"""Tracing/profiling hooks (SURVEY §5.1).

The reference has only coarse step timers and /proc/self/stat dumps
(chainCleaner.c printMem:348-361, axtChain.c clock1000:281-287,
verbose.c verboseTime:44-63).  The replacements here:

- `phase(name)` - per-phase wall timers reported through the verbose
  subsystem at level 2 (matches verboseTime's "label: N millis" shape)
- `trace(out_dir)` - a JAX profiler trace (XLA device timeline, HLO cost
  model, host<->device transfers) viewable in TensorBoard / Perfetto;
  enabled globally by the CLI flag `-profile=dir` or env GAT_PROFILE=dir
- `device_timer` - measures on-device time of a jitted callable by
  synchronizing on its outputs
"""

from __future__ import annotations

import contextlib
import os
import time

from .verbose import verbose

_profile_dir: str | None = None


def set_profile_dir(path: str | None) -> None:
    global _profile_dir
    _profile_dir = path


def profile_dir() -> str | None:
    return _profile_dir if _profile_dir is not None \
        else (os.environ.get("GAT_PROFILE") or None)


_phase_acc: dict | None = None


def phase_acc_start() -> None:
    """Begin accumulating phase() durations (bench phase breakdowns)."""
    global _phase_acc
    _phase_acc = {}


def phase_acc_stop() -> dict:
    """Stop accumulating; returns {phase_name: seconds}."""
    global _phase_acc
    acc, _phase_acc = _phase_acc, None
    return acc or {}


def phase_add(name: str, seconds: float) -> None:
    """Record a phase duration measured by the caller (no-op unless a
    phase accumulation is active)."""
    if _phase_acc is not None:
        _phase_acc[name] = _phase_acc.get(name, 0.0) + seconds


@contextlib.contextmanager
def phase(name: str, level: int = 2):
    """Wall-clock phase timer: 'name: N millis' at the given verbosity."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        dt = time.monotonic() - t0
        if _phase_acc is not None:
            _phase_acc[name] = _phase_acc.get(name, 0.0) + dt
        verbose(level, "%s: %d millis\n" % (name, int(dt * 1000)))


@contextlib.contextmanager
def trace(out_dir: str | None = None):
    """JAX profiler trace around a region, if profiling is enabled.

    No-op (zero overhead) when no profile dir is configured."""
    target = out_dir or profile_dir()
    if not target:
        yield
        return
    import jax
    with jax.profiler.trace(target):
        yield
    verbose(1, "profiler trace written to %s\n" % target)


def device_timer(fn, *args, sync=True, **kwargs):
    """Run fn(*args) and return (result, seconds), synchronizing on device
    outputs so the measurement covers actual execution."""
    import jax
    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    if sync:
        jax.block_until_ready(out)
    return out, time.monotonic() - t0
