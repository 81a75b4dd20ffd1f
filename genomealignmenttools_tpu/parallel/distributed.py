"""Multi-host distribution (SURVEY §5.8 / §2.4).

The reference's only cross-host mechanism is cluster-job fan-out over
files (patchChain.perl:192-238).  The replacement here:

- `init_distributed()` - jax.distributed.initialize from the standard env
  (JAX_COORDINATOR_ADDRESS / num processes / process id), idempotent
- `hosts_chips_mesh()` - a ("hosts", "chips") mesh over all devices;
  genomes replicate, work-units shard over the flattened data axis
- `shard_indices(n, ...)` - the deterministic work partition: contiguous
  ranges by process, so per-shard outputs concatenate back in input
  order and the merged file is byte-identical for ANY topology
- `host0_merge_text(...)` - gather per-host output text to process 0 via
  a device all-gather of fixed-size uint8 buffers (ICI/DCN, no side
  filesystem needed); every process returns the merged text, process 0
  is the canonical writer

Chain id assignment stays topology-invariant because ids are carried from
the input (never re-assigned per shard); tools that renumber
(chainMergeSort) run on the merged stream only.
"""

from __future__ import annotations

import numpy as np


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed (idempotent; no-op single-process)."""
    import jax
    if num_processes in (None, 1) and coordinator is None:
        import os
        if "JAX_COORDINATOR_ADDRESS" not in os.environ:
            return  # single host
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError:
        pass  # already initialized


def hosts_chips_mesh():
    """Mesh with ("hosts", "chips") axes over all global devices."""
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices())
    n_hosts = jax.process_count()
    n_chips = devs.size // n_hosts
    return Mesh(devs.reshape(n_hosts, n_chips), ("hosts", "chips"))


def shard_indices(n: int, num_shards: int, shard: int) -> range:
    """Deterministic contiguous partition of n work-units.

    Contiguous (not round-robin) so concatenating per-shard outputs in
    shard order reproduces input order exactly - the merge step is a
    plain cat, and bytes are identical at every topology."""
    base, extra = divmod(n, num_shards)
    start = shard * base + min(shard, extra)
    return range(start, start + base + (1 if shard < extra else 0))


def host0_merge_text(local_text: str, max_bytes: int = 1 << 26) -> str:
    """All-gather per-process output text; every process returns the
    concatenation in process order (process 0 writes the canonical file).

    Uses a device all-gather of fixed-size uint8 buffers so the merge
    rides ICI/DCN; single-process returns local_text unchanged."""
    import jax
    if jax.process_count() == 1:
        return local_text
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    data = local_text.encode()
    if len(data) > max_bytes:
        raise ValueError(f"shard output {len(data)} exceeds {max_bytes}")
    buf = np.zeros(max_bytes + 8, np.uint8)
    buf[:8] = np.frombuffer(np.int64(len(data)).tobytes(), np.uint8)
    buf[8:8 + len(data)] = np.frombuffer(data, np.uint8)
    gathered = multihost_utils.process_allgather(jnp.asarray(buf))
    parts = []
    for row in np.asarray(gathered):
        size = int(np.frombuffer(row[:8].tobytes(), np.int64)[0])
        parts.append(row[8:8 + size].tobytes().decode())
    return "".join(parts)
