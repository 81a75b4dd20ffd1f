"""Differential tests: the batched bandExt paths (threaded native batch,
numpy fallback loop) must produce outputs identical to
ops/band_ext.band_ext, the bit-exact kent bandExt port."""

import numpy as np
import pytest

from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.ops.band_ext import BandExtBatch, band_ext


def _problems(seed, n=10):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    probs = []
    for i in range(n):
        la = int(rng.integers(3, 180))
        lb = int(rng.integers(3, 180))
        a = bases[rng.integers(0, 4, la)].tobytes()
        if i % 2:  # homologous with indels
            bb = bytearray(a[:lb] if lb <= la
                           else a + bases[rng.integers(0, 4,
                                                       lb - la)].tobytes())
            for _ in range(int(rng.integers(1, 5))):
                pos = int(rng.integers(0, max(1, len(bb) - 2)))
                if rng.random() < 0.5 and len(bb) > 3:
                    del bb[pos]
                else:
                    bb.insert(pos, int(bases[rng.integers(0, 4)]))
            b = bytes(bb)
        else:  # unrelated
            b = bases[rng.integers(0, 4, lb)].tobytes()
        probs.append((a, b, 1 if i % 3 else -1))
    return probs


def _native_or_skip():
    from genomealignmenttools_tpu.native import get_lib
    if get_lib() is None:
        pytest.skip("native lib unavailable")


@pytest.mark.parametrize("global_mode", [False, True])
@pytest.mark.parametrize("max_insert", [7, 20, 100])
def test_native_band_matches_band_ext(global_mode, max_insert):
    """The threaded C++ batch (native/bandext.cpp) must equal the numpy
    oracle tuple-for-tuple (scores, tie parents, traceback syms), both
    modes, across homologous/unrelated/empty problems."""
    _native_or_skip()
    cm = score_scheme_default().char_matrix()
    probs = _problems(11, n=30) + [(b"", b"ACGT", 1), (b"ACGT", b"", -1)]
    batch = BandExtBatch(global_mode, cm, 400, 30, max_insert)
    got = batch._run_native(probs)
    assert got is not None
    for i, (a, b, d) in enumerate(probs):
        want = band_ext(global_mode, cm, 400, 30, max_insert, a, b, d)
        assert got[i] == want, (global_mode, max_insert, i)


def test_band_batch_run_uses_native(monkeypatch):
    """run() takes the native batch when the library loads: the numpy
    loop must not be reached, and results equal the oracle."""
    _native_or_skip()
    import genomealignmenttools_tpu.ops.band_ext as be
    cm = score_scheme_default().char_matrix()
    probs = _problems(5, n=12)
    want = [band_ext(False, cm, 400, 30, 10, a, b, d) for a, b, d in probs]

    def _no_loop(*a, **k):
        raise AssertionError("numpy loop used despite native library")

    monkeypatch.setattr(be, "band_ext", _no_loop)
    got = BandExtBatch(False, cm, 400, 30, 10).run(probs)
    assert got == want


@pytest.mark.parametrize("global_mode", [False, True])
def test_band_batch_run_without_native(global_mode, monkeypatch):
    """GAT_BAND_NATIVE=0: run() falls back to the numpy band_ext loop,
    with identical results."""
    monkeypatch.setenv("GAT_BAND_NATIVE", "0")
    cm = score_scheme_default().char_matrix()
    probs = _problems(9, n=6)
    batch = BandExtBatch(global_mode, cm, 400, 30, 10)
    assert batch._run_native(probs) is None
    got = batch.run(probs)
    for i, (a, b, d) in enumerate(probs):
        assert got[i] == band_ext(global_mode, cm, 400, 30, 10, a, b, d)
    assert batch.run([]) == []
