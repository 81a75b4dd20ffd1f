"""The staged XLA segmented combine (ops/pair_rescore._staged_combine) vs
the host scan (engines/scoring chain_global_score / chain_local_score).

Random chain workloads: chunk sums, gap biases, block first/last marks
and chain segmentation are generated adversarially (chains crossing
combine-row boundaries, single-chunk chains, chains spanning many rows),
and the device (global, local) must equal the host's bit for bit."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from genomealignmenttools_tpu.engines.scoring import (  # noqa: E402
    chain_global_score, chain_local_score)
from genomealignmenttools_tpu.ops.pair_rescore import (  # noqa: E402
    _R_COMBINE, _staged_combine)


def _random_workload(rng, n_chains, max_blocks=40, max_chunks=12):
    """Chains as lists of blocks, each block a list of chunk scores, plus
    the gap cost before every block but the first."""
    chains = []
    for _ in range(n_chains):
        nb = int(rng.integers(1, max_blocks + 1))
        blocks = [list(rng.integers(-500, 16001,
                                    int(rng.integers(1, max_chunks + 1))))
                  for _ in range(nb)]
        gaps = [int(g) for g in rng.integers(0, 40000, nb - 1)]
        chains.append((blocks, gaps))
    return chains


def _chunk_arrays(chains, pad_to=None):
    """PairChainScorer._meta's per-chunk layout of a workload."""
    s, bias, first, sample, chain_of, start_idx, end_idx = \
        [], [], [], [], [], [], []
    for ci, (blocks, gaps) in enumerate(chains):
        start_idx.append(len(s))
        for bi, chunks in enumerate(blocks):
            for k, v in enumerate(chunks):
                s.append(int(v))
                bias.append(gaps[bi - 1] if (k == 0 and bi > 0) else 0)
                first.append(int(k == 0))
                sample.append(int(k == len(chunks) - 1))
                chain_of.append(ci)
        end_idx.append(len(s) - 1)
    m = len(s)
    pad = (pad_to or m) - m
    # padding chunks continue the last chain and are inert
    s += [0] * pad
    bias += [0] * pad
    first += [0] * pad
    sample += [0] * pad
    chain_of += [len(chains) - 1] * pad
    i32 = lambda x: jnp.asarray(np.array(x, np.int32))
    return (i32(s), i32(bias), i32(first), i32(sample), i32(chain_of),
            i32(start_idx), i32(end_idx))


def _host(chains):
    out = []
    for blocks, gaps in chains:
        bs = np.array([sum(int(v) for v in b) for b in blocks], np.int64)
        gc = np.array(gaps, np.int64)
        out.append((chain_global_score(bs, gc), chain_local_score(bs, gc)))
    return np.array(out, np.int64)


def _device(chains, pad_to=None):
    with jax.enable_x64(True):
        return np.asarray(_staged_combine(*_chunk_arrays(chains, pad_to)))


@pytest.mark.parametrize("seed,n_chains", [(0, 7), (1, 64), (2, 200),
                                           (3, 800)])
def test_staged_combine_matches_host_scan(seed, n_chains):
    # (3, 800) spans many combine rows: chains cross row boundaries and
    # end mid-row, exercising the cross-row carries of all three scans
    rng = np.random.default_rng(seed)
    chains = _random_workload(rng, n_chains)
    m = sum(len(c) for blocks, _ in chains for c in blocks)
    got = _device(chains, pad_to=-(-m // 1024) * 1024)
    np.testing.assert_array_equal(got, _host(chains))


def test_staged_combine_multi_row_chain():
    """One chain spanning several combine rows, between two short ones
    (carry torture test: blocks of 7 chunks end to end)."""
    rng = np.random.default_rng(3)
    n_chunks = 3 * _R_COMBINE + 100
    blocks = [list(rng.integers(-500, 16001, 7))
              for _ in range(n_chunks // 7)]
    gaps = [int(g) for g in rng.integers(0, 30000, len(blocks) - 1)]
    chains = [([[5]], []), (blocks, gaps), ([[-3], [9]], [4])]
    np.testing.assert_array_equal(_device(chains), _host(chains))


def test_device_combine_integrated_scorer(fixtures_dir, monkeypatch):
    """End-to-end DeviceChainScorer(pair) with the staged device combine
    engaged vs the sequential host scorer."""
    import os

    from genomealignmenttools_tpu.device.genome import Genome
    from genomealignmenttools_tpu.engines.scoring import ChainScorer
    from genomealignmenttools_tpu.formats.chain import read_chains
    from genomealignmenttools_tpu.formats.gapcalc import gap_calc_default
    from genomealignmenttools_tpu.formats.scorematrix import (
        score_scheme_default)
    from genomealignmenttools_tpu.ops.rescore import DeviceChainScorer
    monkeypatch.setenv("GAT_COMBINE", "device")
    chains = read_chains(os.path.join(fixtures_dir, "synthetic.chain"))
    t = Genome(os.path.join(fixtures_dir, "target.2bit"))
    q = Genome(os.path.join(fixtures_dir, "query.2bit"))
    scheme, gc = score_scheme_default(), gap_calc_default()
    dev = DeviceChainScorer(scheme, gc, t, q, mode="pair")
    host = ChainScorer(scheme, gc, t, q)
    got = dev.score_chains(chains)
    assert hasattr(dev, "_pair_chain_scorer")  # device combine ran
    want = [host.global_and_local(c) for c in chains]
    assert [tuple(r) for r in got] == [tuple(w) for w in want]
