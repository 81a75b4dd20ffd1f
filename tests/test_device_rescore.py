"""Device (JAX) block-rescore path must agree bit-for-bit with host numpy,
and plugging it into the engines must preserve byte-parity."""

import os

import numpy as np

from genomealignmenttools_tpu.device.genome import Genome
from genomealignmenttools_tpu.engines.score_chain import score_chain_file
from genomealignmenttools_tpu.engines.scoring import ChainScorer, block_scores
from genomealignmenttools_tpu.formats.chain import read_chains
from genomealignmenttools_tpu.formats.gapcalc import gap_calc_default
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.ops.rescore import DeviceChainScorer


def test_device_block_scores_match_host(fixtures_dir):
    scheme = score_scheme_default()
    gc = gap_calc_default()
    t_genome = Genome(os.path.join(fixtures_dir, "target.2bit"))
    q_genome = Genome(os.path.join(fixtures_dir, "query.2bit"))
    chains = read_chains(os.path.join(fixtures_dir, "synthetic.chain"))

    host = ChainScorer(scheme, gc, t_genome, q_genome)
    dev = DeviceChainScorer(scheme, gc, t_genome, q_genome)

    for chain in chains[:40]:
        bs_h, gc_h = host.score_arrays(chain)
        bs_d, gc_d = dev.score_arrays(chain)
        assert np.array_equal(bs_h, bs_d), f"chain {chain.id} block scores differ"
        assert np.array_equal(gc_h, gc_d)


def test_device_batched_matches_per_chain(fixtures_dir):
    scheme = score_scheme_default()
    gc = gap_calc_default()
    t_genome = Genome(os.path.join(fixtures_dir, "target.2bit"))
    q_genome = Genome(os.path.join(fixtures_dir, "query.2bit"))
    chains = read_chains(os.path.join(fixtures_dir, "synthetic.chain"))
    host = ChainScorer(scheme, gc, t_genome, q_genome)
    dev = DeviceChainScorer(scheme, gc, t_genome, q_genome)
    batched = dev.score_chains(chains)
    for chain, got in zip(chains, batched):
        assert got == host.global_and_local(chain)


def test_score_chain_file_with_device_scorer(fixtures_dir, golden_dir, tmp_path):
    out = str(tmp_path / "dev.chain")
    score_chain_file(
        os.path.join(fixtures_dir, "synthetic.chain"),
        os.path.join(fixtures_dir, "target.2bit"),
        os.path.join(fixtures_dir, "query.2bit"),
        out, linear_gap="loose", scorer_factory=DeviceChainScorer)
    golden = open(os.path.join(golden_dir, "scoreChain.loose.chain"), "rb").read()
    assert open(out, "rb").read() == golden


def test_pair_scorer_matches_host(fixtures_dir):
    """Pair-packed path (native pack + XLA kernel + native combine) is
    bit-identical to the host reference, on both strands."""
    scheme = score_scheme_default()
    gc = gap_calc_default()
    t_genome = Genome(os.path.join(fixtures_dir, "target.2bit"))
    q_genome = Genome(os.path.join(fixtures_dir, "query.2bit"))
    chains = read_chains(os.path.join(fixtures_dir, "synthetic.chain"))
    host = ChainScorer(scheme, gc, t_genome, q_genome)
    dev = DeviceChainScorer(scheme, gc, t_genome, q_genome, mode="pair")
    batched = dev.score_chains(chains)
    for chain, got in zip(chains, batched):
        assert got == host.global_and_local(chain)
    # second call exercises the pack-cache hit path
    assert dev.score_chains(chains) == batched
    # per-chain API
    for chain in chains[:10]:
        bs_h, _ = host.score_arrays(chain)
        bs_d, _ = dev.score_arrays(chain)
        assert np.array_equal(bs_h, bs_d)


def test_pair_scorer_numpy_fallback(fixtures_dir, monkeypatch):
    """GAT_NATIVE=0 exercises the pure-numpy pack + host combine path."""
    import genomealignmenttools_tpu.native as nat
    monkeypatch.setenv("GAT_NATIVE", "0")
    monkeypatch.setattr(nat, "_tried", False)
    monkeypatch.setattr(nat, "_lib", None)
    scheme = score_scheme_default()
    gc = gap_calc_default()
    t_genome = Genome(os.path.join(fixtures_dir, "target.2bit"))
    q_genome = Genome(os.path.join(fixtures_dir, "query.2bit"))
    chains = read_chains(os.path.join(fixtures_dir, "synthetic.chain"))
    host = ChainScorer(scheme, gc, t_genome, q_genome)
    dev = DeviceChainScorer(scheme, gc, t_genome, q_genome, mode="pair")
    got = dev.score_chains(chains[:20])
    want = [host.global_and_local(c) for c in chains[:20]]
    assert got == want
    monkeypatch.setattr(nat, "_tried", False)
    monkeypatch.setattr(nat, "_lib", None)


def test_device_combine_randomized(fixtures_dir):
    """Segmented-scan device combine vs host on adversarial random chains
    (negative runs, clamped-local edge cases, multi-chunk blocks)."""
    scheme = score_scheme_default()
    gcalc = gap_calc_default()
    t_genome = Genome(os.path.join(fixtures_dir, "target.2bit"))
    q_genome = Genome(os.path.join(fixtures_dir, "query.2bit"))
    host = ChainScorer(scheme, gcalc, t_genome, q_genome)
    dev = DeviceChainScorer(scheme, gcalc, t_genome, q_genome, mode="pair")
    rng = np.random.default_rng(11)

    from genomealignmenttools_tpu.formats.chain import Chain
    chains = []
    for ci in range(40):
        n = int(rng.integers(1, 12))
        t = int(rng.integers(0, 800_000))
        q = int(rng.integers(0, 1_700_000))
        rows = []
        for _ in range(n):
            ln = int(rng.integers(1, 400))  # many blocks cross chunk size
            rows.append((t, t + ln, q, q + ln))
            t += ln + int(rng.integers(0, 3000))
            q += ln + int(rng.integers(0, 3000))
        blocks = np.array(rows, np.int64)
        strand = "+" if ci % 2 else "-"
        chains.append(Chain(
            score=0.0, t_name="chrA", t_size=1_000_000,
            t_start=int(blocks[0, 0]), t_end=int(blocks[-1, 1]),
            q_name="chrQ1", q_size=2_000_000, q_strand=strand,
            q_start=int(blocks[0, 2]), q_end=int(blocks[-1, 3]),
            id=ci + 1, blocks=blocks))
    got = dev.score_chains(chains)
    want = [host.global_and_local(c) for c in chains]
    assert got == want


def test_hostnative_scorer_matches_golden(fixtures_dir, golden_dir, tmp_path):
    """GAT_RESCORE=hostnative (threaded C++ pack + LUT-sum + combine, no
    accelerator) must produce byte-identical scoreChain output."""
    import os

    from genomealignmenttools_tpu.engines.score_chain import score_chain_file
    from genomealignmenttools_tpu.ops.rescore import DeviceChainScorer

    def factory(scheme, gap_calc, t_genome, q_genome):
        return DeviceChainScorer(scheme, gap_calc, t_genome, q_genome,
                                 mode="hostnative")

    out = tmp_path / "hn.chain"
    score_chain_file(
        os.path.join(fixtures_dir, "synthetic.chain"),
        os.path.join(fixtures_dir, "target.2bit"),
        os.path.join(fixtures_dir, "query.2bit"),
        str(out), linear_gap="loose", scorer_factory=factory)
    golden = open(os.path.join(golden_dir, "scoreChain.loose.chain")).read()
    assert out.read_text() == golden


def test_score_tiles_vs_code_tiles_identical(fixtures_dir):
    """int8 score-byte tiles (the fast pack mode) must score bit-identically
    to combined-code tiles, through both the streamed-kernel and the
    whole-chain combine paths; matrices outside int8 must fall back."""
    from genomealignmenttools_tpu.formats.gapcalc import gap_calc_default
    from genomealignmenttools_tpu.ops.pair_rescore import (PairBlockScorer,
                                                           PairChainScorer)
    scheme = score_scheme_default()
    gcd = gap_calc_default()
    t_genome = Genome(os.path.join(fixtures_dir, "target.2bit"))
    q_genome = Genome(os.path.join(fixtures_dir, "query.2bit"))
    chains = read_chains(os.path.join(fixtures_dir, "synthetic.chain"))
    lut = np.asarray(scheme.lut)
    assert int(np.abs(lut[:5, :5]).max()) <= 127  # blastz default fits

    import os as _os
    _os.environ["GAT_PAIR_TILES"] = "score4"
    try:
        score4 = PairBlockScorer(lut, t_genome, q_genome)
    finally:
        del _os.environ["GAT_PAIR_TILES"]
    assert score4.score_tiles and score4.score4_tiles
    scored = PairBlockScorer(lut, t_genome, q_genome)
    assert scored.score_tiles and not scored.score4_tiles  # default
    plain = PairBlockScorer(lut, t_genome, q_genome)
    plain.score_tiles = False  # force the combined-code mode

    jobs = [(c.t_name, c.q_name, c.q_strand, c.blocks) for c in chains[:20]]
    bs_4 = score4.block_scores_multi(jobs)
    bs_s = scored.block_scores_multi(jobs)
    bs_p = plain.block_scores_multi(jobs)
    assert np.array_equal(bs_s, bs_p)
    assert np.array_equal(bs_4, bs_p)

    nblocks = [c.n_blocks for c in chains[:20]]
    pcs_4 = PairChainScorer(score4, gcd)
    pcs_s = PairChainScorer(scored, gcd)
    pcs_p = PairChainScorer(plain, gcd)
    assert pcs_s.score(jobs, nblocks) == pcs_p.score(jobs, nblocks)
    assert pcs_4.score(jobs, nblocks) == pcs_p.score(jobs, nblocks)
    out_4 = pcs_4.score_async(jobs, nblocks)
    out_s = pcs_s.score_async(jobs, nblocks)
    out_p = pcs_p.score_async(jobs, nblocks)
    assert np.array_equal(np.asarray(out_s, np.int64),
                          np.asarray(out_p, np.int64))
    assert np.array_equal(np.asarray(out_4, np.int64),
                          np.asarray(out_p, np.int64))

    big = lut.astype(np.int64).copy()
    big[0, 0] = 300  # exceeds int8: rejected by pack_lut already (the
    # packed-LUT trick also needs int8), so no silent wrong-mode risk
    import pytest
    with pytest.raises(AssertionError):
        PairBlockScorer(big, t_genome, q_genome)
