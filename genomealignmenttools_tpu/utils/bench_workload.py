"""Deterministic large synthetic workload for benchmarking chain rescoring.

Builds a target/query genome pair with planted homologous chains (same
construction idea as tests/make_fixtures.py but much larger) and writes
2bit + chain files so both this framework and the reference C scoreChain
can run the identical workload.
"""

from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def bench_dir() -> str:
    """Where benchmark workloads are built and cached: GAT_BENCH_DIR, or
    .gat_bench inside the checkout."""
    return os.environ.get("GAT_BENCH_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".gat_bench")

_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in ((65, 84), (67, 71)):
    _COMP_LUT[_a], _COMP_LUT[_b] = _b, _a


def build_workload(out_dir: str, t_size: int = 64_000_000,
                   n_chains: int = 96, blocks_per_chain: int = 8000,
                   block_len: int = 120, seed: int = 7) -> dict:
    """Create genome + chain files; returns metadata (cached if present)."""
    os.makedirs(out_dir, exist_ok=True)
    meta_path = os.path.join(out_dir, "META.txt")
    chain_path = os.path.join(out_dir, "bench.chain")
    t2bit = os.path.join(out_dir, "t.2bit")
    q2bit = os.path.join(out_dir, "q.2bit")
    key = f"{t_size},{n_chains},{blocks_per_chain},{block_len},{seed},v3"
    if os.path.exists(meta_path) and open(meta_path).read().split("\n")[0] == key:
        ali = int(open(meta_path).read().split("\n")[1])
        return {"chain": chain_path, "t2bit": t2bit, "q2bit": q2bit,
                "aligned_bases": ali}

    from ..formats.chain import Chain, write_chains
    from ..formats.twobit import write_twobit

    rng = np.random.default_rng(seed)
    # 2 random bits per base via raw bytes (5-10x faster than rng.integers
    # at chr1 scale)
    t_seq = BASES[np.frombuffer(rng.bytes(t_size), np.uint8) & 3]
    q_size = t_size
    q_seq = BASES[np.frombuffer(rng.bytes(q_size), np.uint8) & 3].copy()

    # each chain: colinear run of blocks with small gaps; query side copied
    # from target with ~8% divergence
    chains = []
    aligned = 0
    span_per_chain = t_size // n_chains
    for ci in range(n_chains):
        t0 = ci * span_per_chain + 1000
        q0 = ci * span_per_chain + 500
        gap_t = rng.integers(0, 60, blocks_per_chain)
        gap_q = rng.integers(0, 60, blocks_per_chain)
        sizes = rng.integers(block_len // 2, block_len * 3 // 2,
                             blocks_per_chain)
        t_starts = t0 + np.concatenate(
            [[0], np.cumsum(sizes[:-1] + gap_t[:-1])])
        q_starts = q0 + np.concatenate(
            [[0], np.cumsum(sizes[:-1] + gap_q[:-1])])
        t_ends = t_starts + sizes
        q_ends = q_starts + sizes
        if t_ends[-1] >= t_size or q_ends[-1] >= q_size:
            keep = (t_ends < t_size) & (q_ends < q_size)
            t_starts, t_ends = t_starts[keep], t_ends[keep]
            q_starts, q_ends = q_starts[keep], q_ends[keep]
            sizes = sizes[keep]
        blocks = np.stack([t_starts, t_ends, q_starts, q_ends], 1).astype(np.int64)
        strand = "+" if ci % 3 else "-"
        aligned += int(sizes.sum())
        # plant homology: copy target block content into query (plus strand
        # coords), mutating ~8% - fully vectorized over the chain's blocks
        bsizes = (blocks[:, 1] - blocks[:, 0])
        total = int(bsizes.sum())
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(bsizes) - bsizes, bsizes)
        idx_t = np.repeat(blocks[:, 0], bsizes) + within
        frag = t_seq[idx_t]
        mut = np.frombuffer(rng.bytes(total), np.uint8) < 20  # ~8%
        nmut = int(mut.sum())
        if nmut:
            frag[mut] = BASES[np.frombuffer(rng.bytes(nmut), np.uint8) & 3]
        if strand == "+":
            q_seq[np.repeat(blocks[:, 2], bsizes) + within] = frag
        else:
            # query char at q_size-1-(qs+within) = complement(frag)
            idx_q = q_size - 1 - (np.repeat(blocks[:, 2], bsizes) + within)
            q_seq[idx_q] = _COMP_LUT[frag]
        chains.append(Chain(
            score=1.0, t_name="chrT", t_size=t_size,
            t_start=int(blocks[0, 0]), t_end=int(blocks[-1, 1]),
            q_name="chrQ", q_size=q_size, q_strand=strand,
            q_start=int(blocks[0, 2]), q_end=int(blocks[-1, 3]),
            id=ci + 1, blocks=blocks))

    write_twobit(t2bit, [("chrT", t_seq.tobytes())])
    write_twobit(q2bit, [("chrQ", q_seq.tobytes())])
    write_chains(chains, chain_path)
    with open(meta_path, "w") as f:
        f.write(f"{key}\n{aligned}\n")
    return {"chain": chain_path, "t2bit": t2bit, "q2bit": q2bit,
            "aligned_bases": aligned}


def _plant(t_seq: np.ndarray, q_seq: np.ndarray, blocks: np.ndarray,
           strand: str, identity: float, rng) -> None:
    """Copy target block content into the query (chain coordinates), with
    ~(1-identity) point divergence.  Vectorized over the chain's blocks."""
    bsizes = blocks[:, 1] - blocks[:, 0]
    total = int(bsizes.sum())
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(bsizes) - bsizes, bsizes)
    frag = t_seq[np.repeat(blocks[:, 0], bsizes) + within]
    thresh = int(round((1.0 - identity) * 256))
    if thresh > 0:
        mut = np.frombuffer(rng.bytes(total), np.uint8) < thresh
        nmut = int(mut.sum())
        if nmut:
            frag = frag.copy()
            frag[mut] = BASES[np.frombuffer(rng.bytes(nmut), np.uint8) & 3]
    idx_q = np.repeat(blocks[:, 2], bsizes) + within
    if strand == "+":
        q_seq[idx_q] = frag
    else:
        q_seq[q_seq.shape[0] - 1 - idx_q] = _COMP_LUT[frag]


from ..device.genome import _CHAR_CODE as _CHAR2CODE  # 2bit char codes


def _enforce_tie_free(t_seq, q_seq, scenarios, chains, n_scenarios, rng):
    """Guarantee the final chainCleaner output has no duplicate scores.

    The final file's scores are: bulk file scores (unique ints), every
    suspect chain's exact global score, every broken chain's exact global
    score (set via the chainSubsetOnT full-cover side effect), and every
    breaking chain's exact rescored score after suspect removal.  C's
    chainSort resolves equal-score ties in glibc-qsort order (not a
    reproducible contract), so colliding scenario chains are re-planted
    with fresh divergence until all scores are unique.
    """
    from ..formats.gapcalc import gap_calc_from_file
    from ..formats.scorematrix import score_scheme_default

    lut = score_scheme_default().lut.astype(np.int64)
    gap_calc = gap_calc_from_file("loose")
    q_len = q_seq.shape[0]

    def exact_score(blocks, strand):
        bs_total = 0
        for ts, te, qs, qe in blocks:
            tc = _CHAR2CODE[t_seq[ts:te]].astype(np.int64)
            if strand == "+":
                qc = _CHAR2CODE[q_seq[qs:qe]].astype(np.int64)
            else:
                qc = (_CHAR2CODE[q_seq[q_len - qe:q_len - qs]]
                      .astype(np.int64) ^ 2)[::-1]
            bs_total += int(lut[qc, tc].sum())
        dt = blocks[1:, 0] - blocks[:-1, 1]
        dq = blocks[1:, 2] - blocks[:-1, 3]
        return bs_total - int(gap_calc.cost_vec(dq, dt).sum())

    seen = {float(sc) for sc, _ in chains}  # file scores incl. bulk ints
    for strand, a_blocks, s_blocks, b_blocks, c_blocks in scenarios:
        anchors = np.concatenate([a_blocks, b_blocks])
        for blocks, st, ident in ((s_blocks, strand, 0.78),
                                  (c_blocks, "+", 0.94),
                                  (anchors, strand, 0.93)):
            for _attempt in range(50):
                s = float(exact_score(blocks, st))
                if s not in seen:
                    break
                _plant(t_seq, q_seq, blocks[:1], st, ident, rng)
            else:
                raise RuntimeError("could not de-tie workload scores")
            seen.add(s)


def build_cleaner_workload(out_dir: str, n_scenarios: int = 2000,
                           n_bulk: int = 30000, seed: int = 11) -> dict:
    """chr1-scale chainCleaner workload with planted breaking/broken
    structure (same scenario geometry as tests/make_fixtures.py, at scale).

    Per scenario: a high-scoring "breaking" chain P = [10x1.5kb anchor]
    ...20kb gap... [250bp weak suspect] ...22kb gap... [10x1.5kb anchor],
    and a "broken" chain C whose two block runs fill both gaps of P - a
    valid break for chainCleaner (chainCleaner.c:969-1079) whose weak
    suspect passes the removal thresholds.  Plus n_bulk small pass-through
    chains for realistic parse/net volume.  Deterministic; cached on disk.

    Returns paths for chain/t2bit/q2bit/tSizes/qSizes files - runnable
    identically by the reference C chainCleaner and this framework.
    """
    os.makedirs(out_dir, exist_ok=True)
    meta_path = os.path.join(out_dir, "CLEANER_META.txt")
    paths = {
        "chain": os.path.join(out_dir, "cleaner.chain"),
        "t2bit": os.path.join(out_dir, "ct.2bit"),
        "q2bit": os.path.join(out_dir, "cq.2bit"),
        "t_sizes": os.path.join(out_dir, "ct.sizes"),
        "q_sizes": os.path.join(out_dir, "cq.sizes"),
    }
    key = f"{n_scenarios},{n_bulk},{seed},v4"
    if os.path.exists(meta_path) and \
            open(meta_path).read().split("\n")[0] == key:
        return dict(paths, n_scenarios=n_scenarios, n_bulk=n_bulk)

    from ..formats.chain import Chain, write_chains
    from ..formats.twobit import write_twobit

    rng = np.random.default_rng(seed)
    scen_span_t, scen_span_q = 120_000, 90_000
    bulk_span_t, bulk_span_q = 3_000, 3_000
    t_size = n_scenarios * scen_span_t + n_bulk * bulk_span_t + 100_000
    q_size = n_scenarios * scen_span_q + n_bulk * bulk_span_q + 100_000
    t_seq = BASES[np.frombuffer(rng.bytes(t_size), np.uint8) & 3]
    q_seq = BASES[np.frombuffer(rng.bytes(q_size), np.uint8) & 3].copy()

    chains: list[tuple[float, Chain]] = []

    def colinear(t0, q0, n, size, gap_lo, gap_hi):
        gaps_t = rng.integers(gap_lo, gap_hi, n)
        gaps_q = rng.integers(gap_lo, gap_hi, n)
        ts = t0 + np.concatenate([[0], np.cumsum(size + gaps_t[:-1])])
        qs = q0 + np.concatenate([[0], np.cumsum(size + gaps_q[:-1])])
        return np.stack([ts, ts + size, qs, qs + size], 1).astype(np.int64)

    def mk_chain(blocks, strand, score):
        return (score, Chain(
            score=score, t_name="chrT", t_size=t_size,
            t_start=int(blocks[0, 0]), t_end=int(blocks[-1, 1]),
            q_name="chrQ", q_size=q_size, q_strand=strand,
            q_start=int(blocks[0, 2]), q_end=int(blocks[-1, 3]),
            id=0, blocks=blocks))

    # Each chain gets a private query-coordinate slot.  '-'-strand chain
    # coordinates live on the reverse complement, whose PLUS-strand
    # footprint is mirrored to the far end of the chromosome - so minus
    # chains are addressed in the mirrored frame of their own slot, keeping
    # every planted region disjoint on the actual (plus) sequence.
    scenarios = []  # (strand, a_blocks, s_blocks, b_blocks, c_blocks)
    for i in range(n_scenarios):
        t0 = i * scen_span_t + 10_000
        strand = "+" if i % 3 else "-"
        if strand == "+":
            q0 = i * scen_span_q + 5_000
        else:
            q0 = q_size - i * scen_span_q - 55_000
        # breaking chain P: anchorA + weak suspect + anchorB.  Geometry is
        # varied per scenario (anchor/suspect/broken block sizes) so the
        # rescored output scores are spread out - C's chainSort breaks
        # score ties via glibc qsort order, which is not a reproducible
        # contract, so the workload must be (and is verified) tie-free.
        a_bs = 1200 + (i % 800)
        sus_len = 200 + (i * 7) % 1400
        b_bs = 800 + (i * 13) % 300
        a_blocks = colinear(t0, q0, 10, a_bs, 10, 200)
        gap1_start = int(a_blocks[-1, 1])
        sus_t = gap1_start + 20_000
        sus_q = int(a_blocks[-1, 3]) + 900
        s_blocks = np.array([[sus_t, sus_t + sus_len, sus_q, sus_q + sus_len]],
                            np.int64)
        b_blocks = colinear(sus_t + sus_len + 22_000, sus_q + sus_len + 1200,
                            10, a_bs, 10, 200)
        p_blocks = np.concatenate([a_blocks, s_blocks, b_blocks])
        _plant(t_seq, q_seq, a_blocks, strand, 0.93, rng)
        _plant(t_seq, q_seq, s_blocks, strand, 0.78, rng)
        _plant(t_seq, q_seq, b_blocks, strand, 0.93, rng)
        chains.append(mk_chain(p_blocks, strand, 5_000_000 - i))
        # broken chain C: fills P's two big gaps (plus strand)
        cq0 = i * scen_span_q + 61_000
        l_blocks = colinear(gap1_start + 500, cq0, 8, b_bs, 5, 120)
        r_blocks = colinear(sus_t + sus_len + 500, int(l_blocks[-1, 3]) + 400,
                            8, b_bs, 5, 120)
        c_blocks = np.concatenate([l_blocks, r_blocks])
        _plant(t_seq, q_seq, c_blocks, "+", 0.94, rng)
        chains.append(mk_chain(c_blocks, "+", 400_000 - i))
        scenarios.append((strand, a_blocks, s_blocks, b_blocks, c_blocks))

    bulk_t0 = n_scenarios * scen_span_t + 50_000
    bulk_q0 = n_scenarios * scen_span_q + 50_000
    for i in range(n_bulk):
        t0 = bulk_t0 + i * bulk_span_t
        strand = "+" if i % 4 else "-"
        if strand == "+":
            q0 = bulk_q0 + i * bulk_span_q + 100
        else:
            q0 = q_size - (bulk_q0 + i * bulk_span_q + 2_900)
        blocks = colinear(t0, q0, 12, int(rng.integers(60, 180)), 0, 50)
        _plant(t_seq, q_seq, blocks, strand, 0.90, rng)
        chains.append(mk_chain(blocks, strand, 100_001 + i))

    _enforce_tie_free(t_seq, q_seq, scenarios, chains, n_scenarios, rng)

    # score-desc order with ids 1..N in that order (chainMergeSort
    # renumbering semantics: lower id = higher score), as chainNet requires
    chains.sort(key=lambda sc: -sc[0])
    out_chains = []
    for idx, (_, c) in enumerate(chains):
        c.id = idx + 1
        out_chains.append(c)

    write_twobit(paths["t2bit"], [("chrT", t_seq.tobytes())])
    write_twobit(paths["q2bit"], [("chrQ", q_seq.tobytes())])
    with open(paths["t_sizes"], "w") as f:
        f.write(f"chrT\t{t_size}\n")
    with open(paths["q_sizes"], "w") as f:
        f.write(f"chrQ\t{q_size}\n")
    write_chains(out_chains, paths["chain"])
    with open(meta_path, "w") as f:
        f.write(f"{key}\n")
    return dict(paths, n_scenarios=n_scenarios, n_bulk=n_bulk)


def build_repeatfiller_workload(out_dir: str, n_gaps: int = 3000,
                                seed: int = 13) -> dict:
    """Gap-filling workload: one long chain whose every gap hides a
    planted diverged homolog with indels (the content RepeatFiller's
    lastz|axtChain pipeline exists to recover,
    /root/reference/src/RepeatFiller.py:445-468).  Each gap yields real
    HSPs AND banded-DP extension problems, so host-vs-device gap
    throughput exercises the full seed->scan->band->chain path.
    Deterministic; cached on disk."""
    os.makedirs(out_dir, exist_ok=True)
    meta_path = os.path.join(out_dir, "RF_META.txt")
    paths = {
        "chain": os.path.join(out_dir, "rf.chain"),
        "t2bit": os.path.join(out_dir, "rt.2bit"),
        "q2bit": os.path.join(out_dir, "rq.2bit"),
    }
    key = f"{n_gaps},{seed},v1"
    if os.path.exists(meta_path) and \
            open(meta_path).read().split("\n")[0] == key:
        return dict(paths, n_gaps=n_gaps)

    from ..formats.chain import Chain, write_chains
    from ..formats.twobit import write_twobit

    rng = np.random.default_rng(seed)
    anchor, gap_t, gap_q = 500, 2000, 2000
    span = anchor + gap_t
    t_size = q_size = n_gaps * span + anchor + 20_000
    t_seq = BASES[np.frombuffer(rng.bytes(t_size), np.uint8) & 3]
    q_seq = BASES[np.frombuffer(rng.bytes(q_size), np.uint8) & 3].copy()

    def plant(tp, qp, length, identity):
        frag = t_seq[tp:tp + length].copy()
        mut = rng.random(length) > identity
        frag[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        q_seq[qp:qp + length] = frag

    blocks = []
    tp = qp = 1000
    for i in range(n_gaps):
        plant(tp, qp, anchor, 0.97)
        blocks.append((tp, tp + anchor, qp, qp + anchor))
        tp += anchor
        qp += anchor
        # homology inside the gap: a strong 150bp anchor (above the lastz
        # K=1500 HSP threshold) + 8 short diverged pieces split by 1-3bp
        # indels, recoverable only through the banded gapped extension
        ht, hq = tp + 400, qp + 400
        plant(ht, hq, 150, 0.95)
        ht += 150
        hq += 150
        for j in range(8):
            ht += 1 + (i + j) % 3
            plant(ht, hq, 60, 0.92)
            ht += 60
            hq += 60
        tp += gap_t
        qp += gap_q
    plant(tp, qp, anchor, 0.97)
    blocks.append((tp, tp + anchor, qp, qp + anchor))

    b = np.array(blocks, np.int64)
    chain = Chain(score=10_000_000, t_name="chrT", t_size=t_size,
                  t_start=int(b[0, 0]), t_end=int(b[-1, 1]),
                  q_name="chrQ", q_size=q_size, q_strand="+",
                  q_start=int(b[0, 2]), q_end=int(b[-1, 3]),
                  id=1, blocks=b)
    write_twobit(paths["t2bit"], [("chrT", t_seq.tobytes())])
    write_twobit(paths["q2bit"], [("chrQ", q_seq.tobytes())])
    write_chains([chain], paths["chain"])
    with open(meta_path, "w") as f:
        f.write(f"{key}\n")
    return dict(paths, n_gaps=n_gaps)
