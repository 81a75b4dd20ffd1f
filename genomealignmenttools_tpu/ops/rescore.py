"""Batched per-base block scoring on device - the toolkit's hot inner loop.

Replaces chainScoreBlock (kent chainConnect.c:14-22): for every aligned
block, sum matrix[q[i]][t[i]] over its bases.  This is >95% of the work in
scoreChain / chainNet -rescore / chainCleaner (per-base matrix lookups over
up to hundreds of Mb).  DeviceChainScorer has three modes (GAT_RESCORE=
pair|xla|hostnative overrides `auto`):

- "pair" (default on GPU, ops/pair_rescore.py): native C++ multithreaded
  host pack into dense aligned-pair tiles; the device pass is a gather-free
  byte-sum + segmented-scan combine, one round trip per workload.
- "xla" (this file, default on CPU): expand blocks to per-base indices on
  device (cumsum + searchsorted), gather both genome sides, map through
  the 5x5 LUT, segment-sum.
- "hostnative": threaded C++ pack + LUT-sum + combine on the host, no
  device code at all - the plain reference the device modes are held to.

Everything is integer math; all paths are bit-identical to the host numpy
reference (tests enforce this), so byte-parity of downstream outputs is
preserved no matter which path ran.  Shapes are bucketed to powers of two
so XLA compiles a handful of program shapes regardless of input sizes.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ..device.genome import Genome


def _n_threads(cap: int = 16) -> int:
    """Native worker-thread count; GAT_THREADS=N overrides (1 = the
    determinism oracle, tests/test_thread_determinism.py)."""
    env = os.environ.get("GAT_THREADS")
    if env and env.isdigit() and int(env) >= 1:
        return min(int(env), cap)
    return min(os.cpu_count() or 1, cap)

# jax is imported lazily: the all-native host backend (GAT_RESCORE=
# hostnative, and `auto` whenever the native library loads) must not pay
# the jax import + backend start-up cost.

# Persistent compilation cache when JAX_COMPILATION_CACHE_DIR is unset: a
# fixed path inside the checkout (the path is part of the cache key, so a
# moving directory would never hit).
DEFAULT_JAX_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def _init_jax():
    """Import jax with the persistent compile cache placed: the user's
    JAX_COMPILATION_CACHE_DIR (which jax reads itself) wins; otherwise
    DEFAULT_JAX_CACHE."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR") \
            and not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_JAX_CACHE)
    return jax


# Device-traffic counters: every backend records what it ships, fetches
# and dispatches so benchmarks can report bytes moved beside times.
PERF = {"h2d_bytes": 0, "d2h_bytes": 0, "dispatches": 0}


def perf_reset() -> None:
    for k in PERF:
        PERF[k] = 0


def perf_snapshot() -> dict:
    return dict(PERF)


def _next_pow2(n: int, floor: int = 1024) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


_BLOCK_SCORES_KERNEL = None


def _build_block_scores_kernel():
    jax = _init_jax()
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("total_bases",))
    def kern(t_codes, q_codes, lut, t_starts, q_starts, sizes,
             total_bases: int):
        n = sizes.shape[0]
        sizes = sizes.astype(jnp.int32)
        offsets = jnp.concatenate([jnp.zeros(1, jnp.int32),
                                   jnp.cumsum(sizes)[:-1]])
        # pad tail bases onto a dummy segment (id n)
        base_ids = jnp.arange(total_bases, dtype=jnp.int32)
        seg = jnp.searchsorted(offsets + sizes, base_ids,
                               side="right").astype(jnp.int32)
        seg = jnp.minimum(seg, n)  # tail -> dummy
        safe_seg = jnp.minimum(seg, n - 1)
        pos = base_ids - offsets[safe_seg]
        t_idx = t_starts[safe_seg].astype(jnp.int32) + pos
        q_idx = q_starts[safe_seg].astype(jnp.int32) + pos
        valid = seg < n
        t_idx = jnp.where(valid, t_idx, 0)
        q_idx = jnp.where(valid, q_idx, 0)
        tc = jnp.take(t_codes, t_idx).astype(jnp.int32)
        qc = jnp.take(q_codes, q_idx).astype(jnp.int32)
        per_base = jnp.take(lut.reshape(-1), qc * 5 + tc)
        per_base = jnp.where(valid, per_base, 0)
        return jax.ops.segment_sum(per_base, seg, num_segments=n + 1,
                                   indices_are_sorted=True)[:n]

    return kern


def _block_scores_kernel(t_codes, q_codes, lut, t_starts, q_starts, sizes,
                         total_bases: int):
    """Per-block int32 score sums (jit-compiled on first use).

    t_codes/q_codes: uint8[genome] (the relevant strand's code array)
    lut: int32[5,5] indexed [q_code, t_code]
    t_starts/q_starts/sizes: int32[n_blocks_padded] (size 0 padding)
    total_bases: static padded per-base total (>= sizes.sum())
    """
    global _BLOCK_SCORES_KERNEL
    if _BLOCK_SCORES_KERNEL is None:
        _BLOCK_SCORES_KERNEL = _build_block_scores_kernel()
    return _BLOCK_SCORES_KERNEL(t_codes, q_codes, lut, t_starts, q_starts,
                                sizes, total_bases=total_bases)


# Process-wide device-resident genome code arrays.  The host decode is
# already process-cached (device/genome.py _file_seq_cache), so the host
# codes ndarray identity is stable across engine invocations in one
# process; keying on it (with the array pinned in the entry) lets every
# DeviceGenomeCache instance share one upload per (chrom, strand).
# Without this, each engine run re-ships the genome to the device.
_DEV_CODES: dict = {}
# Evict by total bytes, not entry count: each entry pins a
# chromosome-sized device buffer plus its host codes array, so a
# count-bounded cache could pin tens of GB before evicting.
_DEV_CODES_BUDGET = int(os.environ.get("GAT_DEV_CODES_BUDGET",
                                       4 * 1024 ** 3))


def _dev_codes_entry(codes: np.ndarray):
    hit = _DEV_CODES.get(id(codes))
    if hit is not None and hit[0] is codes:
        return hit[1]
    return None


def _dev_codes_store(codes: np.ndarray, dev) -> None:
    total = sum(e[0].nbytes for e in _DEV_CODES.values())
    while _DEV_CODES and total + codes.nbytes > _DEV_CODES_BUDGET:
        k = next(iter(_DEV_CODES))          # FIFO: oldest insertion first
        total -= _DEV_CODES.pop(k)[0].nbytes
    _DEV_CODES[id(codes)] = (codes, dev)


class DeviceGenomeCache:
    """Per-(chrom, strand) uint8 code arrays resident on device."""

    def __init__(self, genome: Genome):
        self.genome = genome

    def codes(self, name: str, strand: str):
        import jax.numpy as jnp
        codes = self.genome.codes(name, strand)
        dev = _dev_codes_entry(codes)
        if dev is None:
            dev = jnp.asarray(codes)
            PERF["h2d_bytes"] += codes.nbytes
            _dev_codes_store(codes, dev)
        return dev


class DeviceBlockScorer:
    """Computes per-block scores on device for batches of blocks that share
    a (t_chrom, q_chrom, q_strand) binding."""

    def __init__(self, lut: np.ndarray, t_cache: DeviceGenomeCache,
                 q_cache: DeviceGenomeCache):
        import jax.numpy as jnp
        self.lut = jnp.asarray(lut.astype(np.int32))
        self.t_cache = t_cache
        self.q_cache = q_cache

    def block_scores(self, t_name: str, q_name: str, q_strand: str,
                     blocks: np.ndarray) -> np.ndarray:
        """int64[n] per-block scores for (n,4) blocks [tS,tE,qS,qE]."""
        n = blocks.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        sizes = (blocks[:, 1] - blocks[:, 0]).astype(np.int32)
        total = int(sizes.sum())
        n_pad = _next_pow2(n, 256)
        total_pad = _next_pow2(total, 4096)
        t_starts = np.zeros(n_pad, np.int32)
        q_starts = np.zeros(n_pad, np.int32)
        sz = np.zeros(n_pad, np.int32)
        t_starts[:n] = blocks[:, 0]
        q_starts[:n] = blocks[:, 2]
        sz[:n] = sizes
        import jax.numpy as jnp
        out = _block_scores_kernel(
            self.t_cache.codes(t_name, "+"),
            self.q_cache.codes(q_name, q_strand),
            self.lut,
            jnp.asarray(t_starts), jnp.asarray(q_starts), jnp.asarray(sz),
            total_pad)
        return np.asarray(out[:n]).astype(np.int64)


class DeviceChainScorer:
    """Drop-in ChainScorer whose per-base block sums run on device.

    Gap costs and the local-score scan stay on host (tiny, integer-exact);
    results are bit-identical to engines.scoring.ChainScorer.
    """

    MODES = ("pair", "xla", "hostnative")

    def __init__(self, scheme, gap_calc, t_genome: Genome, q_genome: Genome,
                 mode: str | None = None):
        self.scheme = scheme
        self.gap_calc = gap_calc
        self.t_genome = t_genome
        self.q_genome = q_genome
        if mode is None:
            mode = os.environ.get("GAT_RESCORE", "auto")
        if mode == "auto":
            mode = auto_device_mode()
        if mode not in self.MODES:
            raise ValueError(f"unknown rescore mode {mode!r}; "
                             f"expected auto or one of {self.MODES}")
        self.mode = mode
        if mode != "hostnative":
            _init_jax()
        if mode == "xla":
            self._dev = DeviceBlockScorer(
                np.asarray(scheme.lut), DeviceGenomeCache(t_genome),
                DeviceGenomeCache(q_genome))
        else:
            # hostnative: threaded C++ pack + LUT-sum + combine, no device
            from .pair_rescore import PairBlockScorer
            self._dev = PairBlockScorer(np.asarray(scheme.lut), t_genome,
                                        q_genome,
                                        host_native=(mode == "hostnative"))

    def score_arrays(self, chain):
        from ..engines.scoring import gap_costs
        bs = self._dev.block_scores(chain.t_name, chain.q_name,
                                    chain.q_strand, chain.blocks)
        gc = gap_costs(chain.blocks, self.gap_calc)
        return bs, gc

    def global_score(self, chain) -> float:
        from ..engines.scoring import chain_global_score
        bs, gc = self.score_arrays(chain)
        return float(chain_global_score(bs, gc))

    def global_and_local(self, chain):
        from ..engines.scoring import chain_global_score, chain_local_score
        bs, gc = self.score_arrays(chain)
        g = chain_global_score(bs, gc)
        loc = chain_local_score(bs, gc)
        ali = int((chain.blocks[:, 1] - chain.blocks[:, 0]).sum())
        return float(g), float(loc), ali

    # -- fully batched path --------------------------------------------------
    def _grouped(self, chains: list):
        """(jobs, order): one job per (t,q,strand) group with concatenated
        blocks; concatenations are memoized by chain-blocks identity (the
        arrays are pinned in the memo, so a hit guarantees freshness)."""
        groups: dict[tuple[str, str, str], list[int]] = {}
        for i, c in enumerate(chains):
            groups.setdefault((c.t_name, c.q_name, c.q_strand), []).append(i)
        jobs = []
        order: list[int] = []
        cache = getattr(self, "_concat_cache", None)
        if cache is None:
            cache = self._concat_cache = {}
        all_hit = bool(groups)
        for (tn, qn, strand), idxs in groups.items():
            parts = [chains[i].blocks for i in idxs]
            ck = tuple(id(b) for b in parts)
            hit = cache.get(ck)
            if hit is not None and all(a is b for a, b in zip(hit[0], parts)):
                all_blocks = hit[1]
            else:
                all_hit = False
                from ..utils.bigmem import big_empty
                rows = sum(p.shape[0] for p in parts)
                all_blocks = big_empty((rows, parts[0].shape[1]),
                                       parts[0].dtype)
                np.concatenate(parts, out=all_blocks)
                if len(cache) > 32:
                    cache.clear()
                cache[ck] = (parts, all_blocks)
            jobs.append((tn, qn, strand, all_blocks))
            order.extend(idxs)
        # resident-workload signal: the same chain set was scored before,
        # so the pack is memoized on device and the (expensive-to-compile)
        # on-device combine amortizes - see score_chains
        self._repeat_workload = all_hit
        return jobs, order

    def score_chains(self, chains: list) -> list[tuple[float, float, int]]:
        """Batched (global, local, aliBases) for many chains.

        Groups chains by (t_chrom, q_chrom, strand) and scores the whole
        workload in ONE device round trip (pair mode), combining per chain
        in native code; other modes fall back to one device call per group
        with host combine.  Order of results matches input order.
        """
        from ..engines.scoring import (chain_global_score, chain_local_score,
                                       gap_costs)
        from ..native import get_lib
        from .pair_rescore import PairBlockScorer
        results: list = [None] * len(chains)
        jobs, order = self._grouped(chains)
        lib = get_lib()
        combine = os.environ.get("GAT_COMBINE", "auto")
        if combine == "auto":
            # The on-device combine (segmented scans, only (n_chains, 2)
            # fetched) serves RESIDENT workloads (the same chains re-scored
            # repeatedly), where its compile amortizes.  One-shot workloads
            # (chainCleaner prescore: fresh subsets every call) use the
            # host combine - one fixed-shape streaming kernel + native C++
            # combine over a small int16 fetch.
            combine = "device" if getattr(self, "_repeat_workload", False) \
                else "host"
        if isinstance(self._dev, PairBlockScorer) and combine == "device" \
                and not getattr(self._dev, "host_native", False):
            from .pair_rescore import PairChainScorer
            pcs = getattr(self, "_pair_chain_scorer", None)
            if pcs is None:
                pcs = self._pair_chain_scorer = PairChainScorer(
                    self._dev, self.gap_calc)
            try:
                scored = pcs.score(jobs,
                                   [chains[i].n_blocks for i in order])
                for k, i in enumerate(order):
                    results[i] = scored[k]
                return results
            except OverflowError:
                pass
        if hasattr(self._dev, "chunk_scores_multi") and lib is not None:
            cs, c_block, n_blocks = self._dev.chunk_scores_multi(jobs)
            all_blocks = self._all_blocks_memo(jobs)
            chain_off = np.zeros(len(order) + 1, np.int64)
            for k, i in enumerate(order):
                chain_off[k + 1] = chain_off[k] + chains[i].n_blocks
            out = _native_combine(lib, cs, c_block, all_blocks, chain_off,
                                  self.gap_calc)
            for k, i in enumerate(order):
                results[i] = (float(out[k, 0]), float(out[k, 1]),
                              int(out[k, 2]))
            return results
        # generic path: batched device scores, host combine per chain
        if isinstance(self._dev, PairBlockScorer):
            flat = self._dev.block_scores_multi(jobs)
        else:
            flat = np.concatenate(
                [self._dev.block_scores(tn, qn, strand, blocks)
                 for (tn, qn, strand, blocks) in jobs]) if jobs \
                else np.zeros(0, np.int64)
        off = 0
        for i in order:
            c = chains[i]
            nb = c.n_blocks
            bs = flat[off:off + nb]
            off += nb
            gc = gap_costs(c.blocks, self.gap_calc)
            results[i] = (float(chain_global_score(bs, gc)),
                          float(chain_local_score(bs, gc)),
                          int((c.blocks[:, 1] - c.blocks[:, 0]).sum()))
        return results

    def score_table(self, table) -> "np.ndarray | None":
        """Batched (global, local, aliBases) over a whole ChainTable - no
        python Chain objects.  Returns an (n, 3) float64 array in table row
        order, or None when this scorer/backend cannot take the SoA path
        (caller falls back to score_chains over materialized chains)."""
        from ..native import get_lib
        from .pair_rescore import PairBlockScorer
        lib = get_lib()
        if lib is None or not hasattr(self._dev, "chunk_scores_multi"):
            return None
        (t_ids, names), (q_ids, qnames) = table.names_factorized()
        n = len(table)
        if n == 0:
            return np.zeros((0, 3))
        if getattr(self._dev, "host_native", False) and \
                hasattr(lib, "gat_subset_scores"):
            # all-host path: gat_subset_scores with full-range windows
            # scores every chain straight from the table columns - no
            # grouping, no block gathers
            return self._score_table_native(lib, table, t_ids, names,
                                            q_ids, qnames)
        minus = (table.strands == ord("-")).astype(np.int64)
        key = ((t_ids.astype(np.int64) << 33)
               | (q_ids.astype(np.int64) << 1) | minus)
        _, inverse = np.unique(key, return_inverse=True)
        order = np.argsort(inverse, kind="stable")  # rows grouped, stable
        bo = table.block_offsets
        cnt = bo[1:] - bo[:-1]
        cnt_o = cnt[order]
        chain_off = np.zeros(n + 1, np.int64)
        np.cumsum(cnt_o, out=chain_off[1:])
        total = int(chain_off[-1])
        if np.array_equal(order, np.arange(n)):
            all_blocks = np.ascontiguousarray(table.blocks)
        else:
            pos = (np.repeat(bo[order] - chain_off[:-1], cnt_o)
                   + np.arange(total))
            all_blocks = np.ascontiguousarray(table.blocks[pos])
        ginv = inverse[order]
        gstart = np.flatnonzero(np.r_[True, ginv[1:] != ginv[:-1]])
        gend = np.r_[gstart[1:], n]
        jobs = []
        for s, e in zip(gstart.tolist(), gend.tolist()):
            i = int(order[s])
            jobs.append((names[t_ids[i]], qnames[q_ids[i]],
                         "-" if minus[i] else "+",
                         all_blocks[chain_off[s]:chain_off[e]]))
        cs, c_block, _nb = self._dev.chunk_scores_multi(jobs)
        out = _native_combine(lib, cs, c_block, all_blocks, chain_off,
                              self.gap_calc)
        results = np.empty((n, 3))
        results[order] = out
        return results

    def _score_table_native(self, lib, table, t_ids, names, q_ids, qnames):
        n = len(table)
        sel = np.arange(n)
        t_ptrs, q_ptrs, keepalive = table_row_code_ptrs(
            table, sel, self.t_genome, self.q_genome)
        jobs = np.empty((n, 3), np.int64)
        jobs[:, 0] = sel
        jobs[:, 1] = table.header[:, 1]  # t_start: full cover
        jobs[:, 2] = table.header[:, 2]  # t_end
        out = native_subset_scores(lib, table.blocks, table.block_offsets,
                                   t_ptrs, q_ptrs, lut25_of(self.scheme.lut),
                                   self.gap_calc, jobs)
        del keepalive
        return out[:, :3].astype(np.float64)

    def _all_blocks_memo(self, jobs) -> np.ndarray:
        """Concatenated int64 blocks across jobs, memoized by identity."""
        memo = getattr(self, "_all_blocks_cache", None)
        ck = tuple(id(b) for (_, _, _, b) in jobs)
        if memo is not None and memo[0] == ck and \
                all(a is b for a, (_, _, _, b) in zip(memo[1], jobs)):
            return memo[2]
        parts = [b for (_, _, _, b) in jobs]
        if parts:
            from ..utils.bigmem import big_empty
            rows = sum(p.shape[0] for p in parts)
            all_blocks = big_empty((rows, 4), np.int64)
            if all(p.dtype == np.int64 for p in parts):
                np.concatenate(parts, out=all_blocks)
            else:
                np.copyto(all_blocks, np.concatenate(parts))
        else:
            all_blocks = np.zeros((0, 4), np.int64)
        self._all_blocks_cache = (ck, parts, all_blocks)
        return all_blocks


# `auto` mode on each JAX backend, chosen by measurement: the pair path
# against the xla path on the three rescoring tools at chr1 scale (PERF.md,
# "Bring-up on H100").
AUTO_MODE = {"cpu": "xla", "gpu": "pair"}


def auto_device_mode() -> str:
    """DeviceChainScorer's `auto` mode for the default JAX backend; a
    backend without a measured choice is an error."""
    import jax
    backend = jax.default_backend()
    if backend not in AUTO_MODE:
        raise ValueError(f"no measured rescore mode for backend {backend!r}"
                         f"; set GAT_RESCORE to one of "
                         f"{DeviceChainScorer.MODES}")
    return AUTO_MODE[backend]


def auto_scorer_factory():
    """Engine-side scorer auto-select (score_chain/chain_cleaner/chain_net
    share it).  Returns a DeviceChainScorer factory, or None for the plain
    python ChainScorer.

    - GAT_RESCORE set (any explicit mode): DeviceChainScorer without
      touching JAX - the decision is already made.
    - native C++ library available: the all-native host backend for
      one-shot tool runs.  The device backends pay host->device shipping
      and per-batch fetches on every one-shot pass; residency (the same
      packed workload re-scored repeatedly) is an explicit choice
      (GAT_RESCORE=pair or a directly-constructed DeviceChainScorer).
      Skipping JAX also removes the backend start-up from every cold run.
    - otherwise: device when an accelerator is present, else python.
    """
    mode = os.environ.get("GAT_RESCORE", "auto")
    if mode != "auto":
        return DeviceChainScorer
    from ..native import get_lib
    if get_lib() is not None:
        return functools.partial(DeviceChainScorer, mode="hostnative")
    import jax
    if jax.default_backend() == "gpu":
        return DeviceChainScorer
    return None


def lut25_of(scheme_lut) -> np.ndarray:
    """Flat 5x5 int32 LUT indexed [q*5+t] (native scoring layout)."""
    lut25 = np.zeros(25, np.int32)
    lut = np.asarray(scheme_lut)
    for qv in range(min(5, lut.shape[0])):
        for tv in range(min(5, lut.shape[1])):
            lut25[qv * 5 + tv] = lut[qv, tv]
    return lut25


def table_row_code_ptrs(table, sel, t_genome, q_genome):
    """Per-row genome code pointers for ChainTable rows `sel`.

    Returns (t_ptrs, q_ptrs, keepalive): ctypes pointer arrays indexed by
    position within sel, plus the list of arrays that must stay alive for
    the duration of the native call."""
    import ctypes
    (t_ids, names), (q_ids, qnames) = table.names_factorized()
    t_ids = t_ids[sel]
    q_ids = q_ids[sel]
    minus = table.strands[sel] == ord("-")
    t_arrs = {j: np.ascontiguousarray(t_genome.codes(names[j], "+"))
              for j in set(t_ids.tolist())}
    q_plus, q_minus = {}, {}
    for j in set(q_ids.tolist()):
        rows_j = q_ids == j
        if (rows_j & ~minus).any():
            q_plus[j] = np.ascontiguousarray(q_genome.codes(qnames[j], "+"))
        if (rows_j & minus).any():
            q_minus[j] = np.ascontiguousarray(q_genome.codes(qnames[j], "-"))
    n = int(sel.shape[0])
    t_ptrs = (ctypes.c_void_p * n)()
    q_ptrs = (ctypes.c_void_p * n)()
    t_ptr_of = {j: a.ctypes.data for j, a in t_arrs.items()}
    qp_ptr = {j: a.ctypes.data for j, a in q_plus.items()}
    qm_ptr = {j: a.ctypes.data for j, a in q_minus.items()}
    mlist = minus.tolist()
    qlist = q_ids.tolist()
    for i, tj in enumerate(t_ids.tolist()):
        t_ptrs[i] = t_ptr_of[tj]
        q_ptrs[i] = qm_ptr[qlist[i]] if mlist[i] else qp_ptr[qlist[i]]
    keepalive = (list(t_arrs.values()) + list(q_plus.values())
                 + list(q_minus.values()))
    return t_ptrs, q_ptrs, keepalive


def native_subset_scores(lib, blocks, chain_off, t_ptrs, q_ptrs, lut25,
                         gap_calc, jobs_arr) -> np.ndarray:
    """gat_subset_scores: fused chainSubsetOnT + scoring over (row, t_lo,
    t_hi) jobs; returns (n_jobs, 4) int64 [global, local, ali, exists]."""
    import ctypes
    blocks = np.ascontiguousarray(blocks, np.int64)
    chain_off = np.ascontiguousarray(chain_off, np.int64)
    jobs_arr = np.ascontiguousarray(jobs_arr, np.int64)
    lut25 = np.ascontiguousarray(lut25, np.int32)
    out = np.empty((jobs_arr.shape[0], 4), np.int64)
    gc = gap_calc
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.gat_subset_scores(
        blocks.ctypes.data_as(i64p), chain_off.ctypes.data_as(i64p),
        chain_off.shape[0] - 1, t_ptrs, q_ptrs,
        lut25.ctypes.data_as(i32p),
        jobs_arr.ctypes.data_as(i64p), jobs_arr.shape[0],
        int(gc.small_size),
        gc.q_small.ctypes.data_as(i64p),
        gc.t_small.ctypes.data_as(i64p),
        gc.b_small.ctypes.data_as(i64p),
        gc.long_pos.ctypes.data_as(i64p), int(gc.long_pos.shape[0]),
        np.ascontiguousarray(gc.q_long).ctypes.data_as(f64p),
        np.ascontiguousarray(gc.t_long).ctypes.data_as(f64p),
        np.ascontiguousarray(gc.b_long).ctypes.data_as(f64p),
        out.ctypes.data_as(i64p),
        _n_threads())
    return out


def _native_combine(lib, chunk_scores: np.ndarray, c_block: np.ndarray,
                    blocks: np.ndarray, chain_off: np.ndarray, gap_calc):
    """Call gat_combine_scores; returns (n_chains, 3) int64
    [global, local, ali]."""
    import ctypes
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n_chains = chain_off.shape[0] - 1
    n_blocks = blocks.shape[0]
    out = np.zeros((n_chains, 3), np.int64)
    if c_block is None:
        # chunk_scores already ARE the per-block totals (fused direct
        # host scoring); skip the segment-sum stage entirely
        bs_out = np.ascontiguousarray(chunk_scores, np.int64)
        chunk_scores = np.zeros(0, np.int32)
        c_block = np.zeros(0, np.int64)
    else:
        bs_out = np.zeros(n_blocks, np.int64)
        chunk_scores = np.ascontiguousarray(chunk_scores, np.int32)
        c_block = np.ascontiguousarray(c_block, np.int64)
    gc = gap_calc
    lib.gat_combine_scores(
        chunk_scores.ctypes.data_as(i32p), c_block.ctypes.data_as(i64p),
        chunk_scores.shape[0],
        blocks.ctypes.data_as(i64p), chain_off.ctypes.data_as(i64p),
        n_chains,
        int(gc.small_size),
        gc.q_small.ctypes.data_as(i64p), gc.t_small.ctypes.data_as(i64p),
        gc.b_small.ctypes.data_as(i64p),
        gc.long_pos.ctypes.data_as(i64p), gc.long_pos.shape[0],
        np.ascontiguousarray(gc.q_long).ctypes.data_as(f64p),
        np.ascontiguousarray(gc.t_long).ctypes.data_as(f64p),
        np.ascontiguousarray(gc.b_long).ctypes.data_as(f64p),
        bs_out.ctypes.data_as(i64p),
        out.ctypes.data_as(i64p))
    return out
