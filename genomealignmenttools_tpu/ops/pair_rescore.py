"""Dense pair-packed chain rescoring - the device path of the rescore loop.

The rescore hot loop (kent chainConnect.c chainScoreBlock:14-22,
``score += matrix[q[i]][t[i]]``) is an irregular gather.  Instead of
gathering on device, the host (native C++, multithreaded - see
native/pairpack.cpp) restructures blocks ONCE into dense (n_chunks, CHUNK)
byte tiles of aligned t/q pairs, padded so that pad bases score zero in
every blastz scheme (axt.c propagateCase leaves non-acgt rows zero).  The
device pass is then elementwise arithmetic + a row reduction - no
gathers, no dynamic slices - a streaming read of the tiles.

- whole workloads are scored in ONE kernel call: tiles from every
  (t_chrom, q_chrom, strand) group are concatenated, since packed pairs
  are genome-agnostic (block_scores_multi)
- per-chunk sums return as int16 (CHUNK=128 keeps |sum| <= 16256), halving
  the fetch payload

Tile layouts: int8 substitution scores per aligned base (the default -
the device pass is a pure byte-sum), combined q*5+t codes decoded through
a packed LUT (``sign_extend((packed[q] >> 8*t) & 0xFF)``; the layout of
the multi-device scorer in parallel/mesh.py), and 4-bit score indices.

Packed tiles are cached per blocks-array identity (pinned), matching the
chainCleaner / chainNet -rescore usage pattern where the same chain set is
re-scored repeatedly; results are bit-identical to the host numpy path.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

def _n_threads(cap: int = 16) -> int:
    """Native worker-thread count; GAT_THREADS=N overrides (1 = the
    determinism oracle, tests/test_thread_determinism.py)."""
    env = os.environ.get("GAT_THREADS")
    if env and env.isdigit() and int(env) >= 1:
        return min(int(env), cap)
    return min(os.cpu_count() or 1, cap)


# bases per packed row/chunk.  Short blocks waste up to CHUNK-1 pad bytes
# each, while every chunk costs fixed combine-metadata traffic.  The int16
# chunk sums need CHUNK * 127 < 2^15.
CHUNK = 128
ROW_PAD = 1024       # minimum row-count bucket


def bucket_rows(m: int, floor: int = ROW_PAD) -> int:
    """Round a row count up to a coarse ladder {2^k * f, f in 1..1.75
    step .25} so the jit shape universe is bounded (every workload would
    otherwise compile its own kernels) while capping pad waste at 25%."""
    if m <= floor:
        return floor
    p = floor
    while p < m:
        p *= 2
    half = p // 2
    for f in (10, 12, 14):  # 1.25x, 1.5x, 1.75x of the lower octave
        c = half * f // 8
        if c >= m:
            return c
    return p


def _pair_vals(c8, packed_lut):
    """(M, CHUNK) combined q*5+t bytes -> per-base int32 scores."""
    c = c8.astype(jnp.int32)
    q = c // 5
    t = c - q * 5
    packed = jnp.where(q == 0, packed_lut[0],
                       jnp.where(q == 1, packed_lut[1],
                                 jnp.where(q == 2, packed_lut[2],
                                           jnp.where(q == 3, packed_lut[3],
                                                     0))))
    v = jax.lax.shift_right_logical(packed, jnp.minimum(t, 3) * 8) & 0xFF
    val = v - ((v & 0x80) << 1)  # sign-extend the byte
    return jnp.where((t < 4) & (q < 4), val, 0)


@functools.partial(jax.jit, static_argnames=())
def _pair_scores_kernel(c8, packed_lut):
    """(M, CHUNK) combined pair tiles -> (M,) int16 chunk scores."""
    return jnp.sum(_pair_vals(c8, packed_lut), axis=1, dtype=jnp.int16)


# Score-byte tiles: when every matrix entry fits int8 (all blastz
# schemes), the host packer writes lut[q*5+t] directly (int8 per aligned
# base, pad 0 = the N/N score) and the device pass is a PURE byte-sum -
# no div/mod-5 decode, no packed-LUT shifts; bit-identical (same integer
# per base, same summation).


def _row_sums_i32(s8):
    """(M, C) int8 -> (M,) int32 row sums."""
    return jnp.sum(s8, axis=1, dtype=jnp.int32)


@jax.jit
def _pair_scores_kernel_scored(s8):
    """(M, CHUNK) int8 score tiles -> (M,) int16 chunk scores."""
    return _row_sums_i32(s8).astype(jnp.int16)


@jax.jit
def _chunk_sums_i32_scored(s8):
    """(M, CHUNK) int8 score tiles -> (M,) int32 chunk scores."""
    return _row_sums_i32(s8)


# 4-bit score-index tiles: schemes with <= 16 distinct substitution
# values (all blastz defaults have ~7) store a nibble per aligned base -
# HALF the device-memory bytes of the int8 score tiles.  The 16 int8
# values ride in four packed int32 words (same trick as pack_lut); decode
# is a 4-way select + shift per base.

def _score4_vals(p8, vals_packed):
    """(M, CHUNK//2) packed nibble tiles -> (M, CHUNK) int32 scores.

    Base order within the chunk is lo-nibbles then hi-nibbles - fine,
    every consumer only ever SUMS a chunk."""
    b = p8.astype(jnp.int32)
    idx = jnp.concatenate([b & 0xF, b >> 4], axis=1)
    w = jnp.where(idx < 4, vals_packed[0],
                  jnp.where(idx < 8, vals_packed[1],
                            jnp.where(idx < 12, vals_packed[2],
                                      vals_packed[3])))
    v = jax.lax.shift_right_logical(w, (idx & 3) * 8) & 0xFF
    return v - ((v & 0x80) << 1)  # sign-extend the byte


@jax.jit
def _pair_scores_kernel_scored4(p8, vals_packed):
    """(M, CHUNK//2) nibble tiles -> (M,) int16 chunk scores."""
    return jnp.sum(_score4_vals(p8, vals_packed), axis=1, dtype=jnp.int16)


@jax.jit
def _chunk_sums_i32_scored4(p8, vals_packed):
    """(M, CHUNK//2) nibble tiles -> (M,) int32 chunk scores."""
    return jnp.sum(_score4_vals(p8, vals_packed), axis=1, dtype=jnp.int32)


def pack_lut(lut: np.ndarray) -> np.ndarray:
    """Pack each q row's four t scores into one int32 (byte per t code).

    Requires N rows/cols to be zero and scores in int8 range - true for
    every blastz scheme (axt.c never fills non-acgt entries).
    """
    lut = np.asarray(lut, np.int64)
    assert np.all(lut[4, :] == 0) and np.all(lut[:, 4] == 0), \
        "packed LUT requires zero N row/col"
    assert np.all((lut >= -128) & (lut <= 127)), "scores must fit int8"
    out = np.zeros(4, np.uint32)
    for q in range(4):
        acc = 0
        for t in range(4):
            acc |= (int(lut[q, t]) & 0xFF) << (8 * t)
        out[q] = acc
    return out.view(np.int32)


def pack_vals16(lut: np.ndarray):
    """(idx_lut25 uint8, vals_packed (4,) int32) for 4-bit score-index
    tiles, or None when the scheme has > 16 distinct substitution values.
    Value 0 gets index 0 so pad nibbles decode to the N/N score."""
    lut55 = np.asarray(lut)[:5, :5]
    vals = sorted({int(v) for v in lut55.flatten()} | {0},
                  key=lambda v: (v != 0, v))
    if len(vals) > 16 or any(not -128 <= v <= 127 for v in vals):
        return None
    vals += [0] * (16 - len(vals))
    of = {v: i for i, v in enumerate(vals)}
    idx_lut25 = np.zeros(25, np.uint8)
    for q in range(5):
        for t in range(5):
            idx_lut25[q * 5 + t] = of[int(lut55[q, t])]
    packed = np.zeros(4, np.int64)
    for i, v in enumerate(vals):
        packed[i // 4] |= (v & 0xFF) << ((i % 4) * 8)
    packed = packed.astype(np.uint32).astype(np.int32)
    return idx_lut25, packed


def chunk_blocks(blocks: np.ndarray, chunk: int = CHUNK):
    """Split (n,4) blocks into <=chunk-base pieces (vectorized).

    Returns (c_toff, c_qoff, c_len, c_block) int64 arrays."""
    n = blocks.shape[0]
    sizes = (blocks[:, 1] - blocks[:, 0]).astype(np.int64)
    n_per = np.maximum((sizes + chunk - 1) // chunk, 1)
    total = int(n_per.sum())
    c_block = np.repeat(np.arange(n, dtype=np.int64), n_per)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(n_per) - n_per, n_per)
    c_toff = blocks[c_block, 0].astype(np.int64) + within * chunk
    c_qoff = blocks[c_block, 2].astype(np.int64) + within * chunk
    c_len = np.minimum(sizes[c_block] - within * chunk, chunk)
    return c_toff, c_qoff, c_len, c_block


def _fill_pairs(t_codes, q_codes, c_toff, c_qoff, c_len, t8, q8, m,
                chunk: int):
    """Fill rows [0, m) of t8/q8 from the genomes (native or numpy)."""
    from ..native import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gat_pack_pairs(
            t_codes.ctypes.data_as(u8p), q_codes.ctypes.data_as(u8p),
            c_toff.ctypes.data_as(i64p), c_qoff.ctypes.data_as(i64p),
            c_len.ctypes.data_as(i64p), m, chunk,
            t8.ctypes.data_as(u8p), q8.ctypes.data_as(u8p),
            _n_threads())
    else:
        lane = np.arange(chunk, dtype=np.int64)
        t_idx = np.minimum(c_toff[:, None] + lane, t_codes.shape[0] - 1)
        q_idx = np.minimum(c_qoff[:, None] + lane, q_codes.shape[0] - 1)
        valid = lane < c_len[:, None]
        t8[:m] = np.where(valid, t_codes[t_idx], 4)
        q8[:m] = np.where(valid, q_codes[q_idx], 4)


def _fill_combined(t_codes, q_codes, c_toff, c_qoff, c_len, c8, m,
                   chunk: int):
    """Fill rows [0, m) of c8 with combined q*5+t codes (pad 24)."""
    from ..native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "gat_pack_pairs_combined"):
        import ctypes
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gat_pack_pairs_combined(
            t_codes.ctypes.data_as(u8p), q_codes.ctypes.data_as(u8p),
            c_toff.ctypes.data_as(i64p), c_qoff.ctypes.data_as(i64p),
            c_len.ctypes.data_as(i64p), m, chunk,
            c8.ctypes.data_as(u8p), _n_threads())
    else:
        lane = np.arange(chunk, dtype=np.int64)
        t_idx = np.minimum(c_toff[:, None] + lane, t_codes.shape[0] - 1)
        q_idx = np.minimum(c_qoff[:, None] + lane, q_codes.shape[0] - 1)
        valid = lane < c_len[:, None]
        c8[:m] = np.where(valid,
                          q_codes[q_idx].astype(np.uint8) * 5
                          + t_codes[t_idx], 24)


def _fill_scored(t_codes, q_codes, c_toff, c_qoff, c_len, s8, m,
                 chunk: int, lut8: np.ndarray):
    """Fill rows [0, m) of s8 with int8 substitution scores (pad 0)."""
    from ..native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "gat_pack_pairs_scored"):
        import ctypes
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8p = ctypes.POINTER(ctypes.c_int8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gat_pack_pairs_scored(
            t_codes.ctypes.data_as(u8p), q_codes.ctypes.data_as(u8p),
            c_toff.ctypes.data_as(i64p), c_qoff.ctypes.data_as(i64p),
            c_len.ctypes.data_as(i64p), m, chunk,
            lut8.ctypes.data_as(i8p), s8.ctypes.data_as(i8p),
            _n_threads())
    else:
        lane = np.arange(chunk, dtype=np.int64)
        t_idx = np.minimum(c_toff[:, None] + lane, t_codes.shape[0] - 1)
        q_idx = np.minimum(c_qoff[:, None] + lane, q_codes.shape[0] - 1)
        valid = lane < c_len[:, None]
        combined = (q_codes[q_idx].astype(np.intp) * 5 + t_codes[t_idx])
        s8[:m] = np.where(valid, lut8[combined], np.int8(0))



def _fill_scored4(t_codes, q_codes, c_toff, c_qoff, c_len, p8, m,
                  chunk: int, idx_lut25: np.ndarray):
    """Fill rows [0, m) of p8 (chunk//2 bytes per row) with packed 4-bit
    score indices, two aligned bases per byte (pad nibble 0 = score 0)."""
    from ..native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "gat_pack_pairs_scored4"):
        import ctypes
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gat_pack_pairs_scored4(
            t_codes.ctypes.data_as(u8p), q_codes.ctypes.data_as(u8p),
            c_toff.ctypes.data_as(i64p), c_qoff.ctypes.data_as(i64p),
            c_len.ctypes.data_as(i64p), m, chunk,
            idx_lut25.ctypes.data_as(u8p), p8.ctypes.data_as(u8p),
            _n_threads())
    else:
        lane = np.arange(chunk, dtype=np.int64)
        t_idx = np.minimum(c_toff[:, None] + lane, t_codes.shape[0] - 1)
        q_idx = np.minimum(c_qoff[:, None] + lane, q_codes.shape[0] - 1)
        valid = lane < c_len[:, None]
        combined = (q_codes[q_idx].astype(np.intp) * 5 + t_codes[t_idx])
        idx = np.where(valid, idx_lut25[combined], np.uint8(0))
        p8[:m] = idx[:, 0::2] | (idx[:, 1::2] << 4)


def pack_pairs(t_codes: np.ndarray, q_codes: np.ndarray,
               blocks: np.ndarray, chunk: int = CHUNK):
    """Dense (M_pad, chunk) uint8 combined q*5+t tiles + chunk->block
    map.  One byte per aligned base (pad 24 = N/N) - half the transfer of
    separate t/q tiles."""
    c_toff, c_qoff, c_len, c_block = chunk_blocks(blocks, chunk)
    m = c_toff.shape[0]
    m_pad = bucket_rows(m)
    c8 = np.empty((m_pad, chunk), np.uint8)
    c8[m:] = 24
    _fill_combined(np.ascontiguousarray(t_codes),
                   np.ascontiguousarray(q_codes),
                   c_toff, c_qoff, c_len, c8, m, chunk)
    return c8, c_block, m


class PairBlockScorer:
    """Drop-in block_scores backend over pair-packed tiles.

    block_scores_multi scores several (t,q,strand,blocks) jobs in one
    device round trip; block_scores is the single-job convenience."""

    def __init__(self, lut: np.ndarray, t_genome, q_genome,
                 tile_sharding=None, host_native: bool = False):
        self.host_native = host_native
        if host_native:
            lut25 = np.zeros(25, np.int32)
            for q in range(5):
                for t in range(5):
                    lut25[q * 5 + t] = lut[q, t]
            # pad to 256 so any byte value indexes safely
            self.lut25 = np.zeros(256, np.int32)
            self.lut25[:25] = lut25
        else:
            self.packed_lut = jnp.asarray(pack_lut(lut))
        # int8 score-byte tiles when the matrix fits (all blastz schemes
        # do): the device pass becomes a pure byte-sum
        lut55 = np.asarray(lut)[:5, :5]
        self.score_tiles = (not host_native
                            and int(np.abs(lut55).max()) <= 127)
        if self.score_tiles:
            lut8 = np.zeros(25, np.int8)
            for q in range(5):
                for t in range(5):
                    lut8[q * 5 + t] = lut55[q, t]
            self.lut8 = lut8
        # GAT_PAIR_TILES=score4: 4-bit score-index tiles, HALF the bytes
        # per aligned base for schemes with <= 16 distinct values, at the
        # cost of a nibble decode per base.  GAT_PAIR_TILES=code: combined
        # q*5+t code tiles.  Both are opt-in and bit-identical.
        self.score4_tiles = False
        if (self.score_tiles
                and os.environ.get("GAT_PAIR_TILES") == "score4"):
            v16 = pack_vals16(lut)
            if v16 is not None:
                self.idx_lut25, vals_packed = v16
                self.vals_packed = jnp.asarray(vals_packed)
                self.score4_tiles = True
        if os.environ.get("GAT_PAIR_TILES") == "code":
            self.score_tiles = False
        self.t_genome = t_genome
        self.q_genome = q_genome
        self.tile_sharding = tile_sharding  # NamedSharding for multi-chip
        self._pack_cache: dict[tuple, tuple] = {}

    def _pack_combined(self, jobs, m_pad_of, scored4=None):
        """Shared pack core: chunk all jobs' blocks, fill tiles padded to
        m_pad_of(m) rows - packed 4-bit score indices (chunk/2 bytes per
        row, pad nibble 0) when score4_tiles, int8 score bytes (pad 0)
        when score_tiles, combined q*5+t codes (pad 24 = N/N) otherwise."""
        if scored4 is None:
            scored4 = self.score4_tiles
        scored = self.score_tiles and not scored4
        parts = []
        c_blocks = []
        block_base = 0
        for (tn, qn, strand, blocks) in jobs:
            c_toff, c_qoff, c_len, c_block = chunk_blocks(blocks)
            parts.append((self.t_genome.codes(tn, "+"),
                          self.q_genome.codes(qn, strand),
                          c_toff, c_qoff, c_len))
            c_blocks.append(c_block + block_base)
            block_base += blocks.shape[0]
        m = sum(p[2].shape[0] for p in parts)
        m_pad = m_pad_of(m)
        from ..utils.bigmem import big_empty
        if scored4:
            c8 = big_empty((m_pad, CHUNK // 2), np.uint8)
            c8[m:] = 0
        else:
            c8 = big_empty((m_pad, CHUNK), np.int8 if scored else np.uint8)
            c8[m:] = 0 if scored else 24
        row = 0
        for (tc, qc, c_toff, c_qoff, c_len) in parts:
            k = c_toff.shape[0]
            if scored4:
                _fill_scored4(np.ascontiguousarray(tc),
                              np.ascontiguousarray(qc),
                              c_toff, c_qoff, c_len, c8[row:row + k], k,
                              CHUNK, self.idx_lut25)
            elif scored:
                _fill_scored(np.ascontiguousarray(tc),
                             np.ascontiguousarray(qc),
                             c_toff, c_qoff, c_len, c8[row:row + k], k,
                             CHUNK, self.lut8)
            else:
                _fill_combined(np.ascontiguousarray(tc),
                               np.ascontiguousarray(qc),
                               c_toff, c_qoff, c_len, c8[row:row + k], k,
                               CHUNK)
            row += k
        c_block_all = np.concatenate(c_blocks) if c_blocks \
            else np.zeros(0, np.int64)
        return c8, c_block_all, m, block_base

    def _pack_cached(self, key, jobs, build):
        hit = self._pack_cache.get(key)
        if hit is not None and all(a is b for a, (_, _, _, b) in
                                   zip(hit[0], jobs)):
            return hit[1]
        packed = build()
        if len(self._pack_cache) > 16:
            self._pack_cache.clear()
        self._pack_cache[key] = ([b for (_, _, _, b) in jobs], packed)
        return packed

    def _pack_multi(self, jobs):
        """(dev_c8, c_block_all, m, n_blocks): one full-size device array
        (row count bucketed for bounded jit shapes)."""
        def build():
            c8, c_block_all, m, n_blocks = self._pack_combined(
                jobs, bucket_rows)
            from .rescore import PERF
            PERF["h2d_bytes"] += c8.nbytes
            if self.tile_sharding is not None:
                dev_c8 = jax.device_put(c8, self.tile_sharding)
            else:
                dev_c8 = jnp.asarray(c8)
            return (dev_c8, c_block_all, m, n_blocks)
        return self._pack_cached(tuple(id(b) for (_, _, _, b) in jobs),
                                 jobs, build)

    TILE_ROWS = 1 << 17  # fixed kernel shape: ONE compile ever, any size

    def _pack_multi_tiles(self, jobs):
        """Like _pack_multi but returns fixed-shape device tiles
        (TILE_ROWS, CHUNK) - the kernel compiles once for every workload
        and process."""
        tile = self.TILE_ROWS

        def build():
            c8, c_block_all, m, n_blocks = self._pack_combined(
                jobs, lambda mm: ((mm + tile - 1) // tile) * tile)
            from .rescore import PERF
            PERF["h2d_bytes"] += c8.nbytes
            dev_tiles = [jnp.asarray(c8[i:i + tile])
                         for i in range(0, c8.shape[0], tile)]
            return (dev_tiles, c_block_all, m, n_blocks)
        return self._pack_cached(
            ("tiles",) + tuple(id(b) for (_, _, _, b) in jobs), jobs, build)

    def chunk_scores_multi(self, jobs):
        """Streamed tile scoring: fixed-shape kernel dispatches pipeline
        asynchronously; one sync at the end.  Returns (chunk_scores
        int16[m], c_block, n_blocks).

        host_native mode evaluates the same combined tiles with the
        threaded C++ LUT-sum (native/pairpack.cpp) - no accelerator
        involved; bit-identical."""
        if self.host_native:
            from ..native import get_lib
            lib = get_lib()
            if lib is not None and hasattr(lib, "gat_block_scores_direct"):
                # fused pack+score: per-block LUT sums straight from the
                # genome arrays - zero intermediate tiles (fresh big
                # allocations cost ~60ms/MB in page faults on sandboxed
                # kernels, so skipping the c8 materialization is the
                # single biggest host-path win)
                import ctypes
                u8p = ctypes.POINTER(ctypes.c_uint8)
                i64p = ctypes.POINTER(ctypes.c_int64)
                i32p = ctypes.POINTER(ctypes.c_int32)
                outs = []
                n_blocks = 0
                for (tn, qn, strand, blocks) in jobs:
                    tc = np.ascontiguousarray(self.t_genome.codes(tn, "+"))
                    qc = np.ascontiguousarray(
                        self.q_genome.codes(qn, strand))
                    b = np.ascontiguousarray(blocks, np.int64)
                    bs = np.empty(b.shape[0], np.int64)
                    lib.gat_block_scores_direct(
                        tc.ctypes.data_as(u8p), qc.ctypes.data_as(u8p),
                        b.ctypes.data_as(i64p), b.shape[0],
                        self.lut25.ctypes.data_as(i32p),
                        bs.ctypes.data_as(i64p),
                        _n_threads())
                    outs.append(bs)
                    n_blocks += b.shape[0]
                flat = np.concatenate(outs) if outs else np.zeros(0, np.int64)
                # already per-block totals: c_block None = identity
                return (flat, None, n_blocks)
            c8, c_block, m, n_blocks = self._pack_multi_host(jobs)
            if lib is not None:
                import ctypes
                out = np.empty(m, np.int16)
                lib.gat_chunk_scores_host(
                    c8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m,
                    CHUNK, self.lut25.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    _n_threads())
            else:  # numpy fallback (no C++ toolchain)
                out = self.lut25[c8[:m]].sum(axis=1).astype(np.int16)
            return out, c_block, n_blocks
        dev_tiles, c_block, m, n_blocks = self._pack_multi_tiles(jobs)
        from .rescore import PERF
        PERF["dispatches"] += len(dev_tiles)
        if self.score4_tiles:
            parts = [_pair_scores_kernel_scored4(t, self.vals_packed)
                     for t in dev_tiles]
        elif self.score_tiles:
            parts = [_pair_scores_kernel_scored(t) for t in dev_tiles]
        else:
            parts = [_pair_scores_kernel(t, self.packed_lut)
                     for t in dev_tiles]
        cs = np.concatenate([np.asarray(p) for p in parts])[:m]
        PERF["d2h_bytes"] += cs.nbytes
        return cs, c_block, n_blocks

    def _pack_multi_host(self, jobs):
        """Host-side combined tiles (no device transfer), cached."""
        def build():
            c8, c_block_all, m, n_blocks = self._pack_combined(
                jobs, lambda mm: max(mm, 1))
            return (c8, c_block_all, m, n_blocks)
        return self._pack_cached(
            ("host",) + tuple(id(b) for (_, _, _, b) in jobs), jobs, build)

    def block_scores_multi(self, jobs) -> np.ndarray:
        cs, c_block, n_blocks = self.chunk_scores_multi(jobs)
        if c_block is None:  # already per-block totals (direct host path)
            return cs
        out = np.zeros(n_blocks, np.int64)
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            import ctypes
            cs32 = cs.astype(np.int32)
            lib.gat_segment_sum(
                cs32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                c_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                cs.shape[0],
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        else:
            np.add.at(out, c_block, cs.astype(np.int64))
        return out

    def block_scores(self, t_name: str, q_name: str, q_strand: str,
                     blocks: np.ndarray) -> np.ndarray:
        n = blocks.shape[0]
        if n == 0:
            return np.zeros(0, np.int64)
        return self.block_scores_multi([(t_name, q_name, q_strand, blocks)])


# ---------------------------------------------------------------------------
# Fully on-device chain scoring for resident workloads: the global/local
# combine (engines/scoring.py chain_global_score / chain_local_score) runs
# on device too, via segmented scans over the chunk stream, and only
# (n_chains, 2) comes back instead of one int16 per chunk.
#
# Semantics (bit-exact vs the host path, tests enforce):
#   delta_i = chunk_score_i - gap_cost_before_chunk_i
#   C = segmented cumsum(delta)            (segments = chains)
#   runmin = segmented prefix-min of min(0, C, C - chunk_score)
#            (C - s_i = prefix value after the gap, before chunk i)
#   local  = max(0, max over block-end chunks of C - runmin)
#   global = C at chain end
# Gap costs are host-precomputed ints (formats/gapcalc.py, exact) uploaded
# once with the tiles; scans are int32 (guarded: callers check the per-chain
# score bound fits).


_R_COMBINE = 512     # row width for the tiled cumulative passes


@jax.jit
def _chunk_sums_i32(c8, packed_lut):
    """(M, CHUNK) combined pair tiles -> (M,) int32 chunk scores."""
    return jnp.sum(_pair_vals(c8, packed_lut), axis=1, dtype=jnp.int32)


# --- staged combine pipeline -------------------------------------------------
#
# The per-chain (global, local) combine is prefix-scan shaped.  A flat
# associative_scan over millions of chunks makes XLA build a log2(M)-deep
# slice tree whose compile time grows past ~1M elements, and lax.scan runs
# one While iteration per chunk.  Instead everything is expressed with
# cumulative ops (jnp.cumsum / lax.cummin / cummax) over (B, R) tiles plus
# a tiny cross-row carry, and chain segmentation is encoded
# arithmetically:
#
# - segmented cumsum:   global cumsum, then subtract each chain's start
#                       prefix (one small gather + one expand gather)
# - segmented cummin:   add -chain_id * 2^33 (int64): later chains dominate
#                       the running min, so the global cummin never leaks
#                       across chains; undo the offset afterwards
# - segmented cummax:   symmetric, +chain_id * 2^33
#
# Int64 math needs jax_enable_x64, which is process-global state - the
# combine is traced AND called inside jax.enable_x64() so the rest of the
# process keeps default int32 semantics.
#
# The stages below are traced into ONE jit with the chunk sums: on the
# H100 a resident pass is then one dispatch (one jit per stage measured
# 1.26 ms per pass against 0.41 ms fused at chr1 scale, PERF.md), and the
# fused program compiles in about a second on the GPU and the CPU.

_INC = np.int64(1) << 33   # > 2x the |score| bound of any chain prefix
_BIG = np.int64(1) << 62


def _combine_pad(x, fill):
    """(M,) -> (B, R) with static padding."""
    n = x.shape[0]
    b = (n + _R_COMBINE - 1) // _R_COMBINE
    pad = b * _R_COMBINE - n
    if pad:
        x = jnp.concatenate([x, jnp.full(pad, fill, x.dtype)])
    return x.reshape(b, _R_COMBINE)


def _stage_delta(s, bias):
    return _combine_pad((s - bias).astype(jnp.int64), 0)


def _stage_cumsum(dp, n):
    w = jnp.cumsum(dp, axis=1)
    agg = w[:, -1]
    rp = jnp.cumsum(agg) - agg          # exclusive row prefix
    return (w + rp[:, None]).reshape(-1)[:n]


# g - base[chain_of] without the M-sized gather from a tiny table: scatter
# each chain's base DELTA at its start chunk and forward-fill by prefix
# sum - an n_chains-sized scatter + one cumsum pass.

def _stage_base_scatter(g, start_idx):
    base = jnp.where(start_idx > 0, g[jnp.maximum(start_idx - 1, 0)], 0)
    deltas = jnp.diff(base, prepend=jnp.zeros(1, base.dtype))
    return _combine_pad(jnp.zeros(g.shape[0], g.dtype)
                        .at[start_idx].add(deltas), 0)


def _stage_m(c, s, first, sample, chain_of64):
    # the running minimum may only see prefixes that exist in the host/C
    # step sequence - post-block (sample) and post-gap (C - s at block
    # starts) - NOT mid-block chunk prefixes: clamping is not
    # refinement-invariant
    m = jnp.minimum(jnp.where(sample != 0, c, _BIG),
                    jnp.where(first != 0, c - s, _BIG))
    return _combine_pad(m - chain_of64 * _INC, _BIG)


def _stage_cummin(vp, n):
    w = jax.lax.cummin(vp, axis=1)
    agg = w[:, -1]
    rp = jax.lax.cummin(agg)
    rp = jnp.concatenate([jnp.full(1, _BIG, rp.dtype), rp[:-1]])
    return jnp.minimum(w, rp[:, None]).reshape(-1)[:n]


def _stage_sampled(wmin, c, chain_of64, sample):
    runmin = jnp.minimum(wmin + chain_of64 * _INC, 0)
    sv = jnp.where(sample != 0, c - runmin, -_BIG) + chain_of64 * _INC
    return _combine_pad(sv, -_BIG)


def _stage_cummax(vp, n):
    w = jax.lax.cummax(vp, axis=1)
    agg = w[:, -1]
    rp = jax.lax.cummax(agg)
    rp = jnp.concatenate([jnp.full(1, -_BIG, rp.dtype), rp[:-1]])
    return jnp.maximum(w, rp[:, None]).reshape(-1)[:n]


def _stage_finish(wmax, c, chain_of64, end_idx):
    runmax = wmax - chain_of64 * _INC
    glob = c[end_idx]
    loc = jnp.maximum(runmax[end_idx], 0)
    return jnp.stack([glob, loc], axis=1)


@jax.jit
def _staged_combine(s, bias, first, sample, chain_of, start_idx,
                    end_idx):
    """(M,) int32 chunk sums -> (n_chains, 2) int64 [global, local].

    Must be called inside jax.enable_x64(True)."""
    n = s.shape[0]
    g = _stage_cumsum(_stage_delta(s, bias), n)
    chain_of64 = chain_of.astype(jnp.int64)
    c = g - _stage_cumsum(_stage_base_scatter(g, start_idx), n)
    vp = _stage_m(c, s.astype(jnp.int64), first, sample, chain_of64)
    wmin = _stage_cummin(vp, n)
    sp = _stage_sampled(wmin, c, chain_of64, sample)
    wmax = _stage_cummax(sp, n)
    return _stage_finish(wmax, c, chain_of64, end_idx)


def _chunk_sums(c8, packed_lut, scored=False, scored4=False):
    """(M,) int32 chunk sums of any tile layout.

    scored4: c8 is nibble tiles and packed_lut carries vals_packed."""
    return (_chunk_sums_i32_scored4(c8, packed_lut) if scored4
            else _chunk_sums_i32_scored(c8) if scored
            else _chunk_sums_i32(c8, packed_lut))


@functools.partial(jax.jit, static_argnames=("scored", "scored4"))
def _pair_pass(c8, packed_lut, bias, first, sample, chain_of, start_idx,
               end_idx, scored, scored4):
    s = _chunk_sums(c8, packed_lut, scored, scored4)
    return _staged_combine(s, bias, first, sample, chain_of, start_idx,
                           end_idx)


def _pair_chain_scores(c8, packed_lut, bias, first, sample,
                       chain_of, start_idx, end_idx, scored=False,
                       scored4=False):
    """-> (n_chains, 2) int64 [global, local]: one dispatch, one
    host<->device sync."""
    with jax.enable_x64(True):
        return _pair_pass(c8, packed_lut, bias, first, sample, chain_of,
                          start_idx, end_idx, scored=scored,
                          scored4=scored4)


class PairChainScorer:
    """Whole-workload (global, local, ali) scoring in one device round trip.

    Built on top of a PairBlockScorer's tile packing; adds the per-chunk
    scan metadata (gap biases, block first/last marks, chain ids and
    ends)."""

    def __init__(self, pair_scorer: PairBlockScorer, gap_calc,
                 meta_sharding=None):
        self.pair = pair_scorer
        self.gap_calc = gap_calc
        self.meta_sharding = meta_sharding  # shard (m_pad,) meta arrays
        self._meta_cache: dict[tuple, tuple] = {}

    def _meta(self, jobs, chain_nblocks: list[int]):
        """Scan metadata for jobs + per-chain block counts (cached)."""
        ck = (tuple(id(b) for (_, _, _, b) in jobs), tuple(chain_nblocks))
        hit = self._meta_cache.get(ck)
        if hit is not None and all(a is b for a, (_, _, _, b) in
                                   zip(hit[0], jobs)):
            return hit[1]
        from ..engines.scoring import gap_costs
        dev_c8, c_block, m, n_blocks = self.pair._pack_multi(jobs)
        m_pad = dev_c8.shape[0]
        # per-block metadata across the concatenated job blocks
        all_blocks = np.concatenate([b for (_, _, _, b) in jobs])
        chain_of_block = np.repeat(np.arange(len(chain_nblocks)),
                                   chain_nblocks)
        # gap cost before each block (0 at chain starts)
        gc_all = np.zeros(all_blocks.shape[0], np.int64)
        off = 0
        for nb in chain_nblocks:
            gc_all[off + 1:off + nb] = gap_costs(
                all_blocks[off:off + nb], self.gap_calc)
            off += nb
        assert np.abs(gc_all).max(initial=0) < 2 ** 31, \
            "gap cost exceeds int32 (device combine unavailable)"
        per_chain_gc = np.zeros(len(chain_nblocks), np.int64)
        np.add.at(per_chain_gc, np.repeat(np.arange(len(chain_nblocks)),
                                          chain_nblocks), gc_all)
        # chunk-level arrays
        first_chunk = np.zeros(m_pad, np.int32)
        sample = np.zeros(m_pad, np.int32)
        bias = np.zeros(m_pad, np.int32)
        is_first = np.ones(m, bool)
        is_first[1:] = c_block[1:] != c_block[:-1]
        first_idx = np.flatnonzero(is_first)
        first_chunk[first_idx] = 1
        is_last = np.ones(m, bool)
        is_last[:-1] = c_block[1:] != c_block[:-1]
        sample[np.flatnonzero(is_last)] = 1
        bias[first_idx] = gc_all[c_block[first_idx]]
        chain_of_chunk = chain_of_block[c_block]
        seg_new = np.ones(m, bool)
        seg_new[1:] = chain_of_chunk[1:] != chain_of_chunk[:-1]
        starts = np.flatnonzero(seg_new)
        # chain start/end chunk per chain
        start_idx = starts.astype(np.int32)
        end_idx = np.zeros(len(chain_nblocks), np.int32)
        end_idx[:-1] = starts[1:] - 1
        end_idx[-1] = m - 1
        # padding chunks continue the last chain (code-4 tiles score 0 and
        # are never block-firsts nor sample points, so they are inert)
        chain_of = np.full(m_pad, len(chain_nblocks) - 1, np.int32)
        chain_of[:m] = chain_of_chunk
        ali = np.zeros(len(chain_nblocks), np.int64)
        np.add.at(ali, chain_of_block,
                  (all_blocks[:, 1] - all_blocks[:, 0]).astype(np.int64))
        # int32 scan guard: |any prefix| <= ali*127 + chain gap-cost total
        bound = ali * 127 + per_chain_gc
        if bound.max(initial=0) >= 2 ** 31:
            raise OverflowError("chain score bound exceeds int32; "
                                "use the host combine path")
        if self.meta_sharding is not None:
            put = lambda x: jax.device_put(x, self.meta_sharding)
        else:
            put = jnp.asarray
        meta = (dev_c8, put(bias), put(first_chunk), put(sample),
                put(chain_of), jnp.asarray(start_idx),
                jnp.asarray(end_idx), ali)
        if len(self._meta_cache) > 8:
            self._meta_cache.clear()
        self._meta_cache[ck] = ([b for (_, _, _, b) in jobs], meta)
        return meta

    def score_async(self, jobs, chain_nblocks: list[int]):
        """Launch one full rescore pass; returns the (n_chains, 2) device
        array WITHOUT syncing."""
        (dev_c8, bias, first, sample, chain_of, start_idx,
         end_idx, _ali) = self._meta(jobs, chain_nblocks)
        from .rescore import PERF
        PERF["dispatches"] += 1
        return _pair_chain_scores(
            dev_c8, self._tile_lut(), bias, first, sample,
            chain_of, start_idx, end_idx, scored=self.pair.score_tiles,
            scored4=self.pair.score4_tiles)

    def chunk_sums_async(self, jobs, chain_nblocks: list[int]):
        """The chunk-sum stage of a pass alone: (m_pad,) int32 on device,
        not synced (times the pass's layers separately)."""
        dev_c8 = self._meta(jobs, chain_nblocks)[0]
        with jax.enable_x64(True):
            return _chunk_sums(dev_c8, self._tile_lut(),
                               self.pair.score_tiles, self.pair.score4_tiles)

    def combine_async(self, s, jobs, chain_nblocks: list[int]):
        """The combine stage of a pass alone, over chunk sums `s` from
        chunk_sums_async: (n_chains, 2) int64 on device, not synced."""
        (_c8, bias, first, sample, chain_of, start_idx,
         end_idx, _ali) = self._meta(jobs, chain_nblocks)
        with jax.enable_x64(True):
            return _staged_combine(s, bias, first, sample, chain_of,
                                   start_idx, end_idx)

    def _tile_lut(self):
        """The LUT companion of the packed tiles: vals_packed for 4-bit
        score-index tiles, packed_lut otherwise (unused by the int8
        score-byte kernel but keeps one signature)."""
        return (self.pair.vals_packed if self.pair.score4_tiles
                else self.pair.packed_lut)

    def resident_hbm_bytes(self, jobs, chain_nblocks: list[int]) -> int:
        """Device-memory bytes a rescore pass reads: padded pair tiles +
        per-chunk combine metadata (the aligned-base count understates
        real traffic by the pad factor)."""
        (dev_c8, bias, first, sample, chain_of) = \
            self._meta(jobs, chain_nblocks)[:5]
        return int(dev_c8.size * dev_c8.dtype.itemsize + bias.size * 4
                   + first.size * 4 + sample.size * 4 + chain_of.size * 4)

    def score(self, jobs, chain_nblocks: list[int]):
        """[(global, local, ali)] per chain, one device sync."""
        ali = self._meta(jobs, chain_nblocks)[7]
        out = np.asarray(self.score_async(jobs, chain_nblocks))
        from .rescore import PERF
        PERF["d2h_bytes"] += out.nbytes
        return [(float(out[i, 0]), float(out[i, 1]), int(ali[i]))
                for i in range(len(chain_nblocks))]
