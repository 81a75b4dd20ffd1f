"""Seed-and-extend local alignment for bounded regions (the lastz stage of
RepeatFiller / patchChain, re-designed).

Behavioral reference: the role lastz plays in src/RepeatFiller.py:445-468
(repeat-seeded alignment inside chain gaps, K/L score thresholds, W word
size) - not a lastz port.  Design:

- exact k-mer seeds over the two regions (soft-mask ignored, like lastz's
  [unmask]; N-containing words excluded); word sizes match the
  reference's lastz invocations (W=6 RepeatFiller.py:163-169, W=5
  patchChain.perl:23)
- per *diagonal*, seed positions are merged into scan windows extended
  by hsp_margin (the x-drop horizon); each window's substitution-score
  vector is scanned for maximal-scoring segments (clamped-prefix-sum
  decomposition) - equivalent to greedy x-drop extension of every seed
  on the diagonal at once, and fully vectorized: a grouped single-pass
  Kadane over all windows prefilters, the exact recursive extraction
  runs only on windows reaching K
- gap-free HSPs >= K are indel-joined by the gapped stage (banded
  affine DP, threshold L), then feed the kd-tree chainer
  (engines/kd_chainer) which plays lastz's chaining stage
"""

from __future__ import annotations

import numpy as np


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Base-4 packed k-mers; -1 where the window contains an N."""
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, np.int64)
    c = codes.astype(np.int64)
    val = np.zeros(n - k + 1, np.int64)
    bad = np.zeros(n - k + 1, bool)
    for j in range(k):
        w = c[j:n - k + 1 + j]
        val = (val << 2) | np.minimum(w, 3)
        bad |= w >= 4
    val[bad] = -1
    return val


def _max_segments(scores: np.ndarray, min_score: int):
    """Disjoint maximal-scoring segments with score >= min_score.

    Returns list of (start, end, segment_score).  Uses the clamp-at-zero
    decomposition: within each zero-reset region the best segment runs
    from just after the prefix minimum to the prefix maximum.
    """
    out = []
    n = scores.shape[0]
    if n == 0:
        return out
    # take the globally best segment (max over ends e of
    # pref[e+1] - min(pref[:e+1]), the running-min formulation), then
    # recurse on the two flanks (segments above threshold are rare)
    stack = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        if hi - lo <= 0:
            continue
        seg = scores[lo:hi]
        c = np.cumsum(seg)
        pref = np.concatenate([[0], c])
        runmin = np.minimum.accumulate(pref[:-1])
        cand = c - runmin  # best segment score ending at each position
        best_end = int(np.argmax(cand))
        score = int(cand[best_end])
        if score < min_score:
            continue
        # minimal maximal segment: zero-score flanks are trimmed (argmax
        # already picks the first maximal end; the start is the LAST
        # prefix-minimum), matching lastz's seed-anchored extension which
        # records max positions and never includes score-neutral tails
        pref_slice = pref[:best_end + 1]
        best_start = int(np.flatnonzero(pref_slice == runmin[best_end])[-1])
        out.append((lo + best_start, lo + best_end + 1, score))
        stack.append((lo, lo + best_start))
        stack.append((lo + best_end + 1, hi))
    out.sort()
    return out


_CODE2CHAR = np.frombuffer(b"TCAGN", dtype=np.uint8)


class GapAligner:
    """Aligns two bounded genome regions into scored gap-free blocks.

    Two stages, mirroring the role lastz's K/L thresholds play
    (RepeatFiller.py:163-169 `K=1500 L=2000`, patchChain.perl:23 `L=2500`):

    - ungapped: per-diagonal maximal segments with score >= K
      (hsp_threshold) - the HSP stage
    - gapped (when gapped_threshold/L is set): each HSP is extended left
    and right across indels with the banded affine-gap DP
      (ops/band_ext, the bit-exact kent bandExt port); an alignment is
      kept iff its total gapped score >= L.  Without L, HSPs are emitted
      directly (the round-1 behavior).

    The emitted gap-free blocks feed the kd-tree chainer (lastz's chaining
    stage is played by engines/kd_chainer downstream).
    """

    def __init__(self, lut: np.ndarray, seed_len: int = 10,
                 hsp_threshold: int = 1500, max_region: int = 1_000_000,
                 max_seeds: int = 32_000_000,
                 hsp_margin: int = 1_000,
                 gapped_threshold: int | None = None,
                 gap_open: int = 400, gap_extend: int = 30,
                 char_matrix: np.ndarray | None = None,
                 max_insert: int = 100, max_ext: int = 2_000):
        self.lut = np.asarray(lut, dtype=np.int64)
        # HSP/DP scoring penalizes N like lastz (characters outside the
        # matrix score as the worst mismatch) so ungapped extension stops
        # at N runs and the gapped DP strictly prefers gapping over them,
        # instead of coasting through at kent's N=0 chain-scoring
        # semantics and picking up off-diagonal noise beyond
        # (tests/test_planted_alignment.py n_run_gap).  Emitted block
        # scores still use self.lut (kent semantics, axt.c:431).
        self._bad_n = int(self.lut[:4, :4].min())
        self.hsp_lut = self.lut.copy()
        self.hsp_lut[4, :] = self._bad_n
        self.hsp_lut[:, 4] = self._bad_n
        self.seed_len = seed_len
        self.hsp_threshold = hsp_threshold
        self.max_region = max_region
        self.max_seeds = max_seeds
        self.hsp_margin = hsp_margin
        self.gapped_threshold = gapped_threshold
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.char_matrix = char_matrix
        self.max_insert = max_insert
        self.max_ext = max_ext

    # -- gapped stage --------------------------------------------------
    def _ext_blocks_and_score(self, t_sym: bytes, q_sym: bytes,
                              t_anchor: int, q_anchor: int, direction: int):
        """Turn band_ext symbol strings into gap-free blocks + affine
        score.  Coordinates grow from (t_anchor, q_anchor) in
        `direction`; for direction=-1 the anchor is the block START.

        band_ext returns syms in genomic-ASCENDING order for both
        directions (it reverses its output only for direction>0, having
        run the DP on reversed input for direction<0) - so for the left
        extension the anchor-adjacent symbol is LAST.  Flip to
        anchor-adjacent-first so the offset arithmetic below is uniform.
        """
        ta = np.frombuffer(t_sym, np.uint8)
        qa = np.frombuffer(q_sym, np.uint8)
        if direction < 0:
            ta = ta[::-1]
            qa = qa[::-1]
        dash = ord("-")
        both = (ta != dash) & (qa != dash)
        score = int(self._dp_char_matrix()[ta[both], qa[both]].sum())
        # affine gap charges: O for the first base, E per extra
        # (bandExt.c state init, bandExt.c:129-141)
        gap = ~both
        if gap.any():
            runs = np.flatnonzero(np.diff(np.concatenate(
                [[0], gap.view(np.int8), [0]])))
            starts, ends = runs[0::2], runs[1::2]
            lens = ends - starts
            score -= int(self.gap_open * len(lens)
                         + self.gap_extend * (lens - 1).sum())
        # blocks: runs of aligned columns; t/q advance where not a dash
        t_adv = np.cumsum(ta != dash)
        q_adv = np.cumsum(qa != dash)
        blocks = []
        if both.any():
            bruns = np.flatnonzero(np.diff(np.concatenate(
                [[0], both.view(np.int8), [0]])))
            for s, e in zip(bruns[0::2], bruns[1::2]):
                t_off0 = int(t_adv[s - 1]) if s else 0
                q_off0 = int(q_adv[s - 1]) if s else 0
                t_off1, q_off1 = int(t_adv[e - 1]), int(q_adv[e - 1])
                if direction > 0:
                    blocks.append([t_anchor + t_off0, t_anchor + t_off1,
                                   q_anchor + q_off0, q_anchor + q_off1])
                else:
                    blocks.append([t_anchor - t_off1, t_anchor - t_off0,
                                   q_anchor - q_off1, q_anchor - q_off0])
        return blocks, score

    def _dp_char_matrix(self) -> np.ndarray:
        """char_matrix with 'n'/'N' rows/cols at the worst mismatch (the
        lastz treatment of off-matrix characters) for the gapped DP, so
        gapping over an N run strictly beats pairing through it."""
        cached = getattr(self, "_dp_cm", None)
        if cached is None:
            m = self.char_matrix.copy()
            for ch in b"nN":
                m[ch, :] = self._bad_n
                m[:, ch] = self._bad_n
            cached = self._dp_cm = m
        return cached

    def _band_batch(self):
        cached = getattr(self, "_band_batch_obj", None)
        if cached is None:
            from .band_ext import BandExtBatch
            cached = self._band_batch_obj = BandExtBatch(
                False, self._dp_char_matrix(), self.gap_open,
                self.gap_extend, self.max_insert)
        return cached

    def _gapped_probs(self, hsps: list, t_region: np.ndarray,
                      q_region: np.ndarray, t_lo: int, q_lo: int):
        """Build the (left, right) banded-DP extension problems for the
        best-first sorted HSPs; returns (hsps_sorted, probs)."""
        if self.char_matrix is None:
            from ..formats.scorematrix import score_scheme_default
            self.char_matrix = score_scheme_default().char_matrix()
        t_chars = _CODE2CHAR[np.minimum(t_region, 4)]
        q_chars = _CODE2CHAR[np.minimum(q_region, 4)]
        tn, qn = t_region.shape[0], q_region.shape[0]
        # best-first; skip anchors already covered by an emitted alignment
        hsps = sorted(hsps, key=lambda b: -b[4])
        probs = []
        for tS, tE, qS, qE, _score in hsps:
            rt0, rt1 = tS - t_lo, tE - t_lo
            rq0, rq1 = qS - q_lo, qE - q_lo
            probs.append((
                t_chars[rt1:min(tn, rt1 + self.max_ext)].tobytes(),
                q_chars[rq1:min(qn, rq1 + self.max_ext)].tobytes(), 1))
            probs.append((
                t_chars[max(0, rt0 - self.max_ext):rt0].tobytes(),
                q_chars[max(0, rq0 - self.max_ext):rq0].tobytes(), -1))
        return hsps, probs

    def _gapped(self, hsps: list, t_region: np.ndarray, q_region: np.ndarray,
                t_lo: int, q_lo: int) -> list:
        """Extend HSPs across indels; keep alignments scoring >= L.

        All (left, right) extension problems are built up front and run
        through one BandExtBatch (ops/band_ext: the threaded native batch,
        or the numpy band_ext loop - identical results), then the
        best-first coverage replay uses the batch results."""
        hsps, probs = self._gapped_probs(hsps, t_region, q_region, t_lo, q_lo)
        exts = self._band_batch().run(probs)
        return self._gapped_finish(hsps, exts, t_region, q_region,
                                   t_lo, q_lo)

    def _gapped_finish(self, hsps: list, exts: list,
                       t_region: np.ndarray, q_region: np.ndarray,
                       t_lo: int, q_lo: int) -> list:
        """Replay the best-first coverage using precomputed extension
        results (exts[2i] = right, exts[2i+1] = left for hsps[i])."""
        covered: list[tuple[int, int, int]] = []  # (diag, t0, t1) in region
        out = []
        for hi, (tS, tE, qS, qE, hsp_score) in enumerate(hsps):
            rt0, rt1 = tS - t_lo, tE - t_lo
            rq0 = qS - q_lo
            diag = rt0 - rq0
            if any(d == diag and c0 <= rt0 and rt1 <= c1
                   for d, c0, c1 in covered):
                continue
            total = hsp_score
            blocks = [[tS, tE, qS, qE]]
            ok, t_sym, q_sym, _, _ = exts[2 * hi]       # right extension
            if ok:
                eb, es = self._ext_blocks_and_score(t_sym, q_sym, tE, qE, 1)
                blocks.extend(eb)
                total += es
            ok, t_sym, q_sym, _, _ = exts[2 * hi + 1]   # left extension
            if ok:
                eb, es = self._ext_blocks_and_score(t_sym, q_sym, tS, qS, -1)
                blocks.extend(eb)
                total += es
            if total < self.gapped_threshold:
                continue
            for bt0, bt1, bq0, bq1 in blocks:
                covered.append((bt0 - bq0 - (t_lo - q_lo),
                                bt0 - t_lo, bt1 - t_lo))
            out.extend([b[0], b[1], b[2], b[3],
                        int(self.lut[q_region[b[2] - q_lo:b[3] - q_lo],
                                     t_region[b[0] - t_lo:b[1] - t_lo]]
                            .sum())]
                       for b in blocks)
        out.sort(key=lambda b: (b[2], b[0]))
        return out

    def _seed_pairs(self, t_region: np.ndarray, q_region: np.ndarray,
                    k: int) -> tuple[np.ndarray, np.ndarray] | None:
        """All exact k-mer matches as (t_pos, q_pos) arrays (region
        coords), or None when either side has no valid word."""
        t_kmers = kmer_codes(t_region, k)
        q_kmers = kmer_codes(q_region, k)
        if t_kmers.size == 0 or q_kmers.size == 0:
            return None
        order = np.argsort(t_kmers, kind="stable")
        t_sorted = t_kmers[order]
        lo_idx = np.searchsorted(t_sorted, q_kmers, side="left")
        hi_idx = np.searchsorted(t_sorted, q_kmers, side="right")
        counts = np.where(q_kmers >= 0, hi_idx - lo_idx, 0)
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if total > self.max_seeds:
            return None  # caller retries with a longer word
        q_pos = np.repeat(np.arange(q_kmers.shape[0]), counts)
        # ragged gather of order[lo:hi] per q position, fully vectorized
        cum = np.concatenate([[0], np.cumsum(counts)])
        intra = np.arange(total, dtype=np.int64) - cum[q_pos]
        t_pos = order[lo_idx[q_pos] + intra]
        return t_pos, q_pos

    def _seed_windows(self, t_region: np.ndarray, q_region: np.ndarray):
        """Per-diagonal scan windows anchored on exact-word seeds.

        Seeds on the same diagonal closer than 2*hsp_margin are merged
        into one window extended by hsp_margin on both sides (lastz's
        ungapped stage x-drop-extends each seed, so a K-scoring segment
        farther than the x-drop horizon from every seed word is
        invisible to lastz at the same W too; hsp_margin=1000 is ~the
        default lastz x-drop of 10*maxMatchScore).  Returns
        (diag, w0, w1) int64 arrays, windows clipped to the diagonal's
        overlap with both regions.

        When the word yields more than max_seeds matches the word length
        is raised by 2 (up to 3 times) - graceful specificity fallback
        instead of the round-1 give-up-on-the-region cliff."""
        k = self.seed_len
        for attempt in range(4):
            got = self._seed_pairs(t_region, q_region, k)
            if got is not None:
                break
            k += 2
        else:
            return (np.zeros(0, np.int64),) * 3
        t_pos, q_pos = got
        if t_pos.size == 0:
            return (np.zeros(0, np.int64),) * 3
        diags = t_pos - q_pos
        o = np.lexsort((t_pos, diags))
        d_s, t_s = diags[o], t_pos[o]
        margin = self.hsp_margin
        gap_limit = k + 2 * margin
        new_w = np.ones(t_s.shape[0], bool)
        new_w[1:] = (d_s[1:] != d_s[:-1]) | (t_s[1:] - t_s[:-1] > gap_limit)
        starts = np.flatnonzero(new_w)
        ends = np.concatenate([starts[1:], [t_s.shape[0]]])
        diag_w = d_s[starts]
        w0 = t_s[starts] - margin
        w1 = t_s[ends - 1] + k + margin
        # clip to the diagonal's overlap with both regions
        tn, qn = t_region.shape[0], q_region.shape[0]
        t0d = np.maximum(diag_w, 0)
        t1d = t0d + np.minimum(tn - t0d, qn - (t0d - diag_w))
        w0 = np.maximum(w0, t0d)
        w1 = np.minimum(w1, t1d)
        keep = w1 - w0 >= k
        return diag_w[keep], w0[keep], w1[keep]

    # windows whose cells exceed this are Kadane-prefiltered in batches
    # before the exact (recursive) segment extraction runs
    _SCAN_BATCH = 8_000_000

    def _scan_windows(self, t_region: np.ndarray, q_region: np.ndarray,
                      diag_w, w0, w1, t_lo: int, q_lo: int) -> list:
        """Exact maximal-segment extraction over the given windows.

        A vectorized single-pass Kadane over all windows first computes
        each window's best segment score; the exact recursive
        _max_segments (byte-parity semantics) then runs only on windows
        whose best reaches the K threshold."""
        lut = self.hsp_lut
        blocks = []
        lens = (w1 - w0).astype(np.int64)
        order = np.argsort(lens, kind="stable")  # batch similar lengths
        native = self._scan_windows_native(t_region, q_region, diag_w, w0,
                                           w1, order, t_lo, q_lo)
        if native is not None:
            return native
        csum = np.cumsum(lens[order])
        batch_edges = np.searchsorted(
            csum, np.arange(self._SCAN_BATCH, int(csum[-1]) if csum.size
                            else 0, self._SCAN_BATCH))
        batches = np.split(order, batch_edges)
        for batch in batches:
            if batch.size == 0:
                continue
            bl = lens[batch]
            n_cells = int(bl.sum())
            wid = np.repeat(np.arange(batch.shape[0]), bl)
            offs = np.concatenate([[0], np.cumsum(bl)])
            pos = np.arange(n_cells, dtype=np.int64) - offs[wid]
            t_idx = w0[batch][wid] + pos
            q_idx = t_idx - diag_w[batch][wid]
            scores = lut[q_region[q_idx], t_region[t_idx]]
            # grouped Kadane: best segment score per window in one pass
            c = np.cumsum(scores)
            base = np.concatenate([[0], c[offs[1:-1] - 1]])
            cw = c - base[wid]                      # window-local prefixes
            big = np.int64(1) << 50
            g = np.minimum.accumulate(cw - wid * big) + wid * big
            runmin = np.minimum(0, np.where(pos > 0,
                                            np.concatenate([[0], g[:-1]]),
                                            0))
            best = np.zeros(batch.shape[0], np.int64)
            np.maximum.at(best, wid, cw - runmin)
            for j in np.flatnonzero(best >= self.hsp_threshold):
                a, b = int(w0[batch[j]]), int(w1[batch[j]])
                d = int(diag_w[batch[j]])
                seg_scores = scores[offs[j]:offs[j + 1]]
                for s, e, sc in _max_segments(seg_scores,
                                              self.hsp_threshold):
                    blocks.append([t_lo + a + s, t_lo + a + e,
                                   q_lo + a - d + s, q_lo + a - d + e, sc])
        return blocks

    def _scan_windows_native(self, t_region, q_region, diag_w, w0, w1,
                             order, t_lo: int, q_lo: int) -> list | None:
        """Threaded C++ scan (native/hspscan.cpp), byte-identical to the
        numpy path incl. block emission order (windows processed in the
        caller's stable length-sorted order); None when unavailable."""
        import os as _os

        if _os.environ.get("GAT_HSP_NATIVE", "1") == "0":
            return None
        from ..native import get_lib
        lib = get_lib()
        if lib is None or not hasattr(lib, "gat_hsp_scan"):
            return None
        if order.size == 0:
            return []
        lut = self.hsp_lut
        lut25 = np.zeros(25, np.int32)
        for qv in range(5):
            for tv in range(5):
                lut25[qv * 5 + tv] = lut[qv, tv]
        import ctypes
        tr = np.ascontiguousarray(t_region, np.uint8)
        qr = np.ascontiguousarray(q_region, np.uint8)
        dw = np.ascontiguousarray(diag_w[order], np.int64)
        a0 = np.ascontiguousarray(w0[order], np.int64)
        a1 = np.ascontiguousarray(w1[order], np.int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        res_p = lib.gat_hsp_scan(
            tr.ctypes.data_as(u8p), tr.shape[0],
            qr.ctypes.data_as(u8p), qr.shape[0],
            dw.ctypes.data_as(i64p), a0.ctypes.data_as(i64p),
            a1.ctypes.data_as(i64p), dw.shape[0],
            lut25.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(self.hsp_threshold), int(t_lo), int(q_lo), 0)
        try:
            n = int(res_p.contents.n)
            if n == 0:
                return []
            rows = np.ctypeslib.as_array(res_p.contents.rows,
                                         shape=(n, 5)).copy()
        finally:
            lib.gat_hsp_free(res_p)
        return rows.tolist()

    def align(self, t_codes: np.ndarray, q_codes: np.ndarray,
              t_lo: int, t_hi: int, q_lo: int, q_hi: int,
              t_seed_codes: np.ndarray | None = None,
              q_seed_codes: np.ndarray | None = None) -> list:
        """HSP block rows [tS, tE, qS, qE, score] (absolute coordinates in
        the supplied code arrays), sorted by (q, t).

        t_seed_codes/q_seed_codes: optional arrays used ONLY for seed
        discovery (soft-masked positions set to code 4 reproduce lastz's
        default masked seeding, where repeats cannot seed but extensions
        score through them; patchChain.perl:24 `[unmask]` lifts this)."""
        if t_hi - t_lo > self.max_region or q_hi - q_lo > self.max_region:
            return []
        t_region = t_codes[t_lo:t_hi]
        q_region = q_codes[q_lo:q_hi]
        t_seed = (t_region if t_seed_codes is None
                  else t_seed_codes[t_lo:t_hi])
        q_seed = (q_region if q_seed_codes is None
                  else q_seed_codes[q_lo:q_hi])
        diag_w, w0, w1 = self._seed_windows(t_seed, q_seed)
        blocks = self._scan_windows(t_region, q_region, diag_w, w0, w1,
                                    t_lo, q_lo)
        if self.gapped_threshold is not None:
            return self._gapped(blocks, t_region, q_region, t_lo, q_lo)
        blocks.sort(key=lambda b: (b[2], b[0]))
        return blocks

    def align_prepare(self, t_codes: np.ndarray, q_codes: np.ndarray,
                      t_lo: int, t_hi: int, q_lo: int, q_hi: int,
                      t_seed_codes: np.ndarray | None = None,
                      q_seed_codes: np.ndarray | None = None):
        """First half of align() for cross-region batching: seeds + HSP
        scan + banded-DP problem construction, WITHOUT running the DP.

        Returns (done, state, probs): when done is not None it is the
        final result (no gapped stage, or nothing to extend) and
        state/probs are empty; otherwise run all probs (from many
        prepare calls, concatenated) through one BandExtBatch.run and
        hand each region's slice to align_finish(state, exts).  Identical
        results to per-region align() - the DP problems are
        self-contained byte strings."""
        if t_hi - t_lo > self.max_region or q_hi - q_lo > self.max_region:
            return [], None, []
        t_region = t_codes[t_lo:t_hi]
        q_region = q_codes[q_lo:q_hi]
        t_seed = (t_region if t_seed_codes is None
                  else t_seed_codes[t_lo:t_hi])
        q_seed = (q_region if q_seed_codes is None
                  else q_seed_codes[q_lo:q_hi])
        diag_w, w0, w1 = self._seed_windows(t_seed, q_seed)
        blocks = self._scan_windows(t_region, q_region, diag_w, w0, w1,
                                    t_lo, q_lo)
        if self.gapped_threshold is None:
            blocks.sort(key=lambda b: (b[2], b[0]))
            return blocks, None, []
        hsps, probs = self._gapped_probs(blocks, t_region, q_region,
                                         t_lo, q_lo)
        if not probs:
            return [], None, []
        return None, (hsps, t_region, q_region, t_lo, q_lo), probs

    def align_finish(self, state, exts: list) -> list:
        """Second half of align_prepare: exts must be the BandExtBatch
        results for exactly this region's probs slice."""
        hsps, t_region, q_region, t_lo, q_lo = state
        return self._gapped_finish(hsps, exts, t_region, q_region,
                                   t_lo, q_lo)
