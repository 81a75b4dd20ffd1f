"""Banded affine-gap Smith-Waterman extension with a wandering band.

Behavioral reference: kent/src/jkOwnLib/bandExt.c - a 3-state affine DP
over a band of 2*maxInsert+1 cells per column, sentinel-padded, with the
band recentered on the best column whenever a new global best appears and
a local-mode early exit when the column best drops more than
gapOpen + gapExtend*maxInsert below the global best.

Port notes:
- the inner column is vectorized: the match and left states depend only on
  the previous column; the up state's in-column recurrence
  u[b] = max(u[b-1]-E, m[b-1]-O) is solved as a prefix max of
  (candidates + b*E) minus b*E
- the C code swaps its two score columns without clearing, so cells
  carry *stale* values from two columns earlier; band wandering can make
  those reachable.  The port keeps the same two persistent arrays and swap
  so results (including tie decisions) match the C bit-for-bit.
- sequences are char arrays (uint8); scoring uses the 256-char matrix.
"""

from __future__ import annotations

import os

import numpy as np

MP_MATCH, MP_UP, MP_LEFT, MP_MASK = 1, 2, 3, 3
UP_EXT = 1 << 2
LP_EXT = 1 << 3


def band_ext(global_mode: bool, char_matrix: np.ndarray, gap_open: int,
             gap_extend: int, max_insert: int,
             a_seq: bytes, b_seq: bytes, direction: int):
    """bandExt.  Returns (ok, sym_a, sym_b, a_best, b_best).

    a_seq/b_seq: the extension regions (not including existing alignment).
    direction: +1 forward, -1 backward.
    sym_a/sym_b: alignment strings with '-' gaps (bytes), empty if no
    extension.
    """
    a = np.frombuffer(a_seq, dtype=np.uint8)
    b = np.frombuffer(b_seq, dtype=np.uint8)
    if direction < 0:
        a = a[::-1]
        b = b[::-1]
    a_size, b_size = a.shape[0], b.shape[0]
    if a_size == 0 or b_size == 0:
        return False, b"", b"", -1, -1

    band_size = 2 * max_insert + 1
    max_ins1 = max_insert + 1
    band_plus = band_size + 2 * max_ins1
    bad = -gap_open * 100
    max_drop = gap_open + gap_extend * max_insert
    mid = 1 + 2 * max_insert

    cur_m = np.full(band_plus, bad, np.int64)
    cur_u = np.full(band_plus, bad, np.int64)
    cur_l = np.full(band_plus, bad, np.int64)
    prev_m = np.full(band_plus, bad, np.int64)
    prev_u = np.full(band_plus, bad, np.int64)
    prev_l = np.full(band_plus, bad, np.int64)
    prev_m[mid] = 0
    score = -gap_open
    for i in range(max_insert):
        prev_u[mid + i] = score
        score -= gap_extend

    parents = np.zeros((band_size, a_size), np.uint8)
    b_offsets = np.zeros(a_size, np.int64)

    best_score = 0
    a_best = b_best = -1
    band_center = 0
    col_shift = 1
    init_gap_score = -gap_open
    matrix = char_matrix

    for a_pos in range(a_size):
        mat_row = matrix[int(a[a_pos])]
        col_top = max(band_center - max_insert, 0)
        col_bottom = min(band_center + max_ins1, b_size)
        cur_off = max_ins1 + col_top - (band_center - max_insert)
        prev_off = cur_off + col_shift
        n = col_bottom - col_top

        if a_pos < max_insert:
            cur_u[cur_off - 1] = init_gap_score
            init_gap_score -= gap_extend
        else:
            cur_u[cur_off - 1] = bad

        if n <= 0:
            # band wandered off the sequence: the column loop body runs
            # zero times; flow through the same best/drop decision with
            # bestColScore = badScore (C semantics)
            best_col_score = bad
            if best_score < best_col_score:
                pass
            elif best_col_score < best_score - max_drop:
                if not global_mode:
                    break
            else:
                col_shift = 1
            b_offsets[a_pos] = band_center
            band_center += col_shift
            cur_m, prev_m = prev_m, cur_m
            cur_u, prev_u = prev_u, cur_u
            cur_l, prev_l = prev_l, cur_l
            continue

        # --- match state (depends on prev column, diag cell) ---
        pm = prev_m[prev_off - 1:prev_off - 1 + n]
        pl = prev_l[prev_off - 1:prev_off - 1 + n]
        pu = prev_u[prev_off - 1:prev_off - 1 + n]
        match_vals = mat_row[b[col_top:col_bottom]]
        use_diag = (pm >= pl) & (pm >= pu)
        use_left = (~use_diag) & (pl > pu)
        base = np.where(use_diag, pm, np.where(use_left, pl, pu))
        m_new = base + match_vals
        parent = np.where(use_diag, MP_MATCH,
                          np.where(use_left, MP_LEFT, MP_UP)).astype(np.uint8)

        # --- left state (prev column, same row) ---
        pl_same = prev_l[prev_off:prev_off + n]
        pm_same = prev_m[prev_off:prev_off + n]
        ext = pl_same - gap_extend
        opn = pm_same - gap_open
        l_ext = ext >= opn
        l_new = np.where(l_ext, ext, opn)
        parent = parent | np.where(l_ext, LP_EXT, 0).astype(np.uint8)

        # --- up state (current column, previous row): first-order
        # recurrence u[i] = max(u[i-1]-E, m[i-1]-O), seeded by the cell
        # above the column (cur_u/cur_m at cur_off-1, which may be stale) ---
        seed_u = int(cur_u[cur_off - 1])
        seed_m = int(cur_m[cur_off - 1])
        cand_m = np.empty(n, np.int64)
        cand_m[0] = seed_m
        cand_m[1:] = m_new[:-1]
        prev_u_chain = np.empty(n, np.int64)
        prev_u_chain[0] = seed_u
        # u[i] = max over k<=i of (cand_m[k] - O - (i-k)*E), also chaining
        # from seed_u:  v[i] = u[i] + i*E = prefix_max(candidates + k*E)
        ks = np.arange(n, dtype=np.int64)
        open_cand = cand_m - gap_open + ks * gap_extend
        open_cand[0] = max(open_cand[0], seed_u - gap_extend + 0 * gap_extend)
        # seed_u contributes u[0] = max(seed_u - E, seed_m - O)
        v = np.maximum.accumulate(open_cand)
        u_new = v - ks * gap_extend
        # recompute exact seeded recurrence for parent-bit comparison
        # (ext >= open per cell): ext_i = u[i-1]-E, open_i = cand_m[i]-O
        u_prev_cells = np.empty(n, np.int64)
        u_prev_cells[0] = seed_u
        u_prev_cells[1:] = u_new[:-1]
        u_ext_vals = u_prev_cells - gap_extend
        u_open_vals = cand_m - gap_open
        u_ext = u_ext_vals >= u_open_vals
        parent = parent | np.where(u_ext, UP_EXT, 0).astype(np.uint8)

        # write back into the persistent arrays
        cur_m[cur_off:cur_off + n] = m_new
        cur_l[cur_off:cur_off + n] = l_new
        cur_u[cur_off:cur_off + n] = u_new
        parents[cur_off - max_ins1:cur_off - max_ins1 + n, a_pos] = parent

        best_col_idx = int(np.argmax(m_new))
        best_col_score = int(m_new[best_col_idx])
        best_col_pos = col_top + best_col_idx

        if best_score < best_col_score:
            best_score = best_col_score
            a_best = a_pos
            b_best = best_col_pos
            col_shift = (best_col_pos + 1) - band_center
        elif best_col_score < best_score - max_drop:
            if not global_mode:
                break
            # note: C leaves colShift unchanged in this branch
        else:
            col_shift = 1

        b_offsets[a_pos] = band_center
        band_center += col_shift
        cur_m, prev_m = prev_m, cur_m
        cur_u, prev_u = prev_u, cur_u
        cur_l, prev_l = prev_l, cur_l

    # --- traceback ---
    if not (global_mode or best_score > 0):
        return False, b"", b"", a_best, b_best
    if global_mode:
        a_pos, b_pos = a_size - 1, b_size - 1
    else:
        a_pos, b_pos = a_best, b_best
    sym_a = bytearray()
    sym_b = bytearray()
    up_state = left_state = False
    while True:
        p_off = b_pos - int(b_offsets[a_pos]) + max_insert
        if p_off < 0:
            p_off = 0
        if p_off >= band_size:
            if not global_mode:
                raise AssertionError("bandExt traceback out of band (local)")
            return False, b"", b"", a_best, b_best
        parent = int(parents[p_off, a_pos])
        if up_state:
            sym_a.append(ord("-"))
            sym_b.append(int(b[b_pos]))
            b_pos -= 1
            up_state = bool(parent & UP_EXT)
        elif left_state:
            sym_a.append(int(a[a_pos]))
            sym_b.append(ord("-"))
            a_pos -= 1
            left_state = bool(parent & LP_EXT)
        else:
            sym_a.append(int(a[a_pos]))
            sym_b.append(int(b[b_pos]))
            a_pos -= 1
            b_pos -= 1
            p = parent & MP_MASK
            if p == MP_UP:
                up_state = True
            elif p == MP_LEFT:
                left_state = True
        if a_pos < 0 or b_pos < 0:
            while a_pos >= 0:
                sym_a.append(int(a[a_pos]))
                sym_b.append(ord("-"))
                a_pos -= 1
            while b_pos >= 0:
                sym_a.append(ord("-"))
                sym_b.append(int(b[b_pos]))
                b_pos -= 1
            break
    out_a = bytes(sym_a)
    out_b = bytes(sym_b)
    if direction > 0:
        out_a = out_a[::-1]
        out_b = out_b[::-1]
    return True, out_a, out_b, a_best, b_best


class BandExtBatch:
    """Batched band_ext: the threaded native batch (native/bandext.cpp),
    or a band_ext loop when the native library is unavailable.

    run(problems): problems = [(a_seq: bytes, b_seq: bytes, direction)].
    Returns [(ok, sym_a, sym_b, a_best, b_best)] identical to band_ext per
    problem.
    """

    def __init__(self, global_mode: bool, char_matrix: np.ndarray,
                 gap_open: int, gap_extend: int, max_insert: int):
        self.global_mode = global_mode
        self.char_matrix = char_matrix
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.max_insert = max_insert

    def run(self, problems):
        if not problems:
            return []
        native = self._run_native(problems)
        if native is not None:
            return native
        return [band_ext(self.global_mode, self.char_matrix,
                         self.gap_open, self.gap_extend,
                         self.max_insert, a, b, d)
                for a, b, d in problems]

    def _run_native(self, problems):
        """Threaded C++ batch (native/bandext.cpp), bit-identical to the
        numpy band_ext oracle; None when the native lib is unavailable or
        GAT_BAND_NATIVE=0."""
        if os.environ.get("GAT_BAND_NATIVE", "1") == "0":
            return None
        from ..native import get_lib
        lib = get_lib()
        if lib is None or not hasattr(lib, "gat_band_ext_batch"):
            return None
        import ctypes
        n = len(problems)
        a_off = np.zeros(n + 1, np.int64)
        b_off = np.zeros(n + 1, np.int64)
        dirs = np.zeros(n, np.int32)
        for i, (a, b, d) in enumerate(problems):
            a_off[i + 1] = a_off[i] + len(a)
            b_off[i + 1] = b_off[i] + len(b)
            dirs[i] = d
        a_blob = np.frombuffer(b"".join(p[0] for p in problems)
                               or b"\0", np.uint8)
        b_blob = np.frombuffer(b"".join(p[1] for p in problems)
                               or b"\0", np.uint8)
        mat = np.ascontiguousarray(self.char_matrix, np.int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        res_p = lib.gat_band_ext_batch(
            1 if self.global_mode else 0,
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(self.gap_open), int(self.gap_extend),
            int(self.max_insert),
            a_blob.ctypes.data_as(u8p), a_off.ctypes.data_as(i64p),
            b_blob.ctypes.data_as(u8p), b_off.ctypes.data_as(i64p),
            dirs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, 0)
        try:
            r = res_p.contents
            ok = np.ctypeslib.as_array(r.ok, shape=(n,)).copy()
            ab = np.ctypeslib.as_array(r.a_best, shape=(n,)).copy()
            bb = np.ctypeslib.as_array(r.b_best, shape=(n,)).copy()
            soff = np.ctypeslib.as_array(r.sym_off, shape=(n + 1,)).copy()
            total = int(soff[-1])
            sa = (np.ctypeslib.as_array(r.sym_a, shape=(total,)).tobytes()
                  if total else b"")
            sb = (np.ctypeslib.as_array(r.sym_b, shape=(total,)).tobytes()
                  if total else b"")
        finally:
            lib.gat_band_ext_free(res_p)
        out = []
        for i in range(n):
            if ok[i] == -2:
                raise AssertionError("bandExt traceback out of band (local)")
            out.append((bool(ok[i]),
                        sa[soff[i]:soff[i + 1]], sb[soff[i]:soff[i + 1]],
                        int(ab[i]), int(bb[i])))
        return out
