"""Python wrappers over the native host alignment primitives
(native/align_eq.cpp), with numpy fallbacks.

``nw_path``      — edlibAlign(..., EDLIB_MODE_NW, EDLIB_TASK_PATH)
``shw_end``      — edlibAlign(..., EDLIB_MODE_SHW) distance + endLocations[0]
``shw_path``     — SHW with path: edlib computes the NW path over
                   target[0..end] (edlib.cpp:196-209)
``ksw_extend2``  — ksw_extend2 (lib/bwa/ksw.c:380-479) equivalent

Provenance: the numpy fallbacks ``_ksw_extend2_np`` and ``ksw_global2``
are transcriptions of the reference's scalar ksw.c loops (ksw.c:380-479
and :504-606 respectively) — kept deliberately close because their job
is bit-exact oracle semantics, including int-truncation and the
direction-bit conventions of the BAM CIGAR builder.  The device kernels
(ops/affine_pl.py, ops/gap_dp_pallas.py) are original TPU-first designs.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import _load

# move codes (edlib convention)
OP_MATCH, OP_INSERT, OP_DELETE, OP_MISMATCH = 0, 1, 2, 3


def _as_u8(x):
    return np.ascontiguousarray(x, dtype=np.uint8)


def nw_path(q: np.ndarray, t: np.ndarray):
    """Global edit-distance alignment; returns (distance, moves uint8)."""
    q, t = _as_u8(q), _as_u8(t)
    lib = _load()
    if lib is not None:
        moves = np.empty(len(q) + len(t), dtype=np.uint8)
        mlen = ctypes.c_int64(0)
        d = lib.nw_align(
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
            moves.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(mlen),
        )
        return int(d), moves[: mlen.value]
    return _nw_path_np(q, t)


def _nw_path_np(q, t):
    ql, tl = len(q), len(t)
    if ql == 0:
        return tl, np.full(tl, OP_DELETE, np.uint8)
    if tl == 0:
        return ql, np.full(ql, OP_INSERT, np.uint8)
    D = np.zeros((ql + 1, tl + 1), np.int32)
    D[0, :] = np.arange(tl + 1)
    D[:, 0] = np.arange(ql + 1)
    for i in range(1, ql + 1):
        sub = (t != q[i - 1]).astype(np.int32)
        row = D[i]
        prev = D[i - 1]
        for j in range(1, tl + 1):
            row[j] = min(prev[j - 1] + sub[j - 1], prev[j] + 1, row[j - 1] + 1)
    moves = []
    r, c = ql - 1, tl - 1
    while r >= 0 and c >= 0:
        cur = D[r + 1, c + 1]
        if D[r, c + 1] + 1 == cur:
            moves.append(OP_INSERT)
            r -= 1
        elif D[r + 1, c] + 1 == cur:
            moves.append(OP_DELETE)
            c -= 1
        else:
            moves.append(OP_MATCH if q[r] == t[c] else OP_MISMATCH)
            r -= 1
            c -= 1
    moves.extend([OP_INSERT] * (r + 1))
    moves.extend([OP_DELETE] * (c + 1))
    return int(D[ql, tl]), np.array(moves[::-1], np.uint8)


def shw_end(q: np.ndarray, t: np.ndarray):
    """SHW distance + end position in target (first among ties)."""
    q, t = _as_u8(q), _as_u8(t)
    lib = _load()
    if lib is not None:
        end = ctypes.c_int64(0)
        d = lib.shw_best_end(
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
            ctypes.byref(end),
        )
        return int(d), int(end.value)
    return _shw_end_np(q, t)


def _shw_end_np(q, t):
    """Fallback mirroring native shw_best_end, including the edlib
    negative-position artifact (see native/align_eq.cpp)."""
    ql, tl = len(q), len(t)
    if ql == 0:
        return 0, -1
    W = (64 - (ql % 64)) % 64
    col = np.arange(ql + 1, dtype=np.int32)
    best, best_end = np.iinfo(np.int32).max, -2
    neg1 = ql if W >= 1 else np.iinfo(np.int32).max
    for j in range(1, tl + 1):
        prev = col.copy()
        col[0] = j
        match = (q != t[j - 1]).astype(np.int32)
        for i in range(1, ql + 1):
            col[i] = min(prev[i - 1] + match[i - 1], col[i - 1] + 1, prev[i] + 1)
        if W >= 1 and j <= W:
            neg1 = min(neg1, int(col[ql]) + j)
        if col[ql] < best:
            best, best_end = int(col[ql]), j - 1
    if W >= 1 and neg1 <= best:
        return neg1, -1
    if best_end == -2:
        return ql, -1
    return best, best_end


def shw_path(q: np.ndarray, t: np.ndarray):
    """SHW with path: (distance, end, moves over target[0..end])."""
    d, end = shw_end(q, t)
    if end < 0:
        return d, end, np.full(len(q), OP_INSERT, np.uint8)
    d2, moves = nw_path(q, t[: end + 1])
    return d, end, moves


def ksw_extend2(
    q, t, mat5, o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop, h0
):
    """ksw_extend2 equivalent; returns (score, qle, tle, gtle, gscore)."""
    q, t = _as_u8(q), _as_u8(t)
    mat = np.ascontiguousarray(mat5, dtype=np.int8)
    lib = _load()
    if lib is None:
        return _ksw_extend2_np(
            q, t, mat, o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop, h0
        )
    qle = ctypes.c_int32(0)
    tle = ctypes.c_int32(0)
    gtle = ctypes.c_int32(0)
    gscore = ctypes.c_int32(0)
    max_off = ctypes.c_int32(0)
    sc = lib.sw_extend(
        len(q), q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(t), t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        5, mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop, h0,
        ctypes.byref(qle), ctypes.byref(tle), ctypes.byref(gtle),
        ctypes.byref(gscore), ctypes.byref(max_off),
    )
    return int(sc), int(qle.value), int(tle.value), int(gtle.value), int(gscore.value)


def _ksw_extend2_np(q, t, mat, o_del, e_del, o_ins, e_ins, w, end_bonus,
                    zdrop, h0):
    """Reference-semantics fallback (slow python)."""
    qlen, tlen = len(q), len(t)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = mat.reshape(5, 5)[:, q].astype(np.int32)  # (5, qlen) profile
    H = np.zeros(qlen + 1, np.int32)
    E = np.zeros(qlen + 1, np.int32)
    H[0] = h0
    H[1] = h0 - oe_ins if h0 > oe_ins else 0
    j = 2
    while j <= qlen and H[j - 1] > e_ins:
        H[j] = H[j - 1] - e_ins
        j += 1
    max_sc = int(mat.max())
    max_ins = max(int((qlen * max_sc + end_bonus - o_ins) / e_ins + 1.0), 1)
    max_del = max(int((qlen * max_sc + end_bonus - o_del) / e_del + 1.0), 1)
    w = min(w, max_ins, max_del)
    best, bi, bj, bie, gscore, beg, end = h0, -1, -1, -1, -1, 0, qlen
    for i in range(tlen):
        f = 0
        hrow = qp[t[i]]
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        h1 = max(h0 - (o_del + e_del * (i + 1)), 0) if beg == 0 else 0
        rmax, rmax_j = 0, -1
        for j in range(beg, end):
            M, e = int(H[j]), int(E[j])
            H[j] = h1
            M = M + int(hrow[j]) if M else 0
            h = max(M, e, f)
            h1 = h
            if rmax <= h:  # ksw.c:437: ties move mj to the LAST j
                rmax, rmax_j = h, j
            tmp = max(M - oe_del, 0)
            e = max(e - e_del, tmp)
            E[j] = e
            tmp = max(M - oe_ins, 0)
            f = max(f - e_ins, tmp)
        H[end] = h1
        E[end] = 0
        if end == qlen and h1 >= gscore:
            bie, gscore = i, h1
        if rmax == 0:
            break
        if rmax > best:
            best, bi, bj = rmax, i, rmax_j
        elif zdrop > 0:
            if i - bi > rmax_j - bj:
                if best - rmax - ((i - bi) - (rmax_j - bj)) * e_del > zdrop:
                    break
            else:
                if best - rmax - ((rmax_j - bj) - (i - bi)) * e_ins > zdrop:
                    break
        j = beg
        while j < end and H[j] == 0 and E[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and H[j] == 0 and E[j] == 0:
            j -= 1
        end = min(j + 2, qlen)
    return best, bj + 1, bi + 1, bie + 1, gscore


def build_ksw_matrix(match: int, mismatch: int) -> np.ndarray:
    """5x5 score matrix like initializeFAST (src/LordFAST.cpp:166-187)."""
    mat = np.zeros(25, np.int8)
    k = 0
    for i in range(4):
        for j in range(4):
            mat[k] = match if i == j else -mismatch
            k += 1
        mat[k] = 0
        k += 1
    return mat


def ksw_global2(q, t, mat5, o_del, e_del, o_ins, e_ins, w):
    """Banded global affine alignment with CIGAR, semantics of
    ksw_global2 (lib/bwa/ksw.c:504-606) including the
    direction-bit traceback convention (z cell = f<<4 | e<<2 | h; the
    `which` state machine reads 2 bits selected by the previous move).
    Returns (score, cigar) with cigar a list of (op, len), op in
    'MID'.  Pure Python — used only by the dormant alignChain_ksw mode
    (src/LordFAST.cpp:213 hardcodes alignChain_edlib)."""
    q = _as_u8(q)
    t = _as_u8(t)
    mat = np.asarray(mat5, np.int64).reshape(5, 5)
    qlen, tlen = len(q), len(t)
    NEG = -0x40000000
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    n_col = min(qlen, 2 * w + 1)
    z = np.zeros((max(tlen, 1), max(n_col, 1)), np.uint8)
    H = np.full(qlen + 2, NEG, np.int64)
    E = np.full(qlen + 2, NEG, np.int64)
    H[0] = 0
    for j in range(1, qlen + 1):
        if j <= w:
            H[j] = -(o_ins + e_ins * j)
        else:
            break
    for i in range(tlen):
        f = NEG
        beg = i - w if i > w else 0
        end = min(i + w + 1, qlen)
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else NEG
        qp = mat[t[i]]
        for j in range(beg, end):
            m = H[j]
            e = E[j]
            H[j] = h1
            m += qp[q[j]]
            d = 0 if m >= e else 1
            h = m if m >= e else e
            d = d if h >= f else 2
            h = h if h >= f else f
            h1 = h
            tt = m - oe_del
            e -= e_del
            d |= (1 << 2) if e > tt else 0
            e = e if e > tt else tt
            E[j] = e
            tt = m - oe_ins
            f -= e_ins
            d |= (2 << 4) if f > tt else 0
            f = f if f > tt else tt
            z[i, j - beg] = d
        H[end] = h1
        E[end] = NEG
    score = int(H[qlen])
    # backtrack
    cigar = []  # list of [op, len], op 0=M 1=I 2=D (ksw codes)

    def push(op, ln):
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += ln
        else:
            cigar.append([op, ln])

    i = tlen - 1
    k = min(i + w + 1, qlen) - 1
    which = 0
    while i >= 0 and k >= 0:
        beg = i - w if i > w else 0
        which = (z[i, k - beg] >> (which << 1)) & 3
        if which == 0:
            push(0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            push(2, 1)
            i -= 1
        else:
            push(1, 1)
            k -= 1
    if i >= 0:
        push(2, i + 1)
    if k >= 0:
        push(1, k + 1)
    cigar.reverse()
    return score, [("MID"[op], ln) for op, ln in cigar]


def ksw_global(q, t, mat5, gapo, gape, w):
    """ksw_global thin wrapper (ksw.c:608-610)."""
    return ksw_global2(q, t, mat5, gapo, gape, gapo, gape, w)
