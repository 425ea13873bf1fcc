"""Batched gap DP in PyTorch: sequence gather, the plain Myers distance
fill and the plain Myers fill with traceback.

Port of ``lordfast_tpu/ops/gap_dp.py`` and of the host side of
``gap_dp_pallas.py``: Myers bit-parallel NW / SHW edit distance (edlib's
calculateBlock, lib/edlib/edlib.cpp:334-369, NW/SHW drivers :475-870)
over padded gap buckets.  The main path needs only each gap's distance
and alignment end: the host stitcher rebuilds every path with the
bit-exact banded edlib traceback (native edlib_path.cpp).  The
escalation offload's secondary segments also take the path, as the
Pallas kernel's per-column codes (``myers_moves_plain``), and those edlib
would align by Hirschberg splitting are first split as edlib splits them
(``myers_dist_plain(want_col=True)``, ``column_scores``,
``hirschberg_split``).

``myers_dist_plain`` and ``myers_moves_plain`` are the plain PyTorch
versions of the CUDA kernels in ``gap_dp_cuda.py``.  They advance all
gaps of a batch column by column; inside a column the W 32-bit words are
updated at once, with the addition carry passed between words by a
prefix scan — the same DP as edlib's word-by-word hin/hout chain, so
every cell value is exact.

SHW reproduces the edlib negative-end artifact (native/align_eq.cpp
shw_best_end): with W64 = (64 - ql % 64) % 64, the virtual position -1
scores ``min(ql, min_{1<=j<=min(W64,tl)} d_j + j)`` and wins ties, in
which case end = -1.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# move codes (edlib convention, matching native/align_eq.cpp)
OP_MATCH, OP_INSERT, OP_DELETE, OP_MISMATCH = 0, 1, 2, 3

INT32_MAX = 2**31 - 1
M32 = 0xFFFFFFFF


def _build_peq(qs, W: int):
    """(G, 5, W) match masks as int64 holding uint32: bit r of
    peq[g, c, w] is set iff qs[g, w*32 + r] == c.  Rows >= ql never
    matter: within a column, carries run from low rows to high rows only,
    and padding rows sit above every valid row."""
    G = qs.shape[0]
    q = qs[:, : W * 32].long()
    eq = q[:, None, :] == torch.arange(5, device=qs.device)[None, :, None]
    bits = torch.arange(32, device=qs.device)
    return (eq.view(G, 5, W, 32).long() << bits).sum(-1)


def gather_gap_seqs(pac_words, reads, desc, Q: int, T: int, l_pac: int):
    """Gather the padded (qs, ql, ts, tl) code tensors of a gap
    descriptor table from the resident read batch and the packed genome.

    desc: dict of (G,) tensors on the reads' device —
      q_read  int32   row into ``reads``
      q_start int32   query slice start (pre-reversal coordinates)
      q_len   int32   query length (>= 1 for valid gaps)
      q_rc    bool    reverse-complement the query slice
      t_start int64   global target start (pre-reversal coordinates)
      t_len   int32   target length (>= 1)
      t_rc    bool    reverse-complement the target slice
      valid   bool    inactive rows are aligned as (1,1) dummies

    Query codes come from the strand-oriented read row; target codes from
    the forward genome with out-of-range positions reading 0 ('A')
    (index/container.py get_ref_codes padding), reverse complement
    applied after slicing (chain_align.py _rc).  Returns qs (G, Q) uint8,
    ql (G,) int32, ts (G, T) uint8, tl (G,) int32."""
    dev = reads.device
    ql = torch.where(desc["valid"], desc["q_len"].long(), 1).clamp(min=1)
    tl = torch.where(desc["valid"], desc["t_len"].long(), 1).clamp(min=1)
    Lr = reads.shape[1]

    j_q = torch.arange(Q, device=dev)[None, :]
    q_rc = desc["q_rc"][:, None]
    q0 = desc["q_start"].long()[:, None]
    qpos = torch.where(q_rc, q0 + ql[:, None] - 1 - j_q, q0 + j_q)
    q_ok = (j_q < ql[:, None]) & (qpos >= 0) & (qpos < Lr)
    qg = reads[desc["q_read"].long()[:, None], qpos.clamp(0, Lr - 1)].long()
    qg = torch.where(q_rc & (qg < 4), 3 - qg, qg)
    qs = torch.where(q_ok, qg, 4).to(torch.uint8)

    # target: gather the contiguous packed words covering
    # [t_start, t_start+T) — T/16+1 words per gap — unpack them into a
    # local code window, then index that window per element
    NWt = T // 16 + 1
    t0 = desc["t_start"].long()
    base = t0.clamp(min=0) >> 4
    max_row = (2 * l_pac - 1) >> 4
    rows = (base[:, None] + torch.arange(NWt, device=dev)).clamp(0, max_row)
    sh16 = 2 * (15 - torch.arange(16, device=dev))
    win = ((pac_words[rows][:, :, None] >> sh16) & 3).reshape(-1, NWt * 16)

    j_t = torch.arange(T, device=dev)[None, :]
    t_rc = desc["t_rc"][:, None]
    tpos = torch.where(t_rc, t0[:, None] + tl[:, None] - 1 - j_t,
                       t0[:, None] + j_t)
    t_in = (tpos >= 0) & (tpos < l_pac)
    widx = (tpos - (base[:, None] << 4)).clamp(0, NWt * 16 - 1)
    tg = torch.where(t_in, win.gather(1, widx), 0)  # pad 0 like get_ref_codes
    tg = torch.where(t_rc, 3 - tg, tg)
    ts = torch.where(j_t < tl[:, None], tg, 0).to(torch.uint8)
    return qs, ql.to(torch.int32), ts, tl.to(torch.int32)


def _carry_in(g, p):
    """Carry into each word of a multi-word addition, from per-word
    generate (g) and propagate (p) flags: c_0 = 0 and
    c_w = g_{w-1} | (p_{w-1} & c_{w-1}), by a Hillis-Steele scan."""
    W = g.shape[1]
    d = 1
    while d < W:
        gl = torch.nn.functional.pad(g[:, :-d], (d, 0), value=False)
        pl = torch.nn.functional.pad(p[:, :-d], (d, 0), value=True)
        g = g | (p & gl)
        p = p & pl
        d <<= 1
    return torch.nn.functional.pad(g[:, :-1], (1, 0), value=False).long()


def myers_dist_plain(qs, ql, ts, tl, is_shw, Q: int, T: int,
                     want_col: bool = False):
    """Batched NW/SHW Myers edit distance: (dist, end), each (G,) int32,
    and with ``want_col`` the last column's words ``col`` (2, Q/32, G)
    int32 holding uint32: col[0] the Pv words and col[1] the Mv words
    after column tl-1, bits of rows >= ql cleared (column_scores).

    qs: (G, Q) uint8 query codes (0..4), rows >= ql arbitrary
    ql: (G,) int32, 1 <= ql <= Q
    ts: (G, T) uint8 target codes, cols >= tl arbitrary
    tl: (G,) int32, 1 <= tl <= T
    is_shw: (G,) bool — True: prefix mode (trailing target free);
            False: global NW (end = tl - 1).

    The fill of JAX gap_dp.gap_align (:126-178) without the traceback.
    Columns run to the batch's deepest tl and words to its widest bottom
    word only: columns at or beyond a gap's tl feed none of its outputs,
    and words above its bottom word cannot change the bottom row."""
    G = qs.shape[0]
    col = torch.zeros((2, Q // 32, G), dtype=torch.int32, device=qs.device)
    if G == 0:
        z = torch.zeros(0, dtype=torch.int32, device=qs.device)
        return (z, z.clone(), col) if want_col else (z, z.clone())
    ql = ql.long()
    dist, end, last = _myers_fill(qs, ql, ts, tl.long(), is_shw,
                                  keep_last=want_col)
    out = (dist.to(torch.int32), end.to(torch.int32))
    if not want_col:
        return out
    # clear the bits of rows >= ql, then store the uint32 words as int32
    Wn = last.shape[2]
    lo = 32 * torch.arange(Wn, device=qs.device)[None, :]
    n = (ql[:, None] - lo).clamp(0, 32)
    keep = (1 << n) - 1
    for i in range(2):
        w = last[i] & keep
        col[i, :Wn] = torch.where(w >= 2**31, w - 2**32, w).T.to(torch.int32)
    return (*out, col)


def _myers_fill(qs, ql, ts, tl, is_shw, keep_planes: bool = False,
                keep_last: bool = False):
    """The batched Myers fill of myers_dist_plain: (dist, end, extra),
    dist/end (G,) int64.  keep_planes: extra = (up, left), each
    (Tn, G, Wn) int64 holding uint32 words — the Pallas kernel's two
    decision planes: ``up`` the Pv word after column c, ``left`` the
    pre-shift Ph word of column c (gap_dp_pallas.py:143-144).
    keep_last: extra = (2, G, Wn) int64, the Pv and Mv words after each
    gap's column tl-1.  Else extra is None."""
    G = qs.shape[0]
    dev = qs.device
    bw = (ql - 1) >> 5          # word of the bottom row
    bb = (ql - 1) & 31          # its bit
    Wn = int(bw.max()) + 1
    Tn = int(tl.max())
    peq = _build_peq(qs, Wn)    # (G, 5, Wn)
    w64 = (64 - ql % 64) % 64   # edlib WORD_SIZE=64 padding (artifact)
    neg1_cap = torch.minimum(w64, tl)
    ts_l = ts.long()

    Pv = torch.full((G, Wn), M32, dtype=torch.int64, device=dev)
    Mv = torch.zeros((G, Wn), dtype=torch.int64, device=dev)
    score = ql.clone()          # D(ql-1, -1) = ql
    nw_dist = torch.full((G,), INT32_MAX, dtype=torch.int64, device=dev)
    best = nw_dist.clone()
    best_end = torch.full((G,), -2, dtype=torch.int64, device=dev)
    # the j = 0 term of position -1 is d_0 + 0 = ql (only when W64 >= 1)
    neg1 = torch.where(w64 >= 1, ql, INT32_MAX)
    one_col = torch.ones((G, 1), dtype=torch.int64, device=dev)
    zero_col = torch.zeros((G, 1), dtype=torch.int64, device=dev)
    bw_i = bw[:, None]
    planes = last = None
    if keep_last:
        last = torch.zeros((2, G, Wn), dtype=torch.int64, device=dev)
    if keep_planes:
        planes = (torch.empty((Tn, G, Wn), dtype=torch.int64, device=dev),
                  torch.empty((Tn, G, Wn), dtype=torch.int64, device=dev))
    for c in range(Tn):
        eq = peq.gather(1, ts_l[:, c].view(G, 1, 1).expand(G, 1, Wn))[:, 0]
        xv = eq | Mv
        s = (eq & Pv) + Pv
        lo = s & M32
        s = (lo + _carry_in(s > M32, lo == M32)) & M32
        xh = (s ^ Pv) | eq
        ph = Mv | ((xh | Pv) ^ M32)
        mh = Pv & xh
        # the top boundary feeds hin = +1 into word 0; word w takes word
        # w-1's top Ph/Mh bit (edlib's hout -> hin chain)
        ph_s = ((ph << 1) & M32) | torch.cat([one_col, ph[:, :-1] >> 31], 1)
        mh_s = ((mh << 1) & M32) | torch.cat([zero_col, mh[:, :-1] >> 31],
                                             1)
        Pv = mh_s | ((xv | ph_s) ^ M32)
        Mv = ph_s & xv
        if planes is not None:
            planes[0][c] = Pv
            planes[1][c] = ph
        if last is not None:
            at_end = (tl - 1 == c)[:, None]
            last[0] = torch.where(at_end, Pv, last[0])
            last[1] = torch.where(at_end, Mv, last[1])
        score = (score + ((ph.gather(1, bw_i)[:, 0] >> bb) & 1)
                 - ((mh.gather(1, bw_i)[:, 0] >> bb) & 1))
        nw_dist = torch.where(tl - 1 == c, score, nw_dist)
        in_range = c < tl
        upd = in_range & (score < best)
        best_end = torch.where(upd, c, best_end)
        best = torch.where(upd, score, best)
        neg1 = torch.where(in_range & (c + 1 <= neg1_cap),
                           torch.minimum(neg1, score + c + 1), neg1)

    # SHW resolution incl. the artifact and empty-target guards
    use_neg1 = (w64 >= 1) & (neg1 <= best)
    shw_dist = torch.where(use_neg1, neg1,
                           torch.where(best_end == -2, ql, best))
    shw_end = torch.where(use_neg1 | (best_end == -2), -1, best_end)
    dist = torch.where(is_shw, shw_dist, nw_dist)
    end = torch.where(is_shw, shw_end, tl - 1)
    return dist, end, planes if keep_planes else last


def _high_bit(z):
    """Index of the highest set bit of each int64 word (0 < z < 2^32),
    by a 5-step binary search; arbitrary where z == 0."""
    hb = torch.zeros_like(z)
    for s in (16, 8, 4, 2, 1):
        t = z >> s
        has = t != 0
        hb = hb + torch.where(has, s, 0)
        z = torch.where(has, t, z)
    return hb


def myers_moves_plain(qs, ql, ts, tl, is_shw, Q: int, T: int):
    """Batched NW/SHW Myers alignment with path: (dist, end, lead,
    colcode) — the outputs of the Pallas kernels gap_dp_pallas
    ``_make_kernel`` (:84) / ``_make_kernel_tiled`` (:290).

    Inputs as myers_dist_plain.  dist/end/lead (G,) int32; colcode
    (T, G) int16 holding the kernel's uint16 ``(run << 2) | move`` per
    column, zero past ``end``; ``lead`` counts the path-leading inserts.
    Forward path = [INSERT]*lead + concat_{c=0..end}([move_c] +
    [INSERT]*run_c) (decode_col_moves).

    The fill keeps the two decision planes; the traceback walks the
    columns from the batch's deepest tl down to 0 in lockstep (a gap is
    active at columns c <= end), as gap_dp_pallas.py:188-239: the run of
    consume-query moves in column c is the run of set "up" bits at and
    below the current row r, ending at the highest clear bit p <= r; at
    p the move is DELETE when p < 0 or the "left" bit is set, else MATCH
    or MISMATCH by q[p] == t[c] (N equals N, as Peq row 4)."""
    G = qs.shape[0]
    dev = qs.device
    colcode = torch.zeros((T, G), dtype=torch.int16, device=dev)
    if G == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z.clone(), z.clone(), colcode
    ql = ql.long()
    tl = tl.long()
    dist, end, (up, left) = _myers_fill(qs, ql, ts, tl, is_shw,
                                        keep_planes=True)
    Tn, _, Wn = up.shape
    qs_l = qs.long()
    ts_l = ts.long()
    wbase = 32 * torch.arange(Wn, device=dev)[None, :]
    r = ql - 1
    for c in range(Tn - 1, -1, -1):
        active = c <= end
        rel = r[:, None] - wbase                          # (G, Wn)
        mask = torch.where(
            rel < 0, 0,
            torch.where(rel >= 31, M32, (1 << (rel.clamp(0, 30) + 1)) - 1))
        z = (up[c] ^ M32) & mask
        p = torch.where(z != 0, wbase + _high_bit(z), -1).amax(1)
        run = r - p
        pc = p.clamp(min=0)
        leftb = (left[c].gather(1, (pc >> 5)[:, None])[:, 0] >> (pc & 31)) & 1
        eqb = qs_l.gather(1, pc[:, None])[:, 0] == ts_l[:, c]
        is_del = (p < 0) | (leftb == 1)
        mv = torch.where(is_del, OP_DELETE,
                         torch.where(eqb, OP_MATCH, OP_MISMATCH))
        colcode[c] = torch.where(active, mv | (run << 2), 0).to(torch.int16)
        r = torch.where(active, torch.where(is_del, p, p - 1), r)
    return (dist.to(torch.int32), end.to(torch.int32),
            (r + 1).to(torch.int32), colcode)


def decode_col_moves(colcode_tg: np.ndarray, end: np.ndarray,
                     lead: np.ndarray) -> list:
    """Host side: expand per-column (run, move) codes into forward move
    arrays (uint8 OP_* codes), one per gap, with the native decoder
    (native align_eq.cpp decode_colcodes).  colcode_tg is the kernels'
    (T, G) layout, int16 or uint16; end/lead (G,)."""
    from .. import native

    lib = native._load()
    g = len(end)
    T = colcode_tg.shape[0]
    col = np.ascontiguousarray(colcode_tg.T[:g]).view(np.uint16)
    ends = np.ascontiguousarray(end, dtype=np.int64)
    leads = np.ascontiguousarray(lead, dtype=np.int64)
    # exact size: lead inserts + one move per emitted column + the insert
    # runs encoded in the codes (columns past `end` are zero, so a
    # full-row sum is the true run total)
    total_runs = int((col.astype(np.int64) >> 2).sum())
    cap = max(int(leads.sum() + (ends + 1).clip(0).sum() + total_runs), 64)
    out = np.empty(cap, np.uint8)
    offs = np.empty(g, np.int64)
    lens = np.empty(g, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    total = lib.decode_colcodes(
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        T, ends.ctypes.data_as(i64p), leads.ctypes.data_as(i64p), g,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        offs.ctypes.data_as(i64p), lens.ctypes.data_as(i64p),
    )
    if total < 0:
        raise RuntimeError("decode_colcodes: move buffer too small")
    return [out[offs[i] : offs[i] + lens[i]] for i in range(g)]


def column_scores(col_g: np.ndarray, ql: int, width: int) -> np.ndarray:
    """Host side: the scores D(r, width-1), r = 0..ql-1, of the column
    that myers_dist's ``col`` output holds for one gap (col_g = col[:, :,
    g], the Pv then the Mv words of a fill over ``width`` target columns):
    the top boundary D(-1, width-1) = width plus the running sum of the
    vertical deltas."""
    bits = np.unpackbits(np.ascontiguousarray(col_g).view(np.uint8)
                         .reshape(2, -1), axis=1, bitorder="little")[:, :ql]
    return width + np.cumsum(bits[0].astype(np.int64) - bits[1])


def hirschberg_split(left: np.ndarray, right: np.ndarray, lhw: int,
                     rhw: int):
    """edlib's Hirschberg split of an NW alignment of q (length ql) vs t
    (length lhw + rhw, lhw = floor(len(t) / 2)): lib/edlib/edlib.cpp:
    1161-1345, native edlib_path.cpp obtainAlignmentHirschberg.

    left = column_scores of the fill of q vs t[:lhw]; right = those of
    the fill of reversed q vs reversed t[lhw:] (row r' is q[ql-1-r':]).
    The split puts the first k query codes with t[:lhw] and the rest with
    t[lhw:]: edlib scans the query rows i = k - 1 = 0..ql-2 for the first
    with left + right == best, then tries i = -1 (k = 0), then i = ql - 1
    (k = ql).  edlib scans only the rows of its banded fills, but those
    hold every row of an optimal path, and a banded score is never below
    the exact one, so the first exact hit is edlib's.  Returns (k, best =
    the NW distance)."""
    ql = len(left)
    lx = np.concatenate([[lhw], left])          # lx[k]: q[:k] vs t[:lhw]
    rx = np.concatenate([right[::-1], [rhw]])   # rx[k]: q[k:] vs t[lhw:]
    s = lx + rx
    best = int(s.min())
    hit = np.flatnonzero(s[1:ql] == best)
    k = int(hit[0]) + 1 if len(hit) else (0 if s[0] == best else ql)
    return k, best
