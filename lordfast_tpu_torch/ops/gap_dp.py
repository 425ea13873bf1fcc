"""Batched gap DP in PyTorch: sequence gather and the plain Myers
distance fill.

Port of the distance half of ``lordfast_tpu/ops/gap_dp.py``: Myers
bit-parallel NW / SHW edit distance (edlib's calculateBlock,
lib/edlib/edlib.cpp:334-369, NW/SHW drivers :475-870) over padded gap
buckets, returning each gap's distance and alignment end.  The main path
needs no in-kernel traceback: the host stitcher rebuilds every path with
the bit-exact banded edlib traceback (native edlib_path.cpp) from the
distance.

``myers_dist_plain`` is the plain PyTorch version of the CUDA kernel in
``gap_dp_cuda.py``.  It advances all gaps of a batch column by column;
inside a column the W 32-bit words are updated at once, with the
addition carry passed between words by a prefix scan — the same DP as
edlib's word-by-word hin/hout chain, so every cell value is exact.

SHW reproduces the edlib negative-end artifact (native/align_eq.cpp
shw_best_end): with W64 = (64 - ql % 64) % 64, the virtual position -1
scores ``min(ql, min_{1<=j<=min(W64,tl)} d_j + j)`` and wins ties, in
which case end = -1.
"""

from __future__ import annotations

import torch

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


def myers_dist_plain(qs, ql, ts, tl, is_shw, Q: int, T: int):
    """Batched NW/SHW Myers edit distance: (dist, end), each (G,) int32.

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
    dev = qs.device
    ql = ql.long()
    tl = tl.long()
    if G == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z.clone()
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
    return dist.to(torch.int32), end.to(torch.int32)
