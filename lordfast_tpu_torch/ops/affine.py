"""Batched affine-gap extension (ksw_extend2 semantics) in PyTorch — the
device path of the clip / split escalation DPs.

Port of ``lordfast_tpu/ops/affine_pl.py``.  Reference semantics:
lib/bwa/ksw.c:380-479 (banded, z-drop, end-bonus extension); the
byte-exactness oracle is the host scalar port native/align_eq.cpp
sw_extend (align.edlib_eq.ksw_extend2).  Only scores and end positions
are produced: callers re-run the Myers NW on the trimmed segments
(src/LordFAST.cpp:1850,1998).

``extend_batch_plain`` is the plain PyTorch version of the CUDA kernel
(``affine_cuda.extend_batch_cuda``, csrc/affine_ext.cu).  It holds the
recurrences of the Pallas kernel ``_make_kernel`` (affine_pl.py:85-272)
over a (G, BW) band, row by row: at target row i, band slot k holds
query column j = i - w_max + k, so the diagonal predecessor lives in the
same slot, E and the query band shift by one slot per row, and the F
chain of ksw.c:441-447 takes its closed form, an exclusive prefix max
along the band.  The adaptive interval [beg, end) (band clamp and
dead-cell shrink), the h0-decay first row, the frontier writes, the
latest-row gscore rule, the last-argmax row max, z-drop timing and the
all-zero-row break are masked updates, as in the Pallas kernel (see its
docstring, affine_pl.py:16-40, for why each is exact).

``extend_batch`` dispatches by device: the plain version for CPU
tensors, the CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .gap_dp import gather_gap_seqs

NEG_BIG = -(1 << 30)
POS_BIG = 1 << 30
PARAM_NAMES = ("o_del", "e_del", "o_ins", "e_ins", "w_eff", "zdrop", "h0",
               "match", "mismatch")


class ExtendResult(NamedTuple):
    score: torch.Tensor    # (G,) int32 best extension score (>= h0)
    qle: torch.Tensor      # (G,) int32 query length of best cell (0 if none)
    tle: torch.Tensor      # (G,) int32 target length of best cell
    gtle: torch.Tensor     # (G,) int32 target length reaching the query end
    gscore: torch.Tensor   # (G,) int32 best score reaching the query end
    max_off: torch.Tensor  # (G,) int32 max diagonal offset of the best cell


def clamp_band(qlen, match_sc: int, end_bonus: int, o_del: int, e_del: int,
               o_ins: int, e_ins: int, w: int):
    """Band clamp by max possible #ins/#del (ksw.c:399-407), with the
    reference's exact double-arithmetic `+ 1.` truncation."""
    qlen = np.asarray(qlen, np.int64)
    max_ins = (qlen.astype(np.float64) * match_sc + end_bonus
               - o_ins) / e_ins + 1.0
    max_ins = np.maximum(max_ins.astype(np.int64), 1)
    max_del = (qlen.astype(np.float64) * match_sc + end_bonus
               - o_del) / e_del + 1.0
    max_del = np.maximum(max_del.astype(np.int64), 1)
    return np.minimum(np.minimum(w, max_ins), max_del).astype(np.int32)


def _roll_up(x, s: int, fill):
    """x shifted up by s band slots (slot k takes x[k+s]); the vacated
    top slots get ``fill`` ((G, 1) or a scalar)."""
    top = torch.as_tensor(fill, dtype=x.dtype, device=x.device).expand(
        x.shape[0], s)
    return torch.cat([x[:, s:], top], 1)


def _roll_down(x, s: int, fill):
    """x shifted down by s band slots (slot k takes x[k-s])."""
    bot = torch.full((x.shape[0], s), fill, dtype=x.dtype, device=x.device)
    return torch.cat([bot, x[:, :-s]], 1)


def extend_batch_plain(qs, ts, Qe: int, Te: int, BW: int, w_max: int, *,
                       qlen, tlen, o_del, e_del, o_ins, e_ins, w_eff, zdrop,
                       h0, match, mismatch, return_cells: bool = False):
    """Batched ksw_extend2 in plain PyTorch.  qs (G, Qe) / ts (G, Te)
    uint8 codes; every parameter a (G,) integer tensor; w_eff already
    clamped (clamp_band) and <= w_max, with BW >= 2 * w_max + 2 band
    slots.  Returns ExtendResult; with return_cells also the number of
    band cells the scalar recurrence computes (sum over the rows each
    problem runs of end_r - beg_r; the work measure of a bound).

    Rows run to the batch's deepest tlen and stop once every problem has
    broken off: a problem's outputs do not change after its last row."""
    G = qs.shape[0]
    dev = qs.device
    col = lambda v: v.to(device=dev, dtype=torch.int64).view(G, 1)
    qlen_, tlen_ = col(qlen), col(tlen)
    o_del, e_del = col(o_del), col(e_del)
    o_ins, e_ins = col(o_ins), col(e_ins)
    w_eff, zdrop, h0 = col(w_eff), col(zdrop), col(h0)
    match, mismatch = col(match), col(mismatch)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qs_l = qs.long()
    ts_l = ts.long()
    k = torch.arange(BW, device=dev).view(1, BW)

    def init_decay(jcol):
        """The scalar first row H[j] (shifted; value of column j-1):
        H[0]=h0; H[1]=max(h0-oe_ins,0); H[j]=max(H[1]-(j-1)e_ins,0)."""
        h1v = (h0 - oe_ins).clamp(min=0)
        return torch.where(jcol <= 0, h0, (h1v - (jcol - 1) * e_ins)
                           .clamp(min=0))

    j_init = k - w_max
    Hband = torch.where((j_init >= 0) & (j_init <= qlen_),
                        init_decay(j_init), 0)
    Eband = torch.zeros((G, BW), dtype=torch.int64, device=dev)
    qband = torch.where((j_init >= 0) & (j_init < qlen_),
                        qs_l.gather(1, j_init.clamp(0, Qe - 1).expand(G, BW)),
                        4)
    beg = torch.zeros((G, 1), dtype=torch.int64, device=dev)
    end = qlen_.clone()
    best = h0.clone()
    best_i = torch.full((G, 1), -1, dtype=torch.int64, device=dev)
    best_j = best_i.clone()
    best_ie = best_i.clone()
    gscore = best_i.clone()
    moff = torch.zeros((G, 1), dtype=torch.int64, device=dev)
    active = torch.ones((G, 1), dtype=torch.bool, device=dev)
    cells = torch.zeros((G, 1), dtype=torch.int64, device=dev)
    n_rows = int(tlen_.max()) if G else 0

    for i in range(n_rows):
        act = active & (i < tlen_)
        if not bool(act.any()):
            break
        t_i = ts_l[:, i : i + 1]
        j_mat = (i - w_max) + k
        # band clamp for this row (ksw.c:414-416)
        beg_r = torch.maximum(beg, i - w_eff)
        end_r = torch.minimum(torch.minimum(end, i + w_eff + 1), qlen_)
        in_band = (j_mat >= beg_r) & (j_mat < end_r)
        if return_cells:
            cells += torch.where(act, (end_r - beg_r).clamp(min=0), 0)
        h1_init = torch.where(
            beg_r == 0, (h0 - (o_del + e_del * (i + 1))).clamp(min=0), 0)
        s = torch.where((qband >= 4) | (t_i >= 4), 0,
                        torch.where(qband == t_i, match, -mismatch))
        M = torch.where((Hband != 0) & in_band, Hband + s, 0)
        # F chain: exclusive prefix-max of A = max(M-oe_ins,0)+k*e_ins
        inc = torch.where(in_band, (M - oe_ins).clamp(min=0) + k * e_ins,
                          NEG_BIG)
        sh = 1
        while sh < BW:
            inc = torch.maximum(inc, _roll_down(inc, sh, NEG_BIG))
            sh *= 2
        p_excl = _roll_down(inc, 1, NEG_BIG)
        f = (p_excl - (k - 1) * e_ins).clamp(min=0)
        h = torch.maximum(torch.maximum(M, Eband), f)
        h = torch.where(in_band, h, 0)
        # row stats: the scalar row max starts at 0 and moves to the LAST
        # j achieving the running max (ksw.c:437)
        rm = h.amax(1, keepdim=True)
        rmj = torch.where(in_band & (h == rm) & (rm > 0), j_mat,
                          -1).amax(1, keepdim=True)
        # gscore: the scalar code checks j == qlen after the row, where
        # j = end_r if the row ran else beg_r, with h1 = h(i, end_r-1)
        # resp. h1_init (empty row)
        loop_ran = beg_r < end_r
        h_last = torch.where(j_mat == end_r - 1, h, NEG_BIG).amax(
            1, keepdim=True)
        h_after = torch.where(loop_ran, h_last, h1_init)
        reach = torch.where(loop_ran, end_r, beg_r) == qlen_
        gupd = act & reach & (h_after >= gscore)
        gscore = torch.where(gupd, h_after, gscore)
        best_ie = torch.where(gupd, i, best_ie)
        # break on a dead row, then best / z-drop (ksw.c:451-461)
        brk0 = rm == 0
        imp = act & ~brk0 & (rm > best)
        moff = torch.where(imp, torch.maximum(moff, (rmj - i).abs()), moff)
        best = torch.where(imp, rm, best)
        best_i = torch.where(imp, i, best_i)
        best_j = torch.where(imp, rmj, best_j)
        di = i - best_i
        dj = rmj - best_j
        del_side = di > dj
        zcond = (del_side & (best - rm - (di - dj) * e_del > zdrop)) | (
            ~del_side & (best - rm - (dj - di) * e_ins > zdrop))
        brkz = ~imp & (zdrop > 0) & zcond
        active = act & ~brk0 & ~brkz

        # ---- state for the next row (next-row coordinates) ----
        j_next = j_mat + 1
        hrow_eff = torch.where(j_mat == beg_r - 1, h1_init, h)
        upd_h = (j_next >= beg_r) & (j_next <= end_r)
        # the slot entering at k = BW-1 starts life as the init row
        fill_col = i + 1 - w_max + BW - 1
        h_fill = torch.where(fill_col <= qlen_,
                             init_decay(torch.full_like(qlen_, fill_col)), 0)
        Hband = torch.where(upd_h, hrow_eff, _roll_up(Hband, 1, h_fill))
        # E: updated in [beg_r, end_r), E[end_r] = 0, else unchanged
        Erec = torch.maximum(Eband - e_del, (M - oe_del).clamp(min=0))
        Enew = torch.where(in_band, Erec,
                           torch.where(j_mat == end_r, 0, Eband))
        Eband = _roll_up(Enew, 1, 0)
        # query band roll + the entering column
        q_fill = torch.where(fill_col < qlen_,
                             qs_l[:, min(fill_col, Qe - 1)].view(G, 1), 4)
        qband = _roll_up(qband, 1, q_fill)
        # dead-cell shrink (ksw.c:466-469) on the post-update rows
        nz = (Hband != 0) | (Eband != 0)
        m_f = (j_next >= beg_r) & (j_next < end_r)
        first_nz = torch.where(m_f & nz, j_next, POS_BIG).amin(
            1, keepdim=True)
        beg2 = torch.where(first_nz == POS_BIG, end_r, first_nz)
        m_b = (j_next >= beg2) & (j_next <= end_r)
        last_nz = torch.where(m_b & nz, j_next, NEG_BIG).amax(
            1, keepdim=True)
        last_nz = torch.where(last_nz == NEG_BIG, beg2 - 1, last_nz)
        end2 = torch.minimum(last_nz + 2, qlen_)
        beg = torch.where(active, beg2, beg)
        end = torch.where(active, end2, end)

    out = lambda v: v.view(G).to(torch.int32)
    res = ExtendResult(out(best), out(best_j + 1), out(best_i + 1),
                       out(best_ie + 1), out(gscore), out(moff))
    return (res, int(cells.sum())) if return_cells else res


def extend_batch(qs, ts, Qe: int, Te: int, BW: int, w_max: int, *, qlen,
                 tlen, o_del, e_del, o_ins, e_ins, w_eff, zdrop, h0, match,
                 mismatch) -> ExtendResult:
    """Batched ksw_extend2 (see extend_batch_plain for the arguments):
    CPU tensors run the plain version, CUDA tensors the CUDA kernel
    (affine_cuda.extend_batch_cuda, which needs every parameter as an
    int32 tensor on the card, and sizes its band from w_max; BW is the
    plain version's)."""
    kw = dict(qlen=qlen, tlen=tlen, o_del=o_del, e_del=e_del, o_ins=o_ins,
              e_ins=e_ins, w_eff=w_eff, zdrop=zdrop, h0=h0, match=match,
              mismatch=mismatch)
    if qs.device.type == "cpu":
        return extend_batch_plain(qs, ts, Qe, Te, BW, w_max, **kw)
    from .affine_cuda import extend_batch_cuda

    return extend_batch_cuda(qs, ts, Qe, Te, w_max, **kw)


def extend_from_desc(pac_words, reads, desc, Qe: int, Te: int, BW: int,
                     w_max: int, l_pac: int) -> ExtendResult:
    """Descriptor-driven batched ksw_extend2: gathers the oriented query /
    target code slices from the resident read batch and the packed
    genome (gap_dp.gather_gap_seqs — the Myers descriptors' semantics),
    then runs extend_batch.  desc carries the gather fields plus the
    per-problem int32 parameters o_del, e_del, o_ins, e_ins, w_eff
    (clamp_band), zdrop, h0, match, mismatch."""
    qs, ql, ts, tl = gather_gap_seqs(pac_words, reads, desc, Qe, Te, l_pac)
    return extend_batch(qs, ts, Qe, Te, BW, w_max, qlen=ql, tlen=tl,
                        **{k: desc[k] for k in PARAM_NAMES})
