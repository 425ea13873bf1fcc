"""Per-window seed selection and the chaining DP in PyTorch.

Port of ``lordfast_tpu/ops/chain.py``.  ``select_window_seeds`` mirrors
the seed filtering of calcChainScore / alignWin
(src/LordFAST.cpp:659-680, 995-1018): window [w*rl, (w+2)*rl-1], margin
rl/2, clamped to the contig containing the window midpoint; seeds are
sorted once per read by (strand, tPos) so each window's seed set is a
contiguous range found by binary search.

``chain_dpn2`` is the O(n^2) chaining DP of chain_seeds_n2
(src/Chain.cpp:232-310) as a loop over seeds i (vectorised over windows
and j): reward = chainReward * MIN_ANCHOR_LEN, penalty = 0.1*d +
chainPenalty*log(d) with d = |distR - distT| (src/Chain.cpp:211-225), in
float64 like the reference's double dp[], each product and sum rounded
on its own and log(max(d, 2)) read from one table of libm's values
(``log_table``), which the kernel reads too.  Ties follow the reference:
predecessor = largest j among score ties, chain end = smallest i.
``chain_clasp_sop`` (``-a clasp``) is the same loop with clasp's
sum-of-pairs gap cost and local reset.

On a CUDA tensor ``chain_seeds`` runs both DPs and the backtrack as one
launch of the hand-written kernel ``csrc/chain_dp.cu``
(``chain_cuda.chain_dp``).  The loops here, over seeds (DP) and chain
links (backtrack), one op sequence per step, are its plain version: the
CPU path and the oracle the kernel is held against.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .voting import topk_stable


class WindowSeeds(NamedTuple):
    q_pos: torch.Tensor   # (..., N) int32, sorted by (qPos, seed-list pos)
    t_pos: torch.Tensor   # (..., N) position dtype
    length: torch.Tensor  # (..., N) int32
    valid: torch.Tensor   # (..., N) bool
    n_in_range: torch.Tensor  # (...,) int32: seeds in range before the cap


class ChainBatch(NamedTuple):
    q_pos: torch.Tensor   # (..., N) chain seeds, ascending qPos
    t_pos: torch.Tensor
    length: torch.Tensor
    chain_len: torch.Tensor  # (...,) int32
    score: torch.Tensor      # (...,) float32 (-1 when no seeds, Chain.cpp:62)


class CompactWindows(NamedTuple):
    """Flat list of the windows that need chaining: the top-vote window
    of coarse-mode reads (src/LordFAST.cpp:543-548) and every candidate
    above minScore of fine-mode reads (:875)."""

    read_idx: torch.Tensor  # (K,) int32 index into the batch
    cand_idx: torch.Tensor  # (K,) int32 index into the CandidateBatch row
    win_id: torch.Tensor    # (K,) int32
    is_rev: torch.Tensor    # (K,) bool
    valid: torch.Tensor     # (K,) bool
    n_needed: torch.Tensor  # () int32: true count (may exceed K: overflow)


def need_mask(cands):
    """Which candidates need chaining: fine-mode reads every candidate
    above minScore, coarse-mode reads their top candidate."""
    C = cands.cnt.shape[1]
    cidx = torch.arange(C, device=cands.cnt.device)[None, :]
    return cands.valid & torch.where(
        cands.is_fine[:, None],
        cands.cnt.float() > cands.min_score[:, None],
        cidx == 0,
    )


def compact_candidates(cands, cfg, k_windows: int) -> CompactWindows:
    B, C = cands.cnt.shape
    flat_need = need_mask(cands).reshape(-1)
    key = torch.where(flat_need, cands.cnt.reshape(-1), -1)
    val, pos = topk_stable(key, k_windows)
    ok = val > 0
    b = pos // C
    c = pos % C
    return CompactWindows(
        read_idx=torch.where(ok, b, 0).to(torch.int32),
        cand_idx=torch.where(ok, c, 0).to(torch.int32),
        win_id=torch.where(ok, cands.win_id[b, c], 0),
        is_rev=ok & cands.is_rev[b, c],
        valid=ok,
        n_needed=flat_need.sum().to(torch.int32),
    )


def select_window_seeds(seeds, cw: CompactWindows, read_lens, arrs, cfg,
                        n_sel=None):
    """Gather each compacted window's seeds into fixed-size slots.

    Window geometry and seed filter follow calcChainScore / alignWin
    (src/LordFAST.cpp:659-680, 995-1018): [w*rl, (w+2)*rl-1] +- rl/2,
    clamped to the contig containing the window midpoint."""
    B, MS = seeds.t_pos.shape
    N = n_sel or cfg.max_chain_seeds
    pdt = seeds.t_pos.dtype
    dev = seeds.t_pos.device

    # one composite-key sort per read: (strand, tPos), ties by the
    # original slot — the reference's seed-LIST position (anchors in
    # sample order, occurrences in SA-row order)
    BIGP = 2**40
    key = torch.where(seeds.valid,
                      seeds.is_rev.long() * BIGP + seeds.t_pos.long(), 2**62)
    key_s, x_s = torch.sort(key, dim=1, stable=True)
    t_s = seeds.t_pos.gather(1, x_s)
    q_s = seeds.q_pos.gather(1, x_s)
    l_s = seeds.length.gather(1, x_s)

    rb = cw.read_idx.long()  # (K,)
    rl = read_lens.long()[rb]
    w = cw.win_id.long()
    t_start = w * rl
    t_end = (w + 2) * rl - 1
    margin = rl >> 1
    mid = (t_start + t_end) >> 1
    # contig of the midpoint (bns_pos2rid binary search, src/BWT.cpp:646)
    offs = arrs["contig_offsets"].long()
    ends = arrs["contig_ends"].long()
    rid = (torch.searchsorted(offs, mid, right=True) - 1).clamp(
        0, offs.shape[0] - 1)
    lo = torch.maximum(t_start - margin, offs[rid])  # (K,)
    hi = torch.minimum(t_end + margin, ends[rid] - 1)

    strand = cw.is_rev.long()
    keys_per_win = key_s[rb]  # (K, MS)
    lo_idx = torch.searchsorted(keys_per_win, (strand * BIGP + lo)[:, None])
    hi_idx = torch.searchsorted(keys_per_win, (strand * BIGP + hi)[:, None],
                                right=True)
    lo_idx, hi_idx = lo_idx[:, 0], hi_idx[:, 0]
    n_in_range = torch.where(cw.valid, hi_idx - lo_idx, 0)

    slot = torch.arange(N, device=dev)
    gidx = (lo_idx[:, None] + slot).clamp(0, MS - 1)  # (K, N)
    ok = slot[None, :] < n_in_range.clamp(max=N)[:, None]
    r2 = rb[:, None]
    q = torch.where(ok, q_s[r2, gidx].long(), 0)
    t = torch.where(ok, t_s[r2, gidx].long(), 0)
    ln = torch.where(ok, l_s[r2, gidx].long(), 0)
    so = torch.where(ok, x_s[r2, gidx], 0)

    # sort window seeds by (qPos, seed-list position) for the DP: the
    # reference std::sort's by qPos only (src/Chain.cpp:244), and for
    # the window sizes where exact score ties occur (< 16 seeds)
    # libstdc++ runs insertion sort — stable — so equal-qPos seeds keep
    # their seed-list order
    skey = torch.where(ok, q * 2**31 + so, 2**62)
    o = torch.sort(skey, dim=1, stable=True).indices
    return WindowSeeds(
        q_pos=q.gather(1, o).to(torch.int32),
        t_pos=t.gather(1, o).to(pdt),
        length=ln.gather(1, o).to(torch.int32),
        valid=ok.gather(1, o),
        n_in_range=n_in_range.to(torch.int32),
    )


def _dp_dtype(cfg):
    mode = getattr(cfg, "chain_dp_dtype", "auto")
    if mode == "f32":
        return torch.float32
    # "f64" and "auto": float64, the reference's double dp[]
    return torch.float64


def _finish_chains(ws, dp, prev, q, t, ln, ok, lead, W, N) -> ChainBatch:
    """Pick the best chain end (smallest index among score ties, the
    reference's ascending scan with strict >, src/Chain.cpp:289-293),
    backtrack through prev[], and emit the chain in ascending qPos."""
    dev = dp.device
    jidx = torch.arange(N, device=dev)
    warange = torch.arange(W, device=dev)
    best_score = dp.max(dim=1).values
    any_ok = ok.any(dim=1)
    best_i = (dp == best_score[:, None]).to(torch.uint8).argmax(dim=1)

    # backtrack (reversed): the chain has at most N links; stop early
    # once every window's walk ended (checked every 32 links)
    rev_idx = torch.full((W, N), -1, dtype=torch.int64, device=dev)
    cur = torch.where(any_ok, best_i, -1)
    clen = torch.zeros(W, dtype=torch.int64, device=dev)
    for step in range(N):
        if step % 32 == 0 and not bool((cur >= 0).any()):
            break
        act = cur >= 0
        rev_idx[warange, clen.clamp(max=N - 1)] = torch.where(
            act, cur, rev_idx[warange, clen.clamp(max=N - 1)])
        cur = torch.where(act, prev[warange, cur.clamp(min=0)], -1)
        clen = clen + act.long()

    # chain[j] = rev_idx[clen-1-j]
    pos = (clen[:, None] - 1 - jidx).clamp(0, N - 1)
    cvalid = jidx[None, :] < clen[:, None]
    cidx = rev_idx.gather(1, pos).clamp(0, N - 1)

    gq = torch.where(cvalid, q.gather(1, cidx), 0)
    gt = torch.where(cvalid, t.gather(1, cidx), 0)
    gl = torch.where(cvalid, ln.gather(1, cidx), 0)

    score = torch.where(any_ok, best_score, -1.0).to(torch.float32)
    return ChainBatch(
        q_pos=gq.reshape(*lead, N).to(torch.int32),
        t_pos=gt.reshape(*lead, N).to(ws.t_pos.dtype),
        length=gl.reshape(*lead, N).to(torch.int32),
        chain_len=torch.where(any_ok, clen, 0).reshape(lead).to(torch.int32),
        score=score.reshape(lead),
    )


def _flatten_ws(ws):
    lead = tuple(ws.q_pos.shape[:-1])
    N = ws.q_pos.shape[-1]
    W = 1
    for d in lead:
        W *= d
    q = ws.q_pos.reshape(W, N).to(torch.int32)
    t = ws.t_pos.reshape(W, N).long()
    ln = ws.length.reshape(W, N).to(torch.int32)
    ok = ws.valid.reshape(W, N)
    return lead, N, W, q, t, ln, ok


def chain_seeds(ws: WindowSeeds, cfg, plain: bool = False) -> ChainBatch:
    """Dispatch on cfg.chain_alg (--chainAlg, src/CommandLineParser.cpp:216;
    call sites src/LordFAST.cpp:1030-1050,1119-1135).  A CUDA tensor goes
    to the kernel (chain_cuda.chain_dp: every window to its own count,
    which is both routes of _chain_bucketed at once), a CPU tensor, or
    ``plain`` (the smoke's and the tests' comparison pass), to
    _chain_bucketed and the plain loops."""
    if ws.q_pos.device.type == "cuda" and not plain:
        from .chain_cuda import chain_dp

        return chain_dp(ws, cfg)
    return _chain_bucketed(ws, cfg, dp_function(cfg))


def dp_function(cfg):
    """The plain DP of cfg.chain_alg: chain_clasp_sop or chain_dpn2."""
    from ..config import ChainAlg

    return (chain_clasp_sop if cfg.chain_alg == ChainAlg.CLASP
            else chain_dpn2)


def _tree_map_ws(ws: WindowSeeds, f) -> WindowSeeds:
    return WindowSeeds(
        q_pos=f(ws.q_pos), t_pos=f(ws.t_pos), length=f(ws.length),
        valid=f(ws.valid), n_in_range=ws.n_in_range,
    )


def _pad_n(x, N):
    return torch.nn.functional.pad(x, (0, N - x.shape[-1]))


def _chain_bucketed(ws: WindowSeeds, cfg, dp_fn) -> ChainBatch:
    """Route windows to a narrow or wide chaining DP by seed count: a
    chain_small_n-wide DP over every window plus the full-width DP over
    the top chain_big_windows windows by seed count, merged.  Both are
    the same DP, so the merge is exact wherever each is complete; when
    more than chain_big_windows windows exceed the narrow width, the
    full DP runs over the whole batch instead.  Each call adds one to
    ``_chain_bucketed.entries``."""
    _chain_bucketed.entries += 1
    lead = ws.q_pos.shape[:-1]
    N = ws.q_pos.shape[-1]
    NS = min(getattr(cfg, "chain_small_n", 64), N)
    if len(lead) != 1 or N <= NS:
        return dp_fn(ws, cfg)
    W = lead[0]
    big_k = min(getattr(cfg, "chain_big_windows", 128), W)
    count = ws.valid.sum(dim=-1)
    if int((count > NS).sum()) > big_k:
        return dp_fn(ws, cfg)

    small = dp_fn(_tree_map_ws(ws, lambda a: a[:, :NS]), cfg)
    _, bigsel = topk_stable(count, big_k)
    big = dp_fn(_tree_map_ws(ws, lambda a: a[bigsel]), cfg)
    out = ChainBatch(
        q_pos=_pad_n(small.q_pos, N),
        t_pos=_pad_n(small.t_pos, N),
        length=_pad_n(small.length, N),
        chain_len=small.chain_len.clone(),
        score=small.score.clone(),
    )
    out.q_pos[bigsel] = big.q_pos
    out.t_pos[bigsel] = big.t_pos
    out.length[bigsel] = big.length
    out.chain_len[bigsel] = big.chain_len
    out.score[bigsel] = big.score
    return out


_chain_bucketed.entries = 0


def _n_live(ok):
    """Seeds of a window occupy its first slots (select_window_seeds sorts
    invalid ones last), so DP steps past the widest window's count are
    no-ops; returns that count."""
    return int(ok.sum(dim=1).max()) if ok.numel() else 0


def log_table_len(cfg) -> int:
    """Entries of dp-n2's log table: every d a linked pair of a window
    can produce.  For a linked pair d = |dr - dt| < max(dr, dt); a
    window of a read of length rl spans rl on q and at most 3 rl - 1 on
    t ([w rl - rl/2, (w + 2) rl - 1 + rl/2], select_window_seeds), and
    the engine maps no read longer than seq_max_length, so d < 3 x
    seq_max_length (750,000 at the default 250,000)."""
    return 3 * cfg.seq_max_length


@functools.lru_cache(maxsize=None)
def _host_log_table(n: int, fdt: torch.dtype) -> torch.Tensor:
    """log(max(d, 2)) for d < n, made on the host: float64 from Python's
    math.log (the C library's log, which the reference calls:
    src/Chain.cpp:217-225), float32 ("f32" DP, not the default) from
    torch.log in float32 on the CPU."""
    if fdt == torch.float64:
        return torch.tensor([math.log(2.0)] * min(n, 2)
                            + list(map(math.log, range(2, n))),
                            dtype=torch.float64)
    return torch.log(torch.arange(n).clamp(min=2).to(torch.float32))


@functools.lru_cache(maxsize=None)
def log_table(n: int, dev: torch.device, fdt: torch.dtype) -> torch.Tensor:
    """dp-n2's table of log(max(d, 2)) for d < n in the DP's float type
    on dev: the host's table (_host_log_table) copied once a (device,
    type, length).  The plain DP and the kernel read it, so the CPU and
    the card take one log."""
    return _host_log_table(n, fdt).to(dev)


def dpn2_penalty(d, link, table, penalty):
    """dp-n2's gap penalty of pairs with integer d (int32 tensor): 0 for
    d <= 1, else 0.1 d + penalty log(max(d, 2)) (src/Chain.cpp:217-225),
    each product and sum rounded on its own, as the reference's C
    doubles are (no fused multiply-add).  The log is the table's entry d
    (log_table), read for the linked pairs only (link): a linked d past
    the table is an index error, never another log."""
    fdt = table.dtype
    lg = table[torch.where(link, d, 0).long()]
    return torch.where(d <= 1, torch.zeros((), dtype=fdt, device=d.device),
                       0.1 * d.to(fdt) + penalty * lg)


def chain_dpn2(ws: WindowSeeds, cfg, return_dp: bool = False):
    """The dp-n2 DP over every window at full width; with ``return_dp``
    also its (W, N) dp and prev: (chains, dp, prev)."""
    lead, N, W, q, t, ln, ok = _flatten_ws(ws)
    fdt = _dp_dtype(cfg)
    dev = q.device

    reward = torch.tensor(cfg.chain_reward * cfg.min_anchor_len, dtype=fdt,
                          device=dev)
    jidx = torch.arange(N, device=dev)
    q_end = q + ln - 1  # qPos_j + len_j - 1
    t_end = t + ln - 1
    neg_inf = torch.tensor(float("-inf"), dtype=fdt, device=dev)
    table = log_table(log_table_len(cfg), dev, fdt)

    dp = torch.full((W, N), float("-inf"), dtype=fdt, device=dev)
    prev = torch.full((W, N), -1, dtype=torch.int64, device=dev)
    for i in range(_n_live(ok)):
        dist_r = q[:, i : i + 1] - q_end  # (W, N)
        dist_t = (t[:, i : i + 1] - t_end).to(torch.int32)
        can = ok & (jidx[None, :] < i) & (dist_r > 0) & (dist_t > 0)
        d = (dist_r - dist_t).abs()
        pen = dpn2_penalty(d, can, table, cfg.chain_penalty)
        val = torch.where(can, dp + reward - pen, neg_inf)
        base = ln[:, i].to(fdt)
        best = val.max(dim=1).values
        take = best > base  # strict, like dp[j]+a-b > dp[i] (Chain.cpp:275)
        # predecessor: largest j among ties (reference scans j descending
        # with strict >)
        pj = torch.where(val == best[:, None], jidx, -1).max(dim=1).values
        ok_i = ok[:, i]
        dp[:, i] = torch.where(ok_i, torch.where(take, best, base), neg_inf)
        prev[:, i] = torch.where(ok_i & take, pj, -1)
    out = _finish_chains(ws, dp, prev, q, t, ln, ok, lead, W, N)
    return (out, dp, prev) if return_dp else out


def chain_clasp_sop(ws: WindowSeeds, cfg, return_dp: bool = False):
    """clasp sum-of-pairs local chaining (``-a clasp``; chain_seeds_clasp,
    src/Chain.cpp:39-209 -> bl_slClusterSop/bl_slChainSop,
    lib/clasp/slchain.c:568-828) as a masked O(n^2) DP, the same loop as
    chain_dpn2.

    fragment score scr = len; precedence strictly before on both axes;
    gap cost GSOP(i,j) = lambda*max(DX,DY) + (eps-lambda)*min(DX,DY),
    DX = tStart_i - tEnd_j - 1, DY = qStart_i - qEnd_j - 1; chain score
    dp[i] = scr_i + max_j(dp[j] - GSOP(i,j)), the link dropped when
    dp[j] < GSOP (slchain.c:719); eps = 0, lambda = 0.15
    (src/Chain.cpp:52-55).  Ties: predecessor = largest j, chain end =
    smallest i.  ``return_dp`` as chain_dpn2."""
    lead, N, W, q, t, ln, ok = _flatten_ws(ws)
    fdt = _dp_dtype(cfg)
    dev = q.device

    lam = torch.tensor(cfg.clasp_lambda, dtype=fdt, device=dev)
    eps = torch.tensor(cfg.clasp_epsilon, dtype=fdt, device=dev)
    jidx = torch.arange(N, device=dev)
    q_end = q + ln - 1
    t_end = t + ln - 1
    scr = ln.to(fdt)
    neg_inf = torch.tensor(float("-inf"), dtype=fdt, device=dev)

    dp = torch.full((W, N), float("-inf"), dtype=fdt, device=dev)
    prev = torch.full((W, N), -1, dtype=torch.int64, device=dev)
    for i in range(_n_live(ok)):
        dy = q[:, i : i + 1] - q_end - 1  # (W, N)
        dx = (t[:, i : i + 1] - t_end - 1).to(torch.int32)
        can = ok & (jidx[None, :] < i) & (dy >= 0) & (dx >= 0)
        dxf, dyf = dx.to(fdt), dy.to(fdt)
        gsop = (lam * torch.maximum(dxf, dyf)
                + (eps - lam) * torch.minimum(dxf, dyf))
        val = torch.where(can, dp - gsop, neg_inf)
        best = val.max(dim=1).values
        # local chaining: keep the link only while dp[j] >= GSOP (strict
        # < drops it, slchain.c:717-721), i.e. best >= 0
        take = best >= 0
        pj = torch.where(val == best[:, None], jidx, -1).max(dim=1).values
        ok_i = ok[:, i]
        dp[:, i] = torch.where(ok_i, scr[:, i] + best.clamp(min=0),
                               neg_inf)
        prev[:, i] = torch.where(ok_i & take, pj, -1)
    out = _finish_chains(ws, dp, prev, q, t, ln, ok, lead, W, N)
    return (out, dp, prev) if return_dp else out
