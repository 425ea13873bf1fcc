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
float64 like the reference's double dp[].  Ties follow the reference:
predecessor = largest j among score ties, chain end = smallest i.

The loops over seeds (DP) and chain links (backtrack) are plain PyTorch
with one op sequence per step; on a GPU they are launch-bound.  A hand
kernel for them is later work.
"""

from __future__ import annotations

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


def chain_seeds(ws: WindowSeeds, cfg) -> ChainBatch:
    """Dispatch on cfg.chain_alg (--chainAlg, src/CommandLineParser.cpp:216;
    call sites src/LordFAST.cpp:1030-1050,1119-1135)."""
    from ..config import ChainAlg

    fn = (chain_clasp_sop if cfg.chain_alg == ChainAlg.CLASP
          else chain_dpn2)
    return _chain_bucketed(ws, cfg, fn)


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
    full DP runs over the whole batch instead."""
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


def _n_live(ok):
    """Seeds of a window occupy its first slots (select_window_seeds sorts
    invalid ones last), so DP steps past the widest window's count are
    no-ops; returns that count."""
    return int(ok.sum(dim=1).max()) if ok.numel() else 0


def chain_dpn2(ws: WindowSeeds, cfg) -> ChainBatch:
    lead, N, W, q, t, ln, ok = _flatten_ws(ws)
    fdt = _dp_dtype(cfg)
    dev = q.device

    reward = torch.tensor(cfg.chain_reward * cfg.min_anchor_len, dtype=fdt,
                          device=dev)
    jidx = torch.arange(N, device=dev)
    q_end = q + ln - 1  # qPos_j + len_j - 1
    t_end = t + ln - 1
    neg_inf = torch.tensor(float("-inf"), dtype=fdt, device=dev)

    dp = torch.full((W, N), float("-inf"), dtype=fdt, device=dev)
    prev = torch.full((W, N), -1, dtype=torch.int64, device=dev)
    for i in range(_n_live(ok)):
        dist_r = q[:, i : i + 1] - q_end  # (W, N)
        dist_t = (t[:, i : i + 1] - t_end).to(torch.int32)
        can = ok & (jidx[None, :] < i) & (dist_r > 0) & (dist_t > 0)
        d = (dist_r - dist_t).abs()
        pen = torch.where(
            d <= 1,
            torch.zeros((), dtype=fdt, device=dev),
            0.1 * d.to(fdt)
            + cfg.chain_penalty * torch.log(d.clamp(min=2).to(fdt)),
        )
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
    return _finish_chains(ws, dp, prev, q, t, ln, ok, lead, W, N)


def chain_clasp_sop(ws: WindowSeeds, cfg) -> ChainBatch:
    """clasp sum-of-pairs chaining (``-a clasp``) is not ported yet."""
    raise NotImplementedError(
        "chain_alg='clasp' is not ported to lordfast_tpu_torch yet; "
        "use the default dp-n2"
    )
