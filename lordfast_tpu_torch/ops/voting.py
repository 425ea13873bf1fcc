"""Window voting and candidate selection in PyTorch.

Port of ``lordfast_tpu/ops/voting.py``, the batched sparse re-design of
``findTopWins_coarse`` / ``findTopWins_fine`` (src/LordFAST.cpp:582-657,
819-904): each seed votes (weight = 1 + len - MIN_ANCHOR_LEN,
src/LordFAST.cpp:593) into windows ``winId = tPos / readLen`` and
``winId - 1``; votes are sorted per read, segment-summed, and local maxima
are found by comparing adjacent (winId, strand) groups (the neighbour
conditions of src/LordFAST.cpp:630-632; an absent neighbour passes).

Output: the top ``max_candidates`` windows per read by vote count, the
coarse-mode decision (best >= scoreRatio * second,
src/LordFAST.cpp:542-543) and the fine-mode threshold minScore =
best / scoreRatio (src/LordFAST.cpp:553).

Tie order: ``lax.top_k`` puts equal scores in ascending index order and
``torch.topk`` leaves it undefined, so every top-k here is a stable
descending sort; multi-key ``lax.sort`` calls become stable sorts by the
secondary key, then the primary.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CandidateBatch(NamedTuple):
    win_id: torch.Tensor     # (B, C) int32, window index (tStart = w * rl)
    is_rev: torch.Tensor     # (B, C) bool
    cnt: torch.Tensor        # (B, C) int32 vote count, descending
    valid: torch.Tensor      # (B, C) bool
    is_fine: torch.Tensor    # (B,) bool: fine mode (chain-score re-ranking)
    min_score: torch.Tensor  # (B,) float32: fine-mode vote threshold


def topk_stable(x, k: int, dim: int = -1):
    """(values, indices) of the k largest along dim, equal values in
    ascending index order (lax.top_k's order)."""
    v, i = torch.sort(x, dim=dim, descending=True, stable=True)
    return v.narrow(dim, 0, k), i.narrow(dim, 0, k)


def _cummax(x, dim=1):
    return torch.cummax(x, dim=dim).values


def _shift_prev(x, fill):
    """x[:, j-1] at column j (fill at column 0)."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], 1)


def _shift_next(x, fill):
    """x[:, j+1] at column j (fill at the last column)."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], 1)


def _segment_local_max(keys_s, wts_s, sent, bigw_mask):
    """Segment totals and local maxima over rows of sorted vote keys.

    keys_s/wts_s: (R, n) sorted keys (sentinel ``sent`` = no vote) and
    weights.  Segment totals are propagated to every member with prefix
    scans (cumsum/cummax); a segment end is a local maximum when its
    total is >= the left neighbour window's and > the right one's.
    Returns (total, is_max)."""
    n = keys_s.shape[1]
    dev = keys_s.device
    ok = keys_s != sent
    prv = _shift_prev(keys_s, -1)
    nxt = _shift_next(keys_s, sent)
    is_start = (keys_s != prv) & ok
    is_end = (keys_s != nxt) & ok

    cw = torch.cumsum(wts_s, dim=1)
    startm1 = _cummax(torch.where(is_start, cw - wts_s, 0))
    part = cw - startm1  # partial total; full at segment ends
    # backward propagation of each end's total to its members: encode
    # (reverse position, value) so a cummax picks the nearest end
    pos_r = torch.arange(n - 1, -1, -1, device=dev, dtype=torch.int64)
    enc = torch.where(is_end, pos_r * 2**32 + part.long(), -1)
    enc = _cummax(enc.flip(1)).flip(1)
    total = enc & 0xFFFFFFFF

    tot_prev = _shift_prev(total, 0)
    tot_next = _shift_next(total, 0)
    w_id = keys_s & bigw_mask
    left_ok = (w_id == 0) | (prv != keys_s - 1) | (total >= tot_prev)
    pos_f = torch.arange(n, device=dev, dtype=torch.int64)
    lenc = _cummax(torch.where(is_start, pos_f * 2 + left_ok.long(), -1))
    left_ok_e = (lenc & 1) == 1
    right_ok = (nxt != keys_s + 1) | (total > tot_next)
    return total, is_end & left_ok_e & right_ok


def vote_windows(seeds, read_lens, cfg, page=None):
    """seeds: SeedBatch; read_lens: (B,) int32 tensor.

    Dispatcher: the flat path packs every read's valid seeds into one
    F-slot vote stream and sorts that; batches whose total vote count
    exceeds F use the wide per-read path; both give identical results.

    page: optional int — return candidate ranks [C*page, C*(page+1))
    instead of the top C, with is_fine/min_score still computed from the
    global top two (the engine's window paging)."""
    B, MS = seeds.t_pos.shape
    F = 131072
    if 2 * B * MS <= F:
        return _vote_windows_wide(seeds, read_lens, cfg, page)
    total_votes = 2 * int(seeds.n_total.long().sum())
    if total_votes <= F:
        return _vote_windows_flat(seeds, read_lens, cfg, F, page)
    return _vote_windows_wide(seeds, read_lens, cfg, page)


def _vote_windows_flat(seeds, read_lens, cfg, F: int, page=None):
    """Flat-compacted voting: valid seed slots are contiguous per read
    (locate fills slots 0..n-1), so vote v of the global stream maps back
    to (read, slot, which-vote) with a searchsorted over per-read offsets.
    The segment/local-max logic is the wide path's on one (1, F) row with
    the read id in the sort key; per-read top-C extraction reproduces the
    wide path's tie order (score desc, then (strand, win) asc)."""
    B, MS = seeds.t_pos.shape
    C = cfg.max_candidates
    dev = seeds.t_pos.device

    rl = read_lens.long().clamp(min=1)[:, None]
    win = seeds.t_pos.long() // rl
    weight = 1 + seeds.length.long() - cfg.min_anchor_len
    strand = seeds.is_rev.long()

    n = seeds.n_total.long().clamp(max=MS)  # valid slots per read
    off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum(2 * n, 0)])
    v = torch.arange(F, device=dev, dtype=torch.int64)
    b = (torch.searchsorted(off, v, right=True) - 1).clamp(0, B - 1)
    rel = v - off[b]
    s = (rel >> 1).clamp(0, MS - 1)
    which = rel & 1
    live = v < off[B]

    w_bs = win[b, s] - which
    val = live & seeds.valid[b, s] & (w_bs >= 0)
    # key: (read, strand, win) — adjacency within (read, strand) is +-1
    SENT = 2**62
    keys = torch.where(val, ((b * 2 + strand[b, s]) << 30) + w_bs, SENT)
    wts = torch.where(val, weight[b, s], 0)
    keys_s, order = torch.sort(keys, stable=True)
    wts_s = wts[order]

    total, is_max = _segment_local_max(keys_s[None], wts_s[None], SENT,
                                       2**30 - 1)
    score = torch.where(is_max[0], total[0], -1)
    bkey = (keys_s >> 31).clamp(0, B - 1)  # read id (or SENT>>31)
    sw_key = keys_s & (2**31 - 1)
    # second sort: (read, -score) primary, (strand, win) secondary
    k1 = torch.where(is_max[0], bkey * 2**32 + (2**31 - 1 - score), 2**62)
    o2 = torch.sort(sw_key, stable=True).indices
    o1 = torch.sort(k1[o2], stable=True).indices
    o = o2[o1]
    k1s, k2s, sc_s = k1[o], sw_key[o], score[o]
    b2 = (k1s >> 32).clamp(0, B - 1)
    idx = torch.arange(F, device=dev, dtype=torch.int64)
    is_start2 = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           b2[1:] != b2[:-1]])
    rank = idx - _cummax(torch.where(is_start2, idx, -1)[None])[0]
    live = (k1s != 2**62) & (sc_s > 0)
    if page is None:
        take = (rank < C) & live
        prank = rank
    else:
        p0 = int(page) * C
        take = (rank >= p0) & (rank < p0 + C) & live
        prank = rank - p0

    flat = torch.where(take, b2 * C + prank, 0)
    cnt = torch.zeros(B * C, dtype=torch.int64, device=dev).scatter_reduce(
        0, flat, torch.where(take, sc_s, 0), reduce="amax")
    keyo = torch.full((B * C,), -1, dtype=torch.int64,
                      device=dev).scatter_reduce(
        0, flat, torch.where(take, k2s, -1), reduce="amax")
    cnt, keyo = cnt.view(B, C), keyo.view(B, C)
    valid = cnt > 0

    # best = -1 for candidate-less reads (the wide path's top_k over a -1
    # filled score row).  On a paged call best/second come from the
    # global ranks 0/1, so every page agrees on the fine-mode decision
    if page is None:
        best = torch.where(valid[:, 0], cnt[:, 0], -1).float()
        second = torch.where(valid[:, 1], cnt[:, 1], 0).float()
    else:
        t0 = (rank == 0) & live
        t1 = (rank == 1) & live
        g0 = torch.full((B,), -1, dtype=torch.int64, device=dev)
        g0 = g0.scatter_reduce(0, torch.where(t0, b2, 0),
                               torch.where(t0, sc_s, -1), reduce="amax")
        g1 = torch.zeros(B, dtype=torch.int64, device=dev)
        g1 = g1.scatter_reduce(0, torch.where(t1, b2, 0),
                               torch.where(t1, sc_s, 0), reduce="amax")
        best, second = g0.float(), g1.float()
    is_fine = best < cfg.score_ratio * second
    min_score = best / cfg.score_ratio

    return CandidateBatch(
        win_id=torch.where(valid, keyo & (2**30 - 1), 0).to(torch.int32),
        is_rev=valid & (keyo >= 2**30),
        cnt=torch.where(valid, cnt, 0).to(torch.int32),
        valid=valid,
        is_fine=is_fine,
        min_score=min_score,
    )


def _vote_windows_wide(seeds, read_lens, cfg, page=None):
    """Per-read padded voting over a (B, 2*MS) key row per read."""
    B, MS = seeds.t_pos.shape
    C = cfg.max_candidates
    n2 = 2 * MS
    dev = seeds.t_pos.device

    rl = read_lens.long().clamp(min=1)[:, None]
    win = seeds.t_pos.long() // rl
    weight = 1 + seeds.length.long() - cfg.min_anchor_len
    strand = seeds.is_rev.long()

    # two votes per seed: winId and winId-1 (skip winId-1 < 0); strand in
    # the high bit keeps same-strand windows adjacent in key space
    BIGW = 2**30
    SENT = 2**31 - 1
    keys = torch.cat([
        torch.where(seeds.valid, strand * BIGW + win, SENT),
        torch.where(seeds.valid & (win >= 1), strand * BIGW + win - 1, SENT),
    ], dim=1)  # (B, 2*MS)
    wts = torch.where(keys == SENT, 0, torch.cat([weight, weight], dim=1))
    keys_s, order = torch.sort(keys, dim=1, stable=True)
    wts_s = wts.gather(1, order)

    total, is_max = _segment_local_max(keys_s, wts_s, SENT, BIGW - 1)
    score = torch.where(is_max, total, -1)
    if page is None:
        top_cnt, top_pos = topk_stable(score, C, dim=1)
    else:
        # rank window [C*page, C*(page+1)) in top_k's order (score desc,
        # position asc), at the slice start lax.dynamic_slice clamps to
        pos_a = torch.arange(n2, device=dev, dtype=torch.int64)
        pk = ((2**31 - 1 - score) << 31) | pos_a
        pk_s = torch.sort(pk, dim=1).values
        p0 = min(int(page) * C, n2 - C)
        sl = pk_s[:, p0 : p0 + C]
        top_cnt = 2**31 - 1 - (sl >> 31)
        top_pos = sl & (2**31 - 1)
        gbest = 2**31 - 1 - (pk_s[:, 0] >> 31)
        gsecond = 2**31 - 1 - (pk_s[:, 1] >> 31)
    top_key = keys_s.gather(1, top_pos)
    valid = top_cnt > 0

    if page is None:
        best = top_cnt[:, 0].float()
        second = torch.where(valid[:, 1], top_cnt[:, 1], 0).float()
    else:
        best = gbest.float()
        second = torch.where(gsecond > 0, gsecond, 0).float()
    is_fine = best < cfg.score_ratio * second
    min_score = best / cfg.score_ratio

    return CandidateBatch(
        win_id=torch.where(valid, top_key % BIGW, 0).to(torch.int32),
        is_rev=valid & (top_key >= BIGW),
        cnt=torch.where(valid, top_cnt, 0).to(torch.int32),
        valid=valid,
        is_fine=is_fine,
        min_score=min_score,
    )
