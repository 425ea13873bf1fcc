"""A numpy model of ``lordfast_tpu_torch/csrc/seed_shard.cu``'s kernels
(names as in the source), for the CPU tests of the sharded index's loops.

Each model computes what its kernel computes, thread by thread as numpy
arrays.  ``shard_bucket_kernel`` is the kernel's scan: tiles of kTile
queries, a warp kItems rounds of 32, each round's peers of one owner
counted by their leader into the warp's running count (wcount), the
warps' counts scanned in warp order, each tile's offset an owner found by
the decoupled look-back over the earlier tiles' words, 32 a round (which
of them hold an inclusive prefix yet drawn at random: the sum cannot
depend on it), a query's slot its tile's offset, its warp's and its
place in the warp's rounds, the owners' totals written by the scan's
last tile and each bucket's -1 tail by the fill blocks, over a send
buffer that starts as garbage.
``shard_answer_kernel`` is the piece copy, a thread a 16-byte piece, that
leaves a routed empty slot unwritten.  The step models read the returned
rows by slot (a zero row for slot -1) and count occ and step the walk as
``fm_rank.cuh`` does, with 32-bit words, the words past the row's masked
out and the row's char from its own word.  ``install`` puts them in place
of the ``fm_shard_cuda`` wrappers (the loops look the wrappers up at call
time), so ``fm_shard_cuda.shard_ext`` and ``shard_walk`` run their block
schedule over the models on the CPU; its answer fills the slots the
kernel leaves unwritten with random values first, so a step that read
one would go wrong.  This module imports neither jax nor lordfast_tpu.
"""

from __future__ import annotations

import numpy as np

M32 = np.uint64(0xFFFFFFFF)
MAX_ANCHOR = 4095

# seed_shard.cu's sizes
kBucketThreads = 512
kWarps = kBucketThreads // 32
kItems = 4
kTile = kBucketThreads * kItems
kMaxOwners = 256


def occ_pos(seq_len, primary, k):
    kk = np.clip(k, 0, seq_len - 1)
    return kk - (kk >= primary)


def query_block(live, k, l, seq_len, primary, ids=False):
    """(blk, asks) of every query: query_block."""
    ext = l is not None
    n = len(live)
    lane = np.concatenate([np.arange(n), np.arange(n)]) if ext else \
        np.arange(n)
    if ids:
        return np.asarray(k), np.asarray(live, bool)
    if ext:
        kq = np.concatenate([k - 1, l])
        return occ_pos(seq_len, primary, kq) >> 7, live[lane]
    return (k - (k > primary)) >> 7, live & (k != primary)


def shard_bucket_kernel(rng, live, k, l, seq_len, primary, rps, D, cap,
                        all_gather, ids=False, published=None):
    """(send, slot, counts, over) of one launch: the scan blocks' tiles in
    ticket order, the fill blocks' tails.  ``published``: the chance that
    an earlier tile has published its inclusive prefix when a tile looks
    back (None: drawn from rng)."""
    blk, ask = query_block(live, k, l, seq_len, primary, ids)
    Q = len(blk)
    if all_gather:
        return np.where(ask, blk, -1), np.arange(Q), None, 0
    assert 1 <= D <= kMaxOwners
    n_scan = max(-(-Q // kTile), 1)
    # owner D: asks nothing (the kernel's -1); query i = t kTile + w 32
    # kItems + it 32 + me
    owner = np.full(n_scan * kTile, D)
    b = np.full(n_scan * kTile, -1, np.int64)
    b[:Q] = blk
    ow = np.clip(blk // rps, 0, D - 1)
    owner[:Q] = np.where(ask, ow, D)
    own = owner.reshape(n_scan, kWarps, kItems, 32)
    t_, w_, it_, me_ = np.indices(own.shape)
    peer = own[..., None] == np.arange(D + 1)   # (t, w, it, me, owner)
    # a round's peers: the lanes before a lane (popc(peers & lt)) and
    # all of them (the leader's popc(peers))
    below = np.cumsum(peer, axis=3) - peer
    popc = peer.sum(3)                           # (t, w, it, owner)
    wcount = np.cumsum(popc, axis=2) - popc      # before each round
    rank = wcount[t_, w_, it_, own] + below[t_, w_, it_, me_, own]
    wtot = popc.sum(2)                           # (t, w, owner)
    woff = np.cumsum(wtot, axis=1) - wtot        # the warps scanned
    run = wtot.sum(1)                            # each tile's own count
    # look_back: a warp an owner reads 32 earlier tiles' words a round,
    # nearest first, and sums them up to the nearest that holds an
    # inclusive prefix (which have published theirs yet drawn at random;
    # tile 0's always has, and before it reads as an inclusive 0)
    incl = np.zeros_like(run)
    boff = np.zeros_like(run)
    if published is None:
        published = rng.random()
    for t in range(n_scan):
        for o in range(D):
            excl, top = 0, t - 1
            while t > 0:
                j = top - np.arange(32)
                flag = (j <= 0) | (rng.random(32) < published)
                jj = np.maximum(j, 0)
                x = np.where(j < 0, 0, np.where(flag, incl[jj, o],
                                                run[jj, o]))
                stop = int(np.argmax(flag)) if flag.any() else 31
                excl += int(x[: stop + 1].sum())
                if flag.any():
                    break
                top -= 32
            boff[t, o] = excl
            incl[t, o] = excl + run[t, o]
    counts = incl[-1, :D]
    r = (boff[t_, own] + woff[t_, w_, own] + rank).reshape(-1)[:Q]
    own = own.reshape(-1)[:Q]
    ok = (own < D) & (r < cap)
    slot = np.where(ok, own * cap + r, -1)
    send = rng.integers(-2**62, 2**62, D * cap)  # what the buffer held
    send[slot[ok]] = b[:Q][ok]
    # the fill blocks: -1 past each bucket's count
    p = np.arange(D * cap)
    send[p % cap >= np.minimum(counts, cap)[p // cap]] = -1
    return send, slot, counts, int((counts > cap).any())


def shard_answer_kernel(recv, rank_a, rank_b, rps, base, fused, out,
                        routed, width=12):
    """Each received row id's row (width 12) or entry (width 1: rank_a the
    1-D sa_samp stripe) as int64 into ``out`` in place, zeros where this
    rank does not own it; with ``routed``, a slot whose id is -1 is left
    as it is.  Width 12: thread t copies piece t % 6 of slot t // 6."""
    n = len(recv)
    if width == 1:
        loc = recv - base
        ok = (loc >= 0) & (loc < rps)
        v = np.where(ok, rank_a[np.clip(loc, 0, rps - 1)].astype(np.int64),
                     0)
        write = ~(routed & (recv == -1))
        out[write] = v[write]
        return
    t = np.arange(6 * n)
    s, j = t // 6, t % 6
    loc = recv[s] - base
    ok = (loc >= 0) & (loc < rps)
    lc = np.clip(loc, 0, rps - 1)
    if fused:
        src = rank_a.reshape(-1, 6, 2)[lc, j]
    else:
        src = np.where((j < 2)[:, None],
                       rank_a.reshape(-1, 2, 2)[lc, np.minimum(j, 1)],
                       rank_b.reshape(-1, 4, 2)[lc, np.maximum(j - 2, 0)])
    v = np.where(ok[:, None], src, 0)
    write = ~(routed & (recv[s] == -1))
    out.reshape(6 * n, 2)[t[write]] = v[write]


def row_at(back, slot):
    rows = back[np.maximum(slot, 0)]
    return np.where((slot >= 0)[:, None], rows, 0)


def first_chars(n):
    n = np.asarray(n, np.int64)
    sh = np.clip(32 - 2 * n, 0, 32).astype(np.uint64)
    full = (M32 << sh) & M32
    return np.where(n >= 16, M32, np.where(n <= 0, np.uint64(0), full))


def popc(x):
    """Population count of uint32 values held in uint64."""
    x = x.astype(np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x55555555))
    x = (x & np.uint64(0x33333333)) + ((x >> np.uint64(2))
                                       & np.uint64(0x33333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
    return (((x * np.uint64(0x01010101)) & M32)
            >> np.uint64(24)).astype(np.int64)


def occ_of_row(seq_len, l2, row, k, pos, c):
    """occ from rows (n, 12) for queries of rows k at positions pos."""
    off = pos & 127
    nch = off + 1
    w = row[:, 4:].astype(np.uint64) & M32
    cu = c.astype(np.uint64)[:, None]
    hi = np.where((cu & np.uint64(2)) != 0, w, ~w & M32)
    lo = np.where((cu & np.uint64(1)) != 0, w, ~w & M32)
    matched = (hi >> np.uint64(1)) & lo & np.uint64(0x55555555)
    first = np.arange(8) * 16
    cnt = popc(matched & first_chars(nch[:, None] - first)).sum(1)
    base = row[np.arange(len(c)), c]
    res = base + cnt
    res = np.where(k == seq_len, l2[c + 1] - l2[c], res)
    return np.where(k < 0, 0, res)


def row_char(row, pos):
    off = pos & 127
    w = row[np.arange(len(pos)), 4 + (off >> 4)].astype(np.uint64) & M32
    return ((w >> ((15 - (off & 15)) * 2).astype(np.uint64))
            & np.uint64(3)).astype(np.int64)


def shard_ext_step_kernel(alive, k, l, m, pos_f, b_lane, rw, lens, L, l2,
                          back, slot, seq_len, primary):
    """The lanes' (alive, k, l, m) after one step, and the live count."""
    n = len(alive)
    q = pos_f + m
    qc = np.minimum(q, L - 1)
    word = rw[b_lane, qc >> 4].astype(np.uint64)
    c = ((word >> (3 * (15 - (qc & 15))).astype(np.uint64))
         & np.uint64(7)).astype(np.int64)
    ok_char = (q < lens[b_lane]) & (c < 4)
    cc = np.where(ok_char, 3 - c, 0)
    pk, pl = occ_pos(seq_len, primary, k - 1), occ_pos(seq_len, primary, l)
    nk = l2[cc] + occ_of_row(seq_len, l2, row_at(back, slot[:n]), k - 1, pk,
                             cc) + 1
    nl = l2[cc] + occ_of_row(seq_len, l2, row_at(back, slot[n:]), l, pl, cc)
    a = alive & ok_char & (nk <= nl) & (m < MAX_ANCHOR)
    return (a, np.where(a, nk, k), np.where(a, nl, l), m + a,
            int(a.sum()))


def shard_walk_step_kernel(active, rows, steps, l2, back, slot, seq_len,
                           primary, intv):
    x = rows - (rows > primary)
    row = row_at(back, slot)
    ch = row_char(row, x)
    nxt = l2[ch] + occ_of_row(seq_len, l2, row, rows, x, ch)
    nxt = np.where(rows == primary, 0, nxt)
    r = np.where(active, nxt, rows)
    act = active & ((r & (intv - 1)) != 0)
    return act, r, steps + active, int(act.sum())


def install(K, rng):
    """Put the models in place of fm_shard_cuda's (module K) four wrappers,
    with the wrappers' signatures; returns the wrappers they replaced."""
    import torch

    saved = (K.shard_bucket, K.shard_answer, K.shard_ext_step,
             K.shard_walk_step)
    T = torch.from_numpy

    def bucket(live, k, l, meta, rps, D, cap, send, slot, counts=None,
               over=None, ids=False):
        # the kernel's argument types (fm_shard_cuda.shard_bucket checks
        # them on the card)
        assert send.dtype == torch.int64 and slot.dtype == torch.int32
        assert cap is None or (counts.dtype == over.dtype == torch.int32)
        out = shard_bucket_kernel(
            rng, live.numpy(), k.numpy(), None if l is None else l.numpy(),
            0 if ids else meta["seq_len"], 0 if ids else meta["primary"],
            rps, D, cap or 0, cap is None, ids)
        send.copy_(T(out[0]))
        slot.copy_(T(out[1]))
        if cap is not None:
            counts.copy_(T(out[2]))
            over.copy_(torch.maximum(over, torch.tensor([out[3]],
                                                        dtype=over.dtype)))

    def answer(recv, arrs, base, out, key=None, routed=False):
        # the slots the kernel leaves unwritten hold whatever they held
        o = rng.integers(-2**62, 2**62, tuple(out.shape))
        if key is not None:
            st = arrs[key].numpy()
            shard_answer_kernel(recv.numpy(), st, None, len(st), base, True,
                                o, routed, 1)
        else:
            fused, a, b = K.rank_stripes(arrs)
            shard_answer_kernel(recv.numpy(), a.numpy(),
                                None if b is None else b.numpy(),
                                a.shape[0], base, fused, o, routed)
        out.copy_(T(o))

    def ext_step(state, pos_f, b_lane, rd, arrs, meta, back, slot,
                 live=None):
        res = shard_ext_step_kernel(
            *(x.numpy() for x in state), pos_f.numpy(), b_lane.numpy(),
            rd.rw.numpy(), rd.lens.numpy(), rd.L, arrs["L2"].long().numpy(),
            back.numpy(), slot.numpy().astype(np.int64), meta["seq_len"],
            meta["primary"])
        for x, v in zip(state, res):
            x.copy_(T(np.asarray(v)))
        if live is not None:
            live += res[4]

    def walk_step(state, arrs, meta, back, slot, live=None):
        res = shard_walk_step_kernel(
            *(x.numpy() for x in state), arrs["L2"].long().numpy(),
            back.numpy(), slot.numpy().astype(np.int64), meta["seq_len"],
            meta["primary"], meta["sa_intv"])
        for x, v in zip(state, res):
            x.copy_(T(np.asarray(v)))
        if live is not None:
            live += res[3]

    K.shard_bucket, K.shard_answer = bucket, answer
    K.shard_ext_step, K.shard_walk_step = ext_step, walk_step
    return saved
