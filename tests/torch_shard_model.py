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
leaves a routed empty slot unwritten.  The step models run over a step's
lanes as ``for_lanes`` does (a block's first step over the alive flags,
a later one over the list the step before wrote, whose lanes it steps
without reading their flags, skipping its -1 entries), read the returned
rows by slot (a zero row for slot -1) and count occ and step the walk as
``fm_rank.cuh`` does, with 32-bit words, the words past the row's masked
out and the row's char from its own word; ``append`` fills the slots the
step reserved with the kept lanes and a -1 for each that died, in an
order drawn at random every step (the atomics'), through the counter
ring of ``fm_shard_cuda.lane_ring``.  ``install`` puts them in place
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


def for_lanes(flags, list_in, n_in):
    """The lanes a step runs over: on a block's first step (list_in None)
    the alive flags' lanes, else the entries of list_in[:n_in] but the -1
    of lanes that died a step before; their flags are not read on the
    card (each must be alive, and listed once)."""
    if list_in is None:
        return np.nonzero(flags)[0]
    lanes = np.asarray(list_in[:n_in], np.int64)
    lanes = lanes[lanes >= 0]
    assert flags[lanes].all() and len(np.unique(lanes)) == len(lanes)
    return lanes


def append(rng, lanes, kept, list_out, n_out, zero, live):
    """A step's list and counts: slots reserved on *n_out for every lane
    it ran (``lanes``), filled with the kept lanes and a -1 for each that
    died, in an order drawn at random (a warp's group at a time in the
    atomics' order, on the card); *zero set to 0, *live raised by the
    kept lanes (live None but on a block's last step)."""
    zero[0] = 0
    base = int(n_out[0])
    filled = np.concatenate([kept, np.full(len(lanes) - len(kept), -1)])
    list_out[base: base + len(lanes)] = rng.permutation(filled)
    n_out[0] = base + len(lanes)
    if live is not None:
        live[0] += len(kept)


def shard_ext_step_kernel(alive, k, l, m, pos_f, b_lane, rw, lens, L, l2,
                          back, slot, seq_len, primary, lanes):
    """One step of the listed lanes (ext_lane); returns the lanes' new
    (alive, k, l, m), as copies, and the lanes kept alive.  A lane that
    dies gets its flag cleared; a kept lane's flag is not written."""
    n = len(alive)
    i = lanes
    q = pos_f[i] + m[i]
    qc = np.minimum(q, L - 1)
    word = rw[b_lane[i], qc >> 4].astype(np.uint64)
    c = ((word >> (3 * (15 - (qc & 15))).astype(np.uint64))
         & np.uint64(7)).astype(np.int64)
    ok_char = (q < lens[b_lane[i]]) & (c < 4)
    cc = np.where(ok_char, 3 - c, 0)
    ki, li = k[i], l[i]
    pk, pl = occ_pos(seq_len, primary, ki - 1), occ_pos(seq_len, primary, li)
    nk = l2[cc] + occ_of_row(seq_len, l2, row_at(back, slot[i]), ki - 1, pk,
                             cc) + 1
    nl = l2[cc] + occ_of_row(seq_len, l2, row_at(back, slot[n + i]), li, pl,
                             cc)
    a = ok_char & (nk <= nl) & (m[i] < MAX_ANCHOR)
    alive, k, l, m = alive.copy(), k.copy(), l.copy(), m.copy()
    alive[i[~a]] = False
    k[i] = np.where(a, nk, ki)
    l[i] = np.where(a, nl, li)
    m[i] = m[i] + a
    return alive, k, l, m, i[a]


def shard_walk_step_kernel(active, rows, steps, l2, back, slot, seq_len,
                           primary, intv, lanes):
    """One walk step of the listed rows (walk_lane); returns the rows' new
    (active, rows, steps) and the rows kept active."""
    i = lanes
    r = rows[i]
    x = r - (r > primary)
    row = row_at(back, slot[i])
    ch = row_char(row, x)
    nxt = l2[ch] + occ_of_row(seq_len, l2, row, r, x, ch)
    nxt = np.where(r == primary, 0, nxt)
    a = (nxt & (intv - 1)) != 0
    active, rows, steps = active.copy(), rows.copy(), steps.copy()
    active[i[~a]] = False
    rows[i] = nxt
    steps[i] += 1
    return active, rows, steps, i[a]


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

    def ring(state, live, lanes):
        """The step's lanes (for_lanes) and the list and counts it writes,
        as numpy views (lane_ring, then live); a list step's entries never
        outnumber the lanes its grid covers, a thread each (the block's
        live lanes at its start: the kernel traps if they do)."""
        views = [None if x is None else x.numpy()
                 for x in (*K.lane_ring(lanes), live)]
        n = state[0].shape[0]
        n_in = None if views[1] is None else int(views[1][0])
        if n_in is not None:
            assert n_in <= K.grid_lanes(n, lanes), (n_in, lanes.n_live)
        return for_lanes(state[0].numpy(), views[0], n_in), views[2:]

    def ext_step(state, pos_f, b_lane, rd, arrs, meta, back, slot,
                 live=None, *, lanes):
        idx, out = ring(state, live, lanes)
        res = shard_ext_step_kernel(
            *(x.numpy() for x in state), pos_f.numpy(), b_lane.numpy(),
            rd.rw.numpy(), rd.lens.numpy(), rd.L, arrs["L2"].long().numpy(),
            back.numpy(), slot.numpy().astype(np.int64), meta["seq_len"],
            meta["primary"], idx)
        for x, v in zip(state, res):
            x.copy_(T(np.asarray(v)))
        append(rng, idx, res[4], *out)

    def walk_step(state, arrs, meta, back, slot, live=None, *, lanes):
        idx, out = ring(state, live, lanes)
        res = shard_walk_step_kernel(
            *(x.numpy() for x in state), arrs["L2"].long().numpy(),
            back.numpy(), slot.numpy().astype(np.int64), meta["seq_len"],
            meta["primary"], meta["sa_intv"], idx)
        for x, v in zip(state, res):
            x.copy_(T(np.asarray(v)))
        append(rng, idx, res[3], *out)

    K.shard_bucket, K.shard_answer = bucket, answer
    K.shard_ext_step, K.shard_walk_step = ext_step, walk_step
    return saved


def step_case(rng, kind, n, seq_len, live_share, pos64):
    """A step kernel's inputs, drawn at random (numpy): n lanes of which
    about live_share are live, over rank rows of random counts and BWT
    words returned in random slots (some -1); rows and intervals drawn
    from [2^31, seq_len] with pos64 (an int64 index; seq_len >= 2^33 keeps
    the rows a step reaches from C on above 2^31 too), else from [0,
    seq_len], seq_len < 2^31.  kind "ext": state (alive, k, l, m), pos_f,
    b_lane, reads (B, L) uint8 codes and lens; "walk": state (active,
    rows, steps).  L2 (5,) int64 (int32 without pos64) rises to seq_len;
    meta holds seq_len, primary and sa_intv 32."""
    lo = 2**31 if pos64 else 0
    assert pos64 == (seq_len >= 2**31 - 1)
    primary = int(rng.integers(lo, seq_len))
    # L2's inner values and the rows' counts keep every next row in [0,
    # seq_len] (above seq_len / 4 but for A's), as an index's do
    l2 = np.zeros(5, np.int64)
    l2[1:4] = np.sort(rng.integers(seq_len // 4, seq_len // 2, 3))
    l2[4] = seq_len
    live = rng.random(n) < live_share
    Q = 2 * n if kind == "ext" else n
    slots = Q + Q // 4
    back = np.empty((slots, 12), np.int64)
    back[:, :4] = rng.integers(0, seq_len // 4, (slots, 4))
    back[:, 4:] = rng.integers(0, 2**32, (slots, 8))
    slot = rng.permutation(slots)[:Q].astype(np.int32)
    slot[rng.random(Q) < 0.05] = -1
    out = {"meta": {"seq_len": seq_len, "primary": primary, "sa_intv": 32},
           "L2": l2.astype(np.int64 if pos64 else np.int32), "back": back,
           "slot": slot}
    if kind == "walk":
        rows = rng.integers(lo, seq_len + 1, n)
        rows[:: 97] = primary
        rows[1:: 89] = seq_len
        out["state"] = (live & ((rows & 31) != 0), rows,
                        rng.integers(0, 40, n))
        return out
    B, L = 64, 300
    k = rng.integers(lo, seq_len, n)
    l = np.minimum(k + rng.integers(-1, 3000, n), seq_len)
    k[:5], l[5:10] = lo, seq_len
    out["state"] = (live, k, l, rng.integers(0, 60, n))
    out["pos_f"] = rng.integers(0, L, n)
    out["b_lane"] = rng.integers(0, B, n)
    out["reads"] = rng.integers(0, 5, (B, L)).astype(np.uint8)
    out["lens"] = rng.integers(100, L + 1, B)
    out["m_max"] = np.nonzero(live)[0][:3]  # lanes at MAX_ANCHOR_LEN
    out["state"][3][out["m_max"]] = MAX_ANCHOR
    return out


def step_args(case, kind, device):
    """A step_case as its wrapper's positional arguments on device: ext
    [state, pos_f, b_lane, rd, arrs, meta, back, slot], walk [state, arrs,
    meta, back, slot]."""
    import torch

    from lordfast_tpu_torch.ops import fm_index as fm

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    state = [T(x) for x in case["state"]]
    arrs = {"L2": T(case["L2"])}
    tail = [arrs, case["meta"], T(case["back"]), T(case["slot"])]
    if kind == "walk":
        return [state] + tail
    rd = fm._Reads(T(case["reads"]), T(case["lens"]))
    return [state, T(case["pos_f"]), T(case["b_lane"]), rd] + tail


def list_steps(K, step, plain, case, kind, device, rng, g=4):
    """A block's first step (loop step g, over the flags) and its second
    (step g + 1, over the list the first wrote, counting its kept lanes
    into live as a block's last step does) of a step_case, through
    ``step`` (a wrapper, or its model once installed) and ``plain`` (its
    plain version), each from copies of the same inputs; the list step
    also with its list reversed and shuffled by rng.  Returns {run:
    outputs}, the outputs the lane state, the counter ring, the list the
    step wrote, sorted, and live (None on the first step): "first",
    "first plain", "list", "list reversed", "list shuffled", "list
    plain"."""
    import torch

    args = step_args(case, kind, device)
    n = args[0][0].shape[0]
    n_live = int(args[0][0].sum())

    def clone(x):
        return [[y.clone() for y in x[0]]] + x[1:]

    def outputs(a, lists, ring, lanes, live):
        _, _, list_out, n_out, _ = K.lane_ring(lanes)
        return [x.clone() for x in a[0]] + [ring.clone(), list_out[
            : int(n_out[0])].sort().values, live]

    out = {}
    lists, ring = K.lane_list(n, device)
    before = None
    for tag, f in (("first plain", plain), ("first", step)):
        a, ls, rg = clone(args), lists.clone(), ring.clone()
        lanes = K.LaneList(ls, rg, g, True, n_live)
        f(*a, lanes=lanes)
        out[tag] = outputs(a, ls, rg, lanes, None)
        before = (a, ls, rg)  # the kernel's (or model's) list, its order
    for tag, f in (("list plain", plain), ("list", step),
                   ("list reversed", step), ("list shuffled", step)):
        a, ls, rg = clone(before[0]), before[1].clone(), before[2].clone()
        lanes = K.LaneList(ls, rg, g + 1, False, n_live)
        list_in, n_in = K.lane_ring(lanes)[:2]
        m = int(n_in[0])
        if tag == "list reversed":
            list_in[:m] = list_in[:m].flip(0)
        elif tag == "list shuffled":
            list_in[:m] = list_in[:m][torch.from_numpy(
                rng.permutation(m)).to(device)]
        live = torch.zeros(1, dtype=torch.int32, device=device)
        f(*a, live, lanes=lanes)  # as a block's last step
        out[tag] = outputs(a, ls, rg, lanes, live)
    return out
