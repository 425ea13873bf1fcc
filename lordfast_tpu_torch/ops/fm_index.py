"""Batched FM-index seeding in PyTorch.

Port of ``lordfast_tpu/ops/fm_index.py``: the equivalents of
``bwt_occ``/``bwt_2occ`` (lib/bwa/bwt.c:107-163), ``bwt_sa``
(lib/bwa/bwt.c:86-96) and the active seeder ``getLocs_extend_whole_step``
(src/BWT.cpp:312-394), as batched tensor code that runs on whatever
device the index tensors live on.

The anchor search is the JAX package's mirror-space design: the indexed
text is fwd+revcomp, so revcomp(anchor) is searched and growing the
anchor on the right is one backward-extension step on the left of the
searched pattern, in lockstep across all (read, sample position) lanes.
Located hits are mapped back through the mirror, so the seed set is the
reference's exactly.

Tensor conventions: the index's uint32 words arrive as int64 tensors
holding the same values (``FMIndex.device_arrays``), so every shift here
is logical; ``~w`` is written ``w ^ 0xFFFFFFFF``.  Positions and rows are
int64 inside and cast to the index's position dtype on output.

On a CUDA tensor the staged extension (``_staged_ext``: the greedy
extension steps and the occ==1 finish) is one launch of the hand-written
kernel ``csrc/seed_ext.cu`` (``fm_index_cuda.seed_ext``), one thread per
lane, and with a sampled SA the locate of the multi-hit slots
(``sa_lookup``) is one launch of the same library's locate kernel
(``fm_index_cuda.sa_locate``), whose lanes take slots from a queue as
their walks end; with a full SA the locate is one gather.  The plain PyTorch loops here are their plain
versions, the CPU path, the path of ``plain`` (``MappingEngine(
plain_loops=True)``) and the oracle.  Where the JAX version bounds its
lockstep loops with fixed-width compaction (``top_k`` into capped
buffers inside ``lax.cond``), they compact to the exact surviving lane
set with ``nonzero`` — eager PyTorch has dynamic shapes.  Which lanes
ride which stage does not change any lane's result, so the outputs are
the JAX version's.

Sharded index (``group=``, parallel/sharded_index.py): the row arrays
``fm_blocks`` / ``occ_cp`` / ``bwt_blocks`` / ``bwt_words`` / ``sa_samp``
hold only this rank's stripe, and every row gather goes to the rank that
owns the row through torch.distributed collectives (``exchange``: the
JAX version's fixed (D, cap) buckets with equal splits, and its
all-gather route; the one protocol around both the plain steps here and
the kernels of ``fm_shard_cuda``).  Each collective needs every rank of
the group, so under a group the seeder takes the JAX version's sharded
branches: the plain lockstep extension (no occ==1 text-compare fast path) and the walk
over every slot, every rank stepping until no lane of any rank is live.
The loops run in blocks of ``SHARD_BLOCK_STEPS`` steps with one host read
a block (``_shard_blocks``); a block whose buckets overflowed runs again
through the all-gather route.  On a CUDA device each step is launches of
``csrc/seed_shard.cu`` between the collectives (``fm_shard_cuda``
``shard_ext`` / ``shard_walk``); ``_shard_ext`` and ``_shard_walk`` here
are their plain versions, the CPU path and the oracle.  The ``nonzero``
compactions above would give each rank its own lane set and stay on the
``group=None`` path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

# Maximum anchor length; the reference stores seed length in a 12-bit
# field (Seed_t.len, src/LordFAST.h:30-35), so 4095 is its hard cap too.
MAX_ANCHOR_LEN = 4095

M32 = 0xFFFFFFFF


def torch_pos_dtype(meta) -> torch.dtype:
    """torch dtype of the index's position arrays (FMIndex.pos_dtype)."""
    return torch.int32 if meta["seq_len"] < 2**31 - 1 else torch.int64


def _popcount32(x):
    """Population count of int64 tensors holding uint32 values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


# The steps a sharded lockstep loop runs between two reads of its
# group-wide flags (_shard_blocks).  A loop runs to the longest lane of any
# rank (extension: the longest anchor, up to MAX_ANCHOR_LEN; walk: the
# longest walk, 340 steps on v2 at sa_intv 32 and 459 on a 300 Mbp genome
# at 32); a block ends with one all_reduce and one host read, and runs up
# to S - 1 steps after its last lane died, each a few launches and two
# collectives of a few lanes.  PERF.md gives the card's figures (Sharded
# seeding loops).
SHARD_BLOCK_STEPS = 32

# Counts of the sharded loops since the last reset: the seeder's device
# calls under a group, the blocks run, the blocks run again through the
# all-gather route, the steps, and the host reads of the loops' flags and
# of the exact gathers.
shard_counts = {"calls": 0, "blocks": 0, "redone": 0, "steps": 0,
                "host_reads": 0}


def shard_cap(n_queries, D):
    """Slots a bucket holds when n_queries are routed over D ranks: the
    JAX version's 2 ceil(Q / D) rounded up to 8 (``_row_gather_routed``
    :96-97), and at least 8."""
    cap = -(-2 * n_queries // D)
    return max((cap + 7) & ~7, 8)


class ShardRoute(NamedTuple):
    """The row gathers of one block of a sharded loop's steps: the
    process group, the buckets' slots (shard_cap of the most queries a
    step of any rank asks at the block's start: lanes only die), or None
    for the all-gather route (the JAX version's ``_row_gather_ag``), the
    block's flags (2,) int32 on the device: the live lanes after its
    last step and whether a bucket overflowed; and the group's most live
    lanes at the block's start (the step kernels' grid; the plain steps
    do not read it)."""

    group: object
    cap: object
    flags: torch.Tensor
    n_live: int = 0


def _answer(stripe, ids, base):
    """Rows ids - base of this rank's stripe, zeros where the row is not
    this rank's (ids of other ranks, -1 for none)."""
    rps = stripe.shape[0]
    loc = ids - base
    ok = (loc >= 0) & (loc < rps)
    vals = stripe[loc.clamp(0, rps - 1)]
    return torch.where(ok.view(ok.shape + (1,) * (stripe.dim() - 1)), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))


def bucket(q, ask, rps, D, cap):
    """The routed buckets of queries q (Q,) int64 (row ids of stripes of
    rps rows) where ask (Q,) bool is set: (slot, send, counts), each
    asked query's slot in its owner's bucket of cap, taken in query
    order, or -1 (not asked, or past the cap); the (D cap,) send buffer
    of row ids, -1 where empty; each owner's asked queries (D,)."""
    owner = torch.where(ask, (q // rps).clamp(0, D - 1), D)
    order = torch.argsort(owner, stable=True)
    so = owner[order]
    counts = torch.bincount(owner, minlength=D + 1)
    rank = torch.arange(q.numel(), device=q.device) - (
        torch.cumsum(counts, 0) - counts)[so]
    slot = torch.empty_like(q)
    slot[order] = torch.where((so < D) & (rank < cap), so * cap + rank, -1)
    send = q.new_full((D * cap,), -1)
    send[slot[slot >= 0]] = q[slot >= 0]
    return slot, send, counts[:D]


def by_slot(back, slot):
    """back's row of each slot, zeros for slot -1."""
    rows = back[slot.long().clamp(min=0)]
    ok = (slot >= 0).view(slot.shape + (1,) * (back.dim() - 1))
    return torch.where(ok, rows, torch.zeros((), dtype=rows.dtype,
                                              device=rows.device))


def _empty(bufs, key, shape, dtype, device):
    """torch.empty(shape), or with ``bufs`` (a dict that a sharded loop
    keeps over its steps) the tensor made for ``key`` at this shape and
    dtype the first time, kept there for the next step."""
    x = None if bufs is None else bufs.get(key)
    if x is None or x.shape != torch.Size(shape) or x.dtype != dtype:
        x = torch.empty(shape, dtype=dtype, device=device)
        if bufs is not None:
            bufs[key] = x
    return x


def exchange(group, bucket_fn, answer_fn, cap, over=None, n_pad=0,
             bufs=None):
    """One gather of rows over a row-striped array (global row r on rank
    r // rps), every rank of the group at the same time, around the
    caller's two steps (the plain ones here, the seed_shard.cu kernels in
    fm_shard_cuda):

    - ``bucket_fn(cap, over)`` -> (send, slot): with cap an int, this
      rank's asked queries in their owners' buckets of cap slots, send
      (D cap,) row ids (-1 in the empty slots) and each query's slot (-1:
      not asked, or past its bucket's cap, when over (1,) is raised on the
      device); with cap None, each query's row id (-1: not asked) in query
      order and its slot, its index.
    - ``answer_fn(ids)`` -> this rank's answers to the row ids (zeros
      where it does not own the row, and for -1).

    cap an int: the JAX version's ``_row_gather_routed``, one
    ``all_to_all_single`` of the row ids with equal splits, the answer,
    the answers straight back.  cap None: its ``_row_gather_ag``, every
    rank's queries (padded with -1 to n_pad) to every rank
    (``all_gather_into_tensor``), the answer, one ``reduce_scatter_tensor``
    (SUM): exact, since every row has one owner.  bufs: _empty's.
    Returns (back, slot): query i's answer is back[slot[i]] (by_slot)."""
    send, slot = bucket_fn(cap, over)
    if n_pad > send.numel():
        send = torch.cat([send, send.new_full((n_pad - send.numel(),), -1)])
    n_ids = send.numel() * (1 if cap is not None else group.size())
    ids = _empty(bufs, "ids", (n_ids,), send.dtype, send.device)
    if cap is not None:
        dist.all_to_all_single(ids, send, group=group)
    else:
        dist.all_gather_into_tensor(ids, send, group=group)
    vals = answer_fn(ids)
    back = _empty(bufs, "back", (send.numel(),) + tuple(vals.shape[1:]),
                  vals.dtype, vals.device)
    if cap is not None:
        dist.all_to_all_single(back, vals, group=group)
    else:
        dist.reduce_scatter_tensor(back, vals, op=dist.ReduceOp.SUM,
                                   group=group)
    return back, slot


def _read_flags(flags, group):
    """The group-wide MAX of a small int tensor, on the host: one
    all_reduce and one host read (counted in shard_counts)."""
    dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=group)
    shard_counts["host_reads"] += 1
    return flags.tolist()


def exact_gather(group, n, device, bucket_fn, answer_fn):
    """One exchange that cannot lose a query, the JAX version's
    ``lax.cond`` over its two routes: the group's largest query count
    read on the host (the buckets' cap, shard_cap of it), the routed
    buckets, the overflow flag read on the host, and, when a bucket
    overflowed, the all-gather route with every rank's n queries padded
    to the largest count.  Two host reads.  Returns exchange's (back,
    slot).  The flags are int32, as the bucket kernel's overflow flag."""
    flags = torch.tensor([n, 0], dtype=torch.int32, device=device)
    n_max = _read_flags(flags, group)[0]
    flags.zero_()
    out = exchange(group, bucket_fn, answer_fn, shard_cap(n_max,
                                                          group.size()),
                   flags[1:])
    if _read_flags(flags, group)[1]:
        out = exchange(group, bucket_fn, answer_fn, None, n_pad=n_max)
    return out


def _plain_steps(stripe, rows, group, live):
    """exchange's bucket_fn and answer_fn for rows of this rank's
    ``stripe``, in plain torch (bucket, _answer): the queries rows
    (flattened) where ``live`` (broadcast to rows' shape; None: every
    one) is set."""
    D, d, rps = group.size(), group.rank(), stripe.shape[0]
    q = rows.reshape(-1).long()
    ask = (torch.ones_like(q, dtype=torch.bool) if live is None else
           torch.broadcast_to(live, rows.shape).reshape(-1))

    def bucket_fn(cap, over):
        if cap is None:
            return torch.where(ask, q, -1), torch.arange(q.numel(),
                                                         device=q.device)
        slot, send, counts = bucket(q, ask, rps, D, cap)
        over.copy_(torch.maximum(over, (counts > cap).any().to(over.dtype)))
        return send, slot

    def answer_fn(ids):
        return _answer(stripe, ids, d * rps).contiguous()

    return bucket_fn, answer_fn


def _row_gather(stripe, rows, group, live=None):
    """Row gather from this rank's ``stripe`` of a row-striped array
    (global row r lives on rank r // rps at local row r % rps, rps =
    stripe.shape[0]): every rank of the group calls this at the same
    time, and each query goes to the rank that owns its row, in one
    exact_gather, whose results have a plain gather's bits.  ``live``
    (broadcast to rows' shape): only those queries are asked; the others
    get zeros."""
    back, slot = exact_gather(group, rows.numel(), rows.device,
                              *_plain_steps(stripe, rows, group, live))
    return by_slot(back, slot).reshape(tuple(rows.shape)
                                       + tuple(stripe.shape[1:]))


def _route_gather(stripe, rows, route=None, live=None):
    """Row gather of a step of a sharded loop's block: through ``route``
    (a ShardRoute; its overflow flag left on the device for the block's
    end), or a plain gather from the whole array for route None.  A
    query past its bucket's cap gets zeros (its block is run again)."""
    if route is None:
        return stripe[rows]
    back, slot = exchange(route.group,
                          *_plain_steps(stripe, rows, route.group, live),
                          route.cap, route.flags[1:])
    return by_slot(back, slot).reshape(tuple(rows.shape)
                                       + tuple(stripe.shape[1:]))


def _shard_blocks(step, state, group, per_lane):
    """A sharded lockstep loop in blocks: ``state`` is a list of lane
    tensors whose first is the lane's live mask, ``step(state, route,
    first, last)`` one step of every lane (a dead lane left as it is)
    that returns the new state, gathers rows through ``route`` (a
    ShardRoute), at most ``per_lane`` queries a lane a gather, and, when
    ``last`` (the block's last step), writes the live lanes into
    route.flags[0]; ``first``: the block's first step.

    One host read sizes the first block (the group's most live lanes);
    then each block runs SHARD_BLOCK_STEPS steps through the routed
    buckets (cap from the live lanes at the block's start: lanes only
    die) and ends with one all_reduce (MAX) of [live lanes, overflow] and
    one host read.  A block that overflowed runs again from the state
    saved at its start through the all-gather route, with one more host
    read.  Exact: a step is a pure function of the lane state, and steps
    past a lane's end leave it as it is.  The flags are group-wide, so
    every rank runs the same blocks."""
    S = SHARD_BLOCK_STEPS
    flags = torch.zeros(2, dtype=torch.int32, device=state[0].device)
    flags[0] = state[0].sum()
    n_live = _read_flags(flags, group)[0]

    def run(st, route):
        for i in range(S):
            st = step(st, route, i == 0, i == S - 1)
        shard_counts["steps"] += S
        return st

    while n_live:
        start = [x.clone() for x in state]
        flags.zero_()
        cap = shard_cap(n_live * per_lane, group.size())
        state = run(state, ShardRoute(group, cap, flags, n_live))
        shard_counts["blocks"] += 1
        n_end, over = _read_flags(flags, group)
        if over:
            shard_counts["redone"] += 1
            flags.zero_()
            state = run(start, ShardRoute(group, None, flags, n_live))
            n_end = _read_flags(flags, group)[0]
        n_live = n_end
    return state


def occ_from_rows(arrs, meta, k, c, base, w):
    """occ(k, c) from the counts ``base`` of c before the block of k's
    query and that block's 8 BWT words ``w`` (..., 8), the rows gathered
    for it; k == seq_len counts c's total and k < 0 is 0."""
    seq_len = meta["seq_len"]
    kk = k.clamp(0, seq_len - 1)
    off = (kk - (kk >= meta["primary"]).long()) & 127
    cidx = c[..., None]
    hi = torch.where((cidx & 2) != 0, w, w ^ M32)
    lo = torch.where((cidx & 1) != 0, w, w ^ M32)
    matched = (hi >> 1) & lo & 0x55555555

    f = (off >> 4)[..., None]  # word holding the row
    r = (off & 15)[..., None]  # base offset within it
    lane = torch.arange(8, device=k.device)
    partial = ((1 << ((15 - r) << 1)) - 1) ^ M32
    cover = torch.where(lane < f, M32,
                        torch.where(lane == f, partial, 0))
    cnt = _popcount32(matched & cover).sum(-1)

    L2 = arrs["L2"].long()
    total = L2[c + 1] - L2[c]
    res = base + cnt
    res = torch.where(k == seq_len, total, res)
    return torch.where(k < 0, 0, res)


def occ(arrs, meta, k, c, route=None, live=None):
    """Occ(c, k): count of char c in the $-removed BWT prefix at row k.

    Semantics of bwt_occ (lib/bwa/bwt.c:107-129) including the primary-row
    adjustment; k in [-1, seq_len], c in [0, 3] (int64 tensors, shapes
    broadcast).  Reads the fused ``fm_blocks`` rank rows when the index
    has them, else the ``occ_cp``/``bwt_blocks`` pair (l_pac >= 2^32);
    route, live: a sharded loop's routing of their stripes
    (_route_gather)."""
    seq_len = meta["seq_len"]
    k, c = torch.broadcast_tensors(k, c)
    kk = k.clamp(0, seq_len - 1)
    blk = (kk - (kk >= meta["primary"]).long()) >> 7
    cidx = c[..., None]
    if "fm_blocks" in arrs:
        # (..., 12): cp(A..T) | 8 words
        row = _route_gather(arrs["fm_blocks"], blk, route, live)
        base = row[..., :4].gather(-1, cidx)[..., 0]
        w = row[..., 4:]
    else:
        base = _route_gather(arrs["occ_cp"], blk, route, live).gather(
            -1, cidx)[..., 0]
        w = _route_gather(arrs["bwt_blocks"], blk, route, live)  # (..., 8)
    return occ_from_rows(arrs, meta, k, c, base, w)


def backward_ext(arrs, meta, k, l, c, route=None, live=None):
    """One backward-search step: [k, l] -> interval of c+pattern
    (bwt_count_exact inner step, src/BWT.cpp:255-258).  The two rank
    queries go through one stacked occ call (bwa's bwt_2occ fusion)."""
    both = occ(arrs, meta, torch.stack([k - 1, l]), c[None], route,
               None if live is None else live[None])
    L2c = arrs["L2"].long()[c]
    return L2c + both[0] + 1, L2c + both[1]


def bwt_b0(arrs, k, route=None, live=None):
    """BWT char at $-removed position k (bwt_B0, lib/bwa/bwt.h:78)."""
    w = _route_gather(arrs["bwt_words"], k >> 4, route, live)
    return (w >> (((k ^ -1) & 15) << 1)) & 3


def _walk_step(arrs, meta, rows, route=None, live=None):
    """One inverse-Psi step (bwt_invPsi, lib/bwa/bwt.c:53-59)."""
    primary = meta["primary"]
    x = rows - (rows > primary).long()
    ch = bwt_b0(arrs, x, route, live)
    nxt = arrs["L2"].long()[ch] + occ(arrs, meta, rows, ch, route, live)
    return torch.where(rows == primary, 0, nxt)


def _shard_walk(arrs, meta, rows, active, group):
    """The locate walk over a sharded index, plain (the JAX version's
    ``sa_lookup`` walk under an axis): every active row takes one
    inverse-Psi step a step, its rank and BWT-word lookups routed to
    their owners for the active rows only, until no row of any rank is
    active, in blocks (_shard_blocks).  Returns (rows, steps): each row's
    sampled row and its steps.  Each call adds one to
    ``_shard_walk.entries``: on the card ``fm_shard_cuda.shard_walk``
    replaces it."""
    _shard_walk.entries += 1
    mask = meta["sa_intv"] - 1

    def step(st, route, first, last):
        act, r, n = st
        r = torch.where(act, _walk_step(arrs, meta, r, route, act), r)
        n = n + act.long()
        act = act & ((r & mask) != 0)
        if last:
            route.flags[0] = act.sum()
        return [act, r, n]

    _, rows, steps = _shard_blocks(step, [active, rows, torch.zeros_like(
        rows)], group, 1)
    return rows, steps


_shard_walk.entries = 0


def _sa_gather(arrs, rows, valid, group):
    """The sampled SA entries of rows where valid, 0 elsewhere, as int64:
    one exact gather (_row_gather) from the sa_samp stripes."""
    return _row_gather(arrs["sa_samp"], rows, group, valid).long()


def _shard_locate(arrs, meta, rows, valid, group, walk, gather):
    """SA values of rows (n,) int64 where valid, 0 elsewhere, over a
    sharded index: with a full SA one exact gather; else ``walk``
    (_shard_walk, or on the card fm_shard_cuda.shard_walk) to sampled
    rows, then one exact gather of their entries (``gather``: _sa_gather,
    or on the card fm_shard_cuda.sa_gather)."""
    intv = meta["sa_intv"]
    rows = torch.where(valid, rows.long(), 0)
    if intv == 1:
        return torch.where(valid, gather(arrs, rows, valid, group), 0)
    active = valid & ((rows & (intv - 1)) != 0)
    rows, steps = walk(arrs, meta, rows, active, group)
    ent = gather(arrs, rows >> (int(intv).bit_length() - 1), valid, group)
    return torch.where(valid, steps + ent, 0)


def sa_lookup(arrs, meta, rows, valid, group=None):
    """SA values for a batch of rows: inverse-Psi walk until a sampled
    row (bwt_sa, lib/bwa/bwt.c:86-96).  Rows outside ``valid`` return 0.

    With the full SA on device (sa_intv == 1) locate is one gather.  Else
    the walk runs in two phases like the JAX version's: intv/2 lockstep
    steps over every lane, then the survivors are compacted and walked
    to the end.  The index samples by row (``sa_full[::intv]``), so a
    walk ends at the first row that is a multiple of intv: its length is
    geometric with mean ~intv (not uniform in [0, intv)), and the
    longest of n lanes ~intv ln n.  At intv 32 (chip_smoke.py's
    sa_locate lines): v2's first locate call, 22,044 lanes, a mean of
    31.2 steps, p99 146, the longest 340; a 300 Mbp random genome's,
    147,386 lanes, 31.0, 146 and 459.  So ~60% of the lanes survive the
    first intv/2 steps.  Under a sharded index (group) the walk is
    _shard_walk's (_shard_locate).  Each walk (sa_intv > 1) adds one to
    ``sa_lookup.entries``: on the card, the locate kernels
    (``fm_index_cuda.sa_locate``, ``fm_shard_cuda.shard_walk``) replace
    it."""
    rows = rows.long()
    intv = meta["sa_intv"]
    sa = arrs["sa_samp"]
    if intv > 1:
        sa_lookup.entries += 1
    if group is not None:
        return _shard_locate(arrs, meta, rows, valid, group, _shard_walk,
                             _sa_gather)
    if intv == 1:
        r = torch.where(valid, rows, 0).clamp(0, sa.shape[0] - 1)
        return torch.where(valid, sa[r].long(), 0)
    mask = intv - 1
    log2_intv = int(intv).bit_length() - 1
    rows = torch.where(valid, rows, 0)
    steps = torch.zeros_like(rows)
    active = valid & ((rows & mask) != 0)
    for _ in range(intv // 2):
        rows = torch.where(active, _walk_step(arrs, meta, rows), rows)
        steps = steps + active.long()
        active = active & ((rows & mask) != 0)
    idx = active.nonzero().squeeze(1)
    r, s = rows[idx], steps[idx]
    while idx.numel():
        r = _walk_step(arrs, meta, r)
        s = s + 1
        done = (r & mask) == 0
        rows[idx[done]] = r[done]
        steps[idx[done]] = s[done]
        keep = (~done).nonzero().squeeze(1)
        idx, r, s = idx[keep], r[keep], s[keep]
    out = steps + sa[rows >> log2_intv].long()
    return torch.where(valid, out, 0)


sa_lookup.entries = 0


class SeedBatch(NamedTuple):
    """Padded per-read seed tensors; the device analogue of the
    forward/reverse SeedList pair (src/LordFAST.h:37-41)."""

    t_pos: torch.Tensor   # (B, MS) target position (forward-genome coords)
    q_pos: torch.Tensor   # (B, MS) query position (strand-local, like ref)
    length: torch.Tensor  # (B, MS) anchor length
    is_rev: torch.Tensor  # (B, MS) bool strand
    valid: torch.Tensor   # (B, MS) bool
    n_total: torch.Tensor     # (B,) hits found (before the MS cap)
    n_anchors: torch.Tensor   # (B,) accepted anchors


def sample_positions_host(read_lens, sampling_count):
    """Anchor sampling positions, bit-exact with the reference's float
    accumulation (src/BWT.cpp:320-328: seed_pos += step in double, then
    truncate).  numpy's sequential float64 cumsum reproduces the C loop's
    IEEE addition order."""
    read_lens = np.asarray(read_lens, dtype=np.int64)
    step = read_lens.astype(np.float64) / sampling_count  # (B,)
    acc = np.zeros((len(read_lens), sampling_count), dtype=np.float64)
    acc[:, 1:] = np.cumsum(
        np.repeat(step[:, None], sampling_count - 1, axis=1), axis=1
    )
    return acc.astype(np.int32)  # truncation toward zero, like (uint32) cast


class _Reads:
    """A read batch in the seeder's layouts: 3-bit packed words (16 chars
    per int64, first char in the highest bits) and per-lane lengths."""

    def __init__(self, reads, read_lens):
        B, L = reads.shape
        self.L = L
        Lp = ((L + 15) // 16) * 16
        r = reads.long()
        if Lp != L:
            r = torch.nn.functional.pad(r, (0, Lp - L), value=4)
        self.W16 = Lp // 16
        j16 = torch.arange(16, device=reads.device)
        self.rw = (r.view(B, self.W16, 16) << (3 * (15 - j16))).sum(-1)
        self.lens = read_lens.long()

    def char(self, b, q):
        """Read code at (row b, position q); q is clipped into the row."""
        qc = q.clamp(0, self.L - 1)
        return (self.rw[b, qc >> 4] >> (3 * (15 - (qc & 15)))) & 7


def next_char(rd, bf, posf, m):
    """(ok_char, cc) of each lane's next read position posf + m: whether
    its char is an ACGT inside the read, and the char's complement (0
    where not)."""
    q = posf + m
    c = rd.char(bf, q)
    ok_char = (q < rd.lens[bf]) & (c < 4)
    return ok_char, torch.where(ok_char, 3 - c, 0)


def advance(alive, k, l, m, ok_char, nk, nl):
    """A greedy-extension step's lanes: an alive lane with an ACGT char,
    a non-empty interval [nk, nl] and m < MAX_ANCHOR_LEN takes it; every
    other lane dies, or stays dead, with k, l, m as they were."""
    alive = alive & ok_char & (nk <= nl) & (m < MAX_ANCHOR_LEN)
    return (alive, torch.where(alive, nk, k), torch.where(alive, nl, l),
            m + alive.long())


def _ext_step(arrs, meta, rd, alive, k, l, m, posf, bf, route=None):
    """One lockstep greedy-extension step: each alive lane consumes the
    complement of its next read char as one backward-extension step and
    dies at the first step that fails (a dead lane is left as it is);
    route: a sharded loop's routing (ShardRoute), for the alive lanes'
    queries."""
    ok_char, cc = next_char(rd, bf, posf, m)
    nk, nl = backward_ext(arrs, meta, k, l, cc, route,
                          None if route is None else alive)
    return advance(alive, k, l, m, ok_char, nk, nl)


def _ext_steps(arrs, meta, rd, alive, k, l, m, posf, bf, n_steps):
    """n_steps lockstep greedy-extension steps (_ext_step)."""
    for _ in range(n_steps):
        alive, k, l, m = _ext_step(arrs, meta, rd, alive, k, l, m, posf, bf)
    return alive, k, l, m


def _shard_ext(arrs, meta, rd, alive, k, l, m, posf, bf, group):
    """The lockstep extension over a sharded index, plain (the JAX
    version's ``ext_loop_flat`` under an axis): _ext_step until no lane
    of any rank is alive, the alive lanes' rank lookups routed to their
    owners, in blocks (_shard_blocks).  Returns the final (k, l, m).
    Each call adds one to ``_shard_ext.entries``: on the card
    ``fm_shard_cuda.shard_ext`` replaces it."""
    _shard_ext.entries += 1

    def step(st, route, first, last):
        st = _ext_step(arrs, meta, rd, *st, posf, bf, route)
        if last:
            route.flags[0] = st[0].sum()
        return list(st)

    # a step stacks each lane's two rank queries (backward_ext)
    _, k, l, m = _shard_blocks(step, [alive, k, l, m], group, 2)
    return k, l, m


_shard_ext.entries = 0


def _resolve_rounds(arrs, meta, rd, k, m, posf, bf):
    """occ==1 fast path for lanes whose interval is one row: the rest of
    the greedy extension is "does the text left of the unique occurrence
    keep matching the complemented read", answered by 128-char direct
    comparisons against the packed text instead of one rank query per
    base.  Returns (m_final, p_final): the final anchor length and the
    occurrence position in mirror space."""
    dev = k.device
    p = sa_lookup(arrs, meta, k, torch.ones_like(k, dtype=torch.bool))
    CH = 128
    NW = CH // 16 + 1  # 9 words cover any 128-char window
    jj = torch.arange(CH, device=dev)
    wj = torch.arange(NW, device=dev)
    t_sh = 2 * (15 - torch.arange(16, device=dev))
    r_sh = 3 * (15 - torch.arange(16, device=dev))
    max_row = (meta["seq_len"] - 1) >> 4
    lens = rd.lens[bf]
    act = torch.ones_like(k, dtype=torch.bool)
    V = k.shape[0]
    while bool(act.any()):
        # text window [p-CH, p), unpacked last-position-first; the
        # arithmetic shift keeps the in-word offset in [128, 143]
        base_w = (p - CH) >> 4
        rows = (base_w[:, None] + wj).clamp(0, max_row)
        tw = (arrs["pac_words"][rows][:, :, None] >> t_sh) & 3
        twr = tw.reshape(V, NW * 16).flip(1)  # twr[i] = text[base*16+143-i]
        s_t = 144 - (p - (base_w << 4))  # in [1, 16]
        tc = twr.gather(1, s_t[:, None] + jj)
        # read window [q0, q0+CH) from the packed read words
        q0 = posf + m
        base_r = (q0 >> 4).clamp(0, rd.W16 - 1)
        rrows = (base_r[:, None] + wj).clamp(0, rd.W16 - 1)
        rwin = ((rd.rw[bf[:, None], rrows][:, :, None] >> r_sh) & 7)
        rc = rwin.reshape(V, NW * 16).gather(1, (q0 & 15)[:, None] + jj)
        in_rd = ((q0[:, None] + jj) < lens[:, None]) & (rc < 4)
        eq = (act[:, None] & in_rd
              & (jj < p.clamp(max=CH)[:, None])
              & (tc == 3 - rc)
              & ((m[:, None] + jj) < MAX_ANCHOR_LEN))
        all_eq = eq.all(1)
        first_ne = (~eq).to(torch.uint8).argmax(1)
        run = torch.where(all_eq, CH, first_ne)
        m = m + run
        p = p - run
        act = act & all_eq
    return m, p


def _staged_ext(arrs, meta, rd, alive, k, l, m, posf, bf, phase1_steps):
    """Run phase1_steps extension steps over the live lanes, resolve the
    occ==1 lanes by direct text comparison, compact to the lanes still
    alive, and repeat until none is.  Returns per-lane final (k, l, m)
    plus (rpos, rflag): the mirror-space position of the lanes the
    comparison resolved (their k/l predate the comparison tail).  Each
    call adds one to ``_staged_ext.entries``."""
    _staged_ext.entries += 1
    k, l, m = k.clone(), l.clone(), m.clone()
    rpos = torch.zeros_like(k)
    rflag = torch.zeros_like(alive)
    idx = alive.nonzero().squeeze(1)
    a = alive[idx]
    kk, ll, mm, pf, bf_ = k[idx], l[idx], m[idx], posf[idx], bf[idx]
    while idx.numel():
        a, kk, ll, mm = _ext_steps(arrs, meta, rd, a, kk, ll, mm, pf, bf_,
                                   phase1_steps)
        one = a & (kk == ll)
        oi = one.nonzero().squeeze(1)
        if oi.numel():
            m_f, p_f = _resolve_rounds(arrs, meta, rd, kk[oi], mm[oi],
                                       pf[oi], bf_[oi])
            mm[oi] = m_f
            rpos[idx[oi]] = p_f
            rflag[idx[oi]] = True
        k[idx], l[idx], m[idx] = kk, ll, mm
        keep = (a & ~one).nonzero().squeeze(1)
        idx, a = idx[keep], a[keep]
        kk, ll, mm, pf, bf_ = kk[keep], ll[keep], mm[keep], pf[keep], \
            bf_[keep]
    return k, l, m, rpos, rflag


_staged_ext.entries = 0


def _seed_anchors_impl(arrs, reads, read_lens, pos, meta, sampling_count,
                       min_anchor_len, max_ref_hits, max_seeds,
                       phase1_steps=24, group=None, plain=False):
    """Seeding for a padded read batch (JAX ``_seed_anchors_impl``).

    reads: (B, L) uint8 codes (4 = N/pad); read_lens: (B,) int32;
    pos: (B, S) int32 sample positions (sample_positions_host), all on
    the index's device.  Returns a SeedBatch with up to max_seeds slots
    per read across both strands.  group: the process group of a
    sharded index's stripes (this rank's rows of the batch; every rank
    passes the same B).  The staged extension runs in the seed_ext
    kernel on a CUDA device, in _staged_ext on the CPU or with ``plain``
    (the smoke's and the tests' comparison pass); with a sampled SA, the
    locate of the slots the extension did not resolve runs in the
    sa_locate kernel on a CUDA device, in sa_lookup on the CPU or with
    ``plain``.  Under a group the lockstep extension and walk run on
    seed_shard.cu's kernels on a CUDA device (fm_shard_cuda), in
    _shard_ext and _shard_walk on the CPU or with ``plain``."""
    dev = reads.device
    pdt = torch_pos_dtype(meta)
    B, L = reads.shape
    S = sampling_count
    kc = meta["kcache_k"]
    assert kc <= 17, "k-mer cache k must fit a 2-word read window"
    l_pac = meta["l_pac"]
    BS = B * S
    b_lane = torch.arange(BS, device=dev) // S  # flat lane -> read row
    rd = _Reads(reads, read_lens)
    pos = pos.long()
    read_lens = read_lens.long()

    # ---- k-mer cache lookup on revcomp(anchor[0:kc]) ----
    # cache index = sum_j comp(read[p+j]) * 4^(kc-1-j)  (encoding of
    # bwt_count_exact_cached, src/BWT.cpp:270-277); the kc chars come
    # out of the lane's 2-word packed window
    pos_f = pos.reshape(BS)
    w0 = pos_f.clamp(0, L - 1) >> 4
    lo0 = rd.rw[b_lane, w0]
    hi0 = rd.rw[b_lane, (w0 + 1).clamp(max=rd.W16 - 1)]
    jj = torch.arange(kc, device=dev)
    qj = pos_f[:, None] + jj  # (BS, kc)
    word = torch.where((qj >> 4) == w0[:, None], lo0[:, None], hi0[:, None])
    ch = (word >> (3 * (15 - (qj & 15)))) & 7
    ch = torch.where(qj < read_lens[b_lane][:, None], ch, 4)
    has_n = (ch >= 4).any(-1)
    comp = torch.where(ch < 4, 3 - ch, 0)
    ci = (comp * (4 ** (kc - 1 - jj))).sum(-1)  # (BS,)
    k0 = arrs["kcache_beg"][ci].long()
    l0 = arrs["kcache_end"][ci].long()
    alive0 = (~has_n) & (k0 <= l0) & (pos_f + kc <= read_lens[b_lane])

    # ---- staged lockstep greedy extension ----
    m0 = torch.full((BS,), kc, dtype=torch.int64, device=dev)
    if group is None and dev.type == "cuda" and not plain:
        from .fm_index_cuda import seed_ext

        kf, lf, mf, rposf, rflagf = seed_ext(
            arrs, meta, rd, alive0, k0, l0, m0, pos_f, b_lane, phase1_steps)
    elif group is None:
        kf, lf, mf, rposf, rflagf = _staged_ext(
            arrs, meta, rd, alive0, k0, l0, m0, pos_f, b_lane, phase1_steps
        )
    else:
        shard_counts["calls"] += 1
        kernels = dev.type == "cuda" and not plain
        if kernels:
            from . import fm_shard_cuda
        ext = fm_shard_cuda.shard_ext if kernels else _shard_ext
        kf, lf, mf = ext(arrs, meta, rd, alive0, k0, l0, m0, pos_f, b_lane,
                         group)
        rposf = torch.zeros_like(kf)
        rflagf = torch.zeros_like(alive0)
    kf, lf, mf = kf.view(B, S), lf.view(B, S), mf.view(B, S)
    rposf, rflagf = rposf.view(B, S), rflagf.view(B, S)

    occ_cnt = torch.where(alive0.view(B, S) & (kf <= lf), lf - kf + 1, 0)

    # ---- acceptance: occ in (0, max_ref_hits), length >= min, not
    # contained (sequential last_pos scan, src/BWT.cpp:345,386): an
    # anchor is accepted iff its end exceeds the running max end of the
    # passing anchors before it (an exclusive cummax) ----
    base_ok = ((occ_cnt > 0) & (occ_cnt < max_ref_hits)
               & (mf >= min_anchor_len))
    ends = torch.where(base_ok, pos + mf, 0)
    prev_max = torch.cat(
        [torch.zeros((B, 1), dtype=ends.dtype, device=dev),
         torch.cummax(ends, dim=1).values[:, :-1]], dim=1,
    )
    accept = base_ok & ((pos + mf) > prev_max)

    # ---- locate: flatten accepted intervals into <= max_seeds slots ----
    occ_acc = torch.where(accept, occ_cnt, 0)
    starts = torch.cumsum(occ_acc, dim=1) - occ_acc  # exclusive prefix
    total = occ_acc.sum(dim=1)  # (B,)
    MS = max_seeds
    slot = torch.arange(MS, device=dev)
    # owner anchor of slot t = the last accepted anchor s with
    # starts[s] <= t: scatter s at starts[s] (index MS = dropped), then a
    # running max
    has_occ = accept & (occ_acc > 0)
    tgt = torch.where(has_occ & (starts < MS), starts, MS)
    scat = torch.full((B, MS + 1), -1, dtype=torch.int64, device=dev)
    scat.scatter_reduce_(
        1, tgt, torch.arange(S, device=dev).expand(B, S), reduce="amax",
        include_self=True,
    )
    sidx = torch.cummax(scat[:, :MS], dim=1).values.clamp(0, S - 1)
    slot_valid = slot[None, :] < total[:, None]
    row = kf.gather(1, sidx) + (slot - starts.gather(1, sidx))
    row = torch.where(slot_valid, row, 0)

    # lanes resolved by the occ==1 path carry their located position;
    # only the rest walk the SA, compacted to the slots that need it
    res_f = rflagf.gather(1, sidx)
    walk = (slot_valid & ~res_f).reshape(-1)
    if group is None:
        sel = walk.nonzero().squeeze(1)
        p_occ = torch.zeros(B * MS, dtype=torch.int64, device=dev)
        rows_sel = row.reshape(-1)[sel]
        if meta["sa_intv"] > 1 and dev.type == "cuda" and not plain:
            from .fm_index_cuda import sa_locate

            p_occ[sel] = sa_locate(arrs, meta, rows_sel, walk[sel])
        else:
            p_occ[sel] = sa_lookup(arrs, meta, rows_sel, walk[sel])
    elif kernels:
        p_occ = _shard_locate(arrs, meta, row.reshape(-1), walk, group,
                              fm_shard_cuda.shard_walk,
                              fm_shard_cuda.sa_gather)
    else:
        p_occ = sa_lookup(arrs, meta, row.reshape(-1), walk, group)
    p_occ = torch.where(res_f, rposf.gather(1, sidx), p_occ.view(B, MS))

    # ---- mirror back to the reference's seed coordinates ----
    m_s = mf.gather(1, sidx)
    p_s = pos.gather(1, sidx)
    p_P = 2 * l_pac - p_occ - m_s  # occurrence of the anchor
    is_fwd = p_P < l_pac
    t_pos = torch.where(is_fwd, p_P, p_occ)
    q_pos = torch.where(is_fwd, p_s, read_lens[:, None] - p_s - m_s)

    return SeedBatch(
        t_pos=torch.where(slot_valid, t_pos, 0).to(pdt),
        q_pos=torch.where(slot_valid, q_pos, 0).to(torch.int32),
        length=torch.where(slot_valid, m_s, 0).to(torch.int32),
        is_rev=slot_valid & ~is_fwd,
        valid=slot_valid,
        n_total=total.to(torch.int32),
        n_anchors=accept.sum(dim=1).to(torch.int32),
    )


def seed_anchors(arrs, meta, reads, read_lens, cfg):
    """Run the seeding stage for a padded read batch.

    reads: (B, L) uint8 codes 0..4 (4 = N / pad); read_lens: (B,) int32,
    numpy or tensors; moved to the index's device.  Returns a SeedBatch
    with up to cfg.max_seeds_per_read seeds per read across both
    strands."""
    dev = arrs["L2"].device
    pos = sample_positions_host(np.asarray(read_lens), cfg.sampling_count)
    return _seed_anchors_impl(
        arrs,
        torch.as_tensor(np.asarray(reads), device=dev),
        torch.as_tensor(np.asarray(read_lens, dtype=np.int32), device=dev),
        torch.from_numpy(pos).to(dev),
        meta,
        cfg.sampling_count,
        cfg.min_anchor_len,
        cfg.max_ref_hits,
        cfg.max_seeds_per_read,
        cfg.seed_phase1_steps,
    )
