"""The sharded index's seeding loops on the card: the hand-written kernels
of ``csrc/seed_shard.cu``, their wrappers and the loops that drive them.

Under a sharded index (parallel/sharded_index.py) the seeder's lockstep
extension and its locate walk route every rank-row lookup to the rank
that owns the row.  ``shard_ext`` and ``shard_walk`` run them as the JAX
package compiles them (``lordfast_tpu/ops/fm_index.py`` ``ext_loop_flat``
:485 and ``sa_lookup``'s walk :281, through ``_row_gather_routed`` :76),
in fm_index's block schedule (``_shard_blocks``: SHARD_BLOCK_STEPS steps
a block, one all_reduce and one host read a block, an overflowed block
run again through the all-gather route) and its routing protocol
(``exchange``, ``exact_gather``: the collectives, the caps and the
fallback, which the plain steps there use too).  A step is:

- ``shard_bucket``: each live lane's queries to its owner's bucket of the
  (D, cap) send buffer, in query order (or, on the all-gather route, to
  its own slot): one launch, no memset;
- ``all_to_all_single`` of the row ids, equal splits (all-gather route:
  ``all_gather_into_tensor``);
- ``shard_answer``: the received rows answered from this rank's stripe
  (on the routed route the empty slots are left unwritten: no step reads
  them);
- ``all_to_all_single`` of the rows back (``reduce_scatter_tensor``, SUM);
- ``shard_ext_step`` or ``shard_walk_step``: the lanes' step from the
  rows their queries got back, in place: a block's first step over
  every lane's flag, each later one over the compacted list of the
  lanes the step before kept alive (``LaneList``), with a grid sized to
  the group's live lanes at the block's start.

``sa_gather`` is the locate's one exact gather of sampled SA entries a
call (and a full SA's locate) on the same bucket and answer kernels.
This module supplies only the launches (``_kernel_steps``).

Each wrapper launches its kernel on a CUDA tensor (counted in its
``launches``) and raises if the launch fails; on a CPU tensor it runs its
plain version (``*_plain`` here), which the smoke and the tests hold the
kernel to.  There is no fallback from the first to the second.  The plain
loops over the same block schedule are fm_index ``_shard_ext`` and
``_shard_walk``; on a CUDA device they run only under ``plain_loops``.
Build: ``cuda_build`` (nvcc at first use, ctypes).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import torch

from . import cuda_build
from . import fm_index as fm
from .cuda_build import check_tensor

# the values of a rank row: the counts of A, C, G, T, then 8 BWT words
ROW = 12
# shard_bucket_kernel's tile of queries a scan block (seed_shard.cu kTile)
# and the most owners it routes to (kMaxOwners)
BUCKET_TILE = 2048
MAX_OWNERS = 256
# the step kernels' threads a block, a lane a thread (kThreads)
STEP_THREADS = 256


# the library's C functions by name, their types set once: a sharded
# step is host time, so a launch looks nothing up
_fns = {}


def _fn(name, argtypes):
    f = _fns.get(name)
    if f is None:
        f = getattr(cuda_build.load("seed_shard"), name)
        f.restype = ctypes.c_int
        f.argtypes = argtypes
        _fns[name] = f
    return f


_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def _cuda_device(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device


def rank_stripes(arrs):
    """(fused, rank_a, rank_b) of this rank's rank-row stripes: fm_blocks
    (rps, 12), or occ_cp (rps, 4) with bwt_blocks (rps, 8), int64; the
    pair must have the same rows, so a block has one owner in both."""
    if "fm_blocks" in arrs:
        return True, arrs["fm_blocks"], None
    cp, bb = arrs["occ_cp"], arrs["bwt_blocks"]
    if cp.shape[0] != bb.shape[0]:
        raise ValueError(f"occ_cp's stripe has {cp.shape[0]} rows, "
                         f"bwt_blocks's {bb.shape[0]}")
    return False, cp, bb


class LaneList(NamedTuple):
    """One step's view of a sharded loop's compacted list of live lanes
    (csrc/seed_shard.cu, the steps' design): ``lists`` (2, n) int32 and
    ``ring`` (3,) int32 (zeros when made), kept on the lanes' device over
    the loop (lane_list); ``step``: the step's index g in the loop,
    counted over its blocks; ``first``: the block's first step, which
    runs over every lane's flag (else over the list the step before
    wrote: a lane it kept alive, or -1 for one that died); ``n_live``:
    the group's most live lanes at the block's start, which sizes a list
    step's grid.  Step g writes lists[g % 2], its slots reserved on
    ring[g % 3], reads lists[(g - 1) % 2] and its count ring[(g - 1) % 3]
    and zeroes ring[(g + 1) % 3]."""

    lists: torch.Tensor
    ring: torch.Tensor
    step: int
    first: bool
    n_live: int


def lane_list(n, device):
    """A loop's (lists, ring) for LaneList: made once, outside any
    block."""
    return (torch.empty((2, n), dtype=torch.int32, device=device),
            torch.zeros(3, dtype=torch.int32, device=device))


def lane_ring(lanes):
    """(list_in, n_in, list_out, n_out, zero) of one step, views of its
    LaneList's tensors (see LaneList): the list it runs over and its
    count (None on a block's first step), the list it writes and the
    count its slots are reserved on, the count it zeroes."""
    g = lanes.step
    first = lanes.first
    return (None if first else lanes.lists[(g - 1) % 2],
            None if first else lanes.ring[(g - 1) % 3: (g - 1) % 3 + 1],
            lanes.lists[g % 2], lanes.ring[g % 3: g % 3 + 1],
            lanes.ring[(g + 1) % 3: (g + 1) % 3 + 1])


def grid_lanes(n, lanes):
    """The lanes a step's grid covers, a thread each: every lane on a
    block's first step, else the group's live lanes at the block's start
    (at least 1, at most n)."""
    if lanes.first:
        return n
    return min(max(lanes.n_live, 1), n)


# ---- the plain versions (the CPU path; the smoke's reference) ----

def _query_blocks(live, k, l, meta, ids=False):
    """(the rank-row block of each query (Q,) int64, whether it is asked
    (Q,) bool) of a step: an extension's rows k - 1 then l of every lane
    (occ's clamp and primary shift), a walk's row of x = k - (k >
    primary); a dead lane and the walk's primary row ask for nothing.
    With ids: the rows k themselves, where live."""
    if ids:
        return k, live
    seq_len, primary = meta["seq_len"], meta["primary"]
    if l is not None:
        kq = torch.cat([k - 1, l])
        kk = kq.clamp(0, seq_len - 1)
        return (kk - (kk >= primary).long()) >> 7, torch.cat([live, live])
    return (k - (k > primary).long()) >> 7, live & (k != primary)


def shard_bucket_plain(live, k, l, meta, rps, D, cap, send, slot, counts,
                       over, ids=False):
    """shard_bucket's plain version: the queries take their bucket's
    slots in query order (fm_index.bucket), as the kernel's scan does."""
    blk, ask = _query_blocks(live, k, l, meta, ids)
    if cap is None:
        send.copy_(torch.where(ask, blk, -1))
        slot.copy_(torch.arange(blk.numel(), device=blk.device))
        return
    s, sent, n = fm.bucket(blk, ask, rps, D, cap)
    send.copy_(sent)
    slot.copy_(s)
    counts.copy_(n)
    over.copy_(torch.maximum(over, (n > cap).any().to(over.dtype)))


def shard_answer_plain(recv, arrs, base, out, key=None, routed=False):
    """shard_answer's plain version: zeros in every slot this rank does
    not own, on either route (``routed`` is the kernel's)."""
    if key is not None:
        out.copy_(fm._answer(arrs[key], recv, base))
        return
    fused, rank_a, rank_b = rank_stripes(arrs)
    if fused:
        out.copy_(fm._answer(rank_a, recv, base))
    else:
        out.copy_(torch.cat([fm._answer(rank_a, recv, base),
                             fm._answer(rank_b, recv, base)], 1))


def _append_plain(alive, kept, lanes, live):
    """The plain steps' list and counts: the lanes kept alive (a mask) in
    lane order, then -1 for each lane that died (alive before the step,
    not kept), into the list a step writes, the lanes alive before it
    added to the count its slots are reserved on, the count it zeroes
    zeroed (lane_ring), and the kept lanes added to live."""
    _, _, list_out, n_out, zero = lane_ring(lanes)
    idx = kept.nonzero()[:, 0]
    n_alive = int(alive.sum())
    list_out[: idx.numel()] = idx.to(list_out.dtype)
    list_out[idx.numel(): n_alive] = -1
    n_out.add_(n_alive)
    zero.zero_()
    if live is not None:
        live.add_(kept.sum().to(live.dtype))


def shard_ext_step_plain(state, pos_f, b_lane, rd, arrs, meta, back, slot,
                         live=None, *, lanes):
    """shard_ext_step's plain version (fm_index._ext_step's arithmetic,
    from the rows returned by slot), over every alive lane whatever the
    list holds: the oracle of a list step too."""
    n = state[0].numel()
    alive = state[0].clone()
    ok_char, cc = fm.next_char(rd, b_lane, pos_f, state[3])
    occs = []
    for kq, rows in ((state[1] - 1, fm.by_slot(back, slot[:n])),
                     (state[2], fm.by_slot(back, slot[n:]))):
        base = rows[:, :4].gather(1, cc[:, None])[:, 0]
        occs.append(fm.occ_from_rows(arrs, meta, kq, cc, base, rows[:, 4:]))
    L2c = arrs["L2"].long()[cc]
    new = fm.advance(*state, ok_char, L2c + occs[0] + 1, L2c + occs[1])
    for x, v in zip(state, new):
        x.copy_(v)
    _append_plain(alive, new[0], lanes, live)


def shard_walk_step_plain(state, arrs, meta, back, slot, live=None, *,
                          lanes):
    """shard_walk_step's plain version (fm_index._walk_step's arithmetic,
    the char from the word of x's own rank row), over every active row
    whatever the list holds."""
    active, rows, steps = state
    primary = meta["primary"]
    x = rows - (rows > primary).long()
    row = fm.by_slot(back, slot)
    w = row[:, 4:].gather(1, ((x & 127) >> 4)[:, None])[:, 0]
    ch = (w >> (((x ^ -1) & 15) << 1)) & 3
    base = row[:, :4].gather(1, ch[:, None])[:, 0]
    nxt = arrs["L2"].long()[ch] + fm.occ_from_rows(arrs, meta, rows, ch,
                                                   base, row[:, 4:])
    nxt = torch.where(rows == primary, 0, nxt)
    a = active.clone()
    rows.copy_(torch.where(a, nxt, rows))
    steps.add_(a.long())
    active.copy_(a & ((rows & (meta["sa_intv"] - 1)) != 0))
    _append_plain(a, active, lanes, live)


# ---- the wrappers ----

# device -> (status (words,) int64, ticket (1,) int32): the bucket
# kernel's look-back words and ticket counter, zeroed once when made
_scratch = {}
_epoch = 0


def _lookback(dev, words):
    """The bucket kernel's scratch on ``dev`` with at least ``words``
    look-back words (made anew, twice as large, when it is too small: an
    epoch never read as 0 marks its words unpublished)."""
    s = _scratch.get(dev)
    if s is None or s[0].numel() < words:
        s = (torch.zeros(max(2 * words, 4096), dtype=torch.int64,
                         device=dev),
             torch.zeros(1, dtype=torch.int32, device=dev))
        _scratch[dev] = s
    return s


def _next_epoch():
    """The next call's epoch: 1 to 2**32 - 1, then 1 again."""
    global _epoch
    _epoch = _epoch % 0xFFFFFFFF + 1
    return _epoch


def shard_bucket(live, k, l, meta, rps, D, cap, send, slot, counts=None,
                 over=None, ids=False):
    """The bucket step of n lanes: live (n,) bool, k (n,) int64 and, for
    an extension, l (n,) int64 (2 n queries: k - 1, then l) or None for a
    walk (n queries); with ``ids`` (l and meta None) the n queries are
    the row ids k themselves.  Routed (cap an int, D <= MAX_OWNERS): send
    (D cap,) int64 gets the row ids in query order (-1 in the empty
    slots), slot (Q,) int32 each query's slot or -1, counts (D,) int32
    each owner's asked queries, and over (1,) int32 is raised to 1 when a
    bucket overflowed: fm_index.bucket's values, bit for bit, from one
    launch.  All-gather route (cap None): send (Q,) gets each query's row
    id or -1, slot its index.  rps: the stripes' rows a rank; D: the
    ranks.  The routed kernel's look-back scratch is kept a device
    (_lookback); calls on one device run in stream order."""
    n = live.shape[0]
    Q = 2 * n if l is not None else n
    routed = cap is not None
    if live.device.type == "cpu":
        return shard_bucket_plain(live, k, l, meta, rps, D, cap, send, slot,
                                  counts, over, ids)
    if ids and l is not None:
        raise ValueError("shard_bucket: row ids take no l")
    if routed and D > MAX_OWNERS:
        raise ValueError(f"shard_bucket: {D} owners, at most {MAX_OWNERS}")
    dev = _cuda_device("shard_bucket", live)
    check_tensor("live", live, torch.bool, (n,), dev)
    check_tensor("k", k, torch.int64, (n,), dev)
    if l is not None:
        check_tensor("l", l, torch.int64, (n,), dev)
    check_tensor("send", send, torch.int64, (D * cap if routed else Q,), dev)
    check_tensor("slot", slot, torch.int32, (Q,), dev)
    status = ticket = None
    words, epoch = 0, 0
    if routed:
        check_tensor("counts", counts, torch.int32, (D,), dev)
        check_tensor("over", over, torch.int32, (1,), dev)
        words = D * max(-(-Q // BUCKET_TILE), 1)
        status, ticket = _lookback(dev, words)
        epoch = _next_epoch()
    with torch.cuda.device(dev):
        rc = _fn("lf_shard_bucket", [_VP] * 9 + [_CL] * 6 + [_CI] * 3
                 + [ctypes.c_uint, _VP])(
            live.data_ptr(), k.data_ptr(), _ptr(l), send.data_ptr(),
            slot.data_ptr(), _ptr(counts if routed else None),
            _ptr(over if routed else None), _ptr(status), _ptr(ticket),
            words, n, 0 if ids else meta["seq_len"],
            0 if ids else meta["primary"], rps, cap if routed else 0, D,
            int(not routed), int(ids), epoch, _stream(dev))
    _check_launch("shard_bucket", rc)
    shard_bucket.launches += 1


shard_bucket.launches = 0


def shard_answer(recv, arrs, base, out, key=None, routed=False):
    """The answer step: recv (n,) int64 row ids (-1 for none); this rank's
    rank stripes (rank_stripes) with their first global row base; out (n,
    12) int64 gets each owned row's counts and words, zeros for the rest.
    With ``key`` ("sa_samp"): the entries of that 1-D stripe (int32 or
    int64) into out (n,) int64, 0 for the rest.  ``routed`` (the routed
    route): a slot whose id is -1 is left as it is, since no query took
    it (seed_shard.cu says why no step reads it); on the all-gather route
    every slot this rank does not own gets zeros, which the
    reduce_scatter's SUM needs.  The plain version writes zeros on
    both."""
    if recv.device.type == "cpu":
        return shard_answer_plain(recv, arrs, base, out, key, routed)
    dev = _cuda_device("shard_answer", recv)
    n = recv.shape[0]
    check_tensor("recv", recv, torch.int64, (n,), dev)
    if key is not None:
        st = arrs[key]
        if st.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"shard_answer: {key} dtype {st.dtype}")
        check_tensor(key, st, st.dtype, (st.shape[0],), dev)
        check_tensor("out", out, torch.int64, (n,), dev)
        _launch_answer(dev, recv, st, None, out, n, st.shape[0], base, 0, 1,
                       st.element_size(), routed)
        return
    fused, rank_a, rank_b = rank_stripes(arrs)
    check_tensor("out", out, torch.int64, (n, ROW), dev)
    check_tensor("rank_a", rank_a, torch.int64,
                 (rank_a.shape[0], ROW if fused else 4), dev)
    if not fused:
        check_tensor("rank_b", rank_b, torch.int64, (rank_a.shape[0], 8),
                     dev)
    for name, x in (("rank_a", rank_a), ("rank_b", rank_b), ("out", out)):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"shard_answer: {name} is not 16-byte aligned")
    _launch_answer(dev, recv, rank_a, rank_b, out, n, rank_a.shape[0], base,
                   int(fused), ROW, 8, routed)


def _launch_answer(dev, recv, rank_a, rank_b, out, n, rps, base, fused,
                   width, elem_bytes, routed):
    with torch.cuda.device(dev):
        rc = _fn("lf_shard_answer", [_VP] * 4 + [_CL] * 3 + [_CI] * 4
                 + [_VP])(
            recv.data_ptr(), rank_a.data_ptr(), _ptr(rank_b),
            out.data_ptr(), n, rps, base, fused, width, elem_bytes,
            int(routed), _stream(dev))
    _check_launch("shard_answer", rc)
    shard_answer.launches += 1


shard_answer.launches = 0


def _check_step(name, back, slot, Q, dev):
    check_tensor("back", back, torch.int64, (back.shape[0], ROW), dev)
    check_tensor("slot", slot, torch.int32, (Q,), dev)
    if back.data_ptr() % 16:
        raise ValueError(f"{name}: back is not 16-byte aligned")


def _l2(arrs, dev):
    l2 = arrs["L2"]
    if l2.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"L2 dtype {l2.dtype}, expected int32 or int64")
    check_tensor("L2", l2, l2.dtype, (5,), dev)
    return l2


def _check_lanes(name, n, lanes, dev):
    check_tensor("lists", lanes.lists, torch.int32, (2, n), dev)
    check_tensor("ring", lanes.ring, torch.int32, (3,), dev)
    if n > 2**30:
        raise ValueError(f"{name}: {n} lanes, at most 2^30 (int32 lists "
                         "and indexes)")


def _lanes_ptrs(n, lanes, lists, ring, live):
    """The list and count pointers of one step in the kernels' order
    (list_in, n_in, list_out, n_out, live, zero: lane_ring's views' and
    live's, from the pointers of lanes.lists and lanes.ring) and the
    lanes its grid covers (grid_lanes)."""
    g = lanes.step
    if lanes.first:
        list_in = n_in = None
    else:
        list_in, n_in = lists + 4 * n * ((g - 1) % 2), ring + 4 * ((g - 1) % 3)
    return ([list_in, n_in, lists + 4 * n * (g % 2), ring + 4 * (g % 3),
             _ptr(live), ring + 4 * ((g + 1) % 3)], grid_lanes(n, lanes))


# each step wrapper's last call: weak references to its tensors, its
# sizes and the tensors' pointers.  A loop passes the same lane state,
# reads, buffers and lane lists every step, so they are checked on its
# first step and then matched by identity and pointer.
_last = {}


def _checked(name, tensors, sizes, check):
    """The data pointers of ``tensors``, after ``check()`` (which raises
    on any the kernel does not take) unless they are the very tensors,
    at the same pointers and sizes, of wrapper name's last call."""
    ptrs = [t.data_ptr() for t in tensors]
    last = _last.get(name)
    if (last is None or last[1] != sizes or last[2] != ptrs
            or any(r() is not t for r, t in zip(last[0], tensors))):
        check()
        _last[name] = ([weakref.ref(t) for t in tensors], sizes, ptrs)
    return ptrs


_EXT_ARGS = [_VP] * 17 + [_CL] * 4 + [_CI] * 3 + [_VP]
_WALK_ARGS = [_VP] * 12 + [_CL] * 4 + [_CI] * 2 + [_VP]


def shard_ext_step(state, pos_f, b_lane, rd, arrs, meta, back, slot,
                   live=None, *, lanes):
    """One extension step of n lanes in place: state [alive (n,) bool, k,
    l, m (n,) int64]; pos_f, b_lane (n,) int64; rd the read batch
    (fm_index._Reads); back (slots, 12) int64 and slot (2 n,) int32 from
    the bucket step; live (1,) int32 or None: the lanes alive after the
    step are added to it; lanes: the step's LaneList (a block's first
    step runs over every lane's flag; a list step's entries must each be
    a live lane, once, or -1: the step before wrote them)."""
    alive, k, l, m = state
    if alive.device.type == "cpu":
        return shard_ext_step_plain(state, pos_f, b_lane, rd, arrs, meta,
                                    back, slot, live, lanes=lanes)
    n = alive.shape[0]
    B, W16 = rd.rw.shape
    l2 = arrs["L2"]
    tensors = (alive, k, l, m, pos_f, b_lane, rd.rw, rd.lens, l2, back,
               slot, lanes.lists, lanes.ring)

    def check():
        dev = _cuda_device("shard_ext_step", alive)
        check_tensor("alive", alive, torch.bool, (n,), dev)
        for name, x in (("k", k), ("l", l), ("m", m), ("pos_f", pos_f),
                        ("b_lane", b_lane)):
            check_tensor(name, x, torch.int64, (n,), dev)
        check_tensor("rw", rd.rw, torch.int64, (B, W16), dev)
        check_tensor("lens", rd.lens, torch.int64, (B,), dev)
        _check_step("shard_ext_step", back, slot, 2 * n, dev)
        _l2(arrs, dev)
        _check_lanes("shard_ext_step", n, lanes, dev)

    ptrs = _checked("shard_ext_step", tensors, (n, B, W16, back.shape[0]),
                    check)
    dev = alive.device
    if live is not None:
        check_tensor("live", live, torch.int32, (1,), dev)
    lane_ptrs, n_grid = _lanes_ptrs(n, lanes, ptrs[11], ptrs[12], live)
    with torch.cuda.device(dev):
        rc = _fn("lf_shard_ext_step", _EXT_ARGS)(
            *ptrs[:11], *lane_ptrs, n, n_grid, meta["seq_len"],
            meta["primary"], rd.L, W16, l2.element_size(), _stream(dev))
    _check_launch("shard_ext_step", rc)
    shard_ext_step.launches += 1


shard_ext_step.launches = 0


def shard_walk_step(state, arrs, meta, back, slot, live=None, *, lanes):
    """One walk step of n rows in place: state [active (n,) bool, rows,
    steps (n,) int64]; back and slot (n,) int32 from the bucket step;
    live and lanes as shard_ext_step's.  The index's sa_intv is a power
    of two above 1."""
    active, rows, steps = state
    if active.device.type == "cpu":
        return shard_walk_step_plain(state, arrs, meta, back, slot, live,
                                     lanes=lanes)
    n = active.shape[0]
    l2 = arrs["L2"]
    tensors = (active, rows, steps, l2, back, slot, lanes.lists, lanes.ring)

    def check():
        dev = _cuda_device("shard_walk_step", active)
        check_tensor("active", active, torch.bool, (n,), dev)
        check_tensor("rows", rows, torch.int64, (n,), dev)
        check_tensor("steps", steps, torch.int64, (n,), dev)
        _check_step("shard_walk_step", back, slot, n, dev)
        _l2(arrs, dev)
        _check_lanes("shard_walk_step", n, lanes, dev)

    ptrs = _checked("shard_walk_step", tensors, (n, back.shape[0]), check)
    dev = active.device
    if live is not None:
        check_tensor("live", live, torch.int32, (1,), dev)
    lane_ptrs, n_grid = _lanes_ptrs(n, lanes, ptrs[6], ptrs[7], live)
    with torch.cuda.device(dev):
        rc = _fn("lf_shard_walk_step", _WALK_ARGS)(
            *ptrs[:6], *lane_ptrs, n, n_grid, meta["seq_len"],
            meta["primary"], meta["sa_intv"], l2.element_size(),
            _stream(dev))
    _check_launch("shard_walk_step", rc)
    shard_walk_step.launches += 1


shard_walk_step.launches = 0


def noop(n_grid, dev):
    """One empty launch of a step's grid over n_grid lanes (a step's
    latency floor starts from its back-to-back time); not counted."""
    with torch.cuda.device(dev):
        rc = _fn("lf_shard_noop", [_CL, _VP])(n_grid, _stream(dev))
    _check_launch("shard_noop", rc)


# ---- the loops ----

def _kernel_steps(arrs, meta, live, k, l, group, key=None, bufs=None):
    """fm_index.exchange's bucket_fn and answer_fn on the kernels, for one
    step's queries: n lanes' (live, k, l) as shard_bucket takes them
    (key None), or with key "sa_samp" the row ids k where live, answered
    from the sa_samp stripe; their buffers from fm_index._empty (bufs).
    answer_fn answers on the route bucket_fn last took (exchange calls
    them in turn), so on the routed route it leaves the empty slots
    unwritten.  The wrappers are looked up at call time."""
    from . import fm_shard_cuda as K

    D, d, dev = group.size(), group.rank(), live.device
    st = arrs[key] if key else rank_stripes(arrs)[1]
    rps, n = st.shape[0], live.shape[0]
    Q = 2 * n if l is not None else n
    i32, i64 = torch.int32, torch.int64
    ids = key is not None

    routed = []  # the route bucket_fn took: exchange answers it next

    def bucket_fn(cap, over):
        routed[:] = [cap is not None]
        slot = fm._empty(bufs, "slot", (Q,), i32, dev)
        if cap is None:
            send = fm._empty(bufs, "send", (Q,), i64, dev)
            K.shard_bucket(live, k, l, meta, rps, D, None, send, slot,
                           ids=ids)
        else:
            send = fm._empty(bufs, "send", (D * cap,), i64, dev)
            K.shard_bucket(live, k, l, meta, rps, D, cap, send, slot,
                           fm._empty(bufs, "counts", (D,), i32, dev), over,
                           ids=ids)
        return send, slot

    def answer_fn(recv):
        out = fm._empty(bufs, "vals", (recv.numel(),) + (
            () if ids else (ROW,)), i64, dev)
        K.shard_answer(recv, arrs, d * rps, out, routed=routed[0],
                       **({"key": key} if ids else {}))
        return out

    return bucket_fn, answer_fn


def _route_rows(arrs, meta, live, k, l, route, bufs):
    """One step's lookups through route (fm_index.ShardRoute): the lanes'
    queries bucketed (shard_bucket), sent to their owners, answered
    (shard_answer) and sent back (fm_index.exchange), in the loop's
    buffers ``bufs``.  Returns (back (slots, 12) int64, slot (Q,)
    int32): query i's row is back[slot[i]]."""
    return fm.exchange(route.group, *_kernel_steps(
        arrs, meta, live, k, l, route.group, bufs=bufs), route.cap,
        route.flags[1:], bufs=bufs)


def _list_steps(live0, launch):
    """_shard_blocks' step of a loop on the kernels over a compacted list
    of live lanes: ``launch(state, route, live, lanes)`` runs one step
    (the bucket, the answer and the step kernel, given its LaneList, and
    on a block's last step route.flags[:1] as live); the loop's lists and
    counter ring are made here, once, on live0's device."""
    lists, ring = lane_list(live0.shape[0], live0.device)
    g = 0

    def step(st, route, first, last):
        nonlocal g
        launch(st, route, route.flags[:1] if last else None,
               LaneList(lists, ring, g, first, route.n_live))
        g += 1
        return st

    return step


def shard_ext(arrs, meta, rd, alive, k, l, m, pos_f, b_lane, group):
    """fm_index._shard_ext on the kernels: the lockstep extension of every
    lane over a sharded index until no lane of any rank is alive, in
    _shard_blocks' blocks; a step is shard_bucket, shard_answer and
    shard_ext_step between the collectives.  The same arguments and
    results: (k, l, m) of each lane, int64."""
    from . import fm_shard_cuda as K

    bufs = {}

    def launch(st, route, live, lanes):
        back, slot = _route_rows(arrs, meta, st[0], st[1], st[2], route,
                                 bufs)
        K.shard_ext_step(st, pos_f, b_lane, rd, arrs, meta, back, slot,
                         live, lanes=lanes)

    state = [alive.clone(), k.clone(), l.clone(), m.clone()]
    # a step stacks each lane's two rank queries (k - 1 and l)
    _, k, l, m = fm._shard_blocks(_list_steps(alive, launch), state, group,
                                  2)
    return k, l, m


def shard_walk(arrs, meta, rows, active, group):
    """fm_index._shard_walk on the kernels: each active row's walk to a
    sampled row over a sharded index until no row of any rank is active,
    in _shard_blocks' blocks; a step is shard_bucket, shard_answer and
    shard_walk_step between the collectives.  The same arguments and
    results: (rows, steps) of each row, int64."""
    from . import fm_shard_cuda as K

    intv = meta["sa_intv"]
    if intv < 2 or intv & (intv - 1):
        raise ValueError(f"shard_walk: sa_intv {intv} is not a power of "
                         "two above 1")

    bufs = {}

    def launch(st, route, live, lanes):
        back, slot = _route_rows(arrs, meta, st[0], st[1], None, route,
                                 bufs)
        K.shard_walk_step(st, arrs, meta, back, slot, live, lanes=lanes)

    state = [active.clone(), rows.clone(), torch.zeros_like(rows)]
    _, rows, steps = fm._shard_blocks(_list_steps(active, launch), state,
                                      group, 1)
    return rows, steps


def sa_gather(arrs, rows, valid, group):
    """The sampled SA entries of rows (n,) int64 where valid (n,) bool is
    set, 0 elsewhere, as int64, from the sa_samp stripes of a sharded
    index: fm_index._row_gather's exact gather (fm_index.exact_gather)
    on the kernels: shard_bucket on the row ids, shard_answer on the
    sa_samp stripe."""
    back, slot = fm.exact_gather(group, rows.shape[0], rows.device,
                                 *_kernel_steps(arrs, None, valid, rows,
                                                None, group, "sa_samp"))
    return fm.by_slot(back, slot)
