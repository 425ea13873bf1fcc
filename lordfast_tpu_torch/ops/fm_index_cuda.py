"""The hand-written CUDA seeding kernels and their wrappers.

``seed_ext`` runs the seeder's staged greedy extension of every lane (a
read times a sample position) with its occ == 1 finish in one launch of
``csrc/seed_ext.cu``, built for sm_90a: one thread per lane, the loop in
registers, each step one round trip (the rank rows of both queries as
16-byte loads, issued together), the finish comparing 16 text chars a
round trip against the reads' 3-bit words (``fm_index._Reads.rw``).  On
a CUDA tensor it launches the kernel and raises if the launch fails; on
a CPU tensor it runs the plain version (``fm_index._staged_ext``).
There is no fallback from the first to the second.  A replicated index
only: a sharded index's lockstep extension and walk make collective
calls between steps, so each step is launches of ``csrc/seed_shard.cu``
between the collectives (``fm_shard_cuda``); both sources count occ and
step the walk through ``csrc/fm_rank.cuh``.

The kernel replaces the JAX package's device loops of
``lordfast_tpu/ops/fm_index.py`` ``_seed_anchors_impl`` (:387):
``ext_loop_flat`` (:485, ``lax.while_loop`` :492), ``_resolve_rounds``
(:497, :568) and ``staged_ext`` (:602); see the source for its design
and what bounds it.

``sa_locate`` walks a batch of rows to their sampled SA rows (the
locate of the seeder's multi-hit slots with a sampled SA) in one launch
of the same library's ``sa_locate_kernel``: a persistent grid whose
lanes take rows from a queue (a device counter, zeroed on the stream in
the launch) as their walks end, each walk step one load of one array
(the row's rank row, whose word holds its char); it replaces the JAX
package's ``sa_lookup`` (:267, ``lax.while_loop`` :303).  Its plain
version is ``fm_index.sa_lookup``.  Both kernels step through one device
function, so their walks cannot drift.  Build: ``cuda_build`` (nvcc at
first use, ctypes).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import check_tensor
from .fm_index import _staged_ext, sa_lookup


def _fn():
    f = cuda_build.load("seed_ext").lf_seed_ext
    if f.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.restype = ci
        f.argtypes = ([vp] * 20 + [cl] * 3 + [cl, ci, ci, ci, cl, cl, cl,
                                               cl, ci, ci, ci] + [vp])
    return f


def _locate_fn():
    f = cuda_build.load("seed_ext").lf_sa_locate
    if f.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.restype = ci
        f.argtypes = [vp] * 11 + [cl] * 5 + [ci] * 3 + [vp]
    return f


def _check_aligned(name, x):
    """The kernel reads rank rows as 16-byte loads."""
    if x.data_ptr() % 16:
        raise ValueError(f"seed_ext: {name} is not 16-byte aligned")


def _rank_arrays(arrs, dev):
    """(fused, rank_a, rank_b) of the index's rank layout, checked."""
    if "fm_blocks" in arrs:
        fb = arrs["fm_blocks"]
        check_tensor("fm_blocks", fb, torch.int64, (fb.shape[0], 12), dev)
        _check_aligned("fm_blocks", fb)
        return True, fb, None
    cp, bb = arrs["occ_cp"], arrs["bwt_blocks"]
    check_tensor("occ_cp", cp, torch.int64, (cp.shape[0], 4), dev)
    check_tensor("bwt_blocks", bb, torch.int64, (bb.shape[0], 8), dev)
    _check_aligned("occ_cp", cp)
    _check_aligned("bwt_blocks", bb)
    return False, cp, bb


def _check_positions(arrs, meta, who):
    """sa_samp and L2 hold text positions up to seq_len, so an index with
    seq_len >= 2**31 - 1 needs them int64 (FMIndex.pos_dtype): cut to
    int32, L2's upper counts wrap negative and a walk steps to rows
    outside the index (on the card, reads outside its arrays).  Checked
    on either device, before the plain version or the kernel runs."""
    if meta["seq_len"] >= 2**31 - 1:
        for k in ("sa_samp", "L2"):
            if arrs[k].dtype != torch.int64:
                raise ValueError(f"{who}: {k} is {arrs[k].dtype}, but "
                                 f"seq_len {meta['seq_len']} needs int64 "
                                 "positions")


def _index_args(arrs, meta, dev, who):
    """(fused, rank_a, rank_b, sa_samp, L2, sa_intv) of a replicated
    index's arrays on dev, checked as both kernels take them."""
    intv = int(meta["sa_intv"])
    if intv < 1 or intv & (intv - 1):
        raise ValueError(f"{who}: sa_intv {intv} is not a power of two")
    fused, rank_a, rank_b = _rank_arrays(arrs, dev)
    sa, l2 = arrs["sa_samp"], arrs["L2"]
    if sa.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{who}: sa_samp dtype {sa.dtype}, expected "
                        "int32 or int64")
    check_tensor("sa_samp", sa, sa.dtype, (sa.shape[0],), dev)
    check_tensor("L2", l2, sa.dtype, (5,), dev)
    return fused, rank_a, rank_b, sa, l2, intv


def _need_segments(arrs, fused, rank_a, rank_b, sa, B=None, W16=None):
    """The need bitmap's segments as (name, first bit, bits, bytes a
    bit), each starting on a 32-bit word: the rank rows' 16-byte pieces (6
    a block of 128 rows: two of counts, four of BWT word pairs), the
    sa_samp entries and, for seed_ext (B reads of W16 words), the pac
    words and the read words."""
    nb = rank_a.shape[0] if fused else max(rank_a.shape[0], rank_b.shape[0])
    kinds = [("rank", 6 * nb, 16), ("sa", sa.shape[0], sa.element_size())]
    if B is not None:
        kinds += [("pac", arrs["pac_words"].shape[0], 8), ("rw", B * W16, 8)]
    segs, bit = [], 0
    for name, n, size in kinds:
        segs.append((name, bit, n, size))
        bit += -(-n // 32) * 32
    return segs, bit


def _need_bytes(need, segs):
    """Bytes of each segment of the need bitmap: its set bits times the
    bytes of the piece a bit stands for."""
    pop = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.int64, device=need.device)
    per_byte = pop[need.view(torch.uint8).long()]
    return {name: size * int(per_byte[bit // 8: (bit + n + 7) // 8].sum())
            for name, bit, n, size in segs}


def seed_ext(arrs, meta, rd, alive0, k0, l0, m0, pos_f, b_lane,
             phase1_steps: int, want_stats: bool = False,
             want_need: bool = False):
    """Per-lane final (k, l, m, rpos, rflag) of the staged extension, as
    ``fm_index._staged_ext`` returns them, from the same arguments: k, l,
    m, rpos (BS,) int64 and rflag (BS,) bool.

    arrs/meta: a replicated index's device arrays and meta; rd: the read
    batch as an ``fm_index._Reads`` (3-bit words rw (B, W16) int64 of L
    chars, lens (B,) int64); per lane alive0 (BS,) bool and k0, l0, m0,
    pos_f, b_lane (BS,) int64.  CUDA tensors launch the kernel on the
    current stream (counted in ``seed_ext.launches``), and with
    ``want_stats`` also return (BS, 7) int32 of each lane's extension
    steps, walk steps, matched chars and compare round trips, and the
    low 32 bits of the card's nanosecond timer at the lane's start, when
    it left the extension and at its end, or with ``want_need`` (not
    both: each is a kernel instantiation of its own) a dict of the bytes
    of the index's and the reads' arrays that the lanes' steps need,
    each piece counted once (rank, sa, pac, rw: ``_need_segments``); CPU
    tensors run the plain version (neither)."""
    if want_stats and want_need:
        raise ValueError("seed_ext: want_stats or want_need, not both")
    _check_positions(arrs, meta, "seed_ext")
    rw, lens = rd.rw, rd.lens
    if rw.device.type == "cpu":
        if want_stats or want_need:
            raise ValueError("seed_ext: the step counts and the needed "
                             "bytes come from the kernel; the plain "
                             "version has none")
        return _staged_ext(arrs, meta, rd, alive0, k0, l0, m0, pos_f,
                           b_lane, phase1_steps)
    dev = rw.device
    if dev.type != "cuda":
        raise ValueError(f"seed_ext: unsupported device {dev}")
    if phase1_steps < 1:
        raise ValueError(f"seed_ext: phase1_steps {phase1_steps} < 1")
    fused, rank_a, rank_b, sa, l2, intv = _index_args(arrs, meta, dev,
                                                      "seed_ext")
    B, W16 = rw.shape
    L = rd.L
    BS = alive0.shape[0]
    check_tensor("rw", rw, torch.int64, (B, W16), dev)
    check_tensor("lens", lens, torch.int64, (B,), dev)
    check_tensor("alive0", alive0, torch.bool, (BS,), dev)
    for name, x in (("k0", k0), ("l0", l0), ("m0", m0), ("pos_f", pos_f),
                    ("b_lane", b_lane)):
        check_tensor(name, x, torch.int64, (BS,), dev)
    x = arrs["pac_words"]
    check_tensor("pac_words", x, torch.int64, (x.shape[0],), dev)
    if not 1 <= L <= 16 * W16:
        raise ValueError(f"seed_ext: reads of width {L} in {W16} words")
    outs = [torch.empty(BS, dtype=torch.int64, device=dev) for _ in range(4)]
    rflag = torch.empty(BS, dtype=torch.bool, device=dev)
    stats = (torch.empty((BS, 7), dtype=torch.int32, device=dev)
             if want_stats else None)
    need, first = None, {"sa": 0, "pac": 0, "rw": 0}
    if want_need:
        segs, n_bits = _need_segments(arrs, fused, rank_a, rank_b, sa, B,
                                      W16)
        need = torch.zeros(n_bits // 32, dtype=torch.int32, device=dev)
        first = {name: bit for name, bit, _, _ in segs}
    if BS:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _fn()(
                alive0.data_ptr(), k0.data_ptr(), l0.data_ptr(),
                m0.data_ptr(), pos_f.data_ptr(), b_lane.data_ptr(),
                rw.data_ptr(), lens.data_ptr(), rank_a.data_ptr(),
                rank_b.data_ptr() if rank_b is not None else None,
                sa.data_ptr(), l2.data_ptr(), arrs["pac_words"].data_ptr(),
                *(o.data_ptr() for o in outs), rflag.data_ptr(),
                stats.data_ptr() if want_stats else None,
                need.data_ptr() if want_need else None,
                first["sa"], first["pac"], first["rw"],
                BS, L, W16, phase1_steps, meta["seq_len"], meta["primary"],
                sa.shape[0], arrs["pac_words"].shape[0], intv,
                sa.element_size(), int(fused), stream)
        if rc != 0:
            raise RuntimeError(f"seed_ext: kernel launch failed (cudaError "
                               f"{rc})")
        seed_ext.launches += 1
    res = (*outs, rflag)
    if want_stats:
        return (*res, stats)
    if want_need:
        return (*res, _need_bytes(need, segs))
    return res


seed_ext.launches = 0


def sa_locate(arrs, meta, rows, valid, want_stats: bool = False,
              want_need: bool = False):
    """SA positions of rows (n,) int64 where valid (n,) bool is set, 0
    elsewhere, as ``fm_index.sa_lookup`` returns them (int64), over a
    replicated index with a sampled SA (sa_intv a power of two above 1).

    CUDA tensors launch ``sa_locate_kernel`` on the current stream
    (counted in ``sa_locate.launches``), and with ``want_stats`` also
    return each row's walk steps (n,) int32 and each warp's issued walk
    steps and its lanes' walk steps (4 ceil(n / 128), 2) int32 (the
    persistent grid's warps, 4 a block of 128 threads, fill the first
    rows; the rest stay 0), or
    with ``want_need`` (not both) a dict of the
    bytes of the index's arrays the walks need, each piece counted once
    (rank, sa: ``_need_segments``); CPU tensors run the plain version
    (neither)."""
    if want_stats and want_need:
        raise ValueError("sa_locate: want_stats or want_need, not both")
    _check_positions(arrs, meta, "sa_locate")
    if rows.device.type == "cpu":
        if want_stats or want_need:
            raise ValueError("sa_locate: the walk steps and the needed "
                             "bytes come from the kernel; the plain "
                             "version has none")
        return sa_lookup(arrs, meta, rows, valid)
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"sa_locate: unsupported device {dev}")
    fused, rank_a, rank_b, sa, l2, intv = _index_args(arrs, meta, dev,
                                                      "sa_locate")
    if intv < 2:
        raise ValueError("sa_locate: a full SA (sa_intv 1) is one gather, "
                         "not a walk")
    n = rows.shape[0]
    check_tensor("rows", rows, torch.int64, (n,), dev)
    check_tensor("valid", valid, torch.bool, (n,), dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    stats = wstats = None
    need, need_sa = None, 0
    if want_need:
        segs, n_bits = _need_segments(arrs, fused, rank_a, rank_b, sa)
        need = torch.zeros(n_bits // 32, dtype=torch.int32, device=dev)
        need_sa = {name: bit for name, bit, _, _ in segs}["sa"]
    if n:
        counter = torch.empty(1, dtype=torch.int64, device=dev)
        if want_stats:
            stats = torch.empty(n, dtype=torch.int32, device=dev)
            wstats = torch.zeros((4 * -(-n // 128), 2), dtype=torch.int32,
                                 device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _locate_fn()(
                rows.data_ptr(), valid.data_ptr(), rank_a.data_ptr(),
                rank_b.data_ptr() if rank_b is not None else None,
                sa.data_ptr(), l2.data_ptr(), out.data_ptr(),
                counter.data_ptr(),
                stats.data_ptr() if want_stats else None,
                wstats.data_ptr() if want_stats else None,
                need.data_ptr() if want_need else None, need_sa, n,
                meta["seq_len"], meta["primary"], sa.shape[0], intv,
                sa.element_size(), int(fused), stream)
        if rc != 0:
            raise RuntimeError(f"sa_locate: kernel launch failed (cudaError "
                               f"{rc})")
        sa_locate.launches += 1
    elif want_stats:
        stats = torch.empty(0, dtype=torch.int32, device=dev)
        wstats = torch.zeros((0, 2), dtype=torch.int32, device=dev)
    if want_stats:
        return out, stats, wstats
    if want_need:
        return out, _need_bytes(need, segs)
    return out


sa_locate.launches = 0
