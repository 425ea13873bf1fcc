"""The hand-written CUDA seed-extension kernel and its wrapper.

``seed_ext`` runs the seeder's staged greedy extension of every lane (a
read times a sample position) with its occ == 1 finish in one launch of
``csrc/seed_ext.cu``, built for sm_90a: one thread per lane, the loop in
registers.  On a CUDA tensor it launches the kernel and raises if the
launch fails; on a CPU tensor it runs the plain version
(``fm_index._staged_ext``).  There is no fallback from the first to the
second.  A replicated index only: the sharded index's lockstep extension
(``fm_index._ext_steps`` under a group) makes collective calls between
steps and stays eager.

The kernel replaces the JAX package's device loops of
``lordfast_tpu/ops/fm_index.py`` ``_seed_anchors_impl`` (:387):
``ext_loop_flat`` (:485, ``lax.while_loop`` :492), ``_resolve_rounds``
(:497, :568) and ``staged_ext`` (:602); see the source for its design
and what bounds it.  Build: ``cuda_build`` (nvcc at first use, ctypes).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import check_tensor
from .fm_index import _Reads, _staged_ext


def _fn():
    f = cuda_build.load("seed_ext").lf_seed_ext
    if f.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.restype = ci
        f.argtypes = ([vp] * 20 + [cl, ci, ci, cl, cl, cl, ci, ci, ci]
                      + [vp])
    return f


def _rank_arrays(arrs, dev):
    """(fused, rank_a, rank_b) of the index's rank layout, checked."""
    if "fm_blocks" in arrs:
        fb = arrs["fm_blocks"]
        check_tensor("fm_blocks", fb, torch.int64, (fb.shape[0], 12), dev)
        return True, fb, None
    cp, bb = arrs["occ_cp"], arrs["bwt_blocks"]
    check_tensor("occ_cp", cp, torch.int64, (cp.shape[0], 4), dev)
    check_tensor("bwt_blocks", bb, torch.int64, (bb.shape[0], 8), dev)
    return False, cp, bb


def seed_ext(arrs, meta, reads, read_lens, alive0, k0, l0, m0, pos_f,
             b_lane, phase1_steps: int, want_stats: bool = False):
    """Per-lane final (k, l, m, rpos, rflag) of the staged extension, as
    ``fm_index._staged_ext`` returns them: k, l, m, rpos (BS,) int64 and
    rflag (BS,) bool.

    arrs/meta: a replicated index's device arrays and meta; reads (B, L)
    uint8 codes (4 = N / pad) and read_lens (B,) int32; per lane alive0
    (BS,) bool and k0, l0, m0, pos_f, b_lane (BS,) int64.  CUDA tensors
    launch the kernel on the current stream (counted in
    ``seed_ext.launches``), and with ``want_stats`` also return (BS, 3)
    int32 of each lane's extension steps, walk steps and compared chars;
    CPU tensors run the plain version (no stats)."""
    if reads.device.type == "cpu":
        if want_stats:
            raise ValueError("seed_ext: the step counts come from the "
                             "kernel; the plain version has none")
        return _staged_ext(arrs, meta, _Reads(reads, read_lens), alive0, k0,
                           l0, m0, pos_f, b_lane, phase1_steps)
    dev = reads.device
    if dev.type != "cuda":
        raise ValueError(f"seed_ext: unsupported device {dev}")
    if phase1_steps < 1:
        raise ValueError(f"seed_ext: phase1_steps {phase1_steps} < 1")
    intv = int(meta["sa_intv"])
    if intv < 1 or intv & (intv - 1):
        raise ValueError(f"seed_ext: sa_intv {intv} is not a power of two")
    B, L = reads.shape
    BS = alive0.shape[0]
    check_tensor("reads", reads, torch.uint8, (B, L), dev)
    check_tensor("read_lens", read_lens, torch.int32, (B,), dev)
    check_tensor("alive0", alive0, torch.bool, (BS,), dev)
    for name, x in (("k0", k0), ("l0", l0), ("m0", m0), ("pos_f", pos_f),
                    ("b_lane", b_lane)):
        check_tensor(name, x, torch.int64, (BS,), dev)
    fused, rank_a, rank_b = _rank_arrays(arrs, dev)
    sa, l2 = arrs["sa_samp"], arrs["L2"]
    if sa.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"seed_ext: sa_samp dtype {sa.dtype}, expected "
                        "int32 or int64")
    check_tensor("sa_samp", sa, sa.dtype, (sa.shape[0],), dev)
    check_tensor("L2", l2, sa.dtype, (5,), dev)
    for name in ("bwt_words", "pac_words"):
        x = arrs[name]
        check_tensor(name, x, torch.int64, (x.shape[0],), dev)
    if L < 1:
        raise ValueError("seed_ext: reads of width 0")
    outs = [torch.empty(BS, dtype=torch.int64, device=dev) for _ in range(4)]
    rflag = torch.empty(BS, dtype=torch.bool, device=dev)
    stats = (torch.empty((BS, 3), dtype=torch.int32, device=dev)
             if want_stats else None)
    if BS:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _fn()(
                alive0.data_ptr(), k0.data_ptr(), l0.data_ptr(),
                m0.data_ptr(), pos_f.data_ptr(), b_lane.data_ptr(),
                reads.data_ptr(), read_lens.data_ptr(), rank_a.data_ptr(),
                rank_b.data_ptr() if rank_b is not None else None,
                arrs["bwt_words"].data_ptr(), sa.data_ptr(), l2.data_ptr(),
                arrs["pac_words"].data_ptr(),
                *(o.data_ptr() for o in outs), rflag.data_ptr(),
                stats.data_ptr() if want_stats else None,
                BS, L, phase1_steps, meta["seq_len"], meta["primary"],
                sa.shape[0], intv, sa.element_size(), int(fused), stream)
        if rc != 0:
            raise RuntimeError(f"seed_ext: kernel launch failed (cudaError "
                               f"{rc})")
        seed_ext.launches += 1
    res = (*outs, rflag)
    return (*res, stats) if want_stats else res


seed_ext.launches = 0
