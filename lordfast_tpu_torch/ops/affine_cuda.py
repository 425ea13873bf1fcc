"""The hand-written CUDA ksw_extend2 kernel and its wrapper.

``extend_batch_cuda`` runs the batched banded affine-gap extension of
the escalation offload (phase B) on the card: ``csrc/affine_ext.cu``,
one warp per problem with the band in registers, built for sm_90a.  It
takes CUDA tensors only and raises if the launch fails; ``affine.extend_batch`` sends CPU
tensors to the plain version ``affine.extend_batch_plain`` instead.

The kernel replaces the Pallas kernel ``lordfast_tpu/ops/affine_pl.py``
``_make_kernel`` (:85); see the source for its design and what bounds
it.  Build: ``cuda_build`` (nvcc at first use, ctypes).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .affine import PARAM_NAMES, ExtendResult
from .cuda_build import check_tensor

MAX_W = 126  # the kernel's band holds at most 8 slots a lane


def _fn():
    f = cuda_build.load("affine_ext").lf_affine_extend
    if f.argtypes is None:
        vp = ctypes.c_void_p
        f.restype = ctypes.c_int
        f.argtypes = [vp, vp, ctypes.POINTER(vp), ctypes.POINTER(vp),
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      vp]
    return f


def extend_batch_cuda(qs, ts, Qe: int, Te: int, w_max: int, *, qlen, tlen,
                      o_del, e_del, o_ins, e_ins, w_eff, zdrop, h0, match,
                      mismatch) -> ExtendResult:
    """Batched ksw_extend2 on the card.  qs (G, Qe) uint8, ts (G, Te)
    uint8, and the eleven per-problem parameters (G,) int32, all on one
    CUDA device; 1 <= qlen <= Qe, 0 <= tlen <= Te, w_eff from
    affine.clamp_band and at most w_max <= MAX_W (the band's 32 K slots,
    K = ceil((2 w_max + 2) / 32) <= 8).  w_max is checked here; w_eff
    lies on the card, so the kernel checks it and traps (the fault shows
    at the next synchronise) rather than this wrapper reading it back,
    which would synchronise every launch.  Launches on the current stream
    (counted in ``extend_batch_cuda.launches``); returns ExtendResult of
    (G,) int32."""
    if qs.device.type != "cuda":
        raise ValueError(f"extend_batch_cuda: unsupported device {qs.device}")
    if not 0 <= w_max <= MAX_W:
        raise ValueError(f"extend_batch_cuda: w_max {w_max} outside "
                         f"[0, {MAX_W}]")
    G = qs.shape[0]
    dev = qs.device
    check_tensor("qs", qs, torch.uint8, (G, Qe), dev)
    check_tensor("ts", ts, torch.uint8, (G, Te), dev)
    given = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                 w_eff=w_eff, zdrop=zdrop, h0=h0, match=match,
                 mismatch=mismatch)
    params = [qlen, tlen] + [given[n] for n in PARAM_NAMES]
    for name, p in zip(("qlen", "tlen") + PARAM_NAMES, params):
        check_tensor(name, p, torch.int32, (G,), dev)
    outs = [torch.empty(G, dtype=torch.int32, device=dev) for _ in range(6)]
    if G == 0:
        return ExtendResult(*outs)
    vp = ctypes.c_void_p
    p_arr = (vp * len(params))(*(p.data_ptr() for p in params))
    o_arr = (vp * 6)(*(o.data_ptr() for o in outs))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(qs.data_ptr(), ts.data_ptr(), p_arr, o_arr, G, Qe, Te,
                   w_max, stream)
    if rc != 0:
        raise RuntimeError(f"extend_batch_cuda: kernel launch failed "
                           f"(cudaError {rc})")
    extend_batch_cuda.launches += 1
    return ExtendResult(*outs)


extend_batch_cuda.launches = 0
