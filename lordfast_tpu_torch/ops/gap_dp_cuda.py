"""The hand-written CUDA Myers kernels and their wrappers.

``myers_dist`` computes the batched NW/SHW Myers edit distance and
alignment end of every gap of a bucket (the main path's gap DP), and on
request the scores of the last column (the escalation offload's
Hirschberg splits); ``myers_moves`` also returns the path, as the Pallas
kernel's ``lead`` and per-column codes (the escalation offload's
secondary segments).  On a CUDA tensor each launches its mode of the one
fill in ``csrc/myers.cu``, built for sm_90a — one thread per gap in the
narrow buckets, one warp per gap with the word chain across its lanes in
the wide ones (the source's dispatch says which W takes which) — and
raises if the launch fails; on a CPU tensor it runs the plain PyTorch
version (``gap_dp.myers_dist_plain`` / ``gap_dp.myers_moves_plain``).
There is no fallback from the first to the second.

Both replace the Pallas kernels
``lordfast_tpu/ops/gap_dp_pallas.py`` ``_make_kernel`` (:84) and
``_make_kernel_tiled`` (:290); see the sources for their design and what
bounds them.  Build: ``cuda_build`` (nvcc at first use, ctypes).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import check_tensor
from .gap_dp import myers_dist_plain, myers_moves_plain

# query words per gap (Q / 32) the kernels are instantiated for: every
# bucket of LordfastConfig.gap_buckets
SUPPORTED_W = (1, 2, 4, 8, 16, 64, 128)


def _bind(fn: str, n_ptr: int):
    lib = cuda_build.load("myers")
    f = getattr(lib, fn)
    if f.argtypes is None:
        vp = ctypes.c_void_p
        f.restype = ctypes.c_int
        f.argtypes = [vp] * n_ptr + [ctypes.c_int] * 3 + [vp]
    return f


def _check_gaps(fname, qs, ql, ts, tl, is_shw, Q, T):
    if qs.device.type != "cuda":
        raise ValueError(f"{fname}: unsupported device {qs.device}")
    if Q % 32 or Q // 32 not in SUPPORTED_W:
        raise ValueError(f"{fname}: Q={Q} not supported")
    G = qs.shape[0]
    dev = qs.device
    check_tensor("qs", qs, torch.uint8, (G, Q), dev)
    check_tensor("ql", ql, torch.int32, (G,), dev)
    check_tensor("ts", ts, torch.uint8, (G, T), dev)
    check_tensor("tl", tl, torch.int32, (G,), dev)
    check_tensor("is_shw", is_shw, torch.bool, (G,), dev)
    # the kernels read the code rows with 16-byte loads
    if T % 16 or qs.data_ptr() % 16 or ts.data_ptr() % 16:
        raise ValueError(f"{fname}: T={T} or a code row not on a 16-byte "
                         "boundary")
    return G, dev


def _launch(fname, f, args, dev):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = f(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fname}: kernel launch failed (cudaError {rc})")


def myers_dist(qs, ql, ts, tl, is_shw, Q: int, T: int,
               want_col: bool = False):
    """Batched NW/SHW Myers distance: (dist, end), each (G,) int32, and
    with ``want_col`` the last column's words ``col`` (2, Q/32, G) int32.

    qs (G, Q) uint8, ql (G,) int32, ts (G, T) uint8, tl (G,) int32,
    is_shw (G,) bool, with 1 <= ql <= Q and 1 <= tl <= T (see
    gap_dp.myers_dist_plain for the semantics).  CUDA tensors launch the
    kernel on the current stream (counted in ``myers_dist.launches``);
    CPU tensors run the plain version."""
    if qs.device.type == "cpu":
        return myers_dist_plain(qs, ql, ts, tl, is_shw, Q, T, want_col)
    G, dev = _check_gaps("myers_dist", qs, ql, ts, tl, is_shw, Q, T)
    dist = torch.empty(G, dtype=torch.int32, device=dev)
    end = torch.empty(G, dtype=torch.int32, device=dev)
    col = (torch.empty((2, Q // 32, G), dtype=torch.int32, device=dev)
           if want_col else None)
    out = (dist, end, col) if want_col else (dist, end)
    if G == 0:
        return out
    f = _bind("lf_myers_dist", 8)
    _launch("myers_dist", f,
            (qs.data_ptr(), ql.data_ptr(), ts.data_ptr(), tl.data_ptr(),
             is_shw.data_ptr(), dist.data_ptr(), end.data_ptr(),
             col.data_ptr() if want_col else None, G, Q, T), dev)
    myers_dist.launches += 1
    return out


def myers_moves(qs, ql, ts, tl, is_shw, Q: int, T: int):
    """Batched NW/SHW Myers alignment with path: (dist, end, lead,
    colcode) — dist/end/lead (G,) int32, colcode (T, G) int16 holding
    the uint16 ``(run << 2) | move`` codes (gap_dp.myers_moves_plain;
    decode with gap_dp.decode_col_moves).  Inputs as myers_dist.  CUDA
    tensors launch the kernel on the current stream (counted in
    ``myers_moves.launches``) with two ((T + 32) * Q/32, G) uint32
    decision planes as scratch (laid out as the kernel's design for the
    bucket needs); CPU tensors run the plain version."""
    if qs.device.type == "cpu":
        return myers_moves_plain(qs, ql, ts, tl, is_shw, Q, T)
    G, dev = _check_gaps("myers_moves", qs, ql, ts, tl, is_shw, Q, T)
    dist = torch.empty(G, dtype=torch.int32, device=dev)
    end = torch.empty(G, dtype=torch.int32, device=dev)
    lead = torch.empty(G, dtype=torch.int32, device=dev)
    colcode = torch.empty((T, G), dtype=torch.int16, device=dev)
    if G == 0:
        return dist, end, lead, colcode
    up = torch.empty(((T + 32) * (Q // 32), G), dtype=torch.int32,
                     device=dev)
    left = torch.empty_like(up)
    f = _bind("lf_myers_moves", 11)
    _launch("myers_moves", f,
            (qs.data_ptr(), ql.data_ptr(), ts.data_ptr(), tl.data_ptr(),
             is_shw.data_ptr(), dist.data_ptr(), end.data_ptr(),
             lead.data_ptr(), colcode.data_ptr(), up.data_ptr(),
             left.data_ptr(), G, Q, T), dev)
    myers_moves.launches += 1
    return dist, end, lead, colcode


myers_dist.launches = 0
myers_moves.launches = 0
