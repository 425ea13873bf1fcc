"""The hand-written CUDA Myers distance kernel and its wrapper.

``myers_dist`` computes the batched NW/SHW Myers edit distance and
alignment end of every gap of a bucket (the main path's gap DP).  On a
CUDA tensor it launches ``csrc/myers_dist.cu`` — one thread per gap,
built for sm_90a — and raises if the launch fails; on a CPU tensor it
runs the plain PyTorch version ``gap_dp.myers_dist_plain``.  There is no
fallback from the first to the second.

The kernel replaces, in distance-only mode, the Pallas kernels
``lordfast_tpu/ops/gap_dp_pallas.py`` ``_make_kernel`` (:84) and
``_make_kernel_tiled`` (:290); see the source for its design and what
bounds it.

Build: ``nvcc`` compiles the source into a shared library with a plain C
interface in ``lordfast_tpu_torch/_build`` at first use (a few seconds),
loaded with ctypes; the library is rebuilt when the source is newer.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..native import BUILD_DIR
from .gap_dp import myers_dist_plain

CSRC = Path(__file__).resolve().parent.parent / "csrc" / "myers_dist.cu"
LIB_PATH = BUILD_DIR / "libmyers_dist.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# query words per gap (Q / 32) the kernel is instantiated for: every
# bucket of LordfastConfig.gap_buckets
SUPPORTED_W = (1, 2, 4, 8, 16, 64, 128)

_lib = None
build_log = ""  # nvcc/ptxas output of the last build (registers, spills)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: set NVCC or put it on PATH")


def build() -> Path:
    """Compile the kernel library if it is missing or older than its
    source; returns its path.  Raises with the compiler's output on
    failure."""
    global build_log
    if LIB_PATH.exists() and \
            LIB_PATH.stat().st_mtime >= CSRC.stat().st_mtime:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC)],
                       capture_output=True, text=True)
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {CSRC.name}:\n{build_log}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp = ctypes.c_void_p
        lib.lf_myers_dist.restype = ctypes.c_int
        lib.lf_myers_dist.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, vp]
        _lib = lib
    return _lib


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def myers_dist(qs, ql, ts, tl, is_shw, Q: int, T: int):
    """Batched NW/SHW Myers distance: (dist, end), each (G,) int32.

    qs (G, Q) uint8, ql (G,) int32, ts (G, T) uint8, tl (G,) int32,
    is_shw (G,) bool, with 1 <= ql <= Q and 1 <= tl <= T (see
    gap_dp.myers_dist_plain for the semantics).  CUDA tensors launch the
    kernel on the current stream (counted in ``myers_dist.launches``);
    CPU tensors run the plain version."""
    if qs.device.type == "cpu":
        return myers_dist_plain(qs, ql, ts, tl, is_shw, Q, T)
    if qs.device.type != "cuda":
        raise ValueError(f"myers_dist: unsupported device {qs.device}")
    if Q % 32 or Q // 32 not in SUPPORTED_W:
        raise ValueError(f"myers_dist: Q={Q} not supported")
    G = qs.shape[0]
    dev = qs.device
    _check("qs", qs, torch.uint8, (G, Q), dev)
    _check("ql", ql, torch.int32, (G,), dev)
    _check("ts", ts, torch.uint8, (G, T), dev)
    _check("tl", tl, torch.int32, (G,), dev)
    _check("is_shw", is_shw, torch.bool, (G,), dev)
    dist = torch.empty(G, dtype=torch.int32, device=dev)
    end = torch.empty(G, dtype=torch.int32, device=dev)
    if G == 0:
        return dist, end
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lf_myers_dist(qs.data_ptr(), ql.data_ptr(), ts.data_ptr(),
                               tl.data_ptr(), is_shw.data_ptr(),
                               dist.data_ptr(), end.data_ptr(), G, Q, T,
                               stream)
    if rc != 0:
        raise RuntimeError(f"myers_dist: kernel launch failed "
                           f"(cudaError {rc})")
    myers_dist.launches += 1
    return dist, end


myers_dist.launches = 0
