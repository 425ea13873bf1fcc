"""Builds the port's CUDA sources (``lordfast_tpu_torch/csrc/*.cu``):
``myers.cu`` (the Myers gap DP, ``gap_dp_cuda``), ``affine_ext.cu``
(ksw_extend2, ``affine_cuda``), ``chain_dp.cu`` (the chaining DP and its
backtrack, ``chain_cuda``), ``seed_ext.cu`` (the seeder's staged
extension and the locate walk of a sampled SA, ``fm_index_cuda``) and
``seed_shard.cu`` (the steps of a sharded index's lockstep extension and
walk, ``fm_shard_cuda``); the last two include ``fm_rank.cuh``.

Each source is compiled by ``nvcc`` for sm_90a into a shared library
with a plain C interface in ``lordfast_tpu_torch/_build`` at first use
(a few seconds each), and loaded with ctypes; a library is rebuilt when
its source or a header of ``csrc/`` is newer.  ``build_all`` starts one nvcc per source at once.
A failed build raises with the compiler's output.  Builds and loads of
one process run under one lock; each nvcc writes to a temporary name
unique to the call, renamed into place, so concurrent processes are safe.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..native import BUILD_DIR, temp_output

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the port's kernel sources, by library name (csrc/<name>.cu)
SOURCES = ("myers", "affine_ext", "chain_dp", "seed_ext", "seed_shard")

logs: dict = {}   # name -> nvcc/ptxas output of its last build
_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: set NVCC or put it on PATH")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not lib.exists():
        return True
    srcs = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in srcs)


def temp_lib_path(name: str) -> Path:
    """A new empty file in BUILD_DIR, unique to the call, for nvcc's
    output before it is renamed to lib_path(name)."""
    return temp_output(BUILD_DIR, lib_path(name).name)


def build_all(names=SOURCES, force: bool = False) -> dict:
    """Compile every stale library of ``names`` (every one with
    ``force``) with one nvcc process each, all started together; returns
    {name: seconds} of the builds that ran."""
    with _lock:
        return _build_all(names, force)


def _build_all(names, force: bool = False) -> dict:
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.time()
    procs = {}
    try:
        for n in todo:
            tmp = temp_lib_path(n)
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        secs, failed = {}, []
        for n, (tmp, proc) in procs.items():
            logs[n] = proc.communicate()[0]
            secs[n] = time.time() - t0
            if proc.returncode != 0:
                failed.append(n)
            else:
                os.replace(tmp, lib_path(n))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}.cu:\n{logs[n]}" for n in failed))
    return secs


def load(name: str):
    """The ctypes library of csrc/<name>.cu, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_all((name,))
            lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return lib


def check_tensor(name, x, dtype, shape, device):
    """Raise unless x has the dtype, shape and device a kernel takes and
    is contiguous."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
