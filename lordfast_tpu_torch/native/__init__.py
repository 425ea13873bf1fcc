"""ctypes bindings for the native (C++) host components.

The C++ sources are the JAX package's (``lordfast_tpu/native/*.cpp``,
read by path: that package is never imported).  They are compiled with
g++ into this package's build directory (``lordfast_tpu_torch/_build``)
at first use.  Unlike the JAX loader there is no numpy fallback: a
failed build or load raises, so a run never drops silently to the slow
host paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG.parent / "lordfast_tpu" / "native"
BUILD_DIR = _PKG / "_build"
_LIB_PATH = BUILD_DIR / "liblordfast_native.so"
_SRCS = ("sais.cpp", "align_eq.cpp", "stitch.cpp", "edlib_path.cpp")
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lib = None


def build() -> Path:
    """Compile the native library if it is missing or older than a
    source; returns its path.  Raises on a compiler error."""
    srcs = [SRC_DIR / s for s in _SRCS]
    missing = [str(s) for s in srcs if not s.exists()]
    if missing:
        raise FileNotFoundError(f"native sources not found: {missing}")
    if _LIB_PATH.exists() and all(
        s.stat().st_mtime <= _LIB_PATH.stat().st_mtime for s in srcs
    ):
        return _LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    r = subprocess.run([cxx, *CXXFLAGS, *map(str, srcs), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"native build failed:\n{r.stderr}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.sais_u8.restype = ctypes.c_int
    lib.sais_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.bwt_from_sa.restype = ctypes.c_int
    lib.bwt_from_sa.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.nw_align.restype = ctypes.c_int64
    lib.nw_align.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                             u8p, i64p]
    lib.nw_align_full.restype = ctypes.c_int64
    lib.nw_align_full.argtypes = lib.nw_align.argtypes
    lib.edlib_band_path.restype = ctypes.c_int
    lib.edlib_band_path.argtypes = [
        u8p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int64,
        u8p, i64p,
    ]
    lib.edlib_nw_dist.restype = ctypes.c_int64
    lib.edlib_nw_dist.argtypes = [u8p, ctypes.c_int64, u8p,
                                  ctypes.c_int64]
    lib.shw_best_end.restype = ctypes.c_int64
    lib.shw_best_end.argtypes = [u8p, ctypes.c_int64, u8p,
                                 ctypes.c_int64, i64p]
    lib.sw_extend.restype = ctypes.c_int32
    lib.sw_extend.argtypes = [
        ctypes.c_int32, u8p, ctypes.c_int32, u8p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p, i32p, i32p,
    ]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.sa_walk_batch.restype = ctypes.c_int
    lib.sa_walk_batch.argtypes = [
        u32p, u32p, i64p, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, ctypes.c_int64, ctypes.c_int,
    ]
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.decode_colcodes.restype = ctypes.c_int64
    lib.decode_colcodes.argtypes = [
        u16p, ctypes.c_int64, i64p, i64p, ctypes.c_int64,
        u8p, ctypes.c_int64, i64p, i64p,
    ]
    lib.stitch_chain.restype = ctypes.c_int32
    lib.stitch_chain.argtypes = [
        i64p, i64p, i64p, ctypes.c_int32,              # chain
        u8p, ctypes.c_int64, ctypes.c_int32,           # query
        u8p, ctypes.c_int64, ctypes.c_int64,           # ref slice
        ctypes.c_int64, ctypes.c_int64,                # chr bounds
        ctypes.c_int32, ctypes.c_double,               # clip
        ctypes.c_int32, ctypes.c_double,               # split
        ctypes.c_double, ctypes.c_int32,               # reverse_sim, slack
        ctypes.POINTER(ctypes.c_int8),                 # mat_clip
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double,                               # gap_penalty
        ctypes.c_void_p, ctypes.c_int32,               # recs
        ctypes.c_char_p, ctypes.c_int64,               # strbuf
        i64p,                                          # total_score
        u8p, i64p, i64p, u8p, i64p, i64p,              # gap table
        u8p, i64p, i64p, u8p, i64p,                    # escalation table
    ]
    _lib = lib
    return _lib


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of ``text`` (uint8 codes; last char must be the unique
    smallest sentinel) by native SA-IS; the O(n log^2 n) numpy prefix
    doubling only where SA-IS reports an error."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    lib = _load()
    sa = np.empty(n, dtype=np.int64)
    rc = lib.sais_u8(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        int(text.max()) + 1,
    )
    if rc == 0:
        return sa
    return _suffix_array_doubling(text)


def sa_walk_batch(bwt_words, occ_cp, L2, primary, intv, rows,
                  n_threads=0):
    """Batched sampled-SA locate walk (bwt_sa, lib/bwa/bwt.c:86-96):
    returns (final_rows, steps) after walking each row to a multiple of
    ``intv``; SA[rows[i]] = steps[i] + sampled_sa[final_rows[i] // intv]."""
    lib = _load()
    bw = np.ascontiguousarray(bwt_words, dtype=np.uint32)
    cp = np.ascontiguousarray(occ_cp, dtype=np.uint32)
    l2 = np.ascontiguousarray(L2, dtype=np.int64)
    out_rows = np.ascontiguousarray(rows, dtype=np.int64).copy()
    steps = np.empty(len(out_rows), dtype=np.int64)
    nt = n_threads or (os.cpu_count() or 1)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sa_walk_batch(
        bw.ctypes.data_as(u32p), cp.ctypes.data_as(u32p),
        l2.ctypes.data_as(i64p), int(primary), int(intv) - 1,
        out_rows.ctypes.data_as(i64p), steps.ctypes.data_as(i64p),
        len(out_rows), int(nt),
    )
    return out_rows, steps


def _suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    """Manber-Myers prefix doubling with numpy lexsort (fallback)."""
    n = len(text)
    rank = text.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    k = 1
    tmp = np.empty(n, dtype=np.int64)
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        tmp[order[0]] = 0
        prev = order[:-1]
        cur = order[1:]
        newgroup = (rank[cur] != rank[prev]) | (key2[cur] != key2[prev])
        tmp[cur] = np.cumsum(newgroup)
        rank = tmp.copy()
        sa = order
        if rank[sa[-1]] == n - 1:
            break
        k <<= 1
    return sa
