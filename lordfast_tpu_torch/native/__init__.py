"""ctypes bindings for the native (C++) host components.

The C++ sources in ``csrc/`` named in ``_SRCS`` are copies of the JAX
package's ``lordfast_tpu/native/*.cpp`` (tests/test_torch_import.py holds
them byte-equal to their originals); those in ``_PORT_SRCS`` are the
port's own: ``stitch_trace.cpp``, the stitcher's accounting
(``trace_begin`` / ``trace_end``), linked around the copies' DP primitives
with ``-Wl,--wrap``, and ``stitch_batch.cpp``, the stitcher over a whole
batch on native threads (``lf_stitch_batch``, pipeline/stitch_batch.py).
They are compiled with g++ into this package's build directory
(``lordfast_tpu_torch/_build``) at first use.
Unlike the JAX loader there is no numpy fallback: a failed build or load
raises, so a run never drops silently to the slow host paths.  Threads
of one process build and load under one lock; the compiler writes to a
temporary name unique to the call and the result is renamed into place,
so concurrent processes are safe too.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"
_LIB_PATH = BUILD_DIR / "liblordfast_native.so"
_SRCS = ("sais.cpp", "align_eq.cpp", "stitch.cpp", "edlib_path.cpp")
_PORT_SRCS = ("stitch_trace.cpp", "stitch_batch.cpp")
# the DP primitives whose calls between the library's objects go through
# stitch_trace.cpp's __wrap_ versions
_WRAPPED = ("edlib_band_path", "nw_align", "shw_best_end", "sw_extend")
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
# the fields of one stitch accounting row (stitch_trace.cpp's Field order)
TRACE_FIELDS = ("native_ns", "windows", "overflow", "rebuild_ns", "rebuilds",
                "rebuild_fallback", "local_dp_ns", "local_dps",
                "local_cells")


class StitchParams(ctypes.Structure):
    """The configuration's stitch scalars (stitch_batch.cpp StitchParams)."""
    _fields_ = [(f, ctypes.c_int32) for f in (
        "clip_len", "split_len", "slack", "clip_gapo", "clip_gape",
        "clip_band", "clip_zdrop", "split_odel", "split_edel", "split_oins",
        "split_eins", "split_band", "split_zdrop")] + [
        (f, ctypes.c_double) for f in (
            "clip_sim", "split_sim", "reverse_sim", "gap_penalty_fwd",
            "gap_penalty_rev")]


class StitchInputs(ctypes.Structure):
    """A packed batch of windows (stitch_batch.cpp StitchInputs): every
    field but the counts is the address of a C-contiguous array."""
    _fields_ = [("n", ctypes.c_int64)] + [
        (f, ctypes.c_void_p) for f in (
            "chain_off", "cq", "ct", "cl", "query_off", "query", "read_len",
            "is_rev", "gap_base", "g_has", "g_dist", "g_end", "g_moves",
            "g_off", "g_len", "esc_base", "e_has", "e_a", "e_b", "e_moves",
            "e_off", "pac")] + [("l_pac", ctypes.c_int64)] + [
        (f, ctypes.c_void_p) for f in ("contig_off", "contig_len")] + [
        ("n_contigs", ctypes.c_int64)]


_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile the native library if it is missing or older than a
    source; returns its path.  Raises on a compiler error."""
    with _lock:
        return _build()


def _build() -> Path:
    srcs = [SRC_DIR / s for s in _SRCS + _PORT_SRCS]
    missing = [str(s) for s in srcs if not s.exists()]
    if missing:
        raise FileNotFoundError(f"native sources not found: {missing}")
    if _LIB_PATH.exists() and all(
        s.stat().st_mtime <= _LIB_PATH.stat().st_mtime for s in srcs
    ):
        return _LIB_PATH
    tmp = temp_output(BUILD_DIR, _LIB_PATH.name)
    try:
        cxx = os.environ.get("CXX", "g++")
        wrap = [f"-Wl,--wrap={f}" for f in _WRAPPED]
        r = subprocess.run([cxx, *CXXFLAGS, *map(str, srcs), *wrap, "-o",
                            str(tmp)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native build failed:\n{r.stderr}")
        os.replace(tmp, _LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
    return _LIB_PATH


def temp_output(directory: Path, name: str) -> Path:
    """A new empty file in ``directory`` (created if missing) whose name
    starts with ``name`` and is unique to the call: a compiler's output
    goes there before it is renamed to ``directory / name``."""
    directory.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=f"{name}.",
                               suffix=".tmp")
    os.close(fd)
    return Path(tmp)


def _load():
    with _lock:
        return _load_locked()


def _load_locked():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
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
    # the timed entry (stitch_trace.cpp) stands in for stitch_chain
    timed = lib.lf_stitch_chain_timed
    timed.restype = lib.stitch_chain.restype
    timed.argtypes = lib.stitch_chain.argtypes
    lib.stitch_chain = timed
    # the accounting's switches for a Python caller of stitch_chain
    # (lf_stitch_batch arms them in its own threads) keep the GIL
    # (PYFUNCTYPE): a call this short gains nothing from letting it go
    lib.lf_trace_begin = ctypes.PYFUNCTYPE(None, ctypes.c_void_p)(
        ("lf_trace_begin", lib))
    lib.lf_trace_end = ctypes.PYFUNCTYPE(None)(("lf_trace_end", lib))
    lib.lf_trace_fields.restype = ctypes.c_int
    lib.lf_trace_fields.argtypes = []
    if lib.lf_trace_fields() != len(TRACE_FIELDS):
        raise RuntimeError("stitch_trace.cpp's fields differ from "
                           "TRACE_FIELDS")
    # the batch stitcher (stitch_batch.cpp); a CDLL call releases the GIL
    lib.lf_stitch_batch.restype = ctypes.c_void_p
    lib.lf_stitch_batch.argtypes = [
        ctypes.POINTER(StitchInputs), ctypes.POINTER(StitchParams),
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,  # mat_clip, threads
        ctypes.c_int32, ctypes.c_int64, i64p,           # capacity, acc
        i32p, i64p, i64p, i64p,                         # outputs, sizes
    ]
    lib.lf_stitch_batch_collect.restype = None
    lib.lf_stitch_batch_collect.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            u8p, i64p]
    lib.lf_stitch_batch_free.restype = None
    lib.lf_stitch_batch_free.argtypes = [ctypes.c_void_p]
    lib.lf_stitch_record_layout.restype = ctypes.c_int64
    lib.lf_stitch_record_layout.argtypes = [
        i64p, ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p)]
    _lib = lib
    return _lib


def trace_begin(acc: np.ndarray) -> None:
    """Add this thread's stitch_chain calls into ``acc`` (int64, C order,
    at least len(TRACE_FIELDS) entries, kept alive by the caller) until
    trace_end, in TRACE_FIELDS' order: CLOCK_MONOTONIC ns inside
    stitch_chain, inside its path rebuilds (edlib_band_path) and inside
    its local DPs (nw_align, shw_best_end, sw_extend), with their calls
    and the DPs' cells.  Calls of those primitives outside stitch_chain
    are not counted."""
    if acc.dtype != np.int64 or not acc.flags.c_contiguous or \
            len(acc) < len(TRACE_FIELDS):
        raise ValueError("trace_begin needs a C-contiguous int64 array of "
                         f"at least {len(TRACE_FIELDS)} entries")
    (_lib or _load()).lf_trace_begin(acc.ctypes.data)


def trace_end() -> None:
    """Stop this thread's stitcher accounting."""
    (_lib or _load()).lf_trace_end()


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
