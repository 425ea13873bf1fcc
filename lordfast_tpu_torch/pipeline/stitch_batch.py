"""The host stitcher over a whole batch in one native call.

``BatchStitcher.stitch`` packs a batch's stitch jobs (engine._build_jobs)
and their gap and escalation tables once, stitches every window in one
call of ``lf_stitch_batch`` (native/csrc/stitch_batch.cpp), whose threads
run stitch_chain with the GIL released for the whole call, and decodes
the records into one ``Mapping`` a window in one pass.  Each window gets
the inputs and the capacity ``align_chain_native`` gives stitch_chain, so
its records are that function's; a window whose records or strings
overflow that capacity comes back as None, for the caller to stitch with
the Python stitcher, as ``align_and_score`` does after such an overflow.
"""

from __future__ import annotations

import ctypes
from contextlib import nullcontext
from typing import List, Optional

import numpy as np

from .. import native
from ..align import edlib_eq as ed
from ..align.chain_align import Mapping, SamRecord, _StitchRecordC

# the records a window that align_chain_native gives stitch_chain room for
MAX_RECS = 64
# stitch.cpp's StitchRecord, as lf_stitch_batch_collect writes it
RECORD = np.dtype(_StitchRecordC)


def _concat(parts, dtype) -> np.ndarray:
    return (np.concatenate(parts).astype(dtype, copy=False) if parts
            else np.zeros(0, dtype))


def _addr(a: np.ndarray) -> int:
    return a.ctypes.data


def check_record(dtype: np.dtype = RECORD) -> None:
    """Raises unless dtype's size and each field's offset, by name, are
    stitch_batch.cpp's record's (lf_stitch_record_layout)."""
    want = {"": dtype.itemsize,
            **{f: dtype.fields[f][1] for f in dtype.names}}
    got = np.zeros(len(want), np.int64)
    names = ctypes.c_char_p()
    n = native._load().lf_stitch_record_layout(
        got.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(got),
        ctypes.byref(names))
    have = dict(zip([""] + names.value.decode().rstrip(",").split(","),
                    got.tolist()[:n]))
    if n != len(want) or have != want:
        raise RuntimeError(f"stitch_batch.cpp's record {have} differs "
                           f"from {want}")


class BatchStitcher:
    """The stitcher of one engine: its index's packed genome and contigs
    and its configuration's scalars, held once.  n_threads: the native
    threads of a call.  str_cap: each window's string capacity (0:
    align_chain_native's, 16 x (read_len + 1024) bytes); a smaller one
    makes windows overflow, for the tests."""

    def __init__(self, idx, cfg, n_threads: int, str_cap: int = 0):
        check_record()
        self.n_threads = max(1, int(n_threads))
        self.str_cap = str_cap
        self._pac = np.ascontiguousarray(idx.pac, dtype=np.uint8)
        self._l_pac = int(idx.l_pac)
        self._contig_off = np.ascontiguousarray(idx.contig_offsets,
                                                dtype=np.int64)
        self._contig_len = np.ascontiguousarray(idx.contig_lengths,
                                                dtype=np.int64)
        self._mat = np.ascontiguousarray(
            ed.build_ksw_matrix(cfg.ksw_match_clip, cfg.ksw_mismatch_clip),
            dtype=np.int8)
        self._params = native.StitchParams(
            clip_len=cfg.clip_len, split_len=cfg.split_len,
            slack=cfg.end_extension_slack,
            clip_gapo=cfg.ksw_gap_open_clip, clip_gape=cfg.ksw_gap_extend_clip,
            clip_band=cfg.clip_band, clip_zdrop=cfg.clip_zdrop,
            split_odel=cfg.split_o_del, split_edel=cfg.split_e_del,
            split_oins=cfg.split_o_ins, split_eins=cfg.split_e_ins,
            split_band=cfg.split_band, split_zdrop=cfg.split_zdrop,
            clip_sim=cfg.clip_sim, split_sim=cfg.split_sim,
            reverse_sim=cfg.reverse_sim,
            # reference quirk (score_mapping): forward windows score their
            # inter-split gaps at 0.15, reverse ones at gapPenalty
            gap_penalty_fwd=0.15, gap_penalty_rev=cfg.gap_penalty)

    def stitch(self, jobs, tables, esc_tables, acc: Optional[np.ndarray] = None,
               span=None) -> List[Optional[Mapping]]:
        """One Mapping a job, None where the window overflowed.  acc: None,
        or a zeroed int64 (len(jobs), len(native.TRACE_FIELDS) + 2) array
        whose row w receives window w's accounting (stitch_batch.cpp).
        span(name): a context manager around the main thread's two serial
        halves, "stitch_pack" and "stitch_decode"."""
        if not jobs:
            return []
        n = len(jobs)
        if acc is not None and (acc.shape != (n, len(native.TRACE_FIELDS) + 2)
                                or acc.dtype != np.int64
                                or not acc.flags.c_contiguous):
            raise ValueError("acc must be a C-contiguous int64 array of "
                             f"shape ({n}, {len(native.TRACE_FIELDS) + 2})")
        span = span or (lambda _name: nullcontext())
        with span("stitch_pack"):
            arrays = self._pack(jobs, tables, esc_tables)
        nrec = np.empty(n, np.int32)
        total = np.empty(n, np.int64)
        n_recs, n_str = ctypes.c_int64(), ctypes.c_int64()
        lib = native._load()
        i64p = ctypes.POINTER(ctypes.c_int64)
        batch = lib.lf_stitch_batch(
            ctypes.byref(self._inputs(n, arrays)), ctypes.byref(self._params),
            self._mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            self.n_threads, MAX_RECS, self.str_cap,
            None if acc is None else acc.ctypes.data_as(i64p),
            nrec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            total.ctypes.data_as(i64p), ctypes.byref(n_recs),
            ctypes.byref(n_str))
        if not batch:
            raise MemoryError("lf_stitch_batch failed: out of memory")
        with span("stitch_decode"):
            try:
                recs = np.empty(n_recs.value, RECORD)
                strs = np.empty(n_str.value, np.uint8)
                first = np.empty(n, np.int64)
            except BaseException:
                lib.lf_stitch_batch_free(batch)
                raise
            lib.lf_stitch_batch_collect(
                batch, _addr(recs),
                strs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                first.ctypes.data_as(i64p))
            return self._decode(nrec, total, first, recs, strs)

    def _pack(self, jobs, tables, esc_tables) -> dict:
        """The batch as flat arrays (StitchInputs' fields)."""
        n = len(jobs)
        a = {}
        lens = np.fromiter((len(j["cq"]) for j in jobs), np.int64, n)
        a["chain_off"] = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=a["chain_off"][1:])
        for k in ("cq", "ct", "cl"):
            a[k] = _concat([j[k] for j in jobs], np.int64)
        queries = [j["query"] for j in jobs]
        a["query_off"] = np.zeros(n + 1, np.int64)
        np.cumsum(np.fromiter(map(len, queries), np.int64, n),
                  out=a["query_off"][1:])
        a["query"] = _concat(queries, np.uint8)
        a["read_len"] = np.fromiter((j["read_len"] for j in jobs), np.int64, n)
        a["is_rev"] = np.fromiter((j["is_rev"] for j in jobs), np.uint8, n)
        self._pack_tables(a, "gap_base", ("g_has", "g_dist", "g_end",
                                          "g_moves", "g_off", "g_len"),
                          tables, n)
        self._pack_tables(a, "esc_base", ("e_has", "e_a", "e_b", "e_moves",
                                          "e_off"), esc_tables, n)
        return a

    @staticmethod
    def _pack_tables(a, base_key, keys, tables, n) -> None:
        """Concatenates the per-window tables {job id: (has, x, ..., moves,
        off[, len])} (engine._collect_jobs_gaps, _escalation_pass): each
        window's first slot into a[base_key] (-1: no table), its move
        offsets moved to the whole moves array's."""
        base = np.full(n, -1, np.int64)
        cols = [[] for _ in keys]
        slot = mv = 0
        for jid in sorted(tables):
            t = tables[jid]
            base[jid] = slot
            slot += len(t[0])
            for c, x in zip(cols, t):
                c.append(x)
            cols[4][-1] = np.asarray(t[4], np.int64) + mv
            mv += len(t[3])
        a[base_key] = base
        for i, (k, c) in enumerate(zip(keys, cols)):
            a[k] = _concat(c, np.uint8 if i in (0, 3) else np.int64)

    def _inputs(self, n, a) -> native.StitchInputs:
        s = native.StitchInputs(n=n, l_pac=self._l_pac,
                                n_contigs=len(self._contig_off))
        for k, v in a.items():
            setattr(s, k, _addr(v))
        s.pac = _addr(self._pac)
        s.contig_off = _addr(self._contig_off)
        s.contig_len = _addr(self._contig_len)
        return s

    @staticmethod
    def _decode(nrec, total, first, recs, strs) -> List[Optional[Mapping]]:
        raw = strs.tobytes()
        col = {f: recs[f].tolist() for f in recs.dtype.names}
        flag, pos, pos_end = col["flag"], col["pos"], col["pos_end"]
        q_start, q_end = col["q_start"], col["q_end"]
        nm, score = col["nm_count"], col["aln_score"]
        co, cl, mo, ml = (col["cigar_off"], col["cigar_len"], col["md_off"],
                          col["md_len"])
        out = []
        for k, ts, r0 in zip(nrec.tolist(), total.tolist(), first.tolist()):
            if k < 0:
                out.append(None)
                continue
            out.append(Mapping(total_score=ts, records=[
                SamRecord(flag=flag[i], pos=pos[i], pos_end=pos_end[i],
                          q_start=q_start[i], q_end=q_end[i],
                          cigar=raw[co[i]:co[i] + cl[i]].decode(),
                          md=raw[mo[i]:mo[i] + ml[i]].decode(),
                          nm_count=nm[i], aln_score=score[i])
                for i in range(r0, r0 + k)]))
        return out
