"""End-to-end mapping engine on one PyTorch device.

Port of ``lordfast_tpu/pipeline/engine.py``.  Orchestrates the per-chunk
flow of the reference driver (src/baseFAST.cpp:44-82: readChunk ->
initFASTChunk -> mapSeqMT -> releaseChunk):

  device (batched over reads): seeding -> window voting -> per-window seed
  selection -> chaining DP (pipeline/device_stage.py), then the batched
  Myers distance of every inter-seed gap and read end
  (ops/gap_dp_cuda.py);
  host: chain stitching (native edlib-equivalent paths from the device
  distances), scoring, mode resolution (coarse vs fine,
  src/LordFAST.cpp:542-569), SAM output in input order.

The host methods are the JAX engine's; only the device seams differ.
Ported path: the extend-whole seeder, any chaining the device stage
supports, a replicated index on one device, and the escalation DPs on
the host stitcher (``esc_device`` off).  A mesh, a sharded index, the
device escalation offload and the dormant seeders raise
NotImplementedError.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, TextIO

import numpy as np
import torch

from ..align.chain_align import Mapping, align_and_score
from ..config import LordfastConfig
from ..index.container import FMIndex
from ..io import sam as sam_io
from ..io.fastx import Read, read_chunks
from ..ops import fm_index as fm_ops
from ..ops import gap_dp
from ..ops import gap_dp_cuda
from ..utils.checkpoint import ChunkProgress
from ..utils.metrics import Metrics
from ..utils.pack import seq_to_codes, revcomp_codes
from .device_stage import device_pipeline


def _pad_to_bucket(n: int, buckets=(1024, 2048, 4096, 8192, 16384, 32768,
                                    65536, 131072, 262144)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device without a usable card
    is an error, never a quiet run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device


class MappingEngine:
    def __init__(self, idx: FMIndex, cfg: Optional[LordfastConfig] = None,
                 device="cuda", mesh=None, shard_index: bool = False,
                 esc_device: Optional[bool] = None):
        """device: the torch device of the index and the device stage
        ("cuda", "cuda:1", "cpu").  mesh / shard_index / esc_device=True
        are the JAX engine's multi-device and escalation-offload options,
        not ported yet."""
        self.idx = idx
        self.cfg = (cfg or LordfastConfig()).validate()
        self.meta = idx.meta
        if mesh is not None or shard_index:
            raise NotImplementedError(
                "mesh / shard_index are not ported to lordfast_tpu_torch")
        if esc_device:
            raise NotImplementedError(
                "the device escalation offload (esc_device=True) is not "
                "ported; the host stitcher runs the escalation DPs")
        if self.cfg.seeder != "extend-whole":
            raise NotImplementedError(
                f"seeder {self.cfg.seeder!r} is not ported; only "
                "'extend-whole' is")
        # the voting keys pack the window id into 30 bits (ops/voting.py);
        # win = t_pos // read_len stays below 2^30 whenever
        # 2*l_pac / min_read_len does (~54 Gbp at the default floor).
        if (2 * idx.l_pac) // max(self.cfg.min_read_len, 1) >= 2**30:
            raise ValueError(
                "genome too large for the 30-bit voting window ids: "
                f"2*l_pac={2 * idx.l_pac} with min_read_len="
                f"{self.cfg.min_read_len} overflows 2^30 windows"
            )
        self.device = resolve_device(device)
        self.stats = {"reads": 0, "mapped": 0, "chunks": 0, "batches": 0}
        self.metrics = Metrics(verbosity=getattr(self.cfg, "verbosity", 0))
        # host worker pool over stitch jobs (the reference's per-core
        # pthread pool, src/LordFAST.cpp:305-316); the native stitcher
        # releases the GIL (ctypes), so threads scale across cores
        import os

        n_workers = self.cfg.num_threads or (os.cpu_count() or 1)
        if n_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=n_workers)
        else:
            self._pool = None
        self.arrs = idx.device_arrays(self.device)
        self._device_fn = device_pipeline(self.meta, self.cfg)
        # wide-budget pipelines for the compact-overflow retries
        # (fine-mode reads whose windows ran out of K slots; the reference
        # chains every qualifying local max, src/LordFAST.cpp:874-904):
        # 8x shared budget first, then a solo-read 512-window pipeline
        self._big_fn = None
        self._solo_fn = None

    def _put_reads(self, arr: np.ndarray):
        return torch.from_numpy(arr).to(self.device)

    def _fetch(self, host_out: dict) -> dict:
        """Device -> host copy of a batch's host payload."""
        return {k: v.cpu().numpy() for k, v in host_out.items()}

    # ---- device stage ----
    def _device_stage(self, reads_dev, lens: np.ndarray, big: bool = False):
        pos = fm_ops.sample_positions_host(lens, self.cfg.sampling_count)
        fn = self._get_big_fn() if big else self._device_fn
        return fn(self.arrs, reads_dev,
                  torch.from_numpy(np.asarray(lens, np.int32)).to(
                      self.device),
                  torch.from_numpy(pos).to(self.device))

    def _get_big_fn(self):
        """Device pipeline with 8x the candidate/compact-window budget."""
        if self._big_fn is None:
            self._big_fn = device_pipeline(self.meta, self.cfg.replace(
                max_candidates=min(4 * self.cfg.max_candidates, 256),
                compact_windows_per_read=8
                * self.cfg.compact_windows_per_read,
            ))
        return self._big_fn

    def _solo_retry(self, codes, L, page: int = 0):
        """Last-resort retry for a read whose candidate windows overflow
        even the 8x shared budget: run it ALONE through a pipeline whose
        per-read candidate cap and window slots both reach 512, so every
        qualifying window gets a chaining slot (the reference chains all
        of them, src/LordFAST.cpp:874-904).  page > 0 selects candidate
        ranks [512*page, 512*(page+1)); the caller pages until a page is
        not saturated.  Returns (out, chains_dev) with the read at batch
        row 0."""
        if self._solo_fn is None:
            self._solo_fn = device_pipeline(self.meta, self.cfg.replace(
                max_candidates=512, compact_windows_per_read=512,
            ))
        arr = np.full((1, L), 4, dtype=np.uint8)
        arr[0, : len(codes)] = codes
        lens = np.array([len(codes)], np.int32)
        pos = fm_ops.sample_positions_host(lens, self.cfg.sampling_count)
        _, chains, host_out = self._solo_fn(
            self.arrs, self._put_reads(arr),
            torch.from_numpy(lens).to(self.device),
            torch.from_numpy(pos).to(self.device), page,
        )
        return self._fetch(host_out), chains

    # ---- per-read host resolution ----
    def _chain_rows(self, out, chains_dev, k: int, n: int, wide=None):
        """Chain arrays for window row k: from the eagerly-transferred
        trimmed tensors when the chain fits, else from the batched wide
        fetch (_fetch_wide_rows); a direct per-row device fetch only as
        a last resort."""
        if n <= out["chain_ql"].shape[1]:
            ql = out["chain_ql"][k, :n]
            return (ql >> 12).astype(np.int64), out["chain_t"][k, :n], \
                (ql & 4095).astype(np.int64)
        if wide is not None and k in wide:
            q, t, ln = wide[k]
            return (q[:n].astype(np.int64), t[:n],
                    ln[:n].astype(np.int64))
        return (chains_dev.q_pos[k, :n].cpu().numpy(),
                chains_dev.t_pos[k, :n].cpu().numpy(),
                chains_dev.length[k, :n].cpu().numpy())

    def _fetch_wide_rows(self, chains_dev, rows, nmax: int):
        """One device gather + copy for every selected chain longer than
        the eager transfer cap."""
        ridx = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        q = chains_dev.q_pos[ridx, :nmax].cpu().numpy()
        t = chains_dev.t_pos[ridx, :nmax].cpu().numpy()
        ln = chains_dev.length[ridx, :nmax].cpu().numpy()
        return {int(k): (q[i], t[i], ln[i]) for i, k in enumerate(rows)}

    def _select_rows(self, b: int, out, rows_by_read):
        """Window selection per read: coarse mode stitches the single
        top-vote window; fine mode the top max_map by chain score
        (src/LordFAST.cpp:542-569, 819-904).

        Returns (is_fine, selected_rows, overflowed): overflowed = the
        read's qualifying windows were not all chained — it got fewer
        compact-window slots than cand_need (shared K budget exhausted)
        or its per-read candidate cap C itself may be truncating
        (cand_sat: the lowest-vote candidate still qualifies).  The
        caller escalates through the 8x-budget then the solo pipeline
        rather than silently diverging from the reference (which chains
        every qualifying window, src/LordFAST.cpp:874-904)."""
        cfg = self.cfg
        if not out["cand_valid0"][b]:
            return False, [], False
        rows = rows_by_read.get(b, [])
        is_fine = bool(out["is_fine"][b])
        if not is_fine:
            selected = [k for k in rows if out["cw_cand_idx"][k] == 0][:1]
            return False, selected, not selected
        over = (len(rows) < int(out["cand_need"][b])
                or bool(out["cand_sat"][b]))
        selected = self._fine_heap_select(rows, out, cfg.max_map)
        return True, selected, over

    @staticmethod
    def _heap_select(items, max_map):
        """findTopWins_fine's top-window heap, byte for byte
        (src/LordFAST.cpp:874-904): items = [(score, payload)] in scan
        order; a min-heap (std::push_heap / pop_heap with compareWin =
        score>) of float32 chain scores keeps the top maxWin, replacing
        only on a STRICTLY greater score, and the result is the heap's
        ARRAY order.  The heap ops match libstdc++'s __push_heap /
        __adjust_heap element moves exactly."""

        def push_heap(h):  # __push_heap(first, len-1, 0, value)
            hole = len(h) - 1
            value = h[hole]
            parent = (hole - 1) >> 1
            while hole > 0 and h[parent][0] > value[0]:  # compareWin
                h[hole] = h[parent]
                hole = parent
                parent = (hole - 1) >> 1
            h[hole] = value

        def pop_heap(h):  # __pop_heap(first, last-1, last-1, value)
            n = len(h) - 1
            value = h[n]
            h[n] = h[0]
            # __adjust_heap(first, 0, n, value)
            hole, top, second = 0, 0, 0
            while second < (n - 1) >> 1:
                second = 2 * (second + 1)
                if h[second][0] > h[second - 1][0]:  # comp(right, left)
                    second -= 1
                h[hole] = h[second]
                hole = second
            if (n & 1) == 0 and second == (n - 2) >> 1:
                second = 2 * (second + 1)
                h[hole] = h[second - 1]
                hole = second - 1
            # __push_heap(first, hole, top, value)
            parent = (hole - 1) >> 1
            while hole > top and h[parent][0] > value[0]:
                h[hole] = h[parent]
                hole = parent
                parent = (hole - 1) >> 1
            h[hole] = value

        heap = []
        for s, payload in items:
            if len(heap) < max_map:
                heap.append((s, payload))
                push_heap(heap)
            elif s > heap[0][0]:
                pop_heap(heap)
                heap[-1] = (s, payload)
                push_heap(heap)
        return [p for _, p in heap]

    @classmethod
    def _fine_heap_select(cls, rows, out, max_map):
        """Windows scanned forward strand first then reverse, ascending
        winId, through _heap_select (the final std::sort by totalScore
        is insertion sort — stable — for n <= 16)."""
        scan = sorted(
            rows,
            key=lambda k: (int(out["cw_is_rev"][k]),
                           int(out["cw_win_id"][k])),
        )
        return cls._heap_select(
            [(np.float32(out["chain_score"][k]), k) for k in scan], max_map)

    @classmethod
    def _fine_heap_select_multi(cls, pairs, ctxs, max_map):
        """_fine_heap_select over windows spread across several device
        contexts (the window-paging escalation): pairs = [(ctx_id, row)].
        Windows are deduped by (strand, winId) — page boundaries can
        overlap at the wide path's sort clamp — and scanned in the same
        fwd-then-rev ascending-winId order; returns selected pairs."""
        seen = set()
        items = []
        for ci, k in pairs:
            out = ctxs[ci][0]
            key = (int(out["cw_is_rev"][k]), int(out["cw_win_id"][k]))
            if key in seen:
                continue
            seen.add(key)
            items.append((key, np.float32(out["chain_score"][k]),
                          (ci, k)))
        items.sort(key=lambda x: x[0])
        return cls._heap_select([(s, p) for _, s, p in items], max_map)

    def _gap_descriptors(self, j, read_len, is_rev, cq, ct, cl,
                         chr_beg, chr_end):
        """Descriptor list for the plain-path DP sites of one window
        (left end / inter-seed gaps / right end), mirroring the stitcher's
        call sites (native/stitch.cpp; reference src/LordFAST.cpp:1820-2230).
        Query coordinates are rebased onto the forward read row: the
        strand-oriented query is revcomp(fwd) for reverse windows, so a
        slice [a, a+n) of it is the reverse-complemented slice
        [L-a-n, L-a) of the forward row, and a site-level revcomp (left
        end) cancels the strand one."""
        slack = self.cfg.end_extension_slack
        L = read_len
        n = len(cq)

        def q_adj(a, ln, site_rc):
            if is_rev:
                return L - a - ln, not site_rc
            return a, site_rc

        descs = []  # (slot, q_start, q_len, q_rc, t_start, t_len, t_rc, shw)
        r0 = int(cq[0])
        tl0 = r0 + slack
        if r0 > 0 and int(ct[0]) - tl0 >= chr_beg:
            qa, qrc = q_adj(0, r0, True)
            descs.append((0, j, qa, r0, qrc, int(ct[0]) - tl0, tl0, True,
                          True))
        for i in range(n - 1):
            r_s = int(cq[i] + cl[i])
            t_s = int(ct[i] + cl[i])
            rl = int(cq[i + 1]) - r_s
            tl = int(ct[i + 1]) - t_s
            if rl > 0 and tl > 0:
                qa, qrc = q_adj(r_s, rl, False)
                descs.append((i + 1, j, qa, rl, qrc, t_s, tl, False, False))
        r_s = int(cq[n - 1] + cl[n - 1])
        rl = L - r_s
        tl = rl + slack
        if rl > 0 and int(ct[n - 1] + cl[n - 1]) + tl - 1 <= chr_end:
            qa, qrc = q_adj(r_s, rl, False)
            descs.append((n, j, qa, rl, qrc, int(ct[n - 1] + cl[n - 1]), tl,
                          False, True))
        return descs

    def _dispatch_gap_descs(self, items, reads_dev):
        """Dispatch the batched device Myers distance over gap
        descriptors, without waiting for it.

        items: list of (key, desc) with desc = (row_j, q_start, q_len,
        q_rc, t_start, t_len, t_rc, is_shw) in forward-read-row / global
        genome coordinates (see _gap_descriptors).  Each gap goes to the
        first bucket (Q, T, G) that holds it and every bucket is cut into
        sub-batches of at most G gaps, one kernel launch each (counted in
        the ``gap_parts`` metric).  Only (dist, end) come back: the
        stitcher rebuilds each path with the bit-exact banded edlib
        traceback (native edlib_path.cpp).  All results are stacked into
        one device tensor, fetched by _collect_gap_descs with a single
        device-to-host copy.  Descriptors larger than every bucket are
        omitted (the native stitcher computes those locally)."""
        cfg = self.cfg
        buckets = cfg.gap_buckets
        per_bucket = [[] for _ in buckets]
        n_host = 0
        want_hist = cfg.verbosity >= 2  # hoisted out of the hot loop
        gsz_hist = {}
        for key, d in items:
            q_len, t_len = d[2], d[5]
            if want_hist:
                m = 1 << max(max(q_len, t_len) - 1, 0).bit_length()
                gsz_hist[m] = gsz_hist.get(m, 0) + 1
            for bi, (Q, T, _) in enumerate(buckets):
                if q_len <= Q and t_len <= T:
                    per_bucket[bi].append((key, d))
                    break
            else:
                n_host += 1
        if want_hist:
            for m, cnt in gsz_hist.items():
                self.metrics.add(f"gsz_{m}", cnt)
        if n_host:
            self.metrics.add("gaps_host", n_host)

        t_pack = time.time()
        parts, dists, ends = [], [], []
        for bi, per in enumerate(per_bucket):
            if not per:
                continue
            Q, T, G = buckets[bi]
            self.metrics.add(f"gaps_b{Q}", len(per))
            for s in range(0, len(per), G):
                part = per[s : s + G]
                # one host->device copy of the part's descriptor table
                dm = torch.from_numpy(
                    np.asarray([d for _, d in part], dtype=np.int64)
                ).to(self.device)
                desc = {
                    "q_read": dm[:, 0], "q_start": dm[:, 1],
                    "q_len": dm[:, 2], "q_rc": dm[:, 3] != 0,
                    "t_start": dm[:, 4], "t_len": dm[:, 5],
                    "t_rc": dm[:, 6] != 0, "is_shw": dm[:, 7] != 0,
                    "valid": torch.ones(len(part), dtype=torch.bool,
                                        device=self.device),
                }
                qs, ql, ts, tl = gap_dp.gather_gap_seqs(
                    self.arrs["pac_words"], reads_dev, desc, Q, T,
                    self.meta["l_pac"],
                )
                dist, end = gap_dp_cuda.myers_dist(qs, ql, ts, tl,
                                                   desc["is_shw"], Q, T)
                self.metrics.add("gap_parts", 1)
                parts.append(part)
                dists.append(dist)
                ends.append(end)
        pending = None
        if parts:
            pending = (parts, torch.stack([torch.cat(dists),
                                           torch.cat(ends)]))
        self.metrics.timers["gap_pack"] += time.time() - t_pack
        return pending

    def _collect_gap_descs(self, pending):
        """Blocking half of the gap DP: one device-to-host copy of every
        dispatched sub-batch's (dist, end).  Returns {key: (dist, end)}."""
        results = {}
        if pending is None:
            return results
        parts, merged = pending
        t_wait = time.time()
        vals = merged.cpu().numpy()
        self.metrics.timers["gap_wait"] += time.time() - t_wait
        t_unpack = time.time()
        off = 0
        for part in parts:
            for gi, (key, _) in enumerate(part):
                results[key] = (int(vals[0, off + gi]),
                                int(vals[1, off + gi]))
            off += len(part)
        self.metrics.timers["gap_unpack"] += time.time() - t_unpack
        return results

    def _dispatch_jobs_gaps(self, jobs, reads_dev):
        """Gap DP over every plain-path DP site of every selected window
        of the batch; _collect_jobs_gaps assembles the results into the
        stitcher's per-window tables one pipeline step later."""
        items = [
            ((job_id, d[0]), d[1:])
            for job_id, job in enumerate(jobs)
            for d in job["descs"]
        ]
        return self._dispatch_gap_descs(items, reads_dev)

    def _collect_jobs_gaps(self, jobs, pending):
        """Per-window gap tables in the stitcher's ABI (has, dist, end,
        moves, move offsets, move lengths): every slot is dist/end only,
        so len = -1 tells the stitcher to rebuild the path locally
        (banded-exact, stitch.cpp) and the move buffer is empty."""
        results = self._collect_gap_descs(pending)
        tables = {}
        for (job_id, slot), (dist, end) in results.items():
            t = tables.get(job_id)
            if t is None:
                ns = len(jobs[job_id]["cq"]) + 1
                t = (np.zeros(ns, np.uint8), np.zeros(ns, np.int64),
                     np.zeros(ns, np.int64), np.zeros(0, np.uint8),
                     np.zeros(ns, np.int64), np.full(ns, -1, np.int64))
                tables[job_id] = t
            t[0][slot] = 1
            t[1][slot] = dist
            t[2][slot] = end
        return tables

    def _stitch_job(self, job, gap_table) -> Mapping:
        # thread-pool worker: must not touch shared mutable state
        # (metrics are accounted serially by the caller)
        return align_and_score(
            job["cq"], job["ct"], job["cl"], job["query"], job["read_len"],
            job["is_rev"], self.idx, self.cfg, gap_table=gap_table,
        )

    def _stitch_all(self, jobs, tables) -> List[Mapping]:
        """Stitch every selected window of the batch, across host threads
        when a pool exists (reference parity: one worker per core,
        src/LordFAST.cpp:305-316; --threads / cfg.num_threads)."""
        if self._pool is not None and len(jobs) > 1:
            mappings = list(
                self._pool.map(
                    lambda it: self._stitch_job(it[1], tables.get(it[0])),
                    enumerate(jobs),
                )
            )
        else:
            mappings = [
                self._stitch_job(job, tables.get(jid))
                for jid, job in enumerate(jobs)
            ]
        for job, m in zip(jobs, mappings):
            if len(m.records) > 1:
                self.metrics.add("splits", len(m.records) - 1)
                base = 16 if job["is_rev"] else 0
                self.metrics.add(
                    "inversions",
                    sum(1 for r in m.records if (r.flag & 16) != base),
                )
        return mappings

    # ---- main loop ----
    def map_file(self, seq_path, out: TextIO, command_line: str = "",
                 progress: Optional[ChunkProgress] = None,
                 process_index: int = 0, num_processes: int = 1):
        """Map every read of seq_path, writing SAM to out.

        progress: optional chunk-level checkpoint — chunks with id <=
        progress.last_done are skipped (already in the output of a
        previous run); each completed chunk is recorded durably.

        process_index / num_processes: this process maps only chunks with
        chunk_id % num_processes == process_index.  self.chunk_table
        records (chunk_id, byte_start, byte_end) per completed chunk."""
        cfg = self.cfg
        # fresh counters/timers per run (chunk lines report deltas)
        self.metrics.reset()
        self.chunk_table = []
        resume_from = progress.last_done if progress else -1
        if resume_from >= 0:
            # seed cumulative stats from the sidecar so run totals and
            # the mapped-rate remain correct across resumes
            self.stats["reads"] = progress.total_reads
            self.stats["mapped"] = progress.total_mapped
        if not cfg.no_sam_header and resume_from < 0:
            sam_io.write_header(out, self.idx, cfg, command_line)

        def _tell():
            try:
                out.flush()
                return out.tell()
            except (OSError, AttributeError):
                return 0

        for chunk_id, chunk in enumerate(read_chunks(seq_path,
                                                     cfg.chunk_bytes)):
            if chunk_id % num_processes != process_index:
                continue
            if chunk_id <= resume_from:
                self.metrics.log(
                    1, f"[engine] chunk {chunk_id} already done; skipping"
                )
                continue
            t0 = time.time()
            self.stats["chunks"] += 1
            self.metrics.snapshot()
            c_start = _tell()
            self._map_chunk(chunk, out)
            self.chunk_table.append((chunk_id, c_start, _tell()))
            if progress is not None:
                out.flush()
                try:
                    off = out.tell()
                except (OSError, AttributeError):
                    off = 0
                progress.mark_done(chunk_id, out_offset=off,
                                   total_reads=self.stats["reads"],
                                   total_mapped=self.stats["mapped"])
            print(
                "[engine] "
                + self.metrics.chunk_line(chunk_id, len(chunk),
                                          time.time() - t0),
                file=sys.stderr, flush=True,
            )
        if progress is not None:
            progress.finish()

    def _map_chunk(self, chunk: List[Read], out: TextIO):
        cfg = self.cfg

        # short reads are emitted unmapped without touching the device
        # (src/LordFAST.cpp:490-499); over-long reads likewise — the
        # reference has no guard and overflows its SEQ_MAX_LENGTH=250k
        # stack buffers (src/Common.h:51), this build rejects them cleanly
        def in_range(r):
            return cfg.min_read_len <= len(r.seq) <= cfg.seq_max_length

        n_long = sum(1 for r in chunk if len(r.seq) > cfg.seq_max_length)
        if n_long:
            self.metrics.add("overlong_reads", n_long)
            self.metrics.log(
                0, f"[WARNING] {n_long} read(s) longer than "
                   f"{cfg.seq_max_length} bp emitted unmapped",
            )
        work = [r for r in chunk if in_range(r)]
        # length-bucketed batches to bound padding waste
        order = sorted(range(len(work)), key=lambda i: len(work[i].seq))
        results = {}
        B = cfg.batch_reads

        def dispatch(s):
            idxs = order[s : s + B]
            batch = [work[i] for i in idxs]
            self.stats["batches"] += 1
            L = _pad_to_bucket(max(len(r.seq) for r in batch))
            # the batch is padded to B rows, as in the JAX engine
            arr = np.full((B, L), 4, dtype=np.uint8)
            lens = np.zeros(B, dtype=np.int32)
            for j, r in enumerate(batch):
                codes = seq_to_codes(r.seq)
                arr[j, : len(codes)] = codes
                lens[j] = len(codes)
            # ship reads once; the same device buffer feeds the seeding
            # stage and the gap-DP gathers (no second upload)
            reads_dev = self._put_reads(arr)
            with self.metrics.timer("device"):
                _, chains_dev, host_out = self._device_stage(reads_dev,
                                                             lens)
            return (idxs, batch, reads_dev, lens, (chains_dev, host_out))

        def _rows_by_read(out):
            rows = {}
            cw_valid = out["cw_valid"]
            cw_read = out["cw_read_idx"]
            for k in range(len(cw_valid)):
                if cw_valid[k]:
                    rows.setdefault(int(cw_read[k]), []).append(k)
            return rows

        def resolve(idxs, batch, reads_dev, lens, dev):
            # one device->host transfer per batch, trimmed on device
            # (seeds and full chains stay on device)
            chains_dev, host_out = dev
            with self.metrics.timer("device"):
                out = self._fetch(host_out)
            for name in ("seeds", "candidates", "fine_reads",
                         "chained_windows"):
                self.metrics.add(name, int(out[f"stat_{name}"]))
            t_sel = time.time()
            rows_by_read = _rows_by_read(out)

            # window selection pre-pass: find chains exceeding the eager
            # transfer cap and fetch them all in one gather
            # selections[j] = (is_fine, [(ctx_id, row), ...])
            selections = {}
            overflow = []
            for j in range(len(idxs)):
                is_fine, selected, over = self._select_rows(
                    j, out, rows_by_read
                )
                selections[j] = (is_fine, [(0, k) for k in selected])
                if over:
                    overflow.append(j)

            # per-read device context: 0 = normal run, 1 = 8x-budget
            # retry, 2+ = solo 512-window retries (and their candidate-
            # rank pages) for reads whose windows overflowed the shared
            # K compact slots
            ctxs = [(out, chains_dev)]
            if overflow:
                self.metrics.add("compact_retry", len(overflow))
                with self.metrics.timer("device"):
                    _, chains2, host_out2 = self._device_stage(
                        reads_dev, lens, big=True
                    )
                    out2 = self._fetch(host_out2)
                rows2 = _rows_by_read(out2)
                ctxs.append((out2, chains2))
                for j in overflow:
                    is_fine, selected, over2 = self._select_rows(
                        j, out2, rows2
                    )
                    selections[j] = (is_fine, [(1, k) for k in selected])
                    if over2:
                        # still no slots: run the read alone with a
                        # 512-window budget (solo row 0 in its context)
                        self.metrics.add("compact_solo", 1)
                        codes_j = seq_to_codes(batch[j].seq)
                        L_j = reads_dev.shape[1]
                        with self.metrics.timer("device"):
                            out3, chains3 = self._solo_retry(codes_j,
                                                             L_j)
                        rows3 = _rows_by_read(out3)
                        is_fine, selected, over3 = self._select_rows(
                            0, out3, rows3
                        )
                        ctxs.append((out3, chains3))
                        ci3 = len(ctxs) - 1
                        selections[j] = (is_fine,
                                         [(ci3, k) for k in selected])
                        if over3 and is_fine:
                            # >512 qualifying windows: page through the
                            # further candidate-rank windows until a
                            # page is unsaturated, then heap-select over
                            # the union — the reference chains EVERY
                            # qualifying window (src/LordFAST.cpp:874-904)
                            pairs = [(ci3, k) for k in rows3.get(0, [])]
                            sat, p = True, 1
                            while sat and p < 64:
                                self.metrics.add("compact_page", 1)
                                with self.metrics.timer("device"):
                                    outp, chainsp = self._solo_retry(
                                        codes_j, L_j, page=p
                                    )
                                rowsp = _rows_by_read(outp)
                                ctxs.append((outp, chainsp))
                                cip = len(ctxs) - 1
                                pairs += [(cip, k)
                                          for k in rowsp.get(0, [])]
                                sat = bool(outp["cand_sat"][0])
                                p += 1
                            if sat:  # >32k qualifying windows
                                self.stats["compact_overflow"] = (
                                    self.stats.get("compact_overflow",
                                                   0) + 1
                                )
                                self.metrics.log(
                                    1, "[WARNING] window paging hit the"
                                       " 64-page cap; selection may be "
                                       "truncated",
                                )
                            sel = self._fine_heap_select_multi(
                                pairs, ctxs, cfg.max_map
                            )
                            selections[j] = (is_fine, sel)
                        elif over3:
                            self.stats["compact_overflow"] = (
                                self.stats.get("compact_overflow", 0) + 1
                            )
                            self.metrics.log(
                                1, "[WARNING] read slot overflow after "
                                   "solo retry; emitted unmapped",
                            )

            self.metrics.timers["py_select"] += time.time() - t_sel
            lazy = []
            ncap = out["chain_ql"].shape[1]
            for j in range(len(idxs)):
                is_fine, selected = selections[j]
                for ci, k in selected:
                    if ci != 0:
                        continue  # retry rows fetch directly (rare)
                    n = int(out["chain_len"][k])
                    if n > ncap:
                        lazy.append((k, n))
            wide = None
            if lazy:
                with self.metrics.timer("device"):
                    wide = self._fetch_wide_rows(
                        chains_dev, [k for k, _ in lazy],
                        max(n for _, n in lazy),
                    )

            # stitch-job construction per read
            t_jb = time.time()
            jobs = []
            read_jobs = {}  # batch row -> (is_fine, [job ids or None])
            for j, i in enumerate(idxs):
                read = batch[j]
                read_len = len(read.seq)
                is_fine, selected = selections[j]
                slots = []
                fwd = rev = None
                for ci, k in selected:
                    out_j, chains_j = ctxs[ci]
                    wide_j = wide if ci == 0 else None
                    n = int(out_j["chain_len"][k])
                    if n <= 1:
                        slots.append(None)  # unmapped placeholder
                        continue
                    if fwd is None:
                        fwd = seq_to_codes(read.seq)
                        rev = revcomp_codes(fwd)
                    is_rev = bool(out_j["cw_is_rev"][k])
                    cq, ct, cl = self._chain_rows(out_j, chains_j, k, n,
                                                  wide_j)
                    chr_beg, chr_end = self.idx.chr_boundaries(
                        int(ct[0]), int(ct[n - 1])
                    )
                    job = {
                        "cq": cq, "ct": ct, "cl": cl,
                        "query": rev if is_rev else fwd,
                        "read_len": read_len, "is_rev": is_rev,
                    }
                    job["descs"] = self._gap_descriptors(
                        j, read_len, is_rev, cq, ct, cl, chr_beg, chr_end
                    )
                    slots.append(len(jobs))
                    jobs.append(job)
                read_jobs[j] = (is_fine, slots)
            self.metrics.timers["py_jobbuild"] += time.time() - t_jb

            # dispatch the gap DPs; the blocking collect happens in
            # finish() one pipeline step later, overlapping this wait
            # with the NEXT batch's host-side work
            with self.metrics.timer("gap_dp"):
                pending = self._dispatch_jobs_gaps(jobs, reads_dev)
            return (idxs, batch, jobs, read_jobs, pending)

        def finish(ctx):
            idxs, batch, jobs, read_jobs, pending = ctx
            with self.metrics.timer("gap_dp"):
                tables = self._collect_jobs_gaps(jobs, pending)

            with self.metrics.timer("stitch"):
                mappings_by_job = self._stitch_all(jobs, tables)

            for j, i in enumerate(idxs):
                read_len = len(batch[j].seq)
                is_fine, slots = read_jobs[j]
                mappings = [
                    mappings_by_job[s] if s is not None
                    else Mapping(records=[], total_score=-2 * read_len)
                    for s in slots
                ]
                # fine mode: sort by totalScore (compareSam,
                # src/LordFAST.cpp:986)
                if is_fine:
                    mappings.sort(key=lambda m: -m.total_score)
                results[i] = mappings

        # two-level software pipeline: up to `depth` device batches in
        # flight (host work of batch k overlaps device work of k+1
        # where the device stage runs ahead of the host), plus a one-step
        # stage split inside each batch — resolve() ends at the gap-DP
        # dispatch, finish() starts at its blocking collect
        depth = 2
        inflight = []
        staged = []
        for s in range(0, len(order), B):
            inflight.append(dispatch(s))
            if len(inflight) > depth:
                staged.append(resolve(*inflight.pop(0)))
                if len(staged) > 1:
                    finish(staged.pop(0))
        for item in inflight:
            staged.append(resolve(*item))
            if len(staged) > 1:
                finish(staged.pop(0))
        for ctx in staged:
            finish(ctx)

        with self.metrics.timer("emit"):
            wi = 0
            for r in chunk:
                self.stats["reads"] += 1
                if not in_range(r):
                    sam_io.emit_read(
                        out, self.idx, cfg, r.name, r.seq, r.qual, []
                    )
                    continue
                mappings = results[wi]
                wi += 1
                if mappings and mappings[0].records:
                    self.stats["mapped"] += 1
                sam_io.emit_read(
                    out, self.idx, cfg, r.name, r.seq, r.qual, mappings
                )
