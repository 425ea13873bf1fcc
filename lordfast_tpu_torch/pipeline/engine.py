"""End-to-end mapping engine on one PyTorch device.

Port of ``lordfast_tpu/pipeline/engine.py``.  Orchestrates the per-chunk
flow of the reference driver (src/baseFAST.cpp:44-82: readChunk ->
initFASTChunk -> mapSeqMT -> releaseChunk):

  device (batched over reads): seeding -> window voting -> per-window seed
  selection -> chaining DP (pipeline/device_stage.py), then the batched
  Myers distance of every inter-seed gap and read end
  (ops/gap_dp_cuda.py), and with the escalation offload on, the clip /
  split affine extensions (ops/affine.py) and their secondary Myers
  segments with path (gap_dp_cuda.myers_moves);
  host: chain stitching (native edlib-equivalent paths from the device
  distances), scoring, mode resolution (coarse vs fine,
  src/LordFAST.cpp:542-569), SAM output in input order.

The host methods are the JAX engine's; only the device seams differ.
Ported path: every seeder (the extend-whole seeder on the device, the
dormant extend-whole-2 / -3 on the host, ops/seeders.py, followed by the
device stage's post-seed part), dp-n2 and clasp chaining, a replicated
index on one device, and the escalation DPs either on the device
(``esc_device``, on by default on a CUDA device, as the JAX engine's is
on its accelerator) or in the host stitcher.

With a mesh (parallel/mesh.py: one process per device under
torch.distributed), rank 0 is the controller, as the JAX engine's single
controller is: it reads the input, runs every host stage and the gap DP
and writes the SAM.  Each device-stage call (the base pass, the 8x
retry, a solo retry page) is broadcast to the other ranks, which serve
such calls in ``map_file`` until rank 0 ends it: a header (which
pipeline, B, L, page) and the read batch, then every rank runs its B / D
rows (parallel/mesh.py, parallel/sharded_index.py) and rank 0 gets the
whole batch's host payload and chains.
"""

from __future__ import annotations

import functools
import sys
import time
from contextlib import contextmanager
from typing import List, Optional, TextIO

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..align.chain_align import Mapping, align_chain_edlib, score_mapping
from ..config import LordfastConfig
from ..index.container import FMIndex
from ..io import sam as sam_io
from ..io.fastx import Read, read_chunks
from ..ops import affine
from ..ops import fm_index as fm_ops
from ..ops import gap_dp
from ..ops import gap_dp_cuda
from ..utils.checkpoint import ChunkProgress
from ..utils.metrics import Metrics, named_range
from ..utils.pack import seq_to_codes, revcomp_codes
from .device_stage import device_pipeline, post_seed_stage
from .stitch_batch import BatchStitcher


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


# the device-stage pipelines a mesh call names in its header
_STAGES = ("base", "big", "solo")
# header ops: run a stage, end the serve loop, or fail it
_RUN, _STOP, _FAIL = 0, 1, 2


class MappingEngine:
    def __init__(self, idx: FMIndex, cfg: Optional[LordfastConfig] = None,
                 device="cuda", mesh=None, shard_index: bool = False,
                 esc_device: Optional[bool] = None,
                 plain_loops: bool = False):
        """device: the torch device of the index and the device stage
        ("cuda", "cuda:1", "cpu").  esc_device: run the clip / split
        escalation DPs on the device (_escalation_pass) instead of in
        the host stitcher; None = on for a CUDA device, off on the CPU.
        Both give the same SAM.

        mesh: a 1-D DeviceMesh with a "data" dimension
        (parallel/mesh.make_mesh), built on every rank; the read batch is
        split over its ranks with the index whole on each, and this
        rank's device is the mesh's (``device`` must name the same
        type).  cfg.batch_reads is rounded up to a multiple of the mesh
        size.  shard_index: stripe the index's row arrays over the mesh
        instead (parallel/sharded_index.py); requires mesh.

        plain_loops: run the device stage's seed-extension and chaining
        loops through their plain PyTorch versions on a CUDA device too,
        instead of the seed_ext and chain_dp kernels: the same SAM,
        slower.  For the smoke's and the tests' kernel-against-plain
        passes; on the CPU the loops are always the plain versions.  With a
        mesh, on every rank (the sharded index's loops too)."""
        self.idx = idx
        self.cfg = (cfg or LordfastConfig()).validate()
        self.meta = idx.meta
        if shard_index and mesh is None:
            raise ValueError("shard_index requires a mesh")
        self._plain_loops = plain_loops
        self._mesh = mesh
        self._shard_index = shard_index
        self._group, self._D, self._rank = None, 1, 0
        if mesh is not None:
            from ..parallel.mesh import mesh_device, mesh_group

            if torch.device(device).type != mesh.device_type:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"{mesh.device_type!r}")
            device = mesh_device(mesh)
            self._group = mesh_group(mesh)
            self._D, self._rank = self._group.size(), self._group.rank()
            B = self.cfg.batch_reads
            if B % self._D:
                self.cfg = self.cfg.replace(
                    batch_reads=-(-B // self._D) * self._D)
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
        self._esc_device = (esc_device if esc_device is not None
                            else self.device.type == "cuda")
        self.stats = {"reads": 0, "mapped": 0, "chunks": 0, "batches": 0}
        self.metrics = Metrics(verbosity=getattr(self.cfg, "verbosity", 0))
        self._batch = None  # the batch id the main thread works on
        # the host stitcher: one native call a batch (stitch_batch.py),
        # whose C++ threads (the reference's per-core pthread pool,
        # src/LordFAST.cpp:305-316; --threads / cfg.num_threads, 0 = one
        # a core) take the batch's windows in order and run stitch_chain
        # with the GIL released for the whole call; only the pack and the
        # decode run on this thread, so the GIL no longer sets the
        # stitch's pace
        import os

        self._stitcher = BatchStitcher(
            idx, self.cfg, self.cfg.num_threads or (os.cpu_count() or 1))
        if shard_index:
            from ..parallel.sharded_index import shard_index_arrays

            self.arrs = shard_index_arrays(idx, mesh)
        else:
            self.arrs = idx.device_arrays(self.device)
        self._mesh_fns = {}  # stage key -> this rank's mesh pipeline
        self._in_call = False  # inside a mesh call's collectives
        self._device_fn = device_pipeline(self.meta, self.cfg, plain_loops)
        # wide-budget pipelines for the compact-overflow retries
        # (fine-mode reads whose windows ran out of K slots; the reference
        # chains every qualifying local max, src/LordFAST.cpp:874-904):
        # 8x shared budget first, then a solo-read 512-window pipeline
        self._big_fn = None
        self._solo_fn = None

    @contextmanager
    def _span(self, name: str):
        """One engine stage: its time into the ``name`` timer and, while a
        torch profiler records, a range ``lf_<name>`` around it that
        carries the current batch id.  Main thread only."""
        with named_range(f"lf_{name}", self.device, self._batch), \
                self.metrics.timer(name):
            yield

    def _put_reads(self, arr: np.ndarray):
        return torch.from_numpy(arr).to(self.device)

    def _stage_cfg(self, key: str):
        """The config of the base, 8x-budget ("big") or solo pipeline."""
        cfg = self.cfg
        if key == "big":
            return cfg.replace(
                max_candidates=min(4 * cfg.max_candidates, 256),
                compact_windows_per_read=8 * cfg.compact_windows_per_read,
            )
        if key == "solo":
            # the solo batch has one row per rank: K = D * per-read
            # slots must reach the 512 candidate cap (ceil division)
            return cfg.replace(max_candidates=512,
                               compact_windows_per_read=-(-512 // self._D))
        return cfg

    def _fetch(self, host_out: dict) -> dict:
        """Device -> host copy of a batch's host payload (it waits for
        the device stage: timer ``device_fetch``)."""
        with self._span("device_fetch"):
            return {k: v.cpu().numpy() for k, v in host_out.items()}

    # ---- device stage ----
    def _device_stage(self, reads_dev, lens: np.ndarray, big: bool = False,
                      host_seeds=None):
        if self._mesh is not None:
            return self._mesh_call("big" if big else "base", reads_dev, lens)
        with self._span("batch_pack"):
            lens_dev = torch.from_numpy(np.asarray(lens, np.int32)).to(
                self.device)
            if host_seeds is None:
                pos = fm_ops.sample_positions_host(lens,
                                                   self.cfg.sampling_count)
                pos_dev = torch.from_numpy(pos).to(self.device)
        if host_seeds is not None:
            return post_seed_stage(self.arrs, host_seeds, reads_dev,
                                   lens_dev,
                                   self._stage_cfg("big" if big else "base"),
                                   plain=self._plain_loops)
        fn = self._get_big_fn() if big else self._device_fn
        return fn(self.arrs, reads_dev, lens_dev, pos_dev)

    def _host_seeds(self, arr: np.ndarray, lens: np.ndarray):
        """Dormant-seeder path (cfg.seeder != "extend-whole"): seed on
        the host (ops/seeders.py, timer ``host_seed``) and put the seeds
        on the device with the device seeder's dtypes, for the post-seed
        stage."""
        from ..ops.seeders import host_seed_batch

        with self._span("host_seed"):
            sb = host_seed_batch(self.idx, arr, lens, self.cfg,
                                 self.cfg.max_seeds_per_read)

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(
                self.device)

        return fm_ops.SeedBatch(
            t_pos=put(sb.t_pos, self.idx.pos_dtype),
            q_pos=put(sb.q_pos, np.int32),
            length=put(sb.length, np.int32),
            is_rev=put(sb.is_rev, bool),
            valid=put(sb.valid, bool),
            n_total=put(sb.n_total, np.int32),
            n_anchors=put(sb.n_anchors, np.int32),
        )

    def _get_big_fn(self):
        """Device pipeline with 8x the candidate/compact-window budget."""
        if self._big_fn is None:
            self._big_fn = device_pipeline(self.meta,
                                           self._stage_cfg("big"),
                                           self._plain_loops)
        return self._big_fn

    def _solo_retry(self, codes, L, page: int = 0):
        """Last-resort retry for a read whose candidate windows overflow
        even the 8x shared budget: run it ALONE through a pipeline whose
        per-read candidate cap and window slots both reach 512, so every
        qualifying window gets a chaining slot (the reference chains all
        of them, src/LordFAST.cpp:874-904).  page > 0 selects candidate
        ranks [512*page, 512*(page+1)); the caller pages until a page is
        not saturated.  Returns (out, chains_dev) with the read at batch
        row 0.  A dormant seeder seeds the read on the host again.  On a
        mesh the batch has a row for each rank, the read's and D - 1
        empty ones, as the JAX engine's has."""
        arr = np.full((self._D, L), 4, dtype=np.uint8)
        arr[0, : len(codes)] = codes
        lens = np.zeros(self._D, np.int32)
        lens[0] = len(codes)
        if self._mesh is not None:
            _, chains, host_out = self._mesh_call(
                "solo", self._put_reads(arr), lens, page)
            return self._fetch(host_out), chains
        lens_dev = torch.from_numpy(lens).to(self.device)
        if self.cfg.seeder != "extend-whole":
            _, chains, host_out = post_seed_stage(
                self.arrs, self._host_seeds(arr, lens), self._put_reads(arr),
                lens_dev, self._stage_cfg("solo"), page, self._plain_loops)
            return self._fetch(host_out), chains
        if self._solo_fn is None:
            self._solo_fn = device_pipeline(self.meta,
                                            self._stage_cfg("solo"),
                                            self._plain_loops)
        pos = fm_ops.sample_positions_host(lens, self.cfg.sampling_count)
        _, chains, host_out = self._solo_fn(
            self.arrs, self._put_reads(arr), lens_dev,
            torch.from_numpy(pos).to(self.device), page,
        )
        return self._fetch(host_out), chains

    # ---- the mesh: rank 0's device-stage calls, served by every rank --
    def _mesh_call(self, key: str, reads_dev, lens: np.ndarray,
                   page: Optional[int] = None):
        """Rank 0: broadcast a device-stage call (header, reads, lens) and
        run this rank's part of it; returns the whole batch's (seeds,
        chains, host_out), seeds this rank's."""
        B, L = reads_dev.shape
        self._in_call = True
        self._bcast([_RUN, _STAGES.index(key), B, L,
                     -1 if page is None else page])
        reads_dev = reads_dev.contiguous()
        dist.broadcast(reads_dev, self._root, group=self._group)
        lens_dev = torch.from_numpy(np.asarray(lens, np.int32)).to(
            self.device)
        dist.broadcast(lens_dev, self._root, group=self._group)
        res = self._rank_stage(key, reads_dev, lens_dev, page)
        self._in_call = False
        return res

    @property
    def _root(self) -> int:
        return dist.get_global_rank(self._group, 0)

    def _bcast(self, header):
        h = torch.tensor(header, dtype=torch.int64, device=self.device)
        dist.broadcast(h, self._root, group=self._group)
        return h.tolist()

    def _serve(self):
        """Ranks > 0: run rank 0's device-stage calls until it ends the
        loop; raise if it failed."""
        while True:
            op, key, B, L, page = self._bcast([0] * 5)
            if op == _STOP:
                return
            if op == _FAIL:
                raise RuntimeError("rank 0 of the mesh failed")
            reads = torch.empty((B, L), dtype=torch.uint8,
                                device=self.device)
            dist.broadcast(reads, self._root, group=self._group)
            lens = torch.empty(B, dtype=torch.int32, device=self.device)
            dist.broadcast(lens, self._root, group=self._group)
            self._rank_stage(_STAGES[key], reads, lens,
                             None if page < 0 else page)

    def _rank_stage(self, key: str, reads, lens, page):
        """This rank's rows of a device-stage call, through the mesh
        pipeline of ``key``'s config.  A dormant seeder seeds the rows
        on this rank's host."""
        from ..parallel import mesh as mesh_ops

        Br = reads.shape[0] // self._D
        rows = slice(self._rank * Br, (self._rank + 1) * Br)
        reads, lens = reads[rows], lens[rows]
        cfg = self._stage_cfg(key)
        lens_np = lens.cpu().numpy()
        if cfg.seeder != "extend-whole":
            seeds = self._host_seeds(reads.cpu().numpy(), lens_np)
            return mesh_ops.post_seed_stage_sharded(
                self.arrs, seeds, reads, lens, cfg, self._group, page,
                self._plain_loops)
        if key not in self._mesh_fns:
            if self._shard_index:
                from ..parallel.sharded_index import sharded_index_pipeline

                fn, _ = sharded_index_pipeline(self.idx, cfg, self._mesh,
                                               arrs=self.arrs,
                                               plain=self._plain_loops)
                self._mesh_fns[key] = functools.partial(fn, self.arrs)
            else:
                self._mesh_fns[key] = mesh_ops.sharded_pipeline(
                    self.idx, cfg, self._mesh, self._plain_loops)
        pos = fm_ops.sample_positions_host(lens_np, cfg.sampling_count)
        return self._mesh_fns[key](reads, lens,
                                   torch.from_numpy(pos).to(self.device),
                                   page)

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
        with self._span("device_fetch"):
            ridx = torch.as_tensor(rows, dtype=torch.int64,
                                   device=self.device)
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

    def _desc_tensors(self, rows):
        """Device descriptor dict of gather_gap_seqs from a list of
        (row_j, q_start, q_len, q_rc, t_start, t_len, t_rc, is_shw),
        with one host-to-device copy."""
        dm = torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(
            self.device)
        return {
            "q_read": dm[:, 0], "q_start": dm[:, 1],
            "q_len": dm[:, 2], "q_rc": dm[:, 3] != 0,
            "t_start": dm[:, 4], "t_len": dm[:, 5],
            "t_rc": dm[:, 6] != 0, "is_shw": dm[:, 7] != 0,
            "valid": torch.ones(len(rows), dtype=torch.bool,
                                device=self.device),
        }

    def _run_gap_descs(self, items, reads_dev, mode="moves"):
        """Batched device Myers DP over arbitrary gap descriptors:
        dispatch + blocking collect.  Returns {key: (dist, end, extra)}
        (see _collect_gap_descs)."""
        return self._collect_gap_descs(
            self._dispatch_gap_descs(items, reads_dev, mode))

    def _dispatch_gap_descs(self, items, reads_dev, mode="dist"):
        """Dispatch the batched device Myers DP over gap descriptors,
        without waiting for it.

        items: list of (key, desc) with desc = (row_j, q_start, q_len,
        q_rc, t_start, t_len, t_rc, is_shw) in forward-read-row / global
        genome coordinates (see _gap_descriptors).  Each gap goes to the
        first bucket (Q, T, G) that holds it and every bucket is cut into
        sub-batches of at most G gaps, one kernel launch each.

        mode "dist" (the main path): only (dist, end) come back
        (``myers_dist``, launches counted in the ``gap_parts`` metric);
        the stitcher rebuilds each path with the bit-exact banded edlib
        traceback (native edlib_path.cpp).  "moves" (escalation phase
        C): ``myers_moves`` also returns lead and the per-column codes,
        trimmed to the sub-batch's deepest target (launches counted in
        ``esc_nw_parts``).  "col" (phase C's Hirschberg splits):
        ``myers_dist`` also returns the last column's words (launches
        counted in ``esc_split_parts``).  All results are stacked into
        one device tensor (and the codes or words into one more),
        fetched by _collect_gap_descs with one device-to-host copy each.
        Descriptors larger than every bucket are omitted (the native
        stitcher computes those locally).  With verbosity >= 2 the
        ``gsz_*`` counters histogram the gap sizes and ``gpart_{mode}_
        {Q}x{T}_{n}`` counts the launches of n gaps in each bucket."""
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

        with self._span("gap_pack"):
            parts, rows, extras = [], [], []
            for bi, per in enumerate(per_bucket):
                if not per:
                    continue
                Q, T, G = buckets[bi]
                self.metrics.add(f"gaps_b{Q}", len(per))
                for s in range(0, len(per), G):
                    part = per[s : s + G]
                    if want_hist:
                        self.metrics.add(
                            f"gpart_{mode}_{Q}x{T}_{len(part)}", 1)
                    desc = self._desc_tensors([d for _, d in part])
                    qs, ql, ts, tl = gap_dp.gather_gap_seqs(
                        self.arrs["pac_words"], reads_dev, desc, Q, T,
                        self.meta["l_pac"],
                    )
                    extra = None
                    if mode == "moves":
                        dist, end, lead, colcode = gap_dp_cuda.myers_moves(
                            qs, ql, ts, tl, desc["is_shw"], Q, T)
                        self.metrics.add("esc_nw_parts", 1)
                        rows.append(torch.stack([dist, end, lead]))
                        # codes are zero past each gap's end <= t_len - 1
                        extra = colcode[: max(d[5] for _, d in part)]
                    elif mode == "col":
                        dist, end, extra = gap_dp_cuda.myers_dist(
                            qs, ql, ts, tl, desc["is_shw"], Q, T,
                            want_col=True)
                        self.metrics.add("esc_split_parts", 1)
                        rows.append(torch.stack([dist, end]))
                    else:
                        dist, end = gap_dp_cuda.myers_dist(
                            qs, ql, ts, tl, desc["is_shw"], Q, T)
                        self.metrics.add("gap_parts", 1)
                        rows.append(torch.stack([dist, end]))
                    if extra is not None:
                        extras.append(extra.reshape(-1))
                    parts.append((part, None if extra is None
                                  else tuple(extra.shape)))
            pending = None
            if parts:
                pending = (mode, parts, torch.cat(rows, 1),
                           torch.cat(extras) if extras else None)
        return pending

    def _collect_gap_descs(self, pending):
        """Blocking half of the gap DP: one device-to-host copy of every
        dispatched sub-batch's results (and one of the codes or words).
        Returns {key: (dist, end, extra)}: extra is the move array
        ("moves", the codes decoded), the (2, Q/32) last-column words
        ("col") or None ("dist")."""
        results = {}
        if pending is None:
            return results
        mode, parts, merged, flat = pending
        with self._span("gap_wait"):
            vals = merged.cpu().numpy()
            flat = flat.cpu().numpy() if flat is not None else None
        with self._span("gap_unpack"):
            off = fo = 0
            for part, shape in parts:
                g = len(part)
                extra = [None] * g
                if shape is not None:
                    n = int(np.prod(shape))
                    block = flat[fo : fo + n].reshape(shape)
                    fo += n
                    if mode == "moves":
                        extra = gap_dp.decode_col_moves(
                            block, vals[1, off : off + g],
                            vals[2, off : off + g])
                    else:
                        extra = [block[:, :, gi] for gi in range(g)]
                for gi, (key, _) in enumerate(part):
                    results[key] = (int(vals[0, off + gi]),
                                    int(vals[1, off + gi]), extra[gi])
                off += g
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
        for (job_id, slot), (dist, end, _) in results.items():
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

    # escalation sub-slot indices (per gap slot; stitch.cpp esc_* ABI)
    ESC_KSW1, ESC_KSW2, ESC_NW_A, ESC_NW_IF, ESC_NW_IR, ESC_NW_B = range(6)

    @staticmethod
    def _edlib_splits(q_len: int, t_len: int) -> bool:
        """Whether edlib aligns a q_len x t_len NW segment by Hirschberg
        splitting (its traceback data would reach 1 MiB; edlib.cpp:
        1090-1145, native edlib_path.cpp obtainAlignment).  Below that
        size edlib's banded traceback follows the unbanded DP's tie order
        (consume-query, consume-target, diagonal) — every cell of an
        optimal path lies inside its band — so myers_moves' path is
        edlib's; above it edlib first splits the segment (_run_nw_paths),
        which can pick another of the equal-cost paths."""
        blocks = -(-q_len // 64)
        return (2 * 8 + 4) * blocks * t_len + 2 * 4 * t_len >= 1 << 20

    def _run_nw_paths(self, items, reads_dev):
        """Phase C's batched device NW alignments, with the path edlib
        builds: a segment at edlib's Hirschberg size (_edlib_splits) is
        split as edlib splits it, level by level for all such segments
        at once — a forward fill of the query against the left target
        half and a reverse-complement fill against the right half give
        the middle column's scores (myers_dist with its last column,
        ``esc_split_parts``), gap_dp.hirschberg_split picks the row —
        until every piece is below that size; myers_moves then aligns
        the pieces with path, and a piece with no query codes is all
        DELETE.  The inversion's forward middle (ESC_NW_IF) needs only
        the distance and is never split.  Returns {key: (dist, end,
        moves)}; a segment larger than every gap bucket is omitted."""
        cfg = self.cfg

        def sub(d, qa, qn, ta, tn, rc=False):
            (row, q0, q_len, qrc, t0, t_len, trc, _s) = d
            q2, qrc2 = self._sub_view(q0, q_len, qrc, qa, qn, rc)
            t2, trc2 = self._sub_view(t0, t_len, trc, ta, tn, rc)
            return (row, q2, qn, qrc2, t2, tn, trc2, False)

        def splits(key, d):
            return (key[2] != self.ESC_NW_IF
                    and self._edlib_splits(d[2], d[5])
                    and any(d[2] <= Q and d[5] <= T
                            for Q, T, _ in cfg.gap_buckets))

        leaves, level, pieces, best = [], [], {}, {}
        for key, d in items:
            (level if splits(key, d) else leaves).append(((key,), d))
        while level:
            # (the reverse complement of both halves aligns like their
            # reversal: complementing codes keeps every match a match)
            fills = []
            for node, d in level:
                lhw = d[5] // 2
                fills.append((node + (0,), sub(d, 0, d[2], 0, lhw)))
                fills.append((node + (1,), sub(d, 0, d[2], lhw, d[5] - lhw,
                                               rc=True)))
            cols = self._run_gap_descs(fills, reads_dev, mode="col")
            self.metrics.add("esc_splits", len(level))
            nxt = []
            for node, d in level:
                q_len, t_len = d[2], d[5]
                lhw, rhw = t_len // 2, t_len - t_len // 2
                k, b = gap_dp.hirschberg_split(
                    gap_dp.column_scores(cols[node + (0,)][2], q_len, lhw),
                    gap_dp.column_scores(cols[node + (1,)][2], q_len, rhw),
                    lhw, rhw)
                if len(node) == 1:
                    best[node[0]] = b
                for half, c8 in ((0, sub(d, 0, k, 0, lhw)),
                                 (1, sub(d, k, q_len - k, lhw, rhw))):
                    child = node + (half,)
                    if c8[2] == 0:
                        pieces[child] = np.full(c8[5], gap_dp.OP_DELETE,
                                                np.uint8)
                    elif self._edlib_splits(c8[2], c8[5]):
                        nxt.append((child, c8))
                    else:
                        leaves.append((child, c8))
            level = nxt
        res = self._run_gap_descs(leaves, reads_dev) if leaves else {}
        for node, (_, _, mv) in res.items():
            pieces[node] = mv

        def path(node):
            if node in pieces:
                return [pieces[node]]
            return path(node + (0,)) + path(node + (1,))

        out = {node[0]: r for node, r in res.items() if len(node) == 1}
        for key, d in items:
            if key in best:
                out[key] = (best[key], d[5] - 1,
                            np.concatenate(path((key,))))
        return out

    @staticmethod
    def _sub_view(start, length, rc, a, L, extra_rc):
        """Global (start, rc) of slice [a, a+L) of the oriented view
        (start, length, rc), optionally reverse-complemented again."""
        if rc:
            return start + length - a - L, (not extra_rc)
        return start + a, extra_rc

    def _affine_desc(self, part):
        """Device descriptor dict of affine.extend_from_desc for a list of
        (key, desc8, kind) escalation items: the gather fields plus the
        reference's clip (src/LordFAST.cpp:1848) or split (:1971)
        parameter set per problem, h0 = query length, w_eff clamped in
        exact double arithmetic (affine.clamp_band)."""
        cfg = self.cfg
        d8 = np.asarray([d for _, d, _ in part], dtype=np.int64)
        clip = np.array([kind == "clip" for _, _, kind in part])
        sel = lambda a, b: np.where(clip, a, b)
        od = sel(cfg.ksw_gap_open_clip, cfg.split_o_del)
        ed_ = sel(cfg.ksw_gap_extend_clip, cfg.split_e_del)
        oi = sel(cfg.ksw_gap_open_clip, cfg.split_o_ins)
        ei = sel(cfg.ksw_gap_extend_clip, cfg.split_e_ins)
        w = sel(cfg.clip_band, cfg.split_band)
        qn = d8[:, 2]
        w_eff = affine.clamp_band(qn, cfg.ksw_match_clip, 0, od, ed_, oi,
                                  ei, w)
        g = len(part)
        par = np.stack([
            od, ed_, oi, ei, w_eff, sel(cfg.clip_zdrop, cfg.split_zdrop),
            qn, np.full(g, cfg.ksw_match_clip),
            np.full(g, cfg.ksw_mismatch_clip),
        ]).astype(np.int32)                       # PARAM_NAMES order
        pm = torch.from_numpy(par).to(self.device)
        desc = self._desc_tensors(d8)
        desc.update({n: pm[i] for i, n in enumerate(affine.PARAM_NAMES)})
        return desc

    def _run_affine_descs(self, items, reads_dev):
        """Batched device ksw_extend2 over escalation descriptors.

        items: list of (key, desc8, kind) with desc8 = (row, qa, qn, qrc,
        ta, tn, trc, shw) and kind in {"clip", "split"} selecting the
        reference's parameter set (src/LordFAST.cpp:1848 vs :1971).  One
        launch per sub-batch of an affine bucket (counted in
        ``esc_affine_parts``), one device-to-host copy for all.  Returns
        {key: (score, qle, tle)}; oversized sites are omitted (the
        stitcher runs them locally)."""
        cfg = self.cfg
        w_max = max(cfg.clip_band, cfg.split_band)
        BW = 128 * ((2 * w_max + 2 + 127) // 128)
        per = [[] for _ in cfg.affine_buckets]
        n_host = 0
        for it in items:
            qn, tn = it[1][2], it[1][5]
            for bi, (Qe, Te, _) in enumerate(cfg.affine_buckets):
                if qn <= Qe and tn <= Te:
                    per[bi].append(it)
                    break
            else:
                n_host += 1
        if n_host:
            self.metrics.add("esc_host", n_host)

        parts, outs = [], []
        for bi, group in enumerate(per):
            if not group:
                continue
            Qe, Te, G = cfg.affine_buckets[bi]
            self.metrics.add(f"esc_b{Qe}", len(group))
            for s in range(0, len(group), G):
                part = group[s : s + G]
                res = affine.extend_from_desc(
                    self.arrs["pac_words"], reads_dev,
                    self._affine_desc(part), Qe, Te, BW, w_max,
                    self.meta["l_pac"])
                self.metrics.add("esc_affine_parts", 1)
                parts.append(part)
                outs.append(torch.stack([res.score, res.qle, res.tle]))

        results = {}
        if parts:
            with self._span("esc_wait"):
                vals = torch.cat(outs, 1).cpu().numpy()
            off = 0
            for part in parts:
                for gi, (key, _, _) in enumerate(part):
                    results[key] = (int(vals[0, off + gi]),
                                    int(vals[1, off + gi]),
                                    int(vals[2, off + gi]))
                off += len(part)
        return results

    def _escalation_sites(self, jobs, tables):
        """Phase B's site test: every plain-path site whose device gap
        result trips the stitcher's clip rule (SHW ends: q_len >
        clip_len and sim < clip_sim) or split rule (|q_len - t_len| >=
        split_len and sim < split_sim), with sim = 1 - dist / q_len in
        float32 as src/LordFAST.cpp:1846,1952 compute it.  Returns the
        affine items in job and site order: a clip site gives one
        (key, desc8, "clip"), a split site two ("split", the second one
        over the reverse-complemented pair)."""
        cfg = self.cfg
        E = self
        sites = [(job_id, d) for job_id, job in enumerate(jobs)
                 if job_id in tables for d in job["descs"]
                 if tables[job_id][0][d[0]]]
        if not sites:
            return []
        dist = np.array([tables[j][1][d[0]] for j, d in sites], np.float32)
        q_len = np.array([d[3] for _, d in sites], np.int64)
        t_len = np.array([d[6] for _, d in sites], np.int64)
        shw = np.array([bool(d[8]) for _, d in sites])
        sim = (np.float32(1.0) - dist / q_len.astype(np.float32)).astype(
            np.float64)
        clip = shw & (q_len > cfg.clip_len) & (sim < cfg.clip_sim)
        split = (~shw & (np.abs(q_len - t_len) >= cfg.split_len)
                 & (sim < cfg.split_sim))
        aff = []
        for i in np.flatnonzero(clip | split):
            job_id, d = sites[i]
            slot, d8 = d[0], d[1:]
            if clip[i]:
                aff.append(((job_id, slot, E.ESC_KSW1), d8, "clip"))
                continue
            aff.append(((job_id, slot, E.ESC_KSW1), d8, "split"))
            (row, qa, qn, qrc, ta, tn, trc, _s) = d8
            aff.append(((job_id, slot, E.ESC_KSW2),
                        (row, qa, qn, not qrc, ta, tn, not trc, _s),
                        "split"))
        return aff

    def _escalation_pass(self, jobs, tables, reads_dev):
        """Device offload of the clip / split escalation DPs.

        Phase B: replay the stitcher's escalation decisions
        (_escalation_sites) against the plain-path gap results, batching
        every flagged site into the affine kernel.  Phase C: the
        secondary NW segments the affine ends imply (clip-trimmed prefix,
        split part1/part2, inversion middle forward and reverse,
        src/LordFAST.cpp:1850,1998-2093,2034-2077) run through the
        batched Myers kernel with path, those edlib would split by
        Hirschberg split first as edlib splits them (_run_nw_paths).
        Every shipped result is exact vs the stitcher's local DP, so
        partial coverage is safe — the stitcher computes any missing
        piece itself.  Returns {job_id: (has, a, b,
        moves, offsets)}, the stitcher's escalation tables (6 sub-slots
        per gap slot)."""
        E = self  # sub-slot constants
        aff = self._escalation_sites(jobs, tables)
        if not aff:
            return {}
        self.metrics.add("esc_sites", len(aff))
        with self._span("esc_affine"):
            aff_res = self._run_affine_descs(aff, reads_dev)

        # ---- phase C: secondary NW descriptors ----
        def nw_desc(d8, qa_off, qL, qX, ta_off, tL, tX):
            (row, qa, qn, qrc, ta, tn, trc, _s) = d8
            q2, qrc2 = self._sub_view(qa, qn, qrc, qa_off, qL, qX)
            t2, trc2 = self._sub_view(ta, tn, trc, ta_off, tL, tX)
            return (row, q2, qL, qrc2, t2, tL, trc2, False)

        by_site = {}
        for key, d8, kind in aff:
            job_id, slot, sub = key
            by_site.setdefault((job_id, slot), {})[sub] = (d8, kind)
        nw_items = []
        esc_vals = {}  # key -> (a, b) for the ksw subs
        for (job_id, slot), subs in by_site.items():
            d8, kind = subs[E.ESC_KSW1]
            q_len, t_len = d8[2], d8[5]
            k1 = (job_id, slot, E.ESC_KSW1)
            if k1 not in aff_res:
                continue
            _, qle1, tle1 = aff_res[k1]
            esc_vals[k1] = (qle1, tle1)
            if kind == "clip":
                if 0 < qle1 < q_len and tle1 >= 1:
                    nw_items.append(((job_id, slot, E.ESC_NW_A),
                                     nw_desc(d8, 0, qle1, False, 0, tle1,
                                             False)))
                continue
            k2 = (job_id, slot, E.ESC_KSW2)
            if k2 not in aff_res:
                continue
            _, qle2, tle2 = aff_res[k2]
            esc_vals[k2] = (qle2, tle2)
            if not (qle1 < q_len - qle2 or tle1 < t_len - tle2):
                continue  # degenerate split: stitcher takes plain path
            if qle1 >= 1 and tle1 >= 1:
                nw_items.append(((job_id, slot, E.ESC_NW_A),
                                 nw_desc(d8, 0, qle1, False, 0, tle1,
                                         False)))
            mid_r = q_len - qle1 - qle2
            mid_t = t_len - tle1 - tle2
            if mid_r > 0 and mid_t > 0:
                nw_items.append(((job_id, slot, E.ESC_NW_IF),
                                 nw_desc(d8, qle1, mid_r, False, tle1,
                                         mid_t, False)))
                nw_items.append(((job_id, slot, E.ESC_NW_IR),
                                 nw_desc(d8, qle1, mid_r, True, tle1,
                                         mid_t, False)))
            if qle2 >= 1 and tle2 >= 1:
                nw_items.append(((job_id, slot, E.ESC_NW_B),
                                 nw_desc(d8, q_len - qle2, qle2, True,
                                         t_len - tle2, tle2, True)))
        nw_res = self._run_nw_paths(nw_items, reads_dev) if nw_items \
            else {}

        # ---- assemble per-job escalation tables ----
        esc = {}

        def etab(job_id):
            t = esc.get(job_id)
            if t is None:
                ns = (len(jobs[job_id]["cq"]) + 1) * 6
                t = {"has": np.zeros(ns, np.uint8),
                     "a": np.zeros(ns, np.int64),
                     "b": np.zeros(ns, np.int64),
                     "mv": [None] * ns}
                esc[job_id] = t
            return t

        for (job_id, slot, sub), (a, b) in esc_vals.items():
            t = etab(job_id)
            i = slot * 6 + sub
            t["has"][i] = 1
            t["a"][i] = a
            t["b"][i] = b
        for (job_id, slot, sub), (dist, _end, moves) in nw_res.items():
            t = etab(job_id)
            i = slot * 6 + sub
            t["has"][i] = 1
            t["a"][i] = dist
            t["b"][i] = len(moves)
            t["mv"][i] = moves

        out = {}
        for job_id, t in esc.items():
            ns = len(t["has"])
            off = np.zeros(ns, np.int64)
            bufs = []
            pos = 0
            for i in range(ns):
                if t["mv"][i] is not None:
                    off[i] = pos
                    bufs.append(t["mv"][i])
                    pos += len(t["mv"][i])
            mvbuf = (np.concatenate(bufs) if bufs
                     else np.zeros(0, np.uint8))
            out[job_id] = (t["has"], t["a"], t["b"], mvbuf, off)
        return out

    def _stitch_all(self, jobs, tables, esc_tables) -> List[Mapping]:
        """Stitch every selected window of the batch in one native call
        (BatchStitcher), then, on this thread, each window that overflowed
        its capacity (align_chain_native's, so a second native call would
        overflow too) through the Python stitcher, the route
        align_and_score takes after such an overflow.  Counts
        stitch_batched (the windows the call stitched) and
        stitch_batch_calls.  While a torch profiler records, the call
        also fills a row of the stitch accounting a window
        (native.TRACE_FIELDS, then the window's wall ns in its thread and
        the thread's CPU ns outside stitch_chain), summed here into the
        stitch_* timers and counters (_account_stitch); the overflowed
        windows' Python stitch is not in it."""
        if not jobs:
            return []
        acc = None
        if torch.autograd.profiler._is_profiler_enabled:
            acc = np.zeros((len(jobs), len(native.TRACE_FIELDS) + 2),
                           np.int64)
        mappings = self._stitcher.stitch(jobs, tables, esc_tables, acc,
                                         span=self._span)
        self.metrics.add("stitch_batch_calls", 1)
        self.metrics.add("stitch_batched",
                         sum(m is not None for m in mappings))
        for jid, m in enumerate(mappings):
            if m is None:
                job = jobs[jid]
                m = mappings[jid] = align_chain_edlib(
                    job["cq"], job["ct"], job["cl"], job["query"],
                    job["read_len"], job["is_rev"], self.idx, self.cfg)
                score_mapping(m, job["read_len"], job["is_rev"], self.cfg)
        for job, m in zip(jobs, mappings):
            if len(m.records) > 1:
                self.metrics.add("splits", len(m.records) - 1)
                base = 16 if job["is_rev"] else 0
                self.metrics.add(
                    "inversions",
                    sum(1 for r in m.records if (r.flag & 16) != base),
                )
        if acc is not None:
            self._account_stitch(acc.sum(axis=0))
        return mappings

    def _account_stitch(self, tot) -> None:
        """Add one batch's summed stitch accounting (_stitch_all) to the
        metrics, in seconds: stitch_native (inside stitch_chain),
        stitch_rebuild (its path rebuilds, edlib_band_path),
        stitch_local_dp (its local nw_align / shw_best_end / sw_extend),
        stitch_py (the threads' CPU time outside stitch_chain: the
        reference slice and the copy-out) and stitch_wait (the rest of
        their wall time, on no core), so that py + native + wait is the
        threads' wall time over their windows; and the counters
        stitch_windows, stitch_rebuilds, stitch_rebuild_fallback,
        stitch_local_dps, stitch_local_cells and stitch_overflow (windows
        that overflowed the batch call's capacity)."""
        f = dict(zip(native.TRACE_FIELDS + ("wall_ns", "py_ns"),
                     tot.tolist()))
        t = self.metrics.timers
        t["stitch_native"] += f["native_ns"] / 1e9
        t["stitch_rebuild"] += f["rebuild_ns"] / 1e9
        t["stitch_local_dp"] += f["local_dp_ns"] / 1e9
        t["stitch_py"] += f["py_ns"] / 1e9
        t["stitch_wait"] += (f["wall_ns"] - f["native_ns"] - f["py_ns"]) / 1e9
        for name, key in (("stitch_windows", "windows"),
                          ("stitch_rebuilds", "rebuilds"),
                          ("stitch_rebuild_fallback", "rebuild_fallback"),
                          ("stitch_local_dps", "local_dps"),
                          ("stitch_local_cells", "local_cells"),
                          ("stitch_overflow", "overflow")):
            self.metrics.add(name, f[key])

    @staticmethod
    def _rows_by_read(out):
        """{batch row: [compact-window rows of the read]} of a payload."""
        rows = {}
        cw_valid = out["cw_valid"]
        cw_read = out["cw_read_idx"]
        for k in range(len(cw_valid)):
            if cw_valid[k]:
                rows.setdefault(int(cw_read[k]), []).append(k)
        return rows

    def _select_batch(self, idxs, batch, reads_dev, lens, seeds, out,
                      chains_dev):
        """Window selection for every read of a batch from its fetched
        payload ``out``, escalating reads whose windows overflowed
        through the 8x-budget and solo pipelines (_select_rows).  Returns
        (selections, ctxs): selections[j] = (is_fine, [(ctx_id, row),
        ...]) and ctxs the device contexts [(payload, chains)] the ids
        name."""
        cfg = self.cfg
        rows_by_read = self._rows_by_read(out)

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
            with self._span("device"):
                _, chains2, host_out2 = self._device_stage(
                    reads_dev, lens, big=True, host_seeds=seeds
                )
                out2 = self._fetch(host_out2)
            rows2 = self._rows_by_read(out2)
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
                    with self._span("device"):
                        out3, chains3 = self._solo_retry(codes_j,
                                                         L_j)
                    rows3 = self._rows_by_read(out3)
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
                            with self._span("device"):
                                outp, chainsp = self._solo_retry(
                                    codes_j, L_j, page=p
                                )
                            rowsp = self._rows_by_read(outp)
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

        return selections, ctxs

    def _build_jobs(self, idxs, batch, selections, ctxs, wide):
        """The stitch jobs of a batch's selected windows (_select_batch),
        each with its gap descriptors.  Returns (jobs, read_jobs):
        read_jobs[j] = (is_fine, [job id, or None for an unmapped
        placeholder, per selected window])."""
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
        return jobs, read_jobs

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
        records (chunk_id, byte_start, byte_end) per completed chunk.

        On a mesh every rank calls map_file: rank 0 maps, and the other
        ranks serve its device-stage calls and ignore the arguments.  A
        failure on rank 0 between calls ends the others' loop with an
        error; inside a call, the others fail in the collective it left
        (when its process exits, or at the group's timeout)."""
        if self._mesh is None:
            return self._map_file(seq_path, out, command_line, progress,
                                  process_index, num_processes)
        if self._rank != 0:
            return self._serve()
        try:
            self._map_file(seq_path, out, command_line, progress,
                           process_index, num_processes)
        except BaseException:
            if not self._in_call:
                self._bcast([_FAIL, 0, 0, 0, 0])
            raise
        self._bcast([_STOP, 0, 0, 0, 0])

    def _map_file(self, seq_path, out, command_line, progress,
                  process_index, num_processes):
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

        chunks = enumerate(read_chunks(seq_path, cfg.chunk_bytes))
        while True:
            with self._span("read_parse"):
                item = next(chunks, None)
            if item is None:
                break
            chunk_id, chunk = item
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

        # each batch's id (the engine's running batch count) travels with
        # it through the pipeline and is the args of its stages' ranges
        def dispatch(s):
            idxs = order[s : s + B]
            batch = [work[i] for i in idxs]
            self.stats["batches"] += 1
            bid = self._batch = self.stats["batches"]
            with self._span("batch_pack"):
                L = _pad_to_bucket(max(len(r.seq) for r in batch))
                # the batch is padded to B rows, as in the JAX engine
                arr = np.full((B, L), 4, dtype=np.uint8)
                lens = np.zeros(B, dtype=np.int32)
                for j, r in enumerate(batch):
                    codes = seq_to_codes(r.seq)
                    arr[j, : len(codes)] = codes
                    lens[j] = len(codes)
                # ship reads once; the same device buffer feeds the
                # seeding stage and the gap-DP gathers (no second upload)
                reads_dev = self._put_reads(arr)
            # a dormant seeder seeds the batch once, on the host; the 8x
            # retry reuses its seeds (on a mesh each rank seeds its rows)
            seeds = (self._host_seeds(arr, lens)
                     if cfg.seeder != "extend-whole" and self._mesh is None
                     else None)
            with self._span("device"):
                _, chains_dev, host_out = self._device_stage(
                    reads_dev, lens, host_seeds=seeds)
            return (bid, idxs, batch, reads_dev, lens,
                    (chains_dev, host_out), seeds)

        def resolve(bid, idxs, batch, reads_dev, lens, dev, seeds):
            # one device->host transfer per batch, trimmed on device
            # (seeds and full chains stay on device)
            self._batch = bid
            chains_dev, host_out = dev
            with self._span("device"):
                out = self._fetch(host_out)
            for name in ("seeds", "candidates", "fine_reads",
                         "chained_windows"):
                self.metrics.add(name, int(out[f"stat_{name}"]))
            with self._span("py_select"):
                selections, ctxs = self._select_batch(
                    idxs, batch, reads_dev, lens, seeds, out, chains_dev)

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
                with self._span("device"):
                    wide = self._fetch_wide_rows(
                        chains_dev, [k for k, _ in lazy],
                        max(n for _, n in lazy),
                    )

            with self._span("py_jobbuild"):
                jobs, read_jobs = self._build_jobs(idxs, batch, selections,
                                                   ctxs, wide)

            # dispatch the gap DPs; the blocking collect happens in
            # finish() one pipeline step later, overlapping this wait
            # with the NEXT batch's host-side work
            with self._span("gap_dp"):
                pending = self._dispatch_jobs_gaps(jobs, reads_dev)
            return (bid, idxs, batch, jobs, read_jobs, reads_dev, pending)

        def finish(ctx):
            bid, idxs, batch, jobs, read_jobs, reads_dev, pending = ctx
            self._batch = bid
            with self._span("gap_dp"):
                tables = self._collect_jobs_gaps(jobs, pending)

            esc_tables = {}
            if self._esc_device:
                with self._span("esc_dp"):
                    esc_tables = self._escalation_pass(jobs, tables,
                                                       reads_dev)

            with self._span("stitch"):
                mappings_by_job = self._stitch_all(jobs, tables, esc_tables)

            with self._span("assemble"):
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

        self._batch = None
        with self._span("emit"):
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
