#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (lordfast_tpu_torch) on one GPU.

    python3 chip_smoke.py [--mesh | --against DIR]

(``--mesh``: phases 1, 3, 5 and 10 only, for a host of several cards;
``--against DIR``: the loop kernels of this checkout against those of
the checkout at DIR, timed in turns, see ``compare_loops``: chain_dp and
seed_ext at v2's call, chain_dp on full windows, sa_locate at v2's call
over its SA sliced to 32, at the 300 Mbp and 1.2 Gbp genomes' and on
their 1,048,576 rows; the sharded kernels on sharded passes' recorded
calls, each loop's first call under the profiler and four passes with
each checkout's sharded loops, see ``compare_shard``.)
Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch/CUDA versions, the card's name, power limit and
   maximum SM clock, and the builds (the four CUDA kernel libraries,
   one nvcc each, started together, with ptxas's register and stack
   lines, and each ``myers`` and ``affine_warp_kernel`` instantiation's
   registers, stack and spills: a warp-per-gap Myers instantiation, an
   affine one (K = 1..8), or a ``chain_dp_kernel`` or
   ``seed_ext_kernel`` one with a stack frame or a spill fails; the
   native host library) with their seconds (a ``sa_locate_kernel``
   instantiation with a stack frame or a spill fails too);
2. kernels against plain, each with its time (CUDA events: the kernel's
   mean over 5 launches queued behind a spin kernel, so that the
   wrapper's host time is hidden; one plain PyTorch pass on the card)
   and its bound:
   - ``myers_dist``: for every gap bucket (Q, T, G) of
     LordfastConfig().gap_buckets, G ragged random gaps (NW and SHW,
     with the word-boundary, lane-boundary, negative-end, short-target
     and length-1 cases) through the kernel and the plain version on the
     card and on the CPU; dist/end and the last column's words equal
     exactly; after phase 5, each bucket the v2 pass launched is timed
     again at the median G of its launches there;
   - ``myers_moves``: the same gaps; dist, end, lead and colcode equal
     exactly on the card and on the CPU, the decoded move arrays equal,
     and dist/end equal to ``myers_dist``'s;
   - ``affine_extend``: for every affine bucket (Qe, Te, G) of
     LordfastConfig().affine_buckets, G problems mixing the clip and
     split parameter sets, related pairs with indels, junk pairs, z-drop
     cases and qlen at Qe, at the engine's w_max = 100 (K = 7 slots a
     lane); then at (512, 544) with w_max = 15, 40 and 100 (K = 1, 3,
     7), w_eff on lane edges and tlen = 0 and 1 (against the plain
     version on the CPU); all six outputs equal exactly; after phase 5,
     each bucket the v2 pass launched is timed again at its median part
     size there (from the ``esc_b*`` counters);
   - after phase 5, the device stage's loop kernels, on the first call
     each that the golden, v1 and v2 passes made (recorded by
     ``record_loops``): ``chain_dp`` on the windows those passes
     chained, with the dp-n2 and the clasp cost, against the plain
     full-width DP on the card (the float bits of dp, prev and every
     chain field equal), and ``seed_ext`` on their lanes against
     ``_staged_ext`` on the card (every lane's k, l, m, rpos and rflag
     equal), then on golden's reads over a sampled-SA index (sa_intv 32)
     and over the split rank layout (occ_cp + bwt_blocks), with the full
     SA and the sampled one; each kernel timed at v2's call against its
     plain version (``_chain_bucketed``, ``_staged_ext``), with its
     bound from the run's inputs (chain_dp: its pairs' integer and float
     operations or its bytes, chain_work; seed_ext: the input pieces its
     lanes need, each once, from the kernel's bitmap, over the HBM rate,
     seed_work), seed_ext's warp efficiency, the issued extension steps,
     walk steps and compare round trips of its warp with the most steps,
     and from the kernel's timers the warp that ends last (when, when it
     left the extension, its steps); and chain_dp on 1024 full windows of
     512 seeds (both costs, bit-equal, timed, with its bound);
   - ``sa_locate`` (the locate walk of a sampled SA) against the plain
     ``sa_lookup`` on the card, on the locate of golden's reads over the
     sampled-SA golden index and on the first locate call of phase 11's
     v2 passes at sa_intv 32 and 16, each with edge lanes (the primary
     row, sampled rows, row seq_len, invalid lanes), in both rank
     layouts and with int32 and int64 sa_samp: every position equal;
     the walks' steps, longest walk and warp efficiency under the lane
     queue (a diagnostic instantiation's per-warp counts), timed at
     sa_intv 32 against one plain pass, with its bound (the rank-row
     pieces and SA entries its walks need, each once, from the kernel's
     bitmap, and the lanes' own bytes, over the HBM rate) and its
     latency floor (the longest walk's steps times the ns of a
     dependent load over a buffer of the rank arrays' size:
     ``chase_ns``, a one-thread pointer chase);
   - the 2.2 Gbp layout of tools/torch_g2200.py (GRCh38's chr1-chr13,
     l_pac 2,191,407,310), with no index (``phase_g2200_layout``, ~7
     s): its forward text as packed words from a seeded generator on
     the card; gap descriptors at targets around forward coordinate
     2**31, across the last contig edge and at the genome's end, both
     orientations: ``gather_gap_seqs`` in two gap buckets and the
     affine bucket's gather equal to a numpy decode, ``myers_dist`` and
     ``extend_from_desc`` (``affine_extend``) on them equal to their
     plain versions; voting, compaction and window selection over seeds
     past 2**31 and the 13 contigs' tables equal between the card and
     the CPU, field by field;
3. golden: MappingEngine(device="cuda") on tests/data (the golden test's
   config, the escalation offload on by default); the SAM must equal
   tests/data/golden.sam byte for byte, the offload must have fired, and
   each kernel's launches must equal the sub-batches its stage counted;
   then 40 segments of the golden reference, most at edlib's Hirschberg
   size, aligned by the offload's phase-C path on the card (Hirschberg
   splits from myers_dist's last column, myers_moves on the pieces) give
   native edlib's paths; a pass of an engine with ``plain_loops=True``
   (the seed-extension and chaining loops through their plain PyTorch
   versions) gives the same SAM;
4. v1: the repo's v1 bench dataset (bench.gen_dataset(easy=True): a 28
   Mbp genome, 512 PacBio-CLR-like reads of 2-20 kb at ~12% error),
   indexed at the default config and mapped on the card twice with the
   offload on and once with it off, in one call; the three SAMs equal;
   at least 95% of the reads mapped; every read's records equal the JAX
   package's (tests/data/jax_sam_digests.json, a sha256 a read, made on
   the CPU by tools/torch_jax_sams.py); two passes of a plain_loops
   engine give the same SAM (the second timed beside the kernels' warm
   pass); the first 32 reads mapped again on the CPU give the same SAM;
5. v2: bench.gen_dataset(easy=False) — the same genome with 120 implanted
   2 kb repeat families, plus 40 SV/clip reads and 8 junk reads — at the
   default config: two passes with the offload on (the SAM repeats) and
   one with it off (the same SAM); the Hirschberg split fired; the stage
   counters equal the JAX package's on the same data, and every read's
   records its digest; two passes of a plain_loops engine give the same
   SAM; the 48 SV/junk reads mapped on the CPU (plain versions, offload
   on) give the same records;
6. clasp: v2 with ``chain_alg="clasp"`` at the default config, two
   passes with the offload on and one with it off (the same SAM, not
   dp-n2's); the SV/junk reads on the CPU give the same records;
7. dormant seeders (host seeding, then the device stage's post-seed
   part): extend-whole-3 on the first 64 v1 reads at the default config
   (the first 16 on the CPU give the same records) and extend-whole-2 on
   golden at the golden config with sampling_count 100 (the CPU gives
   the same SAM), with the host seeding seconds a read;
8. profile: one warm v2 pass of phase 5's engine under
   ``utils.metrics.profiler_trace``; its SAM equals phase 5's, and its
   Chrome trace holds the ranges lf_seed, lf_vote, lf_select and lf_chain
   and the Myers, affine, chain_dp and seed_ext kernels; the device busy
   share (the union of the CUDA kernels' time over the pass), the kernel
   count and the top five kernels by self CUDA time; then the same for
   one pass of phase 5's plain_loops engine;
9. multi-process: two ``python -m lordfast_tpu_torch.cli`` processes on
   the card (--numProcesses 2 --coordinator localhost:<free port>, a
   gloo group) map the golden fixture's chunks and process 0 merges
   them; the merged SAM equals a single-process run's, @PG aside;
10. mesh and sharded index: ranks started as processes of this script
   (``--mesh-rank``), one process per rank, each on a group that the
   script sets up before it builds the mesh (parallel/mesh.make_mesh):
   - NCCL at D = torch.cuda.device_count(), one rank per card:
     MappingEngine(mesh=..., shard_index=True) and mesh= alone (the
     index whole on every rank) on golden at the golden config and on
     the whole of v2 at the default config; each SAM equals golden.sam
     (records) or phase 5's SAM (byte for byte);
   - gloo at D = 2 on card 0 (two ranks on one card, which NCCL does
     not allow), so that the sharded index's routed gathers run between
     two ranks on CUDA tensors: shard_index=True on golden and on the
     first 64 v2 reads, equal to golden.sam and to phase 5's records of
     those reads;
   with each rank's bytes of the striped arrays against the replicated
   index's and its peak device memory, each pass's seconds and rank 0's
   stage timers beside the replicated pass's (rank 0 of the NCCL job
   also maps golden and v2 with no mesh, and phases 3 and 5's warm
   passes), and rank 0's kernel launches, which must equal the
   sub-batches its engine counted;
   - a sharded pass seeds through csrc/seed_shard.cu's four kernels
     (shard_bucket, shard_answer, shard_ext_step and, with a sampled SA,
     shard_walk_step), all of which must launch while the plain sharded
     loops (fm_index._shard_ext, _shard_walk) are not entered; a
     plain_loops pass the reverse; each pass's sharded device calls,
     blocks, redone blocks and host reads are printed, and the reads must
     be one a block, one a redone block, one sizing each loop and two an
     exact gather;
   - v2 over its SA sliced to 32, sharded: at NCCL two passes (== phase
     5's SAM), each kernel held to its plain version bit for bit on its
     first call of the first pass, and each step kernel also on its
     first list steps below 10% and 1% of its lanes live (found after
     the pass, replaying the loops' first calls), with the list
     reversed (record_shard, check_shard_kernels), and timed, with its
     bound by bytes (shard_work) and a step kernel's latency floor
     (step_floor); a plain_loops pass of the first 64 reads; at gloo
     D = 2 the first 64 reads, the kernels checked on both ranks;
11. v2 sampled (run right after phase 5): phase 5's config over v2's
   index with the SA sliced to 32, then 16 (``slice_sa``: no second
   build), two passes each and a plain_loops pass, every SAM byte-equal
   to phase 5's full-SA SAM, with the warm pass's seconds and device
   timer beside phase 5's;
12. 300 Mbp (run while the 1.2 Gbp build goes on): a seeded random
   genome of 300,000,000 bases, indexed with the port's builder at
   LordfastConfig(), which samples its SA at 32 and keeps int32
   positions (a ``--build-bench g300`` process, started with v1's and
   v2's; its seconds and peak RSS), 512 reads of
   ``bench.gen_gbp_reads``: two passes (the SAM repeats, >= 95% mapped),
   a plain_loops pass and the first 16 reads on the CPU (the same
   records), and sa_locate on its first locate call and on 1,048,576
   seeded rows with every edge row (more than the card holds lanes at
   once: the lane queue's case), each bit-equal, timed, with its bound
   and its latency floor (a pointer chase over the index's 1.26 GB of
   rank rows); then the 300 Mbp index sharded at NCCL D = 1 in this
   process (phase_g300_mesh: two passes == the replicated SAM, a
   plain_loops pass of 64 reads);
13. 1.2 Gbp (run last): a seeded random genome of 1,200,000,000 bases
   in one contig, indexed with the port's builder at LordfastConfig(),
   which gives it int64 positions (seq_len 2.4e9 >= 2**31 - 1) and
   samples its SA at 32 (a ``--build-bench g1200`` process started
   before phase 1, or, when the host has less RAM available than the
   builds take at their peaks, once v1's and v2's have ended; its
   seconds by stage and its peak RSS), 512 reads of
   ``bench.gen_gbp_reads``: the index's and the card's position arrays
   int64; two passes (the SAM repeats, >= 95%
   mapped), the truth check (each read's primary record on the strand
   and span that gbp_origins replays from the generator's RNG, for >=
   95% of all reads and of the >= 40 forward reads located at text
   positions >= 2**31), a plain_loops pass and the first 16 reads on the
   CPU (the same records); the first seed_ext, sa_locate and chain_dp
   calls, their inputs int64 and holding positions >= 2**31 (chain_dp's
   windows, forward coordinates below l_pac, are also moved by 2**32),
   each bit-equal to its plain version and timed with its bound
   (check_int64_loops; sa_locate with its latency floor from a pointer
   chase over the rank rows), and sa_locate on 1,048,576 seeded rows with
   every edge row (more than the card holds lanes at once: the lane
   queue's case); the high reads (58) sharded at NCCL D = 1 in this
   process (phase_gbp_mesh, the Pos = int64_t instances of
   seed_shard.cu: a pass with each kernel held to its plain version on
   its first call, and a plain_loops pass, each == the replicated
   records); then dp-n2's log on v1, v2 and the two random genomes
   (every chain call of their first pass): the linked pairs with d >=
   65,536 and with a d at which torch.log differs from the C library's
   log (on the host CPU or on the card), and the largest d against the
   log table's length (``phase_log_counts``).

Phases 4 and 5 run the engine at verbosity 2, which adds the
``gpart_*`` counters (launches per bucket and part size) and prints them
with the ``gaps_b*`` counters.  Every kernel's launch count, and the
entry counts of the loops chain_dp and seed_ext replace
(``chain._chain_bucketed``, ``fm_index._staged_ext``), are set to 0
just before each pass of phases 3-8 and 10 and read just after; a
kernel a path needs that did not launch there is a failure, and so is a
gap or affine kernel's count that differs from the sub-batches the
engine counted, and an entry into either loop on cuda (a plain_loops
pass must enter both and launch neither kernel).  With a sampled SA
(phases 11-13) sa_locate must launch once a device call (as often
as seed_ext) and the plain walk (``fm_index.sa_lookup``, counted on
entry) must not run; a plain_loops pass does the reverse; a full-SA
pass does neither.  The host seeders of phase 7 seed without seed_ext,
and the sharded index of phase 10 through the shard kernels.  Then a
line with the
kernel table (JSON), the nvidia-smi line, and last the contract line
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is available.  The datasets are cached in .smoke_cache/
(gitignored).  The v1, v2, 300 Mbp and 1.2 Gbp datasets and their
indexes are made there by four processes of their own (``chip_smoke.py
--build-bench v1|v2|g300|g1200``), g1200's first and the others after
phase 1; they run on the host while the card runs the phases before the
one that loads each saved index.  The kernel table's ``launches`` is
each kernel's count on v2's first pass, sa_locate's on the 1.2 Gbp
genome's, and its seed_ext, sa_locate and chain_dp rows carry their
g1200_* times at 64 bits (sa_locate also its g300_* times); the four
shard kernels' on the first sharded pass of v2 over its SA sliced to 32
at NCCL.
"""

from __future__ import annotations

import gc
import io
import itertools
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
CACHE = ROOT / ".smoke_cache"

# the golden test's config (tests/test_golden.py TEST_CFG)
GOLDEN_CFG = dict(kmer_cache_k=8, max_seeds_per_read=1024,
                  max_chain_seeds=128, max_candidates=16)
# Mapped-read floor of the v1 phase: the JAX package's mapped count on
# this dataset was not measured (that is a full-size CPU run), so the
# floor is 95% of the reads.
MIN_MAPPED_FRAC = 0.95
N_SUBSET = 32
# The JAX package's stage counters on v2 at the default config, offload
# on (BENCH_r05.json, the v2 chunk lines: counters only), and its SAM
# record count for the 560 reads.
V2_EXPECTED = {"seeds": 167579, "candidates": 26520, "fine_reads": 25,
               "chained_windows": 564, "splits": 16, "inversions": 8}
V2_READS, V2_RECORDS = 560, 585

# Bounds: the larger of bytes over the HBM
# rate and integer operations over the card's INT32 rate, 132 SMs x 64
# INT32 lanes x the maximum SM clock read from nvidia-smi.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64
# integer operations per unit of work, counted from the recurrences:
# Myers word-step (csrc/myers_*.cu word_step: 18 logic/add operations
# plus the two hin/hout shifts); traceback column (the mask, the
# highest-bit search in one word, two bit tests, the code and the row
# update); ksw_extend2 band cell (the score select, M, two maxes for h,
# the row-max test, and sub + max twice for each of E and F)
MYERS_OPS_PER_WORD = 20
TB_OPS_PER_COL = 12
AFFINE_OPS_PER_CELL = 16
# chain_dp's bound, counted from the run's windows (chain_work): on
# every pair j < i of a window's seeds, the integer differences of q and
# t and their two tests (4 operations; a linked dp-n2 pair adds d's
# difference and its absolute value, 2); on a linked pair only (an
# unlinked one needs no float), the float operations: dp-n2 with d > 1,
# 0.1 d, penalty log d, their sum, + reward, - pen and the compare (6),
# with d <= 1 + reward, - 0 and the compare (3); the log of d is a table
# entry (chain.log_table), each distinct one read once, counted as bytes;
# clasp, max, min, two products, their sum, - gsop and the compare (7).  Float operations go over the card's FP64 rate
# outside the tensor cores (NVIDIA's H100 SXM data sheet, 34 TFLOP/s;
# 67 for FP32, chain_dp_dtype "f32"), integer ones over the INT32 rate,
# and the bound takes the slower of the two and the bytes.
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12
CHAIN_INT_OPS = 4
DPN2_D_OPS = 2
DPN2_FAR_OPS, DPN2_NEAR_OPS, CLASP_OPS = 6, 3, 7
KERNELS = ("myers_dist", "myers_moves", "affine_extend", "chain_dp",
           "seed_ext", "sa_locate")
# the loops these three kernels replace, counted on entry (sa_lookup
# counts its walks only: with a full SA it is one gather, and the
# pipeline launches no sa_locate); a sharded index's are SHARD_KERNELS
# and SHARD_LOOPS (below)
LOOP_KERNELS = ("chain_dp", "seed_ext", "sa_locate")
LOOPS = ("_chain_bucketed", "_staged_ext", "sa_lookup")
# The JAX package's SAMs of v1 and v2 on the CPU, a sha256 a read
# (tools/torch_jax_sams.py); phases 4 and 5 hold the card's SAMs to them.
JAX_DIGESTS = DATA / "jax_sam_digests.json"
# Reads whose records may differ from the JAX package's, by (dataset,
# read name) under LordfastConfig() and by (configuration, dataset, read
# name) under another (divergent_key), each with its cause in ROADMAP
# Queue 3: none so far.
KNOWN_DIVERGENT: dict = {}
# The 300 Mbp phase: a seeded random genome of G300_BP bases, the
# smallest round size at which LordfastConfig() samples the SA (its
# 2 x 300 M-char text's full SA passes sa_mem_budget), and 512 reads of
# bench.gen_gbp_reads.
G300_BP = 300_000_000
G300_SEED = 300
# The 1.2 Gbp phase: a seeded random genome of G1200_BP bases in one
# contig, past the size at which text positions need 64 bits (seq_len >=
# 2**31 - 1, i.e. l_pac >= 1,073,741,824), with 512 reads of
# bench.gen_gbp_reads.  The forward reads drawn below 2 l_pac - 2**31
# (~252.5 Mbp) are located at text positions >= 2**31 (high_reads).  Cut
# from the Gbp bench's 3.1 Gbp genome (gbp_build.py, ~120 GB peak RSS)
# by the card host's RAM (101.0 GiB).
G1200_BP = 1_200_000_000
G1200_SEED = 1200
# the random genomes by tag: (bases, seed)
GENOMES = {"g300": (G300_BP, G300_SEED), "g1200": (G1200_BP, G1200_SEED)}
# how long after its start _built waits for each build process to end
# (g1200's took 744.7 s on an idle host), and the host RAM each build
# takes at its peak (its log's peak RSS, PERF.md section 6), for
# g1200_staggered
BUILD_WAIT_S = {"v1": 900, "v2": 900, "g300": 900, "g1200": 1000}
BUILD_PEAK_GIB = {"g1200": 46.0, "g300": 13.6, "v1": 8.6, "v2": 8.6}
# the pass whose launches the kernel table reports (v2's otherwise)
MAIN_PATH = {"sa_locate": "g1200"}


def log(msg):
    print(msg, flush=True)


def smi(query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return smi("name,power.limit")


def _wrappers():
    """Each kernel's wrapper and each replaced loop, by name (through a
    record_loops stand-in to the function it wraps)."""
    from lordfast_tpu_torch.ops import (affine_cuda, chain, chain_cuda,
                                        fm_index, fm_index_cuda,
                                        fm_shard_cuda, gap_dp_cuda)

    fns = {"myers_dist": gap_dp_cuda.myers_dist,
           "myers_moves": gap_dp_cuda.myers_moves,
           "affine_extend": affine_cuda.extend_batch_cuda,
           "chain_dp": chain_cuda.chain_dp,
           "seed_ext": fm_index_cuda.seed_ext,
           "sa_locate": fm_index_cuda.sa_locate,
           "_chain_bucketed": chain._chain_bucketed,
           "_staged_ext": fm_index._staged_ext,
           "sa_lookup": fm_index.sa_lookup,
           "_shard_ext": fm_index._shard_ext,
           "_shard_walk": fm_index._shard_walk,
           **{n: getattr(fm_shard_cuda, n) for n in (
               "shard_bucket", "shard_answer", "shard_ext_step",
               "shard_walk_step")}}
    return {k: getattr(f, "__wrapped__", f) for k, f in fns.items()}


def _counter(name):
    return "entries" if name in LOOPS or name.startswith("_") else \
        "launches"


def reset_launches():
    """Every kernel's launch count, every replaced loop's entry count and
    the sharded loops' counts (fm_index.shard_counts) to 0."""
    from lordfast_tpu_torch.ops import fm_index

    for name, fn in _wrappers().items():
        setattr(fn, _counter(name), 0)
    fm_index.shard_counts.update(dict.fromkeys(fm_index.shard_counts, 0))


def read_launches() -> dict:
    """{kernel: launches, loop: entries} since reset_launches."""
    return {name: getattr(fn, _counter(name))
            for name, fn in _wrappers().items()}


class _Recorder:
    """A wrapper's stand-in at its module attribute: calls record(*args,
    **kw), then the wrapper.  The wrapper counts its launches through
    its module attribute, so ``launches`` reads and writes go to the
    wrapper's own count."""

    def __init__(self, fn, record):
        self.__wrapped__ = fn
        self._record = record

    def __call__(self, *args, **kw):
        self._record(*args, **kw)
        return self.__wrapped__(*args, **kw)

    @property
    def launches(self):
        return self.__wrapped__.launches

    @launches.setter
    def launches(self, n):
        self.__wrapped__.launches = n


class record_loops:
    """Context manager: the first ``limit`` calls of chain_cuda.chain_dp,
    fm_index_cuda.seed_ext and fm_index_cuda.sa_locate made inside it
    are recorded with their inputs (cloned) in ``self.chain``,
    ``self.seed`` and ``self.locate``, and run as usual: the module
    attributes the call sites read are _Recorder stand-ins for the three
    wrappers."""

    def __init__(self, limit: int = 1):
        self.limit = limit
        self.chain, self.seed, self.locate = [], [], []

    def _chain(self, ws, cfg, want_dp=False):
        if len(self.chain) < self.limit:
            self.chain.append((type(ws)(*(x.clone() for x in ws)), cfg))

    def _seed(self, arrs, meta, rd, *lanes, **kw):
        if len(self.seed) < self.limit:
            self.seed.append(dict(
                arrs=arrs, meta=meta, rd=rd,
                lanes=[x.clone() for x in lanes[:6]],
                phase1_steps=lanes[6]))

    def _locate(self, arrs, meta, rows, valid, **kw):
        if len(self.locate) < self.limit:
            self.locate.append(dict(arrs=arrs, meta=meta, rows=rows.clone(),
                                    valid=valid.clone()))

    def __enter__(self):
        from lordfast_tpu_torch.ops import chain_cuda, fm_index_cuda

        self._saved = (chain_cuda.chain_dp, fm_index_cuda.seed_ext,
                       fm_index_cuda.sa_locate)
        chain_cuda.chain_dp = _Recorder(self._saved[0], self._chain)
        fm_index_cuda.seed_ext = _Recorder(self._saved[1], self._seed)
        fm_index_cuda.sa_locate = _Recorder(self._saved[2], self._locate)
        return self

    def __exit__(self, *exc):
        from lordfast_tpu_torch.ops import chain_cuda, fm_index_cuda

        (chain_cuda.chain_dp, fm_index_cuda.seed_ext,
         fm_index_cuda.sa_locate) = self._saved
        return False


def record_seeding(arrs, meta, reads, lens, cfg):
    """record_loops over the seeding of reads (B, L) uint8 / lens (B,)
    int32 tensors on the card under cfg, by fm_index._seed_anchors_impl
    on the index arrays arrs: its staged extension's call and, with a
    sampled SA, its locate's."""
    import torch

    from lordfast_tpu_torch.ops import fm_index

    pos = torch.from_numpy(fm_index.sample_positions_host(
        lens.cpu().numpy(), cfg.sampling_count)).to(reads.device)
    with record_loops() as rec:
        fm_index._seed_anchors_impl(
            arrs, reads, lens, pos, meta, cfg.sampling_count,
            cfg.min_anchor_len, cfg.max_ref_hits, cfg.max_seeds_per_read,
            cfg.seed_phase1_steps)
    return rec


def seed_lanes(arrs, meta, reads, lens, cfg):
    """The staged extension's call (record_loops' record) in the seeding
    of record_seeding."""
    return record_seeding(arrs, meta, reads, lens, cfg).seed[0]


def reads_of(rd):
    """(reads (B, L) uint8, lens (B,) int32) of an fm_index._Reads: its
    3-bit words decoded."""
    import torch

    sh = 3 * (15 - torch.arange(16, device=rd.rw.device))
    codes = ((rd.rw[:, :, None] >> sh) & 7).reshape(rd.rw.shape[0], -1)
    return (codes[:, :rd.L].to(torch.uint8).contiguous(),
            rd.lens.to(torch.int32))


def bound(nbytes: float, ops: float, int_rate: float, fp_ops: float = 0,
          fp_rate: float = FP64_FLOPS):
    """(bound_ms, bound_by): the least time for nbytes of HBM traffic, ops
    integer operations and fp_ops float ones (each kind on its own
    units, so the slower of the two)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / int_rate, fp_ops / fp_rate) * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_env() -> float:
    """Versions and builds; returns the INT32 rate in operations/s."""
    import torch

    from lordfast_tpu_torch import native
    from lordfast_tpu_torch.ops import cuda_build

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(f"[env] nvidia-smi: {nvidia_smi_line()}")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_rate = INT32_LANES * clock_mhz * 1e6
    log(f"[env] max SM clock {clock_mhz:.0f} MHz -> INT32 rate "
        f"{int_rate / 1e12:.2f} Tops/s (132 SMs x 64 lanes)")
    t = time.time()
    secs = cuda_build.build_all(force=True)
    log(f"[env] kernel libraries built in {time.time() - t:.1f} s "
        f"(one nvcc each, in parallel: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()) + ")")
    for name, text in cuda_build.logs.items():
        for line in text.splitlines():
            if "registers" in line or "stack frame" in line:
                log(f"[env] ptxas {name}: {line.strip()}")
    check_myers_frames(cuda_build.logs.get("myers", ""))
    check_affine_frames(cuda_build.logs.get("affine_ext", ""))
    check_loop_frames(cuda_build.logs.get("chain_dp", ""),
                      cuda_build.logs.get("seed_ext", ""))
    check_shard_frames(cuda_build.logs.get("seed_shard", ""))
    t = time.time()
    native._load()
    log(f"[env] native host library built in {time.time() - t:.1f} s")
    return int_rate


def ptxas_frames(ptxas_log: str, name_re: str) -> list:
    """(name_re's groups..., registers, stack, spill stores, spill loads)
    of each kernel instantiation in ptxas's -v report whose mangled name
    matches name_re."""
    import re

    out, cur = [], None
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for \S*" + name_re, line)
        if m:
            cur = [m.groups()]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if cur is not None and m and len(cur) == 1:
            cur.append([int(x) for x in m.groups()])
            continue
        m = re.search(r"Used (\d+) registers", line)
        if cur is not None and m and len(cur) == 2:
            out.append((*cur[0], int(m.group(1)), *cur[1]))
            cur = None
    return out


def myers_frames(ptxas_log: str) -> list:
    """(kernel, W, path, registers, stack, spill stores, spill loads) of
    each myers instantiation in ptxas's -v report."""
    return [(kern, int(W), path == "1", *rest) for kern, W, path, *rest in
            ptxas_frames(ptxas_log, r"(myers_\w+?_kernel)ILi(\d+)ELb([01])E")]


def check_myers_frames(ptxas_log: str):
    """Print each myers instantiation's frame; a warp-per-gap one with a
    stack frame or a spill is a failure (its words must stay in
    registers)."""
    frames = myers_frames(ptxas_log)
    if not frames:
        raise AssertionError("no ptxas report for the myers kernels")
    for kern, W, path, regs, stack, st, ld in sorted(frames):
        log(f"[env] ptxas myers {kern} W={W} {'moves' if path else 'dist'}:"
            f" {regs} registers, {stack} bytes stack, {st}/{ld} bytes "
            "spill stores/loads")
    bad = [f for f in frames if f[0] == "myers_warp_kernel" and any(f[4:])]
    if bad:
        raise AssertionError(f"warp-per-gap instantiations with a stack "
                             f"frame or spills: {bad}")


def check_affine_frames(ptxas_log: str):
    """Print each affine_warp_kernel<K> instantiation's frame; one missing
    (K = 1..8), or with a stack frame or a spill, is a failure (the band
    must stay in registers)."""
    frames = sorted((int(K), *rest) for _, K, *rest in ptxas_frames(
        ptxas_log, r"(affine_warp_kernel)ILi(\d+)E"))
    for K, regs, stack, st, ld in frames:
        log(f"[env] ptxas affine_warp_kernel K={K}: {regs} registers, "
            f"{stack} bytes stack, {st}/{ld} bytes spill stores/loads")
    if [f[0] for f in frames] != list(range(1, 9)):
        raise AssertionError(f"ptxas reported affine_warp_kernel for K = "
                             f"{[f[0] for f in frames]}, not 1..8")
    bad = [f for f in frames if any(f[2:])]
    if bad:
        raise AssertionError(f"affine instantiations with a stack frame or "
                             f"spills: {bad}")


def check_loop_frames(chain_log: str, seed_log: str):
    """Every chain_dp_kernel (8: two position dtypes x two float types x
    two costs), seed_ext_kernel and sa_locate_kernel (12 each: two rank
    layouts x two position dtypes x no diagnostics, the step counts, the
    need bitmap) instantiation in ptxas's report, none with a stack
    frame or a spill (a lane's state stays in registers, a window's in
    shared memory)."""
    for name, text, n in (("chain_dp_kernel", chain_log, 8),
                          ("seed_ext_kernel", seed_log, 12),
                          ("sa_locate_kernel", seed_log, 12)):
        # the seeding kernels' kDiag from the mangled name: <bool, Pos, int>
        frames = ptxas_frames(text, f"({name})" + (
            "()" if name == "chain_dp_kernel" else r"ILb[01]E[il]Li(\d)E"))
        if len(frames) != n:
            raise AssertionError(f"ptxas reported {len(frames)} {name} "
                                 f"instantiations, not {n}")
        bad = [f for f in frames if any(f[3:])]
        if bad:
            raise AssertionError(f"{name} instantiations with a stack frame "
                                 f"or spills: {bad}")
        regs = {}
        for f in frames:
            regs.setdefault(f[1], []).append(f[2])
        log(f"[env] ptxas {name}: {n} instantiations, "
            + ", ".join(f"{min(r)}-{max(r)}" + (f" (kDiag {d})" if d else "")
                        for d, r in sorted(regs.items()))
            + " registers, no stack frame, no spill")


def check_shard_frames(ptxas_log: str):
    """seed_shard.cu's kernels in ptxas's report: shard_bucket_kernel and
    shard_answer_kernel once, shard_ext_step_kernel and
    shard_walk_step_kernel once a position dtype; none with a stack frame
    or a spill."""
    for name, n in (("shard_bucket_kernel", 1), ("shard_answer_kernel", 1),
                    ("shard_ext_step_kernel", 2),
                    ("shard_walk_step_kernel", 2)):
        frames = ptxas_frames(ptxas_log, f"({name})")
        if len(frames) != n:
            raise AssertionError(f"ptxas reported {len(frames)} {name} "
                                 f"instantiations, not {n}")
        bad = [f for f in frames if any(f[2:])]
        if bad:
            raise AssertionError(f"{name} instantiations with a stack frame "
                                 f"or spills: {bad}")
        log(f"[env] ptxas {name}: {n} instantiation(s), "
            + "/".join(str(f[1]) for f in frames)
            + " registers, no stack frame, no spill")


def make_gaps(rng, Q, T, G):
    """G ragged gaps for bucket (Q, T): mutated-copy targets (so the
    distances are non-trivial), random NW/SHW modes, and the edge cases
    first — ql at 32/64 multiples, ql = 1, tl = 1, tl < W64; where W =
    Q/32 >= 8, ql at lane boundaries of the warp kernel's bottom word
    (32 K l - 1, 32 K l, 32 K l + 1 for K = ceil(W/32) words a lane, l =
    1, 2, the middle and the last lane) against targets of 1 to 33
    columns, shorter than the 32-lane skew, and T."""
    import numpy as np

    qs = np.full((G, Q), 4, np.uint8)
    ts = np.zeros((G, T), np.uint8)
    ql = rng.integers(max(1, Q // 2), Q + 1, G).astype(np.int32)
    tl = rng.integers(1, T + 1, G).astype(np.int32)
    special_q = [Q, Q - 1, 1, min(Q, 32), min(Q, 64), min(Q, 33),
                 min(Q, 63), 1]
    special_t = [T, 1, T, 3, 1, 5, T, 1]
    W = Q // 32
    if W >= 8:
        K = -(-W // 32)
        lanes = min(W // K, 32)
        for i, lane in enumerate(sorted({1, 2, lanes // 2, lanes - 1})):
            special_q += [32 * K * lane - 1, 32 * K * lane,
                          32 * K * lane + 1]
            special_t += [[1, 31, 33, T][i], 2, T - 7]
    for i, (a, b) in enumerate(zip(special_q, special_t)):
        if i < G:
            ql[i], tl[i] = a, b
    for g in range(G):
        q = rng.integers(0, 4, ql[g]).astype(np.uint8)
        base = np.resize(q, tl[g]).copy()
        sites = rng.integers(0, tl[g], max(1, tl[g] // 8))
        base[sites] = rng.integers(0, 4, len(sites))
        qs[g, : ql[g]] = q
        ts[g, : tl[g]] = base
    shw = rng.integers(0, 2, G).astype(bool)
    return qs, ql, ts, tl, shw


def make_windows(rng, W, N, counts, wrap=False):
    """W chaining windows of N slots (q, t int64, len, valid, as
    chain.WindowSeeds holds them), window w with counts[w] seeds in its
    first slots sorted by (qPos, tPos), near a diagonal with indels.
    Every third window repeats some of its seeds, so exact score ties
    decide predecessors (the largest j) and best ends (the smallest i).
    With ``wrap``, every fourth window moves the t of its second half by
    3 * 2^30 (t differences that cut to negative int32 values) or by 2^32
    + 5 (cut to small positive ones)."""
    import numpy as np

    q = np.zeros((W, N), np.int32)
    t = np.zeros((W, N), np.int64)
    ln = np.zeros((W, N), np.int32)
    va = np.zeros((W, N), bool)
    for w in range(W):
        base_t = int(rng.integers(0, 50_000))
        s = []
        while len(s) < counts[w]:
            qp = int(rng.integers(0, 3000))
            tp = max(base_t + qp + int(rng.integers(-150, 150)), 0)
            s.append((qp, tp, int(rng.integers(14, 60))))
            if w % 3 == 0 and len(s) < counts[w] and rng.random() < 0.3:
                s.append(s[-1])
        s.sort()
        if wrap and w % 4 == 1:
            jump = 3 * 2**30 if w % 8 == 1 else 2**32 + 5
            s = [(qp, tp + (jump if i >= len(s) // 2 else 0), m)
                 for i, (qp, tp, m) in enumerate(s)]
        for i, (qp, tp, m) in enumerate(s):
            q[w, i], t[w, i], ln[w, i], va[w, i] = qp, tp, m, True
    return q, t, ln, va


LOG_SEED_LEN = 2**17  # log_windows' first seed: longer than any penalty


def log_windows(ds):
    """One window of two seeds for each d of ds (int64 array): seed 0 at
    q = t = 0 of length LOG_SEED_LEN, seed 1 at q = LOG_SEED_LEN, t =
    LOG_SEED_LEN + d, of length 1, so that dr = 1, dt = d + 1 and dp-n2's
    pair has that d and links; seed 1 takes it (its val, LOG_SEED_LEN +
    reward - pen(d), beats its length 1 for every d of the log table),
    so its dp carries the penalty's bits.  (q, t int64, len, valid)."""
    import numpy as np

    W = len(ds)
    q = np.zeros((W, 2), np.int32)
    t = np.zeros((W, 2), np.int64)
    ln = np.ones((W, 2), np.int32)
    q[:, 1] = LOG_SEED_LEN
    t[:, 1] = LOG_SEED_LEN + np.asarray(ds, np.int64)
    ln[:, 0] = LOG_SEED_LEN
    return q, t, ln, np.ones((W, 2), bool)


def log_window_dp(ds, cfg):
    """The dp of log_windows' seed 1 in C doubles, as the reference
    computes it (src/Chain.cpp:217-225, 275): (LOG_SEED_LEN + reward) -
    (0.1 d + penalty log(d)), 0 penalty for d <= 1, each product and sum
    rounded on its own, log the C library's (math.log)."""
    import math

    reward = cfg.chain_reward * cfg.min_anchor_len
    return [(LOG_SEED_LEN + reward)
            - (0.0 if d <= 1 else 0.1 * d + cfg.chain_penalty * math.log(d))
            for d in (int(x) for x in ds)]


# seed counts at chain_dp's tile edges (32 seeds a tile) and v2's deepest
EDGE_COUNTS = (0, 1, 31, 32, 33, 64, 65, 105, 512)
EDGE_DUPS = (5, 31, 63)  # a chain window's seed p repeats at p + 1
EDGE_TOPS = (3, 7, 35)   # an unlinked window's longest seeds


def edge_windows(rng, N):
    """Windows of N slots at each of EDGE_COUNTS up to N, three a count:
    a chain along one diagonal (t off it by 0-2) whose seed p repeats at
    slot p + 1 for p in EDGE_DUPS, so seed p + 2 takes p + 1 from an
    exact tie with p (inside a tile at 5, across a tile's edge at 31 and
    63); seeds that do not link, the longest at EDGE_TOPS, so the best
    end is slot 3 by an exact tie across lanes (7) and within a lane
    (35); and make_windows' random window of the count, t differences
    that wrap int32 in every fourth."""
    import numpy as np

    counts = [c for c in EDGE_COUNTS if c <= N]
    W = 3 * len(counts)
    q = np.zeros((W, N), np.int32)
    t = np.zeros((W, N), np.int64)
    ln = np.zeros((W, N), np.int32)
    va = np.zeros((W, N), bool)
    for k, c in enumerate(counts):
        chain, free = [], []
        for i in range(c):
            if i - 1 in EDGE_DUPS:
                chain.append(chain[-1])
            else:
                chain.append((40 * i, 40 * i + 5000 + i % 3, 20))
            free.append((40 * i, 10**6 - 40 * i, 50 if i in EDGE_TOPS
                         else 20))
        for w, seeds in ((3 * k, chain), (3 * k + 1, free)):
            for i, (a, b, m) in enumerate(seeds):
                q[w, i], t[w, i], ln[w, i], va[w, i] = a, b, m, True
    rq, rt, rl, rv = make_windows(rng, len(counts), N, counts, wrap=True)
    for k in range(len(counts)):
        w = 3 * k + 2
        q[w], t[w], ln[w], va[w] = rq[k], rt[k], rl[k], rv[k]
    return q, t, ln, va


def text_of(arrs, meta):
    """The mirror-space text (fwd + revcomp, 2 * l_pac codes) of an
    index's device arrays, from its pac words, as numpy int64."""
    import numpy as np

    pw = arrs["pac_words"].cpu().numpy().astype(np.int64)
    codes = (pw[:, None] >> (2 * (15 - np.arange(16)))) & 3
    return codes.reshape(-1)[: 2 * meta["l_pac"]]


def edge_reads(rng, text, seq_len):
    """Reads for seed_ext's 16-char compare, copied from the mirror-space
    text (int codes): read position j holds 3 - text[P - 1 - j], so a
    lane from pos_f extends along text[.., P - pos_f) and its finish
    compares exact matches until the case's end at read position e: a
    wrong code ("mismatch", e = 40..87: every offset of a trip and runs
    across word boundaries), an N ("N", e = 40..55), the read's end
    ("end", length e = 40..55), the text's start ("start", P = e =
    40..55, so the last trip has p < 16) or MAX_ANCHOR_LEN ("max": 4200
    exact chars, pos_f 0..15).  Returns (reads (B, L) uint8, lens (B,)
    int32, kinds, e, lanes): one lane a read, alive over the whole
    interval [0, seq_len] with m = 0, as numpy (alive0, k0, l0, m0,
    pos_f, b_lane)."""
    import numpy as np

    n = len(text)
    cases = ([("mismatch", 40 + o) for o in range(48)]
             + [(kind, 40 + o) for kind in ("N", "end", "start")
                for o in range(16)]
             + [("max", o) for o in range(16)])
    B = len(cases)
    L = 4200
    reads = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    pos_f = np.zeros(B, np.int64)
    for b, (kind, e) in enumerate(cases):
        ln = {"end": e, "max": L}.get(kind, 300)
        P = e if kind == "start" else int(rng.integers(ln + 1, n))
        j = np.arange(ln)
        src = P - 1 - j
        read = np.where(src >= 0, 3 - text[np.maximum(src, 0)],
                        rng.integers(0, 4, ln))
        if kind == "mismatch":
            read[e] = (read[e] + rng.integers(1, 4)) % 4
        elif kind == "N":
            read[e] = 4
        reads[b, :ln], lens[b] = read, ln
        pos_f[b] = e if kind == "max" else 0
    lanes = (np.ones(B, bool), np.zeros(B, np.int64),
             np.full(B, seq_len, np.int64), np.zeros(B, np.int64), pos_f,
             np.arange(B, dtype=np.int64))
    kinds = np.array([k for k, _ in cases])
    return reads, lens, kinds, np.array([e for _, e in cases]), lanes


def _time_cuda(fn, reps):
    """Mean ms of fn() between two events: the device time and whatever
    host time fn spends between its launches (the plain versions)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# Pre-roll of _time_launches: a spin kernel of this many SM clocks (~20 ms)
# holds the stream while the host queues the launches.
SPIN_CYCLES = 40_000_000


def _time_launches(fn, reps):
    """Mean ms of the kernels fn() launches, back to back: a spin kernel
    holds the stream while the host queues all reps calls, so the events
    see the launches and none of the wrapper's host time.  If the spin
    ended before the host was done, it is doubled and the timing taken
    again."""
    import torch

    fn()  # warm-up: the library's load and the allocator's blocks
    cycles = SPIN_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        hidden = not start.query()
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(stop) / reps
        cycles *= 2
    raise RuntimeError("the host did not queue the launches inside the spin")


def _max_err(pairs) -> int:
    """Largest absolute difference over (got, want) tensor pairs."""
    err = 0
    for a, b in pairs:
        d = (a.cpu().long() - b.cpu().long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def _word_steps(ql, tl) -> float:
    """Myers word-steps a batch needs: the sum of tl * (bottom word + 1),
    the columns and words each gap's DP runs."""
    import numpy as np

    return float((tl.astype(np.int64)
                  * ((ql.astype(np.int64) - 1) // 32 + 1)).sum())


class Tally:
    """One kernel's totals over its buckets: times, bound (split by what
    sets it) and the largest error."""

    def __init__(self):
        self.ms = self.plain_ms = 0.0
        self.bound = {"bytes": 0.0, "operations": 0.0}
        self.err = 0

    def add(self, ms, plain_ms, bnd, err):
        self.ms += ms
        self.plain_ms += plain_ms
        self.bound[bnd[1]] += bnd[0]
        self.err = max(self.err, err)

    def row(self, name, source, replaces, **extra):
        by = max(self.bound, key=self.bound.get)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **extra, "launches": 0,
                "max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms,
                "bound_ms": sum(self.bound.values()), "bound_by": by,
                "library_ms": None}


def phase_kernel_gaps(int_rate):
    """myers_dist and myers_moves against their plain versions in every
    gap bucket; returns their two kernel-table rows."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.ops import gap_dp, gap_dp_cuda

    rng = np.random.default_rng(20261016)
    dist_t, moves_t = Tally(), Tally()
    buckets = LordfastConfig().gap_buckets
    for Q, T, G in buckets:
        qs, ql, ts, tl, shw = make_gaps(rng, Q, T, G)
        cpu = [torch.from_numpy(a) for a in (qs, ql, ts, tl, shw)]
        gpu = [a.cuda() for a in cpu]
        steps = _word_steps(ql, tl)
        in_bytes = qs.nbytes + ts.nbytes + ql.nbytes + tl.nbytes + shw.nbytes

        # ---- distance only, and with the last column ----
        d_k, e_k = gap_dp_cuda.myers_dist(*gpu, Q, T)
        got = gap_dp_cuda.myers_dist(*gpu, Q, T, want_col=True)
        on_card = gap_dp.myers_dist_plain(*gpu, Q, T, want_col=True)
        on_cpu = gap_dp.myers_dist_plain(*cpu, Q, T, want_col=True)
        torch.cuda.synchronize()
        err = _max_err(list(zip(got, on_card)) + list(zip(got, on_cpu))
                       + [(d_k, got[0]), (e_k, got[1])])
        if err:
            raise AssertionError(f"myers_dist ({Q},{T},{G}): kernel != "
                                 f"plain (max abs err {err})")
        ms = _time_launches(lambda: gap_dp_cuda.myers_dist(*gpu, Q, T), 5)
        plain_ms = _time_cuda(lambda: gap_dp.myers_dist_plain(*gpu, Q, T), 1)
        b = bound(in_bytes + 8 * G, MYERS_OPS_PER_WORD * steps, int_rate)
        dist_t.add(ms, plain_ms, b, err)
        log(f"[kernel] myers_dist Q={Q} T={T} G={G}: exact, last column "
            f"too | kernel "
            f"{ms:.3f} ms ({steps / ms / 1e6:.2f} Gword-steps/s) | plain "
            f"{plain_ms:.1f} ms | bound {b[0]:.4f} ms ({b[1]})")

        # ---- with traceback ----
        got = gap_dp_cuda.myers_moves(*gpu, Q, T)
        on_card = gap_dp.myers_moves_plain(*gpu, Q, T)
        on_cpu = gap_dp.myers_moves_plain(*cpu, Q, T)
        torch.cuda.synchronize()
        err = _max_err(list(zip(got, on_card)) + list(zip(got, on_cpu))
                       + [(got[0], d_k), (got[1], e_k)])
        if err:
            raise AssertionError(f"myers_moves ({Q},{T},{G}): kernel != "
                                 f"plain or myers_dist (max abs err {err})")
        k_np = [x.cpu().numpy() for x in got]
        c_np = [x.numpy() for x in on_cpu]
        mv_k = gap_dp.decode_col_moves(k_np[3], k_np[1], k_np[2])
        mv_c = gap_dp.decode_col_moves(c_np[3], c_np[1], c_np[2])
        if any(not np.array_equal(x, y) for x, y in zip(mv_k, mv_c)):
            raise AssertionError(f"myers_moves ({Q},{T},{G}): decoded "
                                 "moves differ")
        ms = _time_launches(lambda: gap_dp_cuda.myers_moves(*gpu, Q, T),
                                5)
        plain_ms = _time_cuda(lambda: gap_dp.myers_moves_plain(*gpu, Q, T),
                              1)
        tb_cols = float((k_np[1].astype(np.int64) + 1).clip(0).sum())
        b = bound(in_bytes + 12 * G + 2 * T * G,
                  MYERS_OPS_PER_WORD * steps + TB_OPS_PER_COL * tb_cols,
                  int_rate)
        moves_t.add(ms, plain_ms, b, err)
        log(f"[kernel] myers_moves Q={Q} T={T} G={G}: exact, moves equal "
            f"| kernel {ms:.3f} ms | plain {plain_ms:.1f} ms | bound "
            f"{b[0]:.4f} ms ({b[1]})")
    log(f"[kernel] all {len(buckets)} gap buckets exact; one launch each "
        f"at full G: myers_dist {dist_t.ms:.3f} ms (plain "
        f"{dist_t.plain_ms:.1f} ms), myers_moves {moves_t.ms:.3f} ms "
        f"(plain {moves_t.plain_ms:.1f} ms)")
    tiled = "lordfast_tpu/ops/gap_dp_pallas.py:290"
    return [
        dist_t.row("myers_dist", "lordfast_tpu_torch/csrc/myers.cu",
                   "lordfast_tpu/ops/gap_dp_pallas.py:84",
                   also_replaces=tiled),
        moves_t.row("myers_moves", "lordfast_tpu_torch/csrc/myers.cu",
                    "lordfast_tpu/ops/gap_dp_pallas.py:84",
                    also_replaces=tiled),
    ]


def time_at_parts(parts):
    """Each (kernel, bucket) the v2 pass launched, timed again at the
    median part size of its launches there (the engine launches each part
    at its real size), against the full-G time of phase 2."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.ops import affine_cuda, gap_dp_cuda

    cfg = LordfastConfig()
    w_max = max(cfg.clip_band, cfg.split_band)
    rng = np.random.default_rng(20261020)
    full = {(Q, T): G for Q, T, G in cfg.gap_buckets + cfg.affine_buckets}
    for (kern, Q, T), sizes in parts.items():
        n = sizes[len(sizes) // 2]
        if kern == "affine_extend":
            qs, ts, params = make_affine(rng, Q, T, n)
            q_d, t_d = torch.from_numpy(qs).cuda(), torch.from_numpy(ts).cuda()
            p_d = {k: torch.from_numpy(v).cuda() for k, v in params.items()}
            ms = _time_launches(lambda: affine_cuda.extend_batch_cuda(
                q_d, t_d, Q, T, w_max, **p_d), 5)
        else:
            gpu = [torch.from_numpy(a).cuda()
                   for a in make_gaps(rng, Q, T, n)]
            fn = getattr(gap_dp_cuda, kern)
            ms = _time_launches(lambda: fn(*gpu, Q, T), 5)
        log(f"[kernel] {kern} {'Qe' if kern == 'affine_extend' else 'Q'}={Q} "
            f"T={T} at v2's median part G={n} (of {len(sizes)} launches; "
            f"full G {full[(Q, T)]}): {ms:.3f} ms")


def _mutate(rng, q, err):
    """q with substitutions, insertions and deletions at rate err/3
    each."""
    import numpy as np

    r = rng.random(len(q))
    out = q.copy()
    sub = (r >= err / 3) & (r < 2 * err / 3)
    out[sub] = rng.integers(0, 4, int(sub.sum()))
    ins = (r >= 2 * err / 3) & (r < err)
    counts = np.where(r < err / 3, 0, np.where(ins, 2, 1))
    t = np.repeat(out, counts)
    pos = np.cumsum(counts)[ins] - 1
    t[pos] = rng.integers(0, 4, len(pos))
    return t if len(t) else rng.integers(0, 4, 1).astype(np.uint8)


def make_affine(rng, Qe, Te, G):
    """G extension problems for bucket (Qe, Te): related pairs with
    indels (12% and 30% error), junk pairs with N codes, z-drop cases (a
    related half then junk), qlen at and near Qe; the clip and split
    parameter sets of the engine, h0 = qlen."""
    import numpy as np

    from lordfast_tpu_torch.ops import affine

    qs = np.zeros((G, Qe), np.uint8)
    ts = np.zeros((G, Te), np.uint8)
    qlen = np.zeros(G, np.int32)
    tlen = np.zeros(G, np.int32)
    for g in range(G):
        n = Qe - g if g < 6 else int(rng.integers(max(1, Qe // 8), Qe + 1))
        q = rng.integers(0, 4, n).astype(np.uint8)
        kind = g % 4
        if kind == 0:
            t = _mutate(rng, q, 0.12)
        elif kind == 1:
            t = rng.integers(0, 5, int(rng.integers(1, Te + 1)))
        elif kind == 2:
            t = np.concatenate([_mutate(rng, q[: n // 2], 0.1),
                                rng.integers(0, 4, n - n // 2)])
        else:
            t = _mutate(rng, q, 0.3)
        t = t[:Te].astype(np.uint8)
        qs[g, :n], ts[g, : len(t)] = q, t
        qlen[g], tlen[g] = n, len(t)
    split = rng.integers(0, 2, G).astype(bool)
    sel = lambda a, b: np.where(split, b, a).astype(np.int32)
    od, ed_, oi, ei = sel(0, 8), sel(1, 1), sel(0, 4), sel(1, 1)
    params = dict(qlen=qlen, tlen=tlen, o_del=od, e_del=ed_, o_ins=oi,
                  e_ins=ei,
                  w_eff=affine.clamp_band(qlen, 2, 0, od, ed_, oi, ei,
                                          sel(40, 100)),
                  zdrop=sel(40, 200), h0=qlen.copy(),
                  match=np.full(G, 2, np.int32),
                  mismatch=np.full(G, 16, np.int32))
    return qs, ts, params


def lane_edge_bands(w_max: int, n: int = 12) -> list:
    """Up to n w_eff values, spread over [1, w_max] and w_max itself,
    whose band of slots [w_max - w_eff, w_max + w_eff] starts on a lane's
    first slot or ends on a lane's last one (K = ceil((2 w_max + 2) / 32)
    slots a lane), or whose width 2 w_eff + 1 is a multiple of K."""
    import numpy as np

    K = -(-(2 * w_max + 2) // 32)
    ws = [w for w in range(1, w_max + 1)
          if (w_max - w) % K == 0 or (w_max + w + 1) % K == 0
          or (2 * w + 1) % K == 0]
    pick = np.unique(np.linspace(0, len(ws) - 1, n).round().astype(int))
    return sorted({ws[i] for i in pick} | {w_max})


def make_affine_edges(rng, Qe, Te, w_max):
    """make_affine's problems for a band of w_max (K = 1 at 15, 3 at 40, 7
    at 100): the clip and split bands capped at w_max, and every third
    problem a w_eff of lane_edge_bands(w_max); tlen = 0 and 1 in two."""
    import numpy as np

    from lordfast_tpu_torch.ops import affine

    edges = lane_edge_bands(w_max)
    qs, ts, p = make_affine(rng, Qe, Te, 3 * len(edges))
    w = np.minimum(np.where(p["o_del"] == 8, 100, 40), w_max)
    p["w_eff"] = affine.clamp_band(p["qlen"], 2, 0, p["o_del"], p["e_del"],
                                   p["o_ins"], p["e_ins"], w)
    p["w_eff"][::3] = edges
    p["tlen"][1:3] = [0, 1]
    ts[1:3] = 0
    ts[2, 0] = qs[2, 0]
    return qs, ts, p


def phase_kernel_affine(int_rate):
    """affine_extend against its plain version in every affine bucket at
    the engine's band, and on lane-edge bands at K = 1, 3 and 7; returns
    its kernel-table row."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.ops import affine, affine_cuda

    cfg = LordfastConfig()
    w_max = max(cfg.clip_band, cfg.split_band)
    BW = 128 * ((2 * w_max + 2 + 127) // 128)
    rng = np.random.default_rng(20261017)
    tally = Tally()
    for Qe, Te, G in cfg.affine_buckets:
        qs, ts, params = make_affine(rng, Qe, Te, G)
        q_d = torch.from_numpy(qs).cuda()
        t_d = torch.from_numpy(ts).cuda()
        p_d = {k: torch.from_numpy(v).cuda() for k, v in params.items()}
        got = affine.extend_batch(q_d, t_d, Qe, Te, BW, w_max, **p_d)
        plain = []  # (ExtendResult, band cells) of the timed plain pass
        plain_ms = _time_cuda(lambda: plain.append(affine.extend_batch_plain(
            q_d, t_d, Qe, Te, BW, w_max, **p_d, return_cells=True)), 1)
        want, cells = plain[0]
        err = _max_err(zip(got, want))
        if err:
            raise AssertionError(f"affine_extend ({Qe},{Te},{G}): kernel != "
                                 f"plain (max abs err {err})")
        ms = _time_launches(lambda: affine_cuda.extend_batch_cuda(
            q_d, t_d, Qe, Te, w_max, **p_d), 5)
        nbytes = qs.nbytes + ts.nbytes + 4 * G * (len(params) + 6)
        b = bound(nbytes, AFFINE_OPS_PER_CELL * cells, int_rate)
        tally.add(ms, plain_ms, b, err)
        early = int((got.tle.cpu().numpy() < params["tlen"]).sum())
        log(f"[kernel] affine_extend Qe={Qe} Te={Te} G={G}: six outputs "
            f"exact ({early} problems end before their last row) | kernel "
            f"{ms:.3f} ms ({cells / ms / 1e6:.3f} Gcell/s over {cells} band "
            f"cells, {int(params['tlen'].max())} rows at most) | plain "
            f"{plain_ms:.1f} ms | bound {b[0]:.4f} ms ({b[1]})")
    log(f"[kernel] all {len(cfg.affine_buckets)} affine buckets exact; one "
        f"launch each at full G: kernel {tally.ms:.3f} ms, plain "
        f"{tally.plain_ms:.1f} ms")
    Qe, Te = 512, 544
    for wm in (15, 40, w_max):
        qs, ts, params = make_affine_edges(rng, Qe, Te, wm)
        cpu = [torch.from_numpy(a) for a in (qs, ts)]
        p_c = {k: torch.from_numpy(v) for k, v in params.items()}
        got = affine.extend_batch(*(a.cuda() for a in cpu), Qe, Te, 256, wm,
                                  **{k: v.cuda() for k, v in p_c.items()})
        want = affine.extend_batch_plain(*cpu, Qe, Te, 256, wm, **p_c)
        err = _max_err(zip(got, want))
        if err:
            raise AssertionError(f"affine_extend w_max={wm}: kernel != plain "
                                 f"on lane-edge bands (max abs err {err})")
        tally.err = max(tally.err, err)
        log(f"[kernel] affine_extend w_max={wm} (K={-(-(2 * wm + 2) // 32)})"
            f": {len(qs)} problems, w_eff on lane edges "
            f"{lane_edge_bands(wm)}: six outputs exact against the plain "
            f"version on the CPU")
    return tally.row("affine_extend", "lordfast_tpu_torch/csrc/affine_ext.cu",
                     "lordfast_tpu/ops/affine_pl.py:85")


def _bits(x):
    """A float tensor's bits as integers (the tensor itself otherwise)."""
    import torch

    if x.dtype == torch.float64:
        return x.view(torch.int64)
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


def check_chain_dp(ws, cfg):
    """chain_dp's kernel against the plain full-width DP (chain_dpn2 /
    chain_clasp_sop) on the card, on the windows ws and cfg's cost: the
    float bits of dp, prev and every ChainBatch field must be equal."""
    from lordfast_tpu_torch.ops import chain

    got, dp, prev = _wrappers()["chain_dp"](ws, cfg, want_dp=True)
    want, dp_w, prev_w = chain.dp_function(cfg)(ws, cfg, return_dp=True)
    pairs = [(dp, dp_w), (prev, prev_w)] + [
        (getattr(got, f), getattr(want, f)) for f in chain.ChainBatch._fields]
    bad = [i for i, (a, b) in enumerate(pairs)
           if not bool((_bits(a) == _bits(b)).all())]
    if bad:
        names = ["dp", "prev", *chain.ChainBatch._fields]
        raise AssertionError(f"chain_dp ({cfg.chain_alg}): kernel != plain "
                             f"in {[names[i] for i in bad]}")


def check_seed_ext(rec):
    """seed_ext's kernel against _staged_ext on the card, on one recorded
    call (record_loops): every lane's k, l, m, rpos and rflag equal, in
    two launches, one with the step counts and timers and one with the
    bitmap of needed input pieces.  Returns the kernel's (BS, 7) step
    counts and timers as numpy and its dict of the input bytes the lanes
    need (fm_index_cuda.seed_ext)."""
    from lordfast_tpu_torch.ops import fm_index

    args = (rec["arrs"], rec["meta"], rec["rd"], *rec["lanes"],
            rec["phase1_steps"])
    want = fm_index._staged_ext(*args)
    out = []
    for kw in ("want_stats", "want_need"):
        got = _wrappers()["seed_ext"](*args, **{kw: True})
        for name, a, b in zip(("k", "l", "m", "rpos", "rflag"), got, want):
            if not bool((a == b).all()):
                raise AssertionError(
                    f"seed_ext ({kw}): kernel != _staged_ext in {name} "
                    f"({int((a != b).sum())} lanes)")
        out.append(got[5])
    return out[0].cpu().numpy(), out[1]


def _wrap32(x):
    """int64 values cut to int32, as the kernel's differences wrap."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _linked_d(ws, dpn2=True):
    """The linked pairs j < i of every window of ws, a chunk of windows
    at a time: dp-n2's d of each (int64), or with dpn2 False clasp's dx
    of each pair linked under its precedence."""
    import torch

    N = ws.q_pos.shape[-1]
    q, t, ln = (x.reshape(-1, N).long()
                for x in (ws.q_pos, ws.t_pos, ws.length))
    ok = ws.valid.reshape(-1, N)
    dev = q.device
    below = torch.arange(N, device=dev)[None, :] < torch.arange(
        N, device=dev)[:, None]  # [i, j]: j < i
    step = max(1, 2**24 // (N * N))
    for w0 in range(0, q.shape[0], step):
        sl = slice(w0, w0 + step)
        qe = q[sl] + ln[sl] - 1  # the ends of j
        te = t[sl] + ln[sl] - 1
        live = below & ok[sl][:, None, :] & ok[sl][:, :, None]
        if dpn2:
            dr = _wrap32(q[sl][:, :, None] - qe[:, None, :])
            dt = _wrap32(t[sl][:, :, None] - te[:, None, :])
            link = live & (dr > 0) & (dt > 0)
            dd = _wrap32(dr - dt)
            yield torch.where(dd == -2**31, dd, dd.abs())[link]
        else:
            dy = _wrap32(q[sl][:, :, None] - qe[:, None, :] - 1)
            dx = _wrap32(t[sl][:, :, None] - te[:, None, :] - 1)
            yield dx[live & (dy >= 0) & (dx >= 0)]


def chain_work(ws, cfg) -> dict:
    """What chain_dp's function needs on the windows ws under cfg's cost
    and float type, counted from the windows (see CHAIN_INT_OPS): the
    pairs j < i of every window to its count, the linked ones, their
    integer and float operations and the float rate, and the bytes: the
    valid flag of every slot read once, q, t and len of the live slots
    only (a window's seeds fill its first slots), each distinct table
    entry log(d) of a linked dp-n2 pair read once, and the (W, N) chain
    fields and the W chain lengths and scores written once."""
    import torch

    from lordfast_tpu_torch.config import ChainAlg
    from lordfast_tpu_torch.ops import chain

    N = ws.q_pos.shape[-1]
    ok = ws.valid.reshape(-1, N)
    W, dev = ok.shape[0], ok.device
    n = ok.sum(-1)
    dpn2 = cfg.chain_alg != ChainAlg.CLASP
    fsize = torch.empty((), dtype=chain._dp_dtype(cfg)).element_size()
    seen = torch.zeros(chain.log_table_len(cfg), dtype=torch.bool,
                       device=dev)
    linked = fp_ops = d_ops = 0
    for d in _linked_d(ws, dpn2):
        if dpn2:
            near = d <= 1
            fp_ops += (DPN2_FAR_OPS * int((~near).sum())
                       + DPN2_NEAR_OPS * int(near.sum()))
            seen[d[~near]] = True
            d_ops += DPN2_D_OPS * len(d)
        else:
            fp_ops += CLASP_OPS * len(d)
        linked += len(d)
    pairs = int((n * (n - 1) // 2).sum())
    tb = ws.t_pos.element_size()
    nbytes = (W * N + int(n.sum()) * (4 + tb + 4) + W * N * (4 + tb + 4)
              + W * 8 + fsize * int(seen.sum()))
    return {"pairs": pairs, "linked": linked,
            "int_ops": CHAIN_INT_OPS * pairs + d_ops, "fp_ops": fp_ops,
            "fp_rate": FP64_FLOPS if fsize == 8 else FP32_FLOPS,
            "bytes": nbytes}


def chain_bound(work, int_rate):
    """bound() of a chain_work count."""
    return bound(work["bytes"], work["int_ops"], int_rate, work["fp_ops"],
                 work["fp_rate"])


def seed_work(rec, need) -> float:
    """Bytes seed_ext's function needs on one recorded call: the pieces
    of the index and the reads its lanes' steps need, each once (need,
    from the kernel's bitmap: fm_index_cuda.seed_ext), every lane's
    inputs read and outputs written once, the length of each read with a
    live lane, and L2."""
    alive0, b_lane = rec["lanes"][0], rec["lanes"][5]
    BS = alive0.shape[0]
    reads = int(b_lane[alive0].unique().numel())
    l2 = rec["arrs"]["L2"]
    return float(sum(need.values()) + BS * (1 + 5 * 8 + 4 * 8 + 1)
                 + 8 * reads + l2.numel() * l2.element_size())


# seed_ext's steps: extension, walk, compare round trip (stats columns 0,
# 1 and 3; column 2 is the chars the compare matched, 4-6 timers)
STEP_KINDS = ("ext", "walk", "cmp")


def _warp_steps(stats):
    """(lanes, warps) of each lane's and each warp's issued steps of
    every kind (extension, walk, compare round trip) and in all: a warp
    (32 consecutive lanes) issues each kind as often as its busiest lane
    takes it."""
    import numpy as np

    BS = stats.shape[0]
    pad = np.zeros((-(-BS // 32) * 32, 4), np.int64)
    pad[:BS, :3] = stats[:, [0, 1, 3]]
    pad[:BS, 3] = pad[:BS, :3].sum(1)
    per_warp = pad.reshape(-1, 32, 4).max(1)
    per_warp[:, 3] = per_warp[:, :3].sum(1)
    return pad, per_warp


def warp_efficiency(stats):
    """Active lane-steps over issued ones, per kind of step and in all."""
    pad, per_warp = _warp_steps(stats)
    issued = 32 * per_warp.sum(0)
    return {k: float(pad[:, i].sum() / issued[i]) if issued[i] else 1.0
            for i, k in enumerate((*STEP_KINDS, "all"))}


def longest_warp(stats) -> dict:
    """The issued steps of each kind of the warp that issues the most."""
    _, per_warp = _warp_steps(stats)
    w = int(per_warp[:, 3].argmax())
    return dict(zip((*STEP_KINDS, "all"), (int(x) for x in per_warp[w])))


def last_warp(stats) -> dict:
    """From the kernel's timers (stats columns 4-6: the low 32 bits of
    the card's nanosecond timer at each lane's start, when it left the
    extension and at its end), in microseconds after the first lane
    started: when the warp that ends last ends and when its last lane
    left the extension, its issued steps, and when half and 99% of the
    warps had ended."""
    import numpy as np

    t = stats[:, 4:7].astype(np.int64)
    rel = (t - t[0, 0] + 2**31) % 2**32 - 2**31  # spans under 2 s
    rel -= rel[:, 0].min()
    pad = np.full((-(-len(t) // 32) * 32, 2), -1, np.int64)
    pad[: len(t)] = rel[:, 1:]
    per = pad.reshape(-1, 32, 2).max(1)  # (ext, end) of each warp
    w = int(per[:, 1].argmax())
    _, steps = _warp_steps(stats)
    return {"end_us": per[w, 1] / 1e3, "ext_us": per[w, 0] / 1e3,
            **dict(zip((*STEP_KINDS, "all"), (int(x) for x in steps[w]))),
            "p50_us": float(np.percentile(per[:, 1], 50)) / 1e3,
            "p99_us": float(np.percentile(per[:, 1], 99)) / 1e3}


def split_layout(idx, arrs):
    """The device arrays of idx in the rank layout of l_pac >= 2^32:
    occ_cp + bwt_blocks instead of the fused fm_blocks rows."""
    import torch

    out = {k: v for k, v in arrs.items() if k != "fm_blocks"}
    dev = arrs["L2"].device
    out["occ_cp"] = torch.from_numpy(idx.occ_cp.astype("int64")).to(dev)
    out["bwt_blocks"] = arrs["bwt_words"].reshape(-1, 8)
    return out


FULL_WINDOWS = (1024, 512)  # the default batch's windows x max_chain_seeds


def _full_windows():
    """FULL_WINDOWS windows, every slot a seed: 128 windows of
    make_windows, 8 times over (a second each to make)."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.ops import chain

    W, N = FULL_WINDOWS
    arrays = [np.tile(x, (W // 128, 1)) for x in make_windows(
        np.random.default_rng(20261017), 128, N, [N] * 128)]
    return chain.WindowSeeds(*(torch.from_numpy(x).to("cuda") for x in (
        *arrays, arrays[3].sum(-1).astype(np.int32))))


def phase_full_windows(int_rate) -> dict:
    """chain_dp on FULL_WINDOWS windows with every slot a seed (the most
    pairs a default batch can give; _full_windows), both costs, bit-equal
    to the plain full-width DP on the card and timed against
    _chain_bucketed, with the bound; returns the dp-n2 figures for the
    kernel table."""
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.ops import chain

    W, N = FULL_WINDOWS
    ws = _full_windows()
    out = {}
    for alg in ("dpn2", "clasp"):
        c = LordfastConfig(chain_alg=alg, max_chain_seeds=N)
        check_chain_dp(ws, c)
        ms = _time_launches(lambda: _wrappers()["chain_dp"](ws, c), 5)
        plain_ms = _time_cuda(
            lambda: chain._chain_bucketed(ws, c, chain.dp_function(c)), 1)
        work = chain_work(ws, c)
        b = chain_bound(work, int_rate)
        log(f"[loops] chain_dp full windows {alg}: {W} windows x {N} slots,"
            f" every one full ({_chain_counts(work)}): dp, prev and chains "
            f"bit-equal to the plain version | kernel {ms:.3f} ms | plain "
            f"(_chain_bucketed) {plain_ms:.1f} ms | bound {b[0]:.5f} ms "
            f"({b[1]})")
        if alg == "dpn2":
            out = {"full_windows_ms": ms, "full_windows_plain_ms": plain_ms,
                   "full_windows_bound_ms": b[0],
                   "full_windows_bound_by": b[1]}
    return out


def _chain_counts(work) -> str:
    return (f"{work['pairs']} pairs, {work['linked']} linked, "
            f"{work['int_ops']} integer and {work['fp_ops']} float "
            f"operations, {work['bytes']} bytes")


def slice_sa(idx, intv: int):
    """idx, which holds the full SA, with its SA sampled at interval intv
    as the builder samples it (sa_full[::intv], entry 0 set to -1): a
    sampled-SA index of the same genome without a second build."""
    import dataclasses

    import numpy as np

    if idx.sa_intv != 1:
        raise ValueError(f"slice_sa: the index has sa_intv {idx.sa_intv}")
    sa = np.ascontiguousarray(idx.sa_samp[::intv])
    sa[0] = -1
    return dataclasses.replace(idx, sa_samp=sa, sa_intv=intv, _device=None,
                               _host_cache=None)


def locate_rows(meta, rows, valid, seed: int = 20261019):
    """A recorded locate call's lanes, then 64 edge lanes: the primary
    row and its neighbours, sampled rows (0, intv, the last), row
    seq_len, and 48 invalid lanes of random rows (which must give 0)."""
    import numpy as np
    import torch

    seq_len, primary, intv = meta["seq_len"], meta["primary"], \
        meta["sa_intv"]
    rng = np.random.default_rng(seed)
    edge = [primary, max(primary - 1, 0), min(primary + 1, seq_len), 0,
            intv, (seq_len // intv) * intv, seq_len - 1, seq_len]
    edge += [int(x) for x in rng.integers(0, seq_len + 1, 8)]
    junk = rng.integers(0, seq_len + 1, 48)
    dev = rows.device
    extra = torch.tensor(edge + [int(x) for x in junk], dtype=torch.int64,
                         device=dev)
    ok = torch.tensor([True] * len(edge) + [False] * len(junk), device=dev)
    return torch.cat([rows, extra]), torch.cat([valid, ok])


def locate_work(rec, need) -> float:
    """Bytes sa_locate's function needs on one recorded call: the rank
    row pieces and SA entries its walks need, each once (need, from the
    kernel's bitmap: fm_index_cuda.sa_locate), every lane's row and
    valid flag read and its position written once, and L2."""
    n = rec["rows"].shape[0]
    l2 = rec["arrs"]["L2"]
    return float(sum(need.values()) + n * (8 + 1 + 8)
                 + l2.numel() * l2.element_size())


# check_sa_locate's beyond-residency case: more rows than the card holds
# lanes at once (132 SMs x 2048 threads = 270,336), drawn over the rows
# of the 300 Mbp and 1.2 Gbp indexes, so the lane queue hands most of
# them out as walks end; and the pointer chase that gives a walk step's
# latency floor
BEYOND_ROWS = 1 << 20
BEYOND_SEED = 20261021
CHASE_WARM, CHASE_HOPS, CHASE_SEED = 2_000, 50_000, 20261020


def rank_bytes(arrs) -> int:
    """Bytes of an index's rank arrays on the card (fm_blocks, or occ_cp
    and bwt_blocks), which a walk step reads."""
    return sum(arrs[k].numel() * arrs[k].element_size()
               for k in ("fm_blocks", "occ_cp", "bwt_blocks") if k in arrs)


def chase_ns(nbytes: int) -> float:
    """Nanoseconds of one dependent load on the card over a buffer of
    nbytes: one thread follows a seeded random cyclic permutation of
    nbytes / 8 int64 indexes (csrc/seed_ext.cu chase_kernel, CHASE_WARM
    hops, then CHASE_HOPS timed on the card's timer).  A walk step's
    load depends on the previous step's, so this is its floor: an
    L2-sized buffer (v2's index, 42 MB of rank rows) hits L2 mostly, a
    1.8 GB one (the 1.2 Gbp index) goes to HBM, with TLB misses."""
    import ctypes

    import torch

    from lordfast_tpu_torch.ops import cuda_build

    n = max(nbytes // 8, 2)
    g = torch.Generator(device="cuda")
    g.manual_seed(CHASE_SEED)
    perm = torch.randperm(n, device="cuda", generator=g)
    buf = torch.empty(n, dtype=torch.int64, device="cuda")
    buf[perm] = perm.roll(-1)
    start = int(perm[0])
    del perm
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    f = cuda_build.load("seed_ext").lf_chase
    vp = ctypes.c_void_p
    f.restype = ctypes.c_int
    f.argtypes = [vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp, vp]
    rc = f(buf.data_ptr(), start, CHASE_WARM, CHASE_HOPS, out.data_ptr(),
           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chase: kernel launch failed (cudaError {rc})")
    torch.cuda.synchronize()
    ns = int(out[1]) / CHASE_HOPS
    del buf
    torch.cuda.empty_cache()
    return ns


def beyond_rows(meta):
    """BEYOND_ROWS rows drawn with a seeded torch.Generator over [0,
    seq_len], the first ones every valid edge row of locate_rows
    (primary and its neighbours, sampled rows, seq_len), all valid."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(BEYOND_SEED)
    rows = torch.randint(0, meta["seq_len"] + 1, (BEYOND_ROWS,),
                         generator=g, device="cuda")
    e_rows, e_ok = locate_rows(meta, rows[:0], rows[:0].bool())
    edge = e_rows[e_ok]
    rows[: len(edge)] = edge
    return rows, torch.ones(BEYOND_ROWS, dtype=torch.bool, device="cuda")


def check_sa_locate(tag, idx, rec, int_rate, timed=False, chase=None,
                    layouts=True):
    """sa_locate's kernel against the plain sa_lookup on the card, on one
    recorded call (record_loops) and, with ``layouts``, its edge lanes
    (locate_rows) in both rank layouts and with int32 and int64 sa_samp
    (L2 with it): every position equal, in the pipeline's instantiation
    and in the two diagnostic ones.  Logs the walks (steps a lane, the
    longest, the warp efficiency under the lane queue from the kernel's
    per-warp counts) and the bytes needed; with ``timed`` also the
    kernel's time on the call's own lanes (fused, the index's dtype)
    against one plain pass, its bound, and with ``chase`` (ns a
    dependent load, chase_ns) its latency floor, the longest walk's steps
    times that; returned as a dict."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.ops import fm_index

    meta = rec["meta"]
    loc = _wrappers()["sa_locate"]
    r, v = rec["rows"], rec["valid"]
    cases = []
    if layouts:
        rows, valid = locate_rows(meta, r, v)
        # int32 sa_samp and L2 only where the positions fit them; past
        # 2**31 - 1 the wrapper refuses them (their L2 would wrap)
        wide = meta["seq_len"] >= 2**31 - 1
        dts = (torch.int64,) if wide else (torch.int32, torch.int64)
        for layout in ("fused", "split"):
            a0 = (rec["arrs"] if layout == "fused"
                  else split_layout(idx, rec["arrs"]))
            for dt in dts:
                cases.append(({**a0, "sa_samp": a0["sa_samp"].to(dt),
                               "L2": a0["L2"].to(dt)}, rows, valid,
                              f"{layout}, {dt}"))
        if wide:
            try:
                loc({**rec["arrs"], "sa_samp": rec["arrs"]["sa_samp"].to(
                    torch.int32), "L2": rec["arrs"]["L2"].to(torch.int32)},
                    meta, r, v)
            except ValueError:
                pass
            else:
                raise AssertionError(f"sa_locate {tag}: int32 positions "
                                     f"taken at seq_len {meta['seq_len']}")
    else:
        cases.append((rec["arrs"], r, v, "fused"))
    for a, rows, valid, what in cases:
        want = fm_index.sa_lookup(a, meta, rows, valid)
        for kw in ("plain", "want_stats", "want_need"):
            got = loc(a, meta, rows, valid,
                      **({} if kw == "plain" else {kw: True}))
            got = got if kw == "plain" else got[0]
            if not bool((got == want).all()):
                raise AssertionError(
                    f"sa_locate {tag} ({what}, {kw}): kernel != sa_lookup "
                    f"in {int((got != want).sum())} of {len(rows)} lanes")
    _, steps, wsteps = loc(rec["arrs"], meta, r, v, want_stats=True)
    _, need = loc(rec["arrs"], meta, r, v, want_need=True)
    st = steps.cpu().numpy().astype(np.int64)
    ws = wsteps.cpu().numpy().astype(np.int64)
    ws = ws[ws[:, 0] > 0]  # the warps that stepped
    if ws[:, 1].sum() != st.sum():
        raise AssertionError(f"sa_locate {tag}: the warps' lane steps "
                             f"{ws[:, 1].sum()} != the rows' {st.sum()}")
    eff = float(st.sum() / max(32 * ws[:, 0].sum(), 1))
    longest = int(st.max()) if len(st) else 0
    line = (f"[loops] sa_locate {tag} (sa_intv {meta['sa_intv']}): "
            f"{len(r)} lanes ({int(v.sum())} valid), {int(st.sum())} walk "
            f"steps, {st.mean():.1f} a lane, p99 "
            f"{np.percentile(st, 99):.0f}, the longest {longest}; "
            f"{len(ws)} warps, warp efficiency {eff:.3f} (lane steps over "
            f"32 x issued steps): equal to sa_lookup"
            + (f" on them and {len(cases[0][1]) - len(r)} edge lanes in both "
               "rank layouts, "
               + ("int64 sa_samp (int32 refused)" if len(cases) == 2
                  else "int32 and int64 sa_samp") if layouts else "")
            + " | input bytes needed "
            + " ".join(f"{k} {x}" for k, x in need.items())
            + f" (all {locate_work(rec, need):.0f})")
    out = None
    if timed:
        ms = _time_launches(lambda: loc(rec["arrs"], meta, r, v), 5)
        plain_ms = _time_cuda(
            lambda: fm_index.sa_lookup(rec["arrs"], meta, r, v), 1)
        b = bound(locate_work(rec, need), 0, int_rate)
        line += (f" | kernel {ms:.4f} ms | plain (sa_lookup) "
                 f"{plain_ms:.1f} ms | bound {b[0]:.5f} ms ({b[1]}), "
                 f"kernel {ms / b[0]:.1f}x")
        floor = longest * chase * 1e-6 if chase else None
        if floor:
            line += (f" | latency floor {floor:.4f} ms ({longest} steps x "
                     f"{chase:.1f} ns a dependent load over "
                     f"{rank_bytes(rec['arrs'])} bytes), kernel "
                     f"{ms / floor:.2f}x")
        out = {"ms": ms, "plain_ms": plain_ms, "bound": b,
               "floor_ms": floor, "chase_ns": chase, "lanes": len(r),
               "walk_steps": int(st.sum()), "longest_walk": longest,
               "warp_efficiency": eff, "warps": len(ws)}
    log(line)
    return out


def phase_loops(caps, golden_idx, v2_idx, int_rate):
    """chain_dp and seed_ext against their plain versions on the card, on
    the first call each that the golden, v1 and v2 passes made (caps:
    record_loops by tag): chain_dp on the windows with both costs,
    seed_ext on the lanes; then seed_ext on golden's reads over a
    sampled-SA index (sa_intv 32) and over the split rank layout, each
    in both; then sa_locate (check_sa_locate) on the locate of golden's
    reads over that sampled index and on the first locate call of the
    v2 sampled passes (caps "v2_32" and "v2_16", over v2_idx sliced).
    Times each kernel at v2's call (_time_launches; sa_locate at
    sa_intv 32) against its plain version; returns their three
    kernel-table rows."""
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import build_index
    from lordfast_tpu_torch.ops import chain, fm_index

    chain_t, seed_t = Tally(), Tally()
    for tag in ("golden", "v1", "v2"):
        ws, cfg = caps[tag].chain[0]
        N = ws.q_pos.shape[-1]
        counts = ws.valid.reshape(-1, N).sum(-1)
        for alg in ("dpn2", "clasp"):
            c = cfg.replace(chain_alg=alg)
            check_chain_dp(ws, c)
            work = chain_work(ws, c)
            b = chain_bound(work, int_rate)
            line = (f"[loops] chain_dp {tag} {alg}: {counts.numel()} windows"
                    f" x {N} slots ({int((counts > 0).sum())} with seeds, "
                    f"{int(counts.max())} at most, {_chain_counts(work)}): "
                    "dp, prev and chains bit-equal to the plain version")
            if tag == "v2":
                ms = _time_launches(
                    lambda: _wrappers()["chain_dp"](ws, c), 5)
                plain_ms = _time_cuda(
                    lambda: chain._chain_bucketed(ws, c,
                                                  chain.dp_function(c)), 1)
                if alg == "dpn2":  # the table's row: the main path's cost
                    chain_t.add(ms, plain_ms, b, 0)
                line += (f" | kernel {ms:.3f} ms | plain (_chain_bucketed) "
                         f"{plain_ms:.1f} ms | bound {b[0]:.5f} ms ({b[1]})")
            log(line)
        rec = caps[tag].seed[0]
        stats, need = check_seed_ext(rec)
        line = _seed_line(f"{tag}", rec, stats, need)
        if tag == "v2":
            args = (rec["arrs"], rec["meta"], rec["rd"], *rec["lanes"],
                    rec["phase1_steps"])
            ms = _time_launches(lambda: _wrappers()["seed_ext"](*args), 5)
            plain_ms = _time_cuda(lambda: fm_index._staged_ext(*args), 1)
            b = bound(seed_work(rec, need), 0, int_rate)
            seed_t.add(ms, plain_ms, b, 0)
            line += (f" | kernel {ms:.3f} ms | plain (_staged_ext) "
                     f"{plain_ms:.1f} ms | bound {b[0]:.5f} ms ({b[1]})")
        log(line)
    full = phase_full_windows(int_rate)
    g = caps["golden"].seed[0]
    cfg = LordfastConfig(**GOLDEN_CFG)
    sampled = build_index(DATA / "ref.fa", LordfastConfig(
        kmer_cache_k=8, sa_interval=32), verbose=False)
    fused = {"sampled": (sampled, sampled.device_arrays("cuda")),
             "full": (golden_idx, g["arrs"])}
    for sa, (idx, arrs) in fused.items():
        for layout in ("fused", "split"):
            a = arrs if layout == "fused" else split_layout(idx, arrs)
            rec = record_seeding(a, idx.meta, *reads_of(g["rd"]), cfg)
            stats, need = check_seed_ext(rec.seed[0])
            log(_seed_line(f"golden, {sa} SA (sa_intv {idx.sa_intv}), "
                           f"{layout} rank rows", rec.seed[0], stats, need))
            if sa == "sampled" and layout == "fused":
                check_sa_locate("golden", idx, rec.locate[0], int_rate)
    v2_rec = caps["v2_32"].locate[0]
    ns = chase_ns(rank_bytes(v2_rec["arrs"]))
    log(f"[loops] pointer chase over {rank_bytes(v2_rec['arrs'])} bytes "
        f"(v2's rank arrays): {ns:.1f} ns a dependent load")
    v2_32 = check_sa_locate("v2", v2_idx, v2_rec, int_rate, timed=True,
                            chase=ns)
    check_sa_locate("v2", v2_idx, caps["v2_16"].locate[0], int_rate)
    log("[loops] chain_dp, seed_ext and sa_locate bit-equal to their plain "
        "versions in every case")
    loc_t = Tally()
    loc_t.add(v2_32["ms"], v2_32["plain_ms"], v2_32["bound"], 0)
    return [
        chain_t.row("chain_dp", "lordfast_tpu_torch/csrc/chain_dp.cu",
                    "lordfast_tpu/ops/chain.py:350",
                    also_replaces="lordfast_tpu/ops/chain.py:409, :213",
                    **full),
        seed_t.row("seed_ext", "lordfast_tpu_torch/csrc/seed_ext.cu",
                   "lordfast_tpu/ops/fm_index.py:492",
                   also_replaces="lordfast_tpu/ops/fm_index.py:568, :602"),
        loc_t.row("sa_locate", "lordfast_tpu_torch/csrc/seed_ext.cu",
                  "lordfast_tpu/ops/fm_index.py:303",
                  also_replaces="lordfast_tpu/ops/fm_index.py:267",
                  timed_at="v2 sliced to sa_intv 32, its first locate call",
                  **{k: v2_32[k] for k in ("lanes", "walk_steps",
                                           "longest_walk", "warp_efficiency",
                                           "floor_ms", "chase_ns")}),
    ]


OTHER = "lft_other"  # another checkout's package, for compare_loops


def _load_other(root: Path):
    """The package of the checkout at root, imported as OTHER beside this
    one: its ops modules chain_cuda, fm_index_cuda, cuda_build and
    fm_shard_cuda."""
    import importlib
    import importlib.util

    pkg = root / "lordfast_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        OTHER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{OTHER}.ops.{m}")
                 for m in ("chain_cuda", "fm_index_cuda", "cuda_build",
                           "fm_shard_cuda"))


def compare_loops(other: Path, reps: int = 5) -> int:
    """``--against DIR``: this checkout's chain_dp, seed_ext, sa_locate,
    shard_bucket and shard_answer kernels against those of the checkout
    at DIR (e.g. the parent commit, unpacked with git archive into a
    directory .gitignore lists), on one card.  Both checkouts'
    chain_dp.cu, seed_ext.cu and seed_shard.cu are built at once (one
    nvcc each, each into its own checkout's _build);
    the inputs are v2's first device call, recorded from one pass of this
    checkout's engine over .smoke_cache's v2 dataset (made by a smoke
    run, or here), the full windows, and for sa_locate the first locate
    call of a pass over v2's index with the SA sliced to 32, that of a
    pass over the 300 Mbp and 1.2 Gbp genomes (each whose index a smoke
    run has left in .smoke_cache) and their BEYOND_ROWS rows
    (beyond_rows); each checkout's kernel is held bit-equal to the plain
    version, then timed with _time_launches in turns A B B A (A this
    checkout).  Each
    wrapper is called as its checkout's signature asks (seed_ext took
    (B, L) uint8 reads and int32 lengths before it took an
    fm_index._Reads; shard_answer had no ``routed`` before it left empty
    slots unwritten).  Then compare_shard: the sharded passes (NCCL, a
    group of one in this process) of v2 with its full SA and at 32, and
    of the 300 Mbp genome and the 1.2 Gbp genome's high reads where a
    smoke run has left them.  One JSON line per case, then the card's
    name and power limit; no contract line."""
    import inspect
    import threading

    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import load_index
    from lordfast_tpu_torch.ops import (chain, chain_cuda, cuda_build,
                                        fm_index, fm_index_cuda)
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    if not torch.cuda.is_available():
        print("[compare] needs a CUDA device", file=sys.stderr)
        return 2
    o_chain, o_fm, o_cb, o_shard = _load_other(other.resolve())
    t = time.time()
    errs = []

    def build(cb):
        try:
            cb.build_all(("chain_dp", "seed_ext", "seed_shard"), force=True)
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)

    threads = [threading.Thread(target=build, args=(cb,))
               for cb in (cuda_build, o_cb)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    log(f"[compare] both checkouts' chain_dp, seed_ext and seed_shard "
        f"built in "
        f"{time.time() - t:.1f} s")
    _, reads_path = _dataset(easy=False)
    if not (CACHE / "v2.lft.npz").exists():
        build_bench("v2")
    eng = MappingEngine(load_index(CACHE / "v2.lft.npz"), LordfastConfig(),
                        device="cuda")
    with record_loops() as rec:
        eng.map_file(reads_path, io.StringIO(), "chip_smoke")
    ws, cfg = rec.chain[0]
    seed = rec.seed[0]
    reads, lens = reads_of(seed["rd"])
    lanes = (*seed["lanes"], seed["phase1_steps"])

    def seed_call(fn):
        if "rd" in inspect.signature(fn).parameters:
            return lambda: fn(seed["arrs"], seed["meta"], seed["rd"], *lanes)
        return lambda: fn(seed["arrs"], seed["meta"], reads, lens, *lanes)

    cases = []
    for name, w in (("v2 call", ws), ("full windows", _full_windows())):
        for alg in ("dpn2", "clasp"):
            c = (cfg if name == "v2 call" else LordfastConfig(
                max_chain_seeds=FULL_WINDOWS[1])).replace(chain_alg=alg)
            cases.append((f"chain_dp {name} {alg}",
                          chain.dp_function(c)(w, c), {
                              "this": lambda w=w, c=c: chain_cuda.chain_dp(
                                  w, c),
                              "other": lambda w=w, c=c: o_chain.chain_dp(
                                  w, c)}))
    cases.append(("seed_ext v2 call", fm_index._staged_ext(
        seed["arrs"], seed["meta"], seed["rd"], *lanes), {
            "this": seed_call(fm_index_cuda.seed_ext),
            "other": seed_call(o_fm.seed_ext)}))
    v2_idx = eng.idx
    locs = {"v2 sa_intv 32 call": (keep_layout(slice_sa(v2_idx, 32)),
                                   reads_path)}
    del eng
    for tag, name in (("g300", "300 Mbp"), ("g1200", "1.2 Gbp")):
        if (CACHE / f"{tag}.lft.npz").exists():
            locs[f"{name} call"] = (keep_layout(load_index(
                CACHE / f"{tag}.lft.npz")), _paths(tag)[1])
    for label, (idx, path) in locs.items():
        e = MappingEngine(idx, LordfastConfig(), device="cuda")
        with record_loops() as rec:
            e.map_file(path, io.StringIO(), "chip_smoke")
        calls = {label: rec.locate[0]}
        if not label.startswith("v2"):
            rows, valid = beyond_rows(idx.meta)
            calls[label.replace("call", "beyond residency")] = dict(
                arrs=e.arrs, meta=idx.meta, rows=rows, valid=valid)
        for name, c in calls.items():
            args = (c["arrs"], c["meta"], c["rows"], c["valid"])
            cases.append((f"sa_locate {name}", (fm_index.sa_lookup(*args),),
                          {"this": lambda a=args: (
                              fm_index_cuda.sa_locate(*a),),
                           "other": lambda a=args: (o_fm.sa_locate(*a),)}))
    for label, want, fns in cases:
        for side, fn in fns.items():
            got = fn()
            if not all(bool((_bits(a) == _bits(b)).all())
                       for a, b in zip(got, want)):
                raise AssertionError(f"[compare] {label}: {side} != plain")
        ms = {"this": [], "other": []}
        for side in ("this", "other", "other", "this"):
            ms[side].append(_time_launches(fns[side], reps))
        log(json.dumps({"case": label, "ms_this": ms["this"],
                        "ms_other": ms["other"], "other": str(other)}))
    del cases, e, calls, c, args, rec  # the replicated engines' arrays
    runs = [("v2 full SA", v2_idx, reads_path),
            ("v2 at 32", *locs["v2 sa_intv 32 call"])]
    if "300 Mbp call" in locs:
        runs.append(("300 Mbp", *locs["300 Mbp call"]))
    high = CACHE / "mesh" / "g1200_high.fq"
    if "1.2 Gbp call" in locs and high.exists():
        runs.append(("1.2 Gbp high reads", locs["1.2 Gbp call"][0], high))
    compare_shard(o_shard, runs, other, reps)
    log(f"[compare] {nvidia_smi_line()}")
    return 0


def _routed_optional(fn):
    """fn, or for an answer wrapper without ``routed`` (a checkout before
    it left empty slots unwritten) fn called without it."""
    import inspect

    if "routed" in inspect.signature(fn).parameters:
        return fn

    def call(*args, routed=False, **kw):
        return fn(*args, **kw)

    call.launches = 0
    return call


def _other_bucket_check(fn, args, kw):
    """Another checkout's shard_bucket on one recorded call against this
    one's plain version, as a kernel whose slots follow its atomics'
    order can be held: counts, the overflow flag and each query's
    row id through its own slot equal."""
    import torch

    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    rps, D, cap = args[4:7]
    (sk, tk, ck, ok), (sp, tp, cp, op) = (
        _bucket_run(f, args, kw, rps, D, cap)
        for f in (fn, K.shard_bucket_plain))
    via = [torch.where(t >= 0, s[t.long().clamp(min=0)], -1)
           for s, t in ((sk, tk), (sp, tp))]
    if not (torch.equal(ck, cp) and torch.equal(ok, op)
            and torch.equal(via[0], via[1])):
        raise AssertionError("[compare] the other checkout's shard_bucket "
                             "!= plain")


# the functions of fm_shard_cuda compare_shard puts in place for each
# checkout's sharded passes: its loops, which call its own kernels
SHARD_SIDE = ("shard_ext", "shard_walk", "sa_gather")
# the loop each step kernel runs in
STEP_LOOPS = {"shard_ext": "shard_ext_step", "shard_walk": "shard_walk_step"}


def kernel_events(tdir) -> list:
    """(name, ms) of each CUDA kernel of the one Chrome trace that
    utils.metrics.profiler_trace wrote into tdir, in launch order."""
    traces = list(Path(tdir).glob("lordfast_*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"{len(traces)} trace files in {tdir}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    return [(e["name"], e["dur"] / 1e3) for e in sorted(
        (e for e in events if e.get("cat") == "kernel"),
        key=lambda e: e["ts"])]


def band_sums(ms, lives, n) -> dict:
    """A step kernel's launches over one call (ms: each launch's ms in
    order; lives: the lanes live before each; n: the lanes): its launches,
    summed ms and, in each LIVE_BANDS band, its launches, summed and mean
    ms."""
    if len(ms) != len(lives):
        raise AssertionError(f"{len(ms)} launches traced, {len(lives)} "
                             "steps run")
    bands = {}
    for t, live in zip(ms, lives):
        b = bands.setdefault(live_band(live, n), {"launches": 0, "ms": 0.0})
        b["launches"] += 1
        b["ms"] += t
    for b in bands.values():
        b["mean_ms"] = b["ms"] / b["launches"]
    return {"launches": len(ms), "ms": sum(ms),
            "bands": {label: bands[label] for label, _ in LIVE_BANDS
                      if label in bands}}


def _profile_loop(fn, args, tdir) -> list:
    """kernel_events of one run of loop fn on a clone of its recorded
    arguments under utils.metrics.profiler_trace (trace in tdir)."""
    import shutil

    import torch

    from lordfast_tpu_torch.utils.metrics import profiler_trace

    shutil.rmtree(tdir, ignore_errors=True)
    a = _clone(args)
    torch.cuda.synchronize()
    with profiler_trace(tdir, "cuda"):
        fn(*a)
        torch.cuda.synchronize()
    return kernel_events(tdir)


def call_sums(events, lives, n, step) -> dict:
    """One profiled loop call's seed_shard.cu kernels: for the step kernel
    ``step`` band_sums over its launches, for the bucket and answer their
    launches and summed ms."""
    out = {}
    for name in ("shard_bucket", "shard_answer", step):
        ms = [t for k, t in events if f"{name}_kernel" in k]
        out[name] = (band_sums(ms, lives, n) if name == step
                     else {"launches": len(ms), "ms": sum(ms)})
    return out


def compare_shard(o_shard, runs, other, reps):
    """--against's sharded part, on NCCL over a group of one in this
    process: for each run (label, index, reads), a sharded engine's pass
    records the first calls and the loops' first calls (record_shard),
    and check_shard_kernels finds the step kernels' sparse list steps
    and times this checkout's four kernels beside their bounds and the
    step kernels' floors; then both checkouts' kernels, each held to the
    plain version first, are timed on those calls in turns A B B A (the
    other's step kernels over the flags, this one's over the recorded
    list); then each loop's first call is run again with each
    checkout's loop (_compare_calls): under the profiler, A B B A, each
    step kernel's launches, summed ms and mean ms by live share
    (band_sums) and the bucket's and answer's sums, and unprofiled, A B
    B A three times, the call's wall and the step wrapper's host ms a
    step; then a pass to warm up and eight, A B B A twice, with each
    checkout's loops (and so its kernels) in place, every SAM equal:
    rank 0's ``device`` timer, the wall, the loops' counts, a step's
    ``device`` ms beside the kernels' ms a step summed over the profiled
    calls."""
    import torch.distributed as dist

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.ops import fm_shard_cuda as K
    from lordfast_tpu_torch.parallel.mesh import make_mesh
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    o_fm = sys.modules[f"{OTHER}.ops.fm_index"]
    kernels = {"this": {n: getattr(K, n) for n in SHARD_KERNELS},
               "other": {n: getattr(o_shard, n) for n in SHARD_KERNELS}}
    kernels["other"]["shard_answer"] = _routed_optional(
        o_shard.shard_answer)
    sides = {"this": {n: getattr(K, n) for n in SHARD_SIDE},
             "other": {n: getattr(o_shard, n) for n in SHARD_SIDE}}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh("cuda")
        for label, idx, reads in runs:
            eng = MappingEngine(idx, LordfastConfig(), device="cuda",
                                mesh=mesh, shard_index=True)
            with record_shard() as rec:
                eng.map_file(reads, io.StringIO(), "chip_smoke")
            figs = check_shard_kernels(rec, timed=True, reps=reps)
            log(f"[compare] {label} sharded: " + json.dumps(
                {t: {k: f[k] for k in ("ms", "bound_ms", "plain_ms",
                                       "floor_ms", "live", "lanes")
                     if k in f}
                 for t, f in figs.items()}))
            for tag in figs:
                _compare_kernel(tag, rec, kernels, figs, label, other, reps)
            sums = _compare_calls(rec, sides,
                                  {"this": K, "other": o_shard}, label,
                                  other)
            _compare_passes(eng, reads, sides, o_fm, sums, label, other)
            del eng
    finally:
        dist.destroy_process_group()


def _compare_kernel(tag, rec, kernels, figs, label, other, reps):
    """Both checkouts' kernel of one recorded call, each held to this
    checkout's plain version first, timed A B B A (a step kernel: the
    other's over the flags, this one's over the recorded list)."""
    import torch

    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    args, kw = rec.calls[tag]
    name = tag.split()[0]
    fns = {}
    for side, fn in kernels.items():
        f = fn[name]
        if name == "shard_bucket":
            if side == "other":
                _other_bucket_check(f, args, kw)
            bufs = [args[7].clone(), args[8].clone(), args[9].clone(),
                    torch.zeros_like(args[10])]
            fns[side] = lambda f=f, b=bufs: f(*args[:7], *b, **kw)
        elif name == "shard_answer":
            recv, arrs, base, dst = args
            out = torch.empty_like(dst)
            want = torch.empty_like(dst)
            f(recv, arrs, base, out, **kw)
            K.shard_answer_plain(recv, arrs, base, want, **kw)
            took = recv != -1
            if not torch.equal(out[took], want[took]):
                raise AssertionError(f"[compare] {side} {tag} != plain")
            fns[side] = lambda f=f, o=out: f(recv, arrs, base, o, **kw)
        else:
            this = side == "this"
            n_args = _step_args(name, args, kw)[0]
            got, want = _clone(args), _clone(args)
            f(*got[:n_args], **({"lanes": _clone(kw["lanes"])} if this
                                else {}))
            getattr(K, name + "_plain")(*want[:n_args],
                                        lanes=_clone(kw["lanes"]))
            if not all(torch.equal(x, y) for x, y in zip(got[0], want[0])):
                raise AssertionError(f"[compare] {side} {tag} != plain")
            fns[side] = _time_step(name, args, kw, f, reps, lanes=this)
    ms = {"this": [], "other": []}
    for side in ("this", "other", "other", "this"):
        ms[side].append(_time_launches(fns[side], reps))
    log(json.dumps({"case": f"{tag} {label}", "ms_this": ms["this"],
                    "ms_other": ms["other"],
                    "bound_ms": figs[tag]["bound_ms"],
                    **({"floor_ms": figs[tag]["floor_ms"]}
                       if "floor_ms" in figs[tag] else {}),
                    "other": str(other)}))


class _HostTimed(_Recorder):
    """A wrapper's stand-in that adds the host seconds of each of its
    calls to ``spent`` (the launch is asynchronous: what the host pays to
    check and launch)."""

    def __init__(self, fn):
        super().__init__(fn, None)
        self.spent = 0.0

    def __call__(self, *args, **kw):
        t = time.perf_counter()
        try:
            return self.__wrapped__(*args, **kw)
        finally:
            self.spent += time.perf_counter() - t


# the order of --against's turns: A B B A, as often as a figure takes
ABBA = ("this", "other", "other", "this")


def _compare_calls(rec, sides, mods, label, other) -> dict:
    """Each loop's first recorded call run again with each checkout's loop
    (``sides``; ``mods``: each side's fm_shard_cuda, whose step kernel
    its loop launches): under the profiler, A B B A (call_sums), then
    unprofiled, A B B A three times: the call's wall ms a step, from a
    synchronise to a synchronise (the host's launches and collectives:
    the card waits on them), and the host ms a step in the step kernel's
    wrapper (_HostTimed); logs one line a loop.  Returns {side: the four
    kernels' summed ms a step over both loops' profiled calls, each
    side's mean}."""
    import torch

    lives = rec.replay()
    per_step = {"this": [0.0, 0], "other": [0.0, 0]}
    for loop, step in STEP_LOOPS.items():
        if loop not in lives:  # a full SA has no walk
            continue
        args = rec.calls[loop][0]
        n, steps = int(args[3].numel()), len(lives[loop])
        res = {"this": [], "other": []}
        for i, side in enumerate(ABBA):
            ev = _profile_loop(sides[side][loop], args,
                               CACHE / "profile" / f"shard_call_{i}")
            res[side].append(call_sums(ev, lives[loop], n, step))
        for side, r in res.items():
            per_step[side][0] += sum(sum(x["ms"] for x in c.values())
                                     for c in r) / len(r)
            per_step[side][1] += steps
        wall = {"this": [], "other": []}
        host = {"this": [], "other": []}
        for side in ABBA * 3:
            a = _clone(args)
            f = getattr(mods[side], step)
            timed = _HostTimed(f)
            setattr(mods[side], step, timed)
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                sides[side][loop](*a)
                torch.cuda.synchronize()
                wall[side].append((time.perf_counter() - t) * 1e3 / steps)
            finally:
                setattr(mods[side], step, f)
            host[side].append(timed.spent * 1e3 / steps)
        log(json.dumps({"case": f"{loop} call summed {label}",
                        "lanes": n, "steps": steps,
                        "calls_this": res["this"],
                        "calls_other": res["other"],
                        "wall_ms_a_step_this": wall["this"],
                        "wall_ms_a_step_other": wall["other"],
                        "step_host_ms_this": host["this"],
                        "step_host_ms_other": host["other"],
                        "other": str(other)}))
    return {side: ms / max(steps, 1) for side, (ms, steps)
            in per_step.items()}


def _compare_passes(eng, reads, sides, o_fm, sums, label, other):
    """A sharded pass to warm up, then eight, A B B A twice, each with one
    checkout's loops in place (the loops call their own checkout's
    kernels), every SAM equal; one line of each side's passes (the
    warm-up's too)."""
    import torch

    from lordfast_tpu_torch.ops import fm_index
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    passes = {"this": [], "other": [], "warm-up": []}
    sams = set()
    try:
        for side in ("warm-up",) + ABBA * 2:
            for n, f in sides.get(side, sides["this"]).items():
                setattr(K, n, f)
            for counts in (fm_index.shard_counts, o_fm.shard_counts):
                counts.update(dict.fromkeys(counts, 0))
            out = io.StringIO()
            t = time.time()
            eng.map_file(reads, out, "chip_smoke")
            torch.cuda.synchronize()
            # calls count in this checkout's pipeline, the rest in the
            # loops' own
            c = {k: fm_index.shard_counts[k] + o_fm.shard_counts.get(k, 0)
                 for k in fm_index.shard_counts}
            steps = max(c["steps"], 1)
            device_s = eng.metrics.timers.get("device", 0.0)
            passes[side].append({
                "wall_s": time.time() - t, "device_s": device_s,
                "device_ms_a_step": device_s * 1e3 / steps,
                "kernels_ms_a_step": sums.get(side, sums["this"]),
                "host_reads_a_call": c["host_reads"] / max(c["calls"], 1),
                **c})
            sams.add(out.getvalue())
    finally:
        for n, f in sides["this"].items():
            setattr(K, n, f)
    if len(sams) != 1:
        raise AssertionError(f"[compare] {label}: the sharded passes' SAMs "
                             "differ")
    log(json.dumps({"case": f"sharded passes {label}",
                    "passes_this": passes["this"],
                    "passes_other": passes["other"],
                    "pass_warm_up": passes["warm-up"], "other": str(other)}))


def _seed_line(tag, rec, stats, need):
    eff = warp_efficiency(stats)
    n = stats[:, :4].astype("int64").sum(0)
    top, last = longest_warp(stats), last_warp(stats)
    return (f"[loops] seed_ext {tag}: {stats.shape[0]} lanes "
            f"({int(rec['lanes'][0].sum())} alive), {int(n[0])} extension "
            f"steps, {int(n[1])} walk steps, {int(n[2])} chars matched in "
            f"{int(n[3])} compare round trips: k, l, m, rpos, rflag equal "
            "to _staged_ext | input bytes needed "
            + " ".join(f"{k} {v}" for k, v in need.items())
            + f" (all {seed_work(rec, need):.0f}) | warp efficiency "
            + " ".join(f"{k} {v:.3f}" for k, v in eff.items())
            + " | the warp with the most steps issues "
            + " ".join(f"{k} {v}" for k, v in top.items())
            + f" | the warp that ends last ends {last['end_us']:.1f} us after"
            f" the first lane starts, out of the extension by "
            f"{last['ext_us']:.1f} us, and issues "
            + " ".join(f"{k} {last[k]}" for k in (*STEP_KINDS, "all"))
            + f"; half the warps end by {last['p50_us']:.1f} us, 99% by "
            f"{last['p99_us']:.1f} us (a launch with the timers on)")


def sam_records(text: str):
    return [line for line in text.splitlines() if not line.startswith("@")]


def read_digests(text: str) -> dict:
    """{read name: sha256 of its record lines}, each line with its
    newline, in the SAM's order; the header lines aside."""
    import hashlib

    recs = {}
    for line in sam_records(text):
        recs.setdefault(line.split("\t", 1)[0], []).append(line + "\n")
    return {name: hashlib.sha256("".join(lines).encode()).hexdigest()
            for name, lines in recs.items()}


def map_pass(eng, reads_path, record=None):
    """One synchronised map_file pass with the launch counts set to 0
    just before it and read just after: (sam, seconds, reads, mapped,
    launches).  record: a record_loops to run the pass in."""
    import contextlib

    import torch

    n0, m0 = eng.stats["reads"], eng.stats["mapped"]
    out = io.StringIO()
    reset_launches()
    t = time.time()
    with record if record is not None else contextlib.nullcontext():
        eng.map_file(reads_path, out, "chip_smoke")
        torch.cuda.synchronize()
    dt = time.time() - t
    return (out.getvalue(), dt, eng.stats["reads"] - n0,
            eng.stats["mapped"] - m0, read_launches())


def check_launches(path, launches, counters, needed, plain=False,
                   sampled=False, sharded=False):
    """Each gap and affine kernel's launches equal the sub-batches its
    stages counted, every kernel in ``needed`` launched, and the loops
    the kernels replace (chain_dp, seed_ext and sa_locate's; a sharded
    index's, seed_shard.cu's four) were not entered (with ``plain``, the
    engine's plain_loops pass: none of those kernels launched and, with
    ``sharded``, the sharded loops entered).  With ``sampled`` (an index
    with a sampled SA) a pass that launches seed_ext launches sa_locate
    as often, once a device call; without, a pass neither launches
    sa_locate nor shard_walk_step nor walks (the full SA's locate is one
    gather)."""
    stages = {"myers_dist": ("gap_parts", "esc_split_parts"),
              "myers_moves": ("esc_nw_parts",),
              "affine_extend": ("esc_affine_parts",)}
    if not sampled:
        needed = [k for k in needed if k not in ("sa_locate",
                                                 "shard_walk_step")]
        if any(launches.get(k, 0) for k in ("sa_locate", "sa_lookup",
                                            "shard_walk_step",
                                            "_shard_walk")):
            raise AssertionError(f"{path}: a full SA, yet a locate walk: "
                                 f"{launches}")
    elif not plain and launches["sa_locate"] != launches["seed_ext"]:
        raise AssertionError(f"{path}: sa_locate launched "
                             f"{launches['sa_locate']} times for "
                             f"{launches['seed_ext']} seed_ext launches")
    for name, n in launches.items():
        if name in stages:
            parts = sum(counters.get(k, 0) for k in stages[name])
            if n != parts:
                raise AssertionError(f"{path}: {name} launched {n} times "
                                     f"for {parts} "
                                     f"{' + '.join(stages[name])}")
        if name in needed and n <= 0:
            raise AssertionError(f"{path}: {name} never launched")
    if plain:
        if any(launches.get(k, 0) for k in LOOP_KERNELS + SHARD_KERNELS):
            raise AssertionError(f"{path}: plain loops, yet {launches}")
        entered = SHARD_LOOPS if sampled else SHARD_LOOPS[:1]
        if sharded and not all(launches[k] for k in entered):
            raise AssertionError(f"{path}: plain loops, yet the sharded "
                                 f"loops were not entered: {launches}")
    elif any(launches.get(k, 0) for k in LOOPS + SHARD_LOOPS):
        raise AssertionError(f"{path}: an eager loop ran on cuda: "
                             f"{ {k: launches.get(k, 0) for k in LOOPS} }, "
                             f"{ {k: launches.get(k, 0) for k in SHARD_LOOPS} }")


def _stage_line(eng):
    tm = eng.metrics.timers
    return " ".join(f"{k} {tm[k]:.3f}" for k in (
        "device", "gap_dp", "esc_dp", "esc_affine", "esc_wait", "stitch",
        "emit") if k in tm)


def phase_golden():
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import build_index
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    cfg = LordfastConfig(**GOLDEN_CFG)
    idx = build_index(DATA / "ref.fa", LordfastConfig(kmer_cache_k=8),
                      verbose=False)
    eng = MappingEngine(idx, cfg, device="cuda")
    if not eng._esc_device:
        raise AssertionError("golden: the offload is not on by default")
    caps = record_loops()
    sam, dt, _, _, launches = map_pass(eng, DATA / "reads.fq", caps)
    c = eng.metrics.counters
    ours = sam_records(sam)
    golden = sam_records((DATA / "golden.sam").read_text())
    if len(ours) != len(golden):
        raise AssertionError(f"golden: {len(ours)} records, expected "
                             f"{len(golden)}")
    for i, (a, b) in enumerate(zip(golden, ours)):
        if a != b:
            raise AssertionError(f"golden line {i} differs:\nG: {a[:200]}\n"
                                 f"O: {b[:200]}")
    if c.get("esc_sites", 0) <= 0:
        raise AssertionError("golden: the escalation offload never fired")
    check_launches("golden", launches, c, KERNELS)
    log(f"[golden] {len(ours)} SAM records byte-equal to golden.sam on "
        f"cuda, offload on, in {dt:.2f} s; esc_sites {c['esc_sites']}; "
        f"launches {launches} == sub-batches (gap_parts "
        f"{c['gap_parts']}, esc_nw_parts {c['esc_nw_parts']}, "
        f"esc_affine_parts {c['esc_affine_parts']})")
    check_split_paths(eng, idx)
    sam, warm_s, _, _, _ = map_pass(eng, DATA / "reads.fq")
    log(f"[golden] warm pass {warm_s:.3f} s")
    plain_pass("golden", MappingEngine(idx, cfg, device="cuda",
                                       plain_loops=True),
               DATA / "reads.fq", sam, warm_s)
    return launches, dict(idx=idx, warm_s=warm_s, caps=caps)


def plain_pass(tag, eng, reads, sam, warm_s, passes=1):
    """``passes`` passes of an engine with plain_loops=True (the device
    stage's seed-extension, locate and chaining loops through their
    plain PyTorch versions): each SAM equals the kernels' ``sam``, no
    loop kernel launched and the loops ran (the locate walk with a
    sampled SA).  Logs the last pass beside the kernels' warm pass
    (warm_s); returns its map_pass result."""
    sampled = eng.meta["sa_intv"] > 1
    loops = [k for k in LOOPS if sampled or k != "sa_lookup"]
    for i in range(passes):
        res = map_pass(eng, reads)
        if res[0] != sam:
            raise AssertionError(f"{tag}: the plain loops' SAM differs from "
                                 "the kernels'")
        check_launches(f"{tag} plain loops", res[4], eng.metrics.counters,
                       ("myers_dist",), plain=True, sampled=sampled)
        if not all(res[4][k] for k in loops):
            raise AssertionError(f"{tag}: plain loops not entered: "
                                 f"{res[4]}")
    log(f"[{tag}] plain loops (MappingEngine(plain_loops=True)), pass "
        f"{passes}: {res[1]:.3f} s against the kernels' warm {warm_s:.3f} s"
        f", SAM equal | {_stage_line(eng)} | launches {res[4]}")
    return res


def check_split_paths(eng, idx, n=40):
    """Phase C's device paths at edlib's Hirschberg size
    (engine._run_nw_paths: myers_dist's last column, the split,
    myers_moves on the pieces) against the host stitcher's nw_align
    (native edlib) on n segments of the golden reference: junk, related,
    half-related and twice-mutated queries, both strands."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.align import edlib_eq as ted
    from lordfast_tpu_torch.utils.pack import revcomp_codes

    rng = np.random.default_rng(20261018)
    qs, items, want = [], [], []
    for i in range(n):
        tn = int(rng.integers(1200, 4300))
        t0 = int(rng.integers(0, idx.l_pac - tn))
        t = idx.get_ref_codes(t0, tn)
        q = [lambda: rng.integers(0, 4, int(rng.integers(700, 4000))),
             lambda: _mutate(rng, t, 0.15),
             lambda: np.concatenate([_mutate(rng, t[: tn // 2], 0.15),
                                     rng.integers(0, 4, tn // 3)]),
             lambda: _mutate(rng, _mutate(rng, t, 0.15), 0.15),
             ][i % 4]()[:4096].astype(np.uint8)
        qrc, trc = bool(rng.integers(0, 2)), bool(rng.integers(0, 2))
        qs.append(q)
        items.append(((0, i, eng.ESC_NW_A),
                      (i, 0, len(q), qrc, t0, tn, trc, False)))
        want.append(ted.nw_path(revcomp_codes(q) if qrc else q,
                                revcomp_codes(t) if trc else t))
    reads = np.full((n, max(map(len, qs))), 4, np.uint8)
    for i, q in enumerate(qs):
        reads[i, : len(q)] = q
    eng.metrics.reset()
    t = time.time()
    got = eng._run_nw_paths(items, torch.from_numpy(reads).cuda())
    dt = time.time() - t
    for (key, d), (dist, mv) in zip(items, want):
        g = got[key]
        if g[0] != dist or not np.array_equal(g[2], mv):
            raise AssertionError(f"split paths: segment {key[1]} "
                                 f"({d[2]} x {d[5]}) differs from edlib")
    c = eng.metrics.counters
    n_big = sum(eng._edlib_splits(d[2], d[5]) for _, d in items)
    if c.get("esc_splits", 0) < n_big or n_big == 0:
        raise AssertionError(f"split paths: {c.get('esc_splits', 0)} "
                             f"splits for {n_big} Hirschberg-size segments")
    log(f"[golden] split paths: {n} segments ({n_big} at edlib's Hirschberg "
        f"size, {c['esc_splits']} splits) equal edlib's paths, in "
        f"{dt:.3f} s on cuda ({c['esc_split_parts']} myers_dist column "
        f"launches, {c['esc_nw_parts']} myers_moves launches)")


def _paths(tag: str):
    """(reference, reads) of the dataset tag (v1, v2, g300 or g1200) in
    .smoke_cache/."""
    pre = {"v1": "v1_bench", "v2": "bench", "g300": "g300",
           "g1200": "g1200"}[tag]
    return CACHE / f"{pre}_ref.fa", CACHE / f"{pre}_reads.fq"


def _dataset(easy: bool):
    """The bench's v1 (easy) or v2 dataset, generated into .smoke_cache/
    once."""
    import bench

    CACHE.mkdir(exist_ok=True)
    ref, reads = _paths("v1" if easy else "v2")
    if not (ref.exists() and reads.exists()):
        t = time.time()
        bench.gen_dataset(CACHE, easy=easy)
        log(f"[{'v1' if easy else 'v2'}] generated the dataset in "
            f"{time.time() - t:.1f} s")
    return ref, reads


def _subset(src: Path, dst: Path, keep):
    """Write the reads of src whose names pass keep(name) to dst; returns
    their names."""
    lines = src.read_text().splitlines(keepends=True)
    names, out = [], []
    for i in range(0, len(lines), 4):
        name = lines[i][1:].split()[0]
        if keep(name, i // 4):
            names.append(name)
            out.extend(lines[i : i + 4])
    dst.write_text("".join(out))
    return set(names)


def _index(ref, tag):
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import build_index

    t = time.time()
    idx = build_index(ref, LordfastConfig(), verbose=tag in GENOMES)
    log(f"[{tag}] index built in {time.time() - t:.1f} s (l_pac "
        f"{idx.l_pac}, sa_intv {idx.sa_intv}, kcache k={idx.kcache_k})")
    return idx


def _random_genome(ref: Path, tag: str):
    """The random genome tag of GENOMES, seeded, one contig named tag,
    written as FASTA lines of 100 bases."""
    import numpy as np

    bp, seed = GENOMES[tag]
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    tmp = ref.with_suffix(".part")
    step = 10_000_000
    with open(tmp, "wb") as f:
        f.write(f">{tag}\n".encode())
        for s0 in range(0, bp, step):
            n = min(step, bp - s0)
            lines = np.full((n // 100, 101), ord("\n"), np.uint8)
            lines[:, :100] = lut[rng.integers(0, 4, n)].reshape(-1, 100)
            f.write(lines.tobytes())
    os.replace(tmp, ref)


def build_bench(tag: str) -> int:
    """Generate the dataset ``tag`` into .smoke_cache/ and save its index
    there as ``{tag}.lft.npz``: the process that start_builds starts
    (``chip_smoke.py --build-bench TAG``).  v1 and v2: the bench's
    datasets.  g300 and g1200: the random genome (GENOMES), its index at
    LordfastConfig() (the SA sampled at 32; int64 positions at 1.2 Gbp),
    then 512 reads of bench.gen_gbp_reads; logs each step's seconds (the
    builder's own lines give its stages') and the process's peak RSS."""
    import bench
    from lordfast_tpu_torch.index.builder import save_index

    t = time.time()
    if tag in GENOMES:
        CACHE.mkdir(exist_ok=True)
        ref, reads = _paths(tag)
        if not ref.exists():
            _random_genome(ref, tag)
        log(f"[{tag}] genome of {GENOMES[tag][0]} bp written in "
            f"{time.time() - t:.1f} s")
    else:
        ref, _ = _dataset(easy=tag == "v1")
    idx = _index(ref, tag)
    t_save = time.time()
    tmp = CACHE / f"{tag}.part.npz"
    save_index(idx, tmp)
    os.replace(tmp, CACHE / f"{tag}.lft.npz")
    t_reads = time.time()
    if tag in GENOMES:
        bench.gen_gbp_reads(idx, reads)
    log(f"[{tag}] index saved in {t_reads - t_save:.1f} s, reads in "
        f"{time.time() - t_reads:.1f} s; all in {time.time() - t:.1f} s; "
        f"the build process's peak RSS "
        f"{_peak_rss_gib(resource.RUSAGE_SELF):.2f} GiB")
    return 0


def start_builds(tags) -> dict:
    """One process for each dataset of tags, started together, that
    generates it and builds and saves its index (build_bench) on the
    host while the card runs the phases before the one that loads it;
    {tag: (process, its output file, its start time)}.  The processes
    see no card."""
    CACHE.mkdir(exist_ok=True)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    builds = {}
    for tag in tags:
        out = CACHE / f"build_{tag}.log"
        with open(out, "w") as f:
            builds[tag] = (subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--build-bench",
                 tag], cwd=ROOT, env=env, stdout=f,
                stderr=subprocess.STDOUT), out, time.time())
    return builds


def _peak_rss_gib(who) -> float:
    return resource.getrusage(who).ru_maxrss / 2**20


def mem_available_gib() -> float:
    for line in open("/proc/meminfo"):
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2**20
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def g1200_staggered() -> bool:
    """Whether the g1200 build must wait for v1's and v2's: the host has
    less RAM available than the four builds take at their peaks
    (BUILD_PEAK_GIB).  Staggered, _phases starts it once phase_v2 has
    waited for both."""
    avail = mem_available_gib()
    need = sum(BUILD_PEAK_GIB.values())
    log(f"[smoke] MemAvailable {avail:.1f} GiB before the builds; their "
        f"peaks take {need:.1f} GiB ({BUILD_PEAK_GIB}): "
        + ("g1200's build starts once v1's and v2's have ended"
           if avail < need else "g1200's build starts first, now"))
    return avail < need


def keep_layout(idx):
    """idx with its host layout (FMIndex.host_arrays: the packed text, the
    fused rank rows) made once and kept on it, as load_index keeps a
    device-layout sidecar's: every engine, shard and byte count then
    reuses it instead of making it again (~10 s at 300 Mbp, ~40 s at
    1.2 Gbp)."""
    if idx._host_cache is None:
        idx._host_cache = idx.host_arrays()
    return idx


def _built(builds, tag):
    """(ref, reads, index) of the bench dataset tag, once its build_bench
    process has ended; its log lines are relayed."""
    from lordfast_tpu_torch.index.builder import load_index

    t = time.time()
    proc, out, started = builds[tag]
    rc = proc.wait(timeout=max(BUILD_WAIT_S[tag] - (time.time() - started),
                               1))
    waited = time.time() - t
    text = out.read_text()
    if rc != 0:
        raise AssertionError(f"{tag}: the dataset and index build exited "
                             f"{rc}: {text[-2000:]}")
    for line in text.splitlines():
        if line.startswith((f"[{tag}]", "[index]")):
            log(line)
    t = time.time()
    idx = keep_layout(load_index(CACHE / f"{tag}.lft.npz"))
    log(f"[{tag}] built in a process of its own alongside the phases "
        f"before (waited {waited:.1f} s for it); index loaded and its "
        f"host layout made in {time.time() - t:.1f} s; MemAvailable "
        f"{mem_available_gib():.1f} GiB")
    return (*_paths(tag), idx)


# bench.gen_gbp_reads' RNG seed (bench.py), for gbp_origins
GBP_READS_SEED = 4242
# The truth check's floors: the share of reads on their drawn origin,
# and the least number of reads whose located text positions lie at or
# above 2**31 (high_reads)
MIN_ORIGIN_FRAC = 0.95
MIN_HIGH_READS = 40


def gbp_origins(idx, n: int = 512) -> list:
    """(start, length, reverse) of each of the first n reads that
    bench.gen_gbp_reads writes for idx, by replaying its RNG stream draw
    for draw: the length, the start, the strand, then bench._noise's
    draws, which depend on the fragment's length alone (a fragment of
    that length stands in for it).  Reads nothing of the index but
    l_pac, so it shares no code with the mapper it checks."""
    import numpy as np

    import bench

    rng = np.random.default_rng(GBP_READS_SEED)
    out = []
    for _ in range(n):
        ln = int(rng.integers(2000, 20000))
        st = int(rng.integers(0, idx.l_pac - ln))
        rev = bool(rng.random() < 0.5)
        bench._noise(rng, "A" * ln)
        out.append((st, ln, rev))
    return out


def high_reads(origins, l_pac: int) -> list:
    """Indices of the reads whose located text positions lie at or above
    2**31.  The seeding searches the reverse complement of each anchor,
    so a forward read's anchor at forward position x is located at
    2 l_pac - x - len in the text's upper half (a reverse read's below
    l_pac; tests/test_torch_pos64.py shows it): forward reads with
    start + length <= 2 l_pac - 2**31."""
    return [i for i, (st, ln, rev) in enumerate(origins)
            if not rev and st + ln <= 2 * l_pac - 2**31]


def _ref_span(cigar: str) -> int:
    import re

    return sum(int(n) for n, op in re.findall(r"(\d+)([MDN=X])", cigar))


def origin_check(sam: str, origins, offsets: dict) -> dict:
    """{read index: True when read g<i>'s primary record (flag without
    0x4, 0x100, 0x800) has the read's drawn strand and its aligned
    reference span [POS, POS + the CIGAR's reference length) overlaps
    the drawn [start, start + length)} for every read of origins; a read
    with no primary record is False.  offsets: {contig name: its forward
    offset}."""
    ok = dict.fromkeys(range(len(origins)), False)
    for line in sam_records(sam):
        f = line.split("\t")
        flag = int(f[1])
        if flag & 0x904 or not f[0].startswith("g"):
            continue
        i = int(f[0][1:])
        if i not in ok:
            continue
        st, ln, rev = origins[i]
        beg = offsets[f[2]] + int(f[3]) - 1
        end = beg + _ref_span(f[5])
        ok[i] = bool(flag & 0x10) == rev and beg < st + ln and st < end
    return ok


def _cpu_subset(idx, sam, reads, dst, keep, tag, cfg=None, **kw):
    """The reads keep() selects, mapped on the CPU (at cfg, default
    LordfastConfig()), against the cuda records of the same reads."""
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    names = _subset(reads, dst, keep)
    cuda_sub = [r for r in sam_records(sam) if r.split("\t")[0] in names]
    t = time.time()
    eng = MappingEngine(idx, cfg or LordfastConfig(), device="cpu", **kw)
    out = io.StringIO()
    eng.map_file(dst, out, "chip_smoke")
    cpu_sub = sam_records(out.getvalue())
    if cpu_sub != cuda_sub:
        bad = next(i for i, (a, b) in enumerate(zip(cuda_sub, cpu_sub))
                   if a != b) if len(cpu_sub) == len(cuda_sub) else -1
        raise AssertionError(f"{tag}: {len(names)} reads differ between cpu "
                             f"and cuda (record {bad}; {len(cpu_sub)} vs "
                             f"{len(cuda_sub)} records)")
    log(f"[{tag}] {len(names)} reads: {len(cpu_sub)} SAM records "
        f"byte-equal between cuda and cpu (cpu run {time.time() - t:.1f} s, "
        f"esc_sites {eng.metrics.counters.get('esc_sites', 0)})")


def jax_digests(config, tag, path=None) -> dict:
    """The JAX package's {"reads": N, "digests": {read: sha256}} of
    dataset tag (v1 or v2) under a configuration: None for
    LordfastConfig() (the file's "datasets"), else its name under
    "configs" (clasp, extend-whole-2, extend-whole-3)."""
    want = json.loads((path or JAX_DIGESTS).read_text())
    return (want["datasets"] if config is None
            else want["configs"][config])[tag]


def divergent_key(config, tag, read) -> tuple:
    """A read's KNOWN_DIVERGENT key: (dataset, read) under
    LordfastConfig(), (configuration, dataset, read) under another."""
    return (tag, read) if config is None else (config, tag, read)


def check_digests(tag, sam, config=None, names=None):
    """Every read's records in the card's SAM of dataset tag (v1 or v2)
    against the JAX package's (JAX_DIGESTS, one sha256 a read, made on
    the CPU by tools/torch_jax_sams.py) under a configuration (None:
    LordfastConfig(); else its name, jax_digests): a read that differs
    fails, unless KNOWN_DIVERGENT names it with its cause, which is
    printed.  names: the reads that were mapped, a subset of the
    dataset's (None: all of them); each must have records, and no other
    read may."""
    want = json.loads(JAX_DIGESTS.read_text())
    sec = want if config is None else want["configs"][config]
    ds = (want["datasets"] if config is None else sec)[tag]
    label = f"{tag} {config}" if config else tag
    got = read_digests(sam)
    if names is None:
        if set(got) != set(ds["digests"]) or len(got) != ds["reads"]:
            raise AssertionError(f"{label}: {len(got)} reads with records, "
                                 f"the JAX package's SAM has {ds['reads']}")
        names = list(ds["digests"])
    outside = [n for n in names if n not in ds["digests"]]
    if outside:
        raise AssertionError(f"{label}: {len(outside)} mapped reads are not "
                             f"in the dataset: {outside[:10]}")
    missing = [n for n in names if n not in got]
    extra = sorted(set(got) - set(names))
    if missing or extra:
        raise AssertionError(f"{label}: {len(missing)} mapped reads have no "
                             f"records ({missing[:10]}), {len(extra)} reads "
                             f"that were not mapped have ({extra[:10]})")
    bad = [n for n in names if got[n] != ds["digests"][n]]
    known = [n for n in bad if divergent_key(config, tag, n)
             in KNOWN_DIVERGENT]
    unknown = [n for n in bad if n not in known]
    if unknown:
        raise AssertionError(f"{label}: {len(unknown)} reads' records differ "
                             f"from the JAX package's: {unknown[:10]}")
    log(f"[{label}] {len(names) - len(bad)} of {len(names)} reads' records "
        f"equal the JAX package's on the CPU (sha256 a read, "
        f"{JAX_DIGESTS.name}, {config or 'LordfastConfig()'}, JAX package "
        f"at {sec['jax_package_commit'][:10]}); {len(known)} known to "
        f"differ"
        + "".join(f"; {n}: {KNOWN_DIVERGENT[divergent_key(config, tag, n)]}"
                  for n in known))


def _report(tag, label, eng, res):
    sam, dt, n, m, launches = res
    log(f"[{tag}] {label}: {n} reads in {dt:.3f} s -> {n / dt:.2f} reads/s "
        f"| {m} mapped | {_stage_line(eng)} | launches {launches}")


def gap_parts(counters) -> dict:
    """{(kernel, Q, T): [part sizes, one per launch]} from the engine's
    gpart_{mode}_{Q}x{T}_{n} counters (verbosity >= 2)."""
    parts = {}
    for key, cnt in counters.items():
        if not key.startswith("gpart_"):
            continue
        mode, shape, n = key.split("_")[1:]
        Q, T = map(int, shape.split("x"))
        kern = "myers_moves" if mode == "moves" else "myers_dist"
        parts.setdefault((kern, Q, T), []).extend([int(n)] * cnt)
    return {k: sorted(v) for k, v in sorted(parts.items())}


def affine_parts(counters) -> dict:
    """{("affine_extend", Qe, Te): [part sizes, one per launch]} from the
    engine's esc_b{Qe} counters (problems per affine bucket, launched in
    parts of at most the bucket's G)."""
    from lordfast_tpu_torch.config import LordfastConfig

    parts = {}
    for Qe, Te, G in LordfastConfig().affine_buckets:
        n = counters.get(f"esc_b{Qe}", 0)
        if n:
            parts[("affine_extend", Qe, Te)] = sorted(
                [G] * (n // G) + ([n % G] if n % G else []))
    return parts


def _report_buckets(tag, eng):
    c = eng.metrics.counters
    log(f"[{tag}] gaps per bucket: " + " ".join(
        f"{k} {v}" for k, v in sorted(c.items()) if k.startswith("gaps_b")))
    log(f"[{tag}] launches per bucket (kernel Q x T: launches, part sizes "
        f"min/median/max): " + "; ".join(
            f"{k} {Q}x{T}: {len(v)}, {v[0]}/{v[len(v) // 2]}/{v[-1]}"
            for (k, Q, T), v in gap_parts(c).items()))


def phase_v1(builds):
    """v1 with the offload on (two passes) and off (one), on the card;
    returns the first pass's launch counts, the index and the reads.
    builds: start_builds'."""
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    _, reads, idx = _built(builds, "v1")
    cfg = LordfastConfig(verbosity=2)
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    eng = MappingEngine(idx, cfg, device="cuda")
    log(f"[v1] engine set up (index arrays on the card) in "
        f"{time.time() - t:.2f} s")
    runs = []
    caps = record_loops(LOG_COUNT_CALLS)
    for label in ("first pass, offload on", "second pass, offload on"):
        runs.append(map_pass(eng, reads, caps if not runs else None))
        _report("v1", label, eng, runs[-1])
        check_launches("v1", runs[-1][4], eng.metrics.counters,
                       ("myers_dist", *LOOP_KERNELS))
        if label.startswith("first"):
            _report_buckets("v1", eng)
    log(f"[v1] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; metrics "
        f"{eng.metrics.to_json()}")
    eng_off = MappingEngine(idx, cfg, device="cuda", esc_device=False)
    runs.append(map_pass(eng_off, reads))
    _report("v1", "pass, offload off (warm process)", eng_off, runs[-1])
    check_launches("v1 offload off", runs[-1][4], eng_off.metrics.counters,
                   ("myers_dist", *LOOP_KERNELS))
    sam, _, n_reads, n_mapped, _ = runs[0]
    if any(r[0] != sam for r in runs[1:]):
        raise AssertionError("v1: the passes gave different SAM")
    if n_mapped < MIN_MAPPED_FRAC * n_reads:
        raise AssertionError(f"v1: only {n_mapped} of {n_reads} mapped")
    log(f"[v1] {n_mapped} of {n_reads} reads mapped; the SAM of both "
        f"offload-on passes equals the offload-off pass's")
    check_digests("v1", sam)
    plain_pass("v1", MappingEngine(idx, cfg, device="cuda",
                                   plain_loops=True),
               reads, sam, runs[1][1], passes=2)
    _cpu_subset(idx, sam, reads, CACHE / "v1_first32.fq",
                lambda name, i: i < N_SUBSET, "v1")
    return runs[0][4], idx, reads, caps


def phase_v2(builds):
    """v2 with the offload on (two passes) and off (one); the JAX
    package's counters; the SV/junk reads on the CPU.  Returns the first
    pass's launch counts, its part sizes (gap_parts), and the index, the
    offload-on engine, the SAM and the reads.  builds: start_builds'."""
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    _, reads, idx = _built(builds, "v2")
    cfg = LordfastConfig(verbosity=2)
    torch.cuda.reset_peak_memory_stats()
    eng = MappingEngine(idx, cfg, device="cuda")
    runs = []
    caps = record_loops(LOG_COUNT_CALLS)
    for label in ("first pass, offload on", "second pass, offload on"):
        runs.append(map_pass(eng, reads, caps if not runs else None))
        c = eng.metrics.counters
        _report("v2", label, eng, runs[-1])
        log(f"[v2] counters: " + " ".join(
            f"{k} {c.get(k, 0)}" for k in (*V2_EXPECTED, "esc_sites",
                                           "esc_host", "esc_splits",
                                           "gaps_host")))
        check_launches("v2", runs[-1][4], c, KERNELS)
        if label.startswith("first"):
            _report_buckets("v2", eng)
            parts = {**gap_parts(c), **affine_parts(c)}
            if c.get("esc_splits", 0) <= 0:
                raise AssertionError("v2: no Hirschberg split on the card")
            got = {k: c.get(k, 0) for k in V2_EXPECTED}
            if got != V2_EXPECTED:
                raise AssertionError(f"v2: counters {got} != the JAX "
                                     f"package's {V2_EXPECTED}")
    log(f"[v2] peak device memory, offload on: "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; metrics "
        f"{eng.metrics.to_json()}")
    eng_off = MappingEngine(idx, cfg, device="cuda", esc_device=False)
    runs.append(map_pass(eng_off, reads))
    _report("v2", "pass, offload off", eng_off, runs[-1])
    check_launches("v2 offload off", runs[-1][4], eng_off.metrics.counters,
                   ("myers_dist", *LOOP_KERNELS))
    sam, _, n_reads, _, _ = runs[0]
    n_rec = len(sam_records(sam))
    if (n_reads, n_rec) != (V2_READS, V2_RECORDS):
        raise AssertionError(f"v2: {n_rec} SAM records for {n_reads} reads, "
                             f"expected {V2_RECORDS} for {V2_READS}")
    if runs[1][0] != sam:
        raise AssertionError("v2: the two offload-on passes differ")
    if runs[2][0] != sam:
        raise AssertionError("v2: offload on and off give different SAM")
    log(f"[v2] {n_rec} SAM records for {n_reads} reads; both offload-on "
        f"passes and the offload-off pass byte-equal")
    check_digests("v2", sam)
    eng_plain = MappingEngine(idx, cfg, device="cuda", plain_loops=True)
    plain = plain_pass("v2", eng_plain, reads, sam, runs[1][1], passes=2)
    _cpu_subset(idx, sam, reads, CACHE / "v2_sv_junk.fq",
                lambda name, i: name.startswith(("sv", "junk")), "v2",
                esc_device=True)
    v2 = dict(idx=idx, eng=eng, sam=sam, reads=reads, warm_s=runs[1][1],
              device_s=eng.metrics.timers["device"], caps=caps,
              eng_plain=eng_plain, plain_warm_s=plain[1],
              plain_device_s=eng_plain.metrics.timers["device"])
    return runs[0][4], parts, v2


def phase_v2_sampled(v2) -> tuple:
    """v2 at phase 5's config over its index with the SA sliced to 32,
    then to 16 (slice_sa): two passes each, each SAM byte-equal to phase
    5's full-SA SAM (locate is exact), every pass launching sa_locate
    once a device call and entering no walk; then a plain_loops pass,
    the same SAM.  Logs the warm pass's seconds and device timer beside
    phase 5's.  Returns ({path: the first pass's launches}, {"v2_32" /
    "v2_16": the first pass's record_loops})."""
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    cfg = LordfastConfig(verbosity=2)
    by_path, caps = {}, {}
    for intv in (32, 16):
        tag = f"v2 sa_intv {intv}"
        idx = slice_sa(v2["idx"], intv)
        eng = MappingEngine(idx, cfg, device="cuda")
        caps[f"v2_{intv}"] = record_loops()
        runs = []
        for label in ("first pass", "second pass"):
            runs.append(map_pass(eng, v2["reads"],
                                 caps[f"v2_{intv}"] if not runs else None))
            _report(tag, label, eng, runs[-1])
            check_launches(tag, runs[-1][4], eng.metrics.counters, KERNELS,
                           sampled=True)
            if runs[-1][0] != v2["sam"]:
                raise AssertionError(f"{tag}: the SAM differs from the full "
                                     "SA's (phase 5)")
        by_path[f"v2_sa{intv}"] = runs[0][4]
        log(f"[{tag}] both passes' SAM byte-equal to the full SA's; warm "
            f"pass {runs[1][1]:.3f} s, device "
            f"{eng.metrics.timers['device']:.3f} s (full SA, phase 5: "
            f"{v2['warm_s']:.3f} s, device "
            f"{v2['device_s']:.3f} s)")
        plain = plain_pass(tag, MappingEngine(idx, cfg, device="cuda",
                                              plain_loops=True),
                           v2["reads"], v2["sam"], runs[1][1])
        by_path[f"v2_sa{intv}_plain"] = plain[4]
        del eng
        torch.cuda.empty_cache()
    return by_path, caps


def phase_g300(builds, rows, int_rate) -> tuple:
    """The G300_BP genome (its index built by a build_bench process since
    phase 1): LordfastConfig() must have sampled its SA at 32 and kept
    int32 positions; two passes of its 512 reads on the card (the SAM
    repeats, at least 95% mapped, sa_locate launched once a device call
    and no walk entered), a plain_loops pass (the same SAM), the first
    16 reads on the CPU (the same records), and sa_locate on the first
    pass's first locate call and on BEYOND_ROWS rows (beyond_rows: more
    than the card holds lanes at once), each bit-equal to sa_lookup and
    timed, with its latency floor from a pointer chase over the rank
    arrays (chase_ns); their figures go into the kernel table's
    sa_locate row (rows).  Returns the first pass's launches, its
    record_loops (its chain calls only) and, for phase_g300_mesh, the
    SAM, the reads, the index file and the warm pass's seconds."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    _, reads, idx = _built(builds, "g300")
    if idx.sa_intv != 32 or idx.pos_dtype is not np.int32:
        raise AssertionError(f"g300: LordfastConfig() chose sa_intv "
                             f"{idx.sa_intv} and {idx.pos_dtype}, not 32 "
                             "and int32")
    cfg = LordfastConfig(verbosity=2)
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    eng = MappingEngine(idx, cfg, device="cuda")
    nbytes = sum(x.numel() * x.element_size() for x in eng.arrs.values())
    log(f"[g300] engine set up in {time.time() - t:.2f} s: {nbytes} bytes "
        f"of index arrays on the card (l_pac {idx.l_pac}, sa_intv "
        f"{idx.sa_intv})")
    caps = record_loops(LOG_COUNT_CALLS)
    runs = []
    for label in ("first pass", "second pass"):
        runs.append(map_pass(eng, reads, caps if not runs else None))
        _report("g300", label, eng, runs[-1])
        check_launches("g300", runs[-1][4], eng.metrics.counters,
                       ("myers_dist", *LOOP_KERNELS), sampled=True)
    sam, _, n_reads, n_mapped, _ = runs[0]
    if runs[1][0] != sam:
        raise AssertionError("g300: the two passes differ")
    if n_mapped < MIN_MAPPED_FRAC * n_reads:
        raise AssertionError(f"g300: only {n_mapped} of {n_reads} mapped")
    log(f"[g300] {n_mapped} of {n_reads} reads mapped, both passes' SAM "
        f"byte-equal; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    plain = plain_pass("g300", MappingEngine(idx, cfg, device="cuda",
                                             plain_loops=True),
                       reads, sam, runs[1][1])
    _cpu_subset(idx, sam, reads, CACHE / "g300_first16.fq",
                lambda name, i: i < 16, "g300")
    ns = chase_ns(rank_bytes(eng.arrs))
    log(f"[g300] pointer chase over {rank_bytes(eng.arrs)} bytes (the rank "
        f"arrays): {ns:.1f} ns a dependent load")
    g = check_sa_locate("g300", idx, caps.locate[0], int_rate, timed=True,
                        chase=ns)
    r, valid = beyond_rows(idx.meta)
    b = check_sa_locate("g300 beyond residency", idx, dict(
        arrs=eng.arrs, meta=idx.meta, rows=r, valid=valid), int_rate,
        timed=True, chase=ns, layouts=False)
    row = next(r for r in rows if r["name"] == "sa_locate")
    for pre, x in (("g300", g), ("g300_beyond", b)):
        row.update({f"{pre}_ms": x["ms"], f"{pre}_plain_ms": x["plain_ms"],
                    f"{pre}_bound_ms": x["bound"][0],
                    f"{pre}_bound_by": x["bound"][1],
                    **{f"{pre}_{k}": x[k] for k in (
                        "floor_ms", "chase_ns", "lanes", "walk_steps",
                        "longest_walk", "warp_efficiency", "warps")}})
    # the seed and locate records hold the index's arrays on the card:
    # dropped, so that phase 13's peak device memory counts its own
    # (phase_log_counts reads the chain calls only)
    caps.seed.clear()
    caps.locate.clear()
    return {"g300": runs[0][4], "g300_plain": plain[4]}, caps, dict(
        sam=sam, reads=reads, index=CACHE / "g300.lft.npz", idx=idx,
        warm_s=runs[1][1])


def _g2200():
    """tools/torch_g2200.py: the 2.2 Gbp genome's layout and its checks'
    inputs (numpy only)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_g2200

    return torch_g2200


# the smoke's 2.2 Gbp layout phase: the packed words' generator seed, the
# gap and affine buckets whose gathers it checks, and its voting batch
G2200_WORDS_SEED = 2202
G2200_GAP_BUCKETS = ((512, 576), (2048, 2176))
G2200_AFFINE_BUCKET = (512, 544)
G2200_VOTE = dict(B=12, MS=512, max_n=512, seed=2203)


def vote_seeds(rng, B, MS, max_n, bases):
    """A SeedBatch's fields (numpy) and read lengths: each read's seed
    slots filled contiguously, clustered around a few windows (equal
    weights common, so windows tie), at forward coordinates
    bases[b % len(bases)] plus up to ~62 read lengths; the last read is
    padding (tests/test_torch_voting.py make_seeds, moved by bases)."""
    import numpy as np

    lens = rng.integers(1000, 3000, B).astype(np.int32)
    lens[-1] = 0
    t_pos = np.zeros((B, MS), np.int64)
    q_pos = np.zeros((B, MS), np.int32)
    length = np.zeros((B, MS), np.int32)
    is_rev = np.zeros((B, MS), bool)
    n_total = rng.integers(0, max_n + 1, B).astype(np.int32)
    n_total[-1] = 0
    for b in range(B):
        n = min(int(n_total[b]), MS)
        loci = rng.integers(0, 60, 16)
        which = rng.integers(0, len(loci), n)
        rl = max(int(lens[b]), 1)
        t_pos[b, :n] = (bases[b % len(bases)] + loci[which] * rl
                        + rng.integers(0, 2 * rl, n))
        q_pos[b, :n] = rng.integers(0, rl, n)
        length[b, :n] = np.where(rng.random(n) < 0.6, 14,
                                 rng.integers(14, 20, n))
        is_rev[b, :n] = (which % 2) == 1
    valid = np.arange(MS)[None, :] < np.minimum(n_total, MS)[:, None]
    for a in (t_pos, q_pos, length, is_rev):
        a[~valid] = 0
    return (dict(t_pos=t_pos, q_pos=q_pos, length=length, is_rev=is_rev,
                 valid=valid, n_total=n_total,
                 n_anchors=np.minimum(n_total, 7)), lens)


def _equal_fields(tag, got, want):
    """Every field of two named tuples of tensors equal, dtype too (got on
    the card, want on the CPU)."""
    import torch

    for name in want._fields:
        a, b = getattr(got, name).cpu(), getattr(want, name)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{tag}: {name} differs between the card "
                                 f"and the CPU")


def phase_g2200_layout() -> dict:
    """The 2.2 Gbp genome of tools/torch_g2200.py without its index
    (~7 s; its full run is the tool's): its forward text packed 16
    codes a word, 136,962,957 words from a seeded generator on the card
    (int64, ~1.1 GB, with the words a gather reads past the genome's
    end), and its 13 contigs' tables.  The gathers of gap descriptors at
    target starts around forward coordinate 2**31, across the last
    contig edge and at the genome's end (gather_starts), both target
    orientations, in two gap buckets (gap_dp.gather_gap_seqs) and the
    affine bucket (the gather of affine.extend_from_desc), each equal to
    a numpy decode of the same words (decode_gather); the gathered sets
    through myers_dist and extend_from_desc (affine_extend) on the card,
    each equal to its plain version; and vote_windows (its flat and wide
    routes), compact_candidates and select_window_seeds over seeds at
    forward coordinates past 2**31 and these contig tables on the card,
    field by field equal to the port on the CPU (which the tests hold to
    the JAX package).  Returns the phase's launches."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.ops import (affine, chain, fm_index, gap_dp,
                                        gap_dp_cuda, voting)

    t0 = time.time()
    g22 = _g2200()
    lay = g22.layout()
    n = lay.l_pac
    n_fwd = (n + 15) // 16
    reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(G2200_WORDS_SEED)
    words = torch.randint(0, 2**32, (n_fwd + G2200_GAP_BUCKETS[-1][1] // 16
                                     + 2,), dtype=torch.int64,
                          device="cuda", generator=gen)
    log(f"[g2200] {n_fwd} packed words of the {n} bp forward text (and "
        f"{words.numel() - n_fwd} past its end) drawn on the card in "
        f"{time.time() - t0:.2f} s: {words.numel() * 8} bytes")

    def words_at(w):
        return words[torch.from_numpy(w).cuda()].cpu().numpy()

    rng = np.random.default_rng(G2200_WORDS_SEED)
    cfg = LordfastConfig()
    for Q, T in G2200_GAP_BUCKETS + (G2200_AFFINE_BUCKET,):
        desc = g22.gather_descs(lay, rng, Q, T)
        G = len(desc["q_read"])
        reads = rng.integers(0, 5, (G, Q + 8)).astype(np.uint8)
        d_dev = {k: torch.from_numpy(v).cuda() for k, v in desc.items()}
        r_dev = torch.from_numpy(reads).cuda()
        got = gap_dp.gather_gap_seqs(words, r_dev, d_dev, Q, T, n)
        want = g22.decode_gather(words_at, reads, desc, Q, T, n)
        for name, a, b in zip(("qs", "ql", "ts", "tl"), got, want):
            if not np.array_equal(a.cpu().numpy(), b):
                raise AssertionError(f"g2200 gather ({Q}, {T}): {name} "
                                     "differs from the numpy decode")
        qs, ql, ts, tl = got
        what = (f"{G} descriptors at t_start {int(desc['t_start'].min())}"
                f"-{int(desc['t_start'].max())}, both orientations")
        if (Q, T) != G2200_AFFINE_BUCKET:
            shw = d_dev["is_shw"]
            k = gap_dp_cuda.myers_dist(qs, ql, ts, tl, shw, Q, T)
            p = gap_dp.myers_dist_plain(qs, ql, ts, tl, shw, Q, T)
            err = _max_err(zip(k, p))
            if err:
                raise AssertionError(f"g2200 myers_dist ({Q}, {T}): kernel "
                                     f"!= plain (max abs err {err})")
            log(f"[g2200] gap gather ({Q}, {T}): {what}, equal to the numpy "
                f"decode; myers_dist == plain on them (distances "
                f"{int(k[0].min())}-{int(k[0].max())})")
            continue
        w_max = max(cfg.clip_band, cfg.split_band)
        BW = 128 * ((2 * w_max + 2 + 127) // 128)
        split = rng.integers(0, 2, G).astype(bool)
        sel = lambda a, b: np.where(split, b, a).astype(np.int32)
        od, ed_, oi, ei = sel(0, 8), sel(1, 1), sel(0, 4), sel(1, 1)
        ql_np = ql.cpu().numpy()
        params = dict(o_del=od, e_del=ed_, o_ins=oi, e_ins=ei,
                      w_eff=affine.clamp_band(ql_np, 2, 0, od, ed_, oi, ei,
                                              sel(40, 100)),
                      zdrop=sel(40, 200), h0=ql_np.copy(),
                      match=np.full(G, 2, np.int32),
                      mismatch=np.full(G, 16, np.int32))
        p_dev = {k: torch.from_numpy(np.asarray(v, np.int32)).cuda()
                 for k, v in params.items()}
        k = affine.extend_from_desc(words, r_dev, {**d_dev, **p_dev}, Q, T,
                                    BW, w_max, n)
        p = affine.extend_batch_plain(qs, ts, Q, T, BW, w_max, qlen=ql,
                                      tlen=tl, **p_dev)
        err = _max_err(zip(k, p))
        if err:
            raise AssertionError(f"g2200 affine_extend ({Q}, {T}): kernel "
                                 f"!= plain (max abs err {err})")
        log(f"[g2200] affine gather ({Q}, {T}): {what}, equal to the numpy "
            f"decode; extend_from_desc (affine_extend) == plain on them "
            f"(scores {int(k.score.min())}-{int(k.score.max())})")
    del words
    torch.cuda.empty_cache()

    offs = np.asarray(lay.offsets, np.int64)
    ends = offs + np.asarray(lay.lengths, np.int64)
    fields, lens = vote_seeds(np.random.default_rng(G2200_VOTE["seed"]),
                              G2200_VOTE["B"], G2200_VOTE["MS"],
                              G2200_VOTE["max_n"], g22.vote_bases(lay))
    vcfg = LordfastConfig(max_candidates=8, max_chain_seeds=64)
    K = len(lens) * vcfg.compact_windows_per_read
    out = {}
    for dev in ("cpu", "cuda"):
        sd = fm_index.SeedBatch(**{k: torch.from_numpy(v).to(dev)
                                   for k, v in fields.items()})
        ld = torch.from_numpy(lens).to(dev)
        arrs = {"contig_offsets": torch.from_numpy(offs).to(dev),
                "contig_ends": torch.from_numpy(ends).to(dev)}
        cands = voting.vote_windows(sd, ld, vcfg)
        cw = chain.compact_candidates(cands, vcfg, K)
        out[dev] = (voting._vote_windows_flat(sd, ld, vcfg, 131072),
                    voting._vote_windows_wide(sd, ld, vcfg), cands, cw,
                    chain.select_window_seeds(sd, cw, ld, arrs, vcfg))
    for what, a, b in zip(("vote_windows flat", "vote_windows wide",
                           "vote_windows", "compact_candidates",
                           "select_window_seeds"), out["cuda"], out["cpu"]):
        _equal_fields(f"g2200 {what}", a, b)
    ws = out["cpu"][-1]
    sel_t = ws.t_pos[ws.valid]
    if not (len(sel_t) > 100 and bool((sel_t >= 2**31).any())
            and bool((sel_t < 2**31).any())):
        raise AssertionError(f"g2200 select_window_seeds: {len(sel_t)} seeds "
                             "selected, none on one side of 2**31")
    launches = read_launches()
    want = {"myers_dist": len(G2200_GAP_BUCKETS), "affine_extend": 1}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"g2200: launches {launches}, not {want}")
    log(f"[g2200] voting, compaction and selection over {len(lens)} reads' "
        f"seeds at forward coordinates {min(g22.vote_bases(lay))}-"
        f"{int(fields['t_pos'].max())} and the 13 contigs' tables: every "
        f"field equal between the card and the CPU ({len(sel_t)} seeds "
        f"selected, up to {int(sel_t.max())}); phase in "
        f"{time.time() - t0:.1f} s; launches {launches}")
    return launches


def _int64_high(kernel: str, tensors: dict, tag: str = "g1200",
                floor: int = 2**31):
    """Each of tensors is int64 and holds a value >= floor: a kernel's
    recorded inputs on a Gbp index (tag)."""
    import torch

    for name, x in tensors.items():
        if x.dtype != torch.int64:
            raise AssertionError(f"{tag} {kernel}: {name} is {x.dtype}, "
                                 "not int64")
        if not x.numel() or int(x.max()) < floor:
            raise AssertionError(f"{tag} {kernel}: no {name} >= {floor}")


def check_int64_loops(idx, caps, int_rate, chase, tag="g1200",
                      floor=2**31, chain_floor=None) -> dict:
    """The first recorded seed_ext, sa_locate and chain_dp calls of a Gbp
    genome's first pass (caps: record_loops; tag: the 1.2 Gbp genome or
    tools/torch_g2200.py's), each bit-equal to its plain version on the
    card and timed against it, with its bound from the call's inputs
    (seed_work, locate_work, chain_work) and, for sa_locate, its latency
    floor (chase: ns a dependent load).  seed_ext's and sa_locate's
    inputs must be int64 and hold positions >= floor (SA rows, sampled SA
    values, L2), and so must the text positions they locate; with
    chain_floor, chain_dp's forward coordinates >= it too.  Returns
    {kernel: its figures}."""
    from lordfast_tpu_torch.ops import fm_index

    figs = {}
    rec = caps.seed[0]
    alive0, k0, l0 = rec["lanes"][:3]
    _int64_high("seed_ext", {"sa_samp": rec["arrs"]["sa_samp"],
                             "L2": rec["arrs"]["L2"], "k": k0[alive0],
                             "l": l0[alive0]}, tag, floor)
    stats, need = check_seed_ext(rec)
    args = (rec["arrs"], rec["meta"], rec["rd"], *rec["lanes"],
            rec["phase1_steps"])
    out = _wrappers()["seed_ext"](*args)
    _int64_high("seed_ext", {"rpos of the lanes the compare resolved":
                             out[3][out[4]]}, tag, floor)
    ms = _time_launches(lambda: _wrappers()["seed_ext"](*args), 5)
    plain_ms = _time_cuda(lambda: fm_index._staged_ext(*args), 1)
    b = bound(seed_work(rec, need), 0, int_rate)
    figs["seed_ext"] = dict(ms=ms, plain_ms=plain_ms, bound=b)
    log(_seed_line(f"{tag} (int64)", rec, stats, need)
        + f" | kernel {ms:.3f} ms | plain (_staged_ext) {plain_ms:.1f} ms"
        f" | bound {b[0]:.5f} ms ({b[1]}), kernel {ms / b[0]:.1f}x")

    rec = caps.locate[0]
    _int64_high("sa_locate", {"sa_samp": rec["arrs"]["sa_samp"],
                              "rows": rec["rows"][rec["valid"]]}, tag, floor)
    pos = _wrappers()["sa_locate"](rec["arrs"], rec["meta"], rec["rows"],
                                   rec["valid"])
    _int64_high("sa_locate", {"located positions": pos[rec["valid"]]}, tag,
                floor)
    figs["sa_locate"] = check_sa_locate(f"{tag} (int64)", idx, rec,
                                        int_rate, timed=True, chase=chase)
    ws, cfg = caps.chain[0]
    if chain_floor is not None:
        _int64_high("chain_dp", {"t_pos (forward coordinates)":
                                 ws.t_pos[ws.valid]}, tag, chain_floor)
    figs["chain_dp"] = check_chain_moved(ws, cfg, int_rate, tag)
    return figs


def check_chain_moved(ws, cfg, int_rate, tag="g1200") -> dict:
    """chain_dp at 64 bits on recorded windows ws: int64 t_pos, but the
    seeds are forward coordinates, below l_pac < 2**31 at 1.2 Gbp, so
    the kernel is held to its plain version on ws and on ws moved by
    2**32, whose chains must be ws's moved (the DP reads differences
    only); timed on ws against its plain version, with its bound
    (chain_work).  Returns its figures."""
    import torch

    from lordfast_tpu_torch.ops import chain

    if ws.t_pos.dtype != torch.int64:
        raise AssertionError(f"{tag} chain_dp: t_pos is {ws.t_pos.dtype}")
    up = ws._replace(t_pos=torch.where(ws.valid, ws.t_pos + 2**32,
                                       ws.t_pos))
    _int64_high("chain_dp", {"t_pos moved by 2**32": up.t_pos}, tag)
    check_chain_dp(ws, cfg)
    check_chain_dp(up, cfg)
    got, moved = (_wrappers()["chain_dp"](x, cfg) for x in (ws, up))
    N = got.t_pos.shape[-1]
    link = torch.arange(N, device=got.t_pos.device) < got.chain_len[
        ..., None]
    other = [f for f in chain.ChainBatch._fields if f != "t_pos"
             if not bool((getattr(got, f) == getattr(moved, f)).all())]
    if other or not bool((torch.where(link, got.t_pos + 2**32, got.t_pos)
                          == moved.t_pos).all()):
        raise AssertionError(f"{tag} chain_dp: the windows moved by 2**32 "
                             f"chain otherwise ({other or 't_pos'})")
    work = chain_work(ws, cfg)
    b = chain_bound(work, int_rate)
    ms = _time_launches(lambda: _wrappers()["chain_dp"](ws, cfg), 5)
    plain_ms = _time_cuda(
        lambda: chain._chain_bucketed(ws, cfg, chain.dp_function(cfg)), 1)
    counts = ws.valid.reshape(-1, N).sum(-1)
    log(f"[loops] chain_dp {tag} (int64): {counts.numel()} windows x {N} "
        f"slots ({int((counts > 0).sum())} with seeds, {_chain_counts(work)},"
        f" t_pos up to {int(ws.t_pos.max())}): dp, prev and chains "
        f"bit-equal to the plain version, and on the windows moved by 2**32"
        f" (t_pos up to {int(up.t_pos.max())}) too, their chains the first "
        f"ones moved | kernel {ms:.3f} ms | plain (_chain_bucketed) "
        f"{plain_ms:.1f} ms | bound {b[0]:.5f} ms ({b[1]}), kernel "
        f"{ms / b[0]:.1f}x")
    return dict(ms=ms, plain_ms=plain_ms, bound=b)


def truth_check(idx, sam) -> dict:
    """The reads of sam (bench.gen_gbp_reads' g<i>) against the origins
    their generator drew (gbp_origins, origin_check): at least
    MIN_ORIGIN_FRAC of all reads on their origin, at least MIN_HIGH_READS
    high reads (high_reads: located text positions >= 2**31) and
    MIN_ORIGIN_FRAC of them on their origin.  Returns the origins, the
    high reads and the counts."""
    origins = gbp_origins(idx)
    ok = origin_check(sam, origins, {
        n: int(o) for n, o in zip(idx.contig_names, idx.contig_offsets)})
    high = high_reads(origins, idx.l_pac)
    n_ok, h_ok = sum(ok.values()), sum(ok[i] for i in high)
    line = (f"{n_ok} of {len(origins)} reads on their drawn origin (strand "
            f"and reference span), {h_ok} of the {len(high)} whose located "
            f"text positions lie at or above 2**31")
    if n_ok < MIN_ORIGIN_FRAC * len(origins):
        raise AssertionError(f"g1200 truth check: {line}; off: "
                             f"{[i for i, v in ok.items() if not v][:20]}")
    if len(high) < MIN_HIGH_READS or h_ok < MIN_ORIGIN_FRAC * len(high):
        raise AssertionError(f"g1200 truth check: {line} (at least "
                             f"{MIN_HIGH_READS} high reads needed)")
    log(f"[g1200] truth check: {line}")
    return dict(origins=origins, high=high, n_ok=n_ok, high_ok=h_ok)


def phase_g1200(builds, rows, int_rate) -> tuple:
    """The G1200_BP genome, its index built by a build_bench process
    started before phase 1: LordfastConfig() must have given it int64
    positions (seq_len >= 2**31 - 1) and a SA sampled at 32, and the
    engine's position arrays on the card must be int64.  Two passes of
    its 512 reads on the card (the SAM repeats, at least 95% mapped,
    sa_locate launched once a device call, no walk entered), the truth
    check (truth_check), a plain_loops pass (the same SAM), the first 16
    reads on the CPU (the same records), the first recorded seed_ext,
    sa_locate and chain_dp calls at 64 bits (check_int64_loops), and
    sa_locate on BEYOND_ROWS rows (beyond_rows: more than the card holds
    lanes at once), bit-equal and timed, with its latency floor from a
    pointer chase over the rank arrays (chase_ns).  The figures go into
    rows (the kernel table) by kernel.  Returns the first pass's
    launches, its record_loops (every chain call) and, for
    phase_gbp_mesh, the SAM, the reads, the index file, the high
    reads and the warm pass's seconds."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.ops import fm_index
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    _, reads, idx = _built(builds, "g1200")
    if (idx.seq_len < 2**31 - 1 or idx.pos_dtype is not np.int64
            or fm_index.torch_pos_dtype(idx.meta) != torch.int64
            or idx.sa_intv != 32):
        raise AssertionError(f"g1200: seq_len {idx.seq_len}, pos_dtype "
                             f"{idx.pos_dtype}, sa_intv {idx.sa_intv}; "
                             "LordfastConfig() must give int64 and 32")
    cfg = LordfastConfig(verbosity=2)
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    eng = MappingEngine(idx, cfg, device="cuda")
    pos = {k: eng.arrs[k].dtype for k in (
        "sa_samp", "kcache_beg", "kcache_end", "L2", "contig_offsets",
        "contig_ends")}
    if any(d != torch.int64 for d in pos.values()):
        raise AssertionError(f"g1200: position arrays on the card {pos}")
    nbytes = sum(x.numel() * x.element_size() for x in eng.arrs.values())
    log(f"[g1200] engine set up in {time.time() - t:.2f} s: {nbytes} bytes "
        f"of index arrays on the card (l_pac {idx.l_pac}, seq_len "
        f"{idx.seq_len}, sa_intv {idx.sa_intv}; sa_samp, k-mer cache, L2 and"
        f" contig table int64 on the card)")
    caps = record_loops(LOG_COUNT_CALLS)
    runs = []
    for label in ("first pass", "second pass"):
        runs.append(map_pass(eng, reads, caps if not runs else None))
        _report("g1200", label, eng, runs[-1])
        check_launches("g1200", runs[-1][4], eng.metrics.counters,
                       ("myers_dist", *LOOP_KERNELS), sampled=True)
    sam, _, n_reads, n_mapped, _ = runs[0]
    if runs[1][0] != sam:
        raise AssertionError("g1200: the two passes differ")
    if n_mapped < MIN_MAPPED_FRAC * n_reads:
        raise AssertionError(f"g1200: only {n_mapped} of {n_reads} mapped")
    fig = {"index_bytes": nbytes, "cold_s": runs[0][1],
           "warm_s": runs[1][1], "device_s": eng.metrics.timers["device"],
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    log(f"[g1200] {n_mapped} of {n_reads} reads mapped, both passes' SAM "
        f"byte-equal; cold pass {fig['cold_s']:.3f} s, warm pass "
        f"{fig['warm_s']:.3f} s (device {fig['device_s']:.3f} s); peak "
        f"device memory {fig['peak_mib']:.0f} MiB")
    truth = truth_check(idx, sam)
    plain = plain_pass("g1200", MappingEngine(idx, cfg, device="cuda",
                                              plain_loops=True),
                       reads, sam, runs[1][1])
    _cpu_subset(idx, sam, reads, CACHE / "g1200_first16.fq",
                lambda name, i: i < 16, "g1200")
    ns = chase_ns(rank_bytes(eng.arrs))
    log(f"[g1200] pointer chase over {rank_bytes(eng.arrs)} bytes (the "
        f"rank arrays): {ns:.1f} ns a dependent load")
    figs = check_int64_loops(idx, caps, int_rate, ns)
    r, valid = beyond_rows(idx.meta)
    b = check_sa_locate("g1200 beyond residency", idx, dict(
        arrs=eng.arrs, meta=idx.meta, rows=r, valid=valid), int_rate,
        timed=True, chase=ns, layouts=False)
    fig.update(mapped=n_mapped, on_origin=truth["n_ok"],
               high=len(truth["high"]), high_on_origin=truth["high_ok"],
               **{f"{k}_{x}": v[x] if x != "bound" else v[x][0]
                  for k, v in figs.items() for x in ("ms", "bound")},
               sa_locate_floor_ms=figs["sa_locate"]["floor_ms"],
               beyond_ms=b["ms"], beyond_bound=b["bound"][0],
               beyond_floor_ms=b["floor_ms"])
    log(f"[g1200] figures ({nvidia_smi_line()}): {json.dumps(fig)}")
    by_name = {row["name"]: row for row in rows}
    for name, x in figs.items():
        by_name[name].update({"g1200_ms": x["ms"],
                              "g1200_plain_ms": x["plain_ms"],
                              "g1200_bound_ms": x["bound"][0],
                              "g1200_bound_by": x["bound"][1]})
    for pre, x in (("g1200", figs["sa_locate"]), ("g1200_beyond", b)):
        by_name["sa_locate"].update({
            f"{pre}_ms": x["ms"], f"{pre}_plain_ms": x["plain_ms"],
            f"{pre}_bound_ms": x["bound"][0],
            f"{pre}_bound_by": x["bound"][1],
            **{f"{pre}_{k}": x[k] for k in (
                "floor_ms", "chase_ns", "lanes", "walk_steps",
                "longest_walk", "warp_efficiency", "warps")}})
    return {"g1200": runs[0][4], "g1200_plain": plain[4]}, caps, dict(
        sam=sam, reads=reads, index=CACHE / "g1200.lft.npz", idx=idx,
        warm_s=runs[1][1], high=truth["high"])


# recorded chain calls of a pass, for phase_log_counts: more than any
# pass of the smoke's datasets makes (v2: 6)
LOG_COUNT_CALLS = 64


def torch_log_misses(n: int):
    """The d in [2, n) at which torch.log in float64 differs from the C
    library's log (Python's math.log), on the host's CPU and on the card:
    two int64 tensors on the card."""
    import math

    import torch

    d = torch.arange(2, n, dtype=torch.float64)
    ref = torch.tensor(list(map(math.log, range(2, n))), dtype=torch.float64)
    host = torch.nonzero(torch.log(d) != ref)[:, 0] + 2
    card = torch.nonzero(torch.log(d.cuda()).cpu() != ref)[:, 0] + 2
    return host.cuda(), card.cuda()


def phase_log_counts(caps):
    """dp-n2's log on the datasets (caps: record_loops of the first pass
    of v1, v2 and the two random genomes, every chain call): how many
    linked pairs have d >= 65,536 (past the table of torch.log values the
    port read before it read one table of the C library's log for every
    d a window links) and how many a d at which torch.log differs from the C
    library's log for d = 2..2,000,000, on the host CPU or on the card;
    and the largest linked d, against the table's length."""
    import torch

    from lordfast_tpu_torch.ops import chain

    host, card = torch_log_misses(2_000_001)
    log(f"[chain log] torch.log in float64 differs from the C library's "
        f"log at {len(host)} d of 2..2,000,000 on the host CPU (the first "
        f"{host[:6].tolist()}) and at {len(card)} on the card (the first "
        f"{card[:6].tolist()}); the port reads neither")
    for tag, rec in caps.items():
        linked = far = on_host = on_card = top = 0
        for ws, cfg in rec.chain:
            for d in _linked_d(ws):
                linked += len(d)
                far += int((d >= 65_536).sum())
                on_host += int(torch.isin(d, host).sum())
                on_card += int(torch.isin(d, card).sum())
                top = max(top, int(d.max()) if len(d) else 0)
        n = chain.log_table_len(rec.chain[0][1])
        if top >= n:
            raise AssertionError(f"{tag}: a linked d {top} past the log "
                                 f"table's {n} entries")
        log(f"[chain log] {tag}: {len(rec.chain)} chain calls, {linked} "
            f"linked dp-n2 pairs, {far} with d >= 65,536, {on_host} with a "
            f"d where the host's torch.log differs, {on_card} where the "
            f"card's does; the largest d {top} (the table holds {n})")


def _sv_junk(name, i):
    return name.startswith(("sv", "junk"))


def _v2_seeder_subset(name, i):
    """The v2 reads the extend-whole-3 pass maps: the 40 SV/clip and 8
    junk reads (v2's last 48) and the first 16 others."""
    return _sv_junk(name, i) or i < 16


def _v2_ew2_subset(name, i):
    """The v2 reads the extend-whole-2 pass maps: _v2_seeder_subset's
    but the 8 noiseless inversion reads (bench.gen_dataset's SV kind 2:
    sv2, sv7, ..., 4,500 bases matching the genome in runs of 1,500),
    56 reads.  Its host seeder extends each of a read's 1000 anchors one
    char a numpy call, as far as the read matches, so an inversion read
    costs ~185 s on an 8-core x86 host (measured: sv2, sv12, sv22,
    sv32), another read 2-5 s; the 64 reads of _v2_seeder_subset took
    1,044.6 s of host seeding on the H100's host.  On the CPU,
    tools/torch_jax_sams.py holds all 560."""
    inversion = name.startswith("sv") and int(name[2:]) % 5 == 2
    return _v2_seeder_subset(name, i) and not inversion


def phase_clasp(v2, v1_idx, v1_reads):
    """v2 with -a clasp at the default config: two passes with the
    offload on (the SAM repeats) and one with it off (the same SAM); the
    first held read by read to the JAX package's clasp digests; the
    SV/junk reads on the CPU give the same records.  Then one v1 pass
    with clasp and the offload on, held to its digests.  Returns the
    first v2 pass's launch counts and the v1 pass's."""
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    cfg = LordfastConfig(chain_alg="clasp")
    idx, reads = v2["idx"], v2["reads"]
    eng = MappingEngine(idx, cfg, device="cuda")
    runs = []
    for label in ("first pass, offload on", "second pass, offload on"):
        runs.append(map_pass(eng, reads))
        _report("v2 clasp", label, eng, runs[-1])
        c = eng.metrics.counters
        # myers_moves serves phase C, which needs a segment for it
        needed = ("myers_dist", "affine_extend", *LOOP_KERNELS) + (
            ("myers_moves",) if c.get("esc_nw_parts", 0) else ())
        check_launches("v2 clasp", runs[-1][4], c, needed)
    log("[v2 clasp] counters: " + " ".join(
        f"{k} {c.get(k, 0)}" for k in (*V2_EXPECTED, "esc_sites",
                                       "esc_splits", "esc_nw_parts")))
    eng_off = MappingEngine(idx, cfg, device="cuda", esc_device=False)
    runs.append(map_pass(eng_off, reads))
    _report("v2 clasp", "pass, offload off", eng_off, runs[-1])
    check_launches("v2 clasp offload off", runs[-1][4],
                   eng_off.metrics.counters, ("myers_dist", *LOOP_KERNELS))
    sam, _, n_reads, n_mapped, _ = runs[0]
    if runs[1][0] != sam:
        raise AssertionError("v2 clasp: the two offload-on passes differ")
    if runs[2][0] != sam:
        raise AssertionError("v2 clasp: offload on and off give different "
                             "SAM")
    if sam == v2["sam"]:
        raise AssertionError("v2 clasp: the SAM equals dp-n2's")
    log(f"[v2 clasp] {n_mapped} of {n_reads} reads mapped, "
        f"{len(sam_records(sam))} SAM records; both offload-on passes and "
        f"the offload-off pass byte-equal; warm pass "
        f"{runs[1][2] / runs[1][1]:.2f} reads/s (dp-n2, phase 5: "
        f"{n_reads / v2['warm_s']:.2f})")
    check_digests("v2", sam, "clasp")
    _cpu_subset(idx, sam, reads, CACHE / "v2_sv_junk.fq", _sv_junk,
                "v2 clasp", cfg=cfg, esc_device=True)
    eng = MappingEngine(v1_idx, cfg, device="cuda")
    res = map_pass(eng, v1_reads)
    _report("v1 clasp", "pass, offload on", eng, res)
    check_launches("v1 clasp", res[4], eng.metrics.counters,
                   ("myers_dist", *LOOP_KERNELS))
    check_digests("v1", res[0], "clasp")
    return runs[0][4], res[4]


def phase_seeders(v1_idx, v1_reads, v2):
    """The dormant seeders on the card: extend-whole-3 on the first 64
    v1 reads at the default config (the first 16 again on the CPU), and
    on 64 v2 reads (_v2_seeder_subset), extend-whole-2 on 56 of them
    (_v2_ew2_subset), each held read by read to the JAX package's
    digests of its configuration; then extend-whole-2 on golden at the golden config
    with sampling_count 100 (the CPU gives the same SAM).  Returns their
    launch counts."""
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import build_index
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    def host_seed_line(tag, eng, n):
        sec = eng.metrics.timers["host_seed"]
        log(f"[{tag}] host seeding {sec:.2f} s for {n} reads: "
            f"{sec / n:.4f} s a read")

    def seeder_pass(tag, seeder, idx, sub, names):
        eng = MappingEngine(idx, LordfastConfig(seeder=seeder),
                            device="cuda")
        res = map_pass(eng, sub)
        label = f"{tag} {seeder}"
        _report(label, f"{len(names)} reads, offload on", eng, res)
        check_launches(label, res[4], eng.metrics.counters,
                       ("myers_dist", "chain_dp"))
        host_seed_line(label, eng, res[2])
        check_digests(tag, res[0], seeder, names)
        by_path[f"{tag}_{seeder.replace('-', '_')}"] = res[4]
        return res

    by_path = {}
    sub = CACHE / "v1_first64.fq"
    names = _subset(v1_reads, sub, lambda name, i: i < 64)
    res = seeder_pass("v1", "extend-whole-3", v1_idx, sub, names)
    _cpu_subset(v1_idx, res[0], sub, CACHE / "v1_first16.fq",
                lambda name, i: i < 16, "v1 extend-whole-3",
                cfg=LordfastConfig(seeder="extend-whole-3"))
    for seeder, sub, keep in (
            ("extend-whole-2", "v2_ew2.fq", _v2_ew2_subset),
            ("extend-whole-3", "v2_seeders64.fq", _v2_seeder_subset)):
        names = _subset(v2["reads"], CACHE / sub, keep)
        seeder_pass("v2", seeder, v2["idx"], CACHE / sub, names)

    cfg = LordfastConfig(**GOLDEN_CFG, seeder="extend-whole-2",
                         sampling_count=100)
    idx = build_index(DATA / "ref.fa", LordfastConfig(kmer_cache_k=8),
                      verbose=False)
    eng = MappingEngine(idx, cfg, device="cuda")
    res = map_pass(eng, DATA / "reads.fq")
    _report("golden extend-whole-2", "offload on", eng, res)
    check_launches("golden extend-whole-2", res[4], eng.metrics.counters,
                   ("myers_dist", "chain_dp"))
    host_seed_line("golden extend-whole-2", eng, res[2])
    by_path["golden_extend_whole_2"] = res[4]
    t = time.time()
    out = io.StringIO()
    MappingEngine(idx, cfg, device="cpu").map_file(DATA / "reads.fq", out,
                                                    "chip_smoke")
    if sam_records(out.getvalue()) != sam_records(res[0]):
        raise AssertionError("golden extend-whole-2: cpu and cuda differ")
    log(f"[golden extend-whole-2] {len(sam_records(res[0]))} SAM records "
        f"byte-equal between cuda and cpu (cpu run {time.time() - t:.1f} s)")
    return by_path


def trace_summary(events, wall_s):
    """(busy share, [(kernel, self ms, launches)] by time) of the CUDA
    kernel events of a Chrome trace: the union of their intervals over
    wall_s."""
    kern = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "kernel")
    busy, end = 0.0, float("-inf")
    per = {}
    for a, b, name in kern:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        ms, n = per.get(name, (0.0, 0))
        per[name] = (ms + (b - a) / 1e3, n + 1)
    top = sorted(((k, ms, n) for k, (ms, n) in per.items()),
                 key=lambda x: -x[1])
    return busy / 1e6 / wall_s, top


def phase_profile(v2):
    """One warm v2 pass (dp-n2, offload on: phase 5's engine) under
    utils.metrics.profiler_trace on cuda: its SAM equals phase 5's, the
    trace holds the device stage's four named ranges and the Myers,
    affine, chain_dp and seed_ext kernels' CUDA events; then one of
    phase 5's plain_loops engine, the same SAM.  Logs each pass's kernel
    count, device busy share and top five kernels by self CUDA time;
    returns the first pass's launch counts."""
    res = _traced_pass(v2, "eng", "kernels", v2["warm_s"],
                       ("myers_", "affine_", "chain_dp_kernel",
                        "seed_ext_kernel"))
    _traced_pass(v2, "eng_plain", "plain loops", v2["plain_warm_s"],
                 ("myers_", "affine_"))
    return res[4]


def _traced_pass(v2, key, label, warm_s, kinds):
    import shutil

    from lordfast_tpu_torch.utils.metrics import profiler_trace

    tdir = CACHE / "profile" / key
    shutil.rmtree(tdir, ignore_errors=True)
    with profiler_trace(tdir, "cuda"):
        res = map_pass(v2[key], v2["reads"])
    if res[0] != v2["sam"]:
        raise AssertionError(f"profile ({label}): the traced v2 pass's SAM "
                             "differs from phase 5's")
    traces = list(tdir.glob("lordfast_*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"profile: {len(traces)} trace files in {tdir}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    missing = {"lf_seed", "lf_vote", "lf_select", "lf_chain"} - names
    if missing:
        raise AssertionError(f"profile: no range {sorted(missing)}")
    busy, top = trace_summary(events, res[1])
    for kind in kinds:
        if not any(kind in k for k, _, _ in top):
            raise AssertionError(f"profile ({label}): no {kind}* kernel in "
                                 "the trace")
    kern_ms = sum(ms for _, ms, _ in top)
    log(f"[profile] {label}: traced warm v2 pass {res[1]:.3f} s (untraced, "
        f"phase 5: {warm_s:.3f} s); trace "
        f"{traces[0].stat().st_size >> 20} MiB, {len(events)} events; "
        f"{sum(n for _, _, n in top)} kernels, {kern_ms:.1f} ms of kernel "
        f"time; device busy share {busy:.4f} of the traced pass "
        f"({busy * res[1] / warm_s:.4f} of the untraced one)")
    for k, ms, n in top[:5]:
        log(f"[profile] {label}: top kernel: {ms:.2f} ms in {n} launches: "
            f"{k[:120]}")
    return res


def phase_multiprocess():
    """Two ``python -m lordfast_tpu_torch.cli`` processes on the one card
    (--numProcesses 2 --coordinator localhost:<free port>, gloo) map the
    golden fixture's chunks (--minReadLen 100 --chunkSize 40000); process
    0 merges the shards, and the merged SAM equals a single-process
    run's, @PG aside."""
    import shutil
    import socket

    from lordfast_tpu_torch import cli
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import (build_index,
                                                  index_path_for, save_index)

    d = CACHE / "multiprocess"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    ref = d / "ref.fa"
    shutil.copy(DATA / "ref.fa", ref)
    save_index(build_index(ref, LordfastConfig(kmer_cache_k=8),
                           verbose=False), index_path_for(ref))
    args = ["--search", str(ref), "--seq", str(DATA / "reads.fq"),
            "--minReadLen", "100", "--chunkSize", "40000"]
    single, merged = d / "single.sam", d / "merged.sam"
    t = time.time()
    if cli.main(args + ["-o", str(single)]) != 0:
        raise AssertionError("multiprocess: the single-process run failed")
    t_single = time.time() - t
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lordfast_tpu_torch.cli", *args, "-o",
         str(merged), "--numProcesses", "2", "--processIndex", str(pid),
         "--coordinator", f"localhost:{port}"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for pid, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multiprocess: process {pid} exited "
                                 f"{p.returncode}: {err[-2000:]}")

    def body(path):
        return [l for l in path.read_text().splitlines()
                if not l.startswith("@PG")]

    if body(merged) != body(single):
        raise AssertionError("multiprocess: the merged SAM differs from "
                             "the single-process SAM")
    chunks = [sum(l.startswith("[engine] [chunk") for l in err.splitlines())
              for _, err in outs]
    log(f"[multiprocess] 2 processes on one card ({chunks[0]} + {chunks[1]} "
        f"chunks) in {time.time() - t:.1f} s, merged by process 0: "
        f"{len(body(merged))} lines equal to the single-process run's "
        f"({t_single:.1f} s in process), @PG aside")


# the sharded index's step kernels (csrc/seed_shard.cu) and the plain
# loops they replace on the card (counted on entry)
SHARD_KERNELS = ("shard_bucket", "shard_answer", "shard_ext_step",
                 "shard_walk_step")
SHARD_LOOPS = ("_shard_ext", "_shard_walk")
# what each replaces in the JAX package (lordfast_tpu/ops/fm_index.py)
SHARD_REPLACES = {
    "shard_bucket": "lordfast_tpu/ops/fm_index.py:76 _row_gather_routed "
                    "(the buckets :96-121, the overflow flag :111)",
    "shard_answer": "lordfast_tpu/ops/fm_index.py:76 _row_gather_routed "
                    "(the owners' answer :122-128) and :56 _row_gather_ag",
    "shard_ext_step": "lordfast_tpu/ops/fm_index.py:485 ext_loop_flat "
                      "(lax.while_loop :492, _ext_body :452)",
    "shard_walk_step": "lordfast_tpu/ops/fm_index.py:267 sa_lookup (walk "
                       ":281-303, lax.while_loop :303)"}


def _clone(x):
    """x with every tensor in it (lists, tuples, named tuples) cloned."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


# the sparse steps record_shard.replay keeps beside the first calls: the
# first list step of the first sharded call at which fewer than this
# share of its lanes is live, by tag suffix
SPARSE_STEPS = {"<10%": 0.10, "<1%": 0.01}
STEP_KERNELS = ("shard_ext_step", "shard_walk_step")


class record_shard:
    """Context manager: the first call of each of fm_shard_cuda's four
    wrappers made inside it, of the bucket and answer steps of a walk step
    ("shard_bucket walk", "shard_answer walk": most of their lanes dead),
    of the SA entries' gather ("shard_bucket ids", "shard_answer sa") and
    of the loops shard_ext and shard_walk, is recorded in
    ``self.calls[name]`` with its arguments and keywords as they were
    before the call (tensors cloned: the step kernels run in place, on
    the loop's lane lists), and runs as usual (a _Recorder stand-in at
    each module attribute, which the loops look up at call time).  No
    call inside it reads the card.  ``replay`` then finds each step
    kernel's sparse steps."""

    def __init__(self):
        self.calls = {}
        self.lives = None  # replay's: the lanes live before each step
        self._step = ""  # the kind of the last bucket step: an answer's

    def _record(self, name):
        def record(*args, **kw):
            if name == "shard_bucket":
                self._step = (" ids" if kw.get("ids") else
                              " walk" if args[2] is None else "")
            tag = name
            if name == "shard_bucket":
                tag += self._step
            elif name == "shard_answer":
                tag += " sa" if kw.get("key") else (
                    " walk" if self._step == " walk" else "")
            if tag not in self.calls:
                self.calls[tag] = (_clone(args), {k: _clone(v)
                                                  for k, v in kw.items()})
        return record

    def replay(self) -> dict:
        """Runs each recorded loop's first call again on clones of its
        arguments (every rank of the group does: the loop's collectives),
        reading the live flags before each step, and records each step
        kernel at the first list step at which fewer than 10% and 1% of
        its lanes are live ("shard_ext_step <10%", ...: SPARSE_STEPS).
        Once, after the recorded pass: its reads stay out of any timed
        pass.  Returns (and keeps in ``self.lives``) {loop: the lanes live
        before each step}."""
        from lordfast_tpu_torch.ops import fm_shard_cuda as K

        if self.lives is not None:
            return self.lives
        self.lives = {}
        for loop, name in STEP_LOOPS.items():
            if loop not in self.calls:  # a full SA has no walk
                continue
            lives = self.lives[loop] = []

            def note(*args, name=name, lives=lives, **kw):
                flags = args[0][0]
                live = int(flags.sum())
                lives.append(live)
                for t, share in SPARSE_STEPS.items():
                    tag = f"{name} {t}"
                    if (not kw["lanes"].first and tag not in self.calls
                            and live < share * flags.numel()):
                        self.calls[tag] = (_clone(args),
                                           {k: _clone(v)
                                            for k, v in kw.items()})

            f = getattr(K, name)
            setattr(K, name, _Recorder(f, note))
            try:
                getattr(K, loop)(*_clone(self.calls[loop][0]))
            finally:
                setattr(K, name, f)
        return self.lives

    def __enter__(self):
        from lordfast_tpu_torch.ops import fm_shard_cuda as K

        self._saved = {n: getattr(K, n)
                       for n in SHARD_KERNELS + tuple(STEP_LOOPS)}
        for n, f in self._saved.items():
            setattr(K, n, _Recorder(f, self._record(n)))
        return self

    def __exit__(self, *exc):
        from lordfast_tpu_torch.ops import fm_shard_cuda as K

        for n, f in self._saved.items():
            setattr(K, n, f)
        return False


# a value shard_bucket never writes (row ids and slots are >= -1, counts
# >= 0): every output it should write starts as this
UNWRITTEN = -2


def _bucket_run(fn, args, kw, rps, D, cap):
    """(send, slot, counts, over) of fn (shard_bucket or its plain
    version) on one recorded call's queries args[:4] with the stripes'
    rows a rank rps, D ranks and cap; the outputs start as UNWRITTEN (the
    flag at 0)."""
    import torch

    live, k, l, meta = args[:4]
    dev, Q = live.device, args[8].numel()
    send = torch.full((D * cap,), UNWRITTEN, dtype=torch.int64, device=dev)
    slot = torch.full((Q,), UNWRITTEN, dtype=torch.int32, device=dev)
    counts = torch.full((D,), UNWRITTEN, dtype=torch.int32, device=dev)
    over = torch.zeros(1, dtype=torch.int32, device=dev)
    fn(live, k, l, meta, rps, D, cap, send, slot, counts, over, **kw)
    return send, slot, counts, over


def _bucket_check(args, kw, kernel, plain):
    """shard_bucket's kernel against its plain version on one recorded
    call's queries (live, k, l, meta, rps, D, cap, send, slot, counts,
    over), send, slot, counts and the overflow flag bit for bit: as
    recorded, then over the same stripes' rows at D = 2, 3 and 8 (rps
    cut to match) with shard_cap's cap, and at each D with a quarter of
    that cap (rounded up to 8), which overflows.  Returns (the asked
    queries, the launches compared, those that overflowed)."""
    import torch

    from lordfast_tpu_torch.ops import fm_index as fm

    rps, D, cap = args[4:7]

    def check(r, d, c):
        got, want = (_bucket_run(f, args, kw, r, d, c)
                     for f in (kernel, plain))
        for name, x, y in zip(("send", "slot", "counts", "over"), got, want):
            if not torch.equal(x, y):
                bad = int((x != y).sum())
                raise AssertionError(
                    f"shard_bucket at D = {d}, cap {c}: {name} differs from "
                    f"the plain version's at {bad} of {x.numel()}")
        return int(want[3][0])

    over, done = check(rps, D, cap), 1
    asked = int(_bucket_run(plain, args, kw, rps, D, cap)[2].sum())
    for d in dict.fromkeys((D, 2, 3, 8)):
        fit = fm.shard_cap(asked, d)
        for c in ((fit,) if d != D else ()) + (max((fit // 4 + 7) & ~7, 8),):
            over += check(-(-rps * D // d), d, c)
            done += 1
    return asked, done, over


def _row_piece_bytes(k, pos, seq_len, walk=False):
    """Bytes of its returned rank row that an occ query of rows k at BWT
    positions pos needs (fm_rank.cuh occ_of_row, row_char): the 16-byte
    piece that holds c's count and the word pairs up to the pair of the
    row's word; none for k < 0 or, on an extension, k == seq_len (their
    occ is 0 or c's total, from L2); a walk's row seq_len counts c's total
    and needs only the pair that holds x's char."""
    import torch

    pairs = 16 * (((pos & 127) >> 5) + 1)
    if walk:
        return torch.where(k == seq_len, 16, 16 + pairs)
    return torch.where((k < 0) | (k == seq_len), 0, 16 + pairs)


def shard_work(name, args, kw=None) -> float:
    """Bytes the function of shard kernel ``name`` needs on one recorded
    call (its arguments ``args``), each input read once and each output
    written once, counting what this call's lanes need.  The bucket
    reads every lane's live flag and its live lanes' k (and l) and
    writes every query's slot, each asked query's row id and the whole
    send buffer (its empty slots are -1, which the answer reads).  The
    answer reads every row id and each distinct owned row (96 bytes) and
    writes the slots of the owned rows (96 bytes each; no step reads the
    empty ones).  A step reads every lane's flag and, for a live lane,
    its state and slots, the read word and read length it needs, and of
    each query's returned row only the pieces occ needs
    (_row_piece_bytes); it writes a surviving lane's state and the flag
    of a lane that stops; L2 is read once.  A dead lane, an extension
    lane whose next char ends it (it needs no row), a query without a
    slot and the walk's primary row (it steps to 0) read no row.  kw: the
    call's keywords (the SA entries' gather: a query a row id, its 4- or
    8-byte entry read and an int64 written)."""
    import torch

    from lordfast_tpu_torch.ops import fm_index as fm
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    kw = kw or {}
    if name == "shard_bucket":
        live, k, l, meta, rps, D, cap, send, slot = args[:9]
        n_live = int(live.sum())
        return float(live.numel() + n_live * (16 if l is not None else 8)
                     + slot.numel() * 4 + send.numel() * 8)
    if name == "shard_answer":
        recv, arrs, base, out = args
        if kw.get("key"):
            st = arrs[kw["key"]]
            rps, size, width = st.shape[0], st.element_size(), 8
        else:
            rps, size, width = K.rank_stripes(arrs)[1].shape[0], 96, 96
        loc = recv - base
        mine = (loc >= 0) & (loc < rps)
        owned = int(loc[mine].unique().numel())
        return float(recv.numel() * 8 + owned * size
                     + int(mine.sum()) * width)
    if name == "shard_ext_step":
        state, pos_f, b_lane, rd, arrs, meta, back, slot = args[:8]
        alive, k, l, m = state
        n = alive.numel()
        seq_len, primary = meta["seq_len"], meta["primary"]
        go = alive & fm.next_char(rd, b_lane, pos_f, m)[0]
        qc = (pos_f[alive] + m[alive]).clamp(max=rd.L - 1)
        words = int((b_lane[alive] * rd.W16 + (qc >> 4)).unique().numel())
        reads = int(b_lane[alive].unique().numel())
        pieces = 0
        for kq, s in ((k - 1, slot[:n]), (l, slot[n:])):
            kk = kq.clamp(0, seq_len - 1)
            pos = kk - (kk >= primary).long()
            pieces += int(_row_piece_bytes(kq, pos, seq_len)[
                go & (s >= 0)].sum())
        after = _clone(state)
        K.shard_ext_step_plain(after, pos_f, b_lane, rd, arrs, meta, back,
                               slot, lanes=_first_lanes(n, alive.device))
        n_live, n_go, kept = int(alive.sum()), int(go.sum()), int(
            after[0].sum())
        # a live lane reads m, pos_f and b_lane; one that steps also k, l
        # and two slots; a survivor writes k, l, m, a lane that stops its
        # flag
        return float(n + n_live * 3 * 8 + n_go * (2 * 8 + 2 * 4) + pieces
                     + words * 8 + reads * 8 + kept * 3 * 8
                     + (n_live - kept) + _l2_bytes(arrs))
    state, arrs, meta, back, slot = args[:5]
    active, rows, steps = state
    seq_len, primary = meta["seq_len"], meta["primary"]
    steps_row = active & (rows != primary)
    x = rows - (rows > primary).long()
    pieces = int(_row_piece_bytes(rows, x, seq_len, walk=True)[
        steps_row & (slot >= 0)].sum())
    after = _clone(state)
    K.shard_walk_step_plain(after, arrs, meta, back, slot,
                            lanes=_first_lanes(active.numel(), active.device))
    n_live, kept = int(active.sum()), int(after[0].sum())
    # an active row reads and writes its row and steps, and reads its slot
    # unless it is the primary row; one that stops writes its flag
    return float(active.numel() + n_live * 4 * 8 + int(steps_row.sum()) * 4
                 + pieces + (n_live - kept) + _l2_bytes(arrs))


def _first_lanes(n, device):
    """A LaneList of a block's first step over n lanes, on lists of its
    own: a plain step's, whose list nothing reads."""
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    return K.LaneList(*K.lane_list(n, device), 0, True, n)


def _l2_bytes(arrs) -> int:
    l2 = arrs["L2"]
    return l2.numel() * l2.element_size()


# a value no rank row, SA entry or zero fill holds: what shard_answer's
# checks fill its output with first
SENTINEL = -0x5A5A5A5A5A5A5A5B


def _answer_check(kern, plain, recv, arrs, base, dst, kw):
    """shard_answer's kernel against its plain version on one recorded
    call (kw: its keywords but ``routed``), each into an output filled
    with SENTINEL first: on the routed route every slot a query took (id
    not -1) equal, and on the card every empty slot left unwritten; on
    the all-gather route the whole buffer equal.  Returns (the routed
    output, its figures)."""
    import torch

    want = torch.empty_like(dst)
    plain(recv, arrs, base, want, **kw)
    took = recv != -1
    got = torch.full_like(dst, SENTINEL)
    kern(recv, arrs, base, got, routed=True, **kw)
    if not torch.equal(got[took], want[took]):
        raise AssertionError("shard_answer, routed: a taken slot differs "
                             "from the plain version's")
    if recv.is_cuda and not bool((got[~took] == SENTINEL).all()):
        raise AssertionError("shard_answer, routed: an empty slot was "
                             "written")
    ag = torch.full_like(dst, SENTINEL)
    kern(recv, arrs, base, ag, routed=False, **kw)
    if not torch.equal(ag, want):
        raise AssertionError("shard_answer, all-gather route: kernel != "
                             "plain")
    return got, {"slots": int(recv.numel()), "empty": int((~took).sum())}


def _sentinel_back(back, slot):
    """back with SENTINEL in every row no query's slot names: what a
    routed answer leaves unwritten reaches no step."""
    import torch

    taken = torch.zeros(back.shape[0], dtype=torch.bool, device=back.device)
    taken[slot[slot >= 0].long()] = True
    shape = (-1,) + (1,) * (back.dim() - 1)
    return torch.where(taken.view(shape), back, SENTINEL)


def step_floor(empty_ms: float, chase: float) -> float:
    """A step kernel's latency floor (ms): the back-to-back time of an
    empty launch of its grid, plus two dependent loads (a lane's slot,
    then its returned row) at ``chase`` ns each (chase_ns over the rank
    rows' bytes)."""
    return empty_ms + 2 * chase * 1e-6


# the live shares a step kernel's summed time is split by (the lanes
# live before the step over all lanes): label, lowest share
LIVE_BANDS = ((">=50%", 0.5), ("1-50%", 0.01), ("<1%", 0.0))


def live_band(live: int, n: int) -> str:
    """The LIVE_BANDS label of a step with ``live`` of its ``n`` lanes
    live before it."""
    share = live / max(n, 1)
    return next(label for label, lo in LIVE_BANDS if share >= lo)


def _step_args(name, args, kw):
    """(the positional arguments a step kernel's check passes, the index
    of its back, its lanes' LaneList)."""
    n_args, bk = (8, 6) if name == "shard_ext_step" else (5, 3)
    return n_args, bk, kw["lanes"]


def _step_outputs(state, live, lanes):
    """A step's results as check_shard_kernels compares them: the lane
    state, the live count, the list it wrote (sorted: its order follows
    the atomics) and the counter ring."""
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    _, _, list_out, n_out, _ = K.lane_ring(lanes)
    return list(state) + [live, list_out[: int(n_out[0])].sort().values,
                          lanes.ring]


def _reverse_list(lanes):
    """A list step's list reversed in place (its count's lanes): the step
    must give the same results in any order."""
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    list_in, n_in = K.lane_ring(lanes)[:2]
    m = int(n_in[0])
    list_in[:m] = list_in[:m].flip(0)


def _check_step(name, tag, args, kw, kern, plain, routed_rows):
    """A step kernel against its plain version on one recorded call (from
    clones of its arguments): the lane state, the live count and, with a
    list, the list written (as a set) and the count zeroed, bit-equal;
    also with SENTINEL in every returned row no query took, on a list
    step with the list reversed, and at the first extension call with
    the routed answer's own output as its rows (``routed_rows``, or
    None).  Returns its figures."""
    import torch

    n_args, bk, lanes = _step_args(name, args, kw)
    backs = [None, _sentinel_back(args[bk], args[bk + 1])]
    if routed_rows is not None and routed_rows.shape == args[bk].shape:
        backs.append(routed_rows)
    runs = [(plain, None, False)] + [(kern, b, False) for b in backs]
    if not lanes.first:
        runs.append((kern, None, True))
    res = []
    for f, back, rev in runs:
        a, ln = _clone(args), _clone(lanes)
        if back is not None:
            a = a[:bk] + (back,) + a[bk + 1:]
        if rev:
            _reverse_list(ln)
        live = torch.zeros(1, dtype=torch.int32, device=a[0][0].device)
        f(*a[:n_args], live, lanes=ln)
        res.append(_step_outputs(a[0], live, ln))
    for got in res[1:]:
        for x, y in zip(got, res[0]):
            if not torch.equal(x, y):
                raise AssertionError(f"{tag}: kernel != plain")
    flags = args[0][0]
    return {"lanes": int(flags.numel()), "live": int(flags.sum()),
            "list_step": not lanes.first,
            "backs_checked": len(backs), "reversed": runs[-1][2]}


def _time_step(name, args, kw, f, reps, lanes=True):
    """A call of step kernel f (the wrapper or its plain version) on one
    recorded call for _time_launches, a fresh clone of its arguments a
    launch (made before the timed window: the step runs in place); with
    ``lanes`` False f takes no LaneList (the parent checkout's kernels,
    over the flags)."""
    n_args, _, ln0 = _step_args(name, args, kw)
    pre = itertools.cycle([(_clone(args), _clone(ln0))
                           for _ in range(reps + 1)])

    def call():
        a, ln = next(pre)
        f(*a[:n_args], **({"lanes": ln} if lanes else {}))

    return call


def check_shard_kernels(rec, timed=False, reps=5, chase=None) -> dict:
    """Each of the four step kernels against its plain version on the card,
    on its first recorded call (record_shard), and each step kernel on
    its recorded sparse list steps too: shard_bucket as _bucket_check
    says, shard_answer as _answer_check says, a step as _check_step says.
    With ``timed``, each kernel's mean ms over reps launches queued
    behind a spin (_time_launches) and its plain version's (_time_cuda),
    and its bound by bytes (shard_work); a step kernel also its latency
    floor (step_floor: its grid's empty launch, timed the same way, and
    two loads at ``chase`` ns, chase_ns over the stripe's rank rows,
    measured here when None).  The step kernels' sparse steps are found
    first (record_shard.replay).  Returns {tag: figures}."""
    import functools

    import torch

    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    missing = [n for n in ("shard_bucket", "shard_answer", "shard_ext_step")
               if n not in rec.calls]
    if missing:
        raise AssertionError(f"shard kernels never called: {missing}")
    rec.replay()
    out = {}
    routed_rows = None
    for tag, (args, kw) in rec.calls.items():
        name = tag.split()[0]
        if name not in SHARD_KERNELS:  # a recorded loop (compare_shard's)
            continue
        kern = functools.partial(getattr(K, name), **kw)
        plain = functools.partial(getattr(K, name + "_plain"), **kw)
        fig = {"max_abs_err": 0}
        if name == "shard_bucket":
            if args[6] is None:
                raise AssertionError("shard_bucket: the first call took the "
                                     "all-gather route")
            fig["asked"], fig["launches_checked"], fig["overflowing"] = (
                _bucket_check(args, kw, getattr(K, name),
                              getattr(K, name + "_plain")))
            fig["lanes"] = int(args[0].numel())
            # the outputs, every slot of which each launch writes
            bufs = [args[7].clone(), args[8].clone(), args[9].clone(),
                    torch.zeros(1, dtype=torch.int32, device=args[0].device)]

            def call(f):
                return lambda: f(*args[:7], *bufs)
        elif name == "shard_answer":
            recv, arrs, base, dst = args
            bare = {k: v for k, v in kw.items() if k != "routed"}
            got, f = _answer_check(getattr(K, name),
                                   getattr(K, name + "_plain"), recv, arrs,
                                   base, dst, bare)
            fig.update(f)
            if tag == "shard_answer":
                routed_rows = got.clone()

            def call(f):
                return lambda: f(recv, arrs, base, got)
        else:
            # the routed answer's output is the first extension call's back
            # at D = 1 (the all_to_all's back there)
            first_ext = (tag == "shard_ext_step"
                         and rec.calls["shard_bucket"][0][5] == 1)
            fig.update(_check_step(name, tag, args, kw, kern, plain,
                                   routed_rows if first_ext else None))

            def call(f, name=name, args=args, kw=kw):
                return _time_step(name, args, kw, f, reps)
        if timed:
            fig["ms"] = _time_launches(call(kern), reps)
            fig["plain_ms"] = _time_cuda(call(plain), reps)
            nbytes = shard_work(name, args, kw)
            fig["bound_ms"], fig["bound_by"] = bound(nbytes, 0, 1.0)
            fig["bytes"] = nbytes
            if name in STEP_KERNELS:
                fig.update(_step_times(name, args, kw, reps, chase))
                chase = fig["chase_ns"]
        out[tag] = fig
    return out


def shard_int64_high(rec, tag, floor):
    """The first recorded calls of the four shard kernels (record_shard)
    take int64 BWT rows or text positions reaching floor: shard_bucket's
    live lanes' k, shard_ext_step's live lanes' k and l, shard_walk_step's
    active rows, and the SA entries the SA gather's shard_answer returns
    (its ids index the stripe: rank blocks or SA samples, below floor;
    they must be int64).  A full SA has no walk and no SA gather."""
    calls = rec.calls
    live, k = calls["shard_bucket"][0][:2]
    _int64_high("shard_bucket", {"k of the live lanes": k[live.bool()]},
                tag, floor)
    _int64_high("shard_answer", {"rank-block ids":
                                 calls["shard_answer"][0][0]}, tag, 0)
    if "shard_answer sa" in calls:
        (recv, arrs, base, _), kw = calls["shard_answer sa"]
        stripe = arrs[kw["key"]]
        ids = recv - base
        mine = ids[(ids >= 0) & (ids < stripe.shape[0])]
        _int64_high("shard_answer", {"SA entries answered": stripe[mine]},
                    tag, floor)
    alive, k, l = calls["shard_ext_step"][0][0][:3]
    _int64_high("shard_ext_step", {"k of the live lanes": k[alive.bool()],
                                   "l of the live lanes": l[alive.bool()]},
                tag, floor)
    if "shard_walk_step" in calls:
        active, rows = calls["shard_walk_step"][0][0][:2]
        _int64_high("shard_walk_step", {"active rows": rows[active.bool()]},
                    tag, floor)
    log(f"[mesh] {tag}: the shard kernels' first recorded inputs reach "
        f"{floor} (int64 rows)")


def _step_times(name, args, kw, reps, chase):
    """A step kernel's floor figures on one recorded call: its grid's
    lanes, the empty launch's ms (fm_shard_cuda.noop), the ns of a
    dependent load (chase, or chase_ns over the stripe's rank rows) and
    the floor (step_floor)."""
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    n_args, _, lanes = _step_args(name, args, kw)
    flags = args[0][0]
    grid = K.grid_lanes(flags.numel(), lanes)
    if chase is None:
        chase = chase_ns(rank_bytes(args[4] if n_args == 8 else args[1]))
    empty = _time_launches(lambda: K.noop(grid, flags.device), 4 * reps)
    return {"grid_lanes": grid, "empty_ms": empty, "chase_ns": chase,
            "floor_ms": step_floor(empty, chase)}


def _striped_bytes(idx, arrs: dict):
    """(this rank's device bytes of the arrays a sharded index stripes,
    the same arrays' bytes in the replicated layout of
    FMIndex.device_arrays, which holds uint32 words as int64)."""
    from lordfast_tpu_torch.parallel.sharded_index import _SHARDED_KEYS

    whole = sum((8 if v.dtype.name == "uint32" else v.itemsize) * v.size
                for k, v in idx.host_arrays().items() if k in _SHARDED_KEYS)
    return sum(arrs[k].nbytes for k in _SHARDED_KEYS if k in arrs), whole


def mesh_rank(spec_path: str) -> int:
    """One rank of phase 10 (``python3 chip_smoke.py --mesh-rank SPEC``,
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT in the environment, and
    LOCAL_RANK for one rank a card): set up the process group of the
    spec's backend on this rank's card, build the mesh on it, and map
    each of the spec's runs; every rank appends a JSON line of its
    figures to SPEC.<rank>.jsonl, and rank 0 writes each run's SAM and
    checks its kernel launches against its engine's sub-batches."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from lordfast_tpu_torch.parallel.mesh import make_mesh

    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(spec["backend"],
                            timeout=timedelta(seconds=spec["timeout_s"]))
    map_runs(spec, make_mesh("cuda"), rank, {}, spec_path)
    dist.destroy_process_group()
    return 0


def host_read_us(mesh, n=200) -> float:
    """Mean microseconds of one host read of the sharded loops' flags
    (fm_index._read_flags: an all_reduce (MAX) of two int32 on the mesh's
    group, then their read on the host) over n reads after 10 to warm
    up, every rank of the group at once; fm_index.shard_counts are left
    as they were."""
    import torch

    from lordfast_tpu_torch.ops import fm_index
    from lordfast_tpu_torch.parallel.mesh import mesh_device, mesh_group

    group = mesh_group(mesh)
    flags = torch.zeros(2, dtype=torch.int32, device=mesh_device(mesh))
    saved = dict(fm_index.shard_counts)
    for _ in range(10):
        fm_index._read_flags(flags, group)
    t = time.perf_counter()
    for _ in range(n):
        fm_index._read_flags(flags, group)
    dt = time.perf_counter() - t
    fm_index.shard_counts.update(saved)
    return dt / n * 1e6


def map_runs(spec, mesh, rank, indexes, spec_path):
    """mesh_rank's runs on this rank: each run's index (loaded into
    ``indexes`` by path, or found there), its engine on ``mesh`` (or
    alone for a replicated run), its passes with the launch counts and
    the sharded loops' counts read after each; appends this rank's JSON
    line a run to SPEC.<rank>.jsonl."""
    import contextlib

    import torch
    import torch.distributed as dist

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import load_index
    from lordfast_tpu_torch.ops import fm_index
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    for run in spec["runs"]:
        if run["index"] not in indexes:
            indexes[run["index"]] = keep_layout(load_index(run["index"]))
        idx = indexes[run["index"]]
        t_setup = time.time()
        if run["replicated"]:
            # rank 0 maps alone, with no mesh: the replicated pass in
            # this process; the others go on to the next run's barrier
            if rank != 0:
                continue
            eng = MappingEngine(idx, LordfastConfig(**run["cfg"]),
                                device="cuda")
        else:
            eng = MappingEngine(idx, LordfastConfig(**run["cfg"]),
                                device="cuda", mesh=mesh,
                                shard_index=run["shard_index"],
                                plain_loops=run.get("plain", False))
        mine, whole = _striped_bytes(idx, eng.arrs)
        rec = {"name": run["name"], "rank": rank,
               "backend": dist.get_backend(), "world": dist.get_world_size(),
               "device": str(eng.device), "seconds": [], "shard": [],
               "sampled": idx.sa_intv > 1,
               "index_bytes": mine, "replicated_bytes": whole,
               "setup_s": time.time() - t_setup}
        torch.cuda.reset_peak_memory_stats()
        sams = []
        shard_rec = None
        for i in range(run["passes"]):
            out = io.StringIO()
            if not run["replicated"]:
                dist.barrier()
            reset_launches()
            ctx = contextlib.nullcontext()
            if i == 0 and run.get("check_kernels"):
                ctx = shard_rec = record_shard()
            t = time.time()
            with ctx:
                eng.map_file(run["reads"], out, "chip_smoke")
                torch.cuda.synchronize()
            rec["seconds"].append(time.time() - t)
            rec["launches"] = read_launches()
            rec["shard"].append(dict(fm_index.shard_counts))
            rec["device_s"] = eng.metrics.timers.get("device", 0.0)
            sams.append(out.getvalue())
        rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        if run["shard_index"] and not run["replicated"]:
            rec["host_read_us"] = host_read_us(mesh)
        if shard_rec is not None:
            if run.get("int64_floor"):
                shard_int64_high(shard_rec, run["name"], run["int64_floor"])
            # each kernel against its plain version on this rank's first
            # call of it, timed under NCCL (gloo's collectives copy
            # through the host; its run is a correctness case)
            rec["kernels"] = check_shard_kernels(
                shard_rec, timed=spec["backend"] == "nccl")
        if rank == 0:
            # every pass, the cold one too, must give the same SAM, which
            # the smoke then holds against the replicated one
            if any(x != sams[0] for x in sams[1:]):
                raise AssertionError(f"mesh {run['name']}: the passes' "
                                     f"SAMs differ")
            Path(run["out"]).write_text(sams[0])
            c = eng.metrics.counters
            plain = run.get("plain", False)
            sharded = run["shard_index"]
            needed = ("myers_dist",) + (() if plain else ("chain_dp",) + (
                SHARD_KERNELS if sharded else ("seed_ext", "sa_locate")))
            check_launches(run["name"], rec["launches"], c, needed,
                           plain=plain, sampled=rec["sampled"],
                           sharded=sharded)
            rec["counters"] = {k: c.get(k, 0) for k in V2_EXPECTED}
            rec["timers"] = {k: eng.metrics.timers.get(k, 0.0)
                             for k in ("device", "gap_dp", "stitch")}
        with open(f"{spec_path}.{rank}.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")


def _mesh_job(d: Path, tag: str, backend: str, world: int, runs: list,
              timeout_s: int):
    """Start ``world`` ranks of mesh_rank on one group (a card a rank
    under NCCL, all on card 0 under gloo) and wait for them; returns
    each rank's records ({run name: record})."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_mesh_ranks import launch

    spec = d / f"{tag}.json"
    for old in d.glob(f"{tag}.json.*.jsonl"):
        old.unlink()
    spec.write_text(json.dumps({"backend": backend, "runs": runs,
                                "timeout_s": timeout_s}))
    res, dt = launch([sys.executable, ROOT / "chip_smoke.py", "--mesh-rank",
                      spec], world, timeout_s,
                     card_per_rank=backend == "nccl")
    for rank, (rc, _, err) in enumerate(res):
        if rc != 0:
            raise AssertionError(f"mesh {tag}: rank {rank} exited "
                                 f"{rc}: {err[-3000:]}")
    recs = []
    for rank in range(world):
        lines = Path(f"{spec}.{rank}.jsonl").read_text().splitlines()
        recs.append({r["name"]: r for r in map(json.loads, lines)})
    log(f"[mesh] {tag}: {world} rank(s) on {backend} in {dt:.1f} s")
    return recs


def _mesh_run(d, name, index, reads, cfg, shard, passes=1,
              replicated=False, **kw):
    """One run of a mesh job's spec (mesh_rank): ``kw`` may set "plain"
    (plain_loops) and "check_kernels" (record_shard on the first pass,
    then check_shard_kernels)."""
    return {"name": name, "index": str(index), "reads": str(reads),
            "cfg": cfg, "shard_index": shard, "passes": passes,
            "replicated": replicated, "out": str(d / f"{name}.sam"), **kw}


def _report_mesh(backend, world, runs, recs, want, replicated_s=None):
    """Checks and logs a mesh job's runs: each SAM against ``want``
    ({data: ("records" or "sam", expected)}; a run's data is its name
    without the last _part), each sharded pass's loop counts (a host
    read a block, plus one a redone block, one sizing each loop's first
    block and two for each exact gather) and each rank's kernel checks.
    Returns ({path: rank 0's launches}, {path: rank 0's kernel
    figures})."""
    by_path, kernels = {}, {}
    for r in runs:
        name = r["name"]
        data = name.rsplit("_", 1)[0]
        kind, expect = want[data]
        text = Path(r["out"]).read_text()
        got = sam_records(text) if kind == "records" else text
        if got != expect:
            raise AssertionError(f"mesh {backend} D={world} {name}: the "
                                 f"SAM differs from the replicated one")
        r0 = recs[0][name]
        secs = " / ".join(f"{x:.3f}" for x in r0["seconds"])
        ref = (replicated_s or {}).get(data)
        log(f"[mesh] {backend} D={world} {name}: SAM equal to the "
            f"replicated one ({len(sam_records(text))} records); "
            f"passes {secs} s"
            + (f" (replicated warm pass in the smoke's process: "
               f"{ref:.3f} s)" if ref else "")
            + f"; rank 0 timers of the last pass {r0['timers']}; "
            f"launches {r0['launches']}")
        by_path[f"{name}_{backend}{world}"] = r0["launches"]
        if data == "v2" and r0["counters"] != V2_EXPECTED:
            raise AssertionError(f"mesh {name}: counters "
                                 f"{r0['counters']} != {V2_EXPECTED}")
        if r["replicated"]:
            continue
        for rank in range(world):
            x = recs[rank][name]
            log(f"[mesh] {backend} D={world} {name} rank {rank} on "
                f"{x['device']}: engine set up in {x['setup_s']:.2f} s; "
                f"striped arrays {x['index_bytes']} B "
                f"of {x['replicated_bytes']} B replicated "
                f"({x['index_bytes'] / x['replicated_bytes']:.4f}); "
                f"peak device memory {x['peak_mib']:.0f} MiB")
            for k, f in x.get("kernels", {}).items():
                log(f"[mesh] {backend} D={world} {name} rank {rank} {k}: "
                    f"== plain on its recorded call ("
                    + ", ".join(f"{a} {v:.6g}" if isinstance(v, float)
                                else f"{a} {v}" for a, v in f.items())
                    + ")")
            if rank == 0 and x.get("kernels"):
                kernels[f"{name}_{backend}{world}"] = x["kernels"]
        if not r["shard_index"]:
            continue
        for i, c in enumerate(r0["shard"]):
            loops = 2 if r0["sampled"] else 1
            reads = c["calls"] * (loops + 2) + c["blocks"] + c["redone"]
            if c["host_reads"] != reads or not c["calls"]:
                raise AssertionError(f"mesh {name}: host reads {c} != "
                                     f"{reads}")
            log(f"[mesh] {backend} D={world} {name} pass {i}: "
                f"{c['calls']} sharded device calls, {c['blocks']} blocks "
                f"of {c['steps'] // max(c['blocks'] + c['redone'], 1)} "
                f"steps ({c['steps']} steps), {c['redone']} redone through "
                f"the all-gather route; host reads "
                f"{c['host_reads'] / c['calls']:.1f} a call "
                f"({c['host_reads']}: one a block, one a redone block, "
                f"one sizing each loop, two an exact gather), "
                f"{r0['host_read_us']:.1f} us a read; rank 0's device "
                f"timer {r0['device_s']:.3f} s (last pass), "
                f"{r0['device_s'] / max(c['blocks'], 1) * 1e3:.3f} ms a "
                f"block")
    return by_path, kernels


def shard_rows(figs) -> list:
    """The kernel table's rows of the four shard kernels, from rank 0's
    check_shard_kernels figures on the main path's first pass."""
    return [{"name": name, "route": "cuda",
             "source": "lordfast_tpu_torch/csrc/seed_shard.cu",
             "replaces": SHARD_REPLACES[name], "launches": 0,
             "max_abs_err": figs[name]["max_abs_err"],
             "ms": figs[name]["ms"], "plain_ms": figs[name]["plain_ms"],
             "bound_ms": figs[name]["bound_ms"],
             "bound_by": figs[name]["bound_by"], "library_ms": None,
             **({"floor_ms": figs[name]["floor_ms"]}
                if "floor_ms" in figs[name] else {})}
            for name in SHARD_KERNELS]


def phase_mesh(golden, v2):
    """Phase 10: the mesh and the sharded index (see the module
    docstring).  Returns (rank 0's launch counts by path, rank 0's shard
    kernel figures by path)."""
    import shutil

    import torch

    from lordfast_tpu_torch.index.builder import save_index

    d = CACHE / "mesh"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    t = time.time()
    save_index(golden["idx"], d / "golden.lft.npz")
    save_index(v2["idx"], d / "v2.lft.npz")
    save_index(slice_sa(v2["idx"], 32), d / "v2_32.lft.npz")
    log(f"[mesh] indexes saved for the ranks in {time.time() - t:.1f} s")
    names64 = _subset(v2["reads"], d / "v2_first64.fq",
                      lambda name, i: i < 64)
    golden_recs = sam_records((DATA / "golden.sam").read_text())
    v2_64 = [r for r in sam_records(v2["sam"])
             if r.split("\t")[0] in names64]
    gcfg, vcfg = GOLDEN_CFG, {}
    D = torch.cuda.device_count()
    g, v, v32 = (d / "golden.lft.npz", d / "v2.lft.npz",
                 d / "v2_32.lft.npz")
    v64 = d / "v2_first64.fq"

    def run(*a, **kw):
        return _mesh_run(d, *a, **kw)

    jobs = [
        # the sharded runs first: a rank's peak memory then holds no
        # replicated copy of the index
        ("nccl", D, [
            run("golden_shard", g, DATA / "reads.fq", gcfg, True, 2),
            run("golden_mesh", g, DATA / "reads.fq", gcfg, False, 2),
            run("golden_repl", g, DATA / "reads.fq", gcfg, False, 2, True),
            run("v2_shard", v, v2["reads"], vcfg, True, 2),
            run("v2_32_shard", v32, v2["reads"], vcfg, True, 2,
                check_kernels=True),
            run("v2_64_32_plain", v32, v64, vcfg, True, plain=True),
            run("v2_mesh", v, v2["reads"], vcfg, False, 2),
            run("v2_repl", v, v2["reads"], vcfg, False, 2, True)]),
        ("gloo", 2, [
            run("golden_shard", g, DATA / "reads.fq", gcfg, True),
            run("v2_64_shard", v, v64, vcfg, True),
            run("v2_64_32_shard", v32, v64, vcfg, True,
                check_kernels=True)]),
    ]
    # the SA sliced to 32 gives the full SA's SAM (phase 11)
    want = {"golden": ("records", golden_recs), "v2": ("sam", v2["sam"]),
            "v2_32": ("sam", v2["sam"]), "v2_64": ("records", v2_64),
            "v2_64_32": ("records", v2_64)}
    replicated_s = {"golden": golden["warm_s"], "v2": v2["warm_s"]}
    by_path, kernels = {}, {}
    for backend, world, runs in jobs:
        recs = _mesh_job(d, backend, backend, world, runs, 600)
        p, k = _report_mesh(backend, world, runs, recs, want,
                            replicated_s)
        by_path.update(p)
        kernels.update(k)
    return by_path, kernels


def phase_g300_mesh(g300):
    """The 300 Mbp genome sharded (after phase 12's replicated passes,
    which built its index and mapped it): MappingEngine(mesh=...,
    shard_index=True) at NCCL D = 1 in this process (a group of one), two
    passes of its 512 reads, each SAM byte-equal to phase 12's, and a
    plain_loops pass of its first 64 reads, equal to phase 12's records
    of them.  Returns the launches by path."""
    import torch.distributed as dist

    from lordfast_tpu_torch.parallel.mesh import make_mesh

    d = CACHE / "mesh"
    d.mkdir(parents=True, exist_ok=True)
    names64 = _subset(g300["reads"], d / "g300_first64.fq",
                      lambda name, i: i < 64)
    recs64 = [r for r in sam_records(g300["sam"])
              if r.split("\t")[0] in names64]
    runs = [_mesh_run(d, "g300_shard", g300["index"], g300["reads"], {},
                      True, 2),
            _mesh_run(d, "g300_64_plain", g300["index"],
                      d / "g300_first64.fq", {}, True, plain=True)]
    # one rank, in this process: phase 12's index (its host layout made
    # already) serves it, where a rank process would load and lay it out
    # again (~50 s)
    spec = d / "g300_nccl.json"
    spec.write_text(json.dumps({"backend": "nccl", "runs": runs}))
    spec.with_name(spec.name + ".0.jsonl").unlink(missing_ok=True)
    t = time.time()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh("cuda")
        dist.barrier()
        log(f"[mesh] g300: NCCL group of one and its mesh set up in "
            f"{time.time() - t:.1f} s")
        map_runs(json.loads(spec.read_text()), mesh, 0,
                 {str(g300["index"]): g300["idx"]}, str(spec))
    finally:
        dist.destroy_process_group()
    recs = [{r["name"]: r for r in map(json.loads, spec.with_name(
        spec.name + ".0.jsonl").read_text().splitlines())}]
    log(f"[mesh] g300: 1 rank on nccl in this process in "
        f"{time.time() - t:.1f} s")
    by_path, _ = _report_mesh(
        "nccl", 1, runs, recs,
        {"g300": ("sam", g300["sam"]), "g300_64": ("records", recs64)},
        {"g300": g300["warm_s"]})
    return by_path


def phase_gbp_mesh(g, tag="g1200", floor=None):
    """A Gbp genome sharded (tag: the 1.2 Gbp genome after phase 13's
    replicated passes, which built its index and mapped it; or
    tools/torch_g2200.py's): MappingEngine(mesh=..., shard_index=True) at
    NCCL D = 1 in this process (a group of one), on its high reads
    (g["high"]: located text positions >= 2**31, so seed_shard.cu's
    kernels run their Pos = int64_t instances on them; the 1.2 Gbp
    generator's 512 reads hold 58): a pass, each kernel held to its plain
    version on its first call and timed (record_shard,
    check_shard_kernels; with floor, their recorded inputs must first
    reach it, shard_int64_high), and a plain_loops pass, each equal to
    the replicated records of those reads.  Returns (the launches by
    path, rank 0's kernel figures by run)."""
    import torch.distributed as dist

    from lordfast_tpu_torch.parallel.mesh import make_mesh

    d = CACHE / "mesh"
    d.mkdir(parents=True, exist_ok=True)
    keep = {f"g{i}" for i in g["high"]}
    names = _subset(g["reads"], d / f"{tag}_high.fq",
                    lambda name, i: name in keep)
    recs = [r for r in sam_records(g["sam"]) if r.split("\t")[0] in names]
    extra = {"int64_floor": floor} if floor else {}
    runs = [_mesh_run(d, f"{tag}_high_shard", g["index"],
                      d / f"{tag}_high.fq", {}, True, check_kernels=True,
                      **extra),
            _mesh_run(d, f"{tag}_high_plain", g["index"],
                      d / f"{tag}_high.fq", {}, True, plain=True)]
    # one rank, in this process: the replicated passes' index (its host
    # layout made already) serves it, where a rank process would load and
    # lay it out again
    spec = d / f"{tag}_nccl.json"
    spec.write_text(json.dumps({"backend": "nccl", "runs": runs}))
    spec.with_name(spec.name + ".0.jsonl").unlink(missing_ok=True)
    t = time.time()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh("cuda")
        dist.barrier()
        log(f"[mesh] {tag}: NCCL group of one and its mesh set up in "
            f"{time.time() - t:.1f} s")
        map_runs(json.loads(spec.read_text()), mesh, 0,
                 {str(g["index"]): g["idx"]}, str(spec))
    finally:
        dist.destroy_process_group()
    ranks = [{r["name"]: r for r in map(json.loads, spec.with_name(
        spec.name + ".0.jsonl").read_text().splitlines())}]
    log(f"[mesh] {tag}: 1 rank on nccl in this process in "
        f"{time.time() - t:.1f} s, {len(names)} high reads")
    return _report_mesh("nccl", 1, runs, ranks,
                        {f"{tag}_high": ("records", recs)})


def main(mesh_only: bool = False) -> int:
    """Every phase; with ``mesh_only`` (``--mesh``) the builds, the
    golden and v2 phases that phase 10 is held against, and phase 10,
    with no kernel table and no contract line: the run for a host of
    several cards, where phase 10's NCCL job takes one rank a card."""
    import torch

    if not torch.cuda.is_available():
        print("[smoke] torch.cuda.is_available() is False: this smoke "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t0 = time.time()
    stagger = not mesh_only and g1200_staggered()
    builds = {} if mesh_only or stagger else start_builds(("g1200",))
    try:
        int_rate = phase_env()
        builds.update(start_builds(("v2",) if mesh_only
                                   else ("v1", "v2", "g300")))
        return _phases(mesh_only, int_rate, builds, t0, stagger)
    finally:
        for proc, *_ in builds.values():
            proc.kill()
            proc.wait()


def _phases(mesh_only, int_rate, builds, t0, stagger) -> int:
    import torch

    if mesh_only:
        _, golden = phase_golden()
        _, _, v2 = phase_v2(builds)
        t9 = time.time()
        phase_mesh(golden, v2)
        log(f"[smoke] phase 10 done in {time.time() - t9:.1f} s; phases "
            f"1, 3, 5 and 10 passed in {time.time() - t0:.1f} s")
        print(nvidia_smi_line())
        return 0
    rows = phase_kernel_gaps(int_rate) + [phase_kernel_affine(int_rate)]
    by_path = {"g2200_layout": phase_g2200_layout()}
    by_path["golden"], golden = phase_golden()
    by_path["v1"], v1_idx, v1_reads, v1_caps = phase_v1(builds)
    by_path["v2"], v2_parts, v2 = phase_v2(builds)
    if stagger:  # v1's and v2's builds have ended
        builds.update(start_builds(("g1200",)))
    sampled_paths, sampled_caps = phase_v2_sampled(v2)
    by_path.update(sampled_paths)
    time_at_parts(v2_parts)
    rows += phase_loops({"golden": golden["caps"], "v1": v1_caps,
                         "v2": v2["caps"], **sampled_caps}, golden["idx"],
                        v2["idx"], int_rate)
    t5 = time.time()
    log(f"[smoke] phases 1-5 done in {t5 - t0:.1f} s")
    by_path["v2_clasp"], by_path["v1_clasp"] = phase_clasp(v2, v1_idx,
                                                           v1_reads)
    by_path.update(phase_seeders(v1_idx, v1_reads, v2))
    by_path["v2_profiled"] = phase_profile(v2)
    phase_multiprocess()
    t9 = time.time()
    log(f"[smoke] phases 6-9 done in {t9 - t5:.1f} s")
    mesh_paths, shard_figs = phase_mesh(golden, v2)
    by_path.update(mesh_paths)
    t10 = time.time()
    log(f"[smoke] phase 10 done in {t10 - t9:.1f} s")
    g300_paths, g300_caps, g300 = phase_g300(builds, rows, int_rate)
    by_path.update(g300_paths)
    t = time.time()
    by_path.update(phase_g300_mesh(g300))
    log(f"[smoke] 300 Mbp sharded done in {time.time() - t:.1f} s")
    del g300  # its host index, before the 1.2 Gbp one loads
    gc.collect()
    t12 = time.time()
    log(f"[smoke] phase 12 (300 Mbp) done in {t12 - t10:.1f} s")
    g1200_paths, g1200_caps, g1200 = phase_g1200(builds, rows, int_rate)
    by_path.update(g1200_paths)
    t = time.time()
    by_path.update(phase_gbp_mesh(g1200)[0])
    log(f"[smoke] 1.2 Gbp sharded done in {time.time() - t:.1f} s")
    phase_log_counts({"v1": v1_caps, "v2": v2["caps"], "g300": g300_caps,
                      "g1200": g1200_caps})
    log(f"[smoke] phase 13 (1.2 Gbp) done in {time.time() - t12:.1f} s")
    # the shard kernels' main path: v2 over its SA sliced to 32, sharded
    # at NCCL D = the card count (the walk runs only with a sampled SA)
    main = f"v2_32_shard_nccl{torch.cuda.device_count()}"
    rows += shard_rows(shard_figs[main])
    for name in SHARD_KERNELS:
        MAIN_PATH[name] = main
    for row in rows:
        # each kernel's main path: v2's, and for sa_locate (sampled SA
        # only) the 1.2 Gbp genome's, whose default config samples it
        row["launches"] = by_path[MAIN_PATH.get(row["name"], "v2")][
            row["name"]]
        row["launches_by_path"] = {p: n[row["name"]]
                                   for p, n in by_path.items()}
    log(f"[smoke] all phases passed in {time.time() - t0:.1f} s; peak RSS "
        f"of this process {_peak_rss_gib(resource.RUSAGE_SELF):.2f} GiB, "
        f"of its largest child {_peak_rss_gib(resource.RUSAGE_CHILDREN):.2f}"
        f" GiB")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.path.insert(0, str(ROOT))
        sys.exit(mesh_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--build-bench"]:
        sys.path.insert(0, str(ROOT))
        sys.exit(build_bench(sys.argv[2]))
    if sys.argv[1:2] == ["--against"]:
        sys.path.insert(0, str(ROOT))
        sys.exit(compare_loops(Path(sys.argv[2])))
    sys.exit(main(mesh_only=sys.argv[1:2] == ["--mesh"]))
