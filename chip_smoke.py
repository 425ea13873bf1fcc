#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (lordfast_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit,
   and the builds (CUDA kernel library, native host library) with their
   seconds;
2. kernel against plain: for every gap bucket (Q, T, G) of
   LordfastConfig().gap_buckets, G ragged random gaps (NW and SHW, with
   the word-boundary, negative-end and length-1 cases) through the CUDA
   kernel ``myers_dist`` and its plain PyTorch version, on the card and
   on the CPU; dist/end must be equal exactly; per-bucket times;
3. golden: MappingEngine(device="cuda") on tests/data (the golden test's
   config); the SAM must equal tests/data/golden.sam byte for byte, and
   the kernel launch count must equal the gap sub-batches dispatched;
4. scale: the repo's v1 bench dataset (bench.gen_dataset(easy=True): a
   28 Mbp genome, 512 PacBio-CLR-like reads of 2-20 kb at ~12% error),
   indexed at the default config and mapped on the card twice (the
   first pass is the one whose kernel launches are counted; the second
   gives the warm rate and must repeat the SAM); reads/s, stage timers
   and peak device memory; at least 95% of the reads must map;
   the first 32 reads mapped again on the CPU must give the same SAM.

Then a line with the kernel table (JSON), the nvidia-smi line, and last
the contract line {"ok": true, "device": {...}}.  Exits non-zero without
a result when no CUDA device is available.  The dataset is cached in
.smoke_cache/ (gitignored).
"""

from __future__ import annotations

import io
import json
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
# Mapped-read floor of the scale phase: the JAX package's mapped count on
# this dataset was not measured (that is a full-size CPU run), so the
# floor is 95% of the reads.
MIN_MAPPED_FRAC = 0.95
N_SUBSET = 32


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def phase_env():
    import torch

    from lordfast_tpu_torch import native
    from lordfast_tpu_torch.ops import gap_dp_cuda

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(f"[env] nvidia-smi: {nvidia_smi_line()}")
    t = time.time()
    gap_dp_cuda.build()
    log(f"[env] kernel library built in {time.time() - t:.1f} s")
    for line in gap_dp_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[env] ptxas: {line.strip()}")
    t = time.time()
    native._load()
    log(f"[env] native host library built in {time.time() - t:.1f} s")


def make_gaps(rng, Q, T, G):
    """G ragged gaps for bucket (Q, T): mutated-copy targets (so the
    distances are non-trivial), random NW/SHW modes, and the edge cases
    first — ql at 32/64 multiples, ql = 1, tl = 1, tl < W64."""
    import numpy as np

    qs = np.full((G, Q), 4, np.uint8)
    ts = np.zeros((G, T), np.uint8)
    ql = rng.integers(max(1, Q // 2), Q + 1, G).astype(np.int32)
    tl = rng.integers(1, T + 1, G).astype(np.int32)
    special_q = [Q, Q - 1, 1, min(Q, 32), min(Q, 64), min(Q, 33),
                 min(Q, 63), 1]
    special_t = [T, 1, T, 3, 1, 5, T, 1]
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


def _time_cuda(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel():
    """Kernel == plain in every bucket; returns the kernel table row."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.ops import gap_dp_cuda
    from lordfast_tpu_torch.ops.gap_dp import myers_dist_plain

    rng = np.random.default_rng(20261016)
    tot_ms = tot_plain_ms = 0.0
    max_err = 0
    for Q, T, G in LordfastConfig().gap_buckets:
        qs, ql, ts, tl, shw = make_gaps(rng, Q, T, G)
        cpu = [torch.from_numpy(a) for a in (qs, ql, ts, tl, shw)]
        gpu = [a.cuda() for a in cpu]
        d_k, e_k = gap_dp_cuda.myers_dist(*gpu, Q, T)
        d_p, e_p = myers_dist_plain(*gpu, Q, T)
        d_c, e_c = myers_dist_plain(*cpu, Q, T)
        torch.cuda.synchronize()
        d_k, e_k = d_k.cpu(), e_k.cpu()
        err = max(int((d_k - d_p.cpu()).abs().max()),
                  int((e_k - e_p.cpu()).abs().max()),
                  int((d_k - d_c).abs().max()),
                  int((e_k - e_c).abs().max()))
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"bucket ({Q},{T},{G}): kernel != plain "
                                 f"(max abs err {err})")
        ms = _time_cuda(lambda: gap_dp_cuda.myers_dist(*gpu, Q, T), 5)
        plain_ms = _time_cuda(lambda: myers_dist_plain(*gpu, Q, T), 1)
        cells = float((ql.astype(np.int64) * tl).sum())
        tot_ms += ms
        tot_plain_ms += plain_ms
        log(f"[kernel] bucket Q={Q} T={T} G={G}: exact | kernel "
            f"{ms:.3f} ms ({cells / ms / 1e6:.2f} Gcell/s) | plain "
            f"{plain_ms:.1f} ms ({cells / plain_ms / 1e6:.3f} Gcell/s)")
    log(f"[kernel] all {len(LordfastConfig().gap_buckets)} buckets exact; "
        f"one launch each at full G: kernel {tot_ms:.3f} ms, plain "
        f"{tot_plain_ms:.1f} ms")
    return {"name": "myers_dist", "route": "cuda",
            "source": "lordfast_tpu_torch/csrc/myers_dist.cu",
            "replaces": "lordfast_tpu/ops/gap_dp_pallas.py:84",
            "also_replaces": "lordfast_tpu/ops/gap_dp_pallas.py:290",
            "launches": 0, "max_abs_err": max_err,
            "ms": tot_ms, "plain_ms": tot_plain_ms}


def sam_records(text: str):
    return [line for line in text.splitlines() if not line.startswith("@")]


def map_reads(idx, cfg, reads_path, device):
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    eng = MappingEngine(idx, cfg, device=device)
    out = io.StringIO()
    eng.map_file(reads_path, out, "chip_smoke")
    return eng, out.getvalue()


def phase_golden():
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import build_index
    from lordfast_tpu_torch.ops import gap_dp_cuda

    cfg = LordfastConfig(**GOLDEN_CFG)
    idx = build_index(DATA / "ref.fa", LordfastConfig(kmer_cache_k=8),
                      verbose=False)
    gap_dp_cuda.myers_dist.launches = 0
    t = time.time()
    eng, sam = map_reads(idx, cfg, DATA / "reads.fq", "cuda")
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = gap_dp_cuda.myers_dist.launches
    parts = eng.metrics.counters.get("gap_parts", 0)
    ours = sam_records(sam)
    golden = sam_records((DATA / "golden.sam").read_text())
    if len(ours) != len(golden):
        raise AssertionError(f"golden: {len(ours)} records, expected "
                             f"{len(golden)}")
    for i, (a, b) in enumerate(zip(golden, ours)):
        if a != b:
            raise AssertionError(f"golden line {i} differs:\nG: {a[:200]}\n"
                                 f"O: {b[:200]}")
    if launches <= 0 or launches != parts:
        raise AssertionError(f"golden: {launches} kernel launches for "
                             f"{parts} gap sub-batches")
    log(f"[golden] {len(ours)} SAM records byte-equal to golden.sam on "
        f"cuda in {dt:.2f} s; myers_dist launches {launches} == gap "
        f"sub-batches {parts}")


def _v1_dataset():
    """The bench's v1 dataset, generated into .smoke_cache/ once."""
    import bench

    CACHE.mkdir(exist_ok=True)
    ref, reads = CACHE / "v1_bench_ref.fa", CACHE / "v1_bench_reads.fq"
    if not (ref.exists() and reads.exists()):
        t = time.time()
        bench.gen_dataset(CACHE, easy=True)
        log(f"[scale] generated the v1 dataset in {time.time() - t:.1f} s")
    return ref, reads


def _first_reads(src: Path, dst: Path, n: int):
    lines = src.read_text().splitlines(keepends=True)
    dst.write_text("".join(lines[: 4 * n]))
    return [lines[4 * i][1:].split()[0] for i in range(n)]


def phase_scale():
    """Map the v1 dataset on the card; returns the kernel launch count of
    that run."""
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import build_index
    from lordfast_tpu_torch.ops import gap_dp_cuda

    ref, reads = _v1_dataset()
    cfg = LordfastConfig()
    t = time.time()
    idx = build_index(ref, cfg, verbose=False)
    log(f"[scale] index built in {time.time() - t:.1f} s (l_pac "
        f"{idx.l_pac}, sa_intv {idx.sa_intv}, kcache k={idx.kcache_k})")
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    eng = MappingEngine(idx, cfg, device="cuda")
    log(f"[scale] engine set up (index arrays on the card) in "
        f"{time.time() - t:.2f} s")
    passes = []
    for label in ("first", "second"):
        gap_dp_cuda.myers_dist.launches = 0
        n0, m0 = eng.stats["reads"], eng.stats["mapped"]
        t = time.time()
        out = io.StringIO()
        eng.map_file(reads, out, "chip_smoke")
        torch.cuda.synchronize()
        dt = time.time() - t
        n_reads, n_mapped = eng.stats["reads"] - n0, eng.stats["mapped"] - m0
        passes.append((out.getvalue(), gap_dp_cuda.myers_dist.launches,
                       eng.metrics.counters.get("gap_parts", 0)))
        tm = eng.metrics.timers
        log(f"[scale] {label} pass: {n_reads} reads in {dt:.3f} s -> "
            f"{n_reads / dt:.2f} reads/s | device {tm['device']:.3f} s "
            f"gap_dp {tm['gap_dp']:.3f} s stitch {tm['stitch']:.3f} s emit "
            f"{tm['emit']:.3f} s | myers_dist launches {passes[-1][1]}")
    sam, launches, parts = passes[0]
    log(f"[scale] {n_mapped} of {n_reads} reads mapped; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log("[scale] metrics " + eng.metrics.to_json())
    if passes[1][0] != sam:
        raise AssertionError("scale: the two passes gave different SAM")
    if launches <= 0 or launches != parts:
        raise AssertionError(f"scale: {launches} kernel launches for "
                             f"{parts} gap sub-batches")
    if n_mapped < MIN_MAPPED_FRAC * n_reads:
        raise AssertionError(f"scale: only {n_mapped} of {n_reads} mapped")

    sub = CACHE / "v1_first32.fq"
    names = set(_first_reads(reads, sub, N_SUBSET))
    cuda_sub = [r for r in sam_records(sam) if r.split("\t")[0] in names]
    t = time.time()
    _, sam_cpu = map_reads(idx, cfg, sub, "cpu")
    cpu_sub = sam_records(sam_cpu)
    if cpu_sub != cuda_sub:
        bad = next(i for i, (a, b) in enumerate(zip(cuda_sub, cpu_sub))
                   if a != b) if len(cpu_sub) == len(cuda_sub) else -1
        raise AssertionError(f"scale: the first {N_SUBSET} reads differ "
                             f"between cpu and cuda (record {bad}; "
                             f"{len(cpu_sub)} vs {len(cuda_sub)} records)")
    log(f"[scale] first {N_SUBSET} reads: {len(cpu_sub)} SAM records "
        f"byte-equal between cuda and cpu (cpu run {time.time() - t:.1f} s)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[smoke] torch.cuda.is_available() is False: this smoke "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    phase_env()
    row = phase_kernel()
    phase_golden()
    row["launches"] = phase_scale()
    print(json.dumps({"kernels": [row]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
