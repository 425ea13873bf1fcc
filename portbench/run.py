#!/usr/bin/env python3
"""The benchmark of lordfast_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload chr20.clr --seed 7 --seconds 30 \
        --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for.  Set-up makes (first run in a checkout) or loads the cell's genome
and index, puts the index on the card, writes a pool of jobs drawn from
``--seed`` (each a FASTA of the mix's ``job_reads`` reads), as many as
the mix's ``pool_mbp_per_s`` would finish in the window, after a warm-up
job of other reads.  The window then calls
``MappingEngine.map_file`` on one job after another, one client, closed
loop, until ``--seconds`` have passed, the last job counted whole.  A
window that outruns its pool draws the next job itself, inside its time.  Once
the window has closed the run judges a sample of the window's reads
against the plain reference (harness/reference.py) and prints one JSON
line last on standard output.  ``--trace 1`` profiles the window and
reports the per-layer metrics instead of the end-to-end ones.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from contextlib import contextmanager, nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for _p in (str(BENCH_DIR), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import loader, reads, reference, store  # noqa: E402
from harness import trace as trace_mod  # noqa: E402

# top-level module names the run may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lordfast_tpu")
GEN_THREADS = 4  # threads that draw the pool in set-up
PAGE = 4096


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (lordfast_tpu_torch is not lordfast_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def bytes_written() -> int:
    """Bytes this process has passed to write calls (/proc/self/io's
    wchar: files, pipes and the terminal alike)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def host_peak_gib() -> float:
    """This process's peak resident set, in GiB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def pool_size(traffic: dict, seconds: float) -> int:
    """Jobs the pool holds: what the window would finish at the mix's
    ``pool_mbp_per_s``, plus one."""
    job_mbp = float(reads.length_grid(traffic["length"],
                                      traffic["job_reads"]).sum()) / 1e6
    return int(math.ceil(seconds * traffic["pool_mbp_per_s"] / job_mbp)) + 1


def host_sample() -> tuple:
    """(this process's CPU seconds, its minor and major page faults, the
    machine's busy CPU seconds, its stolen seconds, the cores' mean MHz)
    now: what a job's wall time is set against."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    busy = steal = mhz = -1.0
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        hz = os.sysconf("SC_CLK_TCK")
        busy = (v[0] + v[1] + v[2] + v[5] + v[6]) / hz
        steal = v[7] / hz
        with open("/proc/cpuinfo") as f:
            ms = [float(ln.split(":")[1]) for ln in f
                  if ln.startswith("cpu MHz")]
        mhz = sum(ms) / len(ms)
    except (OSError, ValueError, IndexError, ZeroDivisionError):
        pass
    return (ru.ru_utime + ru.ru_stime, ru.ru_minflt, ru.ru_majflt, busy,
            steal, mhz)


def prefault(arrays) -> int:
    """Touch every page of the memory-mapped arrays, so that no job in
    the window takes their first faults; returns the bytes touched."""
    n = 0
    for a in arrays:
        if isinstance(a, np.memmap) and a.size and a.flags.c_contiguous:
            b = a.reshape(-1).view(np.uint8)
            int(b[::PAGE].sum())
            n += b.size
    return n


class Setup:
    """What set-up leaves for the window: the engine over the cell's
    index, the genome, and the pool of jobs with their FASTQ files."""

    def __init__(self, cell, device: str, workdir: Path, engine_kw=None):
        from lordfast_tpu_torch.index.builder import load_index
        from lordfast_tpu_torch.pipeline.engine import MappingEngine

        self.device = device
        self.traffic = cell.traffic
        self.workdir = workdir
        self.genome, npz = store.prepare(cell.cache, cell.config, log)
        self.idx = load_index(npz, mmap=True)
        touched = prefault(list(vars(self.idx).values())
                           + list(getattr(self.idx, "_host_cache",
                                          {}).values())
                           + [self.genome.codes])
        log(f"{touched} mapped bytes of the index and genome touched")
        self.cfg = store.lordfast_config(cell.config)
        if device == "cuda":
            from lordfast_tpu_torch.ops import cuda_build

            cuda_build.build_all()
        self.engine = MappingEngine(self.idx, self.cfg, device=device,
                                    **(engine_kw or {}))
        self.jobs, self.fasta = [], []

    def make_pool(self, seed: int, n: int, start: int = 0) -> None:
        """Jobs start..n-1 of the mix under seed, and their FASTA files,
        after jobs 0..start-1 of the pool."""
        del self.jobs[start:], self.fasta[start:]
        self.fasta += [self.workdir / f"job{j}.fa" for j in range(start, n)]

        def make(j):
            job = reads.make_job(self.genome, self.traffic, seed, j)
            job.write_fasta(self.fasta[j])
            return job

        # numpy lets go of the interpreter lock: a few threads at once
        with ThreadPoolExecutor(max_workers=GEN_THREADS) as ex:
            self.jobs += list(ex.map(make, range(start, n)))

    def warm_up(self, seed: int) -> float:
        """One job of other reads of the same mix through map_file, so
        that every shape of the mix is built before the window; returns
        its rate in read Mbp/s."""
        import torch

        warm = reads.make_job(self.genome, self.traffic, seed, 0, stream=1)
        fa, sam = self.workdir / "warmup.fa", self.workdir / "warmup.sam"
        warm.write_fasta(fa)
        t0 = time.time()
        self.map(fa, sam)
        if self.device == "cuda":
            torch.cuda.synchronize()
        rate = warm.bases / 1e6 / (time.time() - t0)
        sam.unlink()
        fa.unlink()
        return rate

    def map(self, fasta: Path, sam: Path) -> dict:
        """One job through map_file; its engine timers and counters."""
        with open(sam, "w") as out:
            self.engine.map_file(str(fasta), out, "portbench")
        m = self.engine.metrics
        return {"timers": dict(m.timers), "counters": dict(m.counters)}

    def free(self) -> None:
        """Drop the engine and its index from the card."""
        import gc

        import torch

        self.idx._device = None
        self.engine = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


@contextmanager
def _ranges(engine):
    """Open a ``pb_<name>`` profiler range around each of the engine's
    timed stages while tracing (the engine's timers are unchanged)."""
    import torch

    m = engine.metrics
    orig = m.timer

    @contextmanager
    def timer(name):
        with torch.profiler.record_function(f"pb_{name}"):
            with orig(name):
                yield

    m.timer = timer
    try:
        yield
    finally:
        m.timer = orig


def run_window(s: Setup, seconds: float, traced: bool, seed: int) -> dict:
    """Map jobs back to back until ``seconds`` have passed.  Returns the
    window's record: jobs done, their SAM paths, time, summed timers and
    counters, the trace's figures when traced, any job's error, and each
    job's wall seconds and host figures (``host_sample``) over it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = s.device == "cuda"
    prof = None
    if traced:
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    timers, counters = {}, {}
    sams, error, job_s, hosts, late = [], None, [], [], 0
    rng = record_function if traced else (lambda _name: nullcontext())
    t0 = time.time()
    with rng("pb_window"), (_ranges(s.engine) if traced else nullcontext()):
        j = 0
        while True:
            if j >= len(s.jobs):      # drawn in the window, in its time
                s.make_pool(seed, j + 1, start=j)
                late += 1
            sam = s.workdir / f"job{j}.sam"
            h0 = host_sample()
            tj = time.time()
            try:
                with rng("pb_job"):
                    got = s.map(s.fasta[j], sam)
            except Exception:  # a job that raises fails its reads
                error = traceback.format_exc()
                sams.append(sam)
                break
            for k, v in got["timers"].items():
                timers[k] = timers.get(k, 0.0) + v
            for k, v in got["counters"].items():
                counters[k] = counters.get(k, 0) + v
            sams.append(sam)
            job_s.append(time.time() - tj)
            hosts.append([b - a for a, b in zip(h0[:5], host_sample())]
                         + [h0[5]])
            j += 1
            if time.time() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
    t1 = time.time()
    rec = {"jobs": len(sams), "sams": sams, "window_s": t1 - t0,
           "timers": timers, "counters": counters, "error": error,
           "job_s": job_s, "hosts": hosts, "late_jobs": late,
           "trace": None}
    if prof is not None:
        prof.stop()
        rec["trace"] = trace_mod.reduce(trace_mod.events_of(prof))
        del prof
    return rec


# the numbers compared, in the order printed; each at most its limit
CHECKED = ("missing_reads", "bad_records", "flag_faults", "mapq_low_unique",
           "excess_pct")


def sample_reads(s: Setup, n_jobs: int, seed: int, n: int) -> list:
    """(job, read) pairs drawn from the seed among the window's reads,
    with the longest read of the window among them."""
    rng = np.random.default_rng([int(seed), 7])
    pairs = [(j, i) for j in range(n_jobs)
             for i in range(len(s.jobs[j].lens))]
    pick = rng.choice(len(pairs), size=min(n, len(pairs)), replace=False)
    chosen = {pairs[k] for k in pick}
    longest = max(pairs, key=lambda p: s.jobs[p[0]].lens[p[1]])
    chosen.add(longest)
    return sorted(chosen)


def judge_window(s: Setup, rec: dict, seed: int, limits: dict,
                 device: str, best=None) -> dict:
    """The numbers compared, each beside its limit, and the counts; best:
    the sample's least edit distances when already worked out."""
    n_jobs = rec["jobs"]
    attempted = sum(len(s.jobs[j].lens) for j in range(n_jobs))
    failed = 0
    ok_jobs = n_jobs - (1 if rec["error"] else 0)
    for j in range(n_jobs):
        if j >= ok_jobs or not rec["sams"][j].exists():
            failed += len(s.jobs[j].lens)
            continue
        seen, _ = reference.scan_sam(rec["sams"][j])
        failed += sum(1 for name in s.jobs[j].names if name not in seen)
    sample = sample_reads(s, ok_jobs, seed, limits["sample_reads"]) \
        if ok_jobs else []
    if sample:
        got = reference.judge(s.jobs, rec["sams"], sample, s.genome, device,
                              best)
        got["excess_pct"] = (100.0 * float(got["excess"].sum())
                             / float(got["lens"].sum()))
    else:
        got = {k: 10**9 for k in CHECKED}
        got.update(excess_pct=100.0, problems=["no job finished"], best=None)
    got["missing_reads"] = failed
    lim = limits["limits"]
    checks = {k: {"value": got[k], "limit": lim[k]} for k in CHECKED}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"attempted": attempted, "failed": failed, "checks": checks,
            "correct": correct, "sampled": len(sample),
            "problems": got["problems"], "best": got["best"]}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, root: Path = ROOT,
         bench_dir: Path = BENCH_DIR) -> int:
    """One run.  device: None looks for the cards the cell asks for and
    fails without them; the tests pass "cpu" to drive the rest of a run
    on the CPU."""
    args = parse_args(argv)
    bench = loader.load_json(root / "BENCHMARK.json")
    cell = loader.find_cell(bench, args.workload, bool(args.trace), root,
                            bench_dir)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA device: torch.cuda.is_available() is False")
            return 2
        if torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} asks for {cell.chips} cards; "
                f"{torch.cuda.device_count()} present")
            return 2
        device = "cuda"
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        return _run(args, cell, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(args, cell, device: str, workdir: Path) -> int:
    import torch

    s = Setup(cell, device, workdir)
    rate = s.warm_up(args.seed)
    s.make_pool(args.seed, pool_size(cell.traffic, args.seconds))
    setup_s = time.time() - T_START
    log(f"set-up {setup_s:.3f} s; warm-up job at {rate:.3f} read Mbp/s; "
        f"{len(s.jobs)} jobs in the pool; this process wrote "
        f"{bytes_written()} bytes so far, its host peak "
        f"{host_peak_gib():.2f} GiB")
    rec = run_window(s, args.seconds, bool(args.trace), args.seed)
    if rec["error"]:
        log(f"a job raised:\n{rec['error']}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    s.free()
    got = judge_window(s, rec, args.seed, cell.limits, device)
    for p in got["problems"]:
        log(f"problem: {p}")
    for sam in rec["sams"]:
        sam.unlink(missing_ok=True)

    n_done = rec["jobs"] - (1 if rec["error"] else 0)
    mbp = sum(s.jobs[j].bases for j in range(n_done)) / 1e6
    record = {"cell": cell.name, "config": cell.config["name"],
              "mix": cell.traffic["name"],
              "setup_s": setup_s, "window_s": rec["window_s"],
              "read_mbp": mbp, "jobs": rec["jobs"], "timers": rec["timers"],
              "counters": rec["counters"], "trace": rec["trace"]}
    metrics = {}
    for m, read in cell.metrics:
        v = read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": got["correct"], "attempted": got["attempted"],
           "failed": got["failed"], "metrics": metrics, "device": dev}
    tr = rec["trace"]
    if args.trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = got["checks"]
    log(f"window {rec['window_s']:.3f} s, {rec['jobs']} jobs, {mbp:.3f} "
        f"read Mbp; {got['sampled']} reads judged")
    log("job seconds " + " ".join(f"{x:.3f}" for x in rec["job_s"]))
    log(f"jobs drawn inside the window: {rec['late_jobs']}")
    log("per job: wall s, CPU s, minor faults, major faults, machine busy "
        "s, stolen s, MHz: " + "; ".join(
            f"{w:.3f} {h[0]:.3f} {h[1]} {h[2]} {h[3]:.2f} {h[4]:.2f} "
            f"{h[5]:.0f}" for w, h in zip(rec["job_s"], rec["hosts"])))
    log("timers " + " ".join(f"{k} {v:.3f}" for k, v in
                             sorted(rec["timers"].items())))
    log("counters " + " ".join(f"{k} {v}" for k, v in
                               sorted(rec["counters"].items())))
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}")
        return 3
    for name, c in got["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
