#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the program's sound runs and
the controls, on many seeds, in one process at a cell's own size.

    python3 portbench/probe.py --workload chr20.clr --seeds 11,12,13 \
        --jobs 3 --answers program,f32,truth,shift,half,slot,mapq60,mapq0,flip

For each seed it draws that seed's first ``--jobs`` jobs, as a run's
window would, and for each kind of answer it judges the same sample as a
run does (run.judge_window) and prints one JSON line:

- ``program``: the program as the configuration states it;
- ``f32``: the program with its lower-precision chaining scores
  (``chain_dp_dtype="f32"``; the configuration states f64), with the
  count of records unlike the program's and, in ``--diff``, the first
  reads whose records differ, both sides;
- ``truth``: the simulator's own alignments in the program's place
  (harness/control.py);
- ``half``: half of each job's reads left out;
- derived from the program's own SAM (harness/control.py): ``shift``
  (POS moved by one), ``slot`` (one slot of each 128-read batch comes
  back unmapped), ``mapq60`` / ``mapq0`` (every MAPQ the same), ``flip``
  (a split read's primary and supplementary trade flags).

The benchmark's own runs never run this.  Each reading's ``correct`` is
the run's verdict against the limits in cells/<cell>.json.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import run
from harness import control, loader

DERIVED = {"shift": control.shift_sam, "slot": control.slot_sam,
           "mapq60": lambda p: control.mapq_sam(p, 60),
           "mapq0": lambda p: control.mapq_sam(p, 0),
           "flip": control.flip_sam}


def _by_read(sam: Path) -> dict:
    """read name -> its records, SEQ, QUAL and MD left out."""
    out = {}
    with open(sam) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            c = ln.rstrip("\n").split("\t")
            keep = c[:5] + [c[5][:60]] + c[6:9] + [
                t for t in c[11:] if not t.startswith("MD:Z:")]
            out.setdefault(c[0], []).append("\t".join(keep))
    return out


def _diff(a: Path, b: Path) -> tuple:
    """(records in one SAM and not the other, reads whose records
    differ, {read: (records of a, records of b)})."""
    ra, rb = _by_read(a), _by_read(b)
    n_rec, reads = 0, {}
    for name in ra.keys() | rb.keys():
        x, y = ra.get(name, []), rb.get(name, [])
        if sorted(x) != sorted(y):
            n_rec += len(set(x) ^ set(y))
            reads[name] = (x, y)
    return n_rec, len(reads), reads


def main(argv=None, device=None, root: Path = run.ROOT,
         bench_dir: Path = run.BENCH_DIR) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--jobs", type=int, required=True)
    p.add_argument("--answers", default="program,f32,truth,half,"
                   + ",".join(DERIVED))
    p.add_argument("--out", default="")
    p.add_argument("--diff", default="",
                   help="file for the f32 reads whose records differ")
    a = p.parse_args(argv)
    bench = loader.load_json(root / "BENCHMARK.json")
    cell = loader.find_cell(bench, a.workload, False, root, bench_dir)
    if device is None:
        import torch

        if not torch.cuda.is_available():
            run.log("no CUDA device")
            return 2
        device = "cuda"
    kinds = a.answers.split(",")
    if any(k in DERIVED or k == "f32" for k in kinds) \
            and "program" not in kinds:
        kinds.insert(0, "program")
    kinds.sort(key=lambda k: k != "program")
    workdir = Path(tempfile.mkdtemp(prefix="portbench-probe-"))
    out = open(a.out, "a") if a.out else None
    diff = open(a.diff, "a") if a.diff else None
    try:
        s = run.Setup(cell, device, workdir)
        engines = {"program": s.engine}
        if "f32" in kinds:
            from lordfast_tpu_torch.pipeline.engine import MappingEngine

            engines["f32"] = MappingEngine(
                s.idx, s.cfg.replace(chain_dp_dtype="f32"), device=device)
        s.warm_up(1)
        for seed in [int(x) for x in a.seeds.split(",")]:
            s.make_pool(seed, a.jobs)
            best = None
            for kind in kinds:
                t0 = time.time()
                sams = [workdir / f"{kind}{j}.sam" for j in range(a.jobs)]
                for j, sam in enumerate(sams):
                    if kind == "truth":
                        control.write_truth_sam(s.jobs[j], s.genome, sam)
                    elif kind in DERIVED:
                        shutil.copy(workdir / f"program{j}.sam", sam)
                        DERIVED[kind](sam)
                    else:
                        fa = s.fasta[j]
                        if kind == "half":
                            fa = workdir / f"half{j}.fa"
                            control.halve_fasta(s.fasta[j], fa)
                        s.engine, keep = engines.get(kind, s.engine), s.engine
                        s.map(fa, sam)
                        s.engine = keep
                differs = reads_differ = None
                if kind == "f32":
                    differs = reads_differ = 0
                    for j, sam in enumerate(sams):
                        n_rec, n_reads, reads = _diff(
                            workdir / f"program{j}.sam", sam)
                        differs += n_rec
                        reads_differ += n_reads
                        if diff:
                            for name, (x, y) in list(reads.items())[:4]:
                                diff.write(json.dumps(
                                    {"cell": cell.name, "seed": seed,
                                     "read": name, "f64": x, "f32": y})
                                    + "\n")
                rec = {"jobs": a.jobs, "sams": sams, "error": None}
                got = run.judge_window(s, rec, seed, cell.limits, device,
                                       best)
                if kind == "program":
                    best = got["best"]
                line = {"cell": cell.name, "seed": seed, "answers": kind,
                        "correct": got["correct"],
                        "checks": {k: v["value"]
                                   for k, v in got["checks"].items()},
                        "sampled": got["sampled"],
                        "records_unlike_program": differs,
                        "reads_unlike_program": reads_differ,
                        "problems": got["problems"][:2],
                        "seconds": time.time() - t0}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
            for kind in kinds:
                for j in range(a.jobs):
                    (workdir / f"{kind}{j}.sam").unlink(missing_ok=True)
    finally:
        for f in (out, diff):
            if f:
                f.close()
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
