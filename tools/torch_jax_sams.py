#!/usr/bin/env python3
"""The JAX package's SAMs of the bench's v1 and v2 datasets, as one
sha256 a read, for the port's smoke to hold its card SAMs against.

    JAX_PLATFORMS=cpu python3 tools/torch_jax_sams.py [--cache DIR]
        [--jobs N] [--digests tests/data/jax_sam_digests.json]
        [--port [--sa-interval N]]

Generates v1 (``bench.gen_dataset(easy=True)``) and v2 (``easy=False``)
into DIR (default ``.smoke_cache/``, the smoke's files), builds each
index with the JAX package's builder at ``LordfastConfig()`` and maps
every read with the JAX package's engine on the CPU at its defaults off
the TPU: the jnp kernels, the escalations on the host stitcher (no
device offload).  A read's records do not depend on the other reads, so
the reads go in N chunks, one process each.  Writes, for each dataset,
the read count and the sha256 of each read's record lines
(``chip_smoke.read_digests``: the ``@`` header lines aside), with the
JAX package's commit; ``chip_smoke.py`` compares the card's v1 and v2
SAMs with them read by read.  With ``--port`` it writes nothing: it
maps the same chunks with the port's engine on the CPU instead, over
the same index file (the port's loader reads it; ``--sa-interval N``
samples its SA at N first, ``chip_smoke.slice_sa``), and prints how many
reads of each dataset equal their digests.  This is the only file of
the repository outside the tests that runs the JAX package; nothing of
the port imports it.
"""

from __future__ import annotations

import argparse
import io
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

DATASETS = {"v1": True, "v2": False}  # tag -> gen_dataset(easy=...)


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")


def _paths(cache: Path, tag: str):
    pre = "v1_" if DATASETS[tag] else ""
    return (cache / f"{pre}bench_ref.fa", cache / f"{pre}bench_reads.fq",
            cache / f"{tag}.jax.lft.npz")


def prepare(cache: Path, tag: str):
    """The dataset and its JAX index (built once, saved beside it)."""
    _jax_cpu()
    import bench
    from lordfast_tpu.config import LordfastConfig
    from lordfast_tpu.index.builder import build_index, save_index

    cache.mkdir(exist_ok=True)
    ref, reads, npz = _paths(cache, tag)
    if not (ref.exists() and reads.exists()):
        bench.gen_dataset(cache, easy=DATASETS[tag])
    if not npz.exists():
        t = time.time()
        idx = build_index(ref, LordfastConfig(), verbose=False)
        save_index(idx, cache / f"{tag}.jax.part.npz")
        os.replace(cache / f"{tag}.jax.part.npz", npz)
        print(f"[jax-sams] {tag}: index built in {time.time() - t:.1f} s "
              f"(sa_intv {idx.sa_intv})", flush=True)


def _part(cache: Path, tag: str, part: int, parts: int) -> Path:
    """A FASTQ of every ``parts``-th read of ``tag`` from ``part`` on."""
    lines = _paths(cache, tag)[1].read_text().splitlines(keepends=True)
    sub = cache / f"{tag}.jax.part{part}of{parts}.fq"
    sub.write_text("".join(
        "".join(lines[i : i + 4])
        for i in range(4 * part, len(lines), 4 * parts)))
    return sub


def map_chunk(cache: Path, tag: str, part: int, parts: int,
              port_intv: int = 0) -> str:
    """The SAM of every ``parts``-th read of ``tag`` from ``part`` on, at
    LordfastConfig(), on the CPU: by the JAX engine, or with
    ``port_intv`` by the port's engine over the SA sampled at it (1: the
    full SA)."""
    sub = _part(cache, tag, part, parts)
    npz = _paths(cache, tag)[2]
    if port_intv:
        import torch

        from chip_smoke import slice_sa
        from lordfast_tpu_torch.config import LordfastConfig
        from lordfast_tpu_torch.index.builder import load_index
        from lordfast_tpu_torch.pipeline.engine import MappingEngine

        torch.set_num_threads(3)
        idx = load_index(npz)
        if port_intv > 1:
            idx = slice_sa(idx, port_intv)
        eng = MappingEngine(idx, LordfastConfig(), device="cpu")
    else:
        _jax_cpu()
        from lordfast_tpu.config import LordfastConfig
        from lordfast_tpu.index.builder import load_index
        from lordfast_tpu.pipeline.engine import MappingEngine

        eng = MappingEngine(load_index(npz), LordfastConfig())
    out = io.StringIO()
    t = time.time()
    eng.map_file(sub, out, "torch_jax_sams")
    print(f"[jax-sams] {tag} part {part} of {parts}"
          f"{f' (port, sa_intv {port_intv})' if port_intv else ''}: "
          f"{eng.stats['reads']} reads in {time.time() - t:.1f} s",
          flush=True)
    return out.getvalue()


def main() -> int:
    from chip_smoke import read_digests

    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", type=Path, default=HERE / ".smoke_cache")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--digests", type=Path,
                    default=HERE / "tests" / "data" / "jax_sam_digests.json")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--sa-interval", type=int, default=1)
    args = ap.parse_args()
    t0 = time.time()
    commit = subprocess.run(
        ["git", "log", "-1", "--format=%H", "--", "lordfast_tpu"], cwd=HERE,
        capture_output=True, text=True, check=True).stdout.strip()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(DATASETS), mp_context=ctx) as pool:
        list(pool.map(prepare, [args.cache] * len(DATASETS), DATASETS))
    jobs = [(tag, p) for tag in DATASETS for p in range(args.jobs)]
    port_intv = args.sa_interval if args.port else 0
    with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
        sams = list(pool.map(map_chunk, *zip(*[
            (args.cache, tag, p, args.jobs, port_intv) for tag, p in jobs])))
    if args.port:
        want = json.loads(args.digests.read_text())["datasets"]
        for tag in DATASETS:
            got = {}
            for (t, _), sam in zip(jobs, sams):
                if t == tag:
                    got.update(read_digests(sam))
            ds = want[tag]["digests"]
            same = sum(got.get(n) == d for n, d in ds.items())
            print(f"[jax-sams] {tag}: the port (CPU, sa_intv "
                  f"{args.sa_interval}): {same} of {len(ds)} reads equal "
                  f"the JAX package's digests ({len(got)} reads with "
                  f"records)", flush=True)
        return 0
    out = {"tool": "tools/torch_jax_sams.py", "jax_package_commit": commit,
           "config": "LordfastConfig()", "engine": "lordfast_tpu "
           "MappingEngine on the CPU (jnp kernels, host escalations)",
           "datasets": {}}
    for tag in DATASETS:
        _, reads, _ = _paths(args.cache, tag)
        names = [ln[1:].split()[0] for ln in
                 reads.read_text().splitlines()[::4]]
        digests = {}
        for (t, _), sam in zip(jobs, sams):
            if t == tag:
                digests.update(read_digests(sam))
        missing = [n for n in names if n not in digests]
        if missing:
            raise AssertionError(f"{tag}: no records for {missing[:5]}")
        out["datasets"][tag] = {
            "reads": len(names),
            "digests": {n: digests[n] for n in names}}
        print(f"[jax-sams] {tag}: {len(names)} reads", flush=True)
    args.digests.write_text(json.dumps(out, indent=1) + "\n")
    print(f"[jax-sams] wrote {args.digests} in {time.time() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
