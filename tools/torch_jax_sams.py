#!/usr/bin/env python3
"""The JAX package's SAMs of the bench's v1 and v2 datasets, as one
sha256 a read, for the port's smoke to hold its card SAMs against.

    JAX_PLATFORMS=cpu python3 tools/torch_jax_sams.py [--cache DIR]
        [--jobs N] [--digests tests/data/jax_sam_digests.json]
        [--chain dp-n2|clasp]
        [--seeder extend-whole|extend-whole-2|extend-whole-3]
        [--port [--sa-interval N]] [--g2200]

Generates v1 (``bench.gen_dataset(easy=True)``) and v2 (``easy=False``)
into DIR (default ``.smoke_cache/``, the smoke's files), builds each
index with the JAX package's builder at ``LordfastConfig()`` and maps
every read with the JAX package's engine on the CPU at its defaults off
the TPU: the jnp kernels, the escalations on the host stitcher (no
device offload).  ``--chain`` and ``--seeder`` pick the mapping
configuration (``config_kwargs``); the default one, dp-n2 and
extend-whole, is the file's ``datasets`` section, any other its entry
under ``configs`` (``config_name``: ``clasp``, ``extend-whole-2``,
``extend-whole-3``), which also holds the ``LordfastConfig`` it ran
and the JAX package's commit; a run rewrites its own section only.  A
read's records do not depend on the other reads, so the reads go in N
chunks, one process each.  Writes, for each dataset,
the read count and the sha256 of each read's record lines
(``chip_smoke.read_digests``: the ``@`` header lines aside), with the
JAX package's commit; ``chip_smoke.py`` compares the card's v1 and v2
SAMs with them read by read.  With ``--port`` it writes nothing: it
maps the same chunks with the port's engine on the CPU instead, over
the same index file (the port's loader reads it; ``--sa-interval N``
samples its SA at N first, ``chip_smoke.slice_sa``), and prints how many
reads of each dataset equal their digests, and which of the others
``chip_smoke.KNOWN_DIVERGENT`` names.  ``--g2200`` does the same for
the file's ``g2200`` section instead: the 1/1000 scale of
tools/torch_g2200.py's 13-contig genome (its ``DIGEST_DIV``) and the 48
reads of its ``DIGEST_READS``, at ``DIGEST_CONFIG``, in one process
(~1 min), which tests/test_torch_g2200.py holds the port to.  This is
the only file of the repository outside the tests that runs the JAX
package; nothing of the port imports it.
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
CHAINS = ("dp-n2", "clasp")
SEEDERS = ("extend-whole", "extend-whole-2", "extend-whole-3")


def config_kwargs(chain: str, seeder: str) -> dict:
    """The LordfastConfig keywords of a --chain / --seeder pair: only
    those that differ from the defaults (dp-n2, extend-whole)."""
    kw = {}
    if chain != CHAINS[0]:
        kw["chain_alg"] = chain
    if seeder != SEEDERS[0]:
        kw["seeder"] = seeder
    return kw


def config_name(kw: dict):
    """The ``configs`` key of a configuration (None: the default one,
    the file's ``datasets``)."""
    return "+".join(kw[k] for k in ("chain_alg", "seeder") if k in kw) or None


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
              port_intv: int = 0, kw: dict | None = None) -> str:
    """The SAM of every ``parts``-th read of ``tag`` from ``part`` on, at
    LordfastConfig(**kw), on the CPU: by the JAX engine, or with
    ``port_intv`` by the port's engine over the SA sampled at it (1: the
    full SA)."""
    kw = kw or {}
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
        eng = MappingEngine(idx, LordfastConfig(**kw), device="cpu")
    else:
        _jax_cpu()
        from lordfast_tpu.config import LordfastConfig
        from lordfast_tpu.index.builder import load_index
        from lordfast_tpu.pipeline.engine import MappingEngine

        eng = MappingEngine(load_index(npz), LordfastConfig(**kw))
    out = io.StringIO()
    t = time.time()
    eng.map_file(sub, out, "torch_jax_sams")
    print(f"[jax-sams] {config_name(kw) or 'default'} {tag} part {part} "
          f"of {parts}"
          f"{f' (port, sa_intv {port_intv})' if port_intv else ''}: "
          f"{eng.stats['reads']} reads in {time.time() - t:.1f} s",
          flush=True)
    return out.getvalue()


def g2200_files(cache: Path):
    """(reference, reads) of the --g2200 section: torch_g2200's genome at
    1/DIGEST_DIV and its DIGEST_READS, written into cache once."""
    sys.path.insert(0, str(HERE / "tools"))
    import torch_g2200 as g22

    lay = g22.layout(g22.DIGEST_DIV)
    d = cache / f"g2200_div{g22.DIGEST_DIV}"
    d.mkdir(parents=True, exist_ok=True)
    ref, reads = d / "G.fa", d / "reads48.fq"
    if not ref.exists():
        g22.write_fasta(lay, ref)
    if not reads.exists():
        g22.write_reads(lay, reads, g22.pick(g22.draw_truth(lay),
                                             g22.DIGEST_READS))
    return ref, reads, g22


def g2200_sam(cache: Path, port: bool) -> tuple:
    """(the SAM of the --g2200 reads, their names, the config keywords):
    the genome indexed and mapped on the CPU by the JAX package, or with
    ``port`` by the port."""
    ref, reads, g22 = g2200_files(cache)
    kw = dict(g22.DIGEST_CONFIG)
    if port:
        from lordfast_tpu_torch.config import LordfastConfig
        from lordfast_tpu_torch.index.builder import build_index
        from lordfast_tpu_torch.pipeline.engine import MappingEngine

        eng = MappingEngine(build_index(ref, LordfastConfig(**kw),
                                        verbose=False),
                            LordfastConfig(**kw), device="cpu")
    else:
        _jax_cpu()
        from lordfast_tpu.config import LordfastConfig
        from lordfast_tpu.index.builder import build_index
        from lordfast_tpu.pipeline.engine import MappingEngine

        eng = MappingEngine(build_index(ref, LordfastConfig(**kw),
                                        verbose=False), LordfastConfig(**kw))
    out = io.StringIO()
    eng.map_file(reads, out, "torch_jax_sams")
    names = [ln[1:].split()[0] for ln in reads.read_text().splitlines()[::4]]
    return out.getvalue(), names, kw


def main_g2200(args, commit: str) -> int:
    from chip_smoke import read_digests

    t0 = time.time()
    sam, names, kw = g2200_sam(args.cache, args.port)
    got = read_digests(sam)
    if args.port:
        want = json.loads(args.digests.read_text())["g2200"]["digests"]
        bad = [n for n in names if got.get(n) != want[n]]
        print(f"[jax-sams] g2200: the port (CPU): {len(names) - len(bad)} of "
              f"{len(names)} reads equal the JAX package's digests; differ: "
              f"{bad}", flush=True)
        return 1 if bad else 0
    missing = [n for n in names if n not in got]
    if missing:
        raise AssertionError(f"g2200: no records for {missing[:5]}")
    out = json.loads(args.digests.read_text())
    args_s = ", ".join(f"{k}={v!r}" for k, v in kw.items())
    out["g2200"] = {
        "source": "tools/torch_g2200.py layout(DIGEST_DIV), DIGEST_READS",
        "div": int(g2200_files(args.cache)[2].DIGEST_DIV),
        "config": f"LordfastConfig({args_s})", "kwargs": kw,
        "jax_package_commit": commit,
        "engine": "lordfast_tpu MappingEngine on the CPU (jnp kernels, "
                  "host escalations)",
        "reads": len(names), "digests": {n: got[n] for n in names}}
    args.digests.write_text(json.dumps(out, indent=1) + "\n")
    print(f"[jax-sams] wrote {args.digests} (g2200, {len(names)} reads) in "
          f"{time.time() - t0:.1f} s", flush=True)
    return 0


def main() -> int:
    from chip_smoke import KNOWN_DIVERGENT, divergent_key, jax_digests, \
        read_digests

    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", type=Path, default=HERE / ".smoke_cache")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--digests", type=Path,
                    default=HERE / "tests" / "data" / "jax_sam_digests.json")
    ap.add_argument("--chain", choices=CHAINS, default=CHAINS[0])
    ap.add_argument("--seeder", choices=SEEDERS, default=SEEDERS[0])
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--sa-interval", type=int, default=1)
    ap.add_argument("--g2200", action="store_true")
    args = ap.parse_args()
    kw = config_kwargs(args.chain, args.seeder)
    name = config_name(kw)
    t0 = time.time()
    commit = subprocess.run(
        ["git", "log", "-1", "--format=%H", "--", "lordfast_tpu"], cwd=HERE,
        capture_output=True, text=True, check=True).stdout.strip()
    if args.g2200:
        return main_g2200(args, commit)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(DATASETS), mp_context=ctx) as pool:
        list(pool.map(prepare, [args.cache] * len(DATASETS), DATASETS))
    jobs = [(tag, p) for tag in DATASETS for p in range(args.jobs)]
    port_intv = args.sa_interval if args.port else 0
    with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
        sams = list(pool.map(map_chunk, *zip(*[
            (args.cache, tag, p, args.jobs, port_intv, kw)
            for tag, p in jobs])))
    got = {tag: {} for tag in DATASETS}
    for (tag, _), sam in zip(jobs, sams):
        got[tag].update(read_digests(sam))
    if args.port:
        for tag in DATASETS:
            ds = jax_digests(name, tag, args.digests)["digests"]
            bad = [n for n, d in ds.items() if got[tag].get(n) != d]
            known = [n for n in bad
                     if divergent_key(name, tag, n) in KNOWN_DIVERGENT]
            print(f"[jax-sams] {name or 'default'} {tag}: the port (CPU, "
                  f"sa_intv {args.sa_interval}): {len(ds) - len(bad)} of "
                  f"{len(ds)} reads equal the JAX package's digests "
                  f"({len(got[tag])} reads with records); {len(known)} "
                  f"known to differ {known}, {len(bad) - len(known)} not: "
                  f"{[n for n in bad if n not in known]}", flush=True)
        return 0
    sections = {}
    for tag in DATASETS:
        _, reads, _ = _paths(args.cache, tag)
        names = [ln[1:].split()[0] for ln in
                 reads.read_text().splitlines()[::4]]
        missing = [n for n in names if n not in got[tag]]
        if missing:
            raise AssertionError(f"{tag}: no records for {missing[:5]}")
        sections[tag] = {"reads": len(names),
                         "digests": {n: got[tag][n] for n in names}}
        print(f"[jax-sams] {name or 'default'} {tag}: {len(names)} reads",
              flush=True)
    old = (json.loads(args.digests.read_text()) if args.digests.exists()
           else {})
    engine = ("lordfast_tpu MappingEngine on the CPU (jnp kernels, host "
              "escalations)")
    if name is None:
        out = {"tool": "tools/torch_jax_sams.py",
               "jax_package_commit": commit, "config": "LordfastConfig()",
               "engine": engine, "datasets": sections}
        for key in ("configs", "g2200"):
            if key in old:
                out[key] = old[key]
    else:
        out = old or {"tool": "tools/torch_jax_sams.py", "datasets": {}}
        args_s = ", ".join(f"{k}={v!r}" for k, v in kw.items())
        out["configs"] = dict(sorted({**out.get("configs", {}), name: {
            "config": f"LordfastConfig({args_s})", "kwargs": kw,
            "jax_package_commit": commit, "engine": engine,
            **sections}}.items()))
    args.digests.write_text(json.dumps(out, indent=1) + "\n")
    print(f"[jax-sams] wrote {args.digests} ({name or 'datasets'}) in "
          f"{time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
