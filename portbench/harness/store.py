"""The configuration's genome and index, made once in a checkout.

Both live in ``portbench/cache/<config>-<hash>/``, a fixed path keyed by
a hash of the configuration's genome and index settings, so every later run of a cell in the
checkout loads them, as a user's ``--search`` loads an index built once
by ``--index``.  The genome's codes stay beside the index for the
reference, with the places of its repeat copies; its FASTA is deleted
once the index is built.  Each file is
written under a temporary name and renamed into place; ``done`` is
written last.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np

from .genome import Genome, make_genome, write_fasta


# the version of what a configuration's directory holds
LAYOUT = 2
# the LordfastConfig fields the index depends on (index/builder.py)
INDEX_FIELDS = ("occ_interval", "sa_interval", "sa_mem_budget",
                "kmer_cache_k")


def cache_dir(cache: Path, config: dict) -> Path:
    """The configuration's directory: keyed by a hash of its genome and
    of the settings its index depends on, so that search settings can
    change without a rebuild."""
    cfg = lordfast_config(config)
    key = json.dumps({"layout": LAYOUT, "genome": config["genome"],
                      "index": {f: getattr(cfg, f) for f in INDEX_FIELDS}},
                     sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    return cache / f"{config['name']}-{digest}"


def lordfast_config(config: dict):
    """The program's LordfastConfig: its defaults, but for the keys the
    configuration's ``lordfast`` block fixes."""
    from lordfast_tpu_torch.config import LordfastConfig

    return LordfastConfig(**config.get("lordfast", {})).validate()


def genome_arrays(d: Path, spec: dict) -> Genome:
    """The genome of ``spec``, from d/genome.npy and d/repeats.npz (the
    repeat copies' places) when they are there."""
    path, reps = d / "genome.npy", d / "repeats.npz"
    if path.exists() and reps.exists():
        g = make_layout(spec)
        g.codes = np.load(path, mmap_mode="r")
        with np.load(reps) as z:
            for key in z.files:
                kind, fam = key.split(".", 1)
                if kind == "src":
                    g.sources[fam] = z[key]
                elif kind == "dest":
                    g.placements[fam] = (z[key], z[f"len.{fam}"])
        return g
    g = make_genome(spec)
    arrays = {}
    for fam, (dest, ln) in g.placements.items():
        arrays[f"dest.{fam}"], arrays[f"len.{fam}"] = dest, ln
    for fam, src in g.sources.items():
        arrays[f"src.{fam}"] = src
    with open(d / "repeats.tmp.npz", "wb") as f:
        np.savez(f, **arrays)
    os.replace(d / "repeats.tmp.npz", reps)
    tmp = d / "genome.tmp.npy"
    np.save(tmp, g.codes)
    os.replace(tmp, path)
    return g


def make_layout(spec: dict) -> Genome:
    """The contig table of spec without its bases."""
    names = [c[0] for c in spec["contigs"]]
    lengths = np.array([c[1] for c in spec["contigs"]], np.int64)
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    tel = int(spec["telomere_n"])
    cores = np.stack([offsets + tel, offsets + lengths - tel], axis=1)
    return Genome(names, lengths, offsets, np.zeros(0, np.uint8), cores)


def prepare(cache: Path, config: dict, log) -> tuple:
    """(genome, index path): made under cache if it has none yet."""
    d = cache_dir(cache, config)
    d.mkdir(parents=True, exist_ok=True)
    npz = d / "genome.fa.lft.npz"
    done = d / "done"
    if done.exists():
        return genome_arrays(d, config["genome"]), npz
    from lordfast_tpu_torch.index.builder import (build_index,
                                                  remove_device_cache,
                                                  save_device_cache,
                                                  save_index)

    t0 = time.time()
    g = genome_arrays(d, config["genome"])
    log(f"genome made in {time.time() - t0:.1f} s ({g.total} bp)")
    fasta = d / "genome.fa"
    write_fasta(g, fasta)
    t1 = time.time()
    idx = build_index(fasta, lordfast_config(config), verbose=True)
    remove_device_cache(npz)
    tmp = d / "genome.fa.tmp.npz"
    save_index(idx, tmp)
    os.replace(tmp, npz)
    save_device_cache(idx, npz)
    fasta.unlink()
    del idx
    done.write_text("1\n")
    log(f"index built in {time.time() - t1:.1f} s")
    return g, npz
