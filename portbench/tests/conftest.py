"""Fixtures of the benchmark's CPU tests: a tiny benchmark directory
(configuration, mix, cell, the real metric readers) and the harness on
sys.path.  Nothing here imports JAX or the JAX package."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = {
    "name": "tiny",
    "genome": {
        "contigs": [["chrA", 700_000], ["chrB", 300_000]],
        "telomere_n": 2000,
        "seed": 3,
        "repeats": [
            {"family": "alu", "kind": "interspersed", "consensus_len": 300,
             "share": 0.106, "length": {"law": "full"},
             "divergence": [0.05, 0.15]},
            {"family": "l1", "kind": "interspersed", "consensus_len": 6000,
             "share": 0.169,
             "length": {"law": "truncated_exp", "mean": 900, "min": 100},
             "divergence": [0.05, 0.20]},
            {"family": "segdup", "kind": "duplication", "share": 0.05,
             "length": {"law": "loguniform", "min": 1000, "max": 50000},
             "divergence": [0.0, 0.10]},
        ],
    },
    "lordfast": {"num_threads": 2, "kmer_cache_k": 8},
}
TINY_TRAFFIC = {
    "name": "tinymix",
    "job_reads": 12,
    "length": {"median": 3000, "sigma": 0.9, "min": 1000, "max": 30000},
    "accuracy": {"mean": 0.87, "sd": 0.02, "min": 0.80, "max": 0.95},
    "error_ratio": {"sub": 10, "ins": 60, "del": 30},
    "pool_mbp_per_s": 0.05,
}
TINY_CELL = {"sample_reads": 16,
             "limits": {"missing_reads": 0, "bad_records": 0,
                        "flag_faults": 0, "mapq_low_unique": 2,
                        "excess_pct": 0.3}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skipped without one)")


def make_bench(root: Path, cell=TINY_CELL, config=TINY_CONFIG,
               traffic=TINY_TRAFFIC) -> Path:
    """A checkout-like root with BENCHMARK.json naming one cell
    ``tiny.mix`` and a portbench-like directory beside it."""
    bench = root / "pb"
    for d in ("configs", "traffic", "cells"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", bench / "metrics", dirs_exist_ok=True)
    (bench / "configs" / "tiny.json").write_text(json.dumps(config))
    (bench / "traffic" / f"{traffic['name']}.json").write_text(
        json.dumps(traffic))
    (bench / "cells" / "tiny.mix.json").write_text(json.dumps(cell))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = {**real,
         "configs": [{"name": "tiny", "source": "test", "file":
                      "pb/configs/tiny.json", "reduced": [], "why": "test"}],
         "workloads": [{"name": "tiny.mix", "config": "tiny",
                        "traffic": traffic["name"], "chips": 1,
                        "why": "test"}]}
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return bench


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pbroot")
    make_bench(root)
    return root
