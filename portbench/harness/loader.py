"""Finds a cell's pieces by name.

``BENCHMARK.json`` names the cells, each with a configuration and a
traffic mix, and the metrics.  Everything else is a file of its own
under ``portbench/``, found by that name:

- ``BENCHMARK.json``'s ``configs[].file``: a configuration;
- ``traffic/<mix>.json``: a traffic mix;
- ``cells/<cell>.json``: a cell's sample size and the limits of its
  numbers compared;
- ``metrics/<metric>.py``: a reader with ``read(record) -> float | None``;
  one that finds nothing to read in a cell's record returns None, and
  the run leaves the metric out.

Adding a configuration, a mix, a cell or a metric is adding files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list          # [(metric entry, reader)] this run reports
    cache: Path            # where the configurations' genomes and indexes go


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def find_cell(bench: dict, name: str, trace: bool, root: Path,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of the benchmark file's contents ``bench``;
    root: the directory its paths are relative to."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_file = root / cfg["file"]
    metrics = bench["per_layer"] if trace else bench["end_to_end"]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(cfg_file),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "cells" / f"{name}.json"),
        metrics=[(m, reader(m["name"], bench_dir)) for m in metrics],
        cache=bench_dir / "cache",
    )
