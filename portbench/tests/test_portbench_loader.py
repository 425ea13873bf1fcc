"""The harness finds a configuration, a mix, a cell and a metric by
name, so that each can be added as new files and entries alone."""

import hashlib
import json
from pathlib import Path

from conftest import BENCH, ROOT, TINY_CONFIG, TINY_TRAFFIC, make_bench

from harness import loader


def _digests(d: Path) -> dict:
    return {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file()
            and "cache" not in p.parts and "__pycache__" not in p.parts}


def test_real_cells_resolve():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        for trace in (False, True):
            cell = loader.find_cell(bench, w["name"], trace, ROOT)
            names = [m["name"] for m, _ in cell.metrics]
            assert "setup_s" in names or trace
            assert names, w["name"]
            assert cell.limits["limits"]["missing_reads"] == 0


def test_new_config_mix_cell_and_metric_are_found_as_files(tmp_path):
    before = _digests(BENCH)
    bench_dir = make_bench(tmp_path)
    # a new mix, configuration, cell and per-layer metric: files only
    mix = {**TINY_TRAFFIC, "name": "newmix", "job_reads": 5}
    (bench_dir / "traffic" / "newmix.json").write_text(json.dumps(mix))
    cfg = {**TINY_CONFIG, "name": "newcfg"}
    (bench_dir / "configs" / "newcfg.json").write_text(json.dumps(cfg))
    (bench_dir / "cells" / "newcfg.newmix.json").write_text(json.dumps(
        {"sample_reads": 3, "limits": {"missing_reads": 0, "bad_records": 0,
                                       "excess_pct": 1.0}}))
    # a metric of the new mix alone: nothing to read elsewhere
    (bench_dir / "metrics" / "jobs_done.py").write_text(
        "def read(rec):\n    return float(rec['jobs']) "
        "if rec.get('mix') == 'newmix' else None\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "newcfg", "source": "test",
                         "file": "pb/configs/newcfg.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": "newcfg.newmix", "config": "newcfg",
                           "traffic": "newmix", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine loop",
                           "moves": "read_mbp_per_s"})
    cell = loader.find_cell(b, "newcfg.newmix", True, tmp_path, bench_dir)
    assert cell.config["name"] == "newcfg"
    assert cell.traffic["job_reads"] == 5
    assert cell.limits["sample_reads"] == 3
    got = {m["name"]: read for m, read in cell.metrics}
    assert got["jobs_done"]({"jobs": 4, "mix": "newmix"}) == 4.0
    # in another cell the reader finds nothing, and the run leaves it out
    old = loader.find_cell(b, "tiny.mix", True, tmp_path, bench_dir)
    read = dict((m["name"], r) for m, r in old.metrics)["jobs_done"]
    assert read({"jobs": 4, "mix": "tinymix"}) is None
    assert _digests(BENCH) == before
