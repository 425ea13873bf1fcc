"""Whole runs of the harness on the CPU over a tiny cell: a sound run is
correct; the timed path broken underneath (half of a job's reads left
out, answers altered where they are produced) or the control in the
program's place is not.  Without a card, or without the program, a run
exits non-zero and prints no result.  Nothing the benchmark imports is
JAX or the JAX package."""

import ast
import copy
import json
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT, TINY_TRAFFIC, make_bench

import run
from harness import control

def _run(tiny_root, capsys, seed=2**31 + 5, trace=0, seconds=2) -> dict:
    rc = run.main(["--workload", "tiny.mix", "--seconds", str(seconds),
                   "--trace", str(trace), "--seed", str(seed)], device="cpu",
                  root=tiny_root, bench_dir=tiny_root / "pb")
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    line = out.strip().splitlines()[-1]
    res = json.loads(line)
    # the numbers compared come last, on stderr and in the line
    assert list(res)[-1] == "checks"
    tail = err.strip().splitlines()[-len(run.CHECKED):]
    assert [t.split()[0] for t in tail] == list(res["checks"])
    return res


def test_sound_run_is_correct(tiny_root, capsys):
    res = _run(tiny_root, capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] % TINY_TRAFFIC["job_reads"] == 0
    assert set(res["metrics"]) == {"read_mbp_per_s", "setup_s"}
    assert res["device"]["count"] == 1
    assert not run.forbidden_modules()


def test_traced_run_reports_the_per_layer_metrics(tiny_root, capsys):
    res = _run(tiny_root, capsys, trace=1)
    assert res["correct"] is True
    assert "stitch_ms_per_mbp" in res["metrics"]
    assert "read_mbp_per_s" not in res["metrics"]
    assert "window_s" in res["device"] and "busy_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_half_of_each_job_left_out_is_not_correct(tiny_root, capsys,
                                                   monkeypatch, tmp_path):
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    orig = MappingEngine.map_file

    def half(self, seq_path, out, *a, **kw):
        dst = tmp_path / "half.fa"
        control.halve_fasta(seq_path, dst)
        return orig(self, str(dst), out, *a, **kw)

    monkeypatch.setattr(MappingEngine, "map_file", half)
    res = _run(tiny_root, capsys, seed=11)
    assert res["correct"] is False
    assert res["checks"]["missing_reads"]["value"] == res["failed"] > 0


def test_answers_altered_where_produced_are_not_correct(tiny_root, capsys,
                                                        monkeypatch):
    from lordfast_tpu_torch.io import sam as sam_io

    orig = sam_io._write_line

    def shifted(out, cfg, qname, flag, r, *a):
        r = copy.copy(r)
        r.rstart += 1
        return orig(out, cfg, qname, flag, r, *a)

    monkeypatch.setattr(sam_io, "_write_line", shifted)
    res = _run(tiny_root, capsys, seed=12)
    assert res["correct"] is False
    assert res["checks"]["bad_records"]["value"] > 0


def test_control_in_the_programs_place_is_not_correct(tiny_root, capsys,
                                                      monkeypatch):
    orig = run.Setup.map

    def truth(self, fasta, sam):
        if fasta not in self.fasta:          # the warm-up job
            return orig(self, fasta, sam)
        control.write_truth_sam(self.jobs[self.fasta.index(fasta)],
                                self.genome, sam)
        return {"timers": {}, "counters": {}}

    monkeypatch.setattr(run.Setup, "map", truth)
    # one job: the control takes no time, and would outrun the pool
    res = _run(tiny_root, capsys, seed=13, seconds=0)
    assert res["correct"] is False
    c = res["checks"]["excess_pct"]
    assert c["value"] > c["limit"]
    assert res["checks"]["bad_records"]["value"] == 0


@pytest.mark.parametrize("fault", ["slot", "mapq0"])
def test_planted_faults_are_not_correct(tiny_root, capsys, monkeypatch,
                                        fault):
    """One slot of each batch comes back unmapped; every MAPQ is 0."""
    orig = run.Setup.map
    plant = {"slot": control.slot_sam,
             "mapq0": lambda p: control.mapq_sam(p, 0)}[fault]

    def faulty(self, fasta, sam):
        got = orig(self, fasta, sam)
        plant(sam)
        return got

    monkeypatch.setattr(run.Setup, "map", faulty)
    res = _run(tiny_root, capsys, seed=14)
    assert res["correct"] is False
    name = {"slot": "excess_pct", "mapq0": "mapq_low_unique"}[fault]
    c = res["checks"][name]
    assert c["value"] > c["limit"], res["checks"]


def test_reads_of_20_to_30_kb_map_on_the_cpu(tmp_path, capsys):
    """The clr mix's upper end, which the card had not run before."""
    long_mix = {**TINY_TRAFFIC, "name": "longmix", "job_reads": 3,
                "length": {"median": 25000, "sigma": 0.1, "min": 20000,
                           "max": 30000}}
    make_bench(tmp_path, traffic=long_mix)
    rc = run.main(["--workload", "tiny.mix", "--seconds", "1", "--trace",
                   "0", "--seed", "31"], device="cpu", root=tmp_path,
                  bench_dir=tmp_path / "pb")
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]


def test_no_card_exits_nonzero_without_a_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "chr20.clr", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_exits_nonzero(tmp_path):
    """A checkout that holds only BENCHMARK.json and portbench/."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    code = ("import sys; sys.path.insert(0, 'portbench'); import run; "
            "sys.exit(run.main(['--workload', 'chr20.clr', '--seed', '1', "
            "'--seconds', '1', '--trace', '0'], device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "lordfast_tpu_torch" in p.stderr


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["lordfast_tpu_torch", "jaxtyping",
                                  "lordfast_tpu_torch.ops", "numpy"]) == []
    assert run.forbidden_modules(["jax", "jaxlib.xla", "flax.nn",
                                  "lordfast_tpu.ops.x"]) == [
        "flax.nn", "jax", "jaxlib.xla", "lordfast_tpu.ops.x"]


def test_no_module_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "cache" in path.parts:
            continue
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = run.forbidden_modules(names)
            assert not bad, f"{path} imports {bad}"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["chr20.clr", "chr1_21_22.short"])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", "4000000001", "--seconds", "5",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
