"""Each metric reader on a recorded, synthetic window record, and the
trace reduction on synthetic events."""

import json

import pytest
from conftest import BENCH, ROOT

from harness import loader, trace

REC = {
    "setup_s": 21.5, "window_s": 30.0, "read_mbp": 120.0, "jobs": 13,
    "timers": {"py_select": 0.6, "py_jobbuild": 3.0, "device": 1.2,
               "gap_dp": 6.0, "gap_wait": 0.048, "esc_dp": 1.8,
               "stitch": 15.6, "emit": 2.4},
    "counters": {},
    "trace": {"window_s": 30.0, "busy_s": 0.6, "kernel_s": 0.48,
              "n_kernels": 10, "device_ops": [], "idle_gaps": []},
}
EXPECTED = {
    "read_mbp_per_s": 4.0, "setup_s": 21.5,
    "select_ms_per_mbp": 30.0, "device_stage_ms_per_mbp": 10.0,
    "gap_dp_ms_per_mbp": 50.0, "gap_wait_ms_per_mbp": 0.4,
    "esc_dp_ms_per_mbp": 15.0, "stitch_ms_per_mbp": 130.0,
    "emit_ms_per_mbp": 20.0, "kernel_ms_per_mbp": 4.0,
    "device_idle_pct": 98.0,
}
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]


def test_every_metric_has_an_expected_value():
    assert sorted(NAMES) == sorted(EXPECTED)
    assert sorted(p.stem for p in (BENCH / "metrics").glob("*.py")) == \
        sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_record(name):
    read = loader.reader(name)
    assert read(REC) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(set(EXPECTED) - {"setup_s"}))
def test_reader_finds_nothing_in_an_empty_record(name):
    empty = {"setup_s": 1.0, "window_s": 30.0, "read_mbp": 0.0, "jobs": 0,
             "timers": {}, "counters": {}, "trace": None}
    assert loader.reader(name)(empty) is None


def test_trace_reduction():
    ms = 1_000_000
    ev = [
        ("range", "pb_window", 0, 100 * ms),
        ("range", "pb_job", 0, 90 * ms),
        ("range", "pb_stitch", 10 * ms, 40 * ms),
        ("range", "lf_seed", 50 * ms, 60 * ms),
        ("kernel", "k1", 52 * ms, 55 * ms),
        ("kernel", "k1", 54 * ms, 58 * ms),      # overlaps the first
        ("copy", "Memcpy DtoH", 60 * ms, 61 * ms),
        ("kernel", "k2", 95 * ms, 105 * ms),     # runs past the window
        ("kernel", "early", -10 * ms, -5 * ms),  # before it
        ("cpu", "aten::add", 1 * ms, 2 * ms),
    ]
    r = trace.reduce(ev)
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.006 + 0.001 + 0.005)
    assert r["kernel_s"] == pytest.approx(0.003 + 0.004 + 0.005)
    assert r["n_kernels"] == 3
    assert r["device_ops"][0][0] == "k1"
    idle = dict(r["idle_gaps"])
    # the gap 0-52 ms has its middle in pb_stitch, 58-60 ms in lf_seed,
    # 61-95 ms in pb_job alone
    assert idle == {"pb_stitch": pytest.approx(0.052),
                    "lf_seed": pytest.approx(0.002),
                    "pb_job": pytest.approx(0.034)}
    assert sum(idle.values()) == pytest.approx(0.1 - r["busy_s"])
    assert trace.reduce([("kernel", "k", 0, 1)]) is None


def test_trace_labels_the_innermost_range():
    ms = 1_000_000
    ev = [("range", "pb_window", 0, 100 * ms),
          ("range", "pb_job", 0, 100 * ms),
          ("range", "pb_stitch", 0, 100 * ms),
          ("kernel", "k", 0, 10 * ms), ("kernel", "k", 90 * ms, 100 * ms)]
    assert dict(trace.reduce(ev)["idle_gaps"]) == {
        "pb_stitch": pytest.approx(0.08)}
