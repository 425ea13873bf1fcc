"""The port's own tracing: ``named_range`` opens a profiler range only while
a torch profiler records; under one, the engine opens an ``lf_<stage>``
range around each of its timed stages and accounts the host stitcher
(the stitch_* timers and counters, native/csrc/stitch_trace.cpp), and
with none it adds nothing of that; the SAM is the same either way.  A
one-argument wrapper of ``Metrics.timer``, as the benchmark's tracing
installs, still sees every stage."""

import ctypes
import io
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lordfast_tpu_torch import native
from lordfast_tpu_torch.align.chain_align import align_chain_native
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.io.fastx import read_chunks
from lordfast_tpu_torch.pipeline.engine import MappingEngine
from lordfast_tpu_torch.utils import metrics as metrics_mod

from test_golden import TEST_CFG
from test_torch_fm_index import port_index

DATA = Path(__file__).parent / "data"

# the engine's stage timers that held their names before the spans
STAGE_TIMERS = {"device", "py_select", "py_jobbuild", "gap_dp", "gap_pack",
                "gap_wait", "gap_unpack", "esc_dp", "esc_wait", "esc_affine",
                "stitch", "emit"}
# the stages timed since the spans, and the batch stitcher's two serial
# halves inside the stitch stage
NEW_STAGES = {"read_parse", "batch_pack", "device_fetch", "assemble",
              "stitch_pack", "stitch_decode"}
DEVICE_STAGE = {"lf_seed", "lf_vote", "lf_select", "lf_chain"}
STITCH_TIMERS = {"stitch_native", "stitch_rebuild", "stitch_local_dp",
                 "stitch_py", "stitch_wait"}
STITCH_COUNTERS = {"stitch_windows", "stitch_rebuilds",
                   "stitch_rebuild_fallback", "stitch_local_dps",
                   "stitch_local_cells", "stitch_overflow"}


def _names(prof, prefixes=("lf_", "pb_")) -> set:
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(prefixes)}


@contextmanager
def _recording():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _harness_timer(metrics, seen):
    """The benchmark's swap of Metrics.timer while it traces: a
    one-argument wrapper that opens a ``pb_<name>`` range around the
    original timer."""
    orig = metrics.timer

    @contextmanager
    def timer(name):
        seen.add(name)
        with torch.profiler.record_function(f"pb_{name}"):
            with orig(name):
                yield

    metrics.timer = timer


@pytest.fixture(scope="module")
def port_idx(ref8_idx):
    return port_index(ref8_idx)


@pytest.fixture(scope="module")
def runs(port_idx):
    """The golden fixture through map_file with the escalation offload on
    (so every stage runs): once under a CPU profiler with the harness's
    timer wrapper, once with neither.  The untraced run keeps the
    stitcher's inputs of every batch."""
    got = {}
    for traced in (True, False):
        eng = MappingEngine(port_idx, TCfg(**TEST_CFG), device="cpu",
                            esc_device=True)
        seen, windows = set(), []
        stitch_all = eng._stitch_all

        def keep(jobs, tables, esc_tables, stitch_all=stitch_all,
                 windows=windows):
            windows.append((jobs, tables, esc_tables))
            return stitch_all(jobs, tables, esc_tables)

        eng._stitch_all = keep
        out = io.StringIO()
        if traced:
            _harness_timer(eng.metrics, seen)
            with _recording() as prof:
                eng.map_file(DATA / "reads.fq", out, "test")
            names = _names(prof)
        else:
            eng.map_file(DATA / "reads.fq", out, "test")
            names = set()
        got[traced] = dict(sam=out.getvalue(), names=names, seen=seen,
                           timers=dict(eng.metrics.timers),
                           counters=dict(eng.metrics.counters),
                           windows=windows, engine=eng)
    return got


class _Recorder(torch.profiler.record_function):
    made = []

    def __init__(self, name, args=None):
        super().__init__(name, args)
        _Recorder.made.append((name, args))


def test_named_range_opens_a_range_only_while_a_profiler_records(
        monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Recorder)
    _Recorder.made.clear()
    cpu = torch.device("cpu")
    with metrics_mod.named_range("lf_idle", cpu, args=3):
        pass
    assert _Recorder.made == []
    with _recording() as prof:
        with metrics_mod.named_range("lf_busy", cpu, args=7):
            torch.ones(4).sum()
        with metrics_mod.named_range("lf_bare", cpu):
            pass
    assert _Recorder.made == [("lf_busy", "7"), ("lf_bare", None)]
    assert _names(prof) == {"lf_busy", "lf_bare"}


def test_every_stage_has_a_range_under_a_profiler(runs):
    r = runs[True]
    stages = STAGE_TIMERS | NEW_STAGES
    assert r["names"] == ({f"lf_{s}" for s in stages} | DEVICE_STAGE
                          | {f"pb_{s}" for s in stages})
    # every stage went through the one-argument timer; the stitch
    # accounting is summed outside it
    assert r["seen"] == stages
    assert set(r["timers"]) == stages | STITCH_TIMERS


def test_stitch_accounting_identities(runs):
    r = runs[True]
    t, c = r["timers"], r["counters"]
    assert set(c) >= STITCH_COUNTERS
    assert c["stitch_windows"] == sum(len(w[0]) for w in
                                      runs[False]["windows"]) > 0
    assert t["stitch_native"] >= t["stitch_rebuild"] + t["stitch_local_dp"]
    # py + native + wait is the stitcher threads' wall time over their
    # windows
    threads = r["engine"]._stitcher.n_threads
    assert t["stitch_py"] + t["stitch_native"] + t["stitch_wait"] <= \
        threads * t["stitch"]
    assert t["stitch_native"] > 0 and t["stitch_py"] > 0
    # the device measured every gap: each path is rebuilt, none falls
    # back, and with the offload on no window runs a DP of its own
    assert c["stitch_rebuilds"] > 0
    assert c["stitch_rebuild_fallback"] == 0
    assert c["stitch_overflow"] == 0
    assert c["stitch_local_dps"] == c["stitch_local_cells"] == 0


def test_untraced_run_adds_no_accounting_and_the_same_sam(runs):
    r = runs[False]
    assert not STITCH_TIMERS & set(r["timers"])
    assert not STITCH_COUNTERS & set(r["counters"])
    assert set(r["timers"]) == STAGE_TIMERS | NEW_STAGES
    assert r["sam"] == runs[True]["sam"]
    golden = [l.rstrip("\n") for l in open(DATA / "golden.sam")
              if not l.startswith("@")]
    assert [l for l in r["sam"].splitlines()
            if not l.startswith("@")] == golden


def test_host_seeder_stage_has_a_range(port_idx):
    reads = next(read_chunks(DATA / "reads.fq", 10**9))[:2]
    eng = MappingEngine(port_idx, TCfg(**TEST_CFG, seeder="extend-whole-3"),
                        device="cpu")
    with _recording() as prof:
        eng._map_chunk(reads, io.StringIO())
    assert "lf_host_seed" in _names(prof, ("lf_host_seed",))
    assert eng.metrics.timers["host_seed"] > 0


def _stitch_windows(runs, port_idx, with_tables: bool):
    """Every window of the golden fixture through align_chain_native, the
    ctypes call of the loader's stitch_chain, with the device's gap and
    escalation tables or without (every DP local)."""
    cfg = runs[False]["engine"].cfg
    out = []
    for jobs, tables, esc_tables in runs[False]["windows"]:
        for jid, job in enumerate(jobs):
            m = align_chain_native(
                job["cq"], job["ct"], job["cl"], job["query"],
                job["read_len"], job["is_rev"], port_idx, cfg,
                gap_table=tables.get(jid) if with_tables else None,
                esc_table=esc_tables.get(jid) if with_tables else None)
            out.append((m.total_score, m.records))
    return out


@pytest.mark.parametrize("with_tables", [True, False])
def test_timed_stitch_chain_gives_the_same_records(runs, port_idx,
                                                   with_tables):
    lib = native._load()
    timed = ctypes.cast(lib.lf_stitch_chain_timed, ctypes.c_void_p).value
    assert ctypes.cast(lib.stitch_chain, ctypes.c_void_p).value == timed
    n = sum(len(w[0]) for w in runs[False]["windows"])
    plain = _stitch_windows(runs, port_idx, with_tables)
    acc = np.zeros(len(native.TRACE_FIELDS), np.int64)
    native.trace_begin(acc)
    try:
        once = _stitch_windows(runs, port_idx, with_tables)
        first = dict(zip(native.TRACE_FIELDS, acc.tolist()))
        _stitch_windows(runs, port_idx, with_tables)
    finally:
        native.trace_end()
    twice = dict(zip(native.TRACE_FIELDS, acc.tolist()))
    _stitch_windows(runs, port_idx, with_tables)  # not counted
    assert once == plain and len(plain) == n
    assert first["windows"] == n and first["overflow"] == 0
    for k in ("windows", "rebuilds", "rebuild_fallback", "local_dps",
              "local_cells"):
        assert twice[k] == 2 * first[k], k
    assert twice == dict(zip(native.TRACE_FIELDS, acc.tolist()))
    assert first["native_ns"] >= first["rebuild_ns"] + first["local_dp_ns"]
    if with_tables:
        assert first["rebuilds"] > 0
    else:
        # every gap is a local nw_align / shw_best_end, whose own
        # tracebacks count inside it and not as rebuilds
        assert first["rebuilds"] == 0
        assert first["local_dps"] > 0 and first["local_cells"] > 0
        assert first["local_dp_ns"] > 0
