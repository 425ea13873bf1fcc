"""The batch stitcher (pipeline/stitch_batch.py, native/csrc/stitch_batch.cpp)
against the per-window one: every window of the golden fixture, and
windows at the genome's ends and across a contig boundary, give the records
``align_chain_native`` gives, at 1, 8 and 32 native threads, with the
device's gap and escalation tables and without; the call's record layout
is held to the Python one field by field; a window that overflows the
call's capacity is stitched by the Python stitcher and counted in
stitch_overflow."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lordfast_tpu_torch import native
from lordfast_tpu_torch.align.chain_align import (align_chain_edlib,
                                                   align_chain_native,
                                                   score_mapping)
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.pipeline.engine import MappingEngine
from lordfast_tpu_torch.pipeline.stitch_batch import (RECORD, BatchStitcher,
                                                     check_record)

from test_golden import TEST_CFG
from test_torch_fm_index import port_index

DATA = Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def port_idx(ref8_idx):
    return port_index(ref8_idx)


@pytest.fixture(scope="module")
def golden(port_idx):
    """The golden fixture through map_file with the escalation offload on,
    keeping the stitcher's inputs of every batch."""
    eng = MappingEngine(port_idx, TCfg(**TEST_CFG), device="cpu",
                        esc_device=True)
    windows = []
    stitch_all = eng._stitch_all

    def keep(jobs, tables, esc_tables):
        windows.append((jobs, tables, esc_tables))
        return stitch_all(jobs, tables, esc_tables)

    eng._stitch_all = keep
    out = io.StringIO()
    eng.map_file(DATA / "reads.fq", out, "test")
    return dict(engine=eng, windows=windows, sam=out.getvalue(),
                counters=dict(eng.metrics.counters))


def _per_window(jobs, tables, esc_tables, idx, cfg):
    return [align_chain_native(
        j["cq"], j["ct"], j["cl"], j["query"], j["read_len"], j["is_rev"],
        idx, cfg, gap_table=tables.get(jid), esc_table=esc_tables.get(jid))
        for jid, j in enumerate(jobs)]


def _n_windows(golden):
    return sum(len(w[0]) for w in golden["windows"])


@pytest.mark.parametrize("with_tables", [True, False])
@pytest.mark.parametrize("threads", [1, 8, 32])
def test_batch_equals_per_window(golden, port_idx, threads, with_tables):
    cfg = golden["engine"].cfg
    st = BatchStitcher(port_idx, cfg, threads)
    n = 0
    for jobs, tables, esc_tables in golden["windows"]:
        if not with_tables:
            tables, esc_tables = {}, {}
        got = st.stitch(jobs, tables, esc_tables)
        want = _per_window(jobs, tables, esc_tables, port_idx, cfg)
        assert got == want
        n += len(jobs)
    assert n == _n_windows(golden) > 0


def test_untraced_run_counts_the_batch_calls(golden):
    c = golden["counters"]
    assert c["stitch_batched"] == _n_windows(golden)
    assert c["stitch_batch_calls"] == sum(1 for w in golden["windows"]
                                          if w[0])
    golden_sam = [l.rstrip("\n") for l in open(DATA / "golden.sam")
                  if not l.startswith("@")]
    assert [l for l in golden["sam"].splitlines()
            if not l.startswith("@")] == golden_sam


def _record(names, itemsize):
    """RECORD's formats and offsets, under names, of itemsize bytes."""
    return np.dtype({"names": names,
                     "formats": [RECORD.fields[n][0] for n in RECORD.names],
                     "offsets": [RECORD.fields[n][1] for n in RECORD.names],
                     "itemsize": itemsize})


def test_record_layout_is_checked_field_by_field():
    """stitch_batch.cpp's record against RECORD (chain_align's
    _StitchRecordC): equal here; two int64 fields swapped, or a record
    of another size, is refused."""
    check_record(RECORD)
    names = list(RECORD.names)
    i, j = names.index("cigar_len"), names.index("md_off")
    names[i], names[j] = names[j], names[i]
    with pytest.raises(RuntimeError):
        check_record(_record(names, RECORD.itemsize))
    with pytest.raises(RuntimeError):
        check_record(_record(list(RECORD.names), RECORD.itemsize + 8))


def _edge_window(idx, rng, start, length, is_rev):
    """A read drawn from [start, start + length) of the genome (zeros past
    its ends), ~8% of its bases changed outside three exact seeds."""
    ref = idx.get_ref_codes(start, length)
    q = ref.copy()
    flip = rng.random(length) < 0.08
    q[flip] = (q[flip] + rng.integers(1, 4, flip.sum())) % 4
    seeds = [(40, 24), (length // 2 - 12, 24), (length - 64, 24)]
    for qs, ln in seeds:
        q[qs:qs + ln] = ref[qs:qs + ln]
    return {"cq": np.array([s for s, _ in seeds], np.int64),
            "ct": np.array([start + s for s, _ in seeds], np.int64),
            "cl": np.array([ln for _, ln in seeds], np.int64),
            "query": q.astype(np.uint8), "read_len": length,
            "is_rev": is_rev}


@pytest.mark.parametrize("threads", [1, 8])
def test_edge_windows_equal_per_window(golden, port_idx, threads):
    """Slices that run below 0 and past l_pac, and chains across the
    boundary between the two contigs (both sides of the midpoint)."""
    idx, cfg = port_idx, golden["engine"].cfg
    assert len(idx.contig_offsets) >= 2
    b = int(idx.contig_offsets[1])
    rng = np.random.default_rng(7)
    starts = [(0, 600), (3, 900), (idx.l_pac - 600, 600),
              (idx.l_pac - 1500, 1500), (b - 300, 600), (b - 500, 600),
              (b - 100, 600)]
    jobs = [_edge_window(idx, rng, s, ln, rev) for s, ln in starts
            for rev in (False, True)]
    st = BatchStitcher(idx, cfg, threads)
    assert st.stitch(jobs, {}, {}) == _per_window(jobs, {}, {}, idx, cfg)


def _traced_stitch_all(eng, windows):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        return [eng._stitch_all(*w) for w in windows]
    finally:
        prof.stop()


def _python_stitcher(job, idx, cfg):
    m = align_chain_edlib(job["cq"], job["ct"], job["cl"], job["query"],
                          job["read_len"], job["is_rev"], idx, cfg)
    score_mapping(m, job["read_len"], job["is_rev"], cfg)
    return m


@pytest.mark.parametrize("str_cap", [0, 400, 1000])
def test_overflow_falls_back_and_is_counted(golden, port_idx, str_cap):
    """A capacity of 400 or 1,000 string bytes a window overflows some of
    golden's windows: each is stitched by the Python stitcher, to its
    records and the per-window native stitcher's, and counted in
    stitch_overflow; stitch_batched + stitch_overflow is every window
    under a profiler."""
    eng = MappingEngine(port_idx, golden["engine"].cfg, device="cpu")
    eng._stitcher = BatchStitcher(port_idx, eng.cfg, 8, str_cap=str_cap)
    windows = golden["windows"]
    n = _n_windows(golden)
    over = [[m is None for m in eng._stitcher.stitch(*w)] for w in windows]
    got = _traced_stitch_all(eng, windows)
    for (jobs, tables, esc_tables), ms, ov in zip(windows, got, over):
        assert ms == _per_window(jobs, tables, esc_tables, port_idx, eng.cfg)
        for job, m, o in zip(jobs, ms, ov):
            if o:
                assert m == _python_stitcher(job, port_idx, eng.cfg)
    overflowed = sum(map(sum, over))
    c = eng.metrics.counters
    assert c["stitch_overflow"] == overflowed
    assert c["stitch_batched"] + c["stitch_overflow"] == \
        c["stitch_windows"] == n
    assert c["stitch_batch_calls"] == sum(1 for w in windows if w[0])
    if str_cap:
        assert 0 < overflowed < n
    else:
        assert overflowed == 0


def test_accounting_rows(golden, port_idx):
    """Each window's row: one stitch_chain call, its wall time in its
    thread at least the time inside stitch_chain, and the thread's CPU
    time outside it."""
    st = BatchStitcher(port_idx, golden["engine"].cfg, 8)
    F = len(native.TRACE_FIELDS)
    for w in golden["windows"]:
        acc = np.zeros((len(w[0]), F + 2), np.int64)
        st.stitch(*w, acc=acc)
        f = dict(zip(native.TRACE_FIELDS, acc[:, :F].T))
        assert (f["windows"] == 1).all() and (f["overflow"] == 0).all()
        assert (f["native_ns"] > 0).all()
        assert (acc[:, F] >= f["native_ns"]).all()
        assert (acc[:, F + 1] >= 0).all()
        with pytest.raises(ValueError):
            st.stitch(*w, acc=np.zeros((len(w[0]), F), np.int64))
    assert st.stitch([], {}, {}) == []


def test_spans_around_the_serial_halves(golden, port_idx):
    st = BatchStitcher(port_idx, golden["engine"].cfg, 2)
    seen = []

    class Span:
        def __init__(self, name):
            seen.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    st.stitch(*golden["windows"][0], span=Span)
    assert seen == ["stitch_pack", "stitch_decode"]
    assert not torch.autograd.profiler._is_profiler_enabled
