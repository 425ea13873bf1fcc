"""The readers of the host stitcher's split and of the device stage's
fetch (the engine's stitch_* and device_fetch timers) on a recorded,
synthetic window record, and on records without those timers: an
untraced run, where the program adds no stitch accounting, and a program
that has none."""

import pytest

from harness import loader

REC = {
    "setup_s": 21.5, "window_s": 30.0, "read_mbp": 120.0, "jobs": 13,
    "timers": {"device": 1.2, "stitch": 15.6, "emit": 2.4,
               "stitch_native": 12.0, "stitch_py": 6.0, "stitch_wait": 24.0,
               "stitch_rebuild": 3.6, "stitch_local_dp": 1.2,
               "device_fetch": 0.6},
    "counters": {},
    "trace": None,
}
EXPECTED = {
    "stitch_native_ms_per_mbp": 100.0, "stitch_py_ms_per_mbp": 50.0,
    "stitch_wait_ms_per_mbp": 200.0, "stitch_rebuild_ms_per_mbp": 30.0,
    "stitch_local_dp_ms_per_mbp": 10.0, "device_fetch_ms_per_mbp": 5.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_record(name):
    assert loader.reader(name)(REC) == pytest.approx(EXPECTED[name],
                                                     rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_its_timer(name):
    untraced = dict(REC, timers={"device": 1.2, "stitch": 15.6,
                                 "emit": 2.4})
    assert loader.reader(name)(untraced) is None
    empty = dict(REC, read_mbp=0.0, timers={})
    assert loader.reader(name)(empty) is None
