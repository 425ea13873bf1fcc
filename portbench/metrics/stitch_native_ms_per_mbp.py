"""The host stitcher's time inside the native stitch_chain, summed over its
windows (the engine's stitch_native timer, CLOCK_MONOTONIC in the worker
that stitches each window), summed over the window's map_file calls, in ms
a read Mbp (engine timers, host clock).  None where the record has no such
timer: the stitch accounting runs only while a profiler records (the traced
run)."""

TIMERS = ("stitch_native",)


def read(rec):
    t = rec["timers"]
    if rec["read_mbp"] <= 0 or not any(k in t for k in TIMERS):
        return None
    return 1000.0 * sum(t.get(k, 0.0) for k in TIMERS) / rec["read_mbp"]
