"""The host stitcher's path rebuilds: time inside edlib_band_path called by
stitch_chain for gaps whose distance the card measured (the engine's
stitch_rebuild timer, a part of stitch_native), summed over the window's
map_file calls, in ms a read Mbp (engine timers, host clock).  None where
the record has no such timer: the stitch accounting runs only while a
profiler records (the traced run)."""

TIMERS = ("stitch_rebuild",)


def read(rec):
    t = rec["timers"]
    if rec["read_mbp"] <= 0 or not any(k in t for k in TIMERS):
        return None
    return 1000.0 * sum(t.get(k, 0.0) for k in TIMERS) / rec["read_mbp"]
