"""Read bases of the window's jobs, in Mbp, over the window's seconds:
from its start to the end of its last job, counted whole."""


def read(rec):
    if rec["read_mbp"] <= 0 or rec["window_s"] <= 0:
        return None
    return rec["read_mbp"] / rec["window_s"]
