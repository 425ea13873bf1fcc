"""Seconds from the process's start to the window's start: the index
made or loaded and put on the card, the kernels built or loaded, the
pool written, one warm-up job mapped."""


def read(rec):
    return rec["setup_s"]
