"""Reduction of the window's ``torch.profiler`` trace.

The traced run profiles the window with CPU and CUDA activity.  The
harness opens a ``pb_window`` range around the window and, inside it, a
``pb_<timer>`` range around each of the engine's timed stages (see
run.py); the device stage opens its own ``lf_*`` ranges.  From the
trace's events this takes:

- the kernels (every CUDA event that is not a copy, a memset or a
  range's mirror on the device) and the copies and memsets;
- ``busy_s``: the union of all of those intervals inside the window;
- ``kernel_s``: the kernels' summed durations inside the window;
- ``device_ops``: time by device operation name, most first;
- ``idle_gaps``: the device's idle time inside the window, by the range
  the host had open at each gap's middle (the innermost ``lf_*`` or
  ``pb_*`` range; ``pb_job``, a ``map_file`` call, when only that is
  open, as in host selection and job build; ``host`` when none).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

RANGE_PREFIXES = ("lf_", "pb_")
WINDOW = "pb_window"
JOB = "pb_job"


def _kind(e) -> str:
    """'kernel', 'copy', 'range' (a user range, on either side) or
    'cpu' for one kineto event."""
    name = e.name()
    at = ""
    try:
        at = str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        pass
    user = name.startswith(RANGE_PREFIXES) or "user_annotation" in at
    try:
        user = user or bool(e.is_user_annotation())
    except (AttributeError, RuntimeError):
        pass
    if "cuda" not in str(e.device_type()).lower():
        return "range" if user else "cpu"
    if user:
        return "range"
    if "memcpy" in at or "memset" in at or name.startswith(
            ("Memcpy", "Memset", "memcpy", "memset")):
        return "copy"
    return "kernel"


def events_of(prof) -> list:
    """(kind, name, start_ns, end_ns) of every event of a stopped
    torch.profiler.profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        s = int(e.start_ns())
        out.append((_kind(e), e.name(), s, s + int(e.duration_ns())))
    return out


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals of an (n, 2) array."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def reduce(events: list, top: int = 10) -> dict | None:
    """The window's device figures from events (events_of), or None
    when the trace has no window range."""
    win = [(s, e) for k, n, s, e in events if k == "range" and n == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]
    dev, kernel_ns, n_kernels = [], 0, 0
    by_op = defaultdict(int)
    ranges, jobs = [], []
    for kind, name, s, e in events:
        if kind in ("kernel", "copy"):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            dev.append((s, e))
            by_op[name] += e - s
            if kind == "kernel":
                kernel_ns += e - s
                n_kernels += 1
        elif kind == "range" and s < w1 and e > w0:
            if name == JOB:
                jobs.append((s, e))
            elif name != WINDOW:
                ranges.append((s, e, name))
    busy = _union(np.array(dev, np.int64).reshape(-1, 2))
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0
    # the idle gaps between the busy intervals, inside the window
    edges = np.concatenate(([w0], busy.reshape(-1), [w1]))
    gaps = edges.reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    idle = defaultdict(int)
    r = sorted(ranges)
    rs = np.array([x[0] for x in r], np.int64)
    js = sorted(jobs)
    jst = np.array([x[0] for x in js], np.int64)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "host"
        k = int(np.searchsorted(jst, mid, side="right"))
        if k and js[k - 1][1] > mid:
            label = JOB
        # the innermost open range: the latest start still open
        k = int(np.searchsorted(rs, mid, side="right"))
        for j in range(k - 1, max(k - 256, -1), -1):
            if r[j][1] > mid:
                label = r[j][2]
                break
        idle[label] += int(g1 - g0)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "n_kernels": n_kernels,
        "device_ops": [[n, v / 1e9] for n, v in sorted(
            by_op.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[n, v / 1e9] for n, v in sorted(
            idle.items(), key=lambda x: -x[1])[:top]],
    }
