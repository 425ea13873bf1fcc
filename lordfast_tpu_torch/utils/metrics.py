"""Structured per-stage metrics and profiling.

The reference's observability is compile-time VERBOSITY log macros
(src/Common.h:33-49, Makefile:3-8) plus wall/CPU timers around the
load/chunk/map phases (src/Common.cpp:101-114, src/baseFAST.cpp:49-81).
The TPU build replaces both with runtime-structured counters (SURVEY.md
§5.5): per-stage wall timers, per-batch device scalars (seeds found,
candidate windows, fine-mode reads) reduced on device and fetched with the
batch's host payload, and per-chunk host counters (splits, inversions,
clip escalations).  ``torch.profiler`` tracing wraps the whole mapping
run when enabled (``--profile DIR``); the engine's stages and the device
stage's steps run inside named ranges (``named_range``: a profiler range
while a profiler records, and an NVTX range on a CUDA device).
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Metrics:
    verbosity: int = 0
    counters: dict = field(default_factory=lambda: defaultdict(int))
    timers: dict = field(default_factory=lambda: defaultdict(float))
    _snap_c: dict = field(default_factory=dict)
    _snap_t: dict = field(default_factory=dict)

    def add(self, name: str, n: int = 1) -> None:
        self.counters[name] += int(n)

    @contextmanager
    def timer(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.timers[name] += time.time() - t0

    def reset(self) -> None:
        """Fresh counters/timers (engine calls this per map_file run so
        warmup/compile passes do not leak into timed passes)."""
        self.counters.clear()
        self.timers.clear()
        self._snap_c.clear()
        self._snap_t.clear()

    def snapshot(self) -> None:
        """Record current values; chunk_line reports deltas since here."""
        self._snap_c = dict(self.counters)
        self._snap_t = dict(self.timers)

    def log(self, level: int, msg: str) -> None:
        """LOG1/LOG2/LOG3 equivalent (src/Common.h:33-49), gated at
        runtime instead of compile time."""
        if self.verbosity >= level:
            print(msg, file=sys.stderr, flush=True)

    def chunk_line(self, chunk_id: int, n_reads: int, dt: float) -> str:
        c = {k: v - self._snap_c.get(k, 0) for k, v in self.counters.items()}
        t = {k: v - self._snap_t.get(k, 0.0) for k, v in self.timers.items()}
        c = defaultdict(int, c)
        t = defaultdict(float, t)
        return (
            f"[chunk {chunk_id}] {n_reads} reads in {dt:.2f}s | "
            f"seeds {c['seeds']} cands {c['candidates']} "
            f"fine {c['fine_reads']} chains {c['chained_windows']} | "
            f"splits {c['splits']} inversions {c['inversions']} | "
            f"device {t['device']:.2f}s gap_dp {t['gap_dp']:.2f}s "
            f"(pack {t['gap_pack']:.2f} wait {t['gap_wait']:.2f} "
            f"unpack {t['gap_unpack']:.2f}) "
            f"py {t['py_select'] + t['py_jobbuild']:.2f}s "
            f"stitch {t['stitch']:.2f}s emit {t['emit']:.2f}s"
        )

    def to_json(self) -> str:
        return json.dumps(
            {"counters": dict(self.counters),
             "timers": {k: round(v, 4) for k, v in self.timers.items()}}
        )



@contextmanager
def named_range(name: str, device, args=None):
    """A ``torch.profiler`` range named ``name`` (a user annotation in a
    trace) with ``args`` (str() of it, e.g. a batch id) as the range's
    arguments, opened only while a torch profiler records; and an NVTX
    range of the same name when ``device`` is a CUDA device (a CPU build
    of torch has no NVTX).  With no profiler recording and on the CPU it
    costs one flag check."""
    import torch

    if torch.autograd.profiler._is_profiler_enabled:
        rec = torch.profiler.record_function(
            name, None if args is None else str(args))
    else:
        from contextlib import nullcontext

        rec = nullcontext()
    with rec:
        if device.type == "cuda":
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextmanager
def profiler_trace(trace_dir: str | None, device):
    """``torch.profiler`` trace around the mapping run, written as a
    Chrome trace ``lordfast_<pid>.pt.trace.json`` into trace_dir (made if
    missing); CPU activity always, CUDA activity when ``device`` is a
    CUDA device.  A no-op when trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"lordfast_{os.getpid()}.pt.trace.json"))
