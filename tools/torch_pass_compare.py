#!/usr/bin/env python3
"""Warm passes of the port's engine over the bench's v1 or v2 dataset, on
one GPU, with the engine of a chosen checkout.  A measurement aid: the
smoke (chip_smoke.py) does not run it.

    python3 tools/torch_pass_compare.py [--root DIR] [--dataset v1|v2]
                                        [--passes N]

Imports ``lordfast_tpu_torch`` from ``--root`` (default: this checkout;
give an unpacked copy of another commit to compare the two in one call,
in turns A B B A), generates the dataset with ``bench.gen_dataset`` into
this checkout's ``.smoke_cache/`` (the same files as chip_smoke.py),
builds the index at the default config with the chosen checkout's
builder once and caches it there under a name keyed by that checkout's
path (so each side of a comparison loads its own builder's index), and
maps the reads with the default ``LordfastConfig()`` on cuda: one first
pass, then N warm passes.  Each pass ends in a device synchronise and
prints one JSON line: root, pass, seconds, reads/s and the engine's
stage timers (unsynchronised between stages).  The last line is the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--dataset", choices=("v1", "v2"), default="v2")
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke  # this checkout's, for its dataset cache

    sys.path.insert(0, str(root))
    import torch

    import lordfast_tpu_torch
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import (build_index, load_index,
                                                  save_index)
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    pkg = Path(lordfast_tpu_torch.__file__).resolve().parent
    if pkg.parent != root:
        raise RuntimeError(f"imported {pkg}, not from {root}")
    ref, reads = chip_smoke._dataset(easy=args.dataset == "v1")
    key = hashlib.sha1(str(root).encode()).hexdigest()[:12]
    cached = chip_smoke.CACHE / f"{args.dataset}_index_{key}.npz"
    if cached.exists():
        idx = load_index(cached)
    else:
        idx = build_index(ref, LordfastConfig(), verbose=False)
        save_index(idx, cached)
    eng = MappingEngine(idx, LordfastConfig(), device="cuda")
    for i in range(args.passes + 1):
        out = io.StringIO()
        n0 = eng.stats["reads"]
        t = time.time()
        eng.map_file(reads, out, "torch_pass_compare")
        torch.cuda.synchronize()
        dt = time.time() - t
        n = eng.stats["reads"] - n0
        print(json.dumps({
            "root": str(args.root), "dataset": args.dataset,
            "pass": "first" if i == 0 else f"warm {i}", "s": dt,
            "reads_per_s": n / dt,
            "timers": {k: round(v, 4)
                       for k, v in sorted(eng.metrics.timers.items())}}),
            flush=True)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
