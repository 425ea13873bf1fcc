#!/usr/bin/env python3
"""Times lordfast_tpu_torch/csrc/myers.cu against another version of it
on one GPU.

    python3 tools/torch_myers_design.py [--against OTHER/myers.cu]

Builds this checkout's source and, with ``--against``, another version
of it with the same C entry points (for example the parent commit's),
one nvcc each, in parallel, into lordfast_tpu_torch/_build/design/.
Then, in every bucket of LordfastConfig().gap_buckets at full G, it
checks that every build's outputs equal the plain version's on the card
and times lf_myers_dist and lf_myers_moves of each build (CUDA events,
the mean of 5 launches queued behind a spin kernel, builds in turns
A B B A).  It prints one line per bucket and mode, and the card's name
and power limit.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build(out_dir: Path, against: Path | None) -> dict:
    from lordfast_tpu_torch.ops import cuda_build

    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"this": cuda_build.CSRC_DIR / "myers.cu"}
    if against is not None:
        jobs["against"] = against
    procs = {n: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
         str(out_dir / f"libmyers_{n}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, path in jobs.items()}
    libs = {}
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{log}")
        libs[n] = ctypes.CDLL(str(out_dir / f"libmyers_{n}.so"))
        vp = ctypes.c_void_p
        for fn, n_ptr in (("lf_myers_dist", 8), ("lf_myers_moves", 11)):
            f = getattr(libs[n], fn)
            f.restype = ctypes.c_int
            f.argtypes = [vp] * n_ptr + [ctypes.c_int] * 3 + [vp]
    return libs


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.ops import gap_dp

    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, default=None,
                    help="another myers.cu to build and time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(f"[design] {chip_smoke.nvidia_smi_line()}", flush=True)
    t = time.time()
    libs = build(ROOT / "lordfast_tpu_torch" / "_build" / "design",
                 args.against)
    print(f"[design] {len(libs)} builds in {time.time() - t:.1f} s",
          flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(20261019)
    for Q, T, G in LordfastConfig().gap_buckets:
        arrays = chip_smoke.make_gaps(rng, Q, T, G)
        gpu = [torch.from_numpy(a).cuda() for a in arrays]
        ptrs = [a.data_ptr() for a in gpu]
        want_d = gap_dp.myers_dist_plain(*gpu, Q, T, want_col=True)
        want_m = gap_dp.myers_moves_plain(*gpu, Q, T)

        def dist(lib):
            d, e = (torch.empty(G, dtype=torch.int32, device="cuda")
                    for _ in range(2))
            col = torch.empty((2, Q // 32, G), dtype=torch.int32,
                              device="cuda")
            rc = lib.lf_myers_dist(*ptrs, d.data_ptr(), e.data_ptr(),
                                   col.data_ptr(), G, Q, T, stream())
            if rc != 0:
                raise RuntimeError(f"lf_myers_dist: cudaError {rc}")
            return d, e, col

        def moves(lib):
            d, e, lead = (torch.empty(G, dtype=torch.int32, device="cuda")
                          for _ in range(3))
            cc = torch.empty((T, G), dtype=torch.int16, device="cuda")
            up, left = (torch.empty(((T + 32) * (Q // 32), G),
                                    dtype=torch.int32, device="cuda")
                        for _ in range(2))
            rc = lib.lf_myers_moves(*ptrs, d.data_ptr(), e.data_ptr(),
                                    lead.data_ptr(), cc.data_ptr(),
                                    up.data_ptr(), left.data_ptr(), G, Q, T,
                                    stream())
            if rc != 0:
                raise RuntimeError(f"lf_myers_moves: cudaError {rc}")
            return d, e, lead, cc

        for name, lib in libs.items():
            for got, want in ((dist(lib), want_d), (moves(lib), want_m)):
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} ({Q},{T},{G}) != plain")
        for kind, fn in (("dist", dist), ("moves", moves)):
            ms = {n: [] for n in libs}
            for n in [*libs, *reversed(list(libs))]:
                ms[n].append(
                    chip_smoke._time_launches(lambda: fn(libs[n]), 5))
            print(f"[design] myers_{kind} Q={Q} T={T} G={G}: " + " | ".join(
                f"{n} {min(v):.4f} ms ({' '.join(f'{x:.4f}' for x in v)})"
                for n, v in ms.items()), flush=True)
    print(f"[design] {chip_smoke.nvidia_smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
