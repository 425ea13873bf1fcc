#!/usr/bin/env python3
"""dp-n2's float64 near-ties on the bench's v2 dataset: the JAX package's
jitted ``chain_dpn2`` against the port's plain ``chain_dpn2``, on every
window the port's device stage chains for v2's reads, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_chain_ties.py [--cache DIR]

Generates v2 with ``bench.gen_dataset(easy=False)`` (numpy only) into
DIR (default ``.smoke_cache/``, the smoke's files), builds the port's
index at the default config, and runs the port's device stage
(``device_stage.device_pipeline``, plain PyTorch on the CPU) over the
reads in length-sorted batches of ``batch_reads``, recording the windows
each batch chains.  The windows with a seed then go through JAX's
``chain_dpn2`` under ``jax.jit`` (XLA on the CPU; XLA may contract
``dp + reward - pen`` into fused multiply-adds and rounds its log its
own way) and through the port's ``chain_dpn2`` (one rounded op at a
time, torch's log).  Prints how many float64 dp values differ in their
bits, and how many take flags (best > the seed's length), predecessors
(the largest j among ties), best ends (the smallest i among ties) and
chains differ; for each differing decision, the window, the seed and
the values on both sides beside the reference's C arithmetic (Python
floats: one rounding an operation, libm's log), so the case shows which
side lordFAST's double dp[] takes.  The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def windows_of_v2(cache: Path):
    """(q, t, len, valid) numpy arrays of every window with a seed that
    the port's device stage chains for v2's reads, and the config."""
    import numpy as np
    import torch

    import bench
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import build_index
    from lordfast_tpu_torch.io.fastx import read_chunks
    from lordfast_tpu_torch.ops import chain, fm_index
    from lordfast_tpu_torch.pipeline import device_stage
    from lordfast_tpu_torch.utils.pack import seq_to_codes

    cache.mkdir(exist_ok=True)
    ref, reads_fq = cache / "bench_ref.fa", cache / "bench_reads.fq"
    if not (ref.exists() and reads_fq.exists()):
        bench.gen_dataset(cache, easy=False)
    cfg = LordfastConfig().validate()
    t = time.time()
    idx = build_index(ref, cfg, verbose=False)
    print(f"[ties] index built in {time.time() - t:.1f} s (l_pac "
          f"{idx.l_pac})", flush=True)
    arrs = idx.device_arrays("cpu")
    fn = device_stage.device_pipeline(idx.meta, cfg)
    reads = sorted((r for c in read_chunks(reads_fq, 10**12) for r in c
                    if cfg.min_read_len <= len(r.seq) <= cfg.seq_max_length),
                   key=lambda r: len(r.seq))
    seen = []
    orig = chain.chain_seeds
    chain.chain_seeds = lambda ws, c, plain=False: seen.append(ws) or orig(
        ws, c, plain)
    try:
        B = cfg.batch_reads
        for b0 in range(0, len(reads), B):
            batch = reads[b0 : b0 + B]
            L = 1024
            while L < max(len(r.seq) for r in batch):
                L *= 2
            arr = np.full((B, L), 4, np.uint8)
            lens = np.zeros(B, np.int32)
            for j, r in enumerate(batch):
                arr[j, : len(r.seq)] = seq_to_codes(r.seq)
                lens[j] = len(r.seq)
            pos = fm_index.sample_positions_host(lens, cfg.sampling_count)
            t = time.time()
            fn(arrs, torch.from_numpy(arr), torch.from_numpy(lens),
               torch.from_numpy(pos))
            print(f"[ties] batch {b0 // B}: {len(batch)} reads, device "
                  f"stage {time.time() - t:.1f} s on the CPU", flush=True)
    finally:
        chain.chain_seeds = orig
    out = []
    for ws in seen:
        live = ws.valid.any(-1).numpy()
        out.append([x.numpy()[live] for x in ws[:4]])
    return [np.concatenate(a) for a in zip(*out)], cfg, len(reads)


def c_dp(q, t, ln, ok, cfg):
    """The reference's arithmetic for one window (src/Chain.cpp:232-310):
    Python floats, one rounding an operation, libm's log; returns dp."""
    n = int(ok.sum())
    dp = [0.0] * n
    reward = cfg.chain_reward * cfg.min_anchor_len
    for i in range(n):
        best = float(ln[i])
        for j in range(i - 1, -1, -1):
            dr = int(q[i]) - (int(q[j]) + int(ln[j]) - 1)
            dt = int(t[i]) - (int(t[j]) + int(ln[j]) - 1)
            if dr <= 0 or dt <= 0:
                continue
            d = abs(dr - dt)
            pen = 0.0 if d <= 1 else 0.1 * d + cfg.chain_penalty * math.log(d)
            val = dp[j] + reward - pen
            if val > best:
                best = val
        dp[i] = best
    return dp


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from lordfast_tpu.config import LordfastConfig as JCfg
    from lordfast_tpu.ops import chain as jchain
    from lordfast_tpu_torch.ops import chain

    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", type=Path, default=HERE / ".smoke_cache")
    args = ap.parse_args()
    (q, t, ln, ok), cfg, n_reads = windows_of_v2(args.cache)

    # chain_dpn2 returns (chains, dp, prev) while _finish_chains does
    orig_finish = jchain._finish_chains
    jchain._finish_chains = lambda ws, dp, prev, *rest: (
        orig_finish(ws, dp, prev, *rest), dp, prev)
    try:
        jws = jchain.WindowSeeds(jnp.asarray(q), jnp.asarray(t),
                                 jnp.asarray(ln), jnp.asarray(ok),
                                 jnp.asarray(ok.sum(-1)))
        jcfg = JCfg().validate()
        jout, jdp, jprev = jax.device_get(
            jax.jit(lambda w: jchain.chain_dpn2(w, jcfg))(jws))
    finally:
        jchain._finish_chains = orig_finish
    tws = chain.WindowSeeds(*(torch.from_numpy(np.ascontiguousarray(x))
                              for x in (q, t, ln, ok, ok.sum(-1))))
    tout, tdp, tprev = chain.chain_dpn2(tws, cfg, return_dp=True)
    tdp, tprev = tdp.numpy(), tprev.numpy()
    jdp, jprev = np.asarray(jdp), np.asarray(jprev).astype(np.int64)

    bits = int((jdp.view(np.int64) != tdp.view(np.int64))[ok].sum())
    take = int(((tprev >= 0) != (jprev >= 0))[ok].sum())
    pred = int((tprev != jprev)[ok].sum())
    best_end = lambda dp: np.argmax(dp == dp.max(1, keepdims=True), 1)
    ends = int((best_end(tdp) != best_end(jdp)).sum())
    chains = int(sum(
        (np.asarray(getattr(jout, f)) != getattr(tout, f).numpy()).any(-1)
        .sum() if f != "chain_len" else
        (np.asarray(jout.chain_len) != tout.chain_len.numpy()).sum()
        for f in ("q_pos", "t_pos", "length", "chain_len")))
    print(f"[ties] v2: {n_reads} reads, {len(q)} windows with a seed, "
          f"{int(ok.sum())} seeds; dp values whose float64 bits differ "
          f"(JAX jit vs the port): {bits}; decisions that differ: take "
          f"{take}, predecessor {pred}, best end {ends}; chain fields "
          f"that differ: {chains}", flush=True)
    cases = []
    for w, i in zip(*np.nonzero((tprev != jprev) & ok)):
        ref = c_dp(q[w], t[w], ln[w], ok[w], cfg)
        cases.append(dict(window=int(w), seed=int(i),
                          jax_prev=int(jprev[w, i]),
                          port_prev=int(tprev[w, i]),
                          jax_dp=float(jdp[w, i]), port_dp=float(tdp[w, i]),
                          c_dp=ref[i]))
        print(f"[ties] case {cases[-1]}", flush=True)
    print(json.dumps({"windows": int(len(q)), "seeds": int(ok.sum()),
                      "dp_bits_differ": bits, "take_differ": take,
                      "prev_differ": pred, "best_end_differ": ends,
                      "chains_differ": chains, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
