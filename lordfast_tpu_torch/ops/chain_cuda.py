"""The hand-written CUDA chaining kernel and its wrapper.

``chain_dp`` runs the chaining DP of every window of a batch (dp-n2 or
clasp, by cfg.chain_alg) and its backtrack in one launch of
``csrc/chain_dp.cu``, built for sm_90a: one warp per window, looping to
the window's own seed count in tiles of 32 seeds, one shuffle broadcast a
seed, with dp and prev in shared memory, and dp-n2's log(max(d, 2)) from
the plain version's own table (``chain.log_table``: the C library's log,
made on the host, one copy a device), which covers every d a window can
link.  On a CUDA tensor it launches the kernel and raises if the launch
fails (a linked pair whose d lies past the table stops the kernel with a
trap, which the next synchronize raises, as the plain version's table
index raises); on a CPU tensor it runs the plain version (``chain.chain_dpn2`` /
``chain.chain_clasp_sop`` at full width).  There is no fallback from the
first to the second.

The kernel replaces the JAX package's device loops
``lordfast_tpu/ops/chain.py`` ``chain_dpn2`` (:312, ``lax.scan`` :350),
``chain_clasp_sop`` (:355, :409) and ``_finish_chains`` (:188,
``lax.while_loop`` :213); see the source for its design and what bounds
it.  Build: ``cuda_build`` (nvcc at first use, ctypes).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .chain import (ChainBatch, _dp_dtype, dp_function, log_table,
                    log_table_len)
from .cuda_build import check_tensor

# widest window the kernel takes: its shared memory holds 33 bytes a slot
# (135 KB of a block's 227 KB at 4096, one window a block)
MAX_N = 4096


def _fn():
    f = cuda_build.load("chain_dp").lf_chain_dp
    if f.argtypes is None:
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        f.restype = ci
        f.argtypes = [vp] * 12 + [ci] * 6 + [cd] * 4 + [vp]
    return f


def chain_dp(ws, cfg, want_dp: bool = False):
    """Chains of every window of ``ws`` (chain.WindowSeeds, (..., N)
    slots, valid seeds in each window's first slots, as
    select_window_seeds gives them): a ChainBatch, and with ``want_dp``
    (chains, dp, prev), dp (W, N) in the cfg's DP dtype and prev (W, N)
    int64, W the windows.  CUDA tensors launch the kernel on the current
    stream (counted in ``chain_dp.launches``); CPU tensors run the plain
    version."""
    if ws.q_pos.device.type == "cpu":
        return dp_function(cfg)(ws, cfg, return_dp=want_dp)
    from ..config import ChainAlg

    dev = ws.q_pos.device
    if dev.type != "cuda":
        raise ValueError(f"chain_dp: unsupported device {dev}")
    lead = tuple(ws.q_pos.shape[:-1])
    N = ws.q_pos.shape[-1]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"chain_dp: N={N} outside [1, {MAX_N}]")
    W = 1
    for d in lead:
        W *= d
    pdt = ws.t_pos.dtype
    if pdt not in (torch.int32, torch.int64):
        raise TypeError(f"chain_dp: t_pos dtype {pdt}, expected int32 or "
                        "int64")
    q, t, ln, ok = (x.reshape(W, N) for x in ws[:4])
    check_tensor("q_pos", q, torch.int32, (W, N), dev)
    check_tensor("t_pos", t, pdt, (W, N), dev)
    check_tensor("length", ln, torch.int32, (W, N), dev)
    check_tensor("valid", ok, torch.bool, (W, N), dev)
    fdt = _dp_dtype(cfg)
    out_q = torch.empty((W, N), dtype=torch.int32, device=dev)
    out_t = torch.empty((W, N), dtype=pdt, device=dev)
    out_len = torch.empty((W, N), dtype=torch.int32, device=dev)
    chain_len = torch.empty(W, dtype=torch.int32, device=dev)
    score = torch.empty(W, dtype=torch.float32, device=dev)
    dp = torch.empty((W, N), dtype=fdt, device=dev) if want_dp else None
    prev = (torch.empty((W, N), dtype=torch.int64, device=dev)
            if want_dp else None)
    if W:
        clasp = cfg.chain_alg == ChainAlg.CLASP
        table = (None if clasp
                 else log_table(log_table_len(cfg), dev, fdt))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _fn()(
                q.data_ptr(), t.data_ptr(), ln.data_ptr(), ok.data_ptr(),
                out_q.data_ptr(), out_t.data_ptr(), out_len.data_ptr(),
                chain_len.data_ptr(), score.data_ptr(),
                dp.data_ptr() if want_dp else None,
                prev.data_ptr() if want_dp else None,
                table.data_ptr() if table is not None else None,
                table.shape[0] if table is not None else 0, W, N, t.element_size(), int(fdt == torch.float64),
                int(clasp), float(cfg.chain_reward * cfg.min_anchor_len),
                float(cfg.chain_penalty), float(cfg.clasp_lambda),
                float(cfg.clasp_epsilon), stream)
        if rc != 0:
            raise RuntimeError(f"chain_dp: kernel launch failed (cudaError "
                               f"{rc})")
        chain_dp.launches += 1
    out = ChainBatch(
        q_pos=out_q.reshape(*lead, N), t_pos=out_t.reshape(*lead, N),
        length=out_len.reshape(*lead, N), chain_len=chain_len.reshape(lead),
        score=score.reshape(lead))
    return (out, dp, prev) if want_dp else out


chain_dp.launches = 0
