"""dp-n2's float64 near-ties: the JAX package's jitted chain_dpn2 against
the port's chain_dpn2 on every chaining window of the golden fixture's
batch (tests/data, the golden test's config, the k=8 index).

XLA may contract ``dp + reward - pen`` and ``0.1 d + c log d`` into fused
multiply-adds under jit and rounds its log differently from torch's, so
the float64 dp values may differ in their last bits.  What must not
differ are the integer decisions those values feed: each seed's take
flag (best > its own length), its predecessor (the largest j among score
ties), each window's best end (the smallest i among ties) and the chains.
The test asserts those exactly and reports how many dp values differ in
their float64 bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.ops import chain as jchain
from lordfast_tpu.ops import fm_index as jfm
from lordfast_tpu.ops import voting as jvote
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.ops import chain as tchain

from test_golden import TEST_CFG
from test_torch_engine import _first_batch


def _capture(monkeypatch, module):
    """Make module.chain_dpn2 return (chains, dp, prev)."""
    orig = module._finish_chains

    def finish(ws, dp, prev, *rest):
        return orig(ws, dp, prev, *rest), dp, prev

    monkeypatch.setattr(module, "_finish_chains", finish)


def _best_end(dp):
    """The best chain end: the smallest index among the top score."""
    return np.argmax(dp == dp.max(axis=1, keepdims=True), axis=1)


def test_dpn2_decisions_equal_jax_on_golden(ref8_idx, monkeypatch, capsys,
                                            record_property):
    cfg = JCfg(**TEST_CFG).validate()
    arr, lens = _first_batch(cfg)
    seeds = jfm.seed_anchors(ref8_idx.device_arrays(), ref8_idx.meta, arr,
                             lens, cfg)
    jl = jnp.asarray(lens)
    cands = jvote.vote_windows(seeds, jl, cfg)
    cw = jchain.compact_candidates(cands, cfg,
                                   arr.shape[0] * cfg.compact_windows_per_read)
    ws = jchain.select_window_seeds(seeds, cw, jl, ref8_idx.device_arrays(),
                                    cfg)
    live = np.asarray(ws.valid).any(axis=1)
    ws = jchain.WindowSeeds(*(np.asarray(x)[live] for x in ws[:4]),
                            np.asarray(ws.n_in_range)[live])

    _capture(monkeypatch, jchain)
    _capture(monkeypatch, tchain)
    jout, jdp, jprev = jax.device_get(
        jax.jit(lambda w: jchain.chain_dpn2(w, cfg))(
            jchain.WindowSeeds(*(jnp.asarray(x) for x in ws))))
    tws = tchain.WindowSeeds(*(torch.from_numpy(np.ascontiguousarray(x))
                               for x in ws))
    tout, tdp, tprev = tchain.chain_dpn2(tws, TCfg(**TEST_CFG).validate())
    tdp, tprev = tdp.numpy(), tprev.numpy()

    ok = ws.valid
    n_seeds, n_windows = int(ok.sum()), int(live.sum())
    assert n_windows > 50 and n_seeds > 1000
    bits_differ = int((jdp.view(np.int64) != tdp.view(np.int64))[ok].sum())
    with capsys.disabled():
        print(f"\n[dp-n2 ties] golden: {n_windows} windows, {n_seeds} "
              f"seeds; dp values whose float64 bits differ (JAX jit vs "
              f"torch): {bits_differ}")
    record_property("dp_bits_differ", bits_differ)
    record_property("dp_values", n_seeds)

    np.testing.assert_array_equal(tprev[ok] >= 0, jprev[ok] >= 0,
                                  err_msg="take")
    np.testing.assert_array_equal(tprev[ok], jprev[ok], err_msg="prev")
    np.testing.assert_array_equal(_best_end(tdp), _best_end(jdp),
                                  err_msg="best end")
    for name in ("q_pos", "t_pos", "length", "chain_len"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tout.score.numpy(), np.asarray(jout.score),
                                  err_msg="score")
