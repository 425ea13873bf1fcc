"""Window compaction, window seed selection and dp-n2 chaining in the
PyTorch port (lordfast_tpu_torch/ops/chain.py) against the JAX package's,
on the seeds of noisy reads over the shared small_index.  Integer fields
must be equal exactly; chain scores (float64 DP, float32 output) to
rtol 1e-12 — the last bit of the float64 log may differ between XLA and
PyTorch, and no more than that."""

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
from lordfast_tpu_torch.ops import fm_index as tfm
from lordfast_tpu_torch.ops import voting as tvote

from test_torch_fm_index import _noisy_reads, port_index


def _eq(got, want, fields):
    for name in fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)


@pytest.fixture(scope="module")
def seeded(small_index):
    jidx, _ = small_index
    kw = dict(sampling_count=200, min_anchor_len=12, max_seeds_per_read=512,
              kmer_cache_k=jidx.kcache_k)
    reads, lens = _noisy_reads(np.random.default_rng(21), jidx, 6, 2500)
    seeds = jfm.seed_anchors(jidx.device_arrays(), jidx.meta, reads, lens,
                             JCfg(**kw))
    seeds_np = {k: np.asarray(v) for k, v in seeds._asdict().items()}
    return jidx, kw, reads, lens, seeds_np


@pytest.mark.parametrize("chain_cfg", [
    dict(),                                          # N=512, narrow 64
    dict(max_chain_seeds=64, chain_small_n=16, chain_big_windows=8),
    dict(max_chain_seeds=64, chain_small_n=16, chain_big_windows=1),
], ids=["default", "bucketed", "full_fallback"])
def test_compact_select_chain_match_jax(seeded, chain_cfg):
    jidx, kw, reads, lens, s = seeded
    jcfg, tcfg = JCfg(**kw, **chain_cfg), TCfg(**kw, **chain_cfg)
    js = jfm.SeedBatch(**{k: jnp.asarray(v) for k, v in s.items()})
    ts = tfm.SeedBatch(**{k: torch.from_numpy(np.array(v))
                          for k, v in s.items()})
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    jarrs = jidx.device_arrays()
    tarrs = port_index(jidx).device_arrays("cpu")

    jc = jvote.vote_windows(js, jl, jcfg)
    tc = tvote.vote_windows(ts, tl, tcfg)
    K = len(lens) * jcfg.compact_windows_per_read
    jcw = jchain.compact_candidates(jc, jcfg, K)
    tcw = tchain.compact_candidates(tc, tcfg, K)
    _eq(tcw, jcw, ("read_idx", "cand_idx", "win_id", "is_rev", "valid",
                   "n_needed"))
    assert np.asarray(jcw.valid).sum() >= len(lens) - 1

    jws = jchain.select_window_seeds(js, jcw, jl, jarrs, jcfg)
    tws = tchain.select_window_seeds(ts, tcw, tl, tarrs, tcfg)
    _eq(tws, jws, ("q_pos", "t_pos", "length", "valid", "n_in_range"))

    jch = jchain.chain_seeds(jws, jcfg)
    tch = tchain.chain_seeds(tws, tcfg)
    _eq(tch, jch, ("q_pos", "t_pos", "length", "chain_len"))
    assert np.asarray(jch.chain_len).max() > 5
    np.testing.assert_allclose(tch.score.numpy(), np.asarray(jch.score),
                               rtol=1e-12, atol=0)


def test_chain_clasp_not_ported(seeded):
    jidx, kw, reads, lens, s = seeded
    ws = tchain.WindowSeeds(*(torch.zeros((2, 8), dtype=torch.int32)
                              for _ in range(3)),
                            valid=torch.zeros((2, 8), dtype=torch.bool),
                            n_in_range=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        tchain.chain_seeds(ws, TCfg(chain_alg="clasp"))
