"""clasp sum-of-pairs chaining (``-a clasp``) in the PyTorch port against
the JAX package's ``chain_clasp_sop`` and the literal oracle of
tests/test_vote_chain.py, on random windows, through both routes of
``_chain_bucketed``, and end to end on the golden fixture.  Chains and
chain lengths must be equal exactly, and so must the scores: the DP is
float64 with the same operations in the same order as the JAX version
(no transcendental, unlike dp-n2's log), cast to float32."""

import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.ops import chain as jchain
from lordfast_tpu.pipeline.engine import MappingEngine as JEngine
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.ops import chain as tchain
from lordfast_tpu_torch.pipeline.engine import MappingEngine

from test_golden import TEST_CFG
from test_torch_fm_index import port_index
from test_vote_chain import oracle_clasp_sop

DATA = Path(__file__).parent / "data"

torch.set_num_threads(2)


def _windows(rng, W, N, counts):
    """W windows of N slots, window w holding counts[w] seeds sorted by
    (qPos, tPos) in its first slots, near a diagonal with indels, some
    overlapping and some tied."""
    q = np.zeros((W, N), np.int32)
    t = np.zeros((W, N), np.int64)
    ln = np.zeros((W, N), np.int32)
    va = np.zeros((W, N), bool)
    seeds = []
    for w in range(W):
        base_t = int(rng.integers(0, 50_000))
        s = []
        for _ in range(counts[w]):
            qp = int(rng.integers(0, 3000))
            tp = max(base_t + qp + int(rng.integers(-150, 150)), 0)
            s.append((qp, tp, int(rng.integers(14, 60))))
        s.sort()
        seeds.append(s)
        for i, (qp, tp, m) in enumerate(s):
            q[w, i], t[w, i], ln[w, i], va[w, i] = qp, tp, m, True
    return (q, t, ln, va), seeds


def _both(arrays):
    q, t, ln, va = arrays
    n = va.sum(-1).astype(np.int32)
    jws = jchain.WindowSeeds(q_pos=jnp.asarray(q), t_pos=jnp.asarray(t),
                             length=jnp.asarray(ln), valid=jnp.asarray(va),
                             n_in_range=jnp.asarray(n))
    tws = tchain.WindowSeeds(*(torch.from_numpy(a) for a in (q, t, ln, va,
                                                             n)))
    return jws, tws


def _assert_chains_equal(got, want):
    for f in ("q_pos", "t_pos", "length", "chain_len", "score"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_clasp_matches_jax_and_oracle(rng):
    W, N = 24, 64
    counts = [0, 1, 2] + [int(c) for c in rng.integers(3, N + 1, W - 3)]
    arrays, seeds = _windows(rng, W, N, counts)
    jws, tws = _both(arrays)
    cfg = dict(chain_alg="clasp")
    want = jchain.chain_clasp_sop(jws, JCfg(**cfg))
    got = tchain.chain_clasp_sop(tws, TCfg(**cfg))
    _assert_chains_equal(got, want)
    assert int(got.chain_len.max()) > 5
    for w, s in enumerate(seeds):
        chain, score = oracle_clasp_sop(s)
        n = int(got.chain_len[w])
        assert n == len(chain), w
        assert float(got.score[w]) == np.float32(score), w
        assert [(int(got.q_pos[w, i]), int(got.t_pos[w, i]),
                 int(got.length[w, i])) for i in range(n)] == chain, w


@pytest.mark.parametrize("big_windows,route", [(8, "merged"),
                                               (1, "full")])
def test_clasp_bucketed_routes_match_jax(big_windows, route):
    """chain_small_n = 16: three windows hold more seeds than the narrow
    DP, so with 8 big-window slots the narrow and wide DPs are merged,
    and with 1 the full-width DP runs over the whole batch."""
    rng = np.random.default_rng(5)
    W, N = 20, 64
    counts = [int(c) for c in rng.integers(0, 17, W)]
    counts[3], counts[11], counts[17] = 40, 64, 25
    arrays, _ = _windows(rng, W, N, counts)
    jws, tws = _both(arrays)
    cfg = dict(chain_alg="clasp", max_chain_seeds=N, chain_small_n=16,
               chain_big_windows=big_windows)
    assert (sum(c > 16 for c in counts) <= big_windows) == (route ==
                                                           "merged")
    want = jchain.chain_seeds(jws, JCfg(**cfg))
    got = tchain.chain_seeds(tws, TCfg(**cfg))
    _assert_chains_equal(got, want)
    assert int(got.chain_len[11]) > 16


def _sam(engine):
    out = io.StringIO()
    engine.map_file(DATA / "reads.fq", out, "clasp")
    return [l for l in out.getvalue().splitlines() if not l.startswith("@")]


def test_clasp_engine_golden_matches_jax(ref8_idx):
    cfg = dict(TEST_CFG, chain_alg="clasp")
    eng = MappingEngine(port_index(ref8_idx), TCfg(**cfg), device="cpu")
    ours = _sam(eng)
    want = _sam(JEngine(ref8_idx, JCfg(**cfg)))
    assert len(want) == 78
    assert ours == want
    assert eng.metrics.counters["chained_windows"] > 50
