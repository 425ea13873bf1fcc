"""clasp sum-of-pairs chaining (``-a clasp``) in the PyTorch port against
the JAX package's ``chain_clasp_sop`` and the literal oracle of
tests/test_vote_chain.py, on random windows, through both routes of
``_chain_bucketed``, and end to end on the golden fixture.  Chains and
chain lengths must be equal exactly, and so must the scores: the DP is
float64 with the same operations in the same order as the JAX version
(no transcendental, unlike dp-n2's log), cast to float32.  On random
windows the port is held to the oracle everywhere, and the JAX package
to the oracle with its gap cost rounded once: XLA on the CPU fuses the
gap cost's multiply-add, which now and then breaks a score tie the
other way; there the two chains must tie exactly at lambda = 3/20 and
the port must keep the oracle's (_assert_oracle_then_jax)."""

import io
import math
from fractions import Fraction
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


def _chain_of(c, w):
    return [(int(c.q_pos[w, i]), int(c.t_pos[w, i]), int(c.length[w, i]))
            for i in range(int(c.chain_len[w]))]


def _oracle_fused(seeds, lam=0.15, eps=0.0):
    """oracle_clasp_sop with the gap cost rounded once, as a fused
    multiply-add: lam * max + round((eps - lam) * min), rounded to
    float64 as a whole.  This is what XLA on the CPU computes for the JAX
    package's gap cost."""
    fr = sorted(seeds)
    n = len(fr)
    if n == 0:
        return [], -1.0
    dp, prev = [0.0] * n, [-1] * n
    for i, (qi, ti, li) in enumerate(fr):
        dp[i] = float(li)
        best, bj = -math.inf, -1
        for j, (qj, tj, lj) in enumerate(fr[:i]):
            dy = qi - (qj + lj - 1) - 1
            dx = ti - (tj + lj - 1) - 1
            if dy < 0 or dx < 0:
                continue
            gsop = float(Fraction(lam) * max(dx, dy)
                         + Fraction((eps - lam) * min(dx, dy)))
            v = dp[j] - gsop
            if v >= best:
                best, bj = v, j
        if best >= 0:
            dp[i] = li + best
            prev[i] = bj
    i = max(range(n), key=lambda i: (dp[i], -i))
    chain, score = [], dp[i]
    while i != -1:
        chain.append(fr[i])
        i = prev[i]
    return chain[::-1], score


def _exact_score(chain):
    """The chain's score in exact arithmetic at lordFAST's lambda = 0.15
    as the decimal 3/20 and epsilon = 0 (src/Chain.cpp:52-55): the sum of
    its lengths less 3/20 (max - min) of each link's gaps."""
    s = Fraction(chain[0][2])
    for (qj, tj, lj), (qi, ti, li) in zip(chain, chain[1:]):
        dy, dx = qi - (qj + lj - 1) - 1, ti - (tj + lj - 1) - 1
        s += li - Fraction(3, 20) * (max(dx, dy) - min(dx, dy))
    return s


# at most this many of a random batch's 24 windows break a tie the
# other way in the JAX package: of 400 batches (seeds 0-399), 386 had
# none, 13 one and 1 two (seed 87)
MAX_FUSED = 2


def _assert_oracle_then_jax(rng, W=24, N=64):
    """Random windows through the port, the JAX package and the oracle:
    the port's chain and float32 score equal the oracle's on every
    window.  XLA on the CPU contracts the JAX package's gap cost lam *
    max + (eps - lam) * min into a fused multiply-add, so its float64
    costs differ from the reference's (and the oracle's and the port's)
    in their last bits (ROADMAP Queue 3): the JAX chain and score equal
    _oracle_fused's on every window, and where that chain is not the
    oracle's (returned, in order), it ties the oracle's chain exactly at
    lambda = 3/20 and its float32 score is the oracle's: a tie broken
    the other way, not another answer.  Elsewhere the port equals the
    JAX package."""
    counts = [0, 1, 2] + [int(c) for c in rng.integers(3, N + 1, W - 3)]
    arrays, seeds = _windows(rng, W, N, counts)
    jws, tws = _both(arrays)
    cfg = dict(chain_alg="clasp")
    assert (JCfg().clasp_lambda, JCfg().clasp_epsilon) == (0.15, 0.0)
    want = jchain.chain_clasp_sop(jws, JCfg(**cfg))
    got = tchain.chain_clasp_sop(tws, TCfg(**cfg))
    assert int(got.chain_len.max()) > 5
    fused = []
    for w, s in enumerate(seeds):
        chain, score = oracle_clasp_sop(s)
        assert _chain_of(got, w) == chain, w
        assert float(got.score[w]) == np.float32(score), w
        f_chain, f_score = _oracle_fused(s)
        assert _chain_of(want, w) == f_chain, w
        assert float(want.score[w]) == np.float32(f_score), w
        if f_chain != chain:
            assert float(want.score[w]) == np.float32(score), w
            assert _exact_score(f_chain) == _exact_score(chain), w
            fused.append(w)
    keep = np.setdiff1d(np.arange(W), fused)
    _assert_chains_equal(type(got)(*(x[keep] for x in got)),
                         type(want)(*(np.asarray(x)[keep] for x in want)))
    return fused


def test_clasp_matches_jax_and_oracle(rng):
    assert len(_assert_oracle_then_jax(rng)) <= MAX_FUSED


@pytest.mark.parametrize("seed,fused", [(1, [14]), (56, [22]),
                                        (87, [10, 12])])
def test_clasp_follows_the_reference_where_jax_fuses(seed, fused):
    """Batches whose random windows hold a score tie that the JAX
    package's fused gap cost breaks the other way: the port keeps the
    oracle's chain, and the JAX package the fused oracle's."""
    assert _assert_oracle_then_jax(np.random.default_rng(seed)) == fused


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
