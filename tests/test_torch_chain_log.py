"""dp-n2's log in the port: one table of the C library's log
(lordfast_tpu_torch/ops/chain.py ``log_table``, made with Python's
math.log) that the plain DP and the chaining kernel both read, against
the reference's C-double penalty ``0.1*d + chainPenalty*log(d)``
(src/Chain.cpp:217-225, no fused multiply-add) and the JAX package's
chain decisions.

At the default penalty 11.4 no penalty of a table entry moves with the
log's last bit; at penalty 100 (``-p 100``) torch.log's penalty differs
from the C library's at d = 9,170 and 19,143 among others on an x86-64
CPU, so the cases run both.  Tolerances: the penalty and dp equal in
their float64 bits; chain decisions (q, t, len, chain_len) equal the
JAX package's exactly and its scores to rtol 1e-12 (XLA fuses the
penalty's product and sum, tests/test_torch_chain.py); the kernel's side
of the table runs on the card (tests/test_torch_cuda.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.ops import chain as jchain
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.ops import chain as tchain

torch.set_num_threads(2)

CPU = torch.device("cpu")
TORCH_LOG_DIFFERS = (9170, 19143)  # torch.log != math.log on x86-64 CPUs


def _table(cfg):
    return tchain.log_table(tchain.log_table_len(cfg), CPU, torch.float64)


def _c_pen(d, penalty):
    return 0.0 if d <= 1 else 0.1 * d + penalty * math.log(d)


def _ws(arrays):
    q, t, ln, va = arrays
    return tchain.WindowSeeds(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in (q, t, ln, va,
                                          va.sum(-1).astype(np.int32))))


@pytest.mark.parametrize("penalty", [11.4, 100.0])
def test_penalty_is_the_c_double_formula(penalty):
    """dpn2_penalty at every entry of the table (d = 0 .. 3 x
    seq_max_length - 1, 9,170 and 19,143 among them) equals
    0.1*d + penalty*log(d) in Python floats (C doubles, libm's log)."""
    cfg = TCfg(chain_penalty=penalty)
    table = _table(cfg)
    n = table.shape[0]
    d = torch.arange(n, dtype=torch.int32)
    got = tchain.dpn2_penalty(d, torch.ones(n, dtype=torch.bool), table,
                              penalty).numpy()
    want = np.array([_c_pen(x, penalty) for x in range(n)])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    for x in TORCH_LOG_DIFFERS:
        assert got[x] == 0.1 * x + penalty * math.log(x)


@pytest.mark.parametrize("where", ["last", "past"])
def test_table_edge(where):
    """The table's last entry d = n - 1: the plain DP's dp equals the C
    formula's; one past it (d = n) a linked pair raises, in the DP and in
    dpn2_penalty; an unlinked pair's d reads nothing."""
    cfg = TCfg()
    table = _table(cfg)
    n = table.shape[0]
    d = n - 1 if where == "last" else n
    ws = _ws(chip_smoke.log_windows(np.array([d])))
    one = torch.ones(1, dtype=torch.bool)
    dd = torch.tensor([d], dtype=torch.int32)
    assert float(tchain.dpn2_penalty(dd, ~one, table, 11.4)[0]) == \
        0.1 * d + 11.4 * float(table[0])
    if where == "past":
        with pytest.raises(IndexError):
            tchain.dpn2_penalty(dd, one, table, cfg.chain_penalty)
        with pytest.raises(IndexError):
            tchain.chain_dpn2(ws, cfg)
        return
    _, dp, prev = tchain.chain_dpn2(ws, cfg, return_dp=True)
    assert float(dp[0, 1]) == chip_smoke.log_window_dp([d], cfg)[0]
    assert int(prev[0, 1]) == 0


@pytest.mark.parametrize("penalty", [11.4, 100.0])
def test_dp_bits_equal_the_c_formula(penalty):
    """chain_dpn2's dp of log_windows' second seed equals (L + reward) -
    pen(d) in C doubles for every d < 4096, the values where torch.log
    and the C library's part, 20,000 random d of the table and its last
    entry."""
    cfg = TCfg(chain_penalty=penalty)
    n = tchain.log_table_len(cfg)
    rng = np.random.default_rng(11)
    ds = np.concatenate([np.arange(4096), TORCH_LOG_DIFFERS,
                         rng.integers(4096, n, 20_000), [n - 1]])
    _, dp, prev = tchain.chain_dpn2(_ws(chip_smoke.log_windows(ds)), cfg,
                                    return_dp=True)
    want = np.array(chip_smoke.log_window_dp(ds, cfg))
    np.testing.assert_array_equal(dp[:, 1].numpy().view(np.int64),
                                  want.view(np.int64))
    assert bool((prev[:, 1] == 0).all())


@pytest.mark.parametrize("case", ["near_ties", "log_values"])
def test_decisions_equal_jax(case):
    """chain_dpn2's decisions on seeded windows equal the JAX package's
    jitted chain_dpn2: make_windows' windows with repeated seeds (exact
    ties decide predecessors and ends), and windows whose pairs sit at
    d = 9,170 and 19,143 and one past and before each (a chain of seeds
    t-shifted by those d), at penalty 100."""
    rng = np.random.default_rng(23)
    if case == "near_ties":
        W, N = 24, 128
        counts = [int(c) for c in rng.integers(1, N + 1, W)]
        arrays = chip_smoke.make_windows(rng, W, N, counts)
        kw = dict(max_chain_seeds=N)
    else:
        W, N = 12, 16
        q = np.zeros((W, N), np.int32)
        t = np.zeros((W, N), np.int64)
        ln = np.full((W, N), 20, np.int32)
        for w in range(W):
            d = TORCH_LOG_DIFFERS[w % 2] + (w // 2) % 3 - 1
            q[w] = 2000 * np.arange(N) + rng.integers(0, 50, N)
            t[w] = q[w] + d * (np.arange(N) % 2) + rng.integers(0, 3, N)
            ln[w] += rng.integers(0, 2000, N).astype(np.int32)
        arrays = (q, t, ln, np.ones((W, N), bool))
        kw = dict(max_chain_seeds=N, chain_penalty=100.0)
    tcfg, jcfg = TCfg(**kw).validate(), JCfg(**kw).validate()
    got = tchain.chain_dpn2(_ws(arrays), tcfg)
    q, t, ln, va = arrays
    want = jchain.chain_dpn2(jchain.WindowSeeds(
        q_pos=jnp.asarray(q), t_pos=jnp.asarray(t), length=jnp.asarray(ln),
        valid=jnp.asarray(va), n_in_range=jnp.asarray(va.sum(-1))), jcfg)
    for name in ("q_pos", "t_pos", "length", "chain_len"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=1e-12, atol=0)
    assert int(got.chain_len.max()) > 2
