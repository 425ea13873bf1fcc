"""A numpy model of the chaining kernel (lordfast_tpu_torch/csrc/chain_dp.cu
``chain_dp_kernel``, names as there) against the port's plain version
(ops/chain.py ``chain_dpn2`` / ``chain_clasp_sop`` at full width) and the
JAX package, on the golden batch's windows and on random ones: both
costs, exact score ties, t differences that wrap int32, empty windows, N
= 64, 128 and 512.  The model runs one window at a time to its own seed
count, takes each seed's (val, j) maximum as the kernel's threads, warps
and blocks do, rounds every product and sum on its own (the kernel's
``__dmul_rn`` / ``__dadd_rn`` order; numpy does not contract), takes the
log of the plain version's device (torch's, as the kernel takes CUDA's,
which torch's cuda log calls), and walks prev as thread 0 does.

Tolerances: dp and prev bit-equal to the plain version, and every chain
field too; chains equal to the JAX package's exactly, and its float32
scores too for clasp; dp-n2's scores to rtol 1e-12 against JAX, whose
log and fused multiply-adds may differ in the last bit of the float64
value (tests/test_torch_chain.py has the same tolerance).  Also: the two
routes of ``_chain_bucketed`` equal the full-width DP of every window,
the claim the kernel's dispatch rests on."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.ops import chain as jchain
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.ops import chain as tchain
from lordfast_tpu_torch.ops import chain_cuda
from lordfast_tpu_torch.ops import fm_index as tfm
from lordfast_tpu_torch.pipeline import device_stage

from test_golden import TEST_CFG
from test_torch_engine import _first_batch
from test_torch_fm_index import port_index

torch.set_num_threads(2)

K_THREADS = 128
K_WARPS = K_THREADS // 32
K_DPN2, K_CLASP = 0, 1


def _log_plain(x):
    """The plain version's log on its device: torch's."""
    return torch.log(torch.from_numpy(x)).numpy()


def _wrap32(x):
    """The low 32 bits of a uint64 array as int32."""
    return x.astype(np.uint32).view(np.int32)


def _pair_vals(i, sq, st, slen, sok, sdp, cost, F, reward, penalty, lam,
               eml):
    """val of every j < i for seed i (the loop body over j), -inf where
    the kernel's `continue` skips j."""
    j = np.arange(i)
    qi = sq[i : i + 1].view(np.uint32)[0]
    ti = st[i : i + 1].view(np.uint64)[0]
    qe = sq[j].view(np.uint32) + slen[j].view(np.uint32) - np.uint32(1)
    te = (st[j].view(np.uint64) + slen[j].astype(np.int64).view(np.uint64)
          - np.uint64(1))
    neg_inf = F(-np.inf)
    if cost == K_DPN2:
        dr = (qi - qe).view(np.int32)
        dt = _wrap32(ti - te)
        link = sok[j] & (dr > 0) & (dt > 0)
        dd = (dr.view(np.uint32) - dt.view(np.uint32)).view(np.int32)
        d = np.where(dd < 0, (np.uint32(0) - dd.view(np.uint32)).view(
            np.int32), dd)
        big = d > 1
        logd = _log_plain(np.maximum(d, 2).astype(F))
        pen = np.where(big, (F(0.1) * d.astype(F)) + (F(penalty) * logd),
                       F(0))
        val = (sdp[j] + F(reward)) - pen
    else:
        dy = (qi - qe - np.uint32(1)).view(np.int32)
        dx = _wrap32(ti - te - np.uint64(1))
        link = sok[j] & (dy >= 0) & (dx >= 0)
        fx, fy = dx.astype(F), dy.astype(F)
        hi = np.where(fx > fy, fx, fy)
        lo = np.where(fx < fy, fx, fy)
        gsop = (F(lam) * hi) + (eml * lo)
        val = sdp[j] - gsop
    return np.where(link, val, neg_inf).astype(F)


def _beats_pred(v, j, bv, bj):
    return (v > bv) | ((v == bv) & (j > bj))


def _beats_end(v, i, bv, bi):
    return (v > bv) | ((v == bv) & (i < bi))


def _thread_partials(vals, F, pick_last, none):
    """Each thread x's pair over its slots x, x + K_THREADS, ... of
    ``vals`` (-inf where skipped): the largest value and, among its ties,
    the last slot (the predecessor loop's >=) or the first (the best
    end's strict >); (-inf, none) for a thread with no slot."""
    n = len(vals)
    rows = max(1, -(-n // K_THREADS))
    pad = np.full(rows * K_THREADS, -np.inf, F)
    pad[:n] = vals
    pad = pad.reshape(rows, K_THREADS)
    bv = pad.max(axis=0)
    hit = pad == bv
    row = (rows - 1 - np.argmax(hit[::-1], axis=0) if pick_last
           else np.argmax(hit, axis=0))
    x = np.arange(K_THREADS)
    return bv, np.where(bv > -np.inf, row * K_THREADS + x, none)


def _block_reduce(bv, bj, beats):
    """The kernel's reduction of K_THREADS (value, index) pairs: five
    __shfl_down_sync steps per warp (a lane past the warp's end keeps its
    own pair), then warp 0's pair against warps 1..3 in order."""
    bv = bv.reshape(K_WARPS, 32).copy()
    bj = bj.reshape(K_WARPS, 32).copy()
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        src = np.where(lane + off < 32, lane + off, lane)
        ov, oj = bv[:, src], bj[:, src]
        win = beats(ov, oj, bv, bj)
        bv, bj = np.where(win, ov, bv), np.where(win, oj, bj)
    best, pj = bv[0, 0], bj[0, 0]
    for w in range(1, K_WARPS):
        if beats(bv[w, 0], bj[w, 0], best, pj):
            best, pj = bv[w, 0], bj[w, 0]
    return best, pj


def chain_dp_model(q, t, ln, ok, cost, reward, penalty, lam, eps,
                   F=np.float64):
    """(out_q, out_t, out_len, chain_len, score, dp, prev) of the kernel
    on (W, N) windows: q, len int32, t int64, ok bool."""
    W, N = q.shape
    out_q = np.zeros((W, N), np.int32)
    out_t = np.zeros((W, N), np.int64)
    out_len = np.zeros((W, N), np.int32)
    chain_len = np.zeros(W, np.int32)
    score = np.zeros(W, np.float32)
    dp = np.full((W, N), -np.inf, F)
    prev = np.full((W, N), -1, np.int64)
    eml = F(eps) - F(lam)
    for w in range(W):
        sq, st, slen, sok = q[w], t[w], ln[w], ok[w]
        sdp, sprev = dp[w], prev[w]
        count = int(sok.sum())  # __syncthreads_count over the slots
        for i in range(count):
            val = _pair_vals(i, sq, st, slen, sok, sdp, cost, F, reward,
                             penalty, lam, eml)
            # thread x: its slots j = x mod K_THREADS, ascending, >=
            bv, bj = _thread_partials(val, F, True, -1)
            best, pj = _block_reduce(bv, bj, _beats_pred)
            li = F(slen[i])
            if cost == K_DPN2:
                take = best > li
                dpi = best if take else li
            else:
                take = best >= F(0)
                dpi = li + (best if best > F(0) else F(0))
            if sok[i]:
                sdp[i] = dpi
                sprev[i] = pj if take else -1
        # best end: thread x over s = x mod K_THREADS < count, strict >
        bv, bi = _thread_partials(sdp[:count], F, False, N)
        best, best_i = _block_reduce(bv, bi, _beats_end)
        clen, chain = 0, []
        if count > 0:
            cur = best_i
            while cur >= 0:
                chain.append(cur)
                cur = sprev[cur]
            clen = len(chain)
        chain = chain[::-1]
        chain_len[w] = clen
        score[w] = np.float32(best) if count > 0 else np.float32(-1)
        out_q[w, :clen] = sq[chain]
        out_t[w, :clen] = st[chain]
        out_len[w, :clen] = slen[chain]
    return out_q, out_t, out_len, chain_len, score, dp, prev


COST = {"dpn2": K_DPN2, "clasp": K_CLASP}


def _model(arrays, cfg, F=np.float64):
    q, t, ln, va = arrays
    return chain_dp_model(q, t.astype(np.int64), ln, va,
                          COST["clasp" if cfg.chain_alg == "clasp"
                               else "dpn2"],
                          cfg.chain_reward * cfg.min_anchor_len,
                          cfg.chain_penalty, cfg.clasp_lambda,
                          cfg.clasp_epsilon, F)


def _tws(arrays):
    q, t, ln, va = arrays
    n = va.sum(-1).astype(np.int32)
    return tchain.WindowSeeds(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in (q, t, ln, va, n)))


def _jws(arrays):
    q, t, ln, va = arrays
    return jchain.WindowSeeds(q_pos=jnp.asarray(q), t_pos=jnp.asarray(t),
                              length=jnp.asarray(ln), valid=jnp.asarray(va),
                              n_in_range=jnp.asarray(va.sum(-1)))


def _assert_model_is_plain(arrays, tcfg, F=np.float64):
    """The model's every output bit-equal to the plain version's (dp and
    prev through return_dp); returns the model's outputs."""
    got = _model(arrays, tcfg, F)
    want, dp, prev = tchain.dp_function(tcfg)(_tws(arrays), tcfg,
                                              return_dp=True)
    ibits = np.int64 if F == np.float64 else np.int32
    np.testing.assert_array_equal(got[5].view(ibits), dp.numpy().view(ibits),
                                  err_msg="dp bits")
    np.testing.assert_array_equal(got[6], prev.numpy(), err_msg="prev")
    for name, g in zip(("q_pos", "t_pos", "length", "chain_len"), got):
        np.testing.assert_array_equal(g, getattr(want, name).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(got[4].view(np.int32),
                                  want.score.numpy().view(np.int32),
                                  err_msg="score bits")
    return got


def _assert_model_is_jax(got, arrays, jcfg):
    jfn = (jchain.chain_clasp_sop if jcfg.chain_alg == "clasp"
           else jchain.chain_dpn2)
    want = jfn(_jws(arrays), jcfg)
    for name, g in zip(("q_pos", "t_pos", "length", "chain_len"), got):
        np.testing.assert_array_equal(g, np.asarray(getattr(want, name)),
                                      err_msg=name)
    rtol = 0 if jcfg.chain_alg == "clasp" else 1e-12
    np.testing.assert_allclose(got[4], np.asarray(want.score), rtol=rtol,
                               atol=0)


def _tie_decisions(arrays, tcfg, got):
    """Seeds whose predecessor is one of several j of equal val, and
    windows whose best end is one of several i of equal dp."""
    q, t, ln, va = arrays
    F = np.float64
    cost = K_CLASP if tcfg.chain_alg == "clasp" else K_DPN2
    eml = F(tcfg.clasp_epsilon) - F(tcfg.clasp_lambda)
    pred = end = 0
    for w in range(q.shape[0]):
        dp = got[5][w]
        for i in range(int(va[w].sum())):
            if got[6][w, i] < 0:
                continue
            val = _pair_vals(i, q[w], t[w].astype(np.int64), ln[w], va[w],
                             dp, cost, F, tcfg.chain_reward
                             * tcfg.min_anchor_len, tcfg.chain_penalty,
                             tcfg.clasp_lambda, eml)
            pred += int((val == val[got[6][w, i]]).sum() > 1)
        if va[w].any():
            end += int((dp == dp.max()).sum() > 1)
    return pred, end


@pytest.fixture(scope="module")
def golden_windows(ref8_idx):
    """The windows the port's device stage chains for golden's first
    batch on the CPU, at the golden test's config (N = 128)."""
    cfg = TCfg(**TEST_CFG).validate()
    arr, lens = _first_batch(cfg)
    pidx = port_index(ref8_idx)
    pos = tfm.sample_positions_host(lens, cfg.sampling_count)
    seen = []
    orig = tchain.chain_seeds
    tchain.chain_seeds = lambda ws, c, plain=False: seen.append(ws) or orig(
        ws, c, plain)
    try:
        device_stage.device_pipeline(pidx.meta, cfg)(
            pidx.device_arrays("cpu"), torch.from_numpy(arr),
            torch.from_numpy(lens), torch.from_numpy(pos))
    finally:
        tchain.chain_seeds = orig
    ws = seen[0]
    live = ws.valid.any(-1).numpy()
    return tuple(x.numpy()[live] for x in ws[:4])


@pytest.mark.parametrize("alg", ["dpn2", "clasp"])
def test_model_on_golden_windows(golden_windows, alg):
    kw = dict(TEST_CFG, chain_alg=alg)
    tcfg, jcfg = TCfg(**kw).validate(), JCfg(**kw).validate()
    arrays = golden_windows
    assert arrays[0].shape[1] == 128 and arrays[3].sum() > 1000
    got = _assert_model_is_plain(arrays, tcfg)
    _assert_model_is_jax(got, arrays, jcfg)
    assert got[3].max() > 5


@pytest.mark.parametrize("alg,N,F", [
    ("dpn2", 64, np.float64), ("dpn2", 512, np.float64),
    ("clasp", 64, np.float64), ("clasp", 512, np.float64),
    ("dpn2", 64, np.float32)], ids=["dpn2-64", "dpn2-512", "clasp-64",
                                    "clasp-512", "dpn2-64-f32"])
def test_model_on_random_windows(alg, N, F):
    """Random windows with empty ones, full ones, repeated seeds (exact
    ties) and int32-wrapping t differences."""
    rng = np.random.default_rng(N + len(alg) + (F == np.float32))
    W = 12 if N == 512 else 24
    counts = [0, 1, N, 2] + [int(c) for c in rng.integers(0, N + 1, W - 4)]
    if N == 512:
        counts[5:7] = [0, 300]
    arrays = chip_smoke.make_windows(rng, W, N, counts, wrap=True)
    kw = dict(chain_alg=alg, max_chain_seeds=N,
              chain_dp_dtype="f32" if F == np.float32 else "auto")
    tcfg, jcfg = TCfg(**kw).validate(), JCfg(**kw).validate()
    got = _assert_model_is_plain(arrays, tcfg, F)
    if F == np.float64:
        _assert_model_is_jax(got, arrays, jcfg)
        pred, end = _tie_decisions(arrays, tcfg, got)
        assert pred > 0 and end > 0, (pred, end)
    # the wrapped windows' t jumps (3 * 2^30 and 2^32 + 5) are there
    q, t, ln, va = arrays
    jumps = np.diff(t, axis=1).max(axis=1) > 2**31
    assert jumps.any()
    assert got[3].max() > 5


@pytest.mark.parametrize("alg", ["dpn2", "clasp"])
@pytest.mark.parametrize("route", ["merged", "full"])
def test_bucketed_equals_full_width_dp(alg, route):
    """_chain_bucketed (chain_small_n 16, chain_big_windows 4) against
    the full-width DP of every window: with 3 windows over the narrow
    width every one of them is in the top 4 and the two DPs are merged;
    with 6 the full DP runs over the batch.  Equal either way, so a
    kernel that runs each window to its own count is both routes."""
    rng = np.random.default_rng(17)
    W, N = 20, 64
    counts = [int(c) for c in rng.integers(0, 17, W)]
    big = [3, 11, 17] if route == "merged" else [1, 3, 8, 11, 14, 17]
    for w in big:
        counts[w] = int(rng.integers(17, N + 1))
    arrays = chip_smoke.make_windows(rng, W, N, counts)
    cfg = TCfg(chain_alg=alg, max_chain_seeds=N, chain_small_n=16,
               chain_big_windows=4).validate()
    fn = tchain.dp_function(cfg)
    before = tchain._chain_bucketed.entries
    got = tchain._chain_bucketed(_tws(arrays), cfg, fn)
    assert tchain._chain_bucketed.entries == before + 1
    want = fn(_tws(arrays), cfg)
    for name in tchain.ChainBatch._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)
    assert int(want.chain_len.max()) > 16


def test_chain_dp_wrapper_on_cpu_is_plain():
    """chain_cuda.chain_dp on CPU tensors runs the plain full-width DP
    (no launch); chain_seeds on CPU tensors, or with plain=True, enters
    _chain_bucketed."""
    rng = np.random.default_rng(3)
    arrays = chip_smoke.make_windows(rng, 6, 64, [0, 5, 64, 30, 12, 1])
    cfg = TCfg(max_chain_seeds=64).validate()
    launches = chain_cuda.chain_dp.launches
    got, dp, prev = chain_cuda.chain_dp(_tws(arrays), cfg, want_dp=True)
    want, dp_w, prev_w = tchain.chain_dpn2(_tws(arrays), cfg, return_dp=True)
    assert chain_cuda.chain_dp.launches == launches
    assert torch.equal(dp, dp_w) and torch.equal(prev, prev_w)
    for name in tchain.ChainBatch._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    before = tchain._chain_bucketed.entries
    for plain in (False, True):
        out = tchain.chain_seeds(_tws(arrays), cfg, plain)
        assert torch.equal(out.chain_len, want.chain_len)
    assert tchain._chain_bucketed.entries == before + 2


def test_record_loops_keeps_the_count_on_the_wrapper():
    """chip_smoke.record_loops records the first chain_dp call made
    through the module attribute the call sites read, and a launch
    counted inside the block lands on the wrapper's own count, which
    reset_launches and read_launches use."""
    rng = np.random.default_rng(5)
    arrays = chip_smoke.make_windows(rng, 4, 64, [3, 0, 64, 9])
    cfg = TCfg(max_chain_seeds=64).validate()
    wrapper = chain_cuda.chain_dp
    chip_smoke.reset_launches()
    with chip_smoke.record_loops() as rec:
        assert chain_cuda.chain_dp is not wrapper
        got = chain_cuda.chain_dp(_tws(arrays), cfg)
        chain_cuda.chain_dp(_tws(arrays), cfg)
        chain_cuda.chain_dp.launches += 1  # as the wrapper counts a launch
        assert chip_smoke.read_launches()["chain_dp"] == 1
    assert chain_cuda.chain_dp is wrapper
    assert wrapper.launches == 1 and len(rec.chain) == 1
    ws, rcfg = rec.chain[0]
    assert rcfg is cfg
    for a, b in zip(ws, _tws(arrays)):
        assert torch.equal(a, b)
    want = tchain.chain_dpn2(_tws(arrays), cfg)
    assert torch.equal(got.chain_len, want.chain_len)
    chip_smoke.reset_launches()
