"""A numpy model of the chaining kernel (lordfast_tpu_torch/csrc/chain_dp.cu
``chain_dp_kernel``, names as there) against the port's plain version
(ops/chain.py ``chain_dpn2`` / ``chain_clasp_sop`` at full width) and the
JAX package, on the golden batch's windows and on random ones: both
costs, exact score ties, t differences that wrap int32, empty windows, N
= 64, 128 and 512, and seed counts on the kernel's 32-seed tile edges
with planted ties (``chip_smoke.edge_windows``).  The model runs one
window (a warp) at a time to its own seed count, in tiles of 32 seeds:
each lane's running best over the settled tiles' pairs, the tile's own
penalties, then one broadcast a seed that every lane settles and folds,
as the kernel does; it rounds every product and sum on its own (the
kernel's ``__dmul_rn`` / ``__dadd_rn`` order; numpy does not contract),
reads dp-n2's log from the table the plain version and the kernel read
(``chain.log_table``: the C library's log), and finds the best end by
the kernel's butterfly and walks prev as its lane 0 does.

Tolerances: dp and prev bit-equal to the plain version, and every chain
field too; chains equal to the JAX package's exactly, and its float32
scores too for clasp; dp-n2's scores to rtol 1e-12 against JAX, whose
log and fused multiply-adds may differ in the last bit of the float64
value (tests/test_torch_chain.py has the same tolerance).  Also: the two
routes of ``_chain_bucketed`` equal the full-width DP of every window,
the claim the kernel's dispatch rests on."""

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
from lordfast_tpu_torch.ops import chain_cuda
from lordfast_tpu_torch.ops import fm_index as tfm
from lordfast_tpu_torch.pipeline import device_stage

from test_golden import TEST_CFG
from test_torch_engine import _first_batch
from test_torch_fm_index import port_index

torch.set_num_threads(2)

K_LANES = 32  # a warp: one window, seeds in tiles of 32
K_DPN2, K_CLASP = 0, 1


def _log_of(d, link, F):
    """log(max(d, 2)) of the linked pairs' d from dp-n2's table
    (chain.log_table at the default config's length), as the plain
    version and the kernel read it; an unlinked pair reads entry 0."""
    fdt = torch.float64 if F == np.float64 else torch.float32
    table = tchain.log_table(tchain.log_table_len(TCfg()),
                             torch.device("cpu"), fdt).numpy()
    return table[np.where(link, d, 0)]


def _wrap32(x):
    """The low 32 bits of a uint64 array as int32."""
    return x.astype(np.uint32).view(np.int32)


def pen_of(qi, ti, qj, tj, lj, cost, F, penalty, lam, eml):
    """(pen, link) of the pairs (j, i), elementwise over broadcast
    arrays: seed i at (qi, ti), seed j at (qj, tj) of length lj (int32,
    int64, int32), rounding each product and sum on its own."""
    qi, qj, lj = (np.asarray(x, np.int32) for x in (qi, qj, lj))
    ti, tj = np.asarray(ti, np.int64), np.asarray(tj, np.int64)
    qe = qj.view(np.uint32) + lj.view(np.uint32) - np.uint32(1)
    te = tj.view(np.uint64) + lj.astype(np.int64).view(np.uint64) - np.uint64(1)
    if cost == K_DPN2:
        dr = (qi.view(np.uint32) - qe).view(np.int32)
        dt = _wrap32(ti.view(np.uint64) - te)
        dd = (dr.view(np.uint32) - dt.view(np.uint32)).view(np.int32)
        d = np.where(dd < 0, (np.uint32(0) - dd.view(np.uint32)).view(
            np.int32), dd)
        link = (dr > 0) & (dt > 0)
        p = (F(0.1) * d.astype(F)) + (F(penalty) * _log_of(d, link, F))
        return np.where(d > 1, p, F(0)).astype(F), link
    dy = (qi.view(np.uint32) - qe - np.uint32(1)).view(np.int32)
    dx = _wrap32(ti.view(np.uint64) - te - np.uint64(1))
    fx, fy = dx.astype(F), dy.astype(F)
    hi = np.where(fx > fy, fx, fy)
    lo = np.where(fx < fy, fx, fy)
    return ((F(lam) * hi) + (eml * lo)).astype(F), (dy >= 0) & (dx >= 0)


def val_of(dpj, pen, cost, F, reward):
    """val of linked pairs from their predecessors' dp and penalties."""
    if cost == K_DPN2:
        return ((dpj + F(reward)) - pen).astype(F)
    return (dpj - pen).astype(F)


def _pair_vals(i, sq, st, slen, sok, sdp, cost, F, reward, penalty, lam,
               eml):
    """val of every j < i for seed i, -inf where j does not link."""
    j = np.arange(i)
    pen, link = pen_of(sq[i], st[i], sq[j], st[j], slen[j], cost, F,
                       penalty, lam, eml)
    val = val_of(sdp[j], pen, cost, F, reward)
    return np.where(link & (sok[j] != 0), val, F(-np.inf)).astype(F)


def _beats_end(v, i, bv, bi):
    return (v > bv) | ((v == bv) & (i < bi))


def _settled_pairs(base, qi, ti, sq, st, slen, sok, sdp, cost, F, reward,
                   penalty, lam, eml):
    """Step 1: each lane's running best (bv, bj) over the pairs (j, i)
    of the settled tiles, j < base in ascending order with >= (the
    largest j among the top linked val); (-inf, -1) with no link."""
    bv = np.full(K_LANES, -np.inf, F)
    bj = np.full(K_LANES, -1, np.int64)
    if base == 0:
        return bv, bj
    j = np.arange(base)
    pen, link = pen_of(qi[:, None], ti[:, None], sq[j][None], st[j][None],
                       slen[j][None], cost, F, penalty, lam, eml)
    link &= (sok[j] != 0)[None]
    val = np.where(link, val_of(sdp[j][None], pen, cost, F, reward),
                   F(-np.inf))
    for x in range(K_LANES):
        if link[x].any():
            top = val[x][link[x]].max()
            bv[x] = top
            bj[x] = np.nonzero(link[x] & (val[x] == top))[0].max()
    return bv, bj


def _best_end(sdp, count, N, F):
    """Each lane's (ev, ei) over its slots s = lane mod 32 < count,
    ascending with strict > (the smaller s among ties), then the
    butterfly of __shfl_xor_sync (larger dp, then smaller i)."""
    ev = np.full(K_LANES, -np.inf, F)
    ei = np.full(K_LANES, N, np.int64)
    for s in range(count):
        x = s % K_LANES
        if sdp[s] > ev[x]:
            ev[x], ei[x] = sdp[s], s
    lane = np.arange(K_LANES)
    for off in (16, 8, 4, 2, 1):
        ov, oi = ev[lane ^ off], ei[lane ^ off]
        win = _beats_end(ov, oi, ev, ei)
        ev, ei = np.where(win, ov, ev), np.where(win, oi, ei)
    assert (ev == ev[0]).all() and (ei == ei[0]).all()
    return ev[0], int(ei[0])


def chain_dp_model(q, t, ln, ok, cost, reward, penalty, lam, eps,
                   F=np.float64):
    """(out_q, out_t, out_len, chain_len, score, dp, prev) of the kernel
    on (W, N) windows: q, len int32, t int64, ok bool.  One warp a
    window: its count, then tiles of K_LANES seeds, lane x owning seed
    base + x (step 1, the settled tiles' pairs; step 2, the tile's own
    penalties pen[s] and link bits; step 3, one broadcast a seed), the
    best end and one walk of prev.  The kernel reads dp-n2's log(max(d,
    2)) from the plain version's table (chain.log_table, _log_of), as
    test_log_table_is_the_plain_log holds."""
    W, N = q.shape
    out_q = np.zeros((W, N), np.int32)
    out_t = np.zeros((W, N), np.int64)
    out_len = np.zeros((W, N), np.int32)
    chain_len = np.zeros(W, np.int32)
    score = np.zeros(W, np.float32)
    dp = np.full((W, N), -np.inf, F)
    prev = np.full((W, N), -1, np.int64)
    eml = F(eps) - F(lam)
    lanes = np.arange(K_LANES)
    for w in range(W):
        sq, st, slen, sok = q[w], t[w], ln[w], ok[w]
        sdp, sprev = dp[w], prev[w]
        count = int((sok != 0).sum())  # nz_bytes, __reduce_add_sync
        for base in range(0, count, K_LANES):
            i = base + lanes
            own = i < count
            ic = np.where(own, i, count - 1)
            qi, ti, li = sq[ic], st[ic], slen[ic].astype(F)
            oki = own & (sok[ic] != 0)
            bv, bj = _settled_pairs(base, qi, ti, sq, st, slen, sok, sdp,
                                    cost, F, reward, penalty, lam, eml)
            s = np.arange(K_LANES - 1)
            jt = np.minimum(base + s, count - 1)
            pen, lk = pen_of(qi[:, None], ti[:, None], sq[jt][None],
                             st[jt][None], slen[jt][None], cost, F, penalty,
                             lam, eml)
            link = ((s[None] < lanes[:, None]) & own[:, None] & lk
                    & (sok[jt] != 0)[None])
            for s in range(min(K_LANES, count - base)):
                # the owner's (lane s) bvs, bjs, lis to every lane, which
                # settles seed base + s; the owner keeps dp and prev
                bvs, bjs, lis = bv[s], bj[s], li[s]
                if cost == K_DPN2:
                    take = bvs > lis
                    dps = bvs if take else lis
                else:
                    take = bvs >= F(0)
                    dps = F(lis + (bvs if bvs > F(0) else F(0)))
                if oki[s]:
                    sdp[base + s] = dps
                    sprev[base + s] = bjs if take else -1
                if s < K_LANES - 1:  # every lane folds the broadcast dps
                    val = val_of(dps, pen[:, s], cost, F, reward)
                    upd = link[:, s] & (val >= bv)
                    bv = np.where(upd, val, bv)
                    bj = np.where(upd, base + s, bj)
        ev, ei = _best_end(sdp, count, N, F)
        chain = []
        if ei < count:  # lane 0 walks prev, the chain from the back
            cur = ei
            while cur >= 0:
                chain.append(cur)
                cur = sprev[cur]
        chain = chain[::-1]
        clen = len(chain)
        chain_len[w] = clen
        score[w] = np.float32(ev) if count > 0 else np.float32(-1)
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


@pytest.mark.parametrize("alg,N,F", [
    ("dpn2", 64, np.float64), ("dpn2", 128, np.float64),
    ("dpn2", 512, np.float64), ("clasp", 128, np.float64),
    ("clasp", 512, np.float64), ("dpn2", 128, np.float32),
    ("clasp", 64, np.float32)], ids=["dpn2-64", "dpn2-128", "dpn2-512",
                                     "clasp-128", "clasp-512",
                                     "dpn2-128-f32", "clasp-64-f32"])
def test_model_at_tile_edges(alg, N, F):
    """chip_smoke.edge_windows: seed counts 0, 1, 31, 32, 33, 64, 65,
    105 and 512 (up to N), the planted exact ties of the predecessor
    inside a tile and across a tile's edge and of the best end across
    lanes and within a lane, and random windows of those counts with
    int32-wrapping t differences."""
    rng = np.random.default_rng(N + len(alg) + (F == np.float32))
    arrays = chip_smoke.edge_windows(rng, N)
    kw = dict(chain_alg=alg, max_chain_seeds=N,
              chain_dp_dtype="f32" if F == np.float32 else "auto")
    tcfg, jcfg = TCfg(**kw).validate(), JCfg(**kw).validate()
    got = _assert_model_is_plain(arrays, tcfg, F)
    if F == np.float64:
        _assert_model_is_jax(got, arrays, jcfg)
    q, t, ln, va = arrays
    cost = COST[alg]
    eml = F(tcfg.clasp_epsilon) - F(tcfg.clasp_lambda)
    counts = [c for c in chip_smoke.EDGE_COUNTS if c <= N]
    assert counts[-1] == N or N == 128
    ties = 0
    for k, c in enumerate(counts):
        w = 3 * k  # the chain: seed p + 2 takes p + 1 over the tie with p
        for p in chip_smoke.EDGE_DUPS:
            if p + 2 < c:
                val = _pair_vals(p + 2, q[w], t[w], ln[w], va[w], got[5][w],
                                 cost, F, tcfg.chain_reward
                                 * tcfg.min_anchor_len, tcfg.chain_penalty,
                                 tcfg.clasp_lambda, eml)
                assert val[p] == val[p + 1] == val.max()
                assert got[6][w, p + 2] == p + 1
                ties += 1
        w = 3 * k + 1  # unlinked: the best end is slot 3 of the tops
        if c > 3:
            assert got[3][w] == 1 and got[0][w, 0] == q[w, 3]
            assert (got[5][w][:c] == got[5][w][:c].max()).sum() == sum(
                p < c for p in chip_smoke.EDGE_TOPS)
    assert ties == sum(p + 2 < c for c in counts
                       for p in chip_smoke.EDGE_DUPS)


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


def test_log_table_is_the_plain_log():
    """chain.log_table, dp-n2's table of log(max(d, 2)) that the plain
    version and the kernel (chain_cuda.chain_dp) both read: 3 x
    seq_max_length entries, the C library's log (Python's math.log) in
    float64 and torch's CPU log in float32, made once a (device, type,
    length)."""
    cfg = TCfg()
    n = tchain.log_table_len(cfg)
    assert n == 3 * cfg.seq_max_length == 750_000
    table = tchain.log_table(n, torch.device("cpu"), torch.float64)
    assert table.dtype == torch.float64 and table.shape == (n,)
    want = [math.log(max(d, 2)) for d in range(n)]
    assert table.numpy().tolist() == want
    d = torch.arange(n)
    t32 = tchain.log_table(n, torch.device("cpu"), torch.float32)
    assert torch.equal(t32, torch.log(d.clamp(min=2).to(torch.float32)))
    assert tchain.log_table(n, torch.device("cpu"), torch.float64) is table


def _count_pairs(arrays, alg, fsize):
    """chip_smoke.chain_work's counts, pair by pair in Python ints: every
    pair j < i of a window's seeds, its int32 differences and whether it
    links; for a linked pair the float operations, and dp-n2's d and
    the table entries its log reads (every d > 1: the table covers every
    d a window links), and how many linked d lie at or past 65,536, the
    length of the table that took only near pairs before."""
    q, t, ln, va = arrays
    cut = lambda x: (x + 2**31) % 2**32 - 2**31
    pairs = linked = ints = fp = far = 0
    table = set()
    for w in range(q.shape[0]):
        n = int(va[w].sum())
        for i in range(n):
            qi, ti = int(q[w, i]), int(t[w, i])
            for j in range(i):
                pairs += 1
                ints += 4
                qe = int(q[w, j]) + int(ln[w, j]) - 1
                te = int(t[w, j]) + int(ln[w, j]) - 1
                if alg == "clasp":
                    if cut(qi - qe - 1) >= 0 and cut(ti - te - 1) >= 0:
                        linked += 1
                        fp += 7
                    continue
                dr, dt = cut(qi - qe), cut(ti - te)
                if not (dr > 0 and dt > 0):
                    continue
                linked += 1
                ints += 2
                dd = cut(dr - dt)
                d = dd if dd == -2**31 else abs(dd)
                far += d >= 65_536
                if d <= 1:
                    fp += 3
                else:
                    fp += 6
                    table.add(d)
    W, N = q.shape
    nbytes = (W * N + int(va.sum()) * (4 + 8 + 4) + W * N * (4 + 8 + 4)
              + W * 8 + fsize * len(table))
    return {"pairs": pairs, "linked": linked, "int_ops": ints,
            "fp_ops": fp, "bytes": nbytes}, far


@pytest.mark.parametrize("alg,dtype", [
    ("dpn2", "f64"), ("clasp", "f64"), ("dpn2", "f32")])
def test_smoke_chain_work_counts_the_inputs(alg, dtype):
    """chip_smoke.chain_work, which gives chain_dp's bound, equal to a
    count pair by pair: windows at several counts with int32 wraps, and
    one whose second half sits 100,000 further along t, so that dp-n2
    has linked pairs whose log lies past 65,536 entries (the table's
    length before it took every d a window can link)."""
    rng = np.random.default_rng(31)
    arrays = chip_smoke.make_windows(rng, 8, 64,
                                     [64, 40, 0, 1, 33, 64, 17, 64],
                                     wrap=True)
    arrays[1][7, 32:] += 100_000
    cfg = TCfg(chain_alg=alg, chain_dp_dtype=dtype)
    fsize = 8 if dtype == "f64" else 4
    want, far = _count_pairs(arrays, alg, fsize)
    got = chip_smoke.chain_work(_tws(arrays), cfg)
    rate = chip_smoke.FP64_FLOPS if fsize == 8 else chip_smoke.FP32_FLOPS
    assert got == {**want, "fp_rate": rate}
    assert want["linked"] > 0 and (alg == "clasp" or far > 0)


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
