"""The port's plain batched ksw_extend2 (ops/affine.py
extend_batch_plain) against the JAX package's Pallas affine kernel in
interpret mode (affine_pl.extend_batch) on all six outputs, and against
the port's host scalar oracle (native sw_extend via
align.edlib_eq.ksw_extend2): both parameter sets the engine uses (clip:
band 40, o=0/e=1; split: band 100, o_del 8 / o_ins 4), related, junk
(z-drop) and small / edge pairs with N codes.  Integers: exact."""

import numpy as np
import pytest
import torch

from lordfast_tpu.ops import affine_pl
from lordfast_tpu_torch.align import edlib_eq as ted
from lordfast_tpu_torch.ops import affine

from test_affine_pl import PARAM_SETS, _mutate

MAT = ted.build_ksw_matrix(2, 16)
BW, W_MAX = 256, 100


def _inputs(pairs, params, h0s, Qe, Te):
    G = len(pairs)
    qs = np.zeros((G, Qe), np.uint8)
    ts = np.zeros((G, Te), np.uint8)
    cols = {k: np.zeros(G, np.int32) for k in
            ("qlen", "tlen", "o_del", "e_del", "o_ins", "e_ins", "w_eff",
             "zdrop", "h0")}
    for g, (q, t) in enumerate(pairs):
        qs[g, : len(q)] = q
        ts[g, : len(t)] = t
        od, ed_, oi, ei, w, zd = params[g]
        cols["qlen"][g], cols["tlen"][g] = len(q), len(t)
        cols["o_del"][g], cols["e_del"][g] = od, ed_
        cols["o_ins"][g], cols["e_ins"][g] = oi, ei
        cols["zdrop"][g], cols["h0"][g] = zd, h0s[g]
        cols["w_eff"][g] = affine.clamp_band(len(q), 2, 0, od, ed_, oi, ei, w)
    cols["match"] = np.full(G, 2, np.int32)
    cols["mismatch"] = np.full(G, 16, np.int32)
    return qs, ts, cols


def _check(pairs, params, h0s, Qe, Te):
    qs, ts, cols = _inputs(pairs, params, h0s, Qe, Te)
    got = affine.extend_batch_plain(
        torch.from_numpy(qs), torch.from_numpy(ts), Qe, Te, BW, W_MAX,
        **{k: torch.from_numpy(v) for k, v in cols.items()})
    want = affine_pl.extend_batch(qs, ts, Qe, Te, BW, W_MAX,
                                  interpret=True, **cols)
    for name in affine.ExtendResult._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for g, (q, t) in enumerate(pairs):
        od, ed_, oi, ei, w, zd = params[g]
        oracle = ted.ksw_extend2(q, t, MAT, od, ed_, oi, ei, w, 0, zd,
                                 int(h0s[g]))
        assert tuple(int(getattr(got, n)[g]) for n in
                     ("score", "qle", "tle", "gtle", "gscore")) == oracle, g
    return got


def test_plain_related_pairs(rng):
    pairs, params, h0s = [], [], []
    for g in range(12):
        n = int(rng.integers(30, 400))
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = _mutate(q, rng, err=float(rng.uniform(0.05, 0.3)))[:480]
        pairs.append((q, t))
        params.append(PARAM_SETS[g % 2])
        h0s.append(int(rng.integers(1, 2 * n + 1)))
    _check(pairs, params, h0s, 512, 512)


def test_plain_junk_and_zdrop(rng):
    # unrelated sequences: z-drop ends the extension early
    pairs, params, h0s = [], [], []
    for g in range(10):
        nq = int(rng.integers(50, 500))
        nt = int(rng.integers(50, 500))
        pairs.append((rng.integers(0, 4, nq).astype(np.uint8),
                      rng.integers(0, 4, nt).astype(np.uint8)))
        params.append(PARAM_SETS[g % 2])
        h0s.append(nq)  # engine convention: h0 = query length
    got = _check(pairs, params, h0s, 512, 512)
    assert (got.tle.numpy() < [len(t) for _, t in pairs]).any()


def test_plain_small_and_edge(rng):
    # tiny queries exercise the max_ins/max_del band clamp; N codes;
    # qlen == Qe
    pairs, params, h0s = [], [], []
    for i, n in enumerate([1, 2, 3, 5, 8, 13, 21, 34, 64]):
        q = rng.integers(0, 5, n).astype(np.uint8)
        t = rng.integers(0, 5, int(rng.integers(1, 2 * n + 2))).astype(
            np.uint8)[:128]
        pairs.append((q, t))
        params.append(PARAM_SETS[i % 2])
        h0s.append(max(1, n // 2))
    _check(pairs, params, h0s, 64, 128)


def test_extend_batch_on_cpu_is_plain_and_uncounted(rng):
    from lordfast_tpu_torch.ops import affine_cuda

    pairs = [(rng.integers(0, 4, 40).astype(np.uint8),
              rng.integers(0, 4, 50).astype(np.uint8)) for _ in range(3)]
    qs, ts, cols = _inputs(pairs, [PARAM_SETS[1]] * 3, [40] * 3, 64, 64)
    args = (torch.from_numpy(qs), torch.from_numpy(ts), 64, 64, BW, W_MAX)
    kw = {k: torch.from_numpy(v) for k, v in cols.items()}
    before = affine_cuda.extend_batch_cuda.launches
    got = affine.extend_batch(*args, **kw)
    want, cells = affine.extend_batch_plain(*args, **kw, return_cells=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert affine_cuda.extend_batch_cuda.launches == before
    assert cells > 0
    with pytest.raises(ValueError):
        affine_cuda.extend_batch_cuda(*args[:4], W_MAX, **kw)
