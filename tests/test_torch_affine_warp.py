"""A numpy model of the warp-per-problem ksw_extend2 of csrc/affine_ext.cu
(``affine_warp_kernel``), held against the port's plain version
(affine.extend_batch_plain, at BW = 256) and the JAX package's Pallas
kernel (affine_pl.extend_batch, interpret mode) at w_max = 15, 40 and
100, that is K = 1, 3 and 7 band slots a lane.  The card cannot run
here, so the kernel's index arithmetic is checked on this model first;
its names follow the source.

The layout, as the source note states it: one warp per problem, BW =
32 K band slots, K = ceil((2 w_max + 2) / 32); at target row i slot k
holds query column j = i - w_max + k, and lane l owns the K slots [l K,
l K + K) as registers (Hband, Eband, qband).  The F chain is the
exclusive prefix max of A_k = max(M_k - oe_ins, 0) + k e_ins: an
in-lane scan over the K slots, then a 5-step __shfl_up_sync scan of
the lane totals.  Five warp reductions give the row max rm, its last
column rmj, the last cell's h_last and the shrink's first_nz / last_nz.
Per row H, E and the query band move up one slot: in registers, and
one __shfl_down_sync across the lanes; lane 31's top slot takes the
entering column.  Target bytes and entering query codes come in
windows of 32 rows, one byte a lane, passed on by __shfl_sync.  All
outputs are integers: exact."""

import numpy as np
import pytest
import torch

from chip_smoke import lane_edge_bands
from lordfast_tpu.ops import affine_pl
from lordfast_tpu_torch.ops import affine

from test_affine_pl import PARAM_SETS, _mutate

LANES = 32
NEG_BIG, POS_BIG = affine.NEG_BIG, affine.POS_BIG
NAMES = affine.ExtendResult._fields


def slots_per_lane(w_max: int) -> int:
    return -(-(2 * w_max + 2) // LANES)


def shfl_down(x, d):
    """__shfl_down_sync(full, x, d): lane l takes lane l + d's value;
    lanes past the top keep their own."""
    out = x.copy()
    out[:-d] = x[d:]
    return out


def shfl_up(x, d):
    """__shfl_up_sync(full, x, d): lane l takes lane l - d's value; lanes
    below d keep their own."""
    out = x.copy()
    out[d:] = x[:-d]
    return out


def warp_extend(q, t, w_max, p, scan_steps=(1, 2, 4, 8, 16)):
    """One problem through the warp layout: the six outputs.  q / t are
    the problem's codes (qlen / tlen long), p its parameters; scan_steps
    the shuffle distances of the lane-total scan."""
    K = slots_per_lane(w_max)
    BW = LANES * K
    qlen, tlen = len(q), len(t)
    o_del, e_del, o_ins, e_ins = p["o_del"], p["e_del"], p["o_ins"], p["e_ins"]
    w_eff, zdrop, h0 = p["w_eff"], p["zdrop"], p["h0"]
    match, mismatch = p["match"], p["mismatch"]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    lane = np.arange(LANES)
    k = lane[:, None] * K + np.arange(K)[None, :]   # (LANES, K) slot

    h1v = max(h0 - oe_ins, 0)

    def init_decay(j):
        return np.where(j <= 0, h0, np.maximum(h1v - (j - 1) * e_ins, 0))

    def query_at(j):  # a guarded byte load: code 4 outside [0, qlen)
        j = np.asarray(j)
        inside = (j >= 0) & (j < qlen)
        return np.where(inside, q[np.clip(j, 0, max(qlen - 1, 0))], 4) \
            if qlen else np.full(j.shape, 4)

    j_init = k - w_max
    Hband = np.where((j_init >= 0) & (j_init <= qlen), init_decay(j_init), 0)
    Eband = np.zeros((LANES, K), np.int64)
    qband = query_at(j_init)
    beg, end = 0, qlen
    best, best_i, best_j, best_ie, gscore, moff = h0, -1, -1, -1, -1, 0
    tw = qw = None
    for i in range(tlen):
        if i % LANES == 0:  # one byte a lane for the next 32 rows
            rows = i + lane
            tw = np.where(rows < tlen, t[np.minimum(rows, tlen - 1)], 4)
            qw = query_at(rows + BW - w_max)   # fill_col of row i + lane
        t_i = int(tw[i % LANES])                  # __shfl_sync
        j = i - w_max + k
        beg_r = max(beg, i - w_eff)
        end_r = min(end, i + w_eff + 1, qlen)
        in_band = (j >= beg_r) & (j < end_r)
        h1_init = max(h0 - (o_del + e_del * (i + 1)), 0) if beg_r == 0 else 0
        s = np.where((qband >= 4) | (t_i >= 4), 0,
                     np.where(qband == t_i, match, -mismatch))
        M = np.where((Hband != 0) & in_band, Hband + s, 0)
        # F chain: in-lane inclusive scan, then the lanes' totals
        A = np.where(in_band, np.maximum(M - oe_ins, 0) + k * e_ins, NEG_BIG)
        incl = np.maximum.accumulate(A, axis=1)
        tot = incl[:, -1].copy()
        for d in scan_steps:
            v = shfl_up(tot, d)
            tot = np.where(lane >= d, np.maximum(tot, v), tot)
        lane_excl = np.where(lane == 0, NEG_BIG, shfl_up(tot, 1))
        p_excl = np.concatenate(
            [lane_excl[:, None],
             np.maximum(lane_excl[:, None], incl[:, :-1])], axis=1)
        f = np.maximum(p_excl - (k - 1) * e_ins, 0)
        h = np.where(in_band, np.maximum(np.maximum(M, Eband), f), 0)
        # the row's reductions
        rm = int(h.max())                                   # reduce_max
        rmj = int(np.where(in_band & (h == rm) & (rm > 0), j, -1).max())
        h_last = int(np.where(j == end_r - 1, h, NEG_BIG).max())
        loop_ran = beg_r < end_r
        h_after = h_last if loop_ran else h1_init
        reach = (end_r if loop_ran else beg_r) == qlen
        if reach and h_after >= gscore:
            gscore, best_ie = h_after, i
        if rm == 0:
            break
        if rm > best:
            moff = max(moff, abs(rmj - i))
            best, best_i, best_j = rm, i, rmj
        elif zdrop > 0:
            di, dj = i - best_i, rmj - best_j
            if di > dj:
                drop = best - rm - (di - dj) * e_del
            else:
                drop = best - rm - (dj - di) * e_ins
            if drop > zdrop:
                break
        # next row: H, E and the query band move up one slot
        fill_col = i + BW - w_max
        h_fill = int(init_decay(fill_col)) if fill_col <= qlen else 0
        q_fill = int(qw[i % LANES])                         # __shfl_sync
        j_next = j + 1
        hrow_eff = np.where(j == beg_r - 1, h1_init, h)
        upd_h = (j_next >= beg_r) & (j_next <= end_r)
        h_up = np.where(lane == LANES - 1, h_fill, shfl_down(Hband[:, 0], 1))
        shifted = np.concatenate([Hband[:, 1:], h_up[:, None]], axis=1)
        Hband = np.where(upd_h, hrow_eff, shifted)
        Erec = np.maximum(Eband - e_del, np.maximum(M - oe_del, 0))
        Enew = np.where(in_band, Erec, np.where(j == end_r, 0, Eband))
        e_up = np.where(lane == LANES - 1, 0, shfl_down(Enew[:, 0], 1))
        Eband = np.concatenate([Enew[:, 1:], e_up[:, None]], axis=1)
        q_up = np.where(lane == LANES - 1, q_fill, shfl_down(qband[:, 0], 1))
        qband = np.concatenate([qband[:, 1:], q_up[:, None]], axis=1)
        # the dead-cell shrink, on the next row's slots (column j_next)
        nz = (Hband != 0) | (Eband != 0)
        m_f = (j_next >= beg_r) & (j_next < end_r)
        first_nz = int(np.where(m_f & nz, j_next, POS_BIG).min())
        beg2 = end_r if first_nz == POS_BIG else first_nz
        m_b = (j_next >= beg2) & (j_next <= end_r)
        last_nz = int(np.where(m_b & nz, j_next, NEG_BIG).max())
        if last_nz == NEG_BIG:
            last_nz = beg2 - 1
        beg, end = beg2, min(last_nz + 2, qlen)
    return (best, best_j + 1, best_i + 1, best_ie + 1, gscore, moff)


def _problems(rng, w_max, Qe, Te, G):
    """G problems in a (Qe, Te) bucket: the clip and split parameter sets
    (band min(w, w_max)) mixed in one launch, related pairs with indels,
    junk with N codes, z-drop cases (a related half, then junk), qlen =
    Qe, tlen = 0 and 1, short queries (band clamp), and w_eff on lane
    edges.  Returns (qs, ts, params, pairs)."""
    edges = lane_edge_bands(w_max)
    K = slots_per_lane(w_max)
    pairs, cols = [], []
    for g in range(G):
        kind = g % 6
        n = Qe if g < 2 else int(rng.integers(1, Qe + 1))
        if g in (2, 3):
            n = int(rng.integers(1, 4))
        q = rng.integers(0, 5 if kind == 1 else 4, n).astype(np.uint8)
        if kind == 5 and n > 2 * w_max:
            # a deletion of d, then an insertion of d + w_max: the F run
            # that crosses from offset -d to +w_max spans 16 lanes, the
            # last step of the lane-total scan
            d = max(LANES // 2 * K - w_max, 1)
            a = int(rng.integers(w_max // 2, n - d - w_max))
            t = np.concatenate([q[:a], rng.integers(0, 4, d),
                                q[a + d + w_max:]])
        elif kind == 0:
            t = _mutate(q, rng, err=0.12)
        elif kind == 1:
            t = rng.integers(0, 5, int(rng.integers(1, Te + 1)))
        elif kind == 2:
            t = np.concatenate([_mutate(q[: n // 2], rng, err=0.1),
                                rng.integers(0, 4, Te)])
        elif kind == 3:
            t = _mutate(q, rng, err=0.3)
        else:
            t = np.resize(q, int(rng.integers(1, Te + 1)))
        t = t[: [0, 1][g % 2] if g in (4, 5) else Te].astype(np.uint8)
        od, ed_, oi, ei, w, zd = PARAM_SETS[g % 2]
        w_eff = int(affine.clamp_band(n, 2, 0, od, ed_, oi, ei, min(w, w_max)))
        if g >= 6 and g % 3 == 0:      # a lane-edge band
            w_eff = edges[(g // 3) % len(edges)]
        pairs.append((q, t))
        cols.append(dict(qlen=n, tlen=len(t), o_del=od, e_del=ed_, o_ins=oi,
                         e_ins=ei, w_eff=w_eff, zdrop=zd, h0=n, match=2,
                         mismatch=16))
    qs = np.zeros((G, Qe), np.uint8)
    ts = np.zeros((G, Te), np.uint8)
    for g, (q, t) in enumerate(pairs):
        qs[g, : len(q)], ts[g, : len(t)] = q, t
    params = {name: np.array([c[name] for c in cols], np.int32)
              for name in cols[0]}
    return qs, ts, params, pairs


def _model(pairs, params, w_max):
    out = []
    for g, (q, t) in enumerate(pairs):
        p = {name: int(v[g]) for name, v in params.items()}
        out.append(warp_extend(q, t, w_max, p))
    return np.array(out, np.int64).T      # (6, G)


def _plain(qs, ts, params, Qe, Te, BW, w_max):
    res = affine.extend_batch_plain(
        torch.from_numpy(qs), torch.from_numpy(ts), Qe, Te, BW, w_max,
        **{name: torch.from_numpy(v) for name, v in params.items()})
    return np.stack([r.numpy() for r in res])


@pytest.mark.parametrize("w_max", [15, 40, 100])
def test_warp_model_matches_plain(w_max):
    Qe, Te = 384, 416
    rng = np.random.default_rng(w_max)
    qs, ts, params, pairs = _problems(rng, w_max, Qe, Te, 24)
    want = _plain(qs, ts, params, Qe, Te, 256, w_max)
    got = _model(pairs, params, w_max)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the plain version at the kernel's BW = 32 K slots gives the same
    K = slots_per_lane(w_max)
    np.testing.assert_array_equal(
        _plain(qs, ts, params, Qe, Te, LANES * K, w_max), want)
    assert (params["tlen"] == 0).any() and (params["qlen"] == Qe).any()
    assert (want[2] < params["tlen"]).any()       # some break early


@pytest.mark.parametrize("w_max", [15, 40, 100])
def test_warp_model_lane_edges(w_max):
    # every band whose edge lands on a lane boundary, on related pairs
    # long enough that the band slides over all of its slots
    rng = np.random.default_rng(1000 + w_max)
    edges = lane_edge_bands(w_max)
    Qe, Te = 256, 288
    pairs, rows = [], []
    for g, w_eff in enumerate(edges):
        n = int(rng.integers(Qe // 2, Qe + 1))
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = _mutate(q, rng, err=0.15)[:Te]
        od, ed_, oi, ei, _, zd = PARAM_SETS[g % 2]
        pairs.append((q, t))
        rows.append((n, len(t), od, ed_, oi, ei, w_eff, zd, n, 2, 16))
    names = ("qlen", "tlen", "o_del", "e_del", "o_ins", "e_ins", "w_eff",
             "zdrop", "h0", "match", "mismatch")
    params = {name: np.array(col, np.int32)
              for name, col in zip(names, zip(*rows))}
    qs = np.zeros((len(pairs), Qe), np.uint8)
    ts = np.zeros((len(pairs), Te), np.uint8)
    for g, (q, t) in enumerate(pairs):
        qs[g, : len(q)], ts[g, : len(t)] = q, t
    want = _plain(qs, ts, params, Qe, Te, 256, w_max)
    got = _model(pairs, params, w_max)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("w_max", [15, 40, 100])
def test_warp_model_matches_pallas(w_max):
    Qe, Te = 96, 128
    rng = np.random.default_rng(2000 + w_max)
    qs, ts, params, pairs = _problems(rng, w_max, Qe, Te, 12)
    res = affine_pl.extend_batch(qs, ts, Qe, Te, 256, w_max, interpret=True,
                                 **params)
    got = _model(pairs, params, w_max)
    for name, a in zip(NAMES, got):
        np.testing.assert_array_equal(a, np.asarray(getattr(res, name)),
                                      err_msg=name)


# Found by a random search over block-structured pairs (related, deleted,
# inserted and junk blocks): an F run at w_max = 15 (K = 1) that crosses
# 16 lanes in one row, where the scan's last step (distance 16) decides
# the score and gscore.
FAR_F_Q = ("1133101210320203020111002211230313020220333122033103333011101322"
           "2303333022121020120131311230123201201221023022212210012220310031"
           "33321010200331012013011111333201311102332103103201")
FAR_F_T = ("1133101210320203020303303120233013111002211230313020322230333302"
           "2121020120131300202203233222303301010332320213010221222313011033"
           "2301010320323133302023212130202201003131232220020012103331102211"
           "1132103101113121201021300030")


def test_warp_model_far_f_run():
    q = np.array([int(c) for c in FAR_F_Q], np.uint8)
    t = np.array([int(c) for c in FAR_F_T], np.uint8)
    w_max, Qe, Te = 15, 192, 224
    p = dict(qlen=len(q), tlen=len(t), o_del=8, e_del=1, o_ins=4, e_ins=1,
             w_eff=15, zdrop=200, h0=266, match=2, mismatch=16)
    params = {name: np.array([v], np.int32) for name, v in p.items()}
    qs = np.zeros((1, Qe), np.uint8)
    ts = np.zeros((1, Te), np.uint8)
    qs[0, : len(q)], ts[0, : len(t)] = q, t
    want = _plain(qs, ts, params, Qe, Te, 256, w_max)[:, 0]
    got = _model([(q, t)], params, w_max)[:, 0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _plain(qs, ts, params, Qe, Te, LANES, w_max)[:, 0], want)
    res = affine_pl.extend_batch(qs, ts, Qe, Te, 256, w_max, interpret=True,
                                 **params)
    np.testing.assert_array_equal(
        got, [int(np.asarray(getattr(res, n))[0]) for n in NAMES])
    scalars = {name: int(v[0]) for name, v in params.items()}
    short = warp_extend(q, t, w_max, scalars, scan_steps=(1, 2, 4, 8))
    assert short != tuple(got)
