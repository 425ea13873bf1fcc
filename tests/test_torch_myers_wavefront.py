"""A numpy model of the warp-per-gap schedule of csrc/myers.cu
(``myers_warp_kernel``, the wide buckets, W = Q/32 >= 16), held against
the port's plain versions (gap_dp.myers_dist_plain / myers_moves_plain)
and the JAX package's jnp kernel (gap_dp.gap_align) at W = 16, 64 and
128.  The card cannot run here, so the kernel's index arithmetic is
checked on this model first; its names follow the source.

The schedule, as the source note states it: lane l of a warp owns query
words [l*K, l*K + K), K = ceil(W / 32), with their Peq, Pv and Mv words.
At step s it runs column c = s - l over its K words, taking the carry
(hp, hm) into its first word from lane l - 1's carry out of the step
before (a shuffle up; lane 0 takes the top boundary +1).  Lanes above
lb = bw / K (bw the bottom row's word) do nothing, and the pipeline runs
tl + lb steps; lane lb keeps the score.  With the path, word w of column
c is stored at plane row c + w / K, so that one step's stores are
contiguous; the walk back fetches row r's word of the next 32 columns
with one load per lane and reads them by shuffle, reloading only when
r's word changes or the 32 columns are used up, and lane i keeps the
result of column cb - i of a 32-column window, whose moves and code
stores run once a window.  All outputs are integers: exact."""

import numpy as np
import pytest
import torch

from lordfast_tpu.ops import gap_dp as jgap
from lordfast_tpu_torch.ops import gap_dp as tgap

LANES = 32
M32 = np.uint32(0xFFFFFFFF)
INT_MAX = 2**31 - 1
OP_MATCH, OP_DELETE, OP_MISMATCH = 0, 2, 3


def _clz(z: int) -> int:
    return 32 - int(z).bit_length()


def warp_gap(q, t, W, T, shw, want_col=False, path=False):
    """One gap through the warp schedule: dist, end, col (2, W) or None,
    and with ``path`` lead and colcode (T,) uint16."""
    ql, tl = len(q), len(t)
    K = -(-W // LANES)
    bw, bb = (ql - 1) >> 5, (ql - 1) & 31
    lb, jb = divmod(bw, K)
    lane = np.arange(LANES)
    # Peq of lane l's words; rows >= ql read the padding code 4
    rows = np.full(LANES * K * 32, 4, np.uint8)
    rows[:ql] = q
    bits = rows.reshape(LANES, K, 32)[None] == np.arange(5)[:, None, None,
                                                           None]
    peq = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)                       # (5, LANES, K)
    pv = np.full((LANES, K), M32, np.uint32)
    mv = np.zeros((LANES, K), np.uint32)
    hout = np.zeros(LANES, np.uint32)               # bit 0 hp, bit 1 hm
    up = left = None
    if path:  # the wrapper's scratch: (T + 32) * W words a gap
        up = np.zeros((T + 32) * W, np.uint32)
        left = np.zeros_like(up)

    score, nw_dist, best, best_end = ql, INT_MAX, INT_MAX, -2
    w64 = (64 - ql % 64) % 64
    neg1_cap = min(w64, tl)
    neg1 = ql if w64 >= 1 else INT_MAX
    for s in range(tl + lb):
        hin = np.roll(hout, 1)                      # __shfl_up_sync(.., 1)
        c = s - lane
        act = (lane <= lb) & (c >= 0) & (c < tl)
        tc = t[np.clip(c, 0, tl - 1)]
        hp = np.where(lane == 0, 1, hin & 1).astype(np.uint32)
        hm = np.where(lane == 0, 0, hin >> 1).astype(np.uint32)
        for j in range(K):
            e = peq[tc, lane, j]
            p, m = pv[:, j].copy(), mv[:, j].copy()
            xv = e | m
            e2 = e | hm
            xh = (((e2 & p) + p) ^ p) | e2
            ph = m | ~(xh | p)
            mh = p & xh
            ph_s = (ph << 1) | hp
            mh_s = (mh << 1) | hm
            pv[:, j] = np.where(act, mh_s | ~(xv | ph_s), p)
            mv[:, j] = np.where(act, ph_s & xv, m)
            if path:
                at = s * W + lane * K + j
                up[at[act]] = pv[act, j]
                left[at[act]] = ph[act]
            if j == jb:
                ph_b, mh_b = int(ph[lb]), int(mh[lb])
            hp, hm = ph >> 31, mh >> 31
        hout = hp | (hm << 1)
        c = s - lb
        if 0 <= c < tl:                             # lane lb: the score
            score += ((ph_b >> bb) & 1) - ((mh_b >> bb) & 1)
            if c == tl - 1:
                nw_dist = score
            if score < best:
                best, best_end = score, c
            if c + 1 <= neg1_cap:
                neg1 = min(neg1, score + c + 1)
    if not shw:
        dist, end = nw_dist, tl - 1
    elif w64 >= 1 and neg1 <= best:
        dist, end = neg1, -1
    elif best_end == -2:
        dist, end = ql, -1
    else:
        dist, end = best, best_end
    out = {"dist": dist, "end": end}

    if want_col:
        col = np.zeros((2, W), np.uint32)
        low = (1 << (bb + 1)) - 1
        for w in range(W):
            keep = M32 if w < bw else (low if w == bw else 0)
            col[:, w] = pv[w // K, w % K] & keep, mv[w // K, w % K] & keep
        out["col"] = col
    if not path:
        return out

    def plane(c, w):  # word w of column c, stored at step c + w / K
        return (c + w // K) * W + w

    colcode = np.zeros(T, np.uint16)
    r = ql - 1
    cw, wr = 0, -1   # lane i holds row word wr of column cw - i
    upw = lfw = None
    for cb in range(end, -1, -LANES):  # lane i keeps column cb - i
        my_p = np.zeros(LANES, np.int64)
        my_run = np.zeros(LANES, np.int64)
        my_del = np.ones(LANES, bool)
        n = min(LANES, cb + 1)
        for i in range(n):
            c = cb - i
            p, lword = -1, 0
            if r >= 0:
                rw = r >> 5
                if rw != wr or cw - c >= LANES:     # one load per lane
                    cw, wr = c, rw
                    cc = c - lane
                    at = plane(np.maximum(cc, 0), rw)
                    upw = np.where(cc >= 0, up[at], 0)
                    lfw = np.where(cc >= 0, left[at], 0)
                u, lf = int(upw[cw - c]), int(lfw[cw - c])  # __shfl_sync
                rb = r & 31
                z = ~u & ((1 << (rb + 1)) - 1) & 0xFFFFFFFF
                if z:
                    p, lword = 32 * rw + 31 - _clz(z), lf
                else:
                    for w in range(rw - 1, -1, -1):
                        z = ~int(up[plane(c, w)]) & 0xFFFFFFFF
                        if z:
                            p = 32 * w + 31 - _clz(z)
                            lword = int(left[plane(c, w)])
                            break
            is_del = p < 0 or bool((lword >> (p & 31)) & 1)
            my_p[i], my_run[i], my_del[i] = p, r - p, is_del
            r = p if is_del else p - 1
        # the window's moves and code stores, one lane a column
        for i in range(n):
            c = cb - i
            move = (OP_DELETE if my_del[i] else
                    OP_MATCH if q[max(my_p[i], 0)] == t[c] else OP_MISMATCH)
            colcode[c] = move | (my_run[i] << 2)
    out.update(lead=r + 1, colcode=colcode)
    return out


def _gaps(rng, W, T, qls, tls):
    """Gaps of the given lengths: mutated-copy targets (related pairs)
    and every third one unrelated, packed for a (32 W, T) bucket."""
    Q = 32 * W
    pairs = []
    for i, (a, b) in enumerate(zip(qls, tls)):
        q = rng.integers(0, 4, a).astype(np.uint8)
        if i % 3 == 2:
            t = rng.integers(0, 4, b).astype(np.uint8)
        else:
            t = np.resize(q, b).copy()
            sites = rng.integers(0, b, max(1, b // 6))
            t[sites] = rng.integers(0, 4, len(sites))
        pairs.append((q, t))
    G = len(pairs)
    qs = np.full((G, Q), 4, np.uint8)
    ts = np.zeros((G, T), np.uint8)
    for g, (q, t) in enumerate(pairs):
        qs[g, : len(q)], ts[g, : len(t)] = q, t
    ql = np.array(qls, np.int32)
    tl = np.array(tls, np.int32)
    shw = (np.arange(G) % 2 == 1)
    return pairs, (qs, ql, ts, tl, shw)


def _edge_lengths(W, T):
    """ql at each lane boundary of the bottom word (32 K l and 32 K l +-
    1), at 64-row multiples +- 1 (the W64 term), 1 and Q; tl = 1, tl <
    32 (shorter than the skew), tl at T and between."""
    K = -(-W // LANES)
    Q = 32 * W
    qls = [1, Q, Q - 1, 63, 65, 64 * (W // 4) + 1]
    for l in range(1, min(W // K, LANES)):
        qls += [32 * K * l - 1, 32 * K * l, 32 * K * l + 1]
    qls = sorted({min(max(a, 1), Q) for a in qls})
    tl_cycle = [1, 5, 31, 33, T, T - 7, 17, 2]
    return qls, [tl_cycle[i % len(tl_cycle)] for i in range(len(qls))]


def _plain(arrays, Q, T, fn, **kw):
    out = fn(*(torch.from_numpy(a) for a in arrays), Q, T, **kw)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("W,T", [(16, 96), (64, 80), (128, 72)])
def test_warp_schedule_matches_plain_on_edges(W, T):
    rng = np.random.default_rng(W)
    qls, tls = _edge_lengths(W, T)
    pairs, arrays = _gaps(rng, W, T, qls, tls)
    Q = 32 * W
    dist, end, col = _plain(arrays, Q, T, tgap.myers_dist_plain,
                            want_col=True)
    m_dist, m_end, lead, colcode = _plain(arrays, Q, T,
                                          tgap.myers_moves_plain)
    np.testing.assert_array_equal(m_dist, dist)
    for g, (q, t) in enumerate(pairs):
        got = warp_gap(q, t, W, T, arrays[4][g], want_col=True, path=True)
        want = (dist[g], end[g], lead[g])
        assert (got["dist"], got["end"], got["lead"]) == want, (g, len(q),
                                                                len(t))
        np.testing.assert_array_equal(got["col"].view(np.int32), col[:, :, g],
                                      err_msg=f"gap {g}")
        np.testing.assert_array_equal(got["colcode"].view(np.int16),
                                      colcode[:, g], err_msg=f"gap {g}")


@pytest.mark.parametrize("W,T", [(16, 160), (64, 112), (128, 96)])
def test_warp_schedule_matches_jax_gap_align(W, T):
    # random lengths, long enough targets that the walk back reloads its
    # 32-column window; dist / end and the decoded moves equal the jnp
    # kernel's
    rng = np.random.default_rng(W + T)
    Q = 32 * W
    G = 10
    qls = list(rng.integers(1, Q + 1, G))
    tls = list(rng.integers(T // 2, T + 1, G))
    qls[:2] = [Q, min(Q, 100)]
    tls[:2] = [T, T - 3]
    pairs, arrays = _gaps(rng, W, T, qls, tls)
    ref = jgap.gap_align(*arrays, Q, T)
    want = jgap.unpack_moves(np.asarray(ref.moves_packed),
                             np.asarray(ref.mlen))
    for g, (q, t) in enumerate(pairs):
        got = warp_gap(q, t, W, T, arrays[4][g], path=True)
        assert (got["dist"], got["end"]) == (int(ref.dist[g]),
                                             int(ref.end[g])), g
        moves = tgap.decode_col_moves(got["colcode"][:, None],
                                      np.array([got["end"]]),
                                      np.array([got["lead"]]))[0]
        np.testing.assert_array_equal(moves, want[g], err_msg=f"gap {g}")


def test_warp_schedule_shw_negative_end():
    # SHW gaps where edlib's W64 term wins (end = -1) or ties, with ql
    # mod 64 in 1..63 at W = 64, against targets of 1..40 columns
    rng = np.random.default_rng(7)
    W, T = 64, 48
    qls = [1, 2, 33, 63, 65, 127, 1985, 2047, 1, 3]
    tls = [1, 40, 3, 1, 2, 40, 5, 9, 1, 1]
    pairs, arrays = _gaps(rng, W, T, qls, tls)
    arrays[4][:] = True
    dist, end, lead, colcode = _plain(arrays, 32 * W, T,
                                      tgap.myers_moves_plain)
    assert (end == -1).any()
    for g, (q, t) in enumerate(pairs):
        got = warp_gap(q, t, W, T, True, path=True)
        assert (got["dist"], got["end"], got["lead"]) == (dist[g], end[g],
                                                          lead[g]), g
        np.testing.assert_array_equal(got["colcode"].view(np.int16),
                                      colcode[:, g])
