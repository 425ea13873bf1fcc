"""The port's plain Myers fill with traceback (gap_dp.myers_moves_plain)
against the JAX package: the Pallas kernel in interpret mode
(gap_dp_pallas.gap_align_pl) on dist / end / lead / colcode, exactly, in
a non-tiled and the forced tiled bucket; and the decoded move arrays
against the jnp kernel (gap_dp.gap_align + unpack_moves).  All outputs
are integers: exact."""

import numpy as np
import pytest
import torch

from lordfast_tpu.ops import gap_dp as jgap
from lordfast_tpu.ops import gap_dp_pallas as jpl
from lordfast_tpu_torch.ops import gap_dp as tgap
from lordfast_tpu_torch.ops import gap_dp_cuda

from test_gap_dp import _random_pair
from test_torch_gap_dp import _boundary_pairs, _pack


def _moves(qs, ql, ts, tl, shw, Q, T):
    out = tgap.myers_moves_plain(
        *(torch.from_numpy(a) for a in (qs, ql, ts, tl, shw)), Q, T)
    return [x.numpy() for x in out]


def _check_against_pallas(qs, ql, ts, tl, shw, Q, T):
    dist, end, lead, colcode = _moves(qs, ql, ts, tl, shw, Q, T)
    ref = jpl.gap_align_pl(qs, ql, ts, tl, shw, Q, T, interpret=True)
    np.testing.assert_array_equal(dist, np.asarray(ref.dist))
    np.testing.assert_array_equal(end, np.asarray(ref.end))
    np.testing.assert_array_equal(lead, np.asarray(ref.lead))
    assert colcode.shape == (T, len(ql)) and colcode.dtype == np.int16
    np.testing.assert_array_equal(colcode.view(np.uint16),
                                  np.asarray(ref.colcode))
    return dist, end, lead, colcode


def _check_moves_against_jnp(qs, ql, ts, tl, shw, Q, T, dist, end, lead,
                             colcode):
    ref = jgap.gap_align(qs, ql, ts, tl, shw, Q, T)
    want = jgap.unpack_moves(np.asarray(ref.moves_packed),
                             np.asarray(ref.mlen))
    got = tgap.decode_col_moves(colcode, end, lead)
    np.testing.assert_array_equal(dist, np.asarray(ref.dist))
    for g in range(len(ql)):
        np.testing.assert_array_equal(got[g], want[g], err_msg=f"gap {g}")


def test_moves_plain_matches_pallas_untiled(rng):
    # related and unrelated pairs, ql at the word boundaries (1, 31..65),
    # tl = 1, the W64 negative end, NW and SHW mixed, in a W = 4 bucket
    Q, T = 128, 160
    pairs = [_random_pair(rng, Q, T) for _ in range(14)]
    pairs += _boundary_pairs(rng, [1, 31, 32, 33, 63, 64, 65, 96, 127, 128])
    pairs += [(np.array([0], np.uint8), np.array([1, 1, 1], np.uint8)),
              (rng.integers(0, 4, 40).astype(np.uint8),
               np.array([2], np.uint8)),
              (np.array([3], np.uint8), np.array([3], np.uint8))]
    pairs = [(q, t[:T]) for q, t in pairs]
    G = len(pairs)
    shw = rng.integers(0, 2, G).astype(bool)
    shw[-3] = True
    qs, ql, ts, tl = _pack(pairs, Q, T)
    out = _check_against_pallas(qs, ql, ts, tl, shw, Q, T)
    # the negative-end case: no column, lead = ql
    assert (out[0][-3], out[1][-3], out[2][-3]) == (1, -1, 1)
    assert not out[3][:, -3].any()
    _check_moves_against_jnp(qs, ql, ts, tl, shw, Q, T, *out)


def test_moves_plain_matches_pallas_tiled(rng):
    # Q=512, T=592: T*W = 9472 > 9216 forces the tiled Pallas kernel
    Q, T = 512, 592
    assert T * (Q // 32) > 9216
    pairs = []
    for n in (512, 450, 401):
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = np.resize(q, min(T, n + int(rng.integers(-40, 80)))).copy()
        sites = rng.integers(0, len(t), len(t) // 9)
        t[sites] = rng.integers(0, 4, len(sites))
        pairs.append((q, t))
    pairs.append((rng.integers(0, 5, 33).astype(np.uint8),
                  rng.integers(0, 5, 590).astype(np.uint8)))  # N codes
    G = len(pairs)
    shw = np.array([False, True, True, True])
    qs, ql, ts, tl = _pack(pairs, Q, T)
    out = _check_against_pallas(qs, ql, ts, tl, shw, Q, T)
    _check_moves_against_jnp(qs, ql, ts, tl, shw, Q, T, *out)


def test_moves_equal_edlib_paths_below_hirschberg_size(rng):
    # below edlib's Hirschberg size the in-kernel traceback's path is the
    # one the host stitcher's nw_align (edlib's banded traceback) builds,
    # ties included: junk pairs (many equal-cost paths) and related ones
    from lordfast_tpu_torch.align import edlib_eq as ted
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    Q, T = 512, 600
    pairs = [_random_pair(rng, Q, T, related=g % 2 == 0) for g in range(24)]
    pairs += [(rng.integers(0, 4, 500).astype(np.uint8),
               rng.integers(0, 4, 600).astype(np.uint8))]
    assert not any(MappingEngine._edlib_splits(len(q), len(t))
                   for q, t in pairs)
    qs, ql, ts, tl = _pack(pairs, Q, T)
    shw = np.zeros(len(pairs), bool)
    dist, end, lead, colcode = _moves(qs, ql, ts, tl, shw, Q, T)
    got = tgap.decode_col_moves(colcode, end, lead)
    for g, (q, t) in enumerate(pairs):
        d, mv = ted.nw_path(q, t)
        assert dist[g] == d
        np.testing.assert_array_equal(got[g], mv, err_msg=f"pair {g}")


def test_myers_moves_on_cpu_runs_plain_without_counting(rng):
    pairs = [_random_pair(rng, 30, 45) for _ in range(7)]
    qs, ql, ts, tl = _pack(pairs, 32, 48)
    shw = rng.integers(0, 2, len(pairs)).astype(bool)
    before = gap_dp_cuda.myers_moves.launches
    got = gap_dp_cuda.myers_moves(
        *(torch.from_numpy(a) for a in (qs, ql, ts, tl, shw)), 32, 48)
    want = _moves(qs, ql, ts, tl, shw, 32, 48)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert gap_dp_cuda.myers_moves.launches == before
    # dist/end equal the distance-only version's
    d, e = tgap.myers_dist_plain(
        *(torch.from_numpy(a) for a in (qs, ql, ts, tl, shw)), 32, 48)
    np.testing.assert_array_equal(d.numpy(), want[0])
    np.testing.assert_array_equal(e.numpy(), want[1])


def _last_column(q, t):
    """D(r, len(t)-1), r = 0..len(q)-1, of the plain edit-distance DP."""
    col = np.arange(1, len(q) + 1)
    for c in range(len(t)):
        prev, col = col, np.empty_like(col)
        up = c + 1                                 # D(-1, c)
        for r in range(len(q)):
            diag = (c if r == 0 else prev[r - 1]) + (q[r] != t[c])
            up = col[r] = min(diag, prev[r] + 1, up + 1)
    return col


def test_last_column_scores_equal_dp(rng):
    # the words myers_dist keeps for edlib's Hirschberg split: ql at the
    # word boundaries, tl = 1, N codes, in a W = 4 bucket
    Q, T = 128, 160
    pairs = [_random_pair(rng, Q, T) for _ in range(6)]
    pairs += _boundary_pairs(rng, [1, 31, 32, 33, 64, 127, 128])
    pairs += [(rng.integers(0, 5, 70).astype(np.uint8),
               rng.integers(0, 5, 1).astype(np.uint8))]
    pairs = [(q, t[:T]) for q, t in pairs]
    qs, ql, ts, tl = _pack(pairs, Q, T)
    shw = np.zeros(len(pairs), bool)
    args = [torch.from_numpy(a) for a in (qs, ql, ts, tl, shw)]
    dist, end, col = tgap.myers_dist_plain(*args, Q, T, want_col=True)
    assert col.shape == (2, Q // 32, len(pairs)) and col.dtype == torch.int32
    d0, e0 = tgap.myers_dist_plain(*args, Q, T)
    assert torch.equal(dist, d0) and torch.equal(end, e0)
    for g, (q, t) in enumerate(pairs):
        got = tgap.column_scores(col[:, :, g].numpy(), len(q), len(t))
        np.testing.assert_array_equal(got, _last_column(q, t),
                                      err_msg=f"pair {g}")
        # bits of rows >= ql are clear
        words = np.ascontiguousarray(col[:, :, g].numpy())
        bits = np.unpackbits(words.view(np.uint8).reshape(2, -1), axis=1,
                             bitorder="little")
        assert not bits[:, len(q):].any()


@pytest.mark.parametrize("G", [0, 1])
def test_moves_plain_degenerate_batch(G):
    qs = np.full((G, 32), 4, np.uint8)
    qs[:, 0] = 1
    ts = np.ones((G, 48), np.uint8)
    ql = np.ones(G, np.int32)
    tl = np.ones(G, np.int32)
    dist, end, lead, colcode = _moves(qs, ql, ts, tl, np.zeros(G, bool),
                                      32, 48)
    assert colcode.shape == (48, G)
    if G:
        # one matching base: one MATCH column, no inserts
        assert (dist[0], end[0], lead[0], colcode[0, 0]) == (0, 0, 0,
                                                             tgap.OP_MATCH)
