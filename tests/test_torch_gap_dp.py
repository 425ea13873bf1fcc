"""Gap DP in the PyTorch port (lordfast_tpu_torch/ops/gap_dp.py and the
CUDA wrapper gap_dp_cuda.py) against the JAX package: the sequence
gather, and the plain Myers distance against the jnp kernel
(gap_dp.gap_align) and the Pallas kernel in interpret mode
(gap_dp_pallas.gap_align_pl).  Distances and ends are integers: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lordfast_tpu.ops import gap_dp as jgap
from lordfast_tpu.ops import gap_dp_pallas as jpl
from lordfast_tpu_torch.ops import gap_dp as tgap
from lordfast_tpu_torch.ops import gap_dp_cuda

from test_gap_dp import _random_pair


def _pack(pairs, Q, T):
    G = len(pairs)
    qs = np.full((G, Q), 4, np.uint8)
    ts = np.zeros((G, T), np.uint8)
    ql = np.zeros(G, np.int32)
    tl = np.zeros(G, np.int32)
    for g, (q, t) in enumerate(pairs):
        qs[g, : len(q)] = q
        ts[g, : len(t)] = t
        ql[g], tl[g] = len(q), len(t)
    return qs, ql, ts, tl


def _plain(qs, ql, ts, tl, shw, Q, T):
    d, e = tgap.myers_dist_plain(
        *(torch.from_numpy(a) for a in (qs, ql, ts, tl, shw)), Q, T)
    return d.numpy(), e.numpy()


def _boundary_pairs(rng, sizes):
    pairs = []
    for s in sizes:
        q = rng.integers(0, 4, s).astype(np.uint8)
        t = rng.integers(0, 4, max(1, s + int(rng.integers(-8, 10))))
        pairs.append((q, t.astype(np.uint8)))
    return pairs


@pytest.mark.parametrize("mode", ["nw", "shw", "mixed"])
def test_plain_matches_jnp_kernel(rng, mode):
    # random related pairs plus ql at 32-bit word boundaries (carry
    # chains, the W64 artifact) in a W = 4 bucket
    pairs = [_random_pair(rng, 120, 150) for _ in range(24)]
    pairs += _boundary_pairs(rng, [1, 31, 32, 33, 63, 64, 65, 96, 127, 128])
    G, Q, T = len(pairs), 128, 160
    shw = {"nw": np.zeros(G, bool), "shw": np.ones(G, bool),
           "mixed": rng.integers(0, 2, G).astype(bool)}[mode]
    qs, ql, ts, tl = _pack(pairs, Q, T)
    ref = jgap.gap_align(qs, ql, ts, tl, shw, Q, T)
    dist, end = _plain(qs, ql, ts, tl, shw, Q, T)
    np.testing.assert_array_equal(dist, np.asarray(ref.dist))
    np.testing.assert_array_equal(end, np.asarray(ref.end))


@pytest.mark.parametrize("Q,T", [(32, 48), (64, 96), (128, 160)])
def test_plain_matches_pallas_interpret(rng, Q, T):
    pairs = [_random_pair(rng, Q, T) for _ in range(12)]
    pairs += _boundary_pairs(rng, [s for s in (1, 31, 32, 33, 63, 64, 65)
                                   if s <= Q])
    pairs = [(q, t[:T]) for q, t in pairs]
    G = len(pairs)
    shw = (np.arange(G) % 2).astype(bool)
    qs, ql, ts, tl = _pack(pairs, Q, T)
    ref = jpl.gap_align_pl(qs, ql, ts, tl, shw, Q, T, interpret=True)
    dist, end = _plain(qs, ql, ts, tl, shw, Q, T)
    np.testing.assert_array_equal(dist, np.asarray(ref.dist))
    np.testing.assert_array_equal(end, np.asarray(ref.end))


def test_plain_negative_end_artifact():
    # edlib's W64 negative end: one query base against a mismatching
    # target scores best at position -1
    qs, ql, ts, tl = _pack([(np.array([0], np.uint8),
                             np.array([1, 1, 1], np.uint8))], 32, 48)
    shw = np.ones(1, bool)
    ref = jgap.gap_align(qs, ql, ts, tl, shw, 32, 48)
    dist, end = _plain(qs, ql, ts, tl, shw, 32, 48)
    assert (dist[0], end[0]) == (int(ref.dist[0]), int(ref.end[0])) == (1, -1)


def test_plain_matches_jnp_kernel_large_bucket(rng):
    # the (2048, 2176) bucket (W = 64), where the TPU runs the tiled
    # Pallas kernel
    Q, T = 2048, 2176
    pairs = []
    for n in (2048, 1500, 65):
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = np.resize(q, min(T, n + 40)).copy()
        sites = rng.integers(0, len(t), len(t) // 9)
        t[sites] = rng.integers(0, 4, len(sites))
        pairs.append((q, t))
    shw = np.array([False, True, True])
    qs, ql, ts, tl = _pack(pairs, Q, T)
    ref = jgap.gap_align(qs, ql, ts, tl, shw, Q, T)
    dist, end = _plain(qs, ql, ts, tl, shw, Q, T)
    np.testing.assert_array_equal(dist, np.asarray(ref.dist))
    np.testing.assert_array_equal(end, np.asarray(ref.end))


def test_gather_gap_seqs_matches_jax(small_index, rng):
    jidx, _ = small_index
    pac = jidx.host_arrays()["pac_words"]
    B, L, G, Q, T = 5, 700, 64, 64, 96
    reads = rng.integers(0, 5, (B, L)).astype(np.uint8)
    l_pac = jidx.l_pac
    desc = {
        "q_read": rng.integers(0, B, G).astype(np.int32),
        "q_start": rng.integers(-5, L - 10, G).astype(np.int32),
        "q_len": rng.integers(1, Q + 1, G).astype(np.int32),
        "q_rc": rng.random(G) < 0.5,
        # starts before 0 and past l_pac exercise the 'A' padding
        "t_start": rng.integers(-40, l_pac + 20, G).astype(np.int64),
        "t_len": rng.integers(1, T + 1, G).astype(np.int32),
        "t_rc": rng.random(G) < 0.5,
        "is_shw": rng.random(G) < 0.5,
        "valid": rng.random(G) < 0.9,
    }
    want = jgap.gather_gap_seqs(jnp.asarray(pac), jnp.asarray(reads),
                                {k: jnp.asarray(v) for k, v in desc.items()},
                                Q, T, l_pac)
    got = tgap.gather_gap_seqs(
        torch.from_numpy(pac.astype(np.int64)), torch.from_numpy(reads),
        {k: torch.from_numpy(v) for k, v in desc.items()}, Q, T, l_pac)
    for name, g, w in zip(("qs", "ql", "ts", "tl"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_myers_dist_on_cpu_runs_plain_without_counting(rng):
    pairs = [_random_pair(rng, 60, 90) for _ in range(9)]
    qs, ql, ts, tl = _pack(pairs, 64, 96)
    shw = rng.integers(0, 2, len(pairs)).astype(bool)
    before = gap_dp_cuda.myers_dist.launches
    d, e = gap_dp_cuda.myers_dist(
        *(torch.from_numpy(a) for a in (qs, ql, ts, tl, shw)), 64, 96)
    want = _plain(qs, ql, ts, tl, shw, 64, 96)
    np.testing.assert_array_equal(d.numpy(), want[0])
    np.testing.assert_array_equal(e.numpy(), want[1])
    assert gap_dp_cuda.myers_dist.launches == before

