"""Window voting in the PyTorch port (lordfast_tpu_torch/ops/voting.py)
against the JAX package's on the same seed tensors (made from a numpy
seed, with many equal vote counts so the tie order is exercised).  Every
CandidateBatch field must be equal exactly, min_score included (float32
of an integer divided by 4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.ops import fm_index as jfm
from lordfast_tpu.ops import voting as jvote
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.ops import fm_index as tfm
from lordfast_tpu_torch.ops import voting as tvote

CAND_FIELDS = ("win_id", "is_rev", "cnt", "valid", "is_fine", "min_score")


def make_seeds(rng, B, MS, max_n):
    """Seed slots filled contiguously per read (as locate fills them):
    clusters of votes around a few windows per read, equal weights
    common, so many windows tie."""
    lens = rng.integers(1000, 3000, B).astype(np.int32)
    lens[-1] = 0  # a padding row
    t_pos = np.zeros((B, MS), np.int32)
    q_pos = np.zeros((B, MS), np.int32)
    length = np.zeros((B, MS), np.int32)
    is_rev = np.zeros((B, MS), bool)
    n_total = rng.integers(0, max_n + 1, B).astype(np.int32)
    n_total[-1] = 0
    for b in range(B):
        n = min(int(n_total[b]), MS)
        loci = rng.integers(0, 60, 16)
        which = rng.integers(0, len(loci), n)
        rl = max(int(lens[b]), 1)
        t_pos[b, :n] = loci[which] * rl + rng.integers(0, 2 * rl, n)
        q_pos[b, :n] = rng.integers(0, rl, n)
        length[b, :n] = np.where(rng.random(n) < 0.6, 14,
                                 rng.integers(14, 20, n))
        is_rev[b, :n] = (which % 2) == 1
    valid = np.arange(MS)[None, :] < np.minimum(n_total, MS)[:, None]
    t_pos[~valid] = 0
    q_pos[~valid] = 0
    length[~valid] = 0
    is_rev[~valid] = False
    return (dict(t_pos=t_pos, q_pos=q_pos, length=length, is_rev=is_rev,
                 valid=valid, n_total=n_total,
                 n_anchors=np.minimum(n_total, 7)), lens)


def _both(fields, lens):
    js = jfm.SeedBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = tfm.SeedBatch(**{k: torch.from_numpy(np.array(v))
                          for k, v in fields.items()})
    return js, ts, jnp.asarray(lens), torch.from_numpy(lens)


def assert_cands_equal(got, want):
    for name in CAND_FIELDS:
        np.testing.assert_array_equal(
            got._asdict()[name].numpy(), np.asarray(want._asdict()[name]),
            err_msg=name)


@pytest.mark.parametrize("path", ["flat", "wide"])
@pytest.mark.parametrize("page", [None, 0, 1, 2])
def test_candidate_batch_matches_jax(path, page):
    rng = np.random.default_rng(100 + (page or 0))
    fields, lens = make_seeds(rng, 8, 256, 256)
    js, ts, jl, tl = _both(fields, lens)
    cfg = dict(max_candidates=4)
    if path == "flat":
        want = jvote._vote_windows_flat(js, jl, JCfg(**cfg), 4096, page)
        got = tvote._vote_windows_flat(ts, tl, TCfg(**cfg), 4096, page)
    else:
        want = jvote._vote_windows_wide(js, jl, JCfg(**cfg), page)
        got = tvote._vote_windows_wide(ts, tl, TCfg(**cfg), page)
    assert np.asarray(want.valid).any()
    assert_cands_equal(got, want)


def test_vote_windows_dispatch_matches_jax():
    """Batches past 131072 padded votes go through the dispatcher's
    total-vote check (flat path here)."""
    fields, lens = make_seeds(np.random.default_rng(7), 20, 4096, 300)
    js, ts, jl, tl = _both(fields, lens)
    want = jvote.vote_windows(js, jl, JCfg(max_candidates=16))
    got = tvote.vote_windows(ts, tl, TCfg(max_candidates=16))
    assert_cands_equal(got, want)
