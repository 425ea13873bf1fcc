"""Seeding in the PyTorch port (lordfast_tpu_torch/ops/fm_index.py) against
the JAX package (lordfast_tpu/ops/fm_index.py) on identical index arrays
and inputs made from a numpy seed.  Every output is an integer: the
tolerance is exact equality."""

import dataclasses
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.index.builder import build_index as j_build_index
from lordfast_tpu.ops import fm_index as jfm
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.index.container import FMIndex as TIndex
from lordfast_tpu_torch.ops import fm_index as tfm

DATA = Path(__file__).parent / "data"

torch.set_num_threads(2)


def port_index(jidx) -> TIndex:
    """The port's FMIndex over the same host arrays as a JAX FMIndex."""
    skip = {"_device", "_host_cache"}
    return TIndex(**{f.name: getattr(jidx, f.name)
                     for f in dataclasses.fields(jidx) if f.name not in skip})


def t2n(x):
    return x.cpu().numpy()


def assert_batches_equal(got, want, fields):
    for name in fields:
        np.testing.assert_array_equal(
            t2n(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=name)


@pytest.fixture(scope="module")
def sampled_index():
    """A random genome indexed with a sampled SA (interval 32), so locate
    walks the inverse-Psi chain."""
    r = np.random.default_rng(31)
    seq = "".join("ACGT"[c] for c in r.integers(0, 4, 30000))
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        f.write(">c\n" + seq + "\n")
        path = f.name
    idx = j_build_index(path, JCfg(kmer_cache_k=6, sa_interval=32),
                        verbose=False)
    assert idx.sa_intv == 32
    return idx


def _split_layout(idx, host):
    """The rank layout the kernels use when l_pac >= 2^32 (occ_cp +
    bwt_blocks instead of the fused fm_blocks rows)."""
    out = {k: v for k, v in host.items() if k != "fm_blocks"}
    out["occ_cp"] = idx.occ_cp
    out["bwt_blocks"] = idx.bwt_words.reshape(-1, 8)
    return out


@pytest.mark.parametrize("layout", ["fused", "split"])
def test_occ_and_backward_ext_match_jax(small_index, rng, layout):
    jidx, _ = small_index
    host = jidx.host_arrays()
    if layout == "split":
        host = _split_layout(jidx, host)
    jarrs = {k: jnp.asarray(v) for k, v in host.items()}
    tarrs = {k: torch.from_numpy(np.asarray(v).astype(np.int64)
                                 if v.dtype == np.uint32 else np.array(v))
             for k, v in host.items()}
    meta = jidx.meta
    n = jidx.seq_len
    ks = np.concatenate([
        np.array([-1, 0, jidx.primary - 1, jidx.primary, jidx.primary + 1,
                  n - 1, n]),
        rng.integers(0, n, 500)]).astype(np.int32)
    cs = rng.integers(0, 4, len(ks)).astype(np.int32)
    want = np.asarray(jfm.occ(jarrs, meta, jnp.asarray(ks), jnp.asarray(cs)))
    got = t2n(tfm.occ(tarrs, meta, torch.from_numpy(ks).long(),
                      torch.from_numpy(cs).long()))
    np.testing.assert_array_equal(got, want)

    lo = rng.integers(0, n, 300)
    hi = np.minimum(lo + rng.integers(0, 50, 300), n)
    c3 = rng.integers(0, 4, 300)
    jk, jl = jfm.backward_ext(jarrs, meta, jnp.asarray(lo, jnp.int32),
                              jnp.asarray(hi, jnp.int32),
                              jnp.asarray(c3, jnp.int32))
    tk, tl = tfm.backward_ext(tarrs, meta, torch.from_numpy(lo),
                              torch.from_numpy(hi), torch.from_numpy(c3))
    np.testing.assert_array_equal(t2n(tk), np.asarray(jk))
    np.testing.assert_array_equal(t2n(tl), np.asarray(jl))


@pytest.mark.parametrize("which", ["full_sa", "sampled_sa"])
def test_sa_lookup_matches_jax(small_index, sampled_index, which):
    jidx = small_index[0] if which == "full_sa" else sampled_index
    r = np.random.default_rng(5)
    # >= 2^16 lanes: the JAX walk takes its phased compaction path
    n = 1 << 16
    rows = r.integers(0, jidx.seq_len + 1, n).astype(np.int32)
    valid = r.random(n) < 0.4
    want = jfm.sa_lookup(jidx.device_arrays(), jidx.meta, jnp.asarray(rows),
                         jnp.asarray(valid))
    tidx = port_index(jidx)
    got = tfm.sa_lookup(tidx.device_arrays("cpu"), tidx.meta,
                        torch.from_numpy(rows), torch.from_numpy(valid))
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


def _noisy_reads(rng, idx, B, L):
    from lordfast_tpu_torch.utils.pack import unpack_pac

    fwd = unpack_pac(idx.pac, 0, idx.l_pac)
    reads = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(L // 2, L))
        st = int(rng.integers(0, idx.l_pac - ln))
        frag = fwd[st : st + ln].copy()
        if b % 2:
            frag = (3 - frag[::-1]).astype(np.uint8)
        sites = rng.integers(0, ln, ln // 10)
        frag[sites] = rng.integers(0, 4, len(sites))
        if b % 3 == 0:
            frag[rng.integers(0, ln)] = 4  # an N
        reads[b, :ln] = frag
        lens[b] = ln
    return reads, lens


SEED_FIELDS = ("t_pos", "q_pos", "length", "is_rev", "valid", "n_total",
               "n_anchors")


@pytest.mark.parametrize("which", ["full_sa", "sampled_sa"])
def test_seed_batch_matches_jax_small_index(small_index, sampled_index,
                                            which):
    jidx = small_index[0] if which == "full_sa" else sampled_index
    kw = dict(sampling_count=150, min_anchor_len=12, max_seeds_per_read=512,
              kmer_cache_k=jidx.kcache_k, seed_phase1_steps=3)
    reads, lens = _noisy_reads(np.random.default_rng(11), jidx, 6, 1500)
    want = jfm.seed_anchors(jidx.device_arrays(), jidx.meta, reads, lens,
                            JCfg(**kw))
    tidx = port_index(jidx)
    got = tfm.seed_anchors(tidx.device_arrays("cpu"), tidx.meta, reads,
                           lens, TCfg(**kw))
    assert int(np.asarray(want.n_total).sum()) > 0
    assert_batches_equal(got, want, SEED_FIELDS)


def test_seed_batch_matches_jax_golden_reads(ref8_idx):
    """The fixture reads as the engine batches them (length-sorted, padded
    to batch_reads rows), under the golden test's config."""
    from lordfast_tpu_torch.io.fastx import read_chunks
    from lordfast_tpu_torch.utils.pack import seq_to_codes

    kw = dict(kmer_cache_k=8, max_seeds_per_read=1024, max_chain_seeds=128,
              max_candidates=16)
    reads = [r for c in read_chunks(DATA / "reads.fq", 10**9) for r in c]
    reads = sorted((r for r in reads if len(r.seq) >= 1000),
                   key=lambda r: len(r.seq))[:64]
    B = 64
    L = 1024
    while L < max(len(r.seq) for r in reads):
        L *= 2
    arr = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for j, r in enumerate(reads):
        arr[j, : len(r.seq)] = seq_to_codes(r.seq)
        lens[j] = len(r.seq)
    want = jfm.seed_anchors(ref8_idx.device_arrays(), ref8_idx.meta, arr,
                            lens, JCfg(**kw))
    tidx = port_index(ref8_idx)
    got = tfm.seed_anchors(tidx.device_arrays("cpu"), tidx.meta, arr, lens,
                           TCfg(**kw))
    assert_batches_equal(got, want, SEED_FIELDS)
