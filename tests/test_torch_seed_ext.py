"""A numpy model of the seed-extension kernel (lordfast_tpu_torch/csrc/
seed_ext.cu ``seed_ext_kernel``, names as there) against the port's plain
version (ops/fm_index.py ``_staged_ext``) and, through the seeds it leads
to, the JAX package's seeding.

The model runs every lane as the kernel's thread does, all lanes in step
as a warp issues them, each in its own phase: blocks of phase1_steps
greedy steps (two occ queries each, on the rank rows of the index's
layout, reading only the BWT words up to the row's word), the one-row
check at the end of each block only, then the walk to a sampled SA row
(or the full SA's gather) and the char by char comparison against the
packed text.  Cases: golden's first batch (the k = 8 index of tests/data,
full SA), noisy reads of the small index with the full SA and with
sa_intv 32, each in the fused rank layout and the split one (occ_cp +
bwt_blocks, as for l_pac >= 2^32).  Every output is an integer: the
model's per-lane (k, l, m, rpos, rflag) must equal _staged_ext's
exactly, and the seeds computed with the model in its place must equal
the JAX package's."""

import numpy as np
import pytest
import torch

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.ops import fm_index as jfm
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.ops import fm_index as tfm
from lordfast_tpu_torch.ops import fm_index_cuda

from test_golden import TEST_CFG
from test_torch_engine import _first_batch
from test_torch_fm_index import (SEED_FIELDS, _noisy_reads, _split_layout,
                                 assert_batches_equal, port_index,
                                 sampled_index)

torch.set_num_threads(2)

K_MAX_ANCHOR = 4095
PH_EXT, PH_WALK, PH_CMP, PH_DONE = 0, 1, 2, 3


def _match(w, c):
    """Per-char match bits of uint32 BWT words w for chars c."""
    hi = np.where((c & 2) != 0, w, ~w)
    lo = np.where((c & 1) != 0, w, ~w)
    return (hi >> np.uint32(1)) & lo & np.uint32(0x55555555)


class Index:
    """The kernel's view of the index arrays (numpy, device layout)."""

    def __init__(self, arrs, meta):
        self.fused = "fm_blocks" in arrs
        n = lambda k: arrs[k].numpy()
        if self.fused:
            self.rank_a, self.rank_b = n("fm_blocks"), None
        else:
            self.rank_a, self.rank_b = n("occ_cp"), n("bwt_blocks")
        self.bwt_words = n("bwt_words")
        self.sa_samp = n("sa_samp").astype(np.int64)
        self.l2 = n("L2").astype(np.int64)
        self.pac_words = n("pac_words")
        self.seq_len, self.primary = meta["seq_len"], meta["primary"]
        self.sa_intv = meta["sa_intv"]
        self.log2_intv = int(self.sa_intv).bit_length() - 1
        self.n_sa = len(self.sa_samp)

    def occ(self, k, c):
        """occ<kFused> for lanes of rows k and chars c."""
        none, total = k < 0, k == self.seq_len
        kk = np.clip(k, 0, self.seq_len - 1)
        kp = kk - (kk >= self.primary)
        blk = kp >> 7
        off = kp & 127
        f = off >> 4
        r = off & 15
        if self.fused:
            base = self.rank_a[blk, c]
            words = self.rank_a[blk, 4:]
        else:
            base = self.rank_a[blk, c]
            words = self.rank_b[blk]
        wsel = np.arange(8)[None, :]
        m = _match(words.astype(np.uint32), c[:, None])
        partial = ~((np.uint32(1) << ((15 - r) << 1).astype(np.uint32))
                    - np.uint32(1))
        m = np.where(wsel < f[:, None], m,
                     np.where(wsel == f[:, None], m & partial[:, None], 0))
        cnt = np.bitwise_count(m.astype(np.uint32)).sum(-1).astype(np.int64)
        res = base + cnt
        res = np.where(total, self.l2[np.minimum(c + 1, 4)] - self.l2[c],
                       res)
        return np.where(none, 0, res)


def seed_ext_model(ix, reads, lens, alive0, k0, l0, m0, pos_f, b_lane,
                   phase1_steps):
    """Per-lane (k, l, m, rpos, rflag) of the kernel, and each lane's
    (n_ext, n_walk, n_cmp) step counts."""
    L = reads.shape[1]
    alive = alive0.copy()
    k, l, m = k0.copy(), l0.copy(), m0.copy()
    rpos = np.zeros_like(k)
    rflag = np.zeros_like(alive)
    n_ext = np.zeros(len(k), np.int64)
    n_walk = np.zeros_like(n_ext)
    n_cmp = np.zeros_like(n_ext)
    phase = np.where(alive, PH_EXT, PH_DONE)
    s = np.zeros_like(k)          # steps taken in the current block
    p = np.zeros_like(k)          # SA position of a resolving lane
    rows = np.zeros_like(k)       # its walk's row
    steps = np.zeros_like(k)      # its walk's steps
    lens_l = lens.astype(np.int64)[b_lane]
    mask = ix.sa_intv - 1

    def locate(i):
        """Start resolving lanes i: the full SA's gather, else the walk."""
        if ix.sa_intv == 1:
            p[i] = ix.sa_samp[np.clip(k[i], 0, ix.n_sa - 1)]
            phase[i] = PH_CMP
        else:
            rows[i], steps[i] = k[i], 0
            phase[i] = PH_WALK
            walk_end(i)

    def walk_end(i):
        done = i[(rows[i] & mask) == 0]
        p[done] = steps[done] + ix.sa_samp[rows[done] >> ix.log2_intv]
        phase[done] = PH_CMP

    while True:
        # one iteration: every lane's next action, as a warp issues them
        i = np.nonzero(phase == PH_EXT)[0]
        if len(i):
            q = pos_f[i] + m[i]
            c = reads[b_lane[i], np.minimum(q, L - 1)].astype(np.int64)
            ok_char = (q < lens_l[i]) & (c < 4)
            cc = np.where(ok_char, 3 - c, 0)
            nk = ix.l2[cc] + ix.occ(k[i] - 1, cc) + 1
            nl = ix.l2[cc] + ix.occ(l[i], cc)
            a = ok_char & (nk <= nl) & (m[i] < K_MAX_ANCHOR)
            alive[i] = a
            k[i] = np.where(a, nk, k[i])
            l[i] = np.where(a, nl, l[i])
            m[i] += a
            n_ext[i] += 1
            s[i] += 1
            phase[i[~a]] = PH_DONE
            end = i[a & (s[i] == phase1_steps)]
            s[end] = 0
            locate(end[k[end] == l[end]])
        i = np.nonzero(phase == PH_WALK)[0]
        if len(i):
            r = rows[i]
            x = r - (r > ix.primary)
            ch = ((ix.bwt_words[x >> 4].astype(np.uint32)
                   >> ((15 - (x & 15)) << 1).astype(np.uint32)) & 3)
            ch = ch.astype(np.int64)
            nxt = ix.l2[ch] + ix.occ(r, ch)
            rows[i] = np.where(r == ix.primary, 0, nxt)
            steps[i] += 1
            n_walk[i] += 1
            walk_end(i)
        i = np.nonzero(phase == PH_CMP)[0]
        if len(i):
            q = pos_f[i] + m[i]
            go = (m[i] < K_MAX_ANCHOR) & (p[i] > 0) & (q < lens_l[i])
            c = reads[b_lane[i], np.minimum(q, L - 1)].astype(np.int64)
            go &= c < 4
            tp = np.maximum(p[i] - 1, 0)
            tc = ((ix.pac_words[tp >> 4].astype(np.uint32)
                   >> ((15 - (tp & 15)) << 1).astype(np.uint32)) & 3)
            go &= tc.astype(np.int64) == 3 - c
            m[i] += go
            p[i] -= go
            n_cmp[i] += go
            stop = i[~go]
            rpos[stop] = p[stop]
            rflag[stop] = True
            phase[stop] = PH_DONE
        if not (phase != PH_DONE).any():
            break
    return (k, l, m, rpos, rflag), np.stack([n_ext, n_walk, n_cmp], 1)


def _capture(arrs, meta, reads, lens, cfg):
    """The inputs and outputs of _staged_ext in the port's seeding of one
    batch on the CPU, and the batch's seeds."""
    seen = []
    orig = tfm._staged_ext

    def rec(arrs_, meta_, rd, *lanes):
        out = orig(arrs_, meta_, rd, *lanes)
        seen.append(([x.clone() for x in lanes[:6]], lanes[6], out))
        return out

    rec.entries = 0  # the counter the plain version updates by name
    tfm._staged_ext = rec
    try:
        seeds = tfm.seed_anchors(arrs, meta, reads, lens, cfg)
    finally:
        tfm._staged_ext = orig
    (lanes, steps, out), = seen
    return lanes, steps, out, seeds


def _model_seeds(arrs, meta, reads, lens, cfg):
    """seed_anchors with the model in _staged_ext's place."""
    orig = tfm._staged_ext
    ix = Index(arrs, meta)

    def model(arrs_, meta_, rd, alive0, k0, l0, m0, pos_f, b_lane, steps):
        res, _ = seed_ext_model(ix, np.asarray(reads), np.asarray(lens),
                                *(x.numpy() for x in (alive0, k0, l0, m0,
                                                      pos_f, b_lane)),
                                steps)
        return tuple(torch.from_numpy(x) for x in res)

    tfm._staged_ext = model
    try:
        return tfm.seed_anchors(arrs, meta, reads, lens, cfg)
    finally:
        tfm._staged_ext = orig


def _torch_arrays(host):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)
                                if v.dtype == np.uint32 else np.array(v))
            for k, v in host.items()}


def _case(which, layout, ref8_idx, small_index, sampled_index):
    """(jax index, port arrays, JAX arrays, reads, lens, kw) of a case."""
    import jax.numpy as jnp

    if which == "golden":
        jidx = ref8_idx
        kw = dict(TEST_CFG)
        reads, lens = _first_batch(TCfg(**kw).validate())
    else:
        jidx = small_index[0] if which == "small_full" else sampled_index
        kw = dict(sampling_count=150, min_anchor_len=12,
                  max_seeds_per_read=512, kmer_cache_k=jidx.kcache_k,
                  seed_phase1_steps=3)
        reads, lens = _noisy_reads(np.random.default_rng(11), jidx, 6, 1500)
    host = jidx.host_arrays()
    if layout == "split":
        host = _split_layout(jidx, host)
    jarrs = {k: jnp.asarray(v) for k, v in host.items()}
    return jidx, _torch_arrays(host), jarrs, reads, lens, kw


@pytest.mark.parametrize("which,layout", [
    ("golden", "fused"), ("small_full", "fused"), ("small_full", "split"),
    ("sampled", "fused"), ("sampled", "split")])
def test_model_matches_staged_ext_and_jax(which, layout, ref8_idx,
                                          small_index, sampled_index):
    jidx, arrs, jarrs, reads, lens, kw = _case(which, layout, ref8_idx,
                                               small_index, sampled_index)
    meta = port_index(jidx).meta
    assert meta["sa_intv"] == (32 if which == "sampled" else 1)
    cfg = TCfg(**kw).validate()
    lanes, steps, want, seeds = _capture(arrs, meta, reads, lens, cfg)
    assert steps == cfg.seed_phase1_steps
    got, counts = seed_ext_model(Index(arrs, meta), reads, lens,
                                 *(x.numpy() for x in lanes), steps)
    for name, g, w in zip(("k", "l", "m", "rpos", "rflag"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    rflag = got[4]
    assert rflag.sum() > 100 and (lanes[0].numpy() & ~rflag).sum() > 100
    if which == "sampled":
        assert counts[:, 1].sum() > 0  # the walk ran
    jseeds = jfm.seed_anchors(jarrs, jidx.meta, reads, lens,
                              JCfg(**kw).validate())
    assert_batches_equal(_model_seeds(arrs, meta, reads, lens, cfg), jseeds,
                         SEED_FIELDS)
    assert_batches_equal(seeds, jseeds, SEED_FIELDS)


def test_seed_ext_wrapper_on_cpu_is_plain(small_index):
    """fm_index_cuda.seed_ext on CPU tensors runs _staged_ext (no
    launch; no step counts), and _seed_anchors_impl on the CPU enters
    _staged_ext once a batch."""
    jidx = small_index[0]
    pidx = port_index(jidx)
    arrs, meta = pidx.device_arrays("cpu"), pidx.meta
    cfg = TCfg(sampling_count=50, kmer_cache_k=jidx.kcache_k,
               seed_phase1_steps=2).validate()
    reads, lens = _noisy_reads(np.random.default_rng(2), jidx, 3, 800)
    lanes, steps, want, _ = _capture(arrs, meta, reads, lens, cfg)
    before = (fm_index_cuda.seed_ext.launches, tfm._staged_ext.entries)
    got = fm_index_cuda.seed_ext(arrs, meta, torch.from_numpy(reads),
                                 torch.from_numpy(lens), *lanes, steps)
    assert (fm_index_cuda.seed_ext.launches,
            tfm._staged_ext.entries) == (before[0], before[1] + 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        fm_index_cuda.seed_ext(arrs, meta, torch.from_numpy(reads),
                               torch.from_numpy(lens), *lanes, steps,
                               want_stats=True)
