"""A numpy model of the seed-extension kernel (lordfast_tpu_torch/csrc/
seed_ext.cu ``seed_ext_kernel``, names as there) against the port's plain
version (ops/fm_index.py ``_staged_ext``) and, through the seeds it leads
to, the JAX package's seeding.

The model runs every lane as the kernel's thread does, all lanes in step
as a warp issues them, each in its own phase: blocks of phase1_steps
greedy steps (the read char from the 3-bit read words, two occ queries
each on the rank rows of the index's layout, loaded in 16-byte pairs up
to the row's word), the one-row check at the end of each block only,
then the walk to a sampled SA row (or the full SA's gather) and the
comparison against the packed text, 16 chars a round trip (the text's
two words joined and spread to 3-bit groups, XOR with the read's codes,
the leading zero groups, cut at the read's end, the text's start and
MAX_ANCHOR_LEN).  Cases: golden's first batch (the k = 8 index of
tests/data, full SA), noisy reads of the small index with the full SA
and with sa_intv 32, each in the fused rank layout and the split one
(occ_cp + bwt_blocks, as for l_pac >= 2^32), and reads copied from the
text whose compare ends at every offset of a round trip, at an N, the
read's end, the text's start and MAX_ANCHOR_LEN
(``chip_smoke.edge_reads``).  Every output is an integer: the model's
per-lane (k, l, m, rpos, rflag) must equal _staged_ext's exactly, and
the seeds computed with the model in its place must equal the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

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
K_THREES = np.uint64(0x6DB6DB6DB6DB)  # 3 in each 3-bit group
K_MASK48 = np.uint64(0xFFFFFFFFFFFF)
PH_EXT, PH_WALK, PH_CMP, PH_DONE = 0, 1, 2, 3


def _match(w, c):
    """Per-char match bits of uint32 BWT words w for chars c."""
    hi = np.where((c & 2) != 0, w, ~w)
    lo = np.where((c & 1) != 0, w, ~w)
    return (hi >> np.uint32(1)) & lo & np.uint32(0x55555555)


def read_words(reads):
    """The reads' 3-bit words (fm_index._Reads.rw): 16 codes an int64,
    the first in the highest bits, padded with 4."""
    B, L = reads.shape
    W16 = -(-L // 16)
    r = np.full((B, 16 * W16), 4, np.int64)
    r[:, :L] = reads
    sh = 3 * (15 - np.arange(16))
    return (r.reshape(B, W16, 16) << sh).sum(-1)


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
        self.n_pac = len(self.pac_words)
        self.seq_len, self.primary = meta["seq_len"], meta["primary"]
        self.sa_intv = meta["sa_intv"]
        self.log2_intv = int(self.sa_intv).bit_length() - 1
        self.n_sa = len(self.sa_samp)

    def occ(self, k, c):
        """load_row + occ for lanes of rows k and chars c: the row's four
        counts and its BWT words in 16-byte pairs up to the pair of the
        row's word f (the rest are not loaded: zeros here), the words
        before f whole and word f up to the row's char."""
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
        words = np.where(wsel <= (f | 1)[:, None], words, 0)
        m = _match(words.astype(np.uint32), c[:, None])
        upto = ~((np.uint32(1) << ((15 - r) << 1).astype(np.uint32))
                 - np.uint32(1))
        m = np.where(wsel < f[:, None], m,
                     np.where(wsel == f[:, None], m & upto[:, None], 0))
        cnt = np.bitwise_count(m.astype(np.uint32)).sum(-1).astype(np.int64)
        res = base + cnt
        res = np.where(total, self.l2[np.minimum(c + 1, 4)] - self.l2[c],
                       res)
        return np.where(none, 0, res)


def text16(thi, tlo, a0):
    """The 16 text chars p - 1, ..., p - 16 (a0 = p - 16) as 3-bit
    groups, p - 1 in bits 47..45: the funnel shift of the pac words thi
    (the word of a0) and tlo (the next) by 2 (a0 & 15), then spread."""
    sh = (2 * (a0 & 15)).astype(np.uint64)
    both = (thi.astype(np.uint64) << np.uint64(32)) | tlo.astype(np.uint64)
    tw = (both >> (np.uint64(32) - sh)) & np.uint64(0xFFFFFFFF)
    t3 = np.zeros_like(tw)
    for j in range(16):
        t3 |= ((tw >> np.uint64(2 * j)) & np.uint64(3)) << np.uint64(45 - 3 * j)
    return t3


def leading_groups(d):
    """(clz64(d) - 16) / 3 of 48-bit d: its leading zero 3-bit groups."""
    g = (d[:, None] >> (np.uint64(45) - np.uint64(3) * np.arange(
        16, dtype=np.uint64))) & np.uint64(7)
    nz = g != 0
    return np.where(nz.any(1), nz.argmax(1), 16).astype(np.int64)


def seed_ext_model(ix, reads, lens, alive0, k0, l0, m0, pos_f, b_lane,
                   phase1_steps):
    """Per-lane (k, l, m, rpos, rflag) of the kernel, and each lane's
    (n_ext, n_walk, n_cmp, n_trip) counts: extension steps, walk steps,
    matched chars and compare round trips."""
    L = reads.shape[1]
    rw = read_words(reads).astype(np.uint64)
    W16 = rw.shape[1]
    alive = alive0.copy()
    k, l, m = k0.copy(), l0.copy(), m0.copy()
    rpos = np.zeros_like(k)
    rflag = np.zeros_like(alive)
    n_ext = np.zeros(len(k), np.int64)
    n_walk = np.zeros_like(n_ext)
    n_cmp = np.zeros_like(n_ext)
    n_trip = np.zeros_like(n_ext)
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
            qc = np.minimum(q, L - 1)
            word = rw[b_lane[i], qc >> 4]
            c = ((word >> (np.uint64(3) * (15 - (qc & 15)).astype(np.uint64)))
                 & np.uint64(7)).astype(np.int64)
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
            # one round trip: 16 text chars left of p against the read's
            # next 16 codes, cut at the read's end, the text's start and
            # MAX_ANCHOR_LEN
            q = pos_f[i] + m[i]
            lim = np.minimum(np.minimum(lens_l[i] - q, p[i]),
                             K_MAX_ANCHOR - m[i])
            stop = i[lim <= 0]
            go = lim > 0
            i, q, lim = i[go], q[go], lim[go]
            a0 = p[i] - 16
            wa = a0 >> 4
            thi = ix.pac_words[np.maximum(wa, 0)]
            tlo = ix.pac_words[np.minimum(wa + 1, ix.n_pac - 1)]
            q0 = q >> 4
            r0 = rw[b_lane[i], q0]
            r1 = rw[b_lane[i], np.minimum(q0 + 1, W16 - 1)]
            sh = (3 * (q & 15)).astype(np.uint64)
            rd = ((r0 << sh) | (r1 >> (np.uint64(48) - sh))) & K_MASK48
            d = rd ^ text16(thi, tlo, a0) ^ K_THREES
            run = np.minimum(leading_groups(d), lim)
            m[i] += run
            p[i] -= run
            n_cmp[i] += run
            n_trip[i] += 1
            stop = np.concatenate([stop, i[run < 16]])
            rpos[stop] = p[stop]
            rflag[stop] = True
            phase[stop] = PH_DONE
        if not (phase != PH_DONE).any():
            break
    return ((k, l, m, rpos, rflag),
            np.stack([n_ext, n_walk, n_cmp, n_trip], 1))


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


@pytest.mark.parametrize("which,layout", [
    ("small_full", "fused"), ("small_full", "split"), ("sampled", "fused"),
    ("sampled", "split")])
def test_model_word_compare_edges(which, layout, small_index,
                                  sampled_index):
    """chip_smoke.edge_reads: runs of the finish that end at every
    offset of a 16-char trip and across word boundaries, at a wrong
    code, at an N, at the read's end inside a word, at the text's start
    (a last trip with p < 16) and at MAX_ANCHOR_LEN in mid-word; the
    model equal to _staged_ext lane for lane and, through the seeds of
    the same reads, to the JAX package."""
    jidx = small_index[0] if which == "small_full" else sampled_index
    host = jidx.host_arrays()
    if layout == "split":
        host = _split_layout(jidx, host)
    arrs = _torch_arrays(host)
    meta = port_index(jidx).meta
    text = chip_smoke.text_of(arrs, meta)
    reads, lens, kinds, e, lanes = chip_smoke.edge_reads(
        np.random.default_rng(13), text, meta["seq_len"])
    rd = tfm._Reads(torch.from_numpy(reads), torch.from_numpy(lens))
    want = tfm._staged_ext(arrs, meta, rd,
                           *(torch.from_numpy(x) for x in lanes), 3)
    got, counts = seed_ext_model(Index(arrs, meta), reads, lens, *lanes, 3)
    for name, g, w in zip(("k", "l", "m", "rpos", "rflag"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    m, rpos, rflag = got[2], got[3], got[4]
    pos_f = lanes[4]
    assert rflag.all()
    np.testing.assert_array_equal(
        m, np.where(kinds == "max", K_MAX_ANCHOR, e - pos_f))
    assert (rpos[kinds == "start"] == 0).all()
    last = counts[:, 2] - 16 * (counts[:, 3] - 1)  # the last trip's run
    assert set(last[kinds == "mismatch"]) == set(range(16))
    assert (counts[kinds == "mismatch", 3] > 1).all()
    assert (last[kinds == "N"] < 16).all()  # the N stops its trip
    for kind in ("end", "start"):  # mid-trip, or at a trip's end
        assert (last[kinds == kind] < 16).any(), kind
    assert ((last[kinds == "max"] % 16) != 0).any()
    if layout == "fused":
        kw = dict(sampling_count=40, min_anchor_len=12, max_seeds_per_read=512,
                  kmer_cache_k=jidx.kcache_k, seed_phase1_steps=3)
        jarrs = {k: jnp.asarray(v) for k, v in host.items()}
        jseeds = jfm.seed_anchors(jarrs, jidx.meta, reads, lens,
                                  JCfg(**kw).validate())
        assert_batches_equal(
            _model_seeds(arrs, meta, reads, lens, TCfg(**kw).validate()),
            jseeds, SEED_FIELDS)


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
    rd = tfm._Reads(torch.from_numpy(reads), torch.from_numpy(lens))
    np.testing.assert_array_equal(rd.rw.numpy(), read_words(reads))
    got = fm_index_cuda.seed_ext(arrs, meta, rd, *lanes, steps)
    assert (fm_index_cuda.seed_ext.launches,
            tfm._staged_ext.entries) == (before[0], before[1] + 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for kw in ("want_stats", "want_need"):
        with pytest.raises(ValueError):
            fm_index_cuda.seed_ext(arrs, meta, rd, *lanes, steps,
                                   **{kw: True})


def test_seed_ext_need_bitmap_segments(small_index):
    """fm_index_cuda's need bitmap (the input pieces seed_ext's lanes
    need, which give its bound): each segment starts on a 32-bit word
    after the one before it, and _need_bytes counts each set bit once,
    times its piece's bytes (16 a rank piece, the SA's element, 8 a pac
    or read word)."""
    pidx = port_index(small_index[0])
    arrs = pidx.device_arrays("cpu")
    sa = arrs["sa_samp"]
    segs, n_bits = fm_index_cuda._need_segments(
        arrs, True, arrs["fm_blocks"], None, sa, 3, 5)
    assert [name for name, *_ in segs] == ["rank", "sa", "pac", "rw"]
    end = 0
    for name, bit, n, size in segs:
        assert bit % 32 == 0 and bit >= end and n > 0
        end = bit + n
    assert n_bits % 32 == 0 and n_bits >= end
    first = {name: (bit, n) for name, bit, n, _ in segs}
    assert first["rank"][1] == 6 * arrs["fm_blocks"].shape[0]
    assert first["rw"][1] == 15
    words = np.zeros(n_bits // 32, np.uint32)
    for b in (0, 5, 6, first["sa"][0] + first["sa"][1] - 1,
              first["pac"][0], first["pac"][0] + 1, first["rw"][0] + 14):
        words[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
    got = fm_index_cuda._need_bytes(torch.from_numpy(words.view(np.int32)),
                                    segs)
    assert got == {"rank": 48, "sa": sa.element_size(), "pac": 16, "rw": 8}


def test_smoke_warp_figures():
    """chip_smoke's seed_ext figures from the kernel's (BS, 7) counts and
    timers: a warp issues each kind of step as often as its busiest
    lane; the warp with the most steps (compare round trips, column 3,
    not the matched chars of column 2); the warp that ends last by the
    timers, across the 32-bit timer's wrap."""
    stats = np.zeros((70, 7), np.int64)
    stats[3, :4] = [57, 0, 0, 0]
    stats[40, :4] = [12, 0, 1456, 91]
    stats[41, :4] = [2, 5, 10, 1]
    stats[69, :4] = [1, 0, 0, 0]
    t0 = 2**32 - 5000  # the timer wraps 5 us after the first start
    stats[:, 4] = t0 + np.arange(70)
    stats[:, 5] = stats[:, 4] + 1000
    stats[:, 6] = stats[:, 4] + 2000
    stats[3, 5:] = [t0 + 60000, t0 + 61000]  # warp 0 ends last
    stats[41, 6] = t0 + 30000
    stats = ((stats + 2**31) % 2**32 - 2**31).astype(np.int32)
    assert chip_smoke.longest_warp(stats) == {
        "ext": 12, "walk": 5, "cmp": 91, "all": 108}
    last = chip_smoke.last_warp(stats)
    assert (last["end_us"], last["ext_us"]) == (61.0, 60.0)
    assert (last["ext"], last["cmp"], last["all"]) == (57, 0, 57)
    assert last["p50_us"] == 30.0  # the warps end at 61, 30 and 2.069 us
    eff = chip_smoke.warp_efficiency(stats)
    assert eff["ext"] == (57 + 12 + 2 + 1) / (32 * (57 + 12 + 1))
    assert eff["walk"] == 5 / (32 * 5)
    assert eff["cmp"] == 92 / (32 * 91)
    assert eff["all"] == (57 + 103 + 8 + 1) / (32 * (57 + 108 + 1))
