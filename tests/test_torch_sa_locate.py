"""The locate walk of a sampled SA (lordfast_tpu_torch/ops/fm_index.py
``sa_lookup``, the plain version of the ``sa_locate`` kernel in
csrc/seed_ext.cu) against the JAX package's ``sa_lookup``
(lordfast_tpu/ops/fm_index.py), the wrapper ``fm_index_cuda.sa_locate``
on the CPU, the port's engine over a sampled-SA golden index against
``golden.sam``, and the smoke's pieces of the sampled path: ``slice_sa``,
the edge lanes, the routing checks and the JAX package's SAM digests
(``tests/data/jax_sam_digests.json``); and a numpy model of the kernel
(csrc/seed_ext.cu, names as there): its walk step against ``bwt_b0`` +
``occ`` of the port and of the JAX package on every row class, and its
lane queue against the full SA.

The index is the ``sampled_index`` fixture's genome (seed 31, 30 kb)
with the full SA, sliced to intervals 2, 4, 16 and 32 as the builder
samples (``chip_smoke.slice_sa``).  Every output is an integer: the
tolerance is exact equality.  The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import dataclasses
import hashlib
import io
import json
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.index.builder import build_index as j_build_index
from lordfast_tpu.ops import fm_index as jfm
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.index.builder import build_index as t_build_index
from lordfast_tpu_torch.ops import fm_index as tfm
from lordfast_tpu_torch.ops import fm_index_cuda
from lordfast_tpu_torch.pipeline.engine import MappingEngine

from test_golden import TEST_CFG
from test_torch_fm_index import port_index, sampled_index, t2n

DATA = Path(__file__).parent / "data"

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def full_index():
    """The sampled_index fixture's genome indexed with the full SA."""
    r = np.random.default_rng(31)
    seq = "".join("ACGT"[c] for c in r.integers(0, 4, 30000))
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        f.write(">c\n" + seq + "\n")
        path = f.name
    idx = j_build_index(path, JCfg(kmer_cache_k=6, sa_interval=1),
                        verbose=False)
    assert idx.sa_intv == 1
    return idx


def test_slice_sa_is_the_builders_sampling(full_index, sampled_index):
    """chip_smoke.slice_sa of the full SA at 32 is the builder's sampled
    SA of the same genome at 32, entry for entry (no second build)."""
    got = chip_smoke.slice_sa(port_index(full_index), 32)
    assert got.sa_intv == 32
    np.testing.assert_array_equal(got.sa_samp, sampled_index.sa_samp)
    assert got.sa_samp[0] == -1
    with pytest.raises(ValueError):
        chip_smoke.slice_sa(got, 2)


def _survivors(tidx, rows, valid):
    """Lanes still walking after intv/2 steps (JAX's phased walk takes
    ``take`` when at most half of them are)."""
    arrs, meta = tidx.device_arrays("cpu"), tidx.meta
    mask = meta["sa_intv"] - 1
    r = torch.from_numpy(rows).long()
    act = torch.from_numpy(valid) & ((r & mask) != 0)
    for _ in range(meta["sa_intv"] // 2):
        r = torch.where(act, tfm._walk_step(arrs, meta, r), r)
        act = act & ((r & mask) != 0)
    return int(act.sum())


@pytest.mark.parametrize("intv", [2, 4, 16, 32])
@pytest.mark.parametrize("frac", [0.4, 1.0])
def test_sa_lookup_sliced_matches_jax(full_index, intv, frac):
    """The port's walk == JAX's on 2^16 rows at each interval, with 40%
    of the lanes valid and with all of them.  At 16 and 32 JAX walks in
    two phases: with every lane valid, ~60% survive the first intv/2
    steps (the walk is geometric, mean ~intv), more than its half-width
    cap, so JAX takes its ``fall`` branch; at 40% its ``take``."""
    tidx = chip_smoke.slice_sa(port_index(full_index), intv)
    n = 1 << 16
    r = np.random.default_rng(intv)
    rows = r.integers(0, tidx.seq_len + 1, n).astype(np.int32)
    valid = r.random(n) < frac
    if intv >= 16:
        fall = _survivors(tidx, rows, valid) > n // 2
        assert fall == (frac == 1.0)
    jidx = dataclasses.replace(full_index, sa_samp=tidx.sa_samp,
                               sa_intv=intv, _device=None)
    want = jfm.sa_lookup(jidx.device_arrays(), jidx.meta, jnp.asarray(rows),
                         jnp.asarray(valid))
    before = tfm.sa_lookup.entries
    got = tfm.sa_lookup(tidx.device_arrays("cpu"), tidx.meta,
                        torch.from_numpy(rows), torch.from_numpy(valid))
    assert tfm.sa_lookup.entries == before + 1
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


def test_sa_lookup_walk_lengths(full_index):
    """Row sampling makes the walk geometric: over every row of the
    text at interval 32, the mean walk is ~32 steps (not ~16, as a
    uniform length in [0, 32) would give) and the longest several times
    that; every walk's position is the full SA's."""
    tidx = chip_smoke.slice_sa(port_index(full_index), 32)
    arrs, meta = tidx.device_arrays("cpu"), tidx.meta
    rows = torch.arange(1, tidx.seq_len + 1)
    r, steps = rows.clone(), torch.zeros_like(rows)
    act = (r & 31) != 0
    while bool(act.any()):
        r = torch.where(act, tfm._walk_step(arrs, meta, r), r)
        steps += act.long()
        act = act & ((r & 31) != 0)
    assert 28 < float(steps.double().mean()) < 36
    assert int(steps.max()) > 4 * 32
    got = tfm.sa_lookup(arrs, meta, rows, torch.ones_like(rows, dtype=bool))
    np.testing.assert_array_equal(t2n(got),
                                  full_index.sa_samp[1:].astype(np.int64))


def test_int32_positions_refused_past_2_31(full_index):
    """seed_ext and sa_locate refuse an int32 sa_samp or L2 for an index
    whose positions pass int32 (seq_len >= 2**31 - 1, as the 2.2 Gbp
    genome's 4,382,814,620), on the CPU as on the card: cut to int32,
    its L2 wraps negative and a walk steps outside the index (an illegal
    address on the card).  int64 positions, and int32 ones that fit,
    are taken."""
    tidx = chip_smoke.slice_sa(port_index(full_index), 16)
    arrs, meta = tidx.device_arrays("cpu"), tidx.meta
    assert arrs["sa_samp"].dtype == arrs["L2"].dtype == torch.int32
    rows = torch.arange(0, 64, dtype=torch.int64)
    valid = torch.ones(64, dtype=torch.bool)
    want = tfm.sa_lookup(arrs, meta, rows, valid)
    assert torch.equal(fm_index_cuda.sa_locate(arrs, meta, rows, valid),
                       want)
    wide = {**meta, "seq_len": 4_382_814_620}
    for key in ("sa_samp", "L2"):
        cut = {**arrs, "sa_samp": arrs["sa_samp"].long(),
               "L2": arrs["L2"].long(), key: arrs[key]}
        with pytest.raises(ValueError, match=f"{key} is torch.int32"):
            fm_index_cuda.sa_locate(cut, wide, rows, valid)
        with pytest.raises(ValueError, match=f"{key} is torch.int32"):
            fm_index_cuda.seed_ext(cut, wide, None, *([None] * 6), 1)
    long = {**arrs, "sa_samp": arrs["sa_samp"].long(),
            "L2": arrs["L2"].long()}
    assert torch.equal(fm_index_cuda.sa_locate(long, meta, rows, valid),
                       want)


def test_sa_locate_wrapper_on_cpu_is_plain(full_index):
    """fm_index_cuda.sa_locate on CPU tensors runs sa_lookup (one walk
    entry, no launch; 0 on invalid lanes); the walk steps and the need
    bitmap come from the kernel only, so asking for them on the CPU
    raises; the locate's need bitmap has the rank and sa segments."""
    tidx = chip_smoke.slice_sa(port_index(full_index), 16)
    arrs, meta = tidx.device_arrays("cpu"), tidx.meta
    rows, valid = chip_smoke.locate_rows(
        meta, torch.arange(0, tidx.seq_len + 1, 7),
        torch.ones((tidx.seq_len + 7) // 7, dtype=torch.bool))
    before = (fm_index_cuda.sa_locate.launches, tfm.sa_lookup.entries)
    got = fm_index_cuda.sa_locate(arrs, meta, rows, valid)
    assert (fm_index_cuda.sa_locate.launches,
            tfm.sa_lookup.entries) == (before[0], before[1] + 1)
    assert torch.equal(got, tfm.sa_lookup(arrs, meta, rows, valid))
    assert bool((got[~valid] == 0).all())
    full = torch.from_numpy(full_index.sa_samp.astype(np.int64))
    assert torch.equal(got[valid], full[rows[valid]])
    for kw in ("want_stats", "want_need"):
        with pytest.raises(ValueError):
            fm_index_cuda.sa_locate(arrs, meta, rows, valid, **{kw: True})
    segs, n_bits = fm_index_cuda._need_segments(
        arrs, True, arrs["fm_blocks"], None, arrs["sa_samp"])
    assert [name for name, *_ in segs] == ["rank", "sa"]
    assert n_bits % 32 == 0 and segs[1][1] % 32 == 0


def test_locate_rows_edges(full_index):
    """chip_smoke.locate_rows appends the primary row, its neighbours,
    sampled rows, row seq_len and random rows (valid) and 48 invalid
    lanes to a recorded call's lanes."""
    tidx = chip_smoke.slice_sa(port_index(full_index), 32)
    meta = tidx.meta
    rows0 = torch.tensor([5, 6, 7], dtype=torch.int64)
    valid0 = torch.tensor([True, False, True])
    rows, valid = chip_smoke.locate_rows(meta, rows0, valid0)
    assert torch.equal(rows[:3], rows0) and torch.equal(valid[:3], valid0)
    extra = rows[3:][valid[3:]].tolist()
    for want in (meta["primary"], 0, 32, meta["seq_len"]):
        assert want in extra
    assert int((~valid[3:]).sum()) == 48
    assert int(rows.min()) >= 0 and int(rows.max()) <= meta["seq_len"]


@pytest.fixture(scope="module")
def golden_sampled_idx():
    """tests/data/ref.fa at the golden test's k = 8 with the SA sampled
    at 32, the port's builder."""
    return t_build_index(DATA / "ref.fa",
                         TCfg(kmer_cache_k=8, sa_interval=32), verbose=False)


def test_port_engine_sampled_sa_matches_golden_sam(golden_sampled_idx):
    """The port's engine on the CPU over a sampled SA (the locate walks
    through sa_lookup) gives golden.sam byte for byte."""
    assert golden_sampled_idx.sa_intv == 32
    eng = MappingEngine(golden_sampled_idx, TCfg(**TEST_CFG), device="cpu")
    before = tfm.sa_lookup.entries
    out = io.StringIO()
    eng.map_file(DATA / "reads.fq", out, "test")
    assert tfm.sa_lookup.entries > before
    ours = chip_smoke.sam_records(out.getvalue())
    golden = chip_smoke.sam_records((DATA / "golden.sam").read_text())
    assert len(ours) == len(golden)
    for i, (a, b) in enumerate(zip(golden, ours)):
        assert a == b, f"line {i} differs:\nG: {a[:200]}\nO: {b[:200]}"


def test_jax_sam_digests_file():
    """tests/data/jax_sam_digests.json (tools/torch_jax_sams.py): the JAX
    package's commit, and for v1 and v2 the read count and one sha256 a
    read: 512 v1 reads, 560 v2 reads (40 of them SV/clip, 8 junk)."""
    d = json.loads(chip_smoke.JAX_DIGESTS.read_text())
    assert d["tool"] == "tools/torch_jax_sams.py"
    assert len(d["jax_package_commit"]) == 40
    int(d["jax_package_commit"], 16)
    counts = {tag: ds["reads"] for tag, ds in d["datasets"].items()}
    assert counts == {"v1": 512, "v2": 560}
    for tag, ds in d["datasets"].items():
        assert len(ds["digests"]) == ds["reads"]
        for name, h in ds["digests"].items():
            assert len(h) == 64 and int(h, 16) >= 0, (tag, name)
    v2 = d["datasets"]["v2"]["digests"]
    assert sum(n.startswith("sv") for n in v2) == 40
    assert sum(n.startswith("junk") for n in v2) == 8


def _sam(recs):
    return "@HD\tVN:1.5\n@PG\tID:x\n" + "".join(r + "\n" for r in recs)


def test_read_digests_and_check(tmp_path, monkeypatch):
    """chip_smoke.read_digests hashes each read's record lines in order
    (headers aside), and check_digests fails on a read that differs
    unless KNOWN_DIVERGENT names it, and on a missing read."""
    recs = ["a\t0\tc\t1", "b\t4\t*\t0", "a\t2048\tc\t9"]
    got = chip_smoke.read_digests(_sam(recs))
    assert got == {
        "a": hashlib.sha256(b"a\t0\tc\t1\na\t2048\tc\t9\n").hexdigest(),
        "b": hashlib.sha256(b"b\t4\t*\t0\n").hexdigest()}
    f = tmp_path / "d.json"
    f.write_text(json.dumps({"jax_package_commit": "0" * 40, "datasets": {
        "v1": {"reads": 2, "digests": got}}}))
    monkeypatch.setattr(chip_smoke, "JAX_DIGESTS", f)
    chip_smoke.check_digests("v1", _sam(recs))
    changed = _sam(recs[:2] + ["a\t2048\tc\t10"])
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.check_digests("v1", changed)
    monkeypatch.setattr(chip_smoke, "KNOWN_DIVERGENT",
                        {("v1", "a"): "a cause in ROADMAP Queue 3"})
    chip_smoke.check_digests("v1", changed)
    with pytest.raises(AssertionError, match="reads with records"):
        chip_smoke.check_digests("v1", _sam(recs[1:2]))


def _launches(**kw):
    base = {k: 0 for k in (*chip_smoke.KERNELS, *chip_smoke.LOOPS)}
    return {**base, **kw}


def test_check_launches_sampled_routing():
    """The smoke's routing checks: a sampled pass launches sa_locate as
    often as seed_ext and walks never; a plain_loops pass launches no
    loop kernel; a full-SA pass neither launches sa_locate nor walks."""
    ck = chip_smoke.check_launches
    need = ("chain_dp", "seed_ext", "sa_locate")
    ck("s", _launches(chain_dp=4, seed_ext=4, sa_locate=4), {}, need,
       sampled=True)
    for bad in (dict(sa_locate=3), dict(sa_locate=4, sa_lookup=1)):
        with pytest.raises(AssertionError):
            ck("s", _launches(chain_dp=4, seed_ext=4, **bad), {}, need,
               sampled=True)
    ck("p", _launches(_chain_bucketed=4, _staged_ext=4, sa_lookup=9), {},
       (), plain=True, sampled=True)
    with pytest.raises(AssertionError):
        ck("p", _launches(sa_locate=1, sa_lookup=9), {}, (), plain=True,
           sampled=True)
    ck("f", _launches(chain_dp=4, seed_ext=4), {}, need)
    for bad in (dict(sa_locate=4), dict(sa_lookup=1)):
        with pytest.raises(AssertionError):
            ck("f", _launches(chain_dp=4, seed_ext=4, **bad), {}, need)


# A numpy model of csrc/seed_ext.cu's walk step and lane queue, names as
# there: change the kernel's index arithmetic or schedule here first.
M32 = np.uint64(0xFFFFFFFF)


def _host_index(arrs, layout):
    """The rank arrays as the kernel reads them: (counts (nb, 4), words
    (nb, 8)) int64, from fm_blocks or from occ_cp + bwt_blocks."""
    if layout == "fused":
        fb = arrs["fm_blocks"].numpy()
        return fb[:, :4], fb[:, 4:]
    return arrs["occ_cp"].numpy(), arrs["bwt_blocks"].numpy()


def load_at(ix, kp, k):
    """The kernel's Row of the $-removed position kp for row k: the
    counts and the word pairs up to the pair of kp's word (the rest
    zero, as they are not loaded), and off."""
    cnt, words = ix
    blk, off = kp >> 7, (kp & 127).astype(np.int64)
    f = off >> 4
    w = words[blk].astype(np.uint64) & np.uint64(0xFFFFFFFF)
    pairs = [(w[:, 2 * p], w[:, 2 * p + 1]) for p in range(4)]
    pairs = [(np.where(f >= 2 * p, hi, 0), np.where(f >= 2 * p, lo, 0))
             for p, (hi, lo) in enumerate(pairs)]
    return {"cnt": cnt[blk], "pairs": pairs, "k": k, "off": off}


def match(w, c):
    """Per-char match bits of BWT words (uint64 arrays of uint32 values)."""
    hi = np.where((c & 2) != 0, w, w ^ M32)
    lo = np.where((c & 1) != 0, w, w ^ M32)
    return (hi >> np.uint64(1)) & lo & np.uint64(0x55555555)


def first_chars(n):
    """The chars 0..n - 1 of a word, the first char highest."""
    sh = np.clip(32 - 2 * n, 0, 31).astype(np.uint64)
    return np.where(n >= 16, M32,
                    np.where(n <= 0, np.uint64(0), (M32 << sh) & M32))


def occ(meta, l2, row, c):
    """occ(k, c) of a loaded row: the block's count plus one masked
    popcount a word over the chars 0..off; row seq_len its char's
    total."""
    n = row["off"] + 1
    words = [w for p in row["pairs"] for w in p]
    cnt = sum(np.bitwise_count(match(w, c) & first_chars(n - 16 * i))
              .astype(np.int64) for i, w in enumerate(words))
    base = np.take_along_axis(row["cnt"], c[:, None], 1)[:, 0]
    total = l2[c + 1] - l2[c]
    return np.where(row["k"] == meta["seq_len"], total, base + cnt)


def row_char(row):
    """The char of the row's own position, from its word."""
    f, r = row["off"] >> 4, row["off"] & 15
    hi, lo = np.choose(f >> 1, [p[0] for p in row["pairs"]]), np.choose(
        f >> 1, [p[1] for p in row["pairs"]])
    w = np.where(f & 1, lo, hi).astype(np.int64)
    return (w >> ((15 - r) << 1)) & 3


def walk_step(ix, meta, l2, k):
    """(c, occ(k, c), the next row) of rows k != primary: the row x = k -
    (k > primary) loaded once, its char from its own word."""
    x = k - (k > meta["primary"])
    row = load_at(ix, x, k)
    c = row_char(row)
    o = occ(meta, l2, row, c)
    return c, o, l2[c] + o


def _row_classes(meta, n_random, seed):
    """Rows of every class the step treats apart: primary's neighbours,
    row seq_len and seq_len - 1, the ends and starts of rank blocks (in
    the $-removed positions, so on both sides of primary), 1, and
    n_random random rows; primary itself is the kernel's jump to 0."""
    seq_len, primary = meta["seq_len"], meta["primary"]
    blocks = np.arange(0, seq_len, 128)
    edge = [primary - 1, primary + 1, seq_len, seq_len - 1, 1]
    for b in blocks[:: max(1, len(blocks) // 64)]:
        for x in (b - 1, b, b + 1, b + 127):
            edge += [x, x + 1]  # x itself and past primary's shift
    rng = np.random.default_rng(seed)
    rows = np.concatenate([edge, rng.integers(1, seq_len + 1, n_random)])
    rows = rows[(rows >= 1) & (rows <= seq_len) & (rows != primary)]
    return rows.astype(np.int64)


@pytest.fixture(scope="module")
def golden_port_idx(ref8_idx):
    return port_index(ref8_idx)


@pytest.mark.parametrize("index", ["golden", "sampled"])
@pytest.mark.parametrize("layout", ["fused", "split"])
def test_walk_step_model(index, layout, ref8_idx, golden_port_idx,
                         sampled_index):
    """walk_step's char and count equal bwt_b0 and occ of the port and
    of the JAX package on every row class (primary's neighbours, seq_len,
    block edges on both sides of primary) and on 22,044 seeded random
    rows (v2's first locate call's lane count), over the golden index and
    the sampled-SA test genome, in both rank layouts."""
    jidx = ref8_idx if index == "golden" else sampled_index
    tidx = golden_port_idx if index == "golden" else port_index(jidx)
    arrs, meta = tidx.device_arrays("cpu"), tidx.meta
    if layout == "split":
        arrs = chip_smoke.split_layout(tidx, arrs)
    l2 = arrs["L2"].numpy().astype(np.int64)
    k = _row_classes(meta, 22_044, 7)
    assert meta["seq_len"] in k and (k == meta["primary"] + 1).any()
    c, o, nxt = walk_step(_host_index(arrs, layout), meta, l2, k)
    x = k - (k > meta["primary"])
    full = tidx.device_arrays("cpu")
    np.testing.assert_array_equal(
        c, t2n(tfm.bwt_b0(full, torch.from_numpy(x))))
    np.testing.assert_array_equal(o, t2n(tfm.occ(
        arrs, meta, torch.from_numpy(k), torch.from_numpy(c))))
    jarrs = jidx.device_arrays()
    np.testing.assert_array_equal(c, np.asarray(jfm.bwt_b0(
        jarrs, jnp.asarray(x))).astype(np.int64))
    np.testing.assert_array_equal(o, np.asarray(jfm.occ(
        jarrs, jidx.meta, jnp.asarray(k), jnp.asarray(c))))
    np.testing.assert_array_equal(nxt, t2n(tfm._walk_step(
        arrs, meta, torch.from_numpy(k))))


def sa_locate_kernel(ix, meta, l2, sa, rows, valid, n_warps, rng):
    """The kernel's lane queue, warp by warp in a seeded random order of
    their loop iterations: warp w starts with chunk w, then takes chunk
    n_warps + atomicAdd(counter, 1) when an idle lane finds its chunk
    handed out; each idle lane takes the chunk's next row (rank among the
    idle lanes), a lane with a row steps or, at a sampled row, writes
    out[i] and goes idle.  Returns out, each row's steps, the number of
    writes of each row, and each warp's (issued, active) steps."""
    n, mask = len(rows), meta["sa_intv"] - 1
    log2 = meta["sa_intv"].bit_length() - 1
    out = np.zeros(n, np.int64)
    stats = np.zeros(n, np.int64)
    writes = np.zeros(n, np.int64)
    counter = [0]
    lane = np.arange(32)

    def chunk(cb):
        ok = cb + lane < n
        idx = np.where(ok, cb + lane, 0)
        return np.where(ok, rows[idx], 0), np.where(ok, valid[idx], False)

    warps = []
    for w in range(n_warps):
        crow, cval = chunk(32 * w)
        warps.append(dict(cb=32 * w, crow=crow, cval=cval, taken=0,
                          i=np.full(32, -1), rows=np.zeros(32, np.int64),
                          steps=np.zeros(32, np.int64), issued=0, active=0,
                          done=False))

    def iteration(s):
        idle = s["i"] < 0
        if idle.any() and s["cb"] < n:
            left = min(n - s["cb"], 32) - s["taken"]
            want = int(idle.sum())
            src = s["taken"] + np.cumsum(idle) - idle  # rank among idle
            take = idle & (src < s["taken"] + left)
            srcc = src & 31
            s["i"] = np.where(take, s["cb"] + src, s["i"])
            s["rows"] = np.where(take, s["crow"][srcc], s["rows"])
            s["steps"] = np.where(take, 0, s["steps"])
            bad = take & ~s["cval"][srcc]
            for j in np.nonzero(bad)[0]:
                out[s["i"][j]] = 0
                writes[s["i"][j]] += 1
            s["i"] = np.where(bad, -1, s["i"])
            s["taken"] += min(want, left)
            if want > left:
                c = counter[0]
                counter[0] += 1
                s["cb"] = (n_warps + c) * 32
                s["taken"] = 0
                s["crow"], s["cval"] = chunk(s["cb"])
        busy = s["i"] >= 0
        end = busy & ((s["rows"] & mask) == 0)
        for j in np.nonzero(end)[0]:
            i = s["i"][j]
            out[i] = s["steps"][j] + sa[s["rows"][j] >> log2]
            stats[i] = s["steps"][j]
            writes[i] += 1
        step = busy & ~end
        if step.any():
            r = s["rows"]
            live = step & (r != meta["primary"])
            nxt = r.copy()
            if live.any():
                nxt[live] = walk_step(ix, meta, l2, r[live])[2]
            s["rows"] = np.where(step, np.where(r == meta["primary"], 0, nxt),
                                 r)
            s["steps"] = s["steps"] + step
            s["issued"] += 1
            s["active"] += int(step.sum())
        s["i"] = np.where(end, -1, s["i"])
        if not (s["i"] >= 0).any() and s["cb"] >= n:
            s["done"] = True

    while True:
        live = [s for s in warps if not s["done"]]
        if not live:
            break
        for j in rng.permutation(len(live))[: max(1, len(live) // 2)]:
            iteration(live[j])
    return out, stats, writes, [(s["issued"], s["active"]) for s in warps]


@pytest.mark.parametrize("n_warps", [3, 17, 130])
def test_lane_queue_model(n_warps, full_index):
    """The lane queue's model at 3 and 17 warps (4,160 rows: most chunks
    come from the counter, beyond what the warps hold at once) and at 130
    (every row in a warp's first chunk, the case of v2's calls): every
    row is written once, by its own index, each valid row's position is
    the full SA's (so sa_lookup's) and an invalid one's 0, whatever
    order the warps' iterations run in; the warps' lane steps add up to
    the rows' steps.  Warp efficiency (lane steps over 32 x issued
    steps): ~0.86 at 43 chunks a warp, ~0.69 at 7.6 (the last chunk's
    longest walk), ~0.22 with one chunk a warp (as with one row a
    thread: a warp ends with its longest walk)."""
    tidx = chip_smoke.slice_sa(port_index(full_index), 16)
    arrs, meta = tidx.device_arrays("cpu"), tidx.meta
    l2 = arrs["L2"].numpy().astype(np.int64)
    rng = np.random.default_rng(n_warps)
    n = 4160
    rows = rng.integers(0, tidx.seq_len + 1, n)
    rows[:4] = [meta["primary"], meta["seq_len"], 0, 16]
    valid = rng.random(n) < 0.9
    out, stats, writes, per_warp = sa_locate_kernel(
        _host_index(arrs, "fused"), meta, l2, tidx.sa_samp.astype(np.int64),
        rows, valid, n_warps, rng)
    assert (writes == 1).all()
    want = np.where(valid, full_index.sa_samp[rows].astype(np.int64), 0)
    np.testing.assert_array_equal(out, want)
    assert sum(a for _, a in per_warp) == stats.sum() > 0
    eff = stats.sum() / (32 * sum(i for i, _ in per_warp))
    lo, hi = {3: (0.8, 1.0), 17: (0.6, 1.0), 130: (0.0, 0.3)}[n_warps]
    assert lo < eff <= hi, eff
