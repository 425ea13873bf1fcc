"""The locate walk of a sampled SA (lordfast_tpu_torch/ops/fm_index.py
``sa_lookup``, the plain version of the ``sa_locate`` kernel in
csrc/seed_ext.cu) against the JAX package's ``sa_lookup``
(lordfast_tpu/ops/fm_index.py), the wrapper ``fm_index_cuda.sa_locate``
on the CPU, the port's engine over a sampled-SA golden index against
``golden.sam``, and the smoke's pieces of the sampled path: ``slice_sa``,
the edge lanes, the routing checks and the JAX package's SAM digests
(``tests/data/jax_sam_digests.json``).

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
