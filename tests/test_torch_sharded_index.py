"""The port's sharded index (lordfast_tpu_torch/parallel/sharded_index.py)
against the JAX package's (lordfast_tpu/parallel/sharded_index.py) at the
same mesh size on the same inputs.

The port runs one process per rank under a gloo group on the CPU
(tests/torch_mesh_ranks.py, one thread each, with a timeout); the JAX
package runs in this process on the 8-CPU-device mesh of conftest.py.
Every output is an integer or a float's bits: the tolerance is exact
equality.  Covered: the routed row gather against a plain gather (int64
stripes, owner-skewed and ragged query sets, D = 2 and 3);
the seeds and the whole host payload of sharded_index_pipeline at D = 2
and 8 in both index layouts (fused fm_blocks with the full SA, and
occ_cp + bwt_blocks with the SA sampled at 32, so locate walks), on a
batch whose last three rows are padding (lens 0), as a short last batch
has, at the source's steps a block and at 1 and 7; the engine's SAM
under shard_index=True; a failing rank failing every rank; a rank > 0
of the CLI's --shardIndex that waits for rank 0's index gives up after
its time limit, naming the file.
"""

import dataclasses
import io
import json

import jax
import numpy as np
import pytest

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.ops import fm_index as jfm
from lordfast_tpu.parallel.mesh import make_mesh
from lordfast_tpu.parallel.sharded_index import sharded_index_pipeline
from lordfast_tpu.pipeline.engine import MappingEngine as JEngine
from lordfast_tpu_torch.index.builder import save_index

from test_sharded_index import CFG, _batch_from_index
from test_torch_fm_index import port_index
from torch_mesh_ranks import run_ranks

# the index layouts: (index file, JAX index key, port ranks force the
# occ_cp / bwt_blocks layout)
LAYOUTS = {"fused": ("index.lft.npz", "full", False),
           "split": ("index32.lft.npz", "sampled", True)}


def _split_layout(idx):
    """idx with the SA sampled at 32 and the occ_cp / bwt_blocks rank
    layout forced (tests/test_sharded_index.py's big-genome case)."""
    idx32 = dataclasses.replace(
        idx, sa_samp=np.ascontiguousarray(idx.sa_samp[::32]), sa_intv=32,
        _device=None)
    port = port_index(idx32)
    orig = idx32.host_arrays()

    def forced():
        h = dict(orig)
        fused = h.pop("fm_blocks")
        h["occ_cp"] = np.ascontiguousarray(fused[:, :4])
        h["bwt_blocks"] = np.ascontiguousarray(fused[:, 4:])
        return h

    idx32.host_arrays = forced
    return idx32, port


@pytest.fixture(scope="module")
def case(small_index, tmp_path_factory):
    idx, _ = small_index
    d = tmp_path_factory.mktemp("sharded_index")
    cfg = JCfg(**CFG)
    reads, lens = _batch_from_index(small_index, np.random.default_rng(11))
    reads[-3:], lens[-3:] = 4, 0  # padding rows, as a short last batch has
    pos = jfm.sample_positions_host(lens, cfg.sampling_count)
    np.savez(d / "batch.npz", reads=reads, lens=lens, pos=pos)
    idx32, port32 = _split_layout(idx)
    save_index(port_index(idx), d / "index.lft.npz")
    save_index(port32, d / "index32.lft.npz")
    return d, {"full": idx, "sampled": idx32}, (reads, lens, pos)


_RAN = {}


# the block sizes the schedule is also run at, each in one layout
# (test_block_schedule_matches_jax); the source's is SHARD_BLOCK_STEPS
BLOCK_RUNS = [(1, "fused"), (7, "split")]


def _port_ranks(case, D):
    """The port's sharded pipeline in both layouts at D ranks, and at the
    block sizes of BLOCK_RUNS (one launch per D, shared by the tests)."""
    d = case[0]
    if D not in _RAN:
        runs = [{"name": f"{name}_{D}", "index": f, "split_layout": split,
                 "shard_index": True}
                for name, (f, _, split) in LAYOUTS.items()]
        runs += [{"name": f"{name}_S{S}_{D}", "index": LAYOUTS[name][0],
                  "split_layout": LAYOUTS[name][2], "shard_index": True,
                  "S": S} for S, name in BLOCK_RUNS]
        res, dt = run_ranks("pipeline", d, D, timeout=120,
                            args={"cfg": CFG, "runs": runs})
        for rank, (rc, err) in enumerate(res):
            assert rc == 0, f"rank {rank}: {err[-3000:]}"
        _RAN[D] = dt
    return d


@pytest.mark.parametrize("D", [2, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_index_pipeline_matches_jax(case, layout, D):
    _check_against_jax(case, layout, D, f"{layout}_{D}")


@pytest.mark.parametrize("D", [2, 8])
@pytest.mark.parametrize("S,layout", BLOCK_RUNS)
def test_block_schedule_matches_jax(case, S, layout, D):
    """The sharded loops at S steps a block between reads of their flags
    (fm_index.SHARD_BLOCK_STEPS; 1: a read every step) give JAX's seeds
    and host payload too."""
    _check_against_jax(case, layout, D, f"{layout}_S{S}_{D}")


def _check_against_jax(case, layout, D, name):
    d, jidx, (reads, lens, pos) = case
    d = _port_ranks(case, D)
    idx = jidx[LAYOUTS[layout][1]]
    fn, arrs = sharded_index_pipeline(idx, JCfg(**CFG),
                                      make_mesh(jax.devices()[:D]))
    seeds, _, host = jax.device_get(fn(arrs, reads, lens, pos))
    outs = [np.load(d / f"out{r}_{name}.npz") for r in range(D)]
    for k, v in seeds._asdict().items():
        got = np.concatenate([o[f"seeds_{k}"] for o in outs])
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    assert not any(f.startswith("host_") for o in outs[1:] for f in o.files)
    got = {f[5:] for f in outs[0].files if f.startswith("host_")}
    assert got == set(host)
    for k, v in host.items():
        np.testing.assert_array_equal(outs[0][f"host_{k}"], np.asarray(v),
                                      err_msg=k)
    assert int(host["stat_chained_windows"]) > 0


@pytest.mark.parametrize("D", [2, 3])
def test_routings_match_plain_gather(tmp_path, D):
    """The routed _row_gather gives a plain gather's bits on int64
    stripes, the layout shard_index_arrays gives every striped key: rows
    of a (1001, 12) and a 1-D array (1001 rows do not divide by D, so
    the last stripe is padded), uniform, skewed onto one owner, in two
    rows like backward_ext's stacked queries, with a different count on
    each rank, tiny and empty."""
    rng = np.random.default_rng(D)
    arrays = {"i64": rng.integers(-2**40, 2**40, (1001, 12)),
              "flat": rng.integers(0, 2**32, 1001)}
    cases = [["plain", 700], ["skew", 900], ["ragged", 800],
             ["twod", 600], ["plain", 5], ["plain", 0]]
    for name, full in arrays.items():
        np.save(tmp_path / f"full_{name}.npy", full)
    res, _ = run_ranks("routing", tmp_path, D, timeout=60,
                       args={"seed": 5, "cases": cases,
                             "arrays": sorted(arrays)})
    for rank, (rc, err) in enumerate(res):
        assert rc == 0, f"rank {rank}: {err[-3000:]}"
    for name, full in arrays.items():
        for rank in range(D):
            o = np.load(tmp_path / f"out{rank}_{name}.npz")
            assert sum(f.endswith("_got") for f in o.files) == len(cases)
            for f in o.files:
                if f.endswith("_rows"):
                    continue
                want = full[o[f.rsplit("_", 1)[0] + "_rows"]]
                assert o[f].dtype == want.dtype, (name, f)
                np.testing.assert_array_equal(o[f], want,
                                              err_msg=f"{name} {f}")


def _engine_case(small_index, d):
    """tests/test_sharded_index.py's engine inputs: 12 reads of the
    small genome with 8% substitutions."""
    idx, contigs = small_index
    rng = np.random.default_rng(12)
    text = np.concatenate([np.asarray(v) for v in contigs.values()])
    with open(d / "reads.fq", "w") as f:
        for i in range(12):
            ln = int(rng.integers(300, 900))
            st = int(rng.integers(0, len(text) - ln))
            frag = text[st : st + ln].astype(np.uint8)
            mut = rng.random(ln) < 0.08
            frag = np.where(mut, rng.integers(0, 4, ln), frag)
            s = "".join("ACGT"[c] for c in frag)
            f.write(f"@r{i}\n{s}\n+\n{'I' * ln}\n")
    save_index(port_index(idx), d / "index.lft.npz")
    return dict(CFG, min_read_len=100)


def test_sharded_engine_sam_matches_jax(small_index, tmp_path):
    """MappingEngine(mesh=..., shard_index=True) at D = 2: rank 0's SAM
    equals the JAX engine's with the same sharded index and mesh size,
    byte for byte."""
    cfg = _engine_case(small_index, tmp_path)
    res, _ = run_ranks("engine", tmp_path, 2, timeout=120,
                       args={"cfg": cfg, "shard_index": True})
    for rank, (rc, err) in enumerate(res):
        assert rc == 0, f"rank {rank}: {err[-3000:]}"
    out = io.StringIO()
    JEngine(small_index[0], JCfg(**cfg), mesh=make_mesh(jax.devices()[:2]),
            shard_index=True).map_file(tmp_path / "reads.fq", out, "test")
    assert (tmp_path / "out.sam").read_text() == out.getvalue()
    stats = json.loads((tmp_path / "stats.json").read_text())["stats"]
    assert stats["reads"] == 12 and stats["mapped"] >= 10


@pytest.mark.parametrize("where", ["rank1_stage", "rank0_host"])
def test_failing_rank_fails_every_rank(small_index, tmp_path, where):
    """A rank that raises ends the run with a non-zero exit on every
    rank, well inside the group's timeout: rank 1 in its device stage
    (rank 0 then fails in the collective its peer left), or rank 0 in
    its host stages between calls (the others get its failure
    header)."""
    cfg = _engine_case(small_index, tmp_path)
    res, dt = run_ranks("engine", tmp_path, 2, timeout=120,
                        args={"cfg": cfg, "shard_index": True,
                              "fail": where})
    assert all(rc not in (0, None) for rc, _ in res), res
    assert dt < 100
    errs = [err for _, err in res]
    if where == "rank0_host":
        assert "injected failure" in errs[0]
        assert "rank 0 of the mesh failed" in errs[1]
    else:
        assert "injected failure" in errs[1]


def test_index_wait_times_out(tmp_path):
    """cli._wait_for_index: a rank launched by hand whose rank 0 never
    writes the index (or, with sidecar, its device-layout sidecar)
    raises after its limit, naming the file."""
    from lordfast_tpu_torch.cli import _wait_for_index
    from lordfast_tpu_torch.index.builder import (DEVCACHE_VERSION,
                                                  FORMAT_VERSION, _stamp)

    ipath = tmp_path / "ref.fa.lft.npz"
    with pytest.raises(TimeoutError, match="ref.fa.lft.npz"):
        _wait_for_index(ipath, tmp_path / "ref.fa", poll_s=0.05,
                        timeout_s=0.3)
    ipath.write_bytes(b"")
    _wait_for_index(ipath, tmp_path / "ref.fa", poll_s=0.05, timeout_s=0.3)
    with pytest.raises(TimeoutError, match="sidecar .*ref.fa.lft.npz.devcache"):
        _wait_for_index(ipath, tmp_path / "ref.fa", poll_s=0.05,
                        timeout_s=0.3, sidecar=True)
    side = tmp_path / "ref.fa.lft.npz.devcache"
    side.mkdir()
    meta = {"devcache_version": DEVCACHE_VERSION,
            "format_version": FORMAT_VERSION,
            "sources": {ipath.name: _stamp(ipath)}}
    (side / "meta.json").write_text(json.dumps(meta))
    _wait_for_index(ipath, tmp_path / "ref.fa", poll_s=0.05, timeout_s=0.3,
                    sidecar=True)
    # a sidecar of another index file is waited past
    ipath.write_bytes(b"another index")
    with pytest.raises(TimeoutError, match="sidecar"):
        _wait_for_index(ipath, tmp_path / "ref.fa", poll_s=0.05,
                        timeout_s=0.3, sidecar=True)


def test_sidecar_refused_once_its_index_changes(small_index, tmp_path):
    """load_index(mmap=True) maps a device-layout sidecar only while the
    index file it was made from stands as it was: an index rewritten at
    the same size (contigs renamed) is read from its file, and one
    deleted is missing, sidecar or not."""
    from lordfast_tpu_torch.index.builder import (devcache_meta, load_index,
                                                  save_device_cache,
                                                  save_index)

    idx = port_index(small_index[0])
    path = tmp_path / "ref.fa.lft.npz"
    save_index(idx, path)
    save_device_cache(idx, path)
    got = load_index(path, mmap=True)
    assert got._host_cache is not None
    assert got.contig_names == idx.contig_names
    size = path.stat().st_size
    renamed = dataclasses.replace(
        idx, contig_names=[n[:-1] + n[-1].lower() for n in idx.contig_names],
        _device=None, _host_cache=None)
    save_index(renamed, path)
    assert path.stat().st_size == size and devcache_meta(path) is None
    got = load_index(path, mmap=True)
    assert got._host_cache is None
    assert got.contig_names == renamed.contig_names
    path.unlink()
    with pytest.raises(FileNotFoundError):
        load_index(path, mmap=True)
