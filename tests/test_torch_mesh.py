"""The port's mesh over reads (lordfast_tpu_torch/parallel/mesh.py and
MappingEngine(mesh=...)) against the JAX package's
(lordfast_tpu/parallel/mesh.py, lordfast_tpu/pipeline/engine.py) at the
same mesh size on the same inputs, and --shardIndex under torchrun
against the single-process CLI.

The port runs one process per rank under a gloo group on the CPU
(tests/torch_mesh_ranks.py, one thread each, with a timeout); the JAX
package runs in this process on the 8-CPU-device mesh of conftest.py.
The tolerance is exact equality: integers, float bits and SAM bytes.
"""

import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.index.builder import build_index as j_build_index
from lordfast_tpu.ops import fm_index as jfm
from lordfast_tpu.parallel.mesh import make_mesh, sharded_pipeline
from lordfast_tpu.pipeline.engine import MappingEngine as JEngine
from lordfast_tpu_torch import cli
from lordfast_tpu_torch.index.builder import index_path_for, save_index

from test_compact_overflow import CFG as OVERFLOW_CFG, _make_repeat_case
from test_engine_features import TEST_CFG
from test_sharded_index import CFG, _batch_from_index
from test_torch_fm_index import port_index
from test_torch_sharded_index import _engine_case
from torch_mesh_ranks import ROOT, free_port, run_ranks

DATA = Path(__file__).parent / "data"


def _check(res):
    for rank, (rc, err) in enumerate(res):
        assert rc == 0, f"rank {rank}: {err[-3000:]}"


def _jax_sam(idx, cfg, fq, D):
    out = io.StringIO()
    JEngine(idx, JCfg(**cfg), mesh=make_mesh(jax.devices()[:D])).map_file(
        fq, out, "test")
    return out.getvalue()


@pytest.mark.parametrize("D", [1, 2])
def test_mesh_engine_sam_matches_jax(ref8_idx, tmp_path, D):
    """MappingEngine(mesh=...) with the index whole on every rank maps
    the golden fixture at batch_reads 16 (tests/test_engine_features.py):
    rank 0's SAM equals the JAX engine's on a mesh of the same size."""
    shutil.copy(DATA / "reads.fq", tmp_path / "reads.fq")
    save_index(port_index(ref8_idx), tmp_path / "index.lft.npz")
    res, _ = run_ranks("engine", tmp_path, D, timeout=120,
                       args={"cfg": TEST_CFG, "shard_index": False})
    _check(res)
    want = _jax_sam(ref8_idx, TEST_CFG, DATA / "reads.fq", D)
    assert (tmp_path / "out.sam").read_text() == want
    stats = json.loads((tmp_path / "stats.json").read_text())["stats"]
    assert stats["batches"] == -(-stats["reads"] // 16) > 1


@pytest.mark.parametrize("D", [2, 8])
def test_mesh_pipeline_matches_jax(small_index, tmp_path, D):
    """sharded_pipeline (the read axis split, the index whole): the
    seeds of every rank's rows and rank 0's host payload equal JAX's
    sharded_pipeline at the same mesh size, bit for bit."""
    idx, _ = small_index
    cfg = JCfg(**CFG)
    reads, lens = _batch_from_index(small_index, np.random.default_rng(21))
    reads[-3:], lens[-3:] = 4, 0  # padding rows, as a short last batch has
    pos = jfm.sample_positions_host(lens, cfg.sampling_count)
    np.savez(tmp_path / "batch.npz", reads=reads, lens=lens, pos=pos)
    save_index(port_index(idx), tmp_path / "index.lft.npz")
    res, _ = run_ranks("pipeline", tmp_path, D, timeout=120, args={
        "cfg": CFG, "runs": [{"name": "repl", "shard_index": False}]})
    _check(res)
    fn = sharded_pipeline(idx, cfg, make_mesh(jax.devices()[:D]))
    seeds, _, host = jax.device_get(fn(reads, lens, pos))
    outs = [np.load(tmp_path / f"out{r}_repl.npz") for r in range(D)]
    for k, v in seeds._asdict().items():
        got = np.concatenate([o[f"seeds_{k}"] for o in outs])
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    for k, v in host.items():
        np.testing.assert_array_equal(outs[0][f"host_{k}"], np.asarray(v),
                                      err_msg=k)
    assert int(host["stat_chained_windows"]) > 0


def test_solo_retry_on_mesh(tmp_path):
    """A read whose windows overflow the shared and the 8x budgets runs
    alone in a batch of D rows (the read at row 0, D - 1 empty rows)
    with ceil(512 / D) window slots a read: at D = 2 the SAM equals the
    JAX engine's on a mesh of two (tests/test_compact_overflow.py's
    repeat case)."""
    fa, fq = _make_repeat_case(tmp_path, np.random.default_rng(77), 150)
    jidx = j_build_index(fa, JCfg(**OVERFLOW_CFG), verbose=False)
    save_index(port_index(jidx), tmp_path / "index.lft.npz")
    shutil.copy(fq, tmp_path / "reads.fq")
    res, _ = run_ranks("engine", tmp_path, 2, timeout=120,
                       args={"cfg": OVERFLOW_CFG, "shard_index": False})
    _check(res)
    assert (tmp_path / "out.sam").read_text() == _jax_sam(
        jidx, OVERFLOW_CFG, fq, 2)
    counters = json.loads((tmp_path / "stats.json").read_text())["counters"]
    assert counters["compact_retry"] >= 1 and counters["compact_solo"] >= 1


def test_mesh_dormant_seeder_sam_matches_jax(small_index, tmp_path):
    """A dormant seeder on a mesh of two: each rank seeds its own rows on
    the host, then the post-seed stage runs split over the ranks; the
    SAM equals the JAX engine's on a mesh of two."""
    cfg = dict(_engine_case(small_index, tmp_path), seeder="extend-whole-3")
    res, _ = run_ranks("engine", tmp_path, 2, timeout=120,
                       args={"cfg": cfg, "shard_index": False})
    _check(res)
    assert (tmp_path / "out.sam").read_text() == _jax_sam(
        small_index[0], cfg, tmp_path / "reads.fq", 2)


def _torchrun_cli(small_index, tmp_path, prebuilt):
    """torchrun --nproc_per_node 2 -m lordfast_tpu_torch.cli --shardIndex
    --device cpu on the engine case's reads; returns (the torchrun
    process, rank 0's SAM, the single-process CLI's SAM, run after it on
    the same index).  prebuilt: save the index first; else rank 0 builds
    it while rank 1 waits for the file."""
    _engine_case(small_index, tmp_path)
    idx, contigs = small_index
    ref = _write_ref(tmp_path, contigs)
    if prebuilt:
        save_index(port_index(idx), index_path_for(ref))
    return _sharded_and_single(tmp_path, ref)


def _write_ref(tmp_path, contigs):
    ref = tmp_path / "ref.fa"
    with open(ref, "w") as f:
        for name, codes in contigs.items():
            f.write(f">{name}\n" + "".join("ACGT"[c] for c in codes) + "\n")
    return ref


def _sharded_and_single(tmp_path, ref):
    """(the torchrun process, rank 0's SAM, the single-process CLI's SAM)
    of _torchrun_cli on the index of ref as it stands."""
    args = ["--search", str(ref), "--seq", str(tmp_path / "reads.fq"),
            "--minReadLen", "100", "--device", "cpu"]
    sharded = tmp_path / "sharded.sam"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(free_port()), "-m",
         "lordfast_tpu_torch.cli", *args, "-o", str(sharded),
         "--shardIndex"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    single = tmp_path / "single.sam"
    assert cli.main(args + ["-o", str(single)]) == 0

    def body(p):
        return [l for l in p.read_text().splitlines()
                if not l.startswith("@PG")]

    return r, body(sharded), body(single)


def test_torchrun_cli_shard_index(small_index, tmp_path):
    """torchrun --shardIndex: rank 0's SAM equals the single-process
    CLI's, @PG aside; the other rank writes nothing."""
    r, sharded, single = _torchrun_cli(small_index, tmp_path, True)
    assert sharded == single
    assert len(single) > 12
    assert r.stderr.count("[NOTE] processed 12 reads") == 1


def test_torchrun_cli_shard_index_builds_missing_index(small_index,
                                                       tmp_path):
    """torchrun --shardIndex with no saved index: rank 0 builds it
    (once) and renames it into place while rank 1 waits for the file
    outside any collective; the SAM equals the single-process CLI's on
    that index."""
    r, sharded, single = _torchrun_cli(small_index, tmp_path, False)
    assert sharded == single and len(single) > 12
    assert r.stderr.count("could not locate index file") == 1
    assert sorted(p.name for p in tmp_path.glob("ref.fa.lft*")) == [
        "ref.fa.lft.npz", "ref.fa.lft.npz.devcache"]


SIDECAR_NOTE = "index memory-mapped from its device-layout sidecar"


def test_torchrun_cli_shard_index_shares_one_sidecar(small_index,
                                                      tmp_path):
    """One index copy a host: torchrun --shardIndex (gloo, D = 2) on an
    index without a device-layout sidecar, rank 0 writes it (renamed into
    place whole) and both ranks map it; a second run finds it, writes
    nothing, and both ranks map it again; each SAM equals the
    single-process CLI's."""
    from lordfast_tpu_torch.index.builder import devcache_dir_for

    r, sharded, single = _torchrun_cli(small_index, tmp_path, True)
    assert sharded == single and len(single) > 12
    assert r.stderr.count(SIDECAR_NOTE) == 2
    for rank in (0, 1):
        assert f"rank {rank}: {SIDECAR_NOTE}" in r.stderr
    side = devcache_dir_for(index_path_for(tmp_path / "ref.fa"))
    assert (side / "meta.json").exists()
    assert not list(tmp_path.glob("*.tmp*"))
    stamp = {p.name: p.stat().st_mtime_ns for p in side.iterdir()}
    r, sharded, single = _torchrun_cli(small_index, tmp_path, False)
    assert sharded == single
    assert r.stderr.count(SIDECAR_NOTE) == 2
    assert "could not locate index file" not in r.stderr
    assert {p.name: p.stat().st_mtime_ns for p in side.iterdir()} == stamp


def test_torchrun_cli_shard_index_after_rebuild(small_index, tmp_path):
    """A sidecar stands only for the index file it was made from.  After
    a run writes one, --index rebuilds the index from a FASTA with the
    contigs in the other order and removes the sidecar; then the index
    file is rewritten behind the CLI's back, from the first FASTA, at
    the first file's size, so the sidecar left is stale.  Each time rank 0 alone writes a new sidecar, both ranks map
    it, and the sharded SAM (gloo, D = 2) equals the single-process
    CLI's on the index as it stands."""
    from lordfast_tpu_torch.index.builder import (devcache_dir_for,
                                                  devcache_meta)

    r, first, single = _torchrun_cli(small_index, tmp_path, True)
    assert first == single and len(single) > 12
    idx, contigs = small_index
    ipath = index_path_for(tmp_path / "ref.fa")
    ref = _write_ref(tmp_path, dict(reversed(list(contigs.items()))))
    size = ipath.stat().st_size
    assert cli.main(["--index", str(ref)]) == 0
    assert not devcache_dir_for(ipath).exists()
    r, second, single = _sharded_and_single(tmp_path, ref)
    assert second == single and second != first
    assert r.stderr.count(SIDECAR_NOTE) == 2
    assert devcache_meta(ipath) is not None
    _write_ref(tmp_path, contigs)
    save_index(port_index(idx), ipath)
    assert ipath.stat().st_size == size and devcache_meta(ipath) is None
    r, third, single = _sharded_and_single(tmp_path, ref)
    assert third == single == first
    assert r.stderr.count(SIDECAR_NOTE) == 2
    assert not list(tmp_path.glob("*.tmp*"))
