"""The PyTorch port's device stage and engine against the JAX package:
the device stage's host payload on the fixture's first batch (integers
exact, chain scores to rtol 1e-12: float64 DP, last-bit log differences
only), the port's engine on the CPU byte-equal to the golden SAM, and
the CLI and engine refusing what the JAX package refuses."""

import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.ops import fm_index as jfm
from lordfast_tpu.parallel import mesh as jmesh
from lordfast_tpu_torch import cli
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.io.fastx import read_chunks
from lordfast_tpu_torch.pipeline import device_stage
from lordfast_tpu_torch.pipeline.engine import MappingEngine
from lordfast_tpu_torch.utils.pack import seq_to_codes

from test_golden import TEST_CFG
from test_torch_fm_index import port_index

DATA = Path(__file__).parent / "data"

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_idx(ref8_idx):
    return port_index(ref8_idx)


def _first_batch(cfg):
    """The engine's first read batch: length-sorted in-range reads,
    padded to batch_reads rows and a length bucket."""
    reads = [r for c in read_chunks(DATA / "reads.fq", cfg.chunk_bytes)
             for r in c]
    work = sorted((r for r in reads
                   if cfg.min_read_len <= len(r.seq) <= cfg.seq_max_length),
                  key=lambda r: len(r.seq))[: cfg.batch_reads]
    L = 1024
    while L < max(len(r.seq) for r in work):
        L *= 2
    arr = np.full((cfg.batch_reads, L), 4, np.uint8)
    lens = np.zeros(cfg.batch_reads, np.int32)
    for j, r in enumerate(work):
        arr[j, : len(r.seq)] = seq_to_codes(r.seq)
        lens[j] = len(r.seq)
    return arr, lens


def test_device_stage_host_out_matches_jax(ref8_idx, port_idx):
    jcfg, tcfg = JCfg(**TEST_CFG).validate(), TCfg(**TEST_CFG).validate()
    arr, lens = _first_batch(jcfg)
    pos = jfm.sample_positions_host(lens, jcfg.sampling_count)
    jfn = jax.jit(jmesh.device_pipeline(ref8_idx.meta, jcfg))
    _, _, want = jfn(ref8_idx.device_arrays(), arr, lens, pos)
    tfn = device_stage.device_pipeline(port_idx.meta, tcfg)
    _, _, got = tfn(port_idx.device_arrays("cpu"), torch.from_numpy(arr),
                    torch.from_numpy(lens), torch.from_numpy(pos))
    assert set(got) == set(want)
    assert int(want["stat_chained_windows"]) > 50
    for k in sorted(want):
        w, g = np.asarray(want[k]), got[k].numpy()
        if k == "chain_score":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _map(engine, reads_path):
    out = io.StringIO()
    engine.map_file(reads_path, out, "test")
    return [l for l in out.getvalue().splitlines() if not l.startswith("@")]


def test_port_engine_cpu_matches_golden_sam(port_idx):
    eng = MappingEngine(port_idx, TCfg(**TEST_CFG), device="cpu")
    ours = _map(eng, DATA / "reads.fq")
    golden = [l.rstrip("\n") for l in open(DATA / "golden.sam")
              if not l.startswith("@")]
    assert len(ours) == len(golden)
    for i, (a, b) in enumerate(zip(golden, ours)):
        assert a == b, f"line {i} differs:\nG: {a[:200]}\nO: {b[:200]}"
    # every gap bucket the fixture reaches went through the gap DP
    c = eng.metrics.counters
    assert c["gaps_b32"] > 0 and c["gaps_b2048"] > 0 and c["gap_parts"] >= 5


class _CpuMesh:
    """What the engine reads of a DeviceMesh before it builds anything."""

    device_type = "cpu"


@pytest.mark.parametrize("kw", [dict(shard_index=True, mesh=None),
                                dict(shard_index=False, mesh=_CpuMesh()),
                                dict(shard_index=True, mesh="cuda")])
def test_engine_refuses_unported_options(port_idx, kw):
    """The mesh and the sharded index are ported
    (tests/test_torch_mesh.py, tests/test_torch_sharded_index.py); the
    engine refuses what the JAX engine refuses, shard_index without a
    mesh, and a mesh on another device type than ``device``, and
    make_mesh("cuda") without a usable card raises rather than run on
    the CPU."""
    if kw["mesh"] == "cuda":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        from lordfast_tpu_torch.parallel.mesh import make_mesh

        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh("cuda")
        return
    with pytest.raises(ValueError):
        MappingEngine(port_idx, TCfg(**TEST_CFG), device="cuda", **kw)


def test_engine_refuses_dormant_seeders(port_idx):
    """The dormant seeders are ported (tests/test_torch_seeders.py): the
    engine takes them and seeds on the host."""
    for seeder in ("extend-whole-2", "extend-whole-3"):
        eng = MappingEngine(port_idx, TCfg(**TEST_CFG, seeder=seeder),
                            device="cpu")
        arr = np.full((2, 1024), 4, np.uint8)
        arr[0] = seq_to_codes(next(iter(read_chunks(
            DATA / "reads.fq", 1 << 20)))[0].seq[:1024])
        seeds = eng._host_seeds(arr, np.array([1024, 0], np.int32))
        assert seeds.t_pos.dtype == torch.int32
        assert seeds.q_pos.dtype == seeds.length.dtype == torch.int32
        assert seeds.is_rev.dtype == seeds.valid.dtype == torch.bool
        assert int(seeds.n_total[0]) > 0 and int(seeds.n_total[1]) == 0


def test_cli_refuses_cuda_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = cli.main(["--search", str(DATA / "ref.fa"), "--seq",
                   str(DATA / "reads.fq"), "-o", str(tmp_path / "o.sam"),
                   "--device", "cuda"])
    assert rc == 1
    assert "cuda" in capsys.readouterr().err
    assert not (tmp_path / "o.sam").exists()


@pytest.mark.parametrize("flags", [["--shardIndex"], ["--numProcesses", "2"],
                                   ["--seeder", "extend-whole-3"],
                                   ["-a", "clasp"], ["--profile", "p"],
                                   ["--mergeShards"]])
def test_cli_refuses_unported_flags(tmp_path, capsys, flags):
    """Every flag of the JAX CLI is ported
    (tests/test_torch_{multihost,seeders,clasp,profile,mesh}.py) and
    parses; the CLI refuses only --shardIndex with --numProcesses > 1
    (chunk shards map their own chunks, the sharded index needs every
    rank in the same calls), before it reads anything."""
    args = ["--search", str(DATA / "ref.fa"), "--seq",
            str(DATA / "reads.fq"), "-o", str(tmp_path / "o.sam"),
            "--device", "cpu", *flags]
    parsed = cli.build_parser().parse_args(args)
    assert parsed.shardIndex == (flags == ["--shardIndex"])
    if flags == ["--shardIndex"]:
        assert cli.main(args + ["--numProcesses", "2"]) == 1
        err = capsys.readouterr().err
        assert "--shardIndex" in err and "--numProcesses" in err
        assert "torchrun" in err
        assert not (tmp_path / "o.sam").exists()
