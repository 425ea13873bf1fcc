"""The PyTorch port's multi-process path (parallel/multihost.py and the
CLI's --numProcesses / --processIndex / --coordinator / --mergeShards) on
the CPU, on the committed fixture split into chunks, against the
single-process run: two in-process "hosts" and their ordered merge, two
OS processes under one torch.distributed gloo group with the rank-0
merge, and --mergeShards on its own.  The merged SAM must equal the
single-process SAM (byte for byte in process, @PG aside through the
CLI), as tests/test_multihost.py requires of the JAX package."""

import io
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lordfast_tpu_torch import cli
from lordfast_tpu_torch.config import LordfastConfig
from lordfast_tpu_torch.index.builder import index_path_for, save_index
from lordfast_tpu_torch.parallel.multihost import (merge_shards, shard_path,
                                                   write_chunk_table)
from lordfast_tpu_torch.pipeline.engine import MappingEngine

from test_multihost import TEST_CFG
from test_torch_fm_index import port_index

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
COMMON = ["--minReadLen", "100", "--chunkSize", "40000", "--device", "cpu"]

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cli_case(ref8_idx, tmp_path_factory):
    """The fixture's reference with its k=8 index saved beside it, and
    the single-process CLI run's SAM."""
    d = tmp_path_factory.mktemp("mh")
    ref = d / "ref.fa"
    ref.write_bytes((DATA / "ref.fa").read_bytes())
    save_index(port_index(ref8_idx), index_path_for(ref))
    single = d / "single.sam"
    args = ["--search", str(ref), "--seq", str(DATA / "reads.fq"), *COMMON]
    assert cli.main(args + ["-o", str(single)]) == 0
    return d, args, single


def _body(path):
    return [l for l in Path(path).read_text().splitlines()
            if not l.startswith("@PG")]


def test_chunk_sharding_and_merge(ref8_idx, tmp_path):
    idx = port_index(ref8_idx)
    cfg = LordfastConfig(**TEST_CFG)
    seq = DATA / "reads.fq"
    base = io.StringIO()
    eng = MappingEngine(idx, cfg, device="cpu")
    eng.map_file(seq, base, "cmd")
    assert eng.stats["chunks"] >= 3

    out = tmp_path / "multi.sam"
    for pid in range(2):
        part = shard_path(out, pid)
        e = MappingEngine(idx, cfg, device="cpu")
        with open(part, "w") as f:
            e.map_file(seq, f, "cmd", process_index=pid, num_processes=2)
        write_chunk_table(part, e.chunk_table)
        assert e.chunk_table
        assert all(cid % 2 == pid for cid, _, _ in e.chunk_table)
    assert merge_shards(out, 2) == eng.stats["chunks"]
    assert out.read_text() == base.getvalue()
    assert not Path(shard_path(out, 0)).exists()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_coordinator_merge(cli_case):
    d, args, single = cli_case
    merged = d / "merged.sam"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "lordfast_tpu_torch.cli", *args,
             "-o", str(merged), "--numProcesses", "2", "--processIndex",
             str(pid), "--coordinator", f"localhost:{port}"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert "merged" in outs[0][1]
    assert _body(merged) == _body(single)
    assert not Path(shard_path(merged, 1)).exists()


def test_merge_shards_cli(cli_case, monkeypatch):
    """Two shard runs with no coordinator (the second takes its index
    from LORDFAST_PROCESS_INDEX), then --mergeShards alone."""
    d, args, single = cli_case
    out = d / "by_hand.sam"
    shard = args + ["-o", str(out), "--numProcesses", "2"]
    assert cli.main(shard + ["--processIndex", "0"]) == 0
    monkeypatch.setenv("LORDFAST_PROCESS_INDEX", "1")
    assert cli.main(shard) == 0
    assert not out.exists()
    assert Path(shard_path(out, 1)).exists()
    assert cli.main(["--mergeShards", "-o", str(out),
                     "--numProcesses", "2"]) == 0
    assert _body(out) == _body(single)
