"""Ranks of a torch.distributed gloo group on the CPU, one OS process
each, for the port's mesh and sharded-index tests.

    python tests/torch_mesh_ranks.py JOB DIR

runs one rank of JOB (RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT in
the environment, as torchrun sets them); ``run_ranks`` starts all of
them.  Inputs and outputs are files in DIR: ``job.json`` (the job's
arguments), the port's index (``index.lft.npz`` unless the job names
another), ``batch.npz`` (reads, lens, pos) or ``reads.fq``, and
``out<rank>*.npz`` / ``out.sam`` written back.  This
module imports neither jax nor lordfast_tpu, so the ranks start fast;
the tests compare what they write with the JAX package in the pytest
process.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(cmd: list, world: int, timeout: float, env: dict | None = None,
           card_per_rank: bool = False):
    """Run ``world`` copies of ``cmd`` as the ranks of one
    torch.distributed group on this host: RANK, WORLD_SIZE, MASTER_ADDR
    and MASTER_PORT (a free local port) in each one's environment, with
    ``env`` on top; LOCAL_RANK = RANK when ``card_per_rank`` (one card a
    rank, as NCCL needs), else none (the ranks share a device).  Each
    rank's output goes to a file, so no rank blocks on a full pipe.
    Returns [(returncode, stdout, stderr)] by rank and the seconds
    taken; a rank still running at ``timeout`` is killed and reported
    with returncode None."""
    import tempfile

    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, files = [], []
        try:
            for rank in range(world):
                e = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                         MASTER_ADDR="localhost", MASTER_PORT=str(port),
                         **(env or {}))
                e.pop("LOCAL_RANK", None)
                if card_per_rank:
                    e["LOCAL_RANK"] = str(rank)
                fo = open(Path(tmp) / f"{rank}.out", "w+")
                fe = open(Path(tmp) / f"{rank}.err", "w+")
                files.append((fo, fe))
                procs.append(subprocess.Popen(
                    [str(c) for c in cmd], env=e, cwd=ROOT,
                    stdout=fo, stderr=fe))
            t0 = time.time()
            rcs = []
            for p in procs:
                try:
                    rcs.append(p.wait(max(1.0, timeout - (time.time() - t0))))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                    rcs.append(None)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        res = []
        for rc, (fo, fe) in zip(rcs, files):
            fo.seek(0)
            fe.seek(0)
            res.append((rc, fo.read(), fe.read()))
            fo.close()
            fe.close()
    return res, time.time() - t0


def run_ranks(job: str, d: Path, world: int, timeout: float = 120.0,
              args: dict | None = None):
    """Run ``world`` ranks of ``job`` on the CPU under one gloo group,
    each with one thread; returns [(returncode, stderr)] by rank and the
    seconds taken (see ``launch``)."""
    d = Path(d)
    (d / "job.json").write_text(json.dumps(args or {}))
    res, dt = launch([sys.executable, HERE, job, d], world, timeout,
                     env={"OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)})
    return [(rc, err) for rc, _, err in res], dt


# ---- the jobs, one rank each ----

def _setup(d):
    import torch

    torch.set_num_threads(1)
    from lordfast_tpu_torch.parallel.mesh import make_mesh, mesh_group

    mesh = make_mesh("cpu")
    return mesh, mesh_group(mesh), json.loads((d / "job.json").read_text())


def _index(d, args):
    from lordfast_tpu_torch.index.builder import load_index

    idx = load_index(d / args.get("index", "index.lft.npz"))
    if args.get("split_layout"):
        # the occ_cp / bwt_blocks rank layout (l_pac >= 2^32), forced
        host = dict(idx.host_arrays())
        fused = host.pop("fm_blocks")
        host["occ_cp"] = fused[:, :4].copy()
        host["bwt_blocks"] = fused[:, 4:].copy()
        idx._host_cache = host
    return idx


def job_routing(d):
    """Each rank gathers rows of striped arrays (full_<name>.npy, one
    for each of the job's names) through the routed _row_gather; writes
    what it got and the rows it asked for to out<rank>_<name>.npz."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.ops import fm_index as fm

    _, group, args = _setup(d)
    D, r = group.size(), group.rank()
    for name in args["arrays"]:
        full = np.load(d / f"full_{name}.npy")
        rps = -(-full.shape[0] // D)
        part = np.zeros((rps,) + full.shape[1:], full.dtype)
        mine = full[r * rps : (r + 1) * rps]
        part[: len(mine)] = mine
        stripe = torch.from_numpy(part)
        rng = np.random.default_rng(args["seed"] + r)
        out = {}
        for case, n in args["cases"]:
            if case == "skew":  # every row on one owner
                rows = rng.integers(0, min(rps, full.shape[0]), n)
            elif case == "ragged":  # a different count on each rank
                rows = rng.integers(0, full.shape[0], n + 3 * r)
            else:
                rows = rng.integers(0, full.shape[0], n)
            if case == "twod":  # the stacked (k-1, l) rows of backward_ext
                rows = rows.reshape(2, -1)
            out[f"{case}_{n}_rows"] = rows
            out[f"{case}_{n}_got"] = fm._row_gather(
                stripe, torch.from_numpy(rows), group).numpy()
        np.savez(d / f"out{r}_{name}.npz", **out)


def job_pipeline(d):
    """The device stage on this rank's rows of batch.npz, once for each
    of the job's runs ({"name", "index", "split_layout", "shard_index"}:
    the sharded or the replicated index); writes this rank's seeds and,
    on rank 0, the host payload to out<rank>_<name>.npz."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.parallel.mesh import sharded_pipeline
    from lordfast_tpu_torch.parallel.sharded_index import (
        sharded_index_pipeline)

    mesh, group, args = _setup(d)
    D, r = group.size(), group.rank()
    cfg = LordfastConfig(**args["cfg"])
    b = np.load(d / "batch.npz")
    Br = b["reads"].shape[0] // D
    rows = slice(r * Br, (r + 1) * Br)
    inp = [torch.from_numpy(np.ascontiguousarray(b[k][rows]))
           for k in ("reads", "lens", "pos")]
    for run in args["runs"]:
        idx = _index(d, run)
        if run["shard_index"]:
            fn, arrs = sharded_index_pipeline(idx, cfg, mesh)
            seeds, _, host = fn(arrs, *inp)
        else:
            seeds, _, host = sharded_pipeline(idx, cfg, mesh)(*inp)
        out = {f"seeds_{k}": v.numpy() for k, v in seeds._asdict().items()}
        if host is not None:
            out.update({f"host_{k}": v.numpy() for k, v in host.items()})
        np.savez(d / f"out{r}_{run['name']}.npz", **out)


def job_engine(d):
    """MappingEngine on the mesh maps reads.fq; rank 0 writes out.sam
    and the engine's stats.  ``fail``: "rank1_stage" makes rank 1's
    voting raise, "rank0_host" rank 0's stitching."""
    import io

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    mesh, group, args = _setup(d)
    idx = _index(d, args)
    eng = MappingEngine(idx, LordfastConfig(**args["cfg"]), device="cpu",
                        mesh=mesh, shard_index=args["shard_index"])

    def broken(*a, **k):
        raise RuntimeError("injected failure")

    if args.get("fail") == "rank1_stage" and group.rank() == 1:
        from lordfast_tpu_torch.ops import voting

        voting.vote_windows = broken
    if args.get("fail") == "rank0_host" and group.rank() == 0:
        eng._stitch_all = broken
    out = io.StringIO()
    eng.map_file(d / "reads.fq", out, "test")
    if group.rank() == 0:
        (d / "out.sam").write_text(out.getvalue())
        (d / "stats.json").write_text(json.dumps(
            {"stats": eng.stats, "counters": dict(eng.metrics.counters)}))


if __name__ == "__main__":
    globals()["job_" + sys.argv[1]](Path(sys.argv[2]))
    import torch.distributed as dist

    # a gloo group left to the interpreter's teardown has aborted a
    # rank (std::terminate) after its job was done
    dist.destroy_process_group()
