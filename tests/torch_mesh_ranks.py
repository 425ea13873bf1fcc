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

import itertools
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


def job_routes(d):
    """Each rank gathers rows of striped arrays (full_<name>.npy) on every
    route of fm_index's gathers: the exact gather (_row_gather: routed,
    the all-gather route after an overflow), the all-gather route alone
    and the routed buckets alone at cap shard_cap(n) (_route_gather; its
    overflow flag as this rank left it) and the exact gather of the live queries only (a
    seeded half); writes rows, results and flags to
    out<rank>_<name>.npz.  Cases: (name, n, "uniform" or "skew": every
    row on owner 0)."""
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
        out = {}
        for case, n, kind in args["cases"]:
            rng = np.random.default_rng([args["seed"], r, n])
            hi = min(rps, full.shape[0]) if kind == "skew" else full.shape[0]
            rows = torch.from_numpy(rng.integers(0, hi, n))
            live = torch.from_numpy(rng.random(n) < 0.5)
            flags = torch.zeros(2, dtype=torch.int32)
            routed = fm._route_gather(stripe, rows, fm.ShardRoute(
                group, fm.shard_cap(n, D), flags))
            ag = fm._route_gather(stripe, rows, fm.ShardRoute(
                group, None, torch.zeros(2, dtype=torch.int32)))
            out.update({f"{case}_rows": rows.numpy(), f"{case}_live":
                        live.numpy(), f"{case}_routed": routed.numpy(),
                        f"{case}_over": flags[1].numpy(),
                        f"{case}_ag": ag.numpy(),
                        f"{case}_exact": fm._row_gather(stripe, rows,
                                                        group).numpy(),
                        f"{case}_masked": fm._row_gather(
                            stripe, rows, group, live).numpy()})
        np.savez(d / f"out{r}_{name}.npz", **out)


def _rank_rows(d, D, r):
    """This rank's rows of batch.npz (reads, lens, pos) as tensors."""
    import numpy as np
    import torch

    b = np.load(d / "batch.npz")
    Br = b["reads"].shape[0] // D
    rows = slice(r * Br, (r + 1) * Br)
    return [torch.from_numpy(np.ascontiguousarray(b[k][rows]))
            for k in ("reads", "lens", "pos")]


def _kernel_route(fm, K):
    """Point fm_index's sharded loops and SA entries' gather at
    fm_shard_cuda's (shard_ext, shard_walk, sa_gather: the block schedule
    and the exact gather over the four wrappers), looked up at call time
    as the pipeline does on the card, so that a stand-in at K's
    attribute (chip_smoke.record_shard) sees the calls."""
    fm._shard_ext = lambda *a: K.shard_ext(*a)
    fm._shard_walk = lambda *a: K.shard_walk(*a)
    fm._sa_gather = lambda *a: K.sa_gather(*a)


# the blocks of the edge lanes' model run (job_shard_model) whose cap is
# forced to 8: the first, with every lane alive, and one in the 16
# MAX_ANCHOR_LEN lanes' long tail
EDGE_REDONE = (0, 300)


def job_shard_model(d):
    """The sharded seeding of this rank's rows of batch.npz through the
    plain loops (fm_index._shard_ext / _shard_walk), through the kernels'
    loops over the wrappers' plain versions and over the numpy model of
    seed_shard.cu
    (torch_shard_model, the buckets' slots in a random order), at the
    source's block size and with every bucket's cap forced to 8 (every
    routed block overflows and runs again); then, for a run with "edge",
    the extension of chip_smoke.edge_reads' lanes (at "edge_S" steps a
    block) through the plain loop, through the kernels' loop over the
    model with the cap forced to 8 on EDGE_REDONE's blocks (which run
    again through the all-gather route) and over the replicated index.
    Writes every result
    and the loops' counts to out<rank>_<run name>.npz for each run
    ({"name", "index", "split_layout", "edge"})."""
    import numpy as np
    import torch

    import chip_smoke
    import torch_shard_model as model
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.ops import fm_index as fm
    from lordfast_tpu_torch.ops import fm_shard_cuda as K
    from lordfast_tpu_torch.parallel.sharded_index import shard_index_arrays

    mesh, group, args = _setup(d)
    D, r = group.size(), group.rank()
    cfg = LordfastConfig(**args["cfg"])
    reads, lens, pos = _rank_rows(d, D, r)
    plain = (fm._shard_ext, fm._shard_walk, fm._sa_gather)
    cap = fm.shard_cap

    def seed(arrs, meta):
        fm.shard_counts.update(dict.fromkeys(fm.shard_counts, 0))
        sb = fm._seed_anchors_impl(
            arrs, reads, lens, pos, meta, cfg.sampling_count,
            cfg.min_anchor_len, cfg.max_ref_hits, cfg.max_seeds_per_read,
            cfg.seed_phase1_steps, group=group)
        return sb, dict(fm.shard_counts)

    for run in args["runs"]:
        idx = _index(d, run)
        meta = idx.meta
        arrs = shard_index_arrays(idx, mesh)
        out = {}
        fm._shard_ext, fm._shard_walk, fm._sa_gather = plain
        got, counts = seed(arrs, meta)
        out.update({f"plain_{k}": v.numpy()
                    for k, v in got._asdict().items()})
        out["plain_counts"] = np.array(list(counts.values()))
        # the kernels' loops over the wrappers' own plain versions (the
        # CPU path of fm_shard_cuda), then over the model
        _kernel_route(fm, K)
        with chip_smoke.record_shard() as rec:
            got, counts = seed(arrs, meta)
        out.update({f"wrap_{k}": v.numpy()
                    for k, v in got._asdict().items()})
        out["wrap_counts"] = np.array(list(counts.values()))
        # what the pass itself recorded (its first calls and the loops'),
        # then the smoke's checks of the kernels against their plain
        # versions (here both are the plain ones), which find the sparse
        # steps by replaying the loops, and its bytes bound, on the CPU
        out["recorded"] = np.array(sorted(rec.calls))
        figs = chip_smoke.check_shard_kernels(rec)
        out["checked"] = np.array(sorted(figs))
        out["work"] = np.array([chip_smoke.shard_work(
            n.split()[0], *rec.calls[n]) for n in sorted(figs)])
        saved = model.install(K, np.random.default_rng([7, r]))
        for tag, c in (("model", cap), ("over", lambda n, D: 8)):
            fm.shard_cap = c
            got, counts = seed(arrs, meta)
            out.update({f"{tag}_{k}": v.numpy()
                        for k, v in got._asdict().items()})
            out[f"{tag}_counts"] = np.array(list(counts.values()))
        fm.shard_cap = cap
        fm._shard_ext, fm._shard_walk, fm._sa_gather = plain
        (K.shard_bucket, K.shard_answer, K.shard_ext_step,
         K.shard_walk_step) = saved
        out["counts_keys"] = np.array(list(fm.shard_counts))
        if not run.get("edge"):
            np.savez(d / f"out{r}_{run['name']}.npz", **out)
            continue
        full = idx.device_arrays("cpu")
        rd, lanes = _edge_lanes(chip_smoke, full, meta)
        S = fm.SHARD_BLOCK_STEPS
        fm.SHARD_BLOCK_STEPS = args["edge_S"]
        blocks = itertools.count()

        def forced(n, D):
            return 8 if next(blocks) in EDGE_REDONE else cap(n, D)

        saved = model.install(K, np.random.default_rng([11, r]))
        for tag, fn, c in (("edge_plain", plain[0], cap),
                           ("edge_model", K.shard_ext, forced)):
            fm.shard_cap = c
            fm.shard_counts.update(dict.fromkeys(fm.shard_counts, 0))
            res = fn(arrs, meta, rd, *lanes, group)
            out.update({f"{tag}_{k}": v.numpy()
                        for k, v in zip("klm", res)})
            out[f"{tag}_counts"] = np.array(list(fm.shard_counts.values()))
        fm.SHARD_BLOCK_STEPS, fm.shard_cap = S, cap
        (K.shard_bucket, K.shard_answer, K.shard_ext_step,
         K.shard_walk_step) = saved
        a, k, l, m = lanes[:4]
        while bool(a.any()):
            a, k, l, m = fm._ext_step(full, meta, rd, a, k, l, m, *lanes[4:])
        out.update({"edge_repl_k": k.numpy(), "edge_repl_l": l.numpy(),
                    "edge_repl_m": m.numpy()})
        np.savez(d / f"out{r}_{run['name']}.npz", **out)


def _edge_lanes(chip_smoke, full, meta):
    """chip_smoke.edge_reads' reads and lanes (one lane a read, over the
    whole interval) as an fm_index._Reads and int64 / bool tensors."""
    import numpy as np
    import torch

    from lordfast_tpu_torch.ops import fm_index as fm

    text = chip_smoke.text_of(full, meta)
    reads, lens, _, _, lanes = chip_smoke.edge_reads(
        np.random.default_rng(5), text, meta["seq_len"])
    rd = fm._Reads(torch.from_numpy(reads), torch.from_numpy(lens))
    return rd, [torch.from_numpy(x) for x in lanes]


def job_pipeline(d):
    """The device stage on this rank's rows of batch.npz, once for each
    of the job's runs ({"name", "index", "split_layout", "shard_index"}:
    the sharded or the replicated index, and "S", the sharded loops'
    steps a block, else the source's); writes this rank's seeds and, on
    rank 0, the host payload to out<rank>_<name>.npz."""
    import numpy as np

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.parallel.mesh import sharded_pipeline
    from lordfast_tpu_torch.parallel.sharded_index import (
        sharded_index_pipeline)

    from lordfast_tpu_torch.ops import fm_index as fm

    mesh, group, args = _setup(d)
    D, r = group.size(), group.rank()
    cfg = LordfastConfig(**args["cfg"])
    inp = _rank_rows(d, D, r)
    for run in args["runs"]:
        fm.SHARD_BLOCK_STEPS = run.get("S", fm.SHARD_BLOCK_STEPS)
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
