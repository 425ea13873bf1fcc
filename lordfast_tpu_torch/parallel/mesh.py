"""Data parallelism over reads: one process per device under
torch.distributed.

Port of ``lordfast_tpu/parallel/mesh.py``.  The mesh is a 1-D
``DeviceMesh`` whose dimension is named ``"data"``, one rank per device
(NCCL on cards, gloo on the CPU).  The read batch is split over its
ranks, B / D rows each; with ``sharded_pipeline`` every rank holds the
whole index, with parallel/sharded_index.py each holds a stripe of it.

Voting and chaining are per read and per window, but the window
compaction (ops/chain.py ``compact_candidates``) takes the top K = B x
compact_windows_per_read windows of the whole batch; under ``jax.jit``
XLA partitions that with collectives of its own.  Here every rank
all-gathers the candidate rows, compacts the whole batch's windows the
same way, and chains the windows of its own reads; rank 0 receives the
chains in window order and builds the host payload of the whole batch,
so the result is the single-device pipeline's bit for bit.
"""

from __future__ import annotations

import functools
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from ..ops import chain as chain_ops
from ..ops import fm_index as fm_ops
from ..ops import voting as vote_ops
from ..pipeline.device_stage import (device_pipeline, host_payload,
                                     post_seed_stage)
from ..utils.metrics import named_range

__all__ = ["make_mesh", "mesh_group", "mesh_device", "device_pipeline",
           "post_seed_stage", "post_seed_stage_sharded", "sharded_pipeline"]

# A collective that waits longer than this fails the run on every rank.
# Ranks > 0 wait in a broadcast while rank 0 reads a chunk and stitches
# a batch (seconds), and in the group's set-up while the slowest rank
# loads the index; the limit is parallel/multihost.py's.
TIMEOUT_S = 1800


def make_mesh(device_type: str = "cuda"):
    """A 1-D DeviceMesh named "data" over every rank of the default
    process group.  Without one, the group is set up first: torchrun's
    (RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT in the environment) or
    else a group of one; NCCL for cuda, gloo for cpu.  cuda without a
    usable card is an error, never a quiet run on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..pipeline.engine import resolve_device

    resolve_device(device_type)
    if device_type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        timeout = timedelta(seconds=TIMEOUT_S)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, timeout=timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, timeout=timeout)
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def mesh_group(mesh):
    """The process group of the mesh's "data" dimension."""
    return mesh.get_group("data")


def mesh_device(mesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _pack_cands(cands, lens, n_total):
    """One int64 row per read: win_id | is_rev | cnt | valid (C each),
    is_fine, min_score's bits, lens, n_total."""
    col = [cands.is_fine, cands.min_score.view(torch.int32), lens, n_total]
    return torch.cat([cands.win_id.long(), cands.is_rev.long(),
                      cands.cnt.long(), cands.valid.long()]
                     + [c.long()[:, None] for c in col], dim=1)


def _unpack_cands(rows, like, lens_dtype, n_total_dtype):
    """_pack_cands' inverse: (CandidateBatch, lens, n_total); ``like``
    gives the fields' dtypes."""
    C = like.cnt.shape[1]
    part = [rows[:, i * C : (i + 1) * C] for i in range(4)]
    col = [rows[:, 4 * C + i] for i in range(4)]
    cands = vote_ops.CandidateBatch(
        win_id=part[0].to(like.win_id.dtype),
        is_rev=part[1] != 0,
        cnt=part[2].to(like.cnt.dtype),
        valid=part[3] != 0,
        is_fine=col[0] != 0,
        min_score=col[1].to(torch.int32).view(torch.float32),
    )
    return cands, col[2].to(lens_dtype), col[3].to(n_total_dtype)


def _pack_chains(ch):
    """One int64 row per window: q_pos | t_pos | length (N each),
    chain_len, score's bits."""
    return torch.cat([ch.q_pos.long(), ch.t_pos.long(), ch.length.long(),
                      ch.chain_len.long()[:, None],
                      ch.score.view(torch.int32).long()[:, None]], dim=1)


def _unpack_chains(rows, N, t_dtype):
    return chain_ops.ChainBatch(
        q_pos=rows[:, :N].to(torch.int32),
        t_pos=rows[:, N : 2 * N].to(t_dtype),
        length=rows[:, 2 * N : 3 * N].to(torch.int32),
        chain_len=rows[:, 3 * N].to(torch.int32),
        score=rows[:, 3 * N + 1].to(torch.int32).view(torch.float32),
    )


def post_seed_stage_sharded(arrs, seeds, reads, lens, cfg, group,
                            page=None, plain: bool = False):
    """post_seed_stage with the batch's rows split over ``group``: every
    rank passes its B_r rows (rank r holds rows [r B_r, (r+1) B_r) of
    the batch) and calls this at the same time.

    One all-gather of the candidate rows, then the whole batch's window
    compaction on every rank, then each rank selects and chains the
    windows of its own reads (the invalid compact slots read row 0, so
    rank 0 chains them, as the single-device stage does), and one
    all_to_all_single with split sizes sends the chains to rank 0, which
    puts them in window order.  Returns (seeds, chains, host_out) on rank
    0, for the whole batch; (seeds, chains, None) elsewhere, for the
    rank's own rows and windows.  plain: chain through the plain DP on
    a CUDA device too (device_stage.device_pipeline's)."""
    dev = reads.device
    D, d = group.size(), group.rank()
    Br = reads.shape[0]
    with named_range("lf_vote", dev):
        cands = vote_ops.vote_windows(seeds, lens, cfg, page)
    with named_range("lf_select", dev):
        rows = _pack_cands(cands, lens, seeds.n_total).contiguous()
        all_rows = rows.new_empty((D * Br, rows.shape[1]))
        dist.all_gather_into_tensor(all_rows, rows, group=group)
        cands_g, lens_g, n_total_g = _unpack_cands(
            all_rows, cands, lens.dtype, seeds.n_total.dtype)
        cw = chain_ops.compact_candidates(
            cands_g, cfg, D * Br * cfg.compact_windows_per_read)
        owner = cw.read_idx.long() // Br
        mine = (owner == d).nonzero().squeeze(1)
        cw_mine = chain_ops.CompactWindows(
            read_idx=cw.read_idx[mine] - d * Br,
            cand_idx=cw.cand_idx[mine], win_id=cw.win_id[mine],
            is_rev=cw.is_rev[mine], valid=cw.valid[mine],
            n_needed=cw.n_needed)
        ws = chain_ops.select_window_seeds(seeds, cw_mine, lens, arrs, cfg)
    with named_range("lf_chain", dev):
        chains = chain_ops.chain_seeds(ws, cfg, plain)
    counts = torch.bincount(owner, minlength=D).tolist()
    packed = _pack_chains(chains).contiguous()
    recv = packed.new_empty((sum(counts) if d == 0 else 0, packed.shape[1]))
    dist.all_to_all_single(
        recv, packed,
        output_split_sizes=counts if d == 0 else [0] * D,
        input_split_sizes=[counts[d] if j == 0 else 0 for j in range(D)],
        group=group)
    if d != 0:
        return seeds, chains, None
    order = torch.argsort(owner, stable=True)
    full = torch.empty_like(recv)
    full[order] = recv
    N = ws.q_pos.shape[-1]
    chains_g = _unpack_chains(full, N, seeds.t_pos.dtype)
    return seeds, chains_g, host_payload(n_total_g, cands_g, lens_g, cw,
                                         chains_g, cfg)


def _mesh_stage(meta, cfg, group, seed_group, plain: bool = False):
    """The device stage on every rank's rows: seeding (its lookups routed
    over seed_group when the index is striped), then
    post_seed_stage_sharded over group.  plain: the loops' plain
    versions on a CUDA device too (device_stage.device_pipeline's)."""

    def fn(arrs, reads, lens, pos, page=None):
        name = "lf_seed" if seed_group is None else "lf_seed_sharded"
        with named_range(name, reads.device):
            seeds = fm_ops._seed_anchors_impl(
                arrs, reads, lens, pos, meta,
                cfg.sampling_count, cfg.min_anchor_len, cfg.max_ref_hits,
                cfg.max_seeds_per_read, cfg.seed_phase1_steps,
                group=seed_group, plain=plain,
            )
        return post_seed_stage_sharded(arrs, seeds, reads, lens, cfg, group,
                                       page, plain)

    return fn


def sharded_pipeline(idx, cfg, mesh, plain: bool = False):
    """The device stage with the read axis split over the mesh and the
    whole index on every rank: fn(reads, lens, pos, page=None) on this
    rank's rows (see post_seed_stage_sharded for what it returns).
    plain: as _mesh_stage's."""
    arrs = idx.device_arrays(mesh_device(mesh))
    fn = _mesh_stage(idx.meta, cfg, mesh_group(mesh), None, plain)
    return functools.partial(fn, arrs)
