"""Sharded-index mode: the FM-index striped over the ranks of a mesh.

Port of ``lordfast_tpu/parallel/sharded_index.py``.  The replicated mode
(parallel/mesh.py) keeps a full copy of the index on every device.  At
GRCh38 scale the rank structures stop fitting one device (a full SA
alone is 8 B x 6.2e9 rows = 50 GB), so this module stripes the large
row arrays over the ranks of the mesh's ``"data"`` dimension and routes
every rank / SA lookup to the rank that owns the row (semantics of
lib/bwa/bwt.c:107-166 unchanged):

- ``fm_blocks`` (or ``occ_cp`` + ``bwt_blocks``): 128-base rank blocks,
- ``bwt_words``: the 2-bit BWT stream (inverse-Psi walk when sa_intv>1),
- ``sa_samp``: the (possibly full) sampled suffix array.

One process per device: each rank holds its stripe, seeds its rows of
the read batch, and exchanges row ids and answers with torch.distributed
collectives on the mesh's group: the JAX version's routing, fixed (D,
cap) buckets with equal splits and its all-gather route for a step that
overflows them (ops/fm_index.py ``exchange``).  The seeder's lockstep
extension and locate walk run in blocks of steps with one host read a
block; on a card each step is launches of ``csrc/seed_shard.cu``'s
kernels between the collectives (ops/fm_shard_cuda.py), on the CPU and
under ``plain_loops`` the plain loops (fm_index ``_shard_ext``,
``_shard_walk``).  The stripes keep the layout of
``FMIndex.device_arrays`` (uint32 words as int64 tensors), so the routed
values are int64.

Small arrays stay whole on every rank: L2, contig tables, the 4^k k-mer
cache and ``pac_words`` (the gap-DP reference fetches are strided slices,
which routing would serialise).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import _mesh_stage, mesh_device, mesh_group

# arrays striped by rows over the mesh; everything else is replicated
_SHARDED_KEYS = ("fm_blocks", "occ_cp", "bwt_blocks", "bwt_words",
                 "sa_samp")


def shard_index_arrays(idx, mesh) -> dict:
    """This rank's index tensors for sharded-index mode, on its device.

    Each key of _SHARDED_KEYS is padded with zero rows to a multiple of
    the mesh size D and cut to this rank's stripe of rps = padded / D
    rows: global row r lives on rank r // rps at local row r % rps.  The
    padding rows are never asked for.  Every other array is whole.  The
    dtypes are FMIndex.device_arrays'.  occ_cp is cut to bwt_blocks'
    rows first: its last row (the totals) is never asked for by a rank
    query (a block is at most (seq_len - 1) >> 7), and with the same rows
    both arrays give a block the same owner, so one routed query answers
    both (fm_shard_cuda.shard_answer)."""
    group = mesh_group(mesh)
    D, d = group.size(), group.rank()
    device = mesh_device(mesh)
    host = idx.host_arrays()
    arrs = {}
    for k, v in host.items():
        v = np.asarray(v)
        if k == "occ_cp":
            v = v[: len(host["bwt_blocks"])]
        if k in _SHARDED_KEYS:
            rps = -(-v.shape[0] // D)
            part = v[d * rps : (d + 1) * rps]
            v = np.zeros((rps,) + v.shape[1:], v.dtype)
            v[: part.shape[0]] = part
        v = v.astype(np.int64) if v.dtype == np.uint32 else np.array(v)
        arrs[k] = torch.from_numpy(v).to(device)
    return arrs


def sharded_index_pipeline(idx, cfg, mesh, arrs=None, plain: bool = False):
    """The device stage with the index striped over the mesh.

    Returns (fn, arrs): fn(arrs, reads, lens, pos, page=None) runs on
    every rank at once, each with its own rows of the batch (the same
    count on every rank).  Seeding routes its rank and locate lookups
    over the mesh; voting, selection and chaining run as in
    mesh.post_seed_stage_sharded.  On rank 0 it returns (seeds, chains,
    host_out) for the whole batch, bit for bit the replicated
    pipeline's; elsewhere (seeds, chains, None) for the rank's own rows
    and windows.  The eager function takes the page with every call, so
    JAX's ``paged`` jit signature has no counterpart.

    arrs: this rank's stripes from an earlier call, reused instead of a
    second copy (the engine's overflow-retry pipelines).  plain: the
    loops' plain versions on a CUDA device too (mesh._mesh_stage's)."""
    if arrs is None:
        arrs = shard_index_arrays(idx, mesh)
    group = mesh_group(mesh)
    return _mesh_stage(idx.meta, cfg, group, group, plain), arrs
