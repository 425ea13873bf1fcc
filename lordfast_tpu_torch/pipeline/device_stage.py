"""The device stage of one read batch: seeding -> window voting ->
window seed selection -> chaining, on the index's device.

Counterpart of ``lordfast_tpu/parallel/mesh.py:35-131`` for one device
and no mesh: ``device_pipeline`` returns a plain function (PyTorch runs
eagerly; there is nothing to jit), ``post_seed_stage`` runs everything
after seeding and trims the host payload, and the returned ``host_out``
dict has the JAX version's keys.
"""

from __future__ import annotations

import torch

from ..ops import chain as chain_ops
from ..ops import fm_index as fm_ops
from ..ops import voting as vote_ops


def device_pipeline(meta, cfg):
    """The full device stage as a function of (arrs, reads, lens, pos,
    page=None), with meta/cfg closed over.  reads (B, L) uint8, lens (B,)
    int32 and pos (B, S) int32 are tensors on the index's device."""

    def fn(arrs, reads, lens, pos, page=None):
        seeds = fm_ops._seed_anchors_impl(
            arrs, reads, lens, pos, meta,
            cfg.sampling_count, cfg.min_anchor_len, cfg.max_ref_hits,
            cfg.max_seeds_per_read, cfg.seed_phase1_steps,
        )
        return post_seed_stage(arrs, seeds, reads, lens, cfg, page)

    return fn


def post_seed_stage(arrs, seeds, reads, lens, cfg, page=None):
    """Everything after seeding (voting, selection, chaining, host-payload
    trimming).  page: optional candidate-rank page (vote_windows), the
    engine's window paging for reads whose qualifying windows exceed one
    pipeline budget."""
    cands = vote_ops.vote_windows(seeds, lens, cfg, page)
    k_windows = reads.shape[0] * cfg.compact_windows_per_read
    cw = chain_ops.compact_candidates(cands, cfg, k_windows)
    ws = chain_ops.select_window_seeds(seeds, cw, lens, arrs, cfg)
    chains = chain_ops.chain_seeds(ws, cfg)

    # host-bound results: the chains tensor cut to the first
    # chain_transfer_cap slots with (qPos, len) packed into one int32
    # (qPos < 2^18 given SEQ_MAX_LENGTH=250k, len < 2^12 given the 12-bit
    # Seed_t.len field); longer chains are fetched from the full tensor
    ncap = min(cfg.chain_transfer_cap, chains.q_pos.shape[-1])
    packed = (chains.q_pos[:, :ncap] << 12) | chains.length[:, :ncap]
    need = chain_ops.need_mask(cands)  # JAX: mesh._need_mask
    host_out = {
        # per-batch stage counters, reduced on device
        "stat_seeds": seeds.n_total.long().sum().to(torch.int32),
        "stat_candidates": cands.valid.sum().to(torch.int32),
        # mask padding rows (lens == 0): their empty vote tables can
        # classify as "fine" and inflate the counter
        "stat_fine_reads": (cands.is_fine & (lens > 0)).sum().to(
            torch.int32),
        "stat_chained_windows": (chains.chain_len > 1).sum().to(
            torch.int32),
        "cand_valid0": cands.valid[:, 0],
        "is_fine": cands.is_fine,
        # per-read window demand, for overflow detection on the host:
        # how many candidates qualify for chaining, and whether the
        # per-read candidate cap C itself may be truncating (the last,
        # lowest-vote candidate still qualifies)
        "cand_need": need.sum(dim=1).to(torch.int32),
        "cand_sat": need[:, -1],
        "cw_read_idx": cw.read_idx,
        "cw_cand_idx": cw.cand_idx,
        "cw_win_id": cw.win_id,
        "cw_is_rev": cw.is_rev,
        "cw_valid": cw.valid,
        "chain_len": chains.chain_len,
        "chain_score": chains.score,
        "chain_t": chains.t_pos[:, :ncap],
        "chain_ql": packed,
    }
    return seeds, chains, host_out
