"""Dormant seeder variants, ported for capability completeness.

The reference ships three seeders; only ``getLocs_extend_whole_step``
(src/BWT.cpp:312-394) is linked into the per-read pipeline — the device
seeder in ops/fm_index.py reproduces that one.  The two DORMANT variants
(selected in the reference only by editing the call site) are ported
here as host implementations behind ``cfg.seeder``:

- ``extend-whole-2`` — getLocs_extend_whole_step2 (src/BWT.cpp:423-497):
  scan anchor END positions from qLen-1 downward by qLen/hash_count,
  extend each maximally to the LEFT (bwt_count_exact_backward,
  src/BWT.cpp:396-421: direct backward search of the read, no mirror),
  accept while 0 < occ < MAX_REF_HITS and the start moves left
  (containment by sPos < last_pos).  NOTE the reference quirks kept
  here: no per-anchor MIN_ANCHOR_LEN test beyond the one inside
  bwt_count_exact_backward, and last_pos only updates on acceptance.

- ``extend-whole-3`` — getLocs_extend_whole_step3 (src/BWT.cpp:499-591):
  precompute for every read position i the SA interval of the LONGEST
  match starting at i (O(L^2) rank queries — why the reference left it
  dormant; vectorized here as a lockstep sweep, one numpy step per
  column), then sample start positions like the active seeder and
  accept with m >= MIN_ANCHOR_LEN, occ < MAX_REF_HITS and
  end-containment.

Both run on the host (they are dormant in the reference too); the
engine pads their seed lists into a SeedBatch and continues through the
jitted post-seeding pipeline.
"""

from __future__ import annotations

import numpy as np

from ..index.fm_host import backward_ext_np, sa_lookup_np


def _ext_step(idx, k, l, c):
    nk, nl = backward_ext_np(
        idx.bwt_words, idx.occ_cp, idx.L2, idx.primary, idx.seq_len,
        np.asarray([k], np.int64), np.asarray([l], np.int64),
        np.asarray([c], np.int64),
    )
    return int(nk[0]), int(nl[0])


def _count_exact_backward(idx, codes, e_pos, min_anchor_len):
    """bwt_count_exact_backward (src/BWT.cpp:396-421): maximal leftward
    extension of the pattern ending at e_pos.  Returns (occ, k, l,
    s_pos); occ == 0 when the match is shorter than MIN_ANCHOR_LEN."""
    k, l = 0, idx.seq_len
    i = e_pos
    while i >= 0:
        c = int(codes[i])
        if c > 3:
            break
        nk, nl = _ext_step(idx, k, l, c)
        if nk > nl:
            break
        k, l = nk, nl
        i -= 1
    if e_pos - i < min_anchor_len:
        return 0, 0, 0, 0
    return l - k + 1, k, l, i + 1


def _locate(idx, k, l):
    rows = np.arange(k, l + 1, dtype=np.int64)
    return np.asarray(sa_lookup_np(idx, rows), np.int64)


def seeds_step2(idx, codes, cfg):
    """getLocs_extend_whole_step2 -> (fwd, rev) lists of
    (tPos, qPos, len)."""
    q_len = len(codes)
    l_pac = idx.l_pac
    step = float(q_len) / cfg.sampling_count
    e_frac = float(q_len - 1)
    e_pos = q_len - 1
    last_pos = q_len
    fwd, rev = [], []
    while e_pos >= cfg.min_anchor_len - 1:
        occ, k, l, s_pos = _count_exact_backward(
            idx, codes, e_pos, cfg.min_anchor_len
        )
        m = e_pos - s_pos + 1
        if 0 < occ < cfg.max_ref_hits and s_pos < last_pos:
            for sa in _locate(idx, k, l):
                if sa >= l_pac:
                    rev.append((2 * l_pac - int(sa) - m,
                                q_len - s_pos - m, m))
                else:
                    fwd.append((int(sa), s_pos, m))
            last_pos = s_pos
        e_frac -= step
        e_pos = int(e_frac)
    return fwd, rev


def _longest_match_intervals(idx, codes):
    """allIntv of getLocs_extend_whole_step3 (src/BWT.cpp:503-536):
    for each i, the SA interval + length of the longest match STARTING
    at i.  Lockstep sweep: lane p extends the pattern ending at p one
    column left per iteration; at column i the latest-surviving writer
    is the one with the largest p — exactly the reference's
    first-write-wins under its descending-pos scan."""
    L = len(codes)
    intv_k = np.full(L, -1, np.int64)
    intv_l = np.full(L, -1, np.int64)
    intv_m = np.zeros(L, np.int64)
    p = np.arange(L, dtype=np.int64)
    k = np.zeros(L, np.int64)
    l = np.full(L, idx.seq_len, np.int64)
    alive = np.ones(L, bool)
    for j in range(L):
        i = p - j
        act = alive & (i >= 0)
        if not act.any():
            break
        ii = np.where(act, i, 0)
        c = codes[ii].astype(np.int64)
        ok_c = act & (c <= 3)
        nk, nl = backward_ext_np(
            idx.bwt_words, idx.occ_cp, idx.L2, idx.primary, idx.seq_len,
            np.where(ok_c, k, 0), np.where(ok_c, l, 0),
            np.where(ok_c, c, 0),
        )
        good = ok_c & (nk <= nl)
        k = np.where(good, nk, k)
        l = np.where(good, nl, l)
        alive = good
        # write allIntv[i] for surviving lanes (distinct i per lane)
        wi = ii[good]
        intv_k[wi] = k[good]
        intv_l[wi] = l[good]
        intv_m[wi] = (p - i + 1)[good]
    return intv_k, intv_l, intv_m


def seeds_step3(idx, codes, cfg):
    """getLocs_extend_whole_step3 -> (fwd, rev) lists of
    (tPos, qPos, len)."""
    q_len = len(codes)
    l_pac = idx.l_pac
    ik, il, im = _longest_match_intervals(idx, codes)
    step = float(q_len) / cfg.sampling_count
    seed_pos = 0.0
    sp = 0
    last_pos = 0
    fwd, rev = [], []
    for _ in range(cfg.sampling_count):
        m = int(im[sp])
        if (m >= cfg.min_anchor_len and ik[sp] != -1 and il[sp] != -1
                and il[sp] - ik[sp] + 1 < cfg.max_ref_hits
                and sp + m > last_pos):
            for sa in _locate(idx, int(ik[sp]), int(il[sp])):
                if sa >= l_pac:
                    rev.append((2 * l_pac - int(sa) - m,
                                q_len - sp - m, m))
                else:
                    fwd.append((int(sa), sp, m))
            last_pos = sp + m
        seed_pos += step
        sp = min(int(seed_pos), q_len - 1)
    return fwd, rev


def host_seed_batch(idx, batch_codes, read_lens, cfg, max_seeds):
    """Run the configured dormant seeder over a read batch and pad the
    results into the SeedBatch layout the post-seeding pipeline expects
    (both strands share the slot axis, like the device seeder)."""
    from .fm_index import SeedBatch

    fn = seeds_step2 if cfg.seeder == "extend-whole-2" else seeds_step3
    B = len(batch_codes)
    t = np.zeros((B, max_seeds), np.int64)
    q = np.zeros((B, max_seeds), np.int32)
    ln = np.zeros((B, max_seeds), np.int32)
    rv = np.zeros((B, max_seeds), bool)
    va = np.zeros((B, max_seeds), bool)
    n_tot = np.zeros(B, np.int32)
    n_anch = np.zeros(B, np.int32)
    for b in range(B):
        if read_lens[b] == 0:
            continue
        codes = batch_codes[b][: read_lens[b]]
        fwd, rev = fn(idx, codes, cfg)
        seeds = fwd + rev
        n_tot[b] = len(seeds)
        n_anch[b] = len(seeds)
        for s, (tp, qp, m) in enumerate(seeds[:max_seeds]):
            t[b, s], q[b, s], ln[b, s] = tp, qp, m
            rv[b, s] = s >= len(fwd)
            va[b, s] = True
    return SeedBatch(
        t_pos=t, q_pos=q, length=ln, is_rev=rv, valid=va,
        n_total=n_tot, n_anchors=n_anch,
    )
