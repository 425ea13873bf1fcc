"""Batched FM-index seeding in PyTorch.

Port of ``lordfast_tpu/ops/fm_index.py``: the equivalents of
``bwt_occ``/``bwt_2occ`` (lib/bwa/bwt.c:107-163), ``bwt_sa``
(lib/bwa/bwt.c:86-96) and the active seeder ``getLocs_extend_whole_step``
(src/BWT.cpp:312-394), as batched tensor code that runs on whatever
device the index tensors live on.

The anchor search is the JAX package's mirror-space design: the indexed
text is fwd+revcomp, so revcomp(anchor) is searched and growing the
anchor on the right is one backward-extension step on the left of the
searched pattern, in lockstep across all (read, sample position) lanes.
Located hits are mapped back through the mirror, so the seed set is the
reference's exactly.

Tensor conventions: the index's uint32 words arrive as int64 tensors
holding the same values (``FMIndex.device_arrays``), so every shift here
is logical; ``~w`` is written ``w ^ 0xFFFFFFFF``.  Positions and rows are
int64 inside and cast to the index's position dtype on output.

Where the JAX version bounds its lockstep loops with fixed-width
compaction (``top_k`` into capped buffers inside ``lax.cond``), this port
compacts to the exact surviving lane set with ``nonzero`` — eager
PyTorch has dynamic shapes.  Which lanes ride which stage does not
change any lane's result, so the outputs are the JAX version's.  Each
compaction is a host sync on a GPU; the loops are plain PyTorch, not
kernels (hand kernels for them are later work).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Maximum anchor length; the reference stores seed length in a 12-bit
# field (Seed_t.len, src/LordFAST.h:30-35), so 4095 is its hard cap too.
MAX_ANCHOR_LEN = 4095

M32 = 0xFFFFFFFF


def torch_pos_dtype(meta) -> torch.dtype:
    """torch dtype of the index's position arrays (FMIndex.pos_dtype)."""
    return torch.int32 if meta["seq_len"] < 2**31 - 1 else torch.int64


def _popcount32(x):
    """Population count of int64 tensors holding uint32 values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def occ(arrs, meta, k, c):
    """Occ(c, k): count of char c in the $-removed BWT prefix at row k.

    Semantics of bwt_occ (lib/bwa/bwt.c:107-129) including the primary-row
    adjustment; k in [-1, seq_len], c in [0, 3] (int64 tensors, shapes
    broadcast).  Reads the fused ``fm_blocks`` rank rows when the index
    has them, else the ``occ_cp``/``bwt_blocks`` pair (l_pac >= 2^32)."""
    seq_len = meta["seq_len"]
    primary = meta["primary"]
    k, c = torch.broadcast_tensors(k, c)

    is_total = k == seq_len
    is_none = k < 0
    kk = k.clamp(0, seq_len - 1)
    kp = kk - (kk >= primary).long()

    blk = kp >> 7
    off = kp & 127
    cidx = c[..., None]
    if "fm_blocks" in arrs:
        row = arrs["fm_blocks"][blk]  # (..., 12): cp(A..T) | 8 words
        base = row[..., :4].gather(-1, cidx)[..., 0]
        w = row[..., 4:]
    else:
        base = arrs["occ_cp"][blk].gather(-1, cidx)[..., 0]
        w = arrs["bwt_blocks"][blk]  # (..., 8)
    hi = torch.where((cidx & 2) != 0, w, w ^ M32)
    lo = torch.where((cidx & 1) != 0, w, w ^ M32)
    matched = (hi >> 1) & lo & 0x55555555

    f = (off >> 4)[..., None]  # word holding the row
    r = (off & 15)[..., None]  # base offset within it
    lane = torch.arange(8, device=k.device)
    partial = ((1 << ((15 - r) << 1)) - 1) ^ M32
    cover = torch.where(lane < f, M32,
                        torch.where(lane == f, partial, 0))
    cnt = _popcount32(matched & cover).sum(-1)

    L2 = arrs["L2"].long()
    total = L2[c + 1] - L2[c]
    res = base + cnt
    res = torch.where(is_total, total, res)
    return torch.where(is_none, 0, res)


def backward_ext(arrs, meta, k, l, c):
    """One backward-search step: [k, l] -> interval of c+pattern
    (bwt_count_exact inner step, src/BWT.cpp:255-258).  The two rank
    queries go through one stacked occ call (bwa's bwt_2occ fusion)."""
    both = occ(arrs, meta, torch.stack([k - 1, l]), c[None])
    L2c = arrs["L2"].long()[c]
    return L2c + both[0] + 1, L2c + both[1]


def bwt_b0(arrs, k):
    """BWT char at $-removed position k (bwt_B0, lib/bwa/bwt.h:78)."""
    w = arrs["bwt_words"][k >> 4]
    return (w >> (((k ^ -1) & 15) << 1)) & 3


def _walk_step(arrs, meta, rows):
    """One inverse-Psi step (bwt_invPsi, lib/bwa/bwt.c:53-59)."""
    primary = meta["primary"]
    x = rows - (rows > primary).long()
    ch = bwt_b0(arrs, x)
    nxt = arrs["L2"].long()[ch] + occ(arrs, meta, rows, ch)
    return torch.where(rows == primary, 0, nxt)


def sa_lookup(arrs, meta, rows, valid):
    """SA values for a batch of rows: inverse-Psi walk until a sampled
    row (bwt_sa, lib/bwa/bwt.c:86-96).  Rows outside ``valid`` return 0.

    With the full SA on device (sa_intv == 1) locate is one gather.  Else
    the walk runs in two phases like the JAX version's: intv/2 lockstep
    steps over every lane (the remaining walk length is uniform in
    [0, intv), so about half the lanes finish), then the survivors are
    compacted and walked to the end."""
    rows = rows.long()
    intv = meta["sa_intv"]
    sa = arrs["sa_samp"]
    if intv == 1:
        r = torch.where(valid, rows, 0).clamp(0, sa.shape[0] - 1)
        return torch.where(valid, sa[r].long(), 0)
    mask = intv - 1
    log2_intv = int(intv).bit_length() - 1
    rows = torch.where(valid, rows, 0)
    steps = torch.zeros_like(rows)
    active = valid & ((rows & mask) != 0)
    for _ in range(intv // 2):
        rows = torch.where(active, _walk_step(arrs, meta, rows), rows)
        steps = steps + active.long()
        active = active & ((rows & mask) != 0)
    idx = active.nonzero().squeeze(1)
    r, s = rows[idx], steps[idx]
    while idx.numel():
        r = _walk_step(arrs, meta, r)
        s = s + 1
        done = (r & mask) == 0
        rows[idx[done]] = r[done]
        steps[idx[done]] = s[done]
        keep = (~done).nonzero().squeeze(1)
        idx, r, s = idx[keep], r[keep], s[keep]
    out = steps + sa[rows >> log2_intv].long()
    return torch.where(valid, out, 0)


class SeedBatch(NamedTuple):
    """Padded per-read seed tensors; the device analogue of the
    forward/reverse SeedList pair (src/LordFAST.h:37-41)."""

    t_pos: torch.Tensor   # (B, MS) target position (forward-genome coords)
    q_pos: torch.Tensor   # (B, MS) query position (strand-local, like ref)
    length: torch.Tensor  # (B, MS) anchor length
    is_rev: torch.Tensor  # (B, MS) bool strand
    valid: torch.Tensor   # (B, MS) bool
    n_total: torch.Tensor     # (B,) hits found (before the MS cap)
    n_anchors: torch.Tensor   # (B,) accepted anchors


def sample_positions_host(read_lens, sampling_count):
    """Anchor sampling positions, bit-exact with the reference's float
    accumulation (src/BWT.cpp:320-328: seed_pos += step in double, then
    truncate).  numpy's sequential float64 cumsum reproduces the C loop's
    IEEE addition order."""
    read_lens = np.asarray(read_lens, dtype=np.int64)
    step = read_lens.astype(np.float64) / sampling_count  # (B,)
    acc = np.zeros((len(read_lens), sampling_count), dtype=np.float64)
    acc[:, 1:] = np.cumsum(
        np.repeat(step[:, None], sampling_count - 1, axis=1), axis=1
    )
    return acc.astype(np.int32)  # truncation toward zero, like (uint32) cast


class _Reads:
    """A read batch in the seeder's layouts: 3-bit packed words (16 chars
    per int64, first char in the highest bits) and per-lane lengths."""

    def __init__(self, reads, read_lens):
        B, L = reads.shape
        self.L = L
        Lp = ((L + 15) // 16) * 16
        r = reads.long()
        if Lp != L:
            r = torch.nn.functional.pad(r, (0, Lp - L), value=4)
        self.W16 = Lp // 16
        j16 = torch.arange(16, device=reads.device)
        self.rw = (r.view(B, self.W16, 16) << (3 * (15 - j16))).sum(-1)
        self.lens = read_lens.long()

    def char(self, b, q):
        """Read code at (row b, position q); q is clipped into the row."""
        qc = q.clamp(0, self.L - 1)
        return (self.rw[b, qc >> 4] >> (3 * (15 - (qc & 15)))) & 7


def _ext_steps(arrs, meta, rd, alive, k, l, m, posf, bf, n_steps):
    """n_steps lockstep greedy-extension steps: each lane consumes the
    complement of its next read char as one backward-extension step and
    dies at the first step that fails."""
    lens = rd.lens[bf]
    for _ in range(n_steps):
        q = posf + m  # next read position to consume
        c = rd.char(bf, q)
        ok_char = (q < lens) & (c < 4)
        cc = torch.where(ok_char, 3 - c, 0)  # complemented
        nk, nl = backward_ext(arrs, meta, k, l, cc)
        alive = alive & ok_char & (nk <= nl) & (m < MAX_ANCHOR_LEN)
        k = torch.where(alive, nk, k)
        l = torch.where(alive, nl, l)
        m = m + alive.long()
    return alive, k, l, m


def _resolve_rounds(arrs, meta, rd, k, m, posf, bf):
    """occ==1 fast path for lanes whose interval is one row: the rest of
    the greedy extension is "does the text left of the unique occurrence
    keep matching the complemented read", answered by 128-char direct
    comparisons against the packed text instead of one rank query per
    base.  Returns (m_final, p_final): the final anchor length and the
    occurrence position in mirror space."""
    dev = k.device
    p = sa_lookup(arrs, meta, k, torch.ones_like(k, dtype=torch.bool))
    CH = 128
    NW = CH // 16 + 1  # 9 words cover any 128-char window
    jj = torch.arange(CH, device=dev)
    wj = torch.arange(NW, device=dev)
    t_sh = 2 * (15 - torch.arange(16, device=dev))
    r_sh = 3 * (15 - torch.arange(16, device=dev))
    max_row = (meta["seq_len"] - 1) >> 4
    lens = rd.lens[bf]
    act = torch.ones_like(k, dtype=torch.bool)
    V = k.shape[0]
    while bool(act.any()):
        # text window [p-CH, p), unpacked last-position-first; the
        # arithmetic shift keeps the in-word offset in [128, 143]
        base_w = (p - CH) >> 4
        rows = (base_w[:, None] + wj).clamp(0, max_row)
        tw = (arrs["pac_words"][rows][:, :, None] >> t_sh) & 3
        twr = tw.reshape(V, NW * 16).flip(1)  # twr[i] = text[base*16+143-i]
        s_t = 144 - (p - (base_w << 4))  # in [1, 16]
        tc = twr.gather(1, s_t[:, None] + jj)
        # read window [q0, q0+CH) from the packed read words
        q0 = posf + m
        base_r = (q0 >> 4).clamp(0, rd.W16 - 1)
        rrows = (base_r[:, None] + wj).clamp(0, rd.W16 - 1)
        rwin = ((rd.rw[bf[:, None], rrows][:, :, None] >> r_sh) & 7)
        rc = rwin.reshape(V, NW * 16).gather(1, (q0 & 15)[:, None] + jj)
        in_rd = ((q0[:, None] + jj) < lens[:, None]) & (rc < 4)
        eq = (act[:, None] & in_rd
              & (jj < p.clamp(max=CH)[:, None])
              & (tc == 3 - rc)
              & ((m[:, None] + jj) < MAX_ANCHOR_LEN))
        all_eq = eq.all(1)
        first_ne = (~eq).to(torch.uint8).argmax(1)
        run = torch.where(all_eq, CH, first_ne)
        m = m + run
        p = p - run
        act = act & all_eq
    return m, p


def _staged_ext(arrs, meta, rd, alive, k, l, m, posf, bf, phase1_steps):
    """Run phase1_steps extension steps over the live lanes, resolve the
    occ==1 lanes by direct text comparison, compact to the lanes still
    alive, and repeat until none is.  Returns per-lane final (k, l, m)
    plus (rpos, rflag): the mirror-space position of the lanes the
    comparison resolved (their k/l predate the comparison tail)."""
    k, l, m = k.clone(), l.clone(), m.clone()
    rpos = torch.zeros_like(k)
    rflag = torch.zeros_like(alive)
    idx = alive.nonzero().squeeze(1)
    a = alive[idx]
    kk, ll, mm, pf, bf_ = k[idx], l[idx], m[idx], posf[idx], bf[idx]
    while idx.numel():
        a, kk, ll, mm = _ext_steps(arrs, meta, rd, a, kk, ll, mm, pf, bf_,
                                   phase1_steps)
        one = a & (kk == ll)
        oi = one.nonzero().squeeze(1)
        if oi.numel():
            m_f, p_f = _resolve_rounds(arrs, meta, rd, kk[oi], mm[oi],
                                       pf[oi], bf_[oi])
            mm[oi] = m_f
            rpos[idx[oi]] = p_f
            rflag[idx[oi]] = True
        k[idx], l[idx], m[idx] = kk, ll, mm
        keep = (a & ~one).nonzero().squeeze(1)
        idx, a = idx[keep], a[keep]
        kk, ll, mm, pf, bf_ = kk[keep], ll[keep], mm[keep], pf[keep], \
            bf_[keep]
    return k, l, m, rpos, rflag


def _seed_anchors_impl(arrs, reads, read_lens, pos, meta, sampling_count,
                       min_anchor_len, max_ref_hits, max_seeds,
                       phase1_steps=24):
    """Seeding for a padded read batch (JAX ``_seed_anchors_impl``).

    reads: (B, L) uint8 codes (4 = N/pad); read_lens: (B,) int32;
    pos: (B, S) int32 sample positions (sample_positions_host), all on
    the index's device.  Returns a SeedBatch with up to max_seeds slots
    per read across both strands."""
    dev = reads.device
    pdt = torch_pos_dtype(meta)
    B, L = reads.shape
    S = sampling_count
    kc = meta["kcache_k"]
    assert kc <= 17, "k-mer cache k must fit a 2-word read window"
    l_pac = meta["l_pac"]
    BS = B * S
    b_lane = torch.arange(BS, device=dev) // S  # flat lane -> read row
    rd = _Reads(reads, read_lens)
    pos = pos.long()
    read_lens = read_lens.long()

    # ---- k-mer cache lookup on revcomp(anchor[0:kc]) ----
    # cache index = sum_j comp(read[p+j]) * 4^(kc-1-j)  (encoding of
    # bwt_count_exact_cached, src/BWT.cpp:270-277); the kc chars come
    # out of the lane's 2-word packed window
    pos_f = pos.reshape(BS)
    w0 = pos_f.clamp(0, L - 1) >> 4
    lo0 = rd.rw[b_lane, w0]
    hi0 = rd.rw[b_lane, (w0 + 1).clamp(max=rd.W16 - 1)]
    jj = torch.arange(kc, device=dev)
    qj = pos_f[:, None] + jj  # (BS, kc)
    word = torch.where((qj >> 4) == w0[:, None], lo0[:, None], hi0[:, None])
    ch = (word >> (3 * (15 - (qj & 15)))) & 7
    ch = torch.where(qj < read_lens[b_lane][:, None], ch, 4)
    has_n = (ch >= 4).any(-1)
    comp = torch.where(ch < 4, 3 - ch, 0)
    ci = (comp * (4 ** (kc - 1 - jj))).sum(-1)  # (BS,)
    k0 = arrs["kcache_beg"][ci].long()
    l0 = arrs["kcache_end"][ci].long()
    alive0 = (~has_n) & (k0 <= l0) & (pos_f + kc <= read_lens[b_lane])

    # ---- staged lockstep greedy extension ----
    m0 = torch.full((BS,), kc, dtype=torch.int64, device=dev)
    kf, lf, mf, rposf, rflagf = _staged_ext(
        arrs, meta, rd, alive0, k0, l0, m0, pos_f, b_lane, phase1_steps
    )
    kf, lf, mf = kf.view(B, S), lf.view(B, S), mf.view(B, S)
    rposf, rflagf = rposf.view(B, S), rflagf.view(B, S)

    occ_cnt = torch.where(alive0.view(B, S) & (kf <= lf), lf - kf + 1, 0)

    # ---- acceptance: occ in (0, max_ref_hits), length >= min, not
    # contained (sequential last_pos scan, src/BWT.cpp:345,386): an
    # anchor is accepted iff its end exceeds the running max end of the
    # passing anchors before it (an exclusive cummax) ----
    base_ok = ((occ_cnt > 0) & (occ_cnt < max_ref_hits)
               & (mf >= min_anchor_len))
    ends = torch.where(base_ok, pos + mf, 0)
    prev_max = torch.cat(
        [torch.zeros((B, 1), dtype=ends.dtype, device=dev),
         torch.cummax(ends, dim=1).values[:, :-1]], dim=1,
    )
    accept = base_ok & ((pos + mf) > prev_max)

    # ---- locate: flatten accepted intervals into <= max_seeds slots ----
    occ_acc = torch.where(accept, occ_cnt, 0)
    starts = torch.cumsum(occ_acc, dim=1) - occ_acc  # exclusive prefix
    total = occ_acc.sum(dim=1)  # (B,)
    MS = max_seeds
    slot = torch.arange(MS, device=dev)
    # owner anchor of slot t = the last accepted anchor s with
    # starts[s] <= t: scatter s at starts[s] (index MS = dropped), then a
    # running max
    has_occ = accept & (occ_acc > 0)
    tgt = torch.where(has_occ & (starts < MS), starts, MS)
    scat = torch.full((B, MS + 1), -1, dtype=torch.int64, device=dev)
    scat.scatter_reduce_(
        1, tgt, torch.arange(S, device=dev).expand(B, S), reduce="amax",
        include_self=True,
    )
    sidx = torch.cummax(scat[:, :MS], dim=1).values.clamp(0, S - 1)
    slot_valid = slot[None, :] < total[:, None]
    row = kf.gather(1, sidx) + (slot - starts.gather(1, sidx))
    row = torch.where(slot_valid, row, 0)

    # lanes resolved by the occ==1 path carry their located position;
    # only the rest walk the SA, compacted to the slots that need it
    res_f = rflagf.gather(1, sidx)
    walk = (slot_valid & ~res_f).reshape(-1)
    sel = walk.nonzero().squeeze(1)
    p_occ = torch.zeros(B * MS, dtype=torch.int64, device=dev)
    p_occ[sel] = sa_lookup(arrs, meta, row.reshape(-1)[sel], walk[sel])
    p_occ = torch.where(res_f, rposf.gather(1, sidx), p_occ.view(B, MS))

    # ---- mirror back to the reference's seed coordinates ----
    m_s = mf.gather(1, sidx)
    p_s = pos.gather(1, sidx)
    p_P = 2 * l_pac - p_occ - m_s  # occurrence of the anchor
    is_fwd = p_P < l_pac
    t_pos = torch.where(is_fwd, p_P, p_occ)
    q_pos = torch.where(is_fwd, p_s, read_lens[:, None] - p_s - m_s)

    return SeedBatch(
        t_pos=torch.where(slot_valid, t_pos, 0).to(pdt),
        q_pos=torch.where(slot_valid, q_pos, 0).to(torch.int32),
        length=torch.where(slot_valid, m_s, 0).to(torch.int32),
        is_rev=slot_valid & ~is_fwd,
        valid=slot_valid,
        n_total=total.to(torch.int32),
        n_anchors=accept.sum(dim=1).to(torch.int32),
    )


def seed_anchors(arrs, meta, reads, read_lens, cfg):
    """Run the seeding stage for a padded read batch.

    reads: (B, L) uint8 codes 0..4 (4 = N / pad); read_lens: (B,) int32,
    numpy or tensors; moved to the index's device.  Returns a SeedBatch
    with up to cfg.max_seeds_per_read seeds per read across both
    strands."""
    dev = arrs["L2"].device
    pos = sample_positions_host(np.asarray(read_lens), cfg.sampling_count)
    return _seed_anchors_impl(
        arrs,
        torch.as_tensor(np.asarray(reads), device=dev),
        torch.as_tensor(np.asarray(read_lens, dtype=np.int32), device=dev),
        torch.from_numpy(pos).to(dev),
        meta,
        cfg.sampling_count,
        cfg.min_anchor_len,
        cfg.max_ref_hits,
        cfg.max_seeds_per_read,
        cfg.seed_phase1_steps,
    )
