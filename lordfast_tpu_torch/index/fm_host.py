"""Vectorized host (numpy) FM-index primitives.

These mirror the device kernels in ops/fm_index.py and implement the exact
rank semantics of ``bwt_occ``/``bwt_2occ`` (lib/bwa/bwt.c:107-163): row
indices are over the conceptual n+1-row matrix including the sentinel row
at ``primary``; Occ(c, k) counts char c in the $-removed BWT prefix ending
at adjusted row k.

Used by the index builder (k-mer cache construction = millions of rank
queries, vectorized here) and as the oracle-free reference implementation
in tests.
"""

from __future__ import annotations

import numpy as np

_HAS_BITCOUNT = hasattr(np, "bitwise_count")
if not _HAS_BITCOUNT:
    _POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def _popcount32(x: np.ndarray) -> np.ndarray:
    if _HAS_BITCOUNT:
        return np.bitwise_count(x).astype(np.int64)
    b = x.view(np.uint8) if x.flags["C_CONTIGUOUS"] else np.ascontiguousarray(x).view(np.uint8)
    return _POP8[b].reshape(*x.shape, 4).sum(-1).astype(np.int64)


def occ_np(
    bwt_words: np.ndarray,
    occ_cp: np.ndarray,
    L2: np.ndarray,
    primary: int,
    seq_len: int,
    k: np.ndarray,
    c: np.ndarray,
) -> np.ndarray:
    """Occ(c, k) for arrays of row indices k (int64, may be -1..seq_len)
    and chars c (0..3).  Semantics of bwt_occ (lib/bwa/bwt.c:107-129)."""
    k = np.asarray(k, dtype=np.int64)
    c = np.asarray(c, dtype=np.int64)
    k, c = np.broadcast_arrays(k, c)
    out = np.zeros(k.shape, dtype=np.int64)

    is_total = k == seq_len
    is_none = k == -1
    mid = ~(is_total | is_none)

    if np.any(is_total):
        out[is_total] = (L2[c + 1] - L2[c])[is_total]

    if np.any(mid):
        km = k[mid] - (k[mid] >= primary)
        cm = c[mid]
        blk = km >> 7
        off = km & 127
        base = occ_cp[blk, cm].astype(np.int64)

        word_idx = (blk << 3)[:, None] + np.arange(8, dtype=np.int64)[None, :]
        w = bwt_words[word_idx]  # (M, 8) uint32

        cm32 = cm.astype(np.uint32)[:, None]
        hi = np.where((cm32 & 2) != 0, w, ~w)
        lo = np.where((cm32 & 1) != 0, w, ~w)
        matched = (hi >> np.uint32(1)) & lo & np.uint32(0x55555555)

        f = (off >> 4)[:, None]  # word containing position off
        r = (off & 15).astype(np.uint32)  # base offset within that word
        widx = np.arange(8, dtype=np.int64)[None, :]
        partial_shift = ((np.uint32(15) - r) << np.uint32(1))[:, None]
        partial_mask = (~((np.uint32(1) << partial_shift) - np.uint32(1))).astype(
            np.uint32
        )
        cover = np.where(
            widx < f,
            np.uint32(0xFFFFFFFF),
            np.where(widx == f, partial_mask, np.uint32(0)),
        )
        out[mid] = base + _popcount32(matched & cover).sum(axis=1)

    return out


def occ2_np(bwt_words, occ_cp, L2, primary, seq_len, k, l, c):
    """(Occ(c,k), Occ(c,l)) — bwt_2occ semantics (lib/bwa/bwt.c:132-163)."""
    ok = occ_np(bwt_words, occ_cp, L2, primary, seq_len, k, c)
    ol = occ_np(bwt_words, occ_cp, L2, primary, seq_len, l, c)
    return ok, ol


def backward_ext_np(bwt_words, occ_cp, L2, primary, seq_len, k, l, c):
    """One backward-search step: interval [k,l] extended on the left by
    char c (bwt_count_exact inner step, src/BWT.cpp:255-258).  Empty
    intervals stay/become k>l."""
    ok, ol = occ2_np(bwt_words, occ_cp, L2, primary, seq_len, k - 1, l, c)
    nk = L2[c] + ok + 1
    nl = L2[c] + ol
    return nk, nl


def bwt_b0_np(bwt_words: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Char at $-removed BWT position k (bwt_B0, lib/bwa/bwt.h:78)."""
    k = np.asarray(k, dtype=np.int64)
    return ((bwt_words[k >> 4] >> ((((~k) & 15) << 1).astype(np.uint32))) & 3).astype(
        np.int64
    )


def sa_lookup_np(idx, rows: np.ndarray) -> np.ndarray:
    """SA values for row indices (bwt_sa walk, lib/bwa/bwt.c:86-96)."""
    rows = np.asarray(rows, dtype=np.int64).copy()
    steps = np.zeros_like(rows)
    mask = int(idx.sa_intv - 1)
    active = (rows & mask) != 0
    bw, cp, L2, prim, n = idx.bwt_words, idx.occ_cp, idx.L2, idx.primary, idx.seq_len
    while np.any(active):
        k = rows[active]
        # bwt_invPsi (lib/bwa/bwt.c:53-59)
        x = k - (k > prim)
        ch = bwt_b0_np(bw, x)
        nxt = L2[ch] + occ_np(bw, cp, L2, prim, n, k, ch)
        nxt = np.where(k == prim, 0, nxt)
        rows[active] = nxt
        steps[active] += 1
        active = (rows & mask) != 0
    return steps + idx.sa_samp[rows >> int(np.log2(idx.sa_intv))].astype(np.int64)
