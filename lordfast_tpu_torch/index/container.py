"""FM-index container: host numpy arrays + device placement.

The layout is a device-friendly re-design of bwa's index
(``lib/bwa/bwt.h:46-58``): instead of interleaving Occ checkpoints into
the BWT stream, we keep

- ``bwt_words``  : uint32[ceil(n/16)], 16 2-bit bases per word, base k at
                   bit shift ``(~k&15)<<1`` (same in-word convention as
                   ``bwt_B0``, lib/bwa/bwt.h:78),
- ``occ_cp``     : uint32[n_blocks+1, 4], cumulative char counts before
                   each 128-base block (bwa interleaves these every
                   OCC_INTERVAL=128, lib/bwa/bwt.h:34-37),
- ``sa_samp``    : sampled suffix array, every ``sa_interval``-th row
                   (bwa: interval 32, lib/bwa/bwtindex.c:286),
- ``kcache_beg/end`` : SA intervals of all 4^k k-mers (the lordFAST
                   ``<ref>.cache`` table, src/BWT.cpp:60-138),
- ``pac``        : forward-only 2-bit packed genome (bwa ``.pac``),
- contig metadata (bwa ``.ann`` semantics).

Rank/locate semantics (primary-row adjustment, L2 offsets) exactly follow
``lib/bwa/bwt.c:107-163``; see ops/fm_index.py for the device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class FMIndex:
    l_pac: int                 # forward genome length
    seq_len: int               # BWT text length = 2 * l_pac
    primary: int               # row of the (removed) sentinel
    L2: np.ndarray             # (5,) int64: L2[c] = #chars < c in text
    bwt_words: np.ndarray      # (ceil(seq_len/16),) uint32
    occ_cp: np.ndarray         # (n_blocks+1, 4) uint32
    sa_samp: np.ndarray        # (seq_len//sa_intv + 1,) pos_dtype
    sa_intv: int
    kcache_k: int
    kcache_beg: np.ndarray     # (4**k,) pos_dtype (row index)
    kcache_end: np.ndarray     # (4**k,) pos_dtype
    pac: np.ndarray            # (ceil(l_pac/4),) uint8
    contig_names: list
    contig_offsets: np.ndarray  # (n_seqs,) int64
    contig_lengths: np.ndarray  # (n_seqs,) int64
    amb_offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    amb_lengths: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    amb_chars: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))

    _device: Optional[dict] = None
    # precomputed host_arrays() dict (builder._load_index_mmap memory-maps
    # the device-layout sidecar cache into here — Gbp indexes then skip
    # the pac_words repack and npz decompress entirely)
    _host_cache: Optional[dict] = None

    @property
    def pos_dtype(self):
        """int32 when every row/position index fits, else int64.

        Row indices go up to seq_len (2*l_pac); int32 is safe below 2**31-1.
        """
        return np.int32 if self.seq_len < 2**31 - 1 else np.int64

    # ---- host-side queries (used by builder/tests/SAM emission) ----

    def pos2rid(self, pos: int) -> int:
        """Contig id owning forward-genome position ``pos``
        (semantics of bns_pos2rid, used at src/BWT.cpp:646)."""
        return int(np.searchsorted(self.contig_offsets, pos, side="right") - 1)

    def chr_boundaries(self, beg: int, end: int):
        """(chrBeg, chrEnd) inclusive bounds of the contig containing the
        midpoint of [beg, end] (src/BWT.cpp:653-666)."""
        mid = (beg + end) >> 1
        rid = self.pos2rid(mid)
        off = int(self.contig_offsets[rid])
        ln = int(self.contig_lengths[rid])
        return off, off + ln - 1

    def intv_info(self, beg: int, end: int):
        """(name, chr_len, chr_beg, chr_end) for SAM emission
        (src/BWT.cpp:636-651)."""
        mid = (beg + end) >> 1
        rid = self.pos2rid(mid)
        off = int(self.contig_offsets[rid])
        return (
            self.contig_names[rid],
            int(self.contig_lengths[rid]),
            int(beg - off),
            int(end - off),
        )

    def get_ref_codes(self, beg: int, length: int) -> np.ndarray:
        """Forward-genome codes [beg, beg+length) from pac
        (bwt_str_pac2int, src/BWT.cpp:593-599).

        Requests may legitimately touch positions past a contig's end (the
        reference reads the concatenated pac across contig boundaries for
        window-spanning chains); positions beyond the genome end are padded
        with base 0 ('A') instead of reading out of bounds."""
        from ..utils.pack import unpack_pac

        if beg < 0 or beg + length > self.l_pac:
            out = np.zeros(max(length, 0), dtype=np.uint8)
            lo = max(beg, 0)
            hi = min(beg + length, self.l_pac)
            if hi > lo:
                out[lo - beg : hi - beg] = unpack_pac(self.pac, lo, hi - lo)
            return out
        return unpack_pac(self.pac, beg, length)

    def get_ref_str(self, beg: int, length: int) -> bytes:
        """ASCII "ACGT" slice (bwt_str_pac2char, src/BWT.cpp:601-607)."""
        from ..utils.pack import codes_to_seq

        return codes_to_seq(self.get_ref_codes(beg, length))

    # ---- device placement ----

    def host_arrays(self) -> dict:
        """The search-path arrays as host numpy, in device layout.

        ``pac_words`` is the full fwd+revcomp text re-packed 16 bases/
        uint32 — positions < l_pac are the forward genome (gap-DP
        reference fetches); the revcomp half serves the seeder's occ==1
        direct-comparison fast path.  When the fused rank row fits (see
        below) the redundant ``occ_cp``/``bwt_blocks`` pair is omitted
        (the kernels use one layout or the other).
        """
        from ..utils.pack import pack_bwt_words, unpack_pac

        if self._host_cache is not None:
            return self._host_cache
        pdt = self.pos_dtype
        fwd_codes = unpack_pac(self.pac, 0, self.l_pac)
        bwt_blocks = self.bwt_words.reshape(-1, 8)
        # pac_words holds the FULL text fwd + revcomp(fwd) (bntseq.c:
        # 301-307), 16 codes per uint32.  Positions < l_pac read forward-
        # genome codes (what the gap-DP gathers use); the revcomp half
        # lets the seeder's occ==1 fast path compare the pattern against
        # the text directly at any mirror-space position.
        text_codes = np.concatenate([fwd_codes, 3 - fwd_codes[::-1]])
        arrs = {
            "bwt_words": self.bwt_words,
            "sa_samp": self.sa_samp.astype(pdt),
            "kcache_beg": self.kcache_beg.astype(pdt),
            "kcache_end": self.kcache_end.astype(pdt),
            "L2": self.L2.astype(pdt),
            "pac_words": pack_bwt_words(text_codes),
            "contig_offsets": self.contig_offsets.astype(pdt),
            "contig_ends": (
                self.contig_offsets + self.contig_lengths
            ).astype(pdt),
        }
        del text_codes
        # Fused rank row: [cp(A..T) | 8 BWT words] as one (n_blocks, 12)
        # uint32 array, so a rank query is a single 48-byte row gather
        # instead of two (checkpoint + block words).  Per-char counts fit
        # uint32 whenever l_pac < 2^32 (fwd+revcomp mirror symmetry caps
        # count(c) at l_pac); the kernels fall back to occ_cp/bwt_blocks
        # for larger genomes.
        if self.l_pac < 2**32:
            nb = bwt_blocks.shape[0]
            fused = np.empty((nb, 12), dtype=np.uint32)
            fused[:, :4] = self.occ_cp[:nb].astype(np.uint32)
            fused[:, 4:] = bwt_blocks
            arrs["fm_blocks"] = fused
        else:
            # block-major view for rank: one row = one 128-base block
            arrs["occ_cp"] = self.occ_cp
            arrs["bwt_blocks"] = bwt_blocks
        return arrs

    def device_arrays(self, device) -> dict:
        """Put the search-path arrays on ``device`` as torch tensors.

        uint32 words (bwt_words, pac_words, fm_blocks, occ_cp,
        bwt_blocks) become int64 tensors holding the same values, so the
        kernels' shifts are logical and no op needs an unsigned dtype;
        every other array keeps its dtype.  Cached per device."""
        import torch

        device = torch.device(device)
        if self._device is None:
            self._device = {}
        cached = self._device.get(str(device))
        if cached is not None:
            return cached
        host = self.host_arrays()
        arrs = {}
        for k, v in host.items():
            v = np.asarray(v)
            if v.dtype == np.uint32:
                v = v.astype(np.int64)
            elif not v.flags.writeable or not v.flags.c_contiguous:
                v = np.array(v)
            arrs[k] = torch.from_numpy(v).to(device)
        self._device[str(device)] = arrs
        return arrs

    @property
    def meta(self) -> dict:
        """Static (trace-time) scalars for the device kernels."""
        return {
            "l_pac": int(self.l_pac),
            "seq_len": int(self.seq_len),
            "primary": int(self.primary),
            "sa_intv": int(self.sa_intv),
            "kcache_k": int(self.kcache_k),
            "pos_dtype": self.pos_dtype,
        }
