"""Base-encoding and 2-bit packing utilities (host side, numpy).

Encoding: A=0, C=1, G=2, T=3, anything else=4 (N), matching the
reference's ``nst_nt4_table`` / ``_pf_char2int`` (``src/LordFAST.cpp:158-164``).

Packing convention matches bwa's ``.pac``: base at position ``l`` lives in
byte ``l>>2`` at bit shift ``(~l&3)<<1`` (``lib/bwa/bntseq.c:224-225``), i.e.
the first base of each byte occupies the two MOST significant bits.  The
BWT word packing uses the analogous 16-bases-per-uint32 convention of
``lib/bwa/bwt.h:72-78``.
"""

from __future__ import annotations

import numpy as np

# char -> 2-bit code (everything non-ACGT = 4)
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    NT4_TABLE[ord(_c)] = _v
    NT4_TABLE[ord(_c.lower())] = _v

INT2NT = np.frombuffer(b"ACGTN", dtype=np.uint8)

# char -> complement char ('A'<->'T', 'C'<->'G', else 'N'), reference
# src/Common.cpp reverseComplement semantics.
COMP_TABLE = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("G", "C"), ("T", "A")):
    COMP_TABLE[ord(_a)] = ord(_b)
    COMP_TABLE[ord(_a.lower())] = ord(_b)


def seq_to_codes(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes 0..4."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return NT4_TABLE[arr]


def codes_to_seq(codes: np.ndarray) -> bytes:
    """uint8 codes 0..4 -> ASCII bytes."""
    return INT2NT[np.asarray(codes, dtype=np.uint8)].tobytes()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space; N (4) stays 4."""
    c = codes[::-1]
    return np.where(c < 4, 3 - c, c).astype(np.uint8)


def revcomp_str(seq: bytes | str) -> bytes:
    """Reverse complement of an ASCII sequence (non-ACGT -> N)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8)
    return COMP_TABLE[arr][::-1].tobytes()


def pack_pac(codes: np.ndarray) -> np.ndarray:
    """2-bit pack codes (values 0..3) into bwa .pac byte layout."""
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(-1, 4).astype(np.uint16)
    packed = (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]
    return packed.astype(np.uint8)


def unpack_pac(pac: np.ndarray, start: int, length: int) -> np.ndarray:
    """Extract codes [start, start+length) from bwa .pac byte layout."""
    if length <= 0:
        return np.zeros(0, dtype=np.uint8)
    idx = np.arange(start, start + length, dtype=np.int64)
    return ((pac[idx >> 2] >> (((~idx) & 3) << 1).astype(np.uint8)) & 3).astype(np.uint8)


def pack_bwt_words(codes: np.ndarray) -> np.ndarray:
    """Pack codes (0..3) 16-per-uint32, base k at shift (~k&15)<<1.

    Matches the layout read by ``bwt_B0`` (``lib/bwa/bwt.h:72-78``) after
    stripping the interleaved checkpoint words (we keep checkpoints in a
    separate array instead — device-friendlier than bwa's interleaving).
    """
    n = len(codes)
    nw = (n + 15) // 16
    padded = np.zeros(nw * 16, dtype=np.uint32)
    padded[:n] = codes
    lanes = padded.reshape(-1, 16)
    shifts = ((~np.arange(16)) & 15) << 1  # 30, 28, ..., 0
    return np.bitwise_or.reduce(lanes << shifts[None, :].astype(np.uint32), axis=1).astype(np.uint32)


def unpack_bwt_words(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_bwt_words: first n codes."""
    k = np.arange(n, dtype=np.int64)
    return ((words[k >> 4] >> (((~k) & 15) << 1).astype(np.uint32)) & 3).astype(np.uint8)


class Rand48:
    """drand48/lrand48 LCG, for bit-exact parity with bwa's N-base
    randomization (``lib/bwa/bntseq.c:261,290-291``: srand48(11), N ->
    lrand48()&3)."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int = 11):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def lrand48(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x >> 17  # non-negative long in [0, 2**31)

    def fill_n_bases(self, codes: np.ndarray) -> np.ndarray:
        """Replace code-4 (N) entries with lrand48()&3, in sequence order."""
        out = codes.copy()
        n_idx = np.nonzero(codes >= 4)[0]
        for i in n_idx:
            out[i] = self.lrand48() & 3
        return out
