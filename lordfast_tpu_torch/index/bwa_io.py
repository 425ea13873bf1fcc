"""bwa / lordfast on-disk index interop.

Reads and writes the exact file set the reference binary uses
(``<ref>.bwt .sa .pac .ann .amb`` + the lordFAST ``<ref>.cache``), so

- an index built by the reference (``bwa_index``, lib/bwa/bwtindex.c:
  187-293, + ``bwt_cache_gen``, src/BWT.cpp:60-138) loads directly into
  :class:`FMIndex`, and
- an index built by this package's (much faster, SA-IS) builder can be
  exported for the reference binary to map with — which is how the
  Gbp-scale head-to-head benchmark runs the reference at all.

Formats (all little-endian, bwtint_t = uint64):

``.bwt``   primary u64, L2[1..4] u64, then the interleaved stream
           (bwt_dump_bwt, lib/bwa/bwt.c:385-393): per 128-base block,
           4 u64 cumulative char counts followed by 8 u32 words of
           2-bit bases (bwt_bwtupdate_core, lib/bwa/bwtindex.c:158-180;
           layout macros lib/bwa/bwt.h:71-78), with one final count
           quartet appended after the last (possibly partial) block.
``.sa``    primary u64, L2[1..4] u64, sa_intv u64, seq_len u64, then
           sa[1..n_sa-1] u64 (bwt_dump_sa, lib/bwa/bwt.c:396-406;
           sa[0] = -1 is implicit, bwt_restore_sa :433-442).
``.pac``   2-bit packed forward genome, base k at shift (~k&3)<<1,
           padded so the file is always l_pac/4+2 bytes with the last
           byte = l_pac%4 (bns_fasta2bntseq, lib/bwa/bntseq.c:308-319).
``.ann``   text: "l_pac n_seqs seed", then per contig "gi name[ anno]"
           and "offset len n_ambs" (bns_dump, lib/bwa/bntseq.c:66-82).
``.amb``   text: "l_pac n_seqs n_holes", then "offset len char" per
           ambiguity hole (bns_dump, lib/bwa/bntseq.c:85-94).
``.cache`` kCache i32, cs=4^k i32, then cs x {beg u64, end u64} SA
           intervals (bwt_cache_gen/load, src/BWT.cpp:129-133,159-187).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import LordfastConfig
from .container import FMIndex

OCC_INTERVAL = 128
BWA_SEED = 11  # srand48 seed bwa hardcodes (bntseq.c:289); ours matches


def _u64(a):
    return np.asarray(a, dtype="<u8")


def bwa_files_present(ref_path) -> bool:
    p = str(ref_path)
    return all(
        Path(p + ext).exists()
        for ext in (".bwt", ".sa", ".pac", ".ann", ".amb", ".cache")
    )


# ---------------------------------------------------------------- load

def _load_bwt(path):
    """(primary, L2, bwt_words, occ_cp) from the interleaved .bwt."""
    raw = np.fromfile(path, dtype="<u4")
    primary = int(raw[:2].view("<u8")[0])
    L2 = np.zeros(5, np.int64)
    L2[1:] = raw[2:10].view("<u8").astype(np.int64)
    n = int(L2[4])  # seq_len (bwt_restore_bwt, lib/bwa/bwt.c:459)
    # the internal layout stores cumulative occ counts as uint32
    # (container.FMIndex.occ_cp); bwa's on-disk counts are u64, so a
    # genome where one character's count in the doubled text reaches
    # 2^32 (total > ~8.5 Gbp at uniform composition) would load silently
    # corrupted — fail loudly instead
    if int(np.diff(L2).max()) >= 2**32:
        raise ValueError(
            f"{path}: per-character occ counts exceed uint32 "
            f"(genome too large for the internal occ layout)"
        )
    stream = raw[10:]

    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    n_data = (n + 15) // 16
    n_occ = n_blocks + 1
    if len(stream) != n_occ * 8 + n_data:
        raise ValueError(
            f"{path}: {len(stream)} words != {n_occ * 8 + n_data} expected"
        )

    bwt_words = np.zeros(n_blocks * 8, np.uint32)
    occ_cp = np.zeros((n_blocks + 1, 4), np.uint32)
    full = n // OCC_INTERVAL  # full 16-word blocks
    if full:
        body = stream[: full * 16].reshape(full, 16)
        occ_cp[:full] = (
            body[:, :8].reshape(full, 4, 2).copy().view("<u8")
            .reshape(full, 4).astype(np.uint32)
        )
        bwt_words[: full * 8] = body[:, 8:].reshape(-1)
    tail = stream[full * 16 :]
    # per-block counts written at block START; a trailing partial block
    # has its occ quartet then its data words, then the final quartet
    if full < n_blocks:
        occ_cp[full] = tail[:8].reshape(4, 2).copy().view("<u8").reshape(4)
        ndw = n_data - full * 8
        bwt_words[full * 8 : full * 8 + ndw] = tail[8 : 8 + ndw]
        tail = tail[8 + ndw :]
    occ_cp[n_blocks] = tail[:8].reshape(4, 2).copy().view("<u8").reshape(4)
    return primary, L2, bwt_words, occ_cp


def _load_sa(path, primary, seq_len):
    raw = np.fromfile(path, dtype="<u8")
    if int(raw[0]) != primary:
        raise ValueError(f"{path}: primary mismatch")
    sa_intv = int(raw[5])
    if int(raw[6]) != seq_len:
        raise ValueError(f"{path}: seq_len mismatch")
    n_sa = (seq_len + sa_intv) // sa_intv
    vals = raw[7:]
    if len(vals) != n_sa - 1:
        raise ValueError(f"{path}: {len(vals)} SA entries != {n_sa - 1}")
    sa = np.empty(n_sa, np.int64)
    sa[0] = -1  # bwt_restore_sa, lib/bwa/bwt.c:436
    sa[1:] = vals.astype(np.int64)
    return sa, sa_intv


def _load_ann_amb(ref_path):
    names, offsets, lengths = [], [], []
    with open(str(ref_path) + ".ann") as f:
        l_pac, n_seqs, _seed = (int(x) for x in f.readline().split())
        for _ in range(n_seqs):
            head = f.readline().split(maxsplit=2)
            names.append(head[1])
            off, ln, _namb = (int(x) for x in f.readline().split())
            offsets.append(off)
            lengths.append(ln)
    amb_off, amb_len, amb_chr = [], [], []
    with open(str(ref_path) + ".amb") as f:
        l_pac2, _n, n_holes = (int(x) for x in f.readline().split())
        if l_pac2 != l_pac:
            raise ValueError(".amb/.ann l_pac mismatch")
        for _ in range(n_holes):
            off, ln, ch = f.readline().split()
            amb_off.append(int(off))
            amb_len.append(int(ln))
            amb_chr.append(ord(ch))
    return (l_pac, names, np.asarray(offsets, np.int64),
            np.asarray(lengths, np.int64), np.asarray(amb_off, np.int64),
            np.asarray(amb_len, np.int64), np.asarray(amb_chr, np.uint8))


def _load_cache(path):
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype="<i4", count=2)
        k, cs = int(head[0]), int(head[1])
        tab = np.fromfile(f, dtype="<u8", count=2 * cs).reshape(cs, 2)
    return k, tab[:, 0].astype(np.int64), tab[:, 1].astype(np.int64)


def load_bwa_index(ref_path, cfg: LordfastConfig | None = None) -> FMIndex:
    """Load a reference-built ``.bwt/.sa/.pac/.ann/.amb/.cache`` set
    (bwa_idx_load, lib/bwa/bwa.c:252-284 + bwt_cache_load,
    src/BWT.cpp:159-187) into an :class:`FMIndex`."""
    ref_path = str(ref_path)
    primary, L2, bwt_words, occ_cp = _load_bwt(ref_path + ".bwt")
    seq_len = int(L2[4])
    sa_samp, sa_intv = _load_sa(ref_path + ".sa", primary, seq_len)
    (l_pac, names, offsets, lengths, amb_off, amb_len,
     amb_chr) = _load_ann_amb(ref_path)
    if seq_len != 2 * l_pac:
        raise ValueError(f"seq_len {seq_len} != 2*l_pac {2 * l_pac}")
    n_pac_bytes = (l_pac + 3) // 4
    pac = np.fromfile(ref_path + ".pac", dtype=np.uint8)[:n_pac_bytes]
    kcache_k, kbeg, kend = _load_cache(ref_path + ".cache")
    return FMIndex(
        l_pac=l_pac, seq_len=seq_len, primary=primary, L2=L2,
        bwt_words=bwt_words, occ_cp=occ_cp, sa_samp=sa_samp,
        sa_intv=sa_intv, kcache_k=kcache_k, kcache_beg=kbeg,
        kcache_end=kend, pac=pac, contig_names=names,
        contig_offsets=offsets, contig_lengths=lengths,
        amb_offsets=amb_off, amb_lengths=amb_len, amb_chars=amb_chr,
    )


# ---------------------------------------------------------------- save

def _dump_bwt(path, idx: FMIndex):
    n = idx.seq_len
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    n_data = (n + 15) // 16
    full = n // OCC_INTERVAL
    occ64 = idx.occ_cp.astype("<u8")  # (n_blocks+1, 4)
    words = idx.bwt_words.astype("<u4")
    with open(path, "wb") as f:
        _u64([idx.primary]).tofile(f)
        _u64(idx.L2[1:]).tofile(f)
        if full:
            body = np.empty((full, 16), "<u4")
            body[:, :8] = occ64[:full].view("<u4").reshape(full, 8)
            body[:, 8:] = words[: full * 8].reshape(full, 8)
            body.tofile(f)
        if full < n_blocks:
            occ64[full : full + 1].view("<u4").tofile(f)
            words[full * 8 : n_data].tofile(f)
        occ64[n_blocks : n_blocks + 1].view("<u4").tofile(f)


def _dump_sa(path, idx: FMIndex, out_intv: int = 32):
    if idx.sa_intv == out_intv:
        sa = idx.sa_samp
    elif idx.sa_intv == 1:
        sa = idx.sa_samp[::out_intv]
    elif out_intv % idx.sa_intv == 0:
        sa = idx.sa_samp[:: out_intv // idx.sa_intv]
    else:
        raise ValueError(
            f"cannot derive interval-{out_intv} SA from interval-"
            f"{idx.sa_intv} samples"
        )
    with open(path, "wb") as f:
        _u64([idx.primary]).tofile(f)
        _u64(idx.L2[1:]).tofile(f)
        _u64([out_intv, idx.seq_len]).tofile(f)
        _u64(sa[1:]).tofile(f)  # sa[0] = -1 implicit


def _dump_pac(path, idx: FMIndex):
    with open(path, "wb") as f:
        idx.pac.tofile(f)
        if idx.l_pac % 4 == 0:
            np.zeros(1, np.uint8).tofile(f)
        np.asarray([idx.l_pac % 4], np.uint8).tofile(f)


def _dump_ann_amb(ref_path, idx: FMIndex):
    with open(str(ref_path) + ".ann", "w") as f:
        f.write(f"{idx.l_pac} {len(idx.contig_names)} {BWA_SEED}\n")
        namb = np.zeros(len(idx.contig_names), np.int64)
        if len(idx.amb_offsets):
            rid = np.searchsorted(idx.contig_offsets, idx.amb_offsets,
                                  side="right") - 1
            np.add.at(namb, rid, 1)
        for i, name in enumerate(idx.contig_names):
            f.write(f"0 {name}\n")
            f.write(f"{int(idx.contig_offsets[i])} "
                    f"{int(idx.contig_lengths[i])} {int(namb[i])}\n")
    with open(str(ref_path) + ".amb", "w") as f:
        f.write(f"{idx.l_pac} {len(idx.contig_names)} "
                f"{len(idx.amb_offsets)}\n")
        for i in range(len(idx.amb_offsets)):
            f.write(f"{int(idx.amb_offsets[i])} {int(idx.amb_lengths[i])} "
                    f"{chr(int(idx.amb_chars[i]))}\n")


def _dump_cache(path, idx: FMIndex):
    cs = 4 ** idx.kcache_k
    tab = np.empty((cs, 2), "<u8")
    tab[:, 0] = idx.kcache_beg.astype(np.uint64)
    tab[:, 1] = idx.kcache_end.astype(np.uint64)
    with open(path, "wb") as f:
        np.asarray([idx.kcache_k, cs], "<i4").tofile(f)
        tab.tofile(f)


def save_bwa_index(idx: FMIndex, ref_path):
    """Write the full reference-compatible file set next to ``ref_path``
    (the FASTA path, as the reference binary expects)."""
    ref_path = str(ref_path)
    _dump_bwt(ref_path + ".bwt", idx)
    _dump_sa(ref_path + ".sa", idx)
    _dump_pac(ref_path + ".pac", idx)
    _dump_ann_amb(ref_path, idx)
    _dump_cache(ref_path + ".cache", idx)
