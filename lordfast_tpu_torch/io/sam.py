"""SAM emission: header, MAPQ model and record formatting, equivalent to
printSamHeader (src/BWT.cpp:668-681) and printSamEntry
(src/LordFAST.cpp:318-459)."""

from __future__ import annotations

from typing import List, Optional, TextIO

import numpy as np

from .. import __version__
from ..align.chain_align import Mapping
from ..config import LordfastConfig
from ..utils.pack import revcomp_str


def write_header(out: TextIO, idx, cfg: LordfastConfig, command_line: str):
    out.write("@HD\tVN:1.5\tSO:unsorted\n")
    for name, length in zip(idx.contig_names, idx.contig_lengths):
        out.write(f"@SQ\tSN:{name}\tLN:{int(length)}\n")
    if cfg.read_group_id:
        out.write(cfg.read_group + "\n")
    out.write(
        f"@PG\tID:lordfast\tPN:lordfast\tVN:{__version__}\tCL:{command_line}\n"
    )


def emit_read(
    out: TextIO,
    idx,
    cfg: LordfastConfig,
    qname: str,
    seq: bytes,
    qual: Optional[bytes],
    mappings: List[Mapping],
) -> None:
    """printSamEntry equivalent (src/LordFAST.cpp:318-459).

    mappings: sorted by total_score descending; may be empty or start with
    an unmapped (no-records) mapping."""
    read_len = len(seq)
    qual_s = qual.decode() if qual else "*"
    seq_s = seq.decode()
    num = len(mappings)

    if num == 0 or not mappings[0].records:
        # unmapped (src/LordFAST.cpp:408-415)
        out.write(f"{qname}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq_s}\t{qual_s}")
        if cfg.read_group_id:
            out.write(f"\tRG:Z:{cfg.read_group_id}")
        out.write("\n")
        return

    seq_rev = revcomp_str(seq).decode()
    qual_rev = qual_s[::-1] if qual else "*"

    # ---- MAPQ model (src/LordFAST.cpp:325-356) ----
    best_edit = float(-mappings[0].total_score) / read_len
    mapq_portion = 50.0 / (cfg.max_map - 1)
    x1 = sum(1 for m in mappings if m.records)
    x2 = sum(
        1
        for m in mappings
        if m.records and float(-m.total_score) / read_len * 0.95 < best_edit
    )
    mapq = 2.1 if x2 > 1 else (cfg.max_map - x1) * mapq_portion

    for i, m in enumerate(mappings):
        if i == 0:
            ts0 = float(-m.total_score) / read_len
            if num == 1 or (
                num > 1
                and ts0 < 0.15
                and ts0 < 0.95 * (float(-mappings[1].total_score) / read_len)
            ):
                mapq_int = 60
            else:
                mapq_int = int(mapq + 5 * (0.2 - ts0) / 0.2)

            # fill per-record contig info + SA strings
            for r in m.records:
                name, _, cb, _ = idx.intv_info(r.pos, r.pos_end)
                r.rname = name
                r.rstart = cb
                r.mapq = mapq_int
            for r in m.records:
                r.sa = (
                    f"{r.rname},{r.rstart + 1},"
                    f"{'-' if r.flag & 16 else '+'},"
                    f"{r.cigar},{mapq_int},{abs(r.nm_count)};"
                )
            for j, r in enumerate(m.records):
                flag = r.flag | 2048 if j > 0 else r.flag
                _write_line(
                    out, cfg, qname, flag, r, max(mapq_int, 0),
                    seq_rev if r.flag & 16 else seq_s,
                    qual_rev if r.flag & 16 else qual_s,
                )
                if len(m.records) > 1:
                    sa = "".join(
                        m.records[z].sa for z in range(len(m.records)) if z != j
                    )
                    out.write(f"\tSA:Z:{sa}")
                out.write("\n")
        elif m.records:
            tsi = float(-m.total_score) / read_len
            mapq_int = int(mapq + 5 * (0.2 - tsi) / 0.2)
            for r in m.records:
                name, _, cb, _ = idx.intv_info(r.pos, r.pos_end)
                r.rname = name
                r.rstart = cb
                _write_line(
                    out, cfg, qname, r.flag | 256, r, max(mapq_int, 0),
                    seq_rev if r.flag & 16 else seq_s,
                    qual_rev if r.flag & 16 else qual_s,
                )
                out.write("\n")


def _write_line(out, cfg, qname, flag, r, mapq, seq_s, qual_s):
    out.write(
        f"{qname}\t{flag}\t{r.rname}\t{r.rstart + 1}\t{mapq}\t{r.cigar}"
        f"\t*\t0\t0\t{seq_s}\t{qual_s}"
        f"\tAS:i:{r.aln_score}\tXS:i:0\tNM:i:{abs(r.nm_count)}\tMD:Z:{r.md}"
    )
    if cfg.read_group_id:
        out.write(f"\tRG:Z:{cfg.read_group_id}")
