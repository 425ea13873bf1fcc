"""Behavioral port of the reference's dormant affine whole-chain
aligner ``alignChain_ksw`` (src/LordFAST.cpp:1264-1464).

The reference hardcodes ``alignChain = &alignChain_edlib``
(src/LordFAST.cpp:213), so this mode is dormant there too; it is ported
for capability completeness (SURVEY.md §2.1).  Differences from the
edlib path, faithfully reproduced:

- ends are extended with ksw_extend under the REGULAR scoring matrix
  (match 2 / mismatch 5 / gap 2+1 — src/LordFAST.cpp:78-82), band 40,
  zdrop 40, h0 = end length, then re-aligned globally (ksw_global) over
  the extension's (qle, tle) prefix with band max(qle, tle);
- inter-seed gaps run ksw_global with band max(r_len, t_len)
  (effectively unbanded); one-sided gaps score -(gapo + len*gape)
  (the reference's off-by-reference-comment variant, :1395-1403);
- no split/inversion/clip escalation, ONE record per chain;
- fixCigar (src/LordFAST.cpp:1233-1262) merges adjacent ops and turns a
  leading or trailing I into S;
- MD/NM are not produced by this mode in the reference (Sam_t.md is left
  unset); we emit md="" and nm_count=0 accordingly.
"""

from __future__ import annotations

import numpy as np

from ..config import LordfastConfig
from . import edlib_eq as ed
from .chain_align import Mapping, SamRecord, _rc


def _fix_cigar(parts) -> str:
    """fixCigar (src/LordFAST.cpp:1233-1262): merge adjacent identical
    ops; the FIRST op becomes S if it is I, and so does the last."""
    out = []
    cnt = 0
    ch = None
    opnum = 0
    for n, c in parts:
        if n == 0:
            continue
        if c == ch:
            cnt += n
        else:
            if cnt:
                out.append((cnt, "S" if opnum == 1 and ch == "I" else ch))
                cnt = 0
            cnt = n
            ch = c
            opnum += 1
    if cnt:
        out.append((cnt, "S" if ch == "I" else ch))
    return "".join(f"{n}{c}" for n, c in out)


def align_chain_ksw(chain_q, chain_t, chain_l, query, read_len, is_rev,
                    idx, cfg: LordfastConfig) -> Mapping:
    n = len(chain_q)
    assert n >= 1
    mat = ed.build_ksw_matrix(cfg.ksw_match, cfg.ksw_mismatch)
    gapo, gape = cfg.ksw_gap_open, cfg.ksw_gap_extend
    ref = idx.get_ref_codes

    rec = SamRecord()
    rec.flag = 16 if is_rev else 0
    rec.pos = int(chain_t[0])
    parts = []  # (count, op-char) in emission order
    aln_score = 0

    # ---- extend before the first seed (:1303-1334) ----
    r_len = int(chain_q[0])
    if r_len > 0:
        q_rc = _rc(query[:r_len])
        t_start = int(chain_t[0]) - r_len
        t_rc = _rc(ref(t_start, r_len))
        _, qle, tle, _, _ = ed.ksw_extend2(
            q_rc, t_rc, mat, gapo, gape, gapo, gape, 40, 0, 40, r_len
        )
        bw = max(qle, tle)
        if qle > 0 or tle > 0:
            sc, cig = ed.ksw_global(q_rc[:qle], t_rc[:tle], mat, gapo,
                                    gape, max(bw, 1))
            aln_score += sc
        else:
            cig = []
        if qle < r_len:
            parts.append((r_len - qle, "S"))
        for op, ln in reversed(cig):
            parts.append((ln, op))
        rec.pos = int(chain_t[0]) - tle

    # ---- seeds + inter-seed gaps (:1336-1405) ----
    for i in range(n - 1):
        parts.append((int(chain_l[i]), "M"))
        aln_score += int(chain_l[i]) * cfg.ksw_match
        r_s = int(chain_q[i]) + int(chain_l[i])
        t_s = int(chain_t[i]) + int(chain_l[i])
        r_len = int(chain_q[i + 1]) - r_s
        t_len = int(chain_t[i + 1]) - t_s
        if r_len > 0 and t_len > 0:
            sc, cig = ed.ksw_global(
                query[r_s : r_s + r_len], ref(t_s, t_len), mat, gapo,
                gape, max(r_len, t_len),
            )
            aln_score += sc
            for op, ln in cig:
                parts.append((ln, op))
        elif r_len > 0:
            parts.append((r_len, "I"))
            aln_score -= gapo + r_len * gape
        else:
            parts.append((t_len, "D"))
            aln_score -= gapo + t_len * gape

    last = n - 1
    parts.append((int(chain_l[last]), "M"))
    aln_score += int(chain_l[last]) * cfg.ksw_match
    rec.pos_end = int(chain_t[last]) + int(chain_l[last]) - 1

    # ---- extend after the last seed (:1420-1452) ----
    r_s = int(chain_q[last]) + int(chain_l[last])
    r_len = read_len - r_s
    if r_len > 0:
        t_start = int(chain_t[last]) + int(chain_l[last])
        q_seq = query[r_s:read_len]
        t_seq = ref(t_start, r_len)
        _, qle, tle, _, _ = ed.ksw_extend2(
            q_seq, t_seq, mat, gapo, gape, gapo, gape, 40, 0, 40, r_len
        )
        if qle > 0 or tle > 0:
            sc, cig = ed.ksw_global(q_seq[:qle], t_seq[:tle], mat, gapo,
                                    gape, max(max(qle, tle), 1))
            aln_score += sc
            for op, ln in cig:
                parts.append((ln, op))
        if qle < r_len:
            parts.append((r_len - qle, "S"))
        rec.pos_end = t_start + tle - 1

    rec.cigar = _fix_cigar(parts)
    rec.md = ""
    rec.nm_count = 0
    rec.aln_score = aln_score
    rec.q_start = 0
    rec.q_end = read_len
    return Mapping(records=[rec], total_score=aln_score)
