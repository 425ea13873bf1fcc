"""Host chain-stitching: piecewise alignment of a seed chain into SAM
records, behaviorally equivalent to ``alignChain_edlib``
(src/LordFAST.cpp:1765-2258) including the clip / split / inversion
escalation paths, plus the window scoring of ``alignWin``
(src/LordFAST.cpp:1063-1090).

The DP segments themselves run through align.edlib_eq (native C++); this
module reproduces the exact bookkeeping: CIGAR/MD deques, soft-clip
rewriting, editScore accumulation, split record emission and the
reference's (benign) md-ordering quirk in the inversion branch
(src/LordFAST.cpp:2056-2057 pushes cigar at the end but md at the front).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..config import LordfastConfig
from ..utils.pack import INT2NT
from . import edlib_eq as ed

# complement in code space (4/N -> 4)
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def _rc(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes[::-1]]


@dataclass
class SamRecord:
    """One SAM line worth of alignment info (class Sam_t,
    src/LordFAST.h:81-100)."""

    flag: int = 0
    pos: int = 0          # forward-genome coords (global, pre-contig)
    pos_end: int = 0
    q_start: int = 0
    q_end: int = 0
    cigar: str = "*"
    md: str = ""
    nm_count: int = 0
    aln_score: int = 0
    # filled at emission time:
    rname: str = ""
    rstart: int = 0
    mapq: int = 0
    sa: str = ""


@dataclass
class Mapping:
    """SamList_t (src/LordFAST.h:102-107)."""

    records: List[SamRecord] = field(default_factory=list)
    total_score: int = 0


def _cigar_to_string(cig: list) -> str:
    """edlibCigar_toString (src/LordFAST.cpp:1596-1626): run-length encode;
    a leading or trailing I-run becomes S."""
    out = []
    ch, num, opnum = "", 0, 0
    for c in cig:
        if c != ch:
            if ch:
                out.append(f"{num}{'S' if opnum == 0 and ch == 'I' else ch}")
                opnum += 1
            ch, num = c, 1
        else:
            num += 1
    if num:
        out.append(f"{num}{'S' if ch == 'I' else ch}")
    return "".join(out)


def _md_to_string(md: list, cig: list) -> str:
    """edlibMD_toString (src/LordFAST.cpp:1717-1763)."""
    out = []
    num = 0
    last = "="
    for ch_md, ch_cig in zip(md, cig):
        if ch_md == "=":
            num += 1
            last = "="
        elif ch_md == "-":
            last = "I"
        elif ch_cig == "M":
            out.append(str(num))
            num = 0
            out.append(ch_md)
            last = "X"
        elif ch_cig == "D":
            if last != "D":
                out.append(str(num))
                num = 0
                out.append("^")
            out.append(ch_md)
            last = "D"
    out.append(str(num))
    return "".join(out)


def _push_back_aln(cig, md, q_codes, t_codes, moves):
    """edlibCigar_pushback + edlibMD_pushback (src/LordFAST.cpp:1570-1665):
    append move chars and MD chars (target letters for D/X)."""
    ti = 0
    for mv in moves:
        if mv == ed.OP_MATCH:
            cig.append("M")
            md.append("=")
            ti += 1
        elif mv == ed.OP_INSERT:
            cig.append("I")
            md.append("-")
        elif mv == ed.OP_DELETE:
            cig.append("D")
            md.append(chr(INT2NT[t_codes[ti]]))
            ti += 1
        else:  # mismatch
            cig.append("M")
            md.append(chr(INT2NT[t_codes[ti]]))
            ti += 1


def _push_front_aln(cig, md, q_codes, t_codes, moves):
    """edlibCigar_pushfront + edlibMD_pushfront (src/LordFAST.cpp:1583-1715):
    same but pushed to the front in iteration order (net effect: reversed
    block at the front) and MD letters complemented (the target here is a
    reverse-complemented slice)."""
    ti = 0
    head_c, head_m = [], []
    for mv in moves:
        if mv == ed.OP_MATCH:
            head_c.append("M")
            head_m.append("=")
            ti += 1
        elif mv == ed.OP_INSERT:
            head_c.append("I")
            head_m.append("-")
        elif mv == ed.OP_DELETE:
            head_c.append("D")
            head_m.append(chr(INT2NT[_COMP[t_codes[ti]]]))
            ti += 1
        else:
            head_c.append("M")
            head_m.append(chr(INT2NT[_COMP[t_codes[ti]]]))
            ti += 1
    cig[:0] = head_c[::-1]
    md[:0] = head_m[::-1]


def align_chain_edlib(
    chain_q: np.ndarray,
    chain_t: np.ndarray,
    chain_l: np.ndarray,
    query: np.ndarray,   # strand-oriented read codes (0..4)
    read_len: int,
    is_rev: bool,
    idx,
    cfg: LordfastConfig,
) -> Mapping:
    """Port of alignChain_edlib (src/LordFAST.cpp:1765-2258)."""
    n = len(chain_q)
    assert n >= 1
    mat_clip = ed.build_ksw_matrix(cfg.ksw_match_clip, cfg.ksw_mismatch_clip)
    ref = idx.get_ref_codes

    chr_beg, chr_end = idx.chr_boundaries(int(chain_t[0]), int(chain_t[n - 1]))

    mapping = Mapping()
    cig: list = []
    md: list = []
    edit_score = 0

    rec = SamRecord()
    rec.flag = 16 if is_rev else 0
    rec.pos = int(chain_t[0])
    rec.q_start = int(chain_q[0])

    # ---- left end (src/LordFAST.cpp:1820-1899) ----
    r_len = int(chain_q[0])
    t_len = r_len + cfg.end_extension_slack
    if r_len > 0:
        if int(chain_t[0]) - t_len >= chr_beg:
            q_rc = _rc(query[:r_len])
            t_start = int(chain_t[0]) - t_len
            t_fwd = ref(t_start, t_len)
            t_rc = _rc(t_fwd)
            d, end, moves = ed.shw_path(q_rc, t_rc)
            # float32 arithmetic like the reference's (float) cast
            sim = float(np.float32(1.0) - np.float32(d) / np.float32(r_len))
            if r_len > cfg.clip_len and sim < cfg.clip_sim:
                _, qle, tle, _, _ = ed.ksw_extend2(
                    q_rc, t_rc, mat_clip,
                    cfg.ksw_gap_open_clip, cfg.ksw_gap_extend_clip,
                    cfg.ksw_gap_open_clip, cfg.ksw_gap_extend_clip,
                    cfg.clip_band, 0, cfg.clip_zdrop, r_len,
                )
                if 0 < qle < r_len:
                    d2, moves2 = ed.nw_path(q_rc[:qle], t_rc[:tle])
                    _push_front_aln(cig, md, q_rc[:qle], t_rc[:tle], moves2)
                    edit_score -= d2
                    # NW endLocations[0] == tle-1 (edlib.cpp:157-159)
                    rec.pos = int(chain_t[0]) - (tle - 1) - 1
                    rec.q_start = int(chain_q[0]) - qle
                    cig[:0] = ["I"] * (r_len - qle)
                    md[:0] = ["-"] * (r_len - qle)
                else:
                    edit_score -= d
                    _push_front_aln(cig, md, q_rc, t_rc[: end + 1], moves)
                    rec.pos = int(chain_t[0]) - end - 1
                    rec.q_start = 0
            else:
                edit_score -= d
                _push_front_aln(cig, md, q_rc, t_rc[: end + 1], moves)
                rec.pos = int(chain_t[0]) - end - 1
                rec.q_start = 0
        else:  # not enough chromosome left: soft clip
            cig[:0] = ["I"] * r_len
            md[:0] = ["-"] * r_len

    # ---- inter-seed gaps (src/LordFAST.cpp:1901-2137) ----
    num_anchors = 1
    for i in range(n - 1):
        cig.extend(["M"] * int(chain_l[i]))
        md.extend(["="] * int(chain_l[i]))

        r_s = int(chain_q[i]) + int(chain_l[i])
        t_s = int(chain_t[i]) + int(chain_l[i])
        r_e = int(chain_q[i + 1])
        t_e = int(chain_t[i + 1])
        r_len = r_e - r_s
        t_len = t_e - t_s

        if r_len > 0 and t_len > 0:
            t_seq = ref(t_s, t_len)
            q_seq = query[r_s:r_e]
            d, moves = ed.nw_path(q_seq, t_seq)
            sim = float(np.float32(1.0) - np.float32(d) / np.float32(r_len))
            if abs(r_len - t_len) >= cfg.split_len and sim < cfg.split_sim:
                # find split coordinates with affine extension from both
                # directions (src/LordFAST.cpp:1967-1986)
                _, qle1, tle1, _, _ = ed.ksw_extend2(
                    q_seq, t_seq, mat_clip,
                    cfg.split_o_del, cfg.split_e_del,
                    cfg.split_o_ins, cfg.split_e_ins,
                    cfg.split_band, 0, cfg.split_zdrop, r_len,
                )
                _, qle2, tle2, _, _ = ed.ksw_extend2(
                    _rc(q_seq), _rc(t_seq), mat_clip,
                    cfg.split_o_del, cfg.split_e_del,
                    cfg.split_o_ins, cfg.split_e_ins,
                    cfg.split_band, 0, cfg.split_zdrop, r_len,
                )
                r_s_new = r_s + qle1
                t_s_new = t_s + tle1
                r_e_new = r_e - qle2
                t_e_new = t_e - tle2

                if r_s_new < r_e_new or t_s_new < t_e_new:
                    # ---- first part of the split (:1998-2031) ----
                    if r_s_new > r_s or t_s_new > t_s:
                        d1, mv1 = ed.nw_path(
                            query[r_s:r_s_new], t_seq[: t_s_new - t_s]
                        )
                        _push_back_aln(
                            cig, md, query[r_s:r_s_new],
                            t_seq[: t_s_new - t_s], mv1,
                        )
                        edit_score -= d1
                    cig.extend(["I"] * (read_len - r_s_new))
                    md.extend(["-"] * (read_len - r_s_new))
                    rec.cigar = _cigar_to_string(cig)
                    rec.md = _md_to_string(md, cig)
                    rec.pos_end = t_s_new
                    rec.q_end = r_s_new
                    rec.nm_count = edit_score
                    if num_anchors > 1:
                        mapping.records.append(rec)
                        rec = SamRecord(**{**rec.__dict__})
                    cig, md, edit_score = [], [], 0

                    # ---- middle inversion check (:2034-2077) ----
                    if r_s_new < r_e_new and t_s_new < t_e_new:
                        t_mid = ref(t_s_new, t_e_new - t_s_new)
                        q_mid = query[r_s_new:r_e_new]
                        d_f, _ = ed.nw_path(q_mid, t_mid)
                        q_mid_rc = _rc(q_mid)
                        d_r, mv_r = ed.nw_path(q_mid_rc, t_mid)
                        len_mid = r_e_new - r_s_new
                        sim_f = 1.0 - float(d_f) / len_mid
                        sim_r = 1.0 - float(d_r) / len_mid
                        if sim_r > sim_f and sim_r > cfg.reverse_sim:
                            inv = SamRecord()
                            inv.flag = 0 if is_rev else 16  # flipped
                            inv.pos = t_s_new
                            inv.q_start = r_s_new
                            inv.pos_end = t_e_new
                            inv.q_end = r_e_new
                            cig.extend(["I"] * r_s_new)
                            md.extend(["-"] * r_s_new)
                            _push_back_aln(cig, md, q_mid_rc, t_mid, mv_r)
                            edit_score -= d_r
                            cig.extend(["I"] * (read_len - r_e_new))
                            # reference quirk: md '-'s for the tail go to
                            # the FRONT (src/LordFAST.cpp:2056-2057)
                            md[:0] = ["-"] * (read_len - r_e_new)
                            inv.cigar = _cigar_to_string(cig)
                            inv.md = _md_to_string(md, cig)
                            inv.nm_count = edit_score
                            mapping.records.append(inv)
                            cig, md, edit_score = [], [], 0

                    # ---- second part of the split (:2080-2093) ----
                    if r_e_new < r_e or t_e_new < t_e:
                        q_tail_rc = _rc(q_seq)[: r_e - r_e_new]
                        t_tail_rc = _rc(t_seq)[: t_e - t_e_new]
                        d2, mv2 = ed.nw_path(q_tail_rc, t_tail_rc)
                        _push_front_aln(cig, md, q_tail_rc, t_tail_rc, mv2)
                        edit_score -= d2
                    cig[:0] = ["I"] * r_e_new
                    md[:0] = ["-"] * r_e_new
                    rec.flag = 16 if is_rev else 0
                    rec.pos = t_e_new
                    rec.q_start = r_e_new
                    num_anchors = 0
                else:
                    edit_score -= d
                    _push_back_aln(cig, md, q_seq, t_seq, moves)
            else:
                edit_score -= d
                _push_back_aln(cig, md, q_seq, t_seq, moves)
        elif r_len > 0:  # pure insertion (src/LordFAST.cpp:2119-2125)
            cig.extend(["I"] * r_len)
            md.extend(["-"] * r_len)
            edit_score -= r_len
        else:  # pure deletion (:2126-2134)
            cig.extend(["D"] * t_len)
            for ch in ref(t_s, t_len):
                md.append(chr(INT2NT[ch]))
            edit_score -= t_len
        num_anchors += 1

    # ---- last seed + right end (src/LordFAST.cpp:2149-2230) ----
    last = n - 1
    cig.extend(["M"] * int(chain_l[last]))
    md.extend(["="] * int(chain_l[last]))
    rec.pos_end = int(chain_t[last]) + int(chain_l[last]) - 1
    rec.q_end = int(chain_q[last]) + int(chain_l[last]) - 1

    r_s = int(chain_q[last]) + int(chain_l[last])
    r_len = read_len - r_s
    t_len = r_len + cfg.end_extension_slack
    if r_len > 0:
        if int(chain_t[last]) + int(chain_l[last]) + t_len - 1 <= chr_end:
            t_start = int(chain_t[last]) + int(chain_l[last])
            t_seq = ref(t_start, t_len)
            q_seq = query[r_s:read_len]
            d, end, moves = ed.shw_path(q_seq, t_seq)
            sim = float(np.float32(1.0) - np.float32(d) / np.float32(r_len))
            if r_len > cfg.clip_len and sim < cfg.clip_sim:
                _, qle, tle, _, _ = ed.ksw_extend2(
                    q_seq, t_seq, mat_clip,
                    cfg.ksw_gap_open_clip, cfg.ksw_gap_extend_clip,
                    cfg.ksw_gap_open_clip, cfg.ksw_gap_extend_clip,
                    cfg.clip_band, 0, cfg.clip_zdrop, r_len,
                )
                if 0 < qle < r_len:
                    d2, mv2 = ed.nw_path(q_seq[:qle], t_seq[:tle])
                    _push_back_aln(cig, md, q_seq[:qle], t_seq[:tle], mv2)
                    edit_score -= d2
                    rec.pos_end = t_start + (tle - 1)
                    rec.q_end = r_s + qle
                    cig.extend(["I"] * (r_len - qle))
                    md.extend(["-"] * (r_len - qle))
                else:
                    edit_score -= d
                    _push_back_aln(cig, md, q_seq, t_seq[: end + 1], moves)
                    rec.pos_end = t_start + end
                    rec.q_end = read_len
            else:
                edit_score -= d
                _push_back_aln(cig, md, q_seq, t_seq[: end + 1], moves)
                rec.pos_end = t_start + end
                rec.q_end = read_len
        else:
            cig.extend(["I"] * r_len)
            md.extend(["-"] * r_len)

    rec.cigar = _cigar_to_string(cig)
    rec.md = _md_to_string(md, cig)
    rec.nm_count = edit_score
    mapping.records.append(rec)
    return mapping


class _StitchRecordC(__import__("ctypes").Structure):
    _fields_ = [
        ("flag", __import__("ctypes").c_int32),
        ("pos", __import__("ctypes").c_int64),
        ("pos_end", __import__("ctypes").c_int64),
        ("q_start", __import__("ctypes").c_int64),
        ("q_end", __import__("ctypes").c_int64),
        ("nm_count", __import__("ctypes").c_int64),
        ("aln_score", __import__("ctypes").c_int64),
        ("cigar_off", __import__("ctypes").c_int64),
        ("cigar_len", __import__("ctypes").c_int64),
        ("md_off", __import__("ctypes").c_int64),
        ("md_len", __import__("ctypes").c_int64),
    ]


def align_chain_native(
    chain_q, chain_t, chain_l, query, read_len, is_rev, idx, cfg,
    gap_table=None, esc_table=None,
) -> Mapping | None:
    """Native (C++) stitcher: one call per window (native/stitch.cpp).
    Returns None if the native library is unavailable (caller falls back
    to the Python implementation above).

    gap_table: optional (has, dist, end, moves, off, mlen) arrays from the
    device batched Myers kernel (pipeline/engine.py _precompute_gaps) —
    slot 0 = left end, i+1 = gap i, n = right end; the native stitcher
    skips its local DP for precomputed slots.

    esc_table: optional (has, a, b, moves, off) arrays for the clip/split
    escalation DPs (engine _escalation_pass), 6 sub-slots per gap slot:
    ksw fwd (a=qle, b=tle), ksw rc, NW part1/clip-trim (a=dist, b=mlen,
    moves), NW inversion fwd (dist only), NW inversion rc, NW part2.  Any
    missing sub-slot is computed locally — precomputed values are exact,
    so partial coverage changes nothing."""
    import ctypes

    from ..native import _load

    lib = _load()
    if lib is None:
        return None
    n = len(chain_q)
    cq = np.ascontiguousarray(chain_q, dtype=np.int64)
    ct = np.ascontiguousarray(chain_t, dtype=np.int64)
    cl = np.ascontiguousarray(chain_l, dtype=np.int64)
    q = np.ascontiguousarray(query, dtype=np.uint8)
    chr_beg, chr_end = idx.chr_boundaries(int(ct[0]), int(ct[n - 1]))

    slack = cfg.end_extension_slack
    # chains may cross contig boundaries (the reference reads concatenated
    # pac there), so the slice is bounded by the genome, not the contig
    lo = max(0, int(ct[0]) - read_len - slack - 8)
    hi = int(ct[n - 1] + cl[n - 1]) + read_len + slack + 8
    ref_slice = np.ascontiguousarray(idx.get_ref_codes(lo, hi - lo))

    mat_clip = np.ascontiguousarray(
        ed.build_ksw_matrix(cfg.ksw_match_clip, cfg.ksw_mismatch_clip),
        dtype=np.int8,
    )
    max_recs = 64
    recs = (_StitchRecordC * max_recs)()
    strcap = 16 * (read_len + 1024)
    strbuf = ctypes.create_string_buffer(strcap)
    total = ctypes.c_int64(0)
    gp = cfg.gap_penalty if is_rev else 0.15  # reference quirk, see above

    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if gap_table is not None:
        g_has, g_dist, g_end, g_moves, g_off, g_len = (
            np.ascontiguousarray(gap_table[0], dtype=np.uint8),
            np.ascontiguousarray(gap_table[1], dtype=np.int64),
            np.ascontiguousarray(gap_table[2], dtype=np.int64),
            np.ascontiguousarray(gap_table[3], dtype=np.uint8),
            np.ascontiguousarray(gap_table[4], dtype=np.int64),
            np.ascontiguousarray(gap_table[5], dtype=np.int64),
        )
        pre_args = (
            g_has.ctypes.data_as(u8p), g_dist.ctypes.data_as(i64p),
            g_end.ctypes.data_as(i64p), g_moves.ctypes.data_as(u8p),
            g_off.ctypes.data_as(i64p), g_len.ctypes.data_as(i64p),
        )
    else:
        pre_args = (None, None, None, None, None, None)
    if esc_table is not None:
        e_has, e_a, e_b, e_moves, e_off = (
            np.ascontiguousarray(esc_table[0], dtype=np.uint8),
            np.ascontiguousarray(esc_table[1], dtype=np.int64),
            np.ascontiguousarray(esc_table[2], dtype=np.int64),
            np.ascontiguousarray(esc_table[3], dtype=np.uint8),
            np.ascontiguousarray(esc_table[4], dtype=np.int64),
        )
        esc_args = (
            e_has.ctypes.data_as(u8p), e_a.ctypes.data_as(i64p),
            e_b.ctypes.data_as(i64p), e_moves.ctypes.data_as(u8p),
            e_off.ctypes.data_as(i64p),
        )
    else:
        esc_args = (None, None, None, None, None)
    nrec = lib.stitch_chain(
        cq.ctypes.data_as(i64p), ct.ctypes.data_as(i64p),
        cl.ctypes.data_as(i64p), n,
        q.ctypes.data_as(u8p), read_len, int(is_rev),
        ref_slice.ctypes.data_as(u8p), lo, len(ref_slice),
        chr_beg, chr_end,
        cfg.clip_len, cfg.clip_sim, cfg.split_len, cfg.split_sim,
        cfg.reverse_sim, slack,
        mat_clip.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        cfg.ksw_gap_open_clip, cfg.ksw_gap_extend_clip,
        cfg.clip_band, cfg.clip_zdrop,
        cfg.split_o_del, cfg.split_e_del, cfg.split_o_ins, cfg.split_e_ins,
        cfg.split_band, cfg.split_zdrop,
        gp,
        ctypes.cast(recs, ctypes.c_void_p), max_recs,
        strbuf, strcap,
        ctypes.byref(total),
        *pre_args, *esc_args,
    )
    if nrec < 0:
        return None  # buffers too small; fall back to Python path
    raw = strbuf.raw
    m = Mapping(total_score=int(total.value))
    for i in range(nrec):
        r = recs[i]
        m.records.append(
            SamRecord(
                flag=r.flag, pos=r.pos, pos_end=r.pos_end,
                q_start=r.q_start, q_end=r.q_end,
                cigar=raw[r.cigar_off : r.cigar_off + r.cigar_len].decode(),
                md=raw[r.md_off : r.md_off + r.md_len].decode(),
                nm_count=r.nm_count, aln_score=r.aln_score,
            )
        )
    return m


def align_and_score(chain_q, chain_t, chain_l, query, read_len, is_rev,
                    idx, cfg, gap_table=None, esc_table=None) -> Mapping:
    """Stitch + score one window: native fast path with Python fallback.
    gap_table / esc_table: precomputed device DP results (see
    align_chain_native); the Python fallback recomputes locally (same
    results, slower)."""
    m = align_chain_native(
        chain_q, chain_t, chain_l, query, read_len, is_rev, idx, cfg,
        gap_table=gap_table, esc_table=esc_table,
    )
    if m is None:
        m = align_chain_edlib(
            chain_q, chain_t, chain_l, query, read_len, is_rev, idx, cfg
        )
        score_mapping(m, read_len, is_rev, cfg)
    return m


def score_mapping(mapping: Mapping, read_len: int, is_rev: bool,
                  cfg: LordfastConfig) -> None:
    """Window scoring of alignWin (src/LordFAST.cpp:1063-1090).

    Note the reference quirk: the reverse branch scales inter-split gaps by
    the configurable gapPenalty (:1077) but the forward branch hardcodes
    0.15 (:1162); replicated faithfully."""
    gp = cfg.gap_penalty if is_rev else 0.15
    ts = 0
    for r in mapping.records:
        r.aln_score = r.nm_count + (r.q_end - r.q_start)
        ts += r.nm_count
    for a, b in zip(mapping.records, mapping.records[1:]):
        diff = abs(b.pos - a.pos_end) + abs(b.q_start - a.q_end)
        ts = int(ts - gp * diff)  # int32 truncation like the reference
    ts -= mapping.records[0].q_start
    ts -= read_len - mapping.records[-1].q_end
    mapping.total_score = ts
