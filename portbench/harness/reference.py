"""The plain reference that decides ``correct``.

It reads the SAM records of a sample of reads and judges them against
the harness's own genome codes and each read's truth (reads.py); it
imports nothing of the program and takes nothing the program made.

For each record it checks what the record says by itself: SEQ is the
read (reverse-complemented on the reverse strand), the CIGAR consumes
the whole read, the span lies inside the named contig, and NM lies
between the edits the reference counts along the CIGAR against the
genome and those plus the soft-clipped bases (lordFAST's NM counts an
end extension's trailing insertions that the CIGAR shows as a clip).  A
record that fails any of these is a bad record.

For each read it prices the answer: the edits of its primary and
supplementary records, counted by the reference, plus the read bases
no record covers (an unmapped read: all of them).  It prices the best
answer too: the least edit distance of the whole read against the
genome around its true path (a semi-global DP inside a band of
``BAND`` diagonals either side of the truth's path, in plain PyTorch,
all the sample's reads at once).  The excess of a read is how far its
answer's price lies above the best, and never below 0: a read placed
elsewhere at no higher price (a repeat copy) costs nothing.

For each read it checks the flags, MAPQ and SA tags (``judge_flags``),
and holds the primary record's MAPQ to where the read was drawn: a read
drawn where no duplication lies (the genome's own layout), and placed at
its truth, may not carry a MAPQ under ``LOW_MAPQ``, the class lordFAST
gives to tied placements.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .genome import duplicated
from .reads import Job, true_path

BAND = 32
INF = 1 << 28
LOW_MAPQ = 10    # lordFAST's class for tied placements: 2.1 + at most 5
_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
_NT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _NT[_c] = _i
    _NT[ord(chr(_c).lower())] = _i


def scan_sam(path, wanted=None) -> tuple:
    """(names with a record, {name: [record fields]} of the wanted
    names) of a SAM file; header lines skipped."""
    seen, recs = set(), {}
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            tab = line.find(b"\t")
            name = line[:tab].decode()
            seen.add(name)
            if wanted is not None and name in wanted:
                recs.setdefault(name, []).append(
                    line.rstrip(b"\n").split(b"\t"))
    return seen, recs


def _nm(fields) -> int | None:
    for f in fields[11:]:
        if f.startswith(b"NM:i:"):
            return int(f[5:])
    return None


def judge_record(fields, read: np.ndarray, genome, contig: dict):
    """One mapped record against the read (as sequenced) and the
    genome.  Returns (problem or None, edits counted, covered [lo, hi)
    of the read)."""
    flag = int(fields[1])
    rev = bool(flag & 16)
    L = len(read)
    ops = [(int(n), op) for n, op in
           _CIGAR.findall(fields[5].decode())]
    if not ops:
        return "no CIGAR", 0, (0, 0)
    if "".join(f"{n}{op}" for n, op in ops) != fields[5].decode():
        return "CIGAR does not parse", 0, (0, 0)
    q_used = sum(n for n, op in ops if op in "MI=XSH")
    if q_used != L:
        return f"CIGAR consumes {q_used} of {L} read bases", 0, (0, 0)
    hard = sum(n for n, op in ops if op == "H")
    if rev:                    # SEQ and CIGAR run along the genome
        read = 3 - read[::-1]
    lead_h = ops[0][0] if ops[0][1] == "H" else 0
    seq = _NT[np.frombuffer(fields[9], np.uint8)]
    if len(seq) != L - hard or not np.array_equal(
            seq, read[lead_h:lead_h + L - hard]):
        return "SEQ is not the read", 0, (0, 0)
    name = fields[2].decode()
    if name not in contig:
        return f"unknown contig {name}", 0, (0, 0)
    c_off, c_len = contig[name]
    pos = int(fields[3]) - 1
    t_span = sum(n for n, op in ops if op in "MDN=X")
    if pos < 0 or pos + t_span > c_len:
        return "span leaves its contig", 0, (0, 0)
    t = c_off + pos
    q = 0
    edits = 0
    clip_lo = clip_hi = 0
    for k, (n, op) in enumerate(ops):
        if op in "M=X":
            g = genome[t:t + n]
            edits += int(np.count_nonzero((g != read[q:q + n]) | (g > 3)))
            q += n
            t += n
        elif op == "I":
            edits += n
            q += n
        elif op in "DN":
            edits += n
            t += n
        elif op in "SH":
            if k == 0:
                clip_lo = n
            else:
                clip_hi = n
            q += n
    # lordFAST's NM is the edit distance of the aligned pieces: an end
    # extension whose path ends in inserted bases shows them as a soft
    # clip and still counts them, a clip escalation's clip it does not
    nm = _nm(fields)
    soft = clip_lo + clip_hi - hard
    if nm is None or not edits <= nm <= edits + soft:
        return (f"NM {nm} outside the {edits} edits counted (+ {soft} "
                f"soft-clipped bases)", edits, (0, 0))
    lo, hi = clip_lo, L - clip_hi
    if rev:
        lo, hi = L - hi, L - lo
    return None, edits, (lo, hi)


def _tag(fields, key: bytes):
    for f in fields[11:]:
        if f.startswith(key):
            return f[len(key):]
    return None


def _fwd_pos(fields, contig: dict) -> int:
    return contig[fields[2].decode()][0] + int(fields[3]) - 1


def judge_flags(recs: list, contig: dict):
    """The flag, MAPQ and SA rules of one read's records (lordFAST's
    printSamEntry): an unmapped read has one record, flag 4, MAPQ 0; a
    mapped read has one primary record, the others of its mapping are
    supplementary (2048) and follow it in chain order (forward position
    rising), each carrying the primary's MAPQ and an SA tag that lists
    every other record of the mapping as written; secondary records
    (256) are no more confident than the primary; MAPQ lies in 0..60.
    Returns the first rule broken, or None."""
    flags = [int(f[1]) for f in recs]
    mapqs = [int(f[4]) for f in recs]
    if any(fl & 4 for fl in flags):
        if len(recs) != 1 or flags[0] != 4 or mapqs[0] != 0:
            return "an unmapped read with other records, flags or MAPQ"
        return None
    if any(fl & ~(16 | 256 | 2048) for fl in flags):
        return "flag bits beside 16, 256 and 2048"
    if any(not 0 <= q <= 60 for q in mapqs):
        return "MAPQ outside 0..60"
    if any(fl & 256 and fl & 2048 for fl in flags):
        return "a record both secondary and supplementary"
    main = [k for k, fl in enumerate(flags) if not fl & 256]
    prim = [k for k in main if not flags[k] & 2048]
    if len(prim) != 1:
        return f"{len(prim)} primary records"
    p = prim[0]
    if main[0] != p:
        return "the primary record is not the first of its mapping"
    if any(mapqs[k] != mapqs[p] for k in main):
        return "a supplementary record's MAPQ is not its primary's"
    if any(mapqs[k] > mapqs[p] for k, fl in enumerate(flags) if fl & 256):
        return "a secondary record more confident than its primary"
    if any(f[2].decode() not in contig for f in recs):
        return "unknown contig"
    pos = [_fwd_pos(recs[k], contig) for k in main]
    if any(b < a for a, b in zip(pos, pos[1:])):
        return "a mapping's records out of chain order"
    if len(main) > 1:
        sa = [b"%s,%s,%s,%s,%d,%s;" % (
            recs[k][2], recs[k][3], b"-" if flags[k] & 16 else b"+",
            recs[k][5], mapqs[k], _tag(recs[k], b"NM:i:") or b"?")
            for k in main]
        for n, k in enumerate(main):
            want = b"".join(sa[:n] + sa[n + 1:])
            if _tag(recs[k], b"SA:Z:") != want:
                return "an SA tag unlike the mapping's other records"
    elif any(_tag(recs[k], b"SA:Z:") is not None for k in main):
        return "an SA tag on a mapping of one record"
    return None


def best_costs(genome: np.ndarray, reads: list, device) -> np.ndarray:
    """The least edit distance of each (read_fwd, start, ops) of reads
    against the genome, semi-global (free reference ends) inside the
    band around the truth's path; all reads at once, row by row."""
    n = len(reads)
    Ls = np.array([len(r[0]) for r in reads], np.int64)
    Lmax = int(Ls.max())
    W = 2 * BAND + 1
    # per read: the band's first reference position for every row
    base = np.zeros((n, Lmax + 1), np.int64)
    q = np.full((n, Lmax), 9, np.uint8)
    seg_len = 0
    paths = []
    for i, (codes, start, ops) in enumerate(reads):
        tp = true_path(ops)
        paths.append((start, tp))
        L = len(codes)
        base[i, :L + 1] = tp
        base[i, L + 1:] = tp[-1]
        q[i, :L] = codes
        seg_len = max(seg_len, int(tp[-1]) + 2 * BAND + 2)
    # the genome around each read: position p of the band (relative to
    # the truth's start) is ref[:, p + BAND]; 5 outside the genome
    ref = np.full((n, seg_len), 5, np.uint8)
    for i, (start, tp) in enumerate(paths):
        lo = start - BAND
        hi = min(start + int(tp[-1]) + BAND + 2, len(genome))
        a = max(lo, 0)
        ref[i, a - lo:hi - lo] = genome[a:hi]
    dev = torch.device(device)
    ref_t = torch.from_numpy(ref.astype(np.int64)).to(dev)
    q_t = torch.from_numpy(q.astype(np.int64)).to(dev)
    base_t = torch.from_numpy(base).to(dev)
    L_t = torch.from_numpy(Ls).to(dev)
    cols = torch.arange(W, device=dev)
    D = torch.zeros((n, W), dtype=torch.int64, device=dev)  # free start
    best = torch.full((n,), INF, dtype=torch.int64, device=dev)
    big = torch.full((n, 1), INF, dtype=torch.int64, device=dev)
    for i in range(1, Lmax + 1):
        s = (base_t[:, i] - base_t[:, i - 1]).unsqueeze(1)
        Dp = torch.cat([D, big], dim=1)              # index W = outside
        up_idx = cols + s
        dg_idx = up_idx - 1
        up = Dp.gather(1, torch.where((up_idx >= 0) & (up_idx < W), up_idx,
                                      W))
        dg = Dp.gather(1, torch.where((dg_idx >= 0) & (dg_idx < W), dg_idx,
                                      W))
        # the reference base the diagonal move consumes: position
        # base_i - BAND + c - 1 relative to the truth's start
        rpos = base_t[:, i].unsqueeze(1) + cols - 1      # + BAND - BAND
        rpos = rpos.clamp(0, seg_len - 1)
        rb = ref_t.gather(1, rpos)
        qb = q_t[:, i - 1].unsqueeze(1)
        mis = ((rb != qb) | (rb > 3)).to(torch.int64)
        V = torch.minimum(dg + mis, up + 1).clamp(max=INF)
        Dn = torch.cummin(V - cols, dim=1).values + cols
        live = (L_t >= i).unsqueeze(1)
        D = torch.where(live, Dn, D)
        best = torch.where(L_t == i, D.min(dim=1).values, best)
    return best.cpu().numpy()


def judge(jobs: list, sam_paths: list, sample: list, genome,
          device, best=None) -> dict:
    """The sample's numbers.  jobs / sam_paths: the window's jobs and
    their SAM files; sample: (job index, read index) pairs; best: the
    sample's least edit distances when already worked out (they depend
    on the reads alone).  Returns the counts and per-read arrays the
    checks read."""
    codes, contig = genome.codes, {
        n: (int(o), int(l)) for n, o, l in zip(genome.names, genome.offsets,
                                               genome.lengths)}
    by_job = {}
    for j, i in sample:
        by_job.setdefault(j, []).append(i)
    bad, flag_bad, problems = 0, 0, []
    n = len(sample)
    price = np.zeros(n, np.int64)
    mapq = np.full(n, -1, np.int64)      # the primary's; -1 unmapped
    at_truth = np.zeros(n, bool)
    lo_t = np.zeros(n, np.int64)
    hi_t = np.zeros(n, np.int64)
    lens = np.zeros(len(sample), np.int64)
    reads = []
    k = 0
    for j, idxs in sorted(by_job.items()):
        job: Job = jobs[j]
        wanted = {job.names[i]: i for i in idxs}
        _, recs = scan_sam(sam_paths[j], wanted)
        for name, i in wanted.items():
            fwd = job.read_codes(i)
            seq = (3 - fwd[::-1]) if job.rev[i] else fwd
            L = len(fwd)
            lens[k] = L
            cover = np.zeros(L, bool)
            edits = 0
            mine = recs.get(name, [])
            lo_t[k] = int(job.start[i])
            hi_t[k] = lo_t[k] + int(job.span[i])
            why = judge_flags(mine, contig) if mine else None
            if why is not None:
                flag_bad += 1
                if len(problems) < 5:
                    problems.append(f"{name}: {why}")
            for f in mine:
                flag = int(f[1])
                if flag & 4 or flag & 256:
                    continue
                why, e, (lo, hi) = judge_record(f, seq, codes, contig)
                if why is not None:
                    bad += 1
                    if len(problems) < 5:
                        problems.append(f"{name}: {why}")
                    continue
                edits += e
                cover[lo:hi] = True
                if not flag & 2048:
                    mapq[k] = int(f[4])
                p0 = _fwd_pos(f, contig)
                span = sum(int(c) for c, op in _CIGAR.findall(
                    f[5].decode()) if op in "MDN=X")
                if p0 < hi_t[k] and p0 + span > lo_t[k]:
                    at_truth[k] = True
            price[k] = edits + int(L - cover.sum())
            reads.append((fwd, int(job.start[i]), job.read_ops(i)))
            k += 1
    if best is None:
        best = best_costs(codes, reads, device)
    excess = np.maximum(price - best, 0)
    mapped = mapq >= 0
    unique = ~duplicated(genome, lo_t, hi_t)
    return {"bad_records": bad, "flag_faults": flag_bad,
            "mapq_low_unique": int((mapped & at_truth & unique
                                    & (mapq < LOW_MAPQ)).sum()),
            "problems": problems, "price": price, "best": best,
            "excess": excess, "lens": lens, "mapq": mapq,
            "at_truth": at_truth, "unique": unique}
