"""Answers put in the program's place, to show the check can fail.

``truth``: every read placed exactly where it was drawn, with the
simulator's own edit script as its alignment.  Its placement is right
and its NM is true, but it is not edit-distance exact: it breaks the
configurations' third guarantee the way an aligner that fills gaps by a
heuristic instead of an exact DP would.

``shift``: the program's own records with POS moved by one, an answer
altered where it is produced.

``half``: half of each job's reads never reach the program.

``slot``: the reads of one slot of each 128-read batch come back
unmapped, as from a device batch that loses one lane's work.

``mapq``: every mapped record carries one MAPQ (its SA tags too), as
from a MAPQ model that returns a constant.

``flip``: a split read's primary and first supplementary record trade
their flags.
"""

from __future__ import annotations

import numpy as np

from .reads import Job

_OPS = np.frombuffer(b"MMID", np.uint8)   # match, substitution, ins, del
_ASCII = np.frombuffer(b"ACGTN", np.uint8)


def cigar_of(ops: np.ndarray) -> str:
    """Run-length CIGAR of edit operations (0/1 -> M, 2 -> I, 3 -> D)."""
    c = _OPS[ops]
    if len(c) == 0:
        return "*"
    edge = np.flatnonzero(c[1:] != c[:-1]) + 1
    starts = np.concatenate(([0], edge))
    runs = np.diff(np.concatenate((starts, [len(c)])))
    return "".join(f"{n}{chr(c[s])}" for s, n in zip(starts, runs))


def write_truth_sam(job: Job, genome, path) -> None:
    """The truth's records of job's reads, as SAM."""
    names, offs = genome.names, genome.offsets
    with open(path, "w") as f:
        for i, name in enumerate(job.names):
            st = int(job.start[i])
            k = int(np.searchsorted(offs, st, side="right")) - 1
            seq = _ASCII[job.read_codes(i)].tobytes().decode()
            flag = 16 if job.rev[i] else 0
            f.write(f"{name}\t{flag}\t{names[k]}\t{st - int(offs[k]) + 1}"
                    f"\t60\t{cigar_of(job.read_ops(i))}\t*\t0\t0\t{seq}\t*"
                    f"\tNM:i:{int(job.n_err[i])}\n")


def shift_sam(path) -> None:
    """Move every mapped record's POS one base on, in place."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.startswith("@"):
                c = line.split("\t")
                if not int(c[1]) & 4:
                    c[3] = str(int(c[3]) + 1)
                    line = "\t".join(c)
            out.append(line)
    with open(path, "w") as f:
        f.writelines(out)


def _rewrite(path, edit) -> None:
    """Rewrite a SAM file in place, one read's records at a time:
    edit(records as lists of fields) -> records."""
    head, out, cur = [], [], []

    def flush():
        if cur:
            out.extend(edit(cur))
            cur.clear()

    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                head.append(line)
                continue
            c = line.rstrip("\n").split("\t")
            if cur and cur[0][0] != c[0]:
                flush()
            cur.append(c)
    flush()
    with open(path, "w") as f:
        f.writelines(head)
        f.writelines("\t".join(c) + "\n" for c in out)


def slot_sam(path, slot: int = 0, batch: int = 128) -> None:
    """The reads whose index in their job is ``slot`` modulo ``batch``
    come back as one unmapped record each, in place."""
    def edit(recs):
        i = int(recs[0][0].rsplit("r", 1)[1])
        if i % batch != slot:
            return recs
        return [[recs[0][0], "4", "*", "0", "0", "*", "*", "0", "0", "*",
                 "*"]]
    _rewrite(path, edit)


def mapq_sam(path, mapq: int) -> None:
    """Every mapped record, and every SA entry, carries ``mapq``."""
    def edit(recs):
        for c in recs:
            if int(c[1]) & 4:
                continue
            c[4] = str(mapq)
            for k, f in enumerate(c[11:], 11):
                if f.startswith("SA:Z:"):
                    ents = [e.split(",") for e in f[5:].split(";") if e]
                    for e in ents:
                        e[4] = str(mapq)
                    c[k] = "SA:Z:" + "".join(",".join(e) + ";"
                                             for e in ents)
        return recs
    _rewrite(path, edit)


def flip_sam(path) -> None:
    """A split read's primary and first supplementary record trade their
    2048 flag, in place."""
    def edit(recs):
        sup = [c for c in recs if int(c[1]) & 2048]
        if not sup:
            return recs
        prim = next(c for c in recs if not int(c[1]) & (4 | 256 | 2048))
        prim[1] = str(int(prim[1]) | 2048)
        sup[0][1] = str(int(sup[0][1]) & ~2048)
        return recs
    _rewrite(path, edit)


def halve_fasta(src, dst) -> None:
    """The first half of a one-line-a-read FASTA's records."""
    with open(src, "rb") as f:
        lines = f.readlines()
    n = len(lines) // 2
    with open(dst, "wb") as f:
        f.writelines(lines[:2 * (n // 2)])
