"""Reads drawn from a genome by a traffic mix, and their truth.

A job is ``job_reads`` reads.  Every job of a mix holds the same
multiset of read lengths and of accuracies (quantile grids of the mix's
laws), in an order drawn from the run's seed, so that every seed gives
the same amount of work; the seed draws the strand, the start and the
errors.  The error model follows PBSIM's CLR model in shape (Ono et al.
2013): at each step along the genome an error happens with probability
1 - accuracy, and it is a substitution, an insertion or a deletion in
the mix's ratio.  Starts are uniform over the places where the whole
read's reference span lies inside a contig's core (no N).

Each read keeps its truth: contig, strand, forward start and span, its
forward-oriented codes and its edit operations (0 match, 1 substitution,
2 insertion, 3 deletion), from which the reference recovers the true
path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

from .genome import Genome

MATCH, SUB, INS, DEL = 0, 1, 2, 3
_ASCII = np.frombuffer(b"ACGTN", np.uint8)


def length_grid(law: dict, n: int) -> np.ndarray:
    """n read lengths: the (i + 0.5) / n quantiles of a lognormal of the
    law's median and sigma, cut to [min, max] (the mass outside is put
    at the cuts' quantiles, not piled on the cuts)."""
    nd = NormalDist()
    lo = nd.cdf((np.log(law["min"]) - np.log(law["median"])) / law["sigma"])
    hi = nd.cdf((np.log(law["max"]) - np.log(law["median"])) / law["sigma"])
    q = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    z = np.array([nd.inv_cdf(float(x)) for x in q])
    ln = np.exp(np.log(law["median"]) + law["sigma"] * z)
    return np.clip(np.rint(ln), law["min"], law["max"]).astype(np.int64)


def accuracy_grid(law: dict, n: int) -> np.ndarray:
    """n accuracies: quantiles of a normal(mean, sd) cut to [min, max]."""
    nd = NormalDist(law["mean"], law["sd"])
    lo, hi = nd.cdf(law["min"]), nd.cdf(law["max"])
    q = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return np.array([nd.inv_cdf(float(x)) for x in q])


@dataclass
class Job:
    """One job's reads (as mapped) and their truth."""
    names: list
    lens: np.ndarray        # (n,) read lengths
    rev: np.ndarray         # (n,) bool, drawn from the reverse strand
    start: np.ndarray       # (n,) forward coordinate of the span's start
    span: np.ndarray        # (n,) reference bases the read covers
    n_err: np.ndarray       # (n,) edit operations in the read's truth
    codes: np.ndarray       # forward-oriented read codes, concatenated
    code_off: np.ndarray    # (n + 1,) read i is codes[code_off[i]:...]
    ops: np.ndarray         # edit operations, concatenated
    op_off: np.ndarray      # (n + 1,)

    @property
    def bases(self) -> int:
        return int(self.lens.sum())

    def read_codes(self, i: int) -> np.ndarray:
        return self.codes[self.code_off[i]:self.code_off[i + 1]]

    def read_ops(self, i: int) -> np.ndarray:
        return self.ops[self.op_off[i]:self.op_off[i + 1]]

    def write_fasta(self, path) -> None:
        """The reads as they come off the instrument, reverse-strand
        reads reverse-complemented, one line a read."""
        out = []
        for i, name in enumerate(self.names):
            c = self.read_codes(i)
            if self.rev[i]:
                c = 3 - c[::-1]
            out.append(b">%s\n%s\n" % (name.encode(), _ASCII[c].tobytes()))
        with open(path, "wb") as f:
            f.write(b"".join(out))
            # on disk before the window, so that no write-back of the
            # pool runs under it
            f.flush()
            os.fsync(f.fileno())


def make_job(g: Genome, traffic: dict, seed: int, job: int,
             stream: int = 0) -> Job:
    """Job ``job`` of the mix under ``seed``; ``stream`` keeps warm-up
    jobs (1) apart from the window's (0)."""
    rng = np.random.default_rng([int(seed), int(stream), int(job)])
    n = int(traffic["job_reads"])
    lens = rng.permutation(length_grid(traffic["length"], n))
    acc = rng.permutation(accuracy_grid(traffic["accuracy"], n))
    ratio = traffic["error_ratio"]
    tot = float(ratio["sub"] + ratio["ins"] + ratio["del"])
    p_sub, p_ins = ratio["sub"] / tot, ratio["ins"] / tot

    # draw more steps than any read needs (a step emits a read base
    # unless it is a deletion, p <= 0.2 x 0.3), then cut each read at its
    # length
    slots = (lens * 1.1).astype(np.int64) + 200
    seg = np.concatenate(([0], np.cumsum(slots)))
    total = int(seg[-1])
    err = np.repeat((1.0 - acc).astype(np.float32), slots)
    u = rng.random(total, dtype=np.float32)
    ops = np.zeros(total, np.uint8)
    hit = u < err
    v = u[hit] / err[hit]            # uniform in [0, 1) given an error
    ops[hit] = (1 + (v >= p_sub).astype(np.uint8)
                + (v >= p_sub + p_ins).astype(np.uint8))
    emits = np.cumsum(ops != DEL)
    before = np.concatenate(([0], emits))[seg[:-1]]
    cut = np.searchsorted(emits, before + lens, side="left")
    if (cut >= seg[1:]).any():
        raise RuntimeError("a read ran out of drawn error steps")
    marks = np.zeros(total + 1, np.int8)
    marks[seg[:-1]] += 1
    marks[cut + 1] -= 1
    ops = ops[np.cumsum(marks[:-1]) > 0]
    kept_len = cut - seg[:-1] + 1
    op_off = np.concatenate(([0], np.cumsum(kept_len))).astype(np.int64)
    consumes = ops != INS
    span = np.add.reduceat(consumes.astype(np.int64), op_off[:-1])
    n_err = np.add.reduceat((ops != MATCH).astype(np.int64), op_off[:-1])

    # starts: uniform over the places the whole span fits inside a core
    clen = (g.cores[:, 1] - g.cores[:, 0])[None, :]
    w = np.maximum(clen - span[:, None], 0).astype(np.float64)
    if (w.sum(axis=1) <= 0).any():
        raise ValueError("a read is longer than every contig's core")
    cw = np.cumsum(w, axis=1)
    x = rng.random(n) * cw[:, -1]
    k = (cw <= x[:, None]).sum(axis=1)
    prev = np.where(k > 0, cw[np.arange(n), np.maximum(k - 1, 0)], 0.0)
    start = g.cores[k, 0] + np.minimum((x - prev).astype(np.int64),
                                       np.maximum(w[np.arange(n), k] - 1, 0)
                                       .astype(np.int64))
    rev = rng.random(n) < 0.5

    # the read's bases in forward orientation
    ref_before = np.cumsum(consumes, dtype=np.int64)
    ref_before -= consumes
    ref_pos = ref_before + np.repeat(start - ref_before[op_off[:-1]],
                                     kept_len)
    emit = ops != DEL
    base = g.codes[np.minimum(ref_pos, g.total - 1)]
    sub = ops == SUB
    base[sub] = (base[sub] + rng.integers(1, 4, int(sub.sum()),
                                          dtype=np.uint8)) % 4
    ins = ops == INS
    base[ins] = rng.integers(0, 4, int(ins.sum()), dtype=np.uint8)
    codes = base[emit]
    code_off = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    if len(codes) != code_off[-1] or (codes > 3).any():
        raise RuntimeError("read generation produced a wrong base count or "
                           "an N")
    names = [f"j{job}s{stream}r{i}" for i in range(n)]
    return Job(names, lens, rev, start.astype(np.int64), span, n_err,
               codes, code_off, ops, op_off)


def true_path(ops: np.ndarray) -> np.ndarray:
    """(L + 1,) reference bases consumed before read base i of the
    forward-oriented read (deletions counted before the next base), the
    truth's path, row by row."""
    emit = ops != DEL
    ref = np.cumsum(ops != INS)            # consumed through each op
    ref_before = ref - (ops != INS)
    t = ref_before[emit]                   # before each read base
    return np.concatenate((t, [ref[-1] if len(ref) else 0])).astype(np.int64)
