"""A genome laid out like a stated assembly, made from a seed.

Contigs take the lengths the configuration names, with ``telomere_n`` N
bases at each end.  Between the telomeres the background is uniform
bases, and repeat copies are laid into it without overlap, each family
at its stated share of the core's bases:

- ``interspersed``: copies of one random consensus per family, the
  3' end of it when ``length`` truncates them, each copy with its own
  substitution divergence and orientation (Alu-like, L1-like);
- ``duplication``: segments copied from elsewhere in the genome, after
  the interspersed copies are in place, with their own divergence and
  orientation (segmental duplications).

Everything is numpy over whole arrays; nothing here imports the program.
Codes are 0..3 for A, C, G, T and 4 for N.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

CHUNK_BASES = 1 << 24  # bases of copies laid in one vectorised step


@dataclass
class Genome:
    names: list
    lengths: np.ndarray       # (n,) int64
    offsets: np.ndarray       # (n,) int64, forward coordinate of base 0
    codes: np.ndarray         # (sum(lengths),) uint8, 0..3 and N = 4
    cores: np.ndarray         # (n, 2) int64 [start, end) without telomeres
    # family -> (starts, lengths) of its copies, forward coordinates
    placements: dict = field(default_factory=dict)
    # duplication family -> the starts its copies were copied from
    sources: dict = field(default_factory=dict)

    @property
    def total(self) -> int:
        return int(self.lengths.sum())


def _copy_lengths(rng, law: dict, cons_len: int, target: int) -> np.ndarray:
    """Lengths of one family's copies in one core, summing to target."""
    kind = law["law"]
    if target <= 0:
        return np.zeros(0, np.int64)
    if kind == "full":
        mean = cons_len
    elif kind == "truncated_exp":
        mean = law["mean"]
    elif kind == "loguniform":
        lo, hi = np.log(law["min"]), np.log(law["max"])
        mean = (law["max"] - law["min"]) / (hi - lo)
    else:
        raise ValueError(f"unknown length law {kind!r}")
    n = int(target / mean * 1.3) + 16
    while True:
        if kind == "full":
            ln = np.full(n, cons_len, np.int64)
        elif kind == "truncated_exp":
            ln = law["min"] + rng.exponential(law["mean"] - law["min"], n)
            ln = np.minimum(ln, cons_len).astype(np.int64)
        else:
            ln = np.exp(rng.uniform(lo, hi, n)).astype(np.int64)
        c = np.cumsum(ln)
        if c[-1] >= target:
            break
        n *= 2
    k = int(np.searchsorted(c, target))  # copies [0, k] reach target
    ln = ln[: k + 1].copy()
    ln[-1] -= int(c[k] - target)          # the last copy is cut to fit
    return ln[ln > 0]


def _lay(codes, rng, dest, lengths, rev, div, src_of):
    """Write copies: copy j of length lengths[j] to dest[j]; src_of(base
    index array, copy ids, offsets within copy) gives its source bases
    in forward orientation; then per-base substitutions at div[j] and,
    for rev[j], reverse complement.  Chunked by CHUNK_BASES."""
    n = len(lengths)
    j0 = 0
    while j0 < n:
        c = np.cumsum(lengths[j0:])
        j1 = j0 + max(1, int(np.searchsorted(c, CHUNK_BASES)))
        ln = lengths[j0:j1]
        tot = int(ln.sum())
        ids = np.repeat(np.arange(j0, j1), ln)
        first = np.repeat(np.cumsum(ln) - ln, ln)
        within = np.arange(tot, dtype=np.int64) - first
        bases = src_of(ids, within).astype(np.uint8)
        mut = rng.random(tot) < div[ids]
        bases[mut] = (bases[mut] + rng.integers(1, 4, int(mut.sum()),
                                                dtype=np.uint8)) % 4
        r = rev[ids]
        bases[r] = 3 - bases[r]
        pos = np.where(r, lengths[ids] - 1 - within, within)
        codes[dest[ids] + pos] = bases
        j0 = j1


def make_genome(spec: dict) -> Genome:
    """The genome of a configuration's ``genome`` block (see
    configs/*.json): contigs, telomere_n, seed, repeats."""
    rng = np.random.default_rng(spec["seed"])
    names = [c[0] for c in spec["contigs"]]
    lengths = np.array([c[1] for c in spec["contigs"]], np.int64)
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    tel = int(spec["telomere_n"])
    if (lengths <= 2 * tel).any():
        raise ValueError("a contig is shorter than its two telomeres")
    codes = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
    cores = np.stack([offsets + tel, offsets + lengths - tel], axis=1)
    for (s, e), off, ln in zip(cores, offsets, lengths):
        codes[off:s] = 4
        codes[e:off + ln] = 4

    fams = spec.get("repeats", [])
    cons = {f["family"]: rng.integers(0, 4, f["consensus_len"], np.uint8)
            for f in fams if f["kind"] == "interspersed"}
    # per core: every family's copies, shuffled, with background between
    per = {f["family"]: [] for f in fams}   # family -> [(dest, len)]
    for s, e in cores:
        core = int(e - s)
        fam_ids, lens = [], []
        for k, f in enumerate(fams):
            ln = _copy_lengths(rng, f["length"], f.get("consensus_len", 0),
                               int(round(f["share"] * core)))
            fam_ids.append(np.full(len(ln), k, np.int64))
            lens.append(ln)
        fam_ids = np.concatenate(fam_ids)
        lens = np.concatenate(lens)
        order = rng.permutation(len(lens))
        fam_ids, lens = fam_ids[order], lens[order]
        bg = core - int(lens.sum())
        if bg < 0:
            raise ValueError("repeat shares sum above 1")
        cuts = np.sort(rng.integers(0, bg + 1, len(lens)))
        gaps = np.diff(np.concatenate(([0], cuts)))
        dest = s + np.cumsum(gaps) + np.cumsum(lens) - lens
        for k, f in enumerate(fams):
            m = fam_ids == k
            per[f["family"]].append((dest[m], lens[m]))

    placements, sources = {}, {}
    for f in fams:
        dest = np.concatenate([d for d, _ in per[f["family"]]])
        ln = np.concatenate([l for _, l in per[f["family"]]])
        placements[f["family"]] = (dest, ln)
    # interspersed families first, then duplications of the result
    for kind in ("interspersed", "duplication"):
        for f in fams:
            if f["kind"] != kind:
                continue
            dest, ln = placements[f["family"]]
            n = len(ln)
            lo, hi = f["divergence"]
            div = rng.uniform(lo, hi, n)
            rev = rng.random(n) < 0.5
            if kind == "interspersed":
                c = cons[f["family"]]
                start = len(c) - ln          # the 3' end of the consensus

                def src_of(ids, within, c=c, start=start):
                    return c[start[ids] + within]
            else:
                src = _draw_sources(rng, cores, ln)
                sources[f["family"]] = src

                def src_of(ids, within, src=src):
                    return codes[src[ids] + within]
            _lay(codes, rng, dest, ln, rev, div, src_of)
    return Genome(names, lengths, offsets, codes, cores, placements,
                  sources)


def _draw_sources(rng, cores, lengths) -> np.ndarray:
    """A start for each segment, uniform over the places in the cores
    where a segment of its length fits whole."""
    clen = (cores[:, 1] - cores[:, 0])[None, :]
    w = np.maximum(clen - lengths[:, None], 0).astype(np.float64)
    cw = np.cumsum(w, axis=1)
    u = rng.random(len(lengths)) * cw[:, -1]
    k = (cw <= u[:, None]).sum(axis=1)
    before = np.where(k > 0, cw[np.arange(len(k)), np.maximum(k - 1, 0)], 0)
    return (cores[k, 0] + (u - before).astype(np.int64)).astype(np.int64)


def duplicated(g: Genome, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """For each forward span [lo, hi): whether it touches a copy of a
    duplication family or the segment it was copied from, the places
    where another place of the genome is near-identical."""
    starts, ends = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for fam, src in g.sources.items():
        dest, ln = g.placements[fam]
        starts += [dest, src]
        ends += [dest + ln, src + ln]
    s, e = np.concatenate(starts), np.concatenate(ends)
    out = np.zeros(len(lo), bool)
    for k in range(len(lo)):
        out[k] = bool(((s < hi[k]) & (e > lo[k])).any())
    return out


def repeat_shares(g: Genome) -> dict:
    """family -> share of the cores' bases its copies cover."""
    core = float((g.cores[:, 1] - g.cores[:, 0]).sum())
    return {f: float(ln.sum()) / core for f, (_, ln) in g.placements.items()}


_ASCII = np.frombuffer(b"ACGTN", np.uint8)


def write_fasta(g: Genome, path, width: int = 80) -> None:
    """The genome as FASTA, ``width`` bases a line."""
    with open(path, "wb") as f:
        for name, off, ln in zip(g.names, g.offsets, g.lengths):
            f.write(f">{name}\n".encode())
            seq = _ASCII[g.codes[off:off + ln]]
            full = (len(seq) // width) * width
            if full:
                body = np.empty((full // width, width + 1), np.uint8)
                body[:, :width] = seq[:full].reshape(-1, width)
                body[:, width] = 10
                f.write(body.tobytes())
            if full < len(seq):
                f.write(seq[full:].tobytes() + b"\n")
