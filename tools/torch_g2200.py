#!/usr/bin/env python3
"""A 2.19 Gbp genome laid out like GRCh38's chr1-chr13, its reads with
where each was drawn, and the port's full run on it on one card.

    python3 tools/torch_g2200.py [--div N] [--dir DIR]

The genome: 13 contigs, chr1 ... chr13, with the lengths of the GRCh38
primary assembly (GCA_000001405.15; the lengths are all that is taken
from it), uniform ACGT drawn from GENOME_SEED (a generator a BLOCK of a
contig, so any slice is drawn again without the rest), each contig
starting and ending with TELOMERE N.  l_pac = 2,191,407,310, so forward
coordinate 2**31 falls in chr13 (at its base 70,440,666) and the text
(forward + reverse complement, seq_len 4,382,814,620) passes 2**32.
The reads: 512 of 2-20 kb with bench._noise's errors, drawn from
READS_SEED in the groups of GROUPS and shuffled (g0 ... g511); their
truth (group, strand, and contig, start and length of each segment) is
written beside them (READS.truth.tsv).  No read covers an N: a
contig-edge read joins the last bases of one contig before its
telomere to the first of the next after its own.  ``--div N`` divides
every length, the telomeres and 2**31 / 2**32 by N: the tests' 1/1000
genome, or a short rehearsal of the run on the card.

The run (one card; at --div 1 ~40 min and ~78 GiB of host RAM at the
build's peak, see BUILD_BYTES_PER_CHAR):

1. MemAvailable against the build's estimated peak plus MARGIN_GIB;
   short of it, the run says how much the host has and exits 1;
2. the FASTA and the reads, then ``python -m lordfast_tpu_torch.cli
   --index`` in a process that sees no card: the builder's stages and
   the process's peak RSS (the card's kernels build meanwhile);
3. ``--search`` through the CLI on the card, then two engine passes in
   this process (cold and warm), whose records equal the CLI's;
4. the checks: the reads on their drawn origin (chip_smoke.origin_check;
   >= 95% of the reads that cross no contig edge and of each high
   group), the header's 13 @SQ lines and every POS within its contig, a
   plain_loops pass, 32 reads on the CPU, the 208 high reads through
   the CLI with --shardIndex under torchrun (NCCL, one rank), and the
   first calls of seed_ext, sa_locate, chain_dp and the four sharded
   kernels bit-equal to their plain versions on inputs shown to reach
   text positions >= 2**32 (chain_dp: forward coordinates >= 2**31);
5. the figures: the build's stages and peak RSS, the index's bytes on
   the card, the warm pass and its device timer, each kernel's ms at its
   first call beside its bound, the card's name and power limit.

Every check runs; any that fails makes the exit code 1.  Files go under
DIR (default .smoke_cache/g2200/, or g2200_div<N>/).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

# the GRCh38 primary assembly's chr1-chr13 (GCA_000001405.15)
GRCH38 = (("chr1", 248_956_422), ("chr2", 242_193_529),
          ("chr3", 198_295_559), ("chr4", 190_214_555),
          ("chr5", 181_538_259), ("chr6", 170_805_979),
          ("chr7", 159_345_973), ("chr8", 145_138_636),
          ("chr9", 138_394_717), ("chr10", 133_797_422),
          ("chr11", 135_086_622), ("chr12", 133_275_309),
          ("chr13", 114_364_328))
TELOMERE = 10_000  # N at each end of a contig, as GRCh38's telomeres
GENOME_SEED = 2200
READS_SEED = 2201
BLOCK = 1 << 20  # bases a seeded generator of a contig draws
MIN_LEN, MAX_LEN = 2000, 20000  # read lengths, as bench.gen_gbp_reads
# (group, reads): on the last contig past 2**31, both strands; spanning
# forward coordinate 2**31; forward strand in chr1 ending at or below
# Layout.upper_end (located at text positions >= 2**32); across the
# ends of two adjacent contigs; anywhere, as bench.gen_gbp_reads draws
GROUPS = (("fwd_high", 128), ("across", 16), ("upper", 64), ("edge", 16),
          ("uniform", 288))
HIGH_GROUPS = ("fwd_high", "across", "upper")
MIN_ORIGIN_FRAC = 0.95
# the build's host bytes a text char at its peak, the suffix sort: the
# int64 SA 8, the text, its +1 copy and SA-IS's type bytes 3, and the
# reduced problem's (~n/3 LMS suffixes of a random text) int64 copy and
# buckets ~6, and its recursion: 19.1 measured at seq_len 4,382,814,620
# (78.06 GiB, one H100's host); MARGIN_GIB above it for this process
BUILD_BYTES_PER_CHAR = 20
MARGIN_GIB = 6.0
BUILD_WAIT_S = 3000
# the reads held on the CPU against the card: (group, count)
CPU_READS = (("fwd_high", 16), ("upper", 8), ("edge", 8))
# the 1/1000 genome's reads that tests/test_torch_g2200.py maps on the
# CPU against the JAX package's digests (tools/torch_jax_sams.py
# --g2200), at DIGEST_CONFIG
DIGEST_DIV = 1000
DIGEST_READS = (("edge", 16), ("fwd_high", 8), ("across", 8), ("upper", 8),
                ("uniform", 8))
DIGEST_CONFIG = {"kmer_cache_k": 8}


@dataclass(frozen=True)
class Layout:
    """The genome's contigs at 1/div of GRCh38's lengths."""

    div: int
    names: tuple
    lengths: tuple
    telomere: int

    @property
    def offsets(self) -> tuple:
        return tuple(int(x) for x in np.cumsum((0,) + self.lengths[:-1]))

    @property
    def l_pac(self) -> int:
        return int(sum(self.lengths))

    @property
    def seq_len(self) -> int:
        return 2 * self.l_pac

    @property
    def high(self) -> int:
        """The forward coordinate 2**31 (at 1/div)."""
        return 2**31 // self.div

    @property
    def text_high(self) -> int:
        """The text position 2**32 (at 1/div)."""
        return 2**32 // self.div

    @property
    def upper_end(self) -> int:
        """A forward read ending at or below this forward coordinate is
        located at text positions >= text_high: the seeding searches the
        reverse complement of its anchors, at 2 l_pac - x - len for an
        anchor at x (chip_smoke.high_reads, with 2**32 for 2**31)."""
        return 2 * self.l_pac - self.text_high


def layout(div: int = 1) -> Layout:
    return Layout(div, tuple(n for n, _ in GRCH38),
                  tuple(ln // div for _, ln in GRCH38), TELOMERE // div)


def contig_codes(lay: Layout, i: int, lo: int, hi: int) -> np.ndarray:
    """Codes (0-3, 4 for N) of contig i's bases [lo, hi): block b of a
    contig is default_rng([GENOME_SEED, i, b])'s BLOCK draws."""
    out = np.empty(hi - lo, np.uint8)
    for b in range(lo // BLOCK, (hi - 1) // BLOCK + 1 if hi > lo else 0):
        blk = np.random.default_rng([GENOME_SEED, i, b]).integers(
            0, 4, BLOCK, dtype=np.uint8)
        s, e = max(lo, b * BLOCK), min(hi, (b + 1) * BLOCK)
        out[s - lo : e - lo] = blk[s - b * BLOCK : e - b * BLOCK]
    tel, ln = lay.telomere, lay.lengths[i]
    out[: max(0, min(tel, hi) - lo)] = 4
    out[max(0, ln - tel - lo):] = 4
    return out


ASCII = np.frombuffer(b"ACGTN", np.uint8)
COMP = str.maketrans("ACGT", "TGCA")


def write_fasta(lay: Layout, path: Path, width: int = 60):
    """The genome as FASTA, lines of ``width`` bases; written under
    another name and renamed."""
    tmp = path.with_name(path.name + ".part")
    with open(tmp, "wb") as f:
        for i, name in enumerate(lay.names):
            f.write(f">{name}\n".encode())
            a = ASCII[contig_codes(lay, i, 0, lay.lengths[i])]
            full = len(a) // width * width
            lines = np.full((full // width, width + 1), ord("\n"), np.uint8)
            lines[:, :width] = a[:full].reshape(-1, width)
            f.write(lines.tobytes())
            if full < len(a):
                f.write(a[full:].tobytes() + b"\n")
    os.replace(tmp, path)


class Read(NamedTuple):
    name: str
    group: str
    rev: bool
    segs: tuple  # ((contig index, contig-relative start, length), ...)


def draw_truth(lay: Layout, seed: int = READS_SEED) -> list:
    """The reads' truth, drawn from ``seed`` group by group (GROUPS: a
    length, a strand, then where) and shuffled; g<j> is the j-th after
    the shuffle."""
    rng = np.random.default_rng(seed)
    tel, last = lay.telomere, len(lay.names) - 1
    offs, lens = lay.offsets, lay.lengths
    h = lay.high - offs[last]  # 2**31's base in the last contig
    drawn = []
    for group, n in GROUPS:
        for _ in range(n):
            ln = int(rng.integers(MIN_LEN, MAX_LEN))
            rev = bool(rng.random() < 0.5)
            if group == "fwd_high":
                st = int(rng.integers(max(h, tel), lens[last] - tel - ln + 1))
                segs = ((last, st, ln),)
            elif group == "across":  # st <= h - 1 and st + ln >= h + 1
                segs = ((last, int(rng.integers(h - ln + 1, h)), ln),)
            elif group == "upper":
                rev = False
                segs = ((0, int(rng.integers(tel, lay.upper_end - ln + 1)),
                         ln),)
            elif group == "edge":
                i = int(rng.integers(0, last))
                a = int(rng.integers(ln // 4, 3 * ln // 4 + 1))
                segs = ((i, lens[i] - tel - a, a), (i + 1, tel, ln - a))
            else:
                while True:
                    x = int(rng.integers(0, lay.l_pac - ln))
                    i = bisect.bisect_right(offs, x) - 1
                    st = x - offs[i]
                    if tel <= st and st + ln <= lens[i] - tel:
                        break
                segs = ((i, st, ln),)
            drawn.append((group, rev, segs))
    order = rng.permutation(len(drawn))
    return [Read(f"g{j}", *drawn[k]) for j, k in enumerate(order)]


def pick(truth, counts) -> list:
    """The first reads of each group, as many as counts ((group, n), ...)
    says, in file order."""
    want = dict(counts)
    out = []
    for r in truth:
        if want.get(r.group, 0) > 0:
            want[r.group] -= 1
            out.append(r)
    return out


def read_codes(lay: Layout, read: Read) -> np.ndarray:
    """The genome's codes under the read's segments, joined (forward)."""
    return np.concatenate([contig_codes(lay, c, s, s + n)
                           for c, s, n in read.segs])


def write_reads(lay: Layout, path: Path, truth=None) -> list:
    """The reads as FASTQ, each its fragment (reverse-complemented on the
    reverse strand) with bench._noise's errors from
    default_rng([READS_SEED, j]) for g<j>, and their truth beside them
    (truth_path); returns the truth."""
    sys.path.insert(0, str(ROOT))
    import bench

    truth = truth or draw_truth(lay)
    with open(path, "w") as f:
        for r in truth:
            frag = ASCII[read_codes(lay, r)].tobytes().decode()
            if r.rev:
                frag = frag.translate(COMP)[::-1]
            seq = bench._noise(np.random.default_rng(
                [READS_SEED, int(r.name[1:])]), frag)
            f.write(f"@{r.name}\n{seq}\n+\n{'I' * len(seq)}\n")
    with open(truth_path(path), "w") as f:
        f.write("#name\tgroup\tstrand\tsegments (contig:start:length, "
                "0-based, contig-relative)\n")
        for r in truth:
            segs = ",".join(f"{lay.names[c]}:{s}:{n}" for c, s, n in r.segs)
            f.write(f"{r.name}\t{r.group}\t{'-+'[not r.rev]}\t{segs}\n")
    return truth


def truth_path(reads: Path) -> Path:
    return reads.with_name(reads.name + ".truth.tsv")


def read_truth(lay: Layout, path: Path) -> list:
    """The truth file that write_reads wrote beside ``path``."""
    out = []
    for line in truth_path(path).read_text().splitlines()[1:]:
        name, group, strand, segs = line.split("\t")
        out.append(Read(name, group, strand == "-", tuple(
            (lay.names.index(c), int(s), int(n))
            for c, s, n in (x.split(":") for x in segs.split(",")))))
    return out


def origins(lay: Layout, truth) -> list:
    """(forward start, length, reverse) of each read's first segment, by
    read index: chip_smoke.origin_check's origins."""
    offs = lay.offsets
    return [(offs[r.segs[0][0]] + r.segs[0][1], r.segs[0][2], r.rev)
            for r in truth]


def gather_starts(lay: Layout, T: int) -> list:
    """Gap descriptors' target starts for the gather checks: just below,
    at and past the forward coordinate 2**31, across the edge of the
    last two contigs, and at the genome's end (reading past it)."""
    h, e, n = lay.high, lay.offsets[-1], lay.l_pac
    return sorted({h - T - 7, h - 17, h - 1, h, h + 1, h + 15, h + 16,
                   h + 4097, e - T // 2, e - 1, e, e + 31,
                   (h + n) // 2, n - T - 1, n - T // 2, n - 17, n - 1, n})


def gather_descs(lay: Layout, rng, Q: int, T: int) -> dict:
    """A gap descriptor table (numpy; gap_dp.gather_gap_seqs' fields and
    is_shw) over gather_starts(lay, T), each start in both target
    orientations, with random target and query lengths (the first four
    at T and 1, and Q), random query orientations and starts, and one
    read row a descriptor (q_read)."""
    starts = gather_starts(lay, T)
    G = 2 * len(starts)
    t_len = rng.integers(1, T + 1, G)
    t_len[:4] = (T, T, 1, 1)
    q_len = rng.integers(1, Q + 1, G)
    q_len[:4] = Q
    return {"q_read": np.arange(G, dtype=np.int64),
            "q_start": rng.integers(0, 8, G).astype(np.int64),
            "q_len": q_len.astype(np.int64),
            "q_rc": rng.random(G) < 0.5,
            "t_start": np.repeat(np.asarray(starts, np.int64), 2),
            "t_len": t_len.astype(np.int64),
            "t_rc": np.tile([False, True], len(starts)),
            "valid": np.ones(G, bool),
            "is_shw": rng.random(G) < 0.5}


def gather_rows(desc: dict, T: int) -> np.ndarray:
    """The packed words (16 codes each) a gather of desc reads: each
    descriptor's T // 16 + 1 words from its start's."""
    base = np.maximum(desc["t_start"], 0) >> 4
    return np.unique(base[:, None] + np.arange(T // 16 + 1))


def decode_gather(words_at, reads: np.ndarray, desc: dict, Q: int, T: int,
                  l_pac: int):
    """(qs, ql, ts, tl) of desc, decoded with numpy: query codes from the
    read rows (4 outside the slice, complemented below 4 where q_rc),
    target codes of forward positions below l_pac from the packed words
    (words_at: word indices -> their values; code p at bits 2 (15 - p %
    16) of word p // 16), 0 past the genome, complemented where t_rc,
    and 0 from tl on."""
    ql = np.maximum(np.where(desc["valid"], desc["q_len"], 1), 1)
    tl = np.maximum(np.where(desc["valid"], desc["t_len"], 1), 1)
    jq = np.arange(Q)[None, :]
    q_rc = desc["q_rc"][:, None]
    q0 = desc["q_start"][:, None]
    qpos = np.where(q_rc, q0 + ql[:, None] - 1 - jq, q0 + jq)
    q_ok = (jq < ql[:, None]) & (qpos >= 0) & (qpos < reads.shape[1])
    qg = reads[desc["q_read"][:, None], np.clip(qpos, 0, reads.shape[1] - 1)]
    qg = np.where(q_rc & (qg < 4), 3 - qg, qg)
    qs = np.where(q_ok, qg, 4).astype(np.uint8)
    jt = np.arange(T)[None, :]
    t0, t_rc = desc["t_start"][:, None], desc["t_rc"][:, None]
    tpos = np.where(t_rc, t0 + tl[:, None] - 1 - jt, t0 + jt)
    inside = (tpos >= 0) & (tpos < l_pac)
    w = words_at(np.where(inside, tpos >> 4, 0)).astype(np.int64)
    code = np.where(inside, (w >> (2 * (15 - (tpos & 15)))) & 3, 0)
    code = np.where(t_rc, 3 - code, code)
    ts = np.where(jt < tl[:, None], code, 0).astype(np.uint8)
    return qs, ql.astype(np.int32), ts, tl.astype(np.int32)


def vote_bases(lay: Layout) -> tuple:
    """Where the voting checks' reads put their seeds (make_seeds' spread
    reaches ~190 kb past a base): across forward coordinate 2**31, past
    it, across the edge of the last two contigs and at the genome's
    end."""
    h, e, n = lay.high, lay.offsets[-1], lay.l_pac
    return (h - 90_000, h + 5, h + 20_000_000, e - 90_000, n - 200_000)


# ---------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------

RSS_WRAPPER = (
    "import resource, subprocess, sys\n"
    "rc = subprocess.call(sys.argv[1:])\n"
    "print('[rss] peak_kib', resource.getrusage("
    "resource.RUSAGE_CHILDREN).ru_maxrss, file=sys.stderr, flush=True)\n"
    "sys.exit(rc)\n")


def start_measured(cmd, log_path: Path, env=None):
    """cmd in a process of its own, through a wrapper that prints the
    peak RSS of its children (the command's process and those it
    waited for); output to log_path."""
    f = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-c", RSS_WRAPPER,
                             *map(str, cmd)], cwd=ROOT, env=env, stdout=f,
                            stderr=subprocess.STDOUT)
    return proc, time.time(), log_path, f


def finish_measured(started, timeout) -> dict:
    """Waits for start_measured's process: {rc, seconds, peak_rss_gib,
    log}; raises on a non-zero exit code."""
    proc, t0, log_path, f = started
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        f.close()
    text = log_path.read_text()
    peak = [int(x.split()[-1]) for x in text.splitlines()
            if x.startswith("[rss] peak_kib")]
    if rc != 0:
        raise AssertionError(f"{' '.join(map(str, proc.args[3:]))} exited "
                             f"{rc}: {text[-3000:]}")
    return {"rc": rc, "seconds": time.time() - t0,
            "peak_rss_gib": peak[-1] / 2**20 if peak else None, "log": text}


def build_stages(text: str) -> dict:
    """{stage: seconds} from the builder's "[index] ..." lines."""
    import re

    out = {}
    for line in text.splitlines():
        m = re.match(r"\[index\] (.*?) in ([\d.]+)s$", line) or re.match(
            r"\[index\] (total) ([\d.]+)s$", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sq_check(lay: Layout, sam: str) -> int:
    """The header has one @SQ line a contig, with its name and length,
    in order, and every record's POS is contig-relative: >= 1, and its
    aligned span ends within its contig.  Returns the records checked."""
    import chip_smoke as S

    sq = [ln.split("\t") for ln in sam.splitlines() if ln.startswith("@SQ")]
    want = [[f"SN:{n}", f"LN:{ln}"] for n, ln in zip(lay.names,
                                                     lay.lengths)]
    if [x[1:3] for x in sq] != want:
        raise AssertionError(f"@SQ lines {[x[1:3] for x in sq]} != {want}")
    lens = dict(zip(lay.names, lay.lengths))
    n = 0
    for rec in S.sam_records(sam):
        f = rec.split("\t")
        if int(f[1]) & 4:
            continue
        pos, end = int(f[3]), int(f[3]) + S._ref_span(f[5]) - 1
        if f[2] not in lens or pos < 1 or end > lens[f[2]]:
            raise AssertionError(f"{f[0]}: {f[2]}:{pos}-{end} is not within "
                                 f"its contig ({lens.get(f[2])})")
        n += 1
    return n


def origin_counts(lay: Layout, truth, sam: str) -> dict:
    """chip_smoke.origin_check over the reads that cross no contig edge:
    {group: (on origin, reads)} and "all" over those reads; fails below
    MIN_ORIGIN_FRAC of them or of any high group."""
    import chip_smoke as S

    ok = S.origin_check(sam, origins(lay, truth), dict(zip(lay.names,
                                                            lay.offsets)))
    counts = {}
    for i, r in enumerate(truth):
        if r.group == "edge":
            continue
        for key in (r.group, "all"):
            a, b = counts.get(key, (0, 0))
            counts[key] = (a + ok[i], b + 1)
    low = {k: v for k, v in counts.items()
           if (k == "all" or k in HIGH_GROUPS)
           and v[0] < MIN_ORIGIN_FRAC * v[1]}
    if low:
        off = [r.name for i, r in enumerate(truth)
               if r.group != "edge" and not ok[i]]
        raise AssertionError(f"on origin below {MIN_ORIGIN_FRAC}: {low} "
                             f"(all: {counts}); off: {off[:20]}")
    return counts


def build_peak_gib(lay: Layout) -> float:
    return BUILD_BYTES_PER_CHAR * lay.seq_len / 2**30


class Run:
    """The run's state: its log lines, figures and failed checks."""

    def __init__(self, lay, d):
        self.lay, self.d = lay, d
        self.fig = {"l_pac": lay.l_pac, "seq_len": lay.seq_len,
                    "div": lay.div}
        self.failed = []

    def check(self, name, fn, *a, **kw):
        """fn(*a, **kw); a failure is logged and kept, and the run goes
        on."""
        import chip_smoke as S

        t = time.time()
        try:
            out = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 - every check is reported
            S.log(f"[g2200] FAILED {name} ({time.time() - t:.1f} s): "
                  f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
            self.failed.append(f"{name}: {type(e).__name__}: "
                               f"{str(e)[:300]}")
            return None
        S.log(f"[g2200] passed {name} ({time.time() - t:.1f} s)")
        return out


def run(lay: Layout, d: Path) -> int:
    import torch

    import chip_smoke as S
    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import index_path_for, load_index
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    t0 = time.time()
    R = Run(lay, d)
    fig = R.fig
    card = S.nvidia_smi_line()
    fig["card"] = card
    S.log(f"[g2200] layout: {len(lay.names)} contigs, l_pac {lay.l_pac}, "
          f"seq_len {lay.seq_len} (1/{lay.div} of GRCh38's chr1-chr13); "
          f"forward coordinate {lay.high} at {lay.names[-1]}:"
          f"{lay.high - lay.offsets[-1]}; upper-text reads end at or below "
          f"{lay.upper_end}; card {card}")

    avail = S.mem_available_gib()
    need = build_peak_gib(lay) + MARGIN_GIB
    fig["mem_available_gib"] = avail
    if avail < need:
        S.log(f"[g2200] the host has {avail:.1f} GiB available "
              f"(MemAvailable); the build needs an estimated "
              f"{build_peak_gib(lay):.1f} GiB at its peak "
              f"({BUILD_BYTES_PER_CHAR} bytes a text char) plus "
              f"{MARGIN_GIB} GiB: not run")
        return 1
    S.log(f"[g2200] MemAvailable {avail:.1f} GiB; the build's estimated "
          f"peak {build_peak_gib(lay):.1f} GiB + {MARGIN_GIB} GiB")

    d.mkdir(parents=True, exist_ok=True)
    ref, reads = d / "G.fa", d / "reads.fq"
    npz = index_path_for(ref)
    t = time.time()
    for p in d.glob("G.fa*"):  # a run starts from nothing
        if p.is_dir():
            shutil.rmtree(p)
        else:
            p.unlink()
    write_fasta(lay, ref)
    t_fa = time.time() - t
    truth = write_reads(lay, reads)
    S.log(f"[g2200] FASTA ({ref.stat().st_size} bytes) in {t_fa:.1f} s, "
          f"{len(truth)} reads and their truth in "
          f"{time.time() - t - t_fa:.1f} s")

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    build = start_measured([sys.executable, "-m", "lordfast_tpu_torch.cli",
                            "--index", ref], d / "build.log", env)
    int_rate = S.phase_env()  # the card's kernels build meanwhile
    b = finish_measured(build, BUILD_WAIT_S)
    stages = build_stages(b["log"])
    fig["build"] = {"stages_s": stages, "wall_s": b["seconds"],
                    "save_s": b["seconds"] - stages.get("total", 0.0),
                    "peak_rss_gib": b["peak_rss_gib"]}
    for line in b["log"].splitlines():
        S.log(f"[g2200] build: {line}")
    S.log(f"[g2200] index built through the CLI in {b['seconds']:.1f} s "
          f"(stages {stages}), the build process's peak RSS "
          f"{b['peak_rss_gib']:.2f} GiB; MemAvailable now "
          f"{S.mem_available_gib():.1f} GiB")

    cli_sam = d / "cli.sam"
    c = finish_measured(start_measured(
        [sys.executable, "-m", "lordfast_tpu_torch.cli", "--search", ref,
         "--seq", reads, "-o", cli_sam], d / "cli.log"), 1800)
    fig["cli"] = {"wall_s": c["seconds"], "peak_rss_gib": c["peak_rss_gib"]}
    S.log(f"[g2200] --search through the CLI on the card in "
          f"{c['seconds']:.1f} s (index load and layout included), its "
          f"peak RSS {c['peak_rss_gib']:.2f} GiB: "
          + " | ".join(x for x in c["log"].splitlines()
                       if x.startswith("[NOTE]")))
    sam_cli = cli_sam.read_text()
    recs = S.sam_records(sam_cli)

    t = time.time()
    idx = S.keep_layout(load_index(npz))
    S.log(f"[g2200] index loaded and laid out in {time.time() - t:.1f} s "
          f"(sa_intv {idx.sa_intv}, pos {idx.pos_dtype.__name__}, "
          f"{len(idx.contig_names)} contigs)")
    big = lay.div == 1
    if big and (idx.pos_dtype is not np.int64 or idx.sa_intv != 32
                or idx.l_pac != lay.l_pac):
        raise AssertionError(f"l_pac {idx.l_pac}, pos {idx.pos_dtype}, "
                             f"sa_intv {idx.sa_intv}")
    cfg = LordfastConfig(verbosity=2)
    torch.cuda.reset_peak_memory_stats()
    eng = MappingEngine(idx, cfg, device="cuda")
    nbytes = sum(x.numel() * x.element_size() for x in eng.arrs.values())
    fig["index_bytes_on_card"] = nbytes
    caps = S.record_loops(1)
    sampled = idx.sa_intv > 1
    passes = []
    for label in ("cold", "warm"):
        passes.append(S.map_pass(eng, reads, caps if not passes else None))
        S._report("g2200", f"{label} pass", eng, passes[-1])
        R.check(f"{label} pass launches", S.check_launches, "g2200",
                passes[-1][4], eng.metrics.counters,
                ("myers_dist", "chain_dp", "seed_ext")
                + (("sa_locate",) if sampled else ()), sampled=sampled)
    sam = passes[0][0]
    fig.update(cold_s=passes[0][1], warm_s=passes[1][1],
               device_s=eng.metrics.timers["device"],
               mapped=passes[0][3], reads=passes[0][2],
               peak_card_mib=torch.cuda.max_memory_allocated() / 2**20)
    S.log(f"[g2200] {nbytes} bytes of index arrays on the card; cold pass "
          f"{fig['cold_s']:.3f} s, warm {fig['warm_s']:.3f} s (device "
          f"{fig['device_s']:.3f} s); {fig['mapped']} of {fig['reads']} "
          f"mapped; peak device memory {fig['peak_card_mib']:.0f} MiB")

    def same_as_cli():
        if passes[1][0] != sam:
            raise AssertionError("the cold and warm passes differ")
        if S.sam_records(sam) != recs:
            raise AssertionError("the engine's records differ from the "
                                 "CLI's")
        return len(recs)

    R.check("engine passes == CLI", same_as_cli)
    fig["records_in_bounds"] = R.check("header and POS", sq_check, lay,
                                       sam_cli)
    fig["on_origin"] = R.check("on origin", origin_counts, lay, truth,
                               sam_cli)
    S.log(f"[g2200] on origin (reads, on origin): {fig['on_origin']}")
    plain = R.check("plain loops", S.plain_pass, "g2200",
                    MappingEngine(idx, cfg, device="cuda", plain_loops=True),
                    reads, sam, passes[1][1])
    if plain:
        fig["plain_warm_s"] = plain[1]

    if big:
        ns = S.chase_ns(S.rank_bytes(eng.arrs))
        figs = R.check("kernels == plain (int64)", S.check_int64_loops, idx,
                       caps, int_rate, ns, tag="g2200",
                       floor=lay.text_high, chain_floor=lay.high)
    else:
        S.log(f"[g2200] at 1/{lay.div} the index takes "
              f"{idx.pos_dtype.__name__} positions: its loops are held to "
              "their plain versions by the smoke, not here")
        figs = None
    if figs:
        fig["kernels"] = {k: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                              "bound_ms": v["bound"][0],
                              "bound_by": v["bound"][1]}
                          for k, v in figs.items()}
        fig["kernels"]["sa_locate"]["floor_ms"] = figs["sa_locate"][
            "floor_ms"]

    keep = {r.name for r in pick(truth, CPU_READS)}
    R.check("32 reads cpu == cuda", S._cpu_subset, idx, sam, reads,
            d / "cpu32.fq", lambda name, i: name in keep, "g2200")
    if idx._device:
        idx._device.pop("cpu", None)  # the CPU copy of the arrays

    high = [i for i, r in enumerate(truth) if r.group in HIGH_GROUPS]
    high_names = {truth[i].name for i in high}
    high_fq = d / "high.fq"
    S._subset(reads, high_fq, lambda name, i: name in high_names)
    high_recs = [x for x in recs if x.split("\t")[0] in high_names]

    def shard_cli():
        out = d / "shard_cli.sam"
        m = finish_measured(start_measured(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", "1", "--master_port", free_port(), "-m",
             "lordfast_tpu_torch.cli", "--search", ref, "--seq", high_fq,
             "-o", out, "--shardIndex"], d / "shard_cli.log",
            {**os.environ, "PYTHONPATH": str(ROOT)}), 1800)
        fig["shard_cli"] = {"wall_s": m["seconds"],
                            "rank0_peak_rss_gib": m["peak_rss_gib"]}
        S.log(f"[g2200] {len(high)} high reads through the CLI with "
              f"--shardIndex under torchrun (NCCL, one rank) in "
              f"{m['seconds']:.1f} s (the sidecar written and mapped); "
              f"rank 0's peak RSS {m['peak_rss_gib']:.2f} GiB: "
              + " | ".join(x for x in m["log"].splitlines()
                           if x.startswith("[NOTE]")))
        got = S.sam_records(out.read_text())
        if got != high_recs:
            raise AssertionError(f"the sharded SAM ({len(got)} records) "
                                 f"differs from the replicated records "
                                 f"({len(high_recs)})")

    R.check("sharded CLI == replicated", shard_cli)
    g = dict(sam=sam, reads=reads, index=npz, idx=idx, high=high)
    shard = R.check("sharded in-process, kernels == plain",
                    S.phase_gbp_mesh, g, "g2200",
                    lay.text_high if big else None)
    if shard:
        fig["shard_kernels"] = {
            k: {x: v[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")
                if x in v}
            for k, v in shard[1].get("g2200_high_shard_nccl1", {}).items()}
    fig["wall_s"] = time.time() - t0
    fig["failed"] = R.failed
    S.log(f"[g2200] figures ({card}): {json.dumps(fig)}")
    (d / "figures.json").write_text(json.dumps(fig, indent=1) + "\n")
    if R.failed:
        S.log(f"[g2200] {len(R.failed)} checks failed: {R.failed}")
        return 1
    S.log(f"[g2200] every check passed in {time.time() - t0:.1f} s")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--div", type=int, default=1,
                    help="divide every length by this (1: the full genome)")
    ap.add_argument("--dir", type=Path, default=None,
                    help="where the files go (default .smoke_cache/g2200/)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[g2200] torch.cuda.is_available() is False: this run needs "
              "a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    d = args.dir or ROOT / ".smoke_cache" / (
        "g2200" if args.div == 1 else f"g2200_div{args.div}")
    return run(layout(args.div), d)


if __name__ == "__main__":
    sys.exit(main())
