"""The plain reference on the CPU: the band DP against a full DP, the
record checks against altered records, and the judge end to end over a
tiny genome and its reads, with the truth in the program's place."""

import dataclasses

import numpy as np
import pytest
from conftest import TINY_CONFIG, TINY_TRAFFIC

from harness import control, reference
from harness.genome import duplicated, make_genome
from harness.reads import make_job


@pytest.fixture(scope="module")
def genome():
    return make_genome(TINY_CONFIG["genome"])


@pytest.fixture(scope="module")
def job(genome):
    return make_job(genome, {**TINY_TRAFFIC, "job_reads": 6,
                             "length": {"median": 1500, "sigma": 0.3,
                                        "min": 1000, "max": 3000}}, 9, 0)


def full_semiglobal(q, t) -> int:
    """The least edit distance of all of q against any part of t: a plain
    dynamic programme, row by row."""
    prev = np.zeros(len(t) + 1, np.int64)
    for i in range(1, len(q) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        diag = prev[:-1] + (t != q[i - 1])
        up = prev[1:] + 1
        best = np.minimum(diag, up)
        for j in range(1, len(t) + 1):
            cur[j] = min(best[j - 1], cur[j - 1] + 1)
        prev = cur
    return int(prev.min())


def test_band_dp_matches_a_full_dp(genome, job):
    reads = [(job.read_codes(i), int(job.start[i]), job.read_ops(i))
             for i in range(2)]
    got = reference.best_costs(genome.codes, reads, "cpu")
    for k, (codes, start, ops) in enumerate(reads):
        lo = start - reference.BAND
        t = genome.codes[lo:start + int(job.span[k]) + reference.BAND]
        assert got[k] == full_semiglobal(codes, t)
        assert got[k] <= job.n_err[k]


def _truth_records(job, genome, tmp_path):
    sam = tmp_path / "truth.sam"
    control.write_truth_sam(job, genome, sam)
    return sam, [ln.rstrip("\n").encode().split(b"\t")
                 for ln in sam.read_text().splitlines()]


def _contig(genome):
    return {n: (int(o), int(ln)) for n, o, ln in
            zip(genome.names, genome.offsets, genome.lengths)}


def _seq(job, i):
    c = job.read_codes(i)
    return (3 - c[::-1]) if job.rev[i] else c


def test_truth_records_pass_the_record_checks(genome, job, tmp_path):
    _, recs = _truth_records(job, genome, tmp_path)
    for i, f in enumerate(recs):
        why, edits, (lo, hi) = reference.judge_record(
            f, _seq(job, i), genome.codes, _contig(genome))
        assert why is None, why
        assert edits == job.n_err[i] and (lo, hi) == (0, job.lens[i])


@pytest.mark.parametrize("alter", ["pos", "nm", "seq", "cigar", "contig"])
def test_altered_records_are_bad(genome, job, tmp_path, alter):
    _, recs = _truth_records(job, genome, tmp_path)
    f = list(recs[0])
    if alter == "pos":
        f[3] = str(int(f[3]) + 1).encode()
    elif alter == "nm":
        f[11] = f"NM:i:{job.n_err[0] + 3}".encode()
    elif alter == "seq":
        s = bytearray(f[9])
        s[10] = ord("A") if s[10] != ord("A") else ord("C")
        f[9] = bytes(s)
    elif alter == "cigar":
        f[5] = b"5I" + f[5]
    else:
        f[2] = b"chrZ"
    why, _, _ = reference.judge_record(f, _seq(job, 0), genome.codes,
                                       _contig(genome))
    assert why is not None


def test_judge_prices_the_truth_above_the_best(genome, job, tmp_path):
    sam, _ = _truth_records(job, genome, tmp_path)
    sample = [(0, i) for i in range(len(job.lens))]
    got = reference.judge([job], [sam], sample, genome, "cpu")
    assert got["bad_records"] == 0
    assert (got["price"] == job.n_err).all()
    assert (got["best"] <= got["price"]).all()
    assert got["excess"].sum() > 0


def test_judge_prices_a_missing_read_whole(genome, job, tmp_path):
    sam, _ = _truth_records(job, genome, tmp_path)
    lines = sam.read_text().splitlines(keepends=True)
    sam.write_text("".join(lines[1:]))
    got = reference.judge([job], [sam], [(0, 0)], genome, "cpu")
    assert got["price"][0] == job.lens[0]


def _split(mapq=60):
    """A read written as two pieces of one mapping, primary first."""
    a = [b"r", b"0", b"chrA", b"5001", b"%d" % mapq, b"10M", b"*", b"0",
         b"0", b"ACGTACGTAC", b"*", b"NM:i:1",
         b"SA:Z:chrA,9001,-,10M,%d,2;" % mapq]
    b = [b"r", b"2064", b"chrA", b"9001", b"%d" % mapq, b"10M", b"*", b"0",
         b"0", b"ACGTACGTAC", b"*", b"NM:i:2",
         b"SA:Z:chrA,5001,+,10M,%d,1;" % mapq]
    return [a, b]


def _secondary(mapq):
    return [b"r", b"256", b"chrB", b"4001", b"%d" % mapq, b"10M", b"*",
            b"0", b"0", b"ACGTACGTAC", b"*", b"NM:i:3"]


@pytest.mark.parametrize("alter", [
    "none", "mapq_61", "two_primaries", "flip", "supp_mapq", "sa",
    "order", "secondary_above", "unmapped_mapq", "sa_on_single"])
def test_flag_rules(genome, alter):
    recs = _split()
    if alter == "mapq_61":
        recs = _split(61)
    elif alter == "two_primaries":
        recs[1][1] = b"16"
    elif alter == "flip":
        recs[0][1], recs[1][1] = b"2048", b"16"
    elif alter == "supp_mapq":
        recs[1][4] = b"3"
    elif alter == "sa":
        recs[0][12] = b"SA:Z:chrA,9002,-,10M,60,2;"
    elif alter == "order":
        recs[0][3], recs[1][3] = recs[1][3], recs[0][3]
        recs[0][12], recs[1][12] = recs[1][12], recs[0][12]
    elif alter == "secondary_above":
        recs = [r[:12] for r in _split(20)[:1]] + [_secondary(30)]
    elif alter == "unmapped_mapq":
        recs = [[b"r", b"4", b"*", b"0", b"5", b"*", b"*", b"0", b"0",
                 b"ACGT", b"*"]]
    elif alter == "sa_on_single":
        recs = recs[:1]
    got = reference.judge_flags(recs + ([_secondary(10)] if alter == "none"
                                        else []), _contig(genome))
    assert (got is None) == (alter == "none"), got


def test_judge_holds_mapq_to_the_truth(genome, job, tmp_path):
    sam, _ = _truth_records(job, genome, tmp_path)
    sample = [(0, i) for i in range(len(job.lens))]
    got = reference.judge([job], [sam], sample, genome, "cpu")
    assert got["flag_faults"] == 0
    assert got["at_truth"].all() and got["mapq_low_unique"] == 0
    control.mapq_sam(sam, 0)
    low = reference.judge([job], [sam], sample, genome, "cpu",
                          got["best"])
    assert low["mapq_low_unique"] == int(got["unique"].sum()) > 0
    # the same records judged against truths 200 kb away: a read placed
    # off its truth is not held to a confident MAPQ
    moved = dataclasses.replace(job, start=np.where(
        job.start < 400_000, job.start + 200_000, job.start - 200_000))
    off = reference.judge([moved], [sam], sample, genome, "cpu")
    assert not off["at_truth"].any() and off["mapq_low_unique"] == 0
    assert off["flag_faults"] == off["bad_records"] == 0


def test_duplicated_spans_touch_a_copy_or_its_source(genome):
    dest, ln = genome.placements["segdup"]
    src = genome.sources["segdup"]
    lo = np.array([dest[0], src[0] + ln[0] - 1, 0])
    got = duplicated(genome, lo, lo + 1)
    assert got[0] and got[1] and not got[2]
