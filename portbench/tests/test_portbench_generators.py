"""The genome and read generators: deterministic by seed, and their
lengths, error ratio and repeat shares where the files state them."""

import numpy as np
import pytest
from conftest import TINY_CONFIG, TINY_TRAFFIC

from harness.genome import make_genome, repeat_shares
from harness.reads import (DEL, INS, MATCH, SUB, length_grid, make_job,
                           true_path)


@pytest.fixture(scope="module")
def genome():
    return make_genome(TINY_CONFIG["genome"])


def test_genome_is_deterministic_by_seed(genome):
    again = make_genome(TINY_CONFIG["genome"])
    assert np.array_equal(genome.codes, again.codes)
    other = make_genome({**TINY_CONFIG["genome"], "seed": 4})
    assert not np.array_equal(genome.codes, other.codes)


def test_genome_layout_and_repeat_shares(genome):
    spec = TINY_CONFIG["genome"]
    assert genome.total == sum(c[1] for c in spec["contigs"])
    tel = spec["telomere_n"]
    for (s, e), off, ln in zip(genome.cores, genome.offsets, genome.lengths):
        assert (genome.codes[off:s] == 4).all() and s - off == tel
        assert (genome.codes[e:off + ln] == 4).all() and off + ln - e == tel
        assert (genome.codes[s:e] < 4).all()
    shares = repeat_shares(genome)
    for f in spec["repeats"]:
        assert abs(shares[f["family"]] - f["share"]) < 0.002, f["family"]
    n_cores = len(genome.cores)
    alu = genome.placements["alu"][1]
    # whole consensus copies, but for the one a core cuts to fit
    assert (alu != 300).sum() <= n_cores and alu.max() == 300
    l1 = genome.placements["l1"][1]
    assert (l1 < 100).sum() <= n_cores and l1.max() <= 6000
    assert 700 < l1.mean() < 1100           # mean ~900 bp
    sd = genome.placements["segdup"][1]
    assert sd.max() <= 50000
    # copies never overlap
    starts = np.concatenate([d for d, _ in genome.placements.values()])
    lens = np.concatenate([ln for _, ln in genome.placements.values()])
    o = np.argsort(starts)
    assert (starts[o][1:] >= (starts + lens)[o][:-1]).all()


def test_interspersed_copies_diverge_as_stated():
    spec = {**TINY_CONFIG["genome"], "repeats": [
        {"family": "alu", "kind": "interspersed", "consensus_len": 300,
         "share": 0.106, "length": {"law": "full"},
         "divergence": [0.05, 0.15]}]}
    g = make_genome(spec)
    dest, ln = g.placements["alu"]
    copies = np.stack([g.codes[d:d + 300] for d in dest[ln == 300]])
    # each copy is the consensus or its reverse complement, diverged:
    # the column-wise majority of the forward copies is the consensus
    fwd = copies[0]
    rc = 3 - copies[:, ::-1]
    same = (copies == fwd).mean(axis=1) > (rc == fwd).mean(axis=1)
    oriented = np.where(same[:, None], copies, rc)
    cons = np.array([np.bincount(c, minlength=4).argmax()
                     for c in oriented.T])
    div = (oriented != cons).mean(axis=1)
    # drawn in 5-15%, read off 300 bases (binomial noise ~2%)
    assert 0.02 < div.min() and div.max() < 0.20
    assert 0.08 < div.mean() < 0.12


def test_reads_are_deterministic_and_hold_the_same_work(genome):
    a = make_job(genome, TINY_TRAFFIC, 2**31 + 99, 3)
    b = make_job(genome, TINY_TRAFFIC, 2**31 + 99, 3)
    c = make_job(genome, TINY_TRAFFIC, 2**31 + 100, 3)
    assert np.array_equal(a.codes, b.codes) and np.array_equal(a.ops, b.ops)
    assert not np.array_equal(a.codes, c.codes)
    grid = length_grid(TINY_TRAFFIC["length"], TINY_TRAFFIC["job_reads"])
    for j in (a, c):
        assert sorted(j.lens) == sorted(grid)


def test_length_grid_lands_in_its_law():
    law = {"median": 7600, "sigma": 0.7, "min": 1000, "max": 30000}
    g = length_grid(law, 1024)
    assert g.min() >= 1000 and g.max() <= 30000
    assert abs(np.median(g) - 7600) < 300
    assert 8500 < g.mean() < 9500


def test_error_model_ratio_and_rate(genome):
    traffic = {**TINY_TRAFFIC, "job_reads": 64}
    j = make_job(genome, traffic, 5, 0)
    err = j.ops[j.ops != MATCH]
    frac = [np.mean(err == k) for k in (SUB, INS, DEL)]
    assert abs(frac[0] - 0.10) < 0.02
    assert abs(frac[1] - 0.60) < 0.02
    assert abs(frac[2] - 0.30) < 0.02
    assert abs(j.n_err.sum() / j.lens.sum() - 0.13) < 0.015


def test_reads_follow_their_truth(genome):
    j = make_job(genome, TINY_TRAFFIC, 17, 1)
    for i in range(len(j.lens)):
        ops, codes = j.read_ops(i), j.read_codes(i)
        assert len(codes) == j.lens[i]
        tp = true_path(ops)
        assert tp[-1] == j.span[i]
        ref = genome.codes[j.start[i]:j.start[i] + j.span[i]]
        assert (ref < 4).all()                  # inside a core
        kept = ops[ops != DEL]
        m = kept == MATCH
        s = kept == SUB
        assert np.array_equal(codes[m], ref[tp[:-1][m]])
        assert (codes[s] != ref[tp[:-1][s]]).all()
