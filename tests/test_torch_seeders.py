"""The dormant seeders (``--seeder extend-whole-2 | extend-whole-3``) in the
PyTorch port against the JAX package: the host seeders of the port's
verbatim copy of ops/seeders.py on the same index and reads, the engine's
host-seed path on the golden fixture under extend-whole-3 (the port's
SAM equal to the JAX engine's and to golden.sam), and the
compact-overflow retries (8x budget, solo read, candidate-rank pages)
under a dormant seeder on the repeat cases of
tests/test_compact_overflow.py."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.index.builder import build_index
from lordfast_tpu.ops import seeders as jseed
from lordfast_tpu.pipeline.engine import MappingEngine as JEngine
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.ops import seeders as tseed
from lordfast_tpu_torch.pipeline.engine import MappingEngine

from test_compact_overflow import CFG, CFG700, _make_repeat_case
from test_golden import TEST_CFG
from test_seeders import _mirror_text
from test_torch_fm_index import port_index

DATA = Path(__file__).parent / "data"

torch.set_num_threads(2)


def _sam(engine, fq):
    out = io.StringIO()
    engine.map_file(fq, out, "seeder-test")
    return [l for l in out.getvalue().splitlines() if not l.startswith("@")]


@pytest.mark.parametrize("fn", ["seeds_step2", "seeds_step3"])
def test_host_seeders_match_jax(small_index, fn):
    jidx, contigs = small_index
    tidx = port_index(jidx)
    text, l_pac = _mirror_text(contigs)
    rng = np.random.default_rng(31)
    cfg = dict(sampling_count=60, max_ref_hits=50)
    n_seeds = 0
    for _ in range(4):
        ln = int(rng.integers(150, 400))
        st = int(rng.integers(0, 2 * l_pac - ln))
        codes = text[st : st + ln].copy()
        sites = rng.integers(0, ln, ln // 12)
        codes[sites] = rng.integers(0, 4, len(sites))
        want = getattr(jseed, fn)(jidx, codes, JCfg(**cfg))
        got = getattr(tseed, fn)(tidx, codes, TCfg(**cfg))
        assert got == want
        n_seeds += len(got[0]) + len(got[1])
    assert n_seeds > 20


def test_engine_golden_extend_whole_3_matches_jax(ref8_idx):
    """extend-whole-3 at the golden test's config: the port's SAM equals
    the JAX engine's and golden.sam.  (extend-whole-2, whose host seeder
    costs ~0.4 s a read, is in test_torch_seeder2_golden.py.)"""
    cfg = dict(TEST_CFG, seeder="extend-whole-3")
    eng = MappingEngine(port_index(ref8_idx), TCfg(**cfg), device="cpu")
    ours = _sam(eng, DATA / "reads.fq")
    assert ours == _sam(JEngine(ref8_idx, JCfg(**cfg)), DATA / "reads.fq")
    assert eng.metrics.timers["host_seed"] > 0
    golden = [l.rstrip("\n") for l in open(DATA / "golden.sam")
              if not l.startswith("@")]
    assert len(golden) == 78 and ours == golden


@pytest.mark.parametrize("case", ["solo", "paged"])
def test_overflow_retries_under_dormant_seeder(tmp_path, case):
    """extend-whole-3 on the repeat reads: the batch's host seeds feed the
    8x retry, the solo retry and each page seed the read on the host
    again, and the SAM equals the JAX engine's."""
    if case == "solo":
        fa, fq = _make_repeat_case(tmp_path, np.random.default_rng(77), 150)
        cfg = dict(CFG, seeder="extend-whole-3")
    else:
        fa, fq = _make_repeat_case(tmp_path, np.random.default_rng(78), 1600,
                                   div=0.0, noise=(0.0, 0.0, 0.0))
        cfg = dict(CFG700, seeder="extend-whole-3")
    jidx = build_index(fa, JCfg(**cfg), verbose=False)
    eng = MappingEngine(port_index(jidx), TCfg(**cfg), device="cpu")
    recs = _sam(eng, fq)
    c = eng.metrics.counters
    assert recs and int(recs[0].split("\t")[1]) & 4 == 0
    assert c.get("compact_retry", 0) >= 1 and c.get("compact_solo", 0) >= 1
    if case == "paged":
        assert c.get("compact_page", 0) >= 1
    assert eng.stats.get("compact_overflow", 0) == 0
    assert recs == _sam(JEngine(jidx, JCfg(**cfg)), fq)
