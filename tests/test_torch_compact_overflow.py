"""Compact-window overflow escalation in the PyTorch port's engine, on the
repeat-dense cases of tests/test_compact_overflow.py: a read whose
qualifying windows exceed the shared chaining budget escalates through
the 8x retry to the solo 512-window pipeline, and past 512 windows pages
through candidate ranks — mapped, never given up — and the port's SAM
equals the JAX engine's on the same index."""

import io

import pytest
import torch

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.index.builder import build_index
from lordfast_tpu.pipeline.engine import MappingEngine as JEngine
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.pipeline.engine import MappingEngine

from test_compact_overflow import CFG, CFG700, _make_repeat_case
from test_torch_fm_index import port_index

torch.set_num_threads(2)


def _sam(engine, fq):
    out = io.StringIO()
    engine.map_file(fq, out, "overflow-test")
    return [l for l in out.getvalue().splitlines() if not l.startswith("@")]


@pytest.fixture(scope="module")
def repeat_case(tmp_path_factory):
    import numpy as np

    d = tmp_path_factory.mktemp("overflow")
    return _make_repeat_case(d, np.random.default_rng(77), 150)


@pytest.fixture(scope="module")
def repeat_case_700(tmp_path_factory):
    import numpy as np

    d = tmp_path_factory.mktemp("overflow700")
    return _make_repeat_case(d, np.random.default_rng(78), 1600,
                             div=0.0, noise=(0.0, 0.0, 0.0))


def test_overflow_escalates_to_solo(repeat_case):
    fa, fq = repeat_case
    jidx = build_index(fa, JCfg(**CFG), verbose=False)
    eng = MappingEngine(port_index(jidx), TCfg(**CFG), device="cpu")
    recs = _sam(eng, fq)
    assert recs and int(recs[0].split("\t")[1]) & 4 == 0
    assert eng.stats.get("compact_overflow", 0) == 0
    assert eng.metrics.counters.get("compact_retry", 0) >= 1
    assert eng.metrics.counters.get("compact_solo", 0) >= 1
    assert recs == _sam(JEngine(jidx, JCfg(**CFG)), fq)


def test_window_paging_beyond_512(repeat_case_700):
    fa, fq = repeat_case_700
    jidx = build_index(fa, JCfg(**CFG700), verbose=False)
    eng = MappingEngine(port_index(jidx), TCfg(**CFG700), device="cpu")
    recs = _sam(eng, fq)
    assert recs and int(recs[0].split("\t")[1]) & 4 == 0
    assert eng.metrics.counters.get("compact_solo", 0) >= 1
    assert eng.metrics.counters.get("compact_page", 0) >= 1
    assert eng.stats.get("compact_overflow", 0) == 0
    assert recs == _sam(JEngine(jidx, JCfg(**CFG700)), fq)
