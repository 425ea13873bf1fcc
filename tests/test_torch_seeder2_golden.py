"""The dormant extend-whole-2 seeder through the PyTorch port's engine on
the golden fixture: the port's SAM equals the JAX engine's.  Its host
seeder extends every sampled anchor one character a call
(ops/seeders.py), ~0.4 s a read at sampling_count 100, as in
tests/test_seeders.py, so the case has a file of its own."""

import io
from pathlib import Path

import torch

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.pipeline.engine import MappingEngine as JEngine
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.pipeline.engine import MappingEngine

from test_golden import TEST_CFG
from test_torch_fm_index import port_index

DATA = Path(__file__).parent / "data"

torch.set_num_threads(2)


def _sam(engine):
    out = io.StringIO()
    engine.map_file(DATA / "reads.fq", out, "seeder2")
    return [l for l in out.getvalue().splitlines() if not l.startswith("@")]


def test_engine_golden_extend_whole_2_matches_jax(ref8_idx):
    cfg = dict(TEST_CFG, seeder="extend-whole-2", sampling_count=100)
    eng = MappingEngine(port_index(ref8_idx), TCfg(**cfg), device="cpu")
    ours = _sam(eng)
    assert len(ours) == 78
    assert ours == _sam(JEngine(ref8_idx, JCfg(**cfg)))
    assert eng.metrics.timers["host_seed"] > 0
