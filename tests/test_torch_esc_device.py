"""The port's device escalation offload (engine._escalation_pass with the
plain affine and Myers-with-path versions on the CPU) against the host
stitcher's local escalation path and against the JAX engine with its
offload on (Pallas affine kernel in interpret mode, jnp Myers with
path): the golden fixture's split / inversion / clip / garbage reads
plus six normal reads (as tests/test_esc_device.py), and the whole
golden fixture with the offload on against golden.sam."""

import io
from pathlib import Path

import numpy as np
import pytest

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.pipeline.engine import MappingEngine as JEngine
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.io.fastx import read_chunks
from lordfast_tpu_torch.pipeline.engine import MappingEngine

from test_golden import TEST_CFG
from test_torch_fm_index import port_index
from test_torch_import import jax_native_lib

DATA = Path(__file__).parent / "data"
# the counters both engines keep for the offload and the gap buckets
ESC_KEYS = ("esc_sites", "esc_host", "gaps_host")


@pytest.fixture(scope="module")
def port_idx(ref8_idx):
    return port_index(ref8_idx)


@pytest.fixture(scope="module")
def sv_reads():
    chunk = next(read_chunks(DATA / "reads.fq", 10**9))
    return [r for r in chunk
            if r.name.startswith(("sv_", "garbage"))] + chunk[:6]


def _map(engine, reads):
    out = io.StringIO()
    engine._map_chunk(reads, out)
    return out.getvalue()


def _esc_counters(engine):
    c = engine.metrics.counters
    return {k: v for k, v in c.items()
            if k in ESC_KEYS or k.startswith(("esc_b", "gaps_b"))}


@pytest.fixture(scope="module")
def port_runs(port_idx, sv_reads):
    # verbosity 2 adds the gap histograms (gsz_*, gpart_*) only
    runs = {}
    for on in (False, True):
        eng = MappingEngine(port_idx, TCfg(**TEST_CFG, verbosity=2),
                            device="cpu", esc_device=on)
        runs[on] = (_map(eng, sv_reads), eng)
    return runs


def test_offload_is_off_by_default_on_cpu(port_idx):
    assert not MappingEngine(port_idx, TCfg(**TEST_CFG),
                             device="cpu")._esc_device


def test_offload_on_equals_offload_off(port_runs):
    sam_off, _ = port_runs[False]
    sam_on, eng = port_runs[True]
    c = eng.metrics.counters
    assert c.get("esc_sites", 0) > 0, "the offload never fired"
    assert c["esc_affine_parts"] > 0 and c["esc_nw_parts"] > 0
    assert "esc_sites" not in port_runs[False][1].metrics.counters
    assert sam_on == sam_off


def test_gap_part_counters_match_launches(port_runs):
    # gpart_{mode}_{Q}x{T}_{n}: one count per launch of n gaps, as
    # chip_smoke.gap_parts reads them
    import chip_smoke

    c = port_runs[True][1].metrics.counters
    G = {(Q, T): g for Q, T, g in TCfg().gap_buckets}
    per_mode = {}
    for key, cnt in c.items():
        if key.startswith("gpart_"):
            mode, shape, n = key.split("_")[1:]
            Q, T = map(int, shape.split("x"))
            assert 1 <= int(n) <= G[(Q, T)], key
            per_mode[mode] = per_mode.get(mode, 0) + cnt
    launched = {"dist": c["gap_parts"], "col": c.get("esc_split_parts", 0),
                "moves": c["esc_nw_parts"]}
    assert per_mode == {m: n for m, n in launched.items() if n}
    parts = chip_smoke.gap_parts(c)
    assert sum(map(len, parts.values())) == sum(per_mode.values())
    assert {k for k, _, _ in parts} == {"myers_dist", "myers_moves"}


def test_offload_matches_jax_engine(ref8_idx, port_runs, sv_reads):
    # the JAX engine would fall back to numpy stitching without its
    # native library
    assert jax_native_lib() is not None
    jeng = JEngine(ref8_idx, JCfg(**TEST_CFG), esc_device=True)
    want = _map(jeng, sv_reads)
    sam_on, eng = port_runs[True]
    assert sam_on == want
    assert _esc_counters(eng) == _esc_counters(jeng)


@pytest.mark.parametrize("ql,tl,splits", [
    (512, 592, False), (1600, 2000, False), (1734, 2125, True),
    (2049, 2066, True), (4096, 64, False)])
def test_edlib_hirschberg_rule(ql, tl, splits):
    # edlib's traceback data: (2 words + 1 int) per 64-row block and
    # column, plus 2 ints per column; Hirschberg from 1 MiB
    size = 20 * -(-ql // 64) * tl + 8 * tl
    assert (size >= 2**20) == splits
    assert MappingEngine._edlib_splits(ql, tl) == splits


def _mutate(rng, t):
    """A query read off t with ~5% each of substitutions, insertions and
    deletions."""
    q = []
    for ch in t:
        r = rng.random()
        if r < 0.05:
            q.append(rng.integers(0, 4))
        elif r < 0.10:
            q += [ch, rng.integers(0, 4)]
        elif r >= 0.15:
            q.append(ch)
    return np.array(q, np.uint8)


# (q_len or None for a query mutated from the target, t_len, q_rc, t_rc):
# one Hirschberg level, two levels, reverse-complemented views, a junk
# pair (many equal-cost paths), and a segment below the split size
SPLIT_CASES = [(None, 2200, False, False), (None, 4000, False, False),
               (None, 2600, True, True), (1100, 3300, False, True),
               (None, 900, False, False)]


def test_split_paths_equal_edlib(port_idx, rng):
    # phase C's device paths (_run_nw_paths: Hirschberg splits from
    # myers_dist's last column, then myers_moves on the pieces) equal
    # the host stitcher's nw_align (edlib's obtainAlignment), ties and
    # split points included
    import torch

    from lordfast_tpu_torch.align import edlib_eq as ted
    from lordfast_tpu_torch.utils.pack import revcomp_codes

    eng = MappingEngine(port_idx, TCfg(**TEST_CFG), device="cpu",
                        esc_device=True)
    qs, items, want = [], [], []
    for i, (qn, tn, qrc, trc) in enumerate(SPLIT_CASES):
        t0 = int(rng.integers(0, port_idx.l_pac - tn))
        t = port_idx.get_ref_codes(t0, tn)
        q = (_mutate(rng, t) if qn is None
             else rng.integers(0, 4, qn).astype(np.uint8))
        qs.append(q)
        items.append(((0, i, eng.ESC_NW_A),
                      (i, 0, len(q), qrc, t0, tn, trc, False)))
        want.append(ted.nw_path(revcomp_codes(q) if qrc else q,
                                revcomp_codes(t) if trc else t))
    reads = np.full((len(qs), max(map(len, qs))), 4, np.uint8)
    for i, q in enumerate(qs):
        reads[i, : len(q)] = q
    got = eng._run_nw_paths(items, torch.from_numpy(reads))
    n_split = sum(eng._edlib_splits(d[2], d[5]) for _, d in items)
    assert n_split == len(SPLIT_CASES) - 1
    assert eng.metrics.counters["esc_splits"] > n_split  # two levels
    for (key, d), (dist, mv) in zip(items, want):
        g_dist, g_end, g_mv = got[key]
        assert (g_dist, g_end) == (dist, d[5] - 1), key
        np.testing.assert_array_equal(g_mv, mv, err_msg=str(key))


def test_golden_with_offload_on(port_idx):
    eng = MappingEngine(port_idx, TCfg(**TEST_CFG), device="cpu",
                        esc_device=True)
    out = io.StringIO()
    eng.map_file(DATA / "reads.fq", out, "test")
    ours = [l for l in out.getvalue().splitlines() if not l.startswith("@")]
    golden = [l.rstrip("\n") for l in open(DATA / "golden.sam")
              if not l.startswith("@")]
    assert eng.metrics.counters["esc_sites"] > 0
    assert len(ours) == len(golden)
    for i, (a, b) in enumerate(zip(golden, ours)):
        assert a == b, f"line {i} differs:\nG: {a[:200]}\nO: {b[:200]}"
