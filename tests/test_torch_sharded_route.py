"""The sharded index's routing and loops in the port
(lordfast_tpu_torch/ops/fm_index.py ``_row_gather``, ``_route_gather``,
``_shard_blocks``, ``_shard_ext``, ``_shard_walk``; ops/fm_shard_cuda.py)
against the JAX
package's routing (lordfast_tpu/ops/fm_index.py ``_row_gather_routed``,
``_row_gather_ag``) and against a numpy model of csrc/seed_shard.cu's
kernels (tests/torch_shard_model.py, names as in the source).

The port runs one process per rank under a gloo group on the CPU
(tests/torch_mesh_ranks.py); the JAX package runs in this process under
shard_map on the 8-CPU-device mesh of conftest.py.  Every output is an
integer: the tolerance is exact equality.  Covered:
- every route of the gathers at D = 2 and 8 on int64 stripes: the exact
  gather and the all-gather route equal a plain gather and JAX's routed
  and all-gather functions, on uniform and owner-skewed query sets (at D
  = 8 the skewed ones overflow JAX's buckets, so both take the
  all-gather route); the routed buckets alone flag an overflow exactly
  where a bucket gets more than JAX's cap and answer every query that
  got a slot; a live mask asks only its queries;
- the kernels' loops over the wrappers' plain versions (with the
  smoke's kernel checks, chip_smoke.check_shard_kernels, and bytes
  bound, shard_work, run on them) and over the model (buckets' slots
  taken in a random order) against the plain loops at D = 2 and 3, on a batch with padding
  rows, in both rank layouts with the SA full and at 32: the same seeds,
  also with every bucket's cap forced to 8 (every routed block overflows
  and runs again through the all-gather route); chip_smoke.edge_reads'
  lanes (compares ending at every offset, an N, the read's end, the
  text's start, MAX_ANCHOR_LEN) both ways and over the replicated index,
  at 7 steps a block, so the longest lanes die in mid-block;
- the smoke's bytes bound of each kernel (chip_smoke.shard_work) against
  a count by hand: only the rank-row pieces occ reads, the owned slots.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.ops import fm_index as jfm
from lordfast_tpu.parallel.mesh import make_mesh
from lordfast_tpu_torch.index.builder import save_index

from test_sharded_index import CFG, _batch_from_index
from test_torch_fm_index import port_index
from torch_mesh_ranks import run_ranks

ROUTE_CASES = [["uniform", 600, "uniform"], ["skew", 640, "skew"],
               ["tiny", 5, "uniform"]]


def _jax_route(fn, full, rows, D):
    """fn(stripe, rows, "data") under shard_map over D devices: each
    device's stripe of full (padded to D rows-per-stripe) and its rows
    (rows (D, n), device d's in row d)."""
    rps = -(-full.shape[0] // D)
    pad = np.zeros((D * rps,) + full.shape[1:], full.dtype)
    pad[: full.shape[0]] = full
    mesh = make_mesh(jax.devices()[:D])
    f = jax.shard_map(lambda st, r: fn(st, r, "data"), mesh=mesh,
                      in_specs=(P("data"), P("data")), out_specs=P("data"),
                      check_vma=False)
    return np.asarray(jax.jit(f)(pad, rows.reshape(-1))).reshape(
        rows.shape + full.shape[1:])


@pytest.mark.parametrize("D", [2, 8])
def test_row_gather_routes_match_jax(tmp_path, D):
    rng = np.random.default_rng(D)
    arrays = {"i64": rng.integers(-2**40, 2**40, (1001, 12)),
              "flat": rng.integers(0, 2**32, 1001)}
    for name, full in arrays.items():
        np.save(tmp_path / f"full_{name}.npy", full)
    res, _ = run_ranks("routes", tmp_path, D, timeout=90,
                       args={"seed": 9, "cases": ROUTE_CASES,
                             "arrays": sorted(arrays)})
    for rank, (rc, err) in enumerate(res):
        assert rc == 0, f"rank {rank}: {err[-3000:]}"
    n_over = 0
    for name, full in arrays.items():
        outs = [np.load(tmp_path / f"out{r}_{name}.npz") for r in range(D)]
        rps = -(-full.shape[0] // D)
        for case, n, _ in ROUTE_CASES:
            rows = np.stack([o[f"{case}_rows"] for o in outs])
            want = full[rows]
            routed = _jax_route(jfm._row_gather_routed, full, rows, D)
            ag = _jax_route(jfm._row_gather_ag, full, rows, D)
            np.testing.assert_array_equal(routed, want)
            np.testing.assert_array_equal(ag, want)
            cap = max(((-(-2 * n // D)) + 7) & ~7, 8)
            for r, o in enumerate(outs):
                msg = f"{name} {case} rank {r}"
                for route in ("exact", "ag"):
                    assert o[f"{case}_{route}"].dtype == want.dtype
                    np.testing.assert_array_equal(o[f"{case}_{route}"],
                                                  want[r], err_msg=msg)
                live = o[f"{case}_live"]
                mask = live if full.ndim == 1 else live[:, None]
                np.testing.assert_array_equal(o[f"{case}_masked"],
                                              np.where(mask, want[r], 0),
                                              err_msg=msg)
                # the routed buckets alone: a query past its owner's cap
                # (in query order) is dropped, and the flag says so
                owner = np.minimum(rows[r] // rps, D - 1)
                kept = np.array([(owner[: i] == owner[i]).sum() < cap
                                 for i in range(n)], bool)
                over = bool((np.bincount(owner, minlength=D) > cap).any())
                assert int(o[f"{case}_over"]) == over, msg
                n_over += over
                got = o[f"{case}_routed"]
                np.testing.assert_array_equal(got[kept], want[r][kept],
                                              err_msg=msg)
                assert not got[~kept].any(), msg
    # JAX's buckets overflow on the skewed sets at D = 8 only (at D = 2 a
    # bucket holds 2 ceil(Q / 2) >= Q queries)
    assert (n_over > 0) == (D == 8)


# the runs of the model job: (name, index file, forced split layout);
# the full-SA runs also extend the edge lanes (no locate: the SA's
# sampling does not matter to them)
MODEL_RUNS = [("fused_full", "index.lft.npz", False),
              ("split_32", "index32.lft.npz", True),
              ("fused_32", "index32.lft.npz", False),
              ("split_full", "index.lft.npz", True)]


@pytest.fixture(scope="module")
def model_case(small_index, tmp_path_factory):
    idx, _ = small_index
    d = tmp_path_factory.mktemp("shard_model")
    cfg = JCfg(**CFG)
    reads, lens = _batch_from_index(small_index, np.random.default_rng(21),
                                    B=12)
    reads[-2:], lens[-2:] = 4, 0  # padding rows, as a short last batch has
    pos = jfm.sample_positions_host(lens, cfg.sampling_count)
    np.savez(d / "batch.npz", reads=reads, lens=lens, pos=pos)
    idx32 = dataclasses.replace(
        idx, sa_samp=np.ascontiguousarray(idx.sa_samp[::32]), sa_intv=32,
        _device=None)
    save_index(port_index(idx), d / "index.lft.npz")
    save_index(port_index(idx32), d / "index32.lft.npz")
    return d


@pytest.mark.parametrize("D", [2, 3])
def test_shard_kernel_model_matches_plain_loops(model_case, D):
    d = model_case
    runs = [{"name": f"{name}_{D}", "index": f, "split_layout": split,
             "edge": name.endswith("full")} for name, f, split in MODEL_RUNS]
    res, _ = run_ranks("shard_model", d, D, timeout=600,
                       args={"cfg": CFG, "runs": runs, "edge_S": 7})
    for rank, (rc, err) in enumerate(res):
        assert rc == 0, f"rank {rank}: {err[-3000:]}"
    fields = ("t_pos", "q_pos", "length", "is_rev", "valid", "n_total",
              "n_anchors")
    for run in runs:
        for r in range(D):
            o = np.load(d / f"out{r}_{run['name']}.npz")
            keys = list(o["counts_keys"])
            msg = f"{run['name']} rank {r}"
            for f in fields:
                for tag in ("wrap", "model", "over"):
                    np.testing.assert_array_equal(
                        o[f"{tag}_{f}"], o[f"plain_{f}"],
                        err_msg=f"{msg} {tag} {f}")
            assert o["plain_valid"].any(), msg
            sampled = "32" in run["name"]
            assert list(o["checked"]) == sorted(
                ["shard_bucket", "shard_answer", "shard_ext_step",
                 "shard_bucket ids", "shard_answer sa"]
                + ["shard_walk_step"] * sampled), msg
            assert (o["work"] > 0).all(), msg
            c = {tag: dict(zip(keys, o[f"{tag}_counts"]))
                 for tag in ("plain", "wrap", "model", "over")}
            # one extension loop, and a walk with a sampled SA: a read to
            # size each loop's first block, one a block, one a redone
            # block, two for the exact gather of the SA entries
            loops = 2 if sampled else 1
            for tag, cc in c.items():
                assert cc["calls"] == 1 and cc["blocks"] >= loops, (msg, cc)
                assert cc["host_reads"] == (loops + cc["blocks"]
                                            + cc["redone"] + 2), (msg, cc)
            assert (c["plain"]["redone"] == c["wrap"]["redone"]
                    == c["model"]["redone"] == 0)
            assert c["over"]["redone"] > 0, (msg, c)
            if not run["edge"]:
                continue
            for k in "klm":
                np.testing.assert_array_equal(o[f"edge_model_{k}"],
                                              o[f"edge_plain_{k}"], msg)
                np.testing.assert_array_equal(o[f"edge_plain_{k}"],
                                              o[f"edge_repl_{k}"], msg)
            # the "max" lanes take 4095 steps and die on the 4096th, in
            # the middle of a block of 7 (every rank extends the same
            # lanes, so at D = 3 a bucket may overflow and a block run
            # again)
            assert o["edge_plain_m"].max() == 4095
            for tag in ("edge_plain", "edge_model"):
                ec = dict(zip(keys, o[f"{tag}_counts"]))
                assert ec["blocks"] == math.ceil(4096 / 7), (msg, ec)
                assert ec["steps"] == 7 * (ec["blocks"] + ec["redone"])


def _launches(**kw):
    import chip_smoke

    base = {k: 0 for k in (*chip_smoke.KERNELS, *chip_smoke.LOOPS,
                           *chip_smoke.SHARD_KERNELS, *chip_smoke.SHARD_LOOPS)}
    return {**base, **kw}


@pytest.mark.parametrize("sampled", [False, True])
def test_check_launches_sharded_routing(sampled):
    """The smoke's routing checks of a sharded pass: on the card the four
    seed_shard kernels launch (shard_walk_step only with a sampled SA)
    and neither plain loop is entered; a plain_loops pass enters the
    plain loops (the walk only with a sampled SA) and launches none of
    the kernels."""
    import chip_smoke

    ck = chip_smoke.check_launches
    need = ("chain_dp",) + chip_smoke.SHARD_KERNELS
    kern = dict(chain_dp=4, shard_bucket=90, shard_answer=90,
                shard_ext_step=60, shard_walk_step=30 if sampled else 0)
    ck("s", _launches(**kern), {}, need, sampled=sampled, sharded=True)
    bad = [dict(kern, _shard_ext=1), dict(kern, shard_answer=0)]
    if not sampled:
        bad.append(dict(kern, shard_walk_step=1))
    for b in bad:
        with pytest.raises(AssertionError):
            ck("s", _launches(**b), {}, need, sampled=sampled, sharded=True)
    plain = dict(_chain_bucketed=4, _shard_ext=4,
                 _shard_walk=4 if sampled else 0,
                 sa_lookup=4 if sampled else 0)
    ck("p", _launches(**plain), {}, (), plain=True, sampled=sampled,
       sharded=True)
    for b in (dict(plain, shard_bucket=1), dict(plain, _shard_ext=0)):
        with pytest.raises(AssertionError):
            ck("p", _launches(**b), {}, (), plain=True, sampled=sampled,
               sharded=True)


def _work_case(name):
    """(args, kw, bytes counted by hand) of one recorded call of a shard
    kernel, for chip_smoke.shard_work: rank rows of zeros, so every
    occ counts A's (k's offset + 1) and every walk char is A."""
    import torch

    from lordfast_tpu_torch.ops import fm_index as fm

    i64 = torch.int64
    meta = {"seq_len": 1000, "primary": 500, "sa_intv": 2}
    arrs = {"L2": torch.zeros(5, dtype=i64),
            "fm_blocks": torch.zeros((8, 12), dtype=i64),
            "sa_samp": torch.zeros(8, dtype=torch.int32)}
    T, F = True, False
    if name == "bucket":
        live = torch.tensor([T, F, T])
        k = torch.tensor([1, 2, 3])
        args = (live, k, k + 1, meta, 8, 2, 8, torch.full((16,), -1),
                torch.full((6,), -1, dtype=torch.int32))
        # 3 flags, 2 live lanes' k and l, 6 slots, 16 send slots
        return args, {}, 3 + 2 * 16 + 6 * 4 + 16 * 8
    if name in ("answer", "answer sa"):
        recv = torch.tensor([-1, 5, 5, 12, 3, -1, 20])
        sa = name == "answer sa"
        out = torch.zeros((7,) if sa else (7, 12), dtype=i64)
        # 7 ids; rows 3 and 1 of the stripe (base 2); 3 owned slots
        row, width = (4, 8) if sa else (96, 96)
        return ((recv, arrs, 2, out), {"key": "sa_samp"} if sa else {},
                7 * 8 + 2 * row + 3 * width)
    if name == "walk step":
        active = torch.tensor([T, T, T, T, F, T])
        rows = torch.tensor([3, 500, 1000, 40, 77, 200])
        slot = torch.tensor([0, -1, 1, -1, -1, 2], dtype=torch.int32)
        state = [active, rows, torch.zeros(6, dtype=i64)]
        # pieces: row 3 (count + pair 0) 32, row seq_len (its char's pair)
        # 16, row 200 (off 72: count + pairs 0-2) 64; row 40 has no slot,
        # 500 is primary.  Rows 3, 500 and 1000 stop (3 -> 4, 500 -> 0,
        # 1000 -> 0), 40 -> 41 and 200 -> 73 go on
        pieces, live, stepping, stop = 32 + 16 + 64, 5, 4, 3
        return ((state, arrs, meta, torch.zeros((3, 12), dtype=i64), slot),
                {}, 6 + live * 32 + stepping * 4 + pieces + stop + 40)
    reads = torch.tensor([[3, 0, 4, 2, 2, 1] + [0] * 10])
    rd = fm._Reads(reads, torch.tensor([16]))
    alive = torch.tensor([T, T, T, T, F, T])
    k = torch.tensor([1, 0, 5, 5, 5, 130])
    l = torch.tensor([700, 1000, 9, 9, 9, 200])
    m = torch.tensor([0, 0, 0, 13, 0, 0])
    pos_f = torch.tensor([0, 1, 2, 3, 0, 5])
    slot = torch.tensor([0, 1, 5, 6, -1, 2, 3, 4, 7, 8, -1, -1],
                        dtype=torch.int32)
    args = ([alive, k, l, m], pos_f, torch.zeros(6, dtype=i64), rd, arrs,
            meta, torch.zeros((9, 12), dtype=i64), slot)
    # lanes 2 (an N) and 3 (past the read's end) end on their char and
    # need no row; lane 1's queries are rows -1 and seq_len (no row);
    # pieces: lane 0 rows 0 (32) and 700 (off 59: 48), lane 5 row 129
    # (32; its l has no slot).  Only lane 0 survives (k 2, l 60)
    pieces, live, stepping, kept = 32 + 48 + 32, 5, 3, 1
    return args, {}, (6 + live * 24 + stepping * 24 + pieces + 8 + 8
                      + kept * 24 + (live - kept) + 40)


@pytest.mark.parametrize("name", ["bucket", "answer", "answer sa",
                                  "ext step", "walk step"])
def test_smoke_shard_work_counts_what_the_lanes_need(name):
    # the bytes bound of each shard kernel counts, of each returned rank
    # row, only the pieces occ reads (the count of c, the word pairs up
    # to the row's), and of the answer only the owned slots
    import chip_smoke

    args, kw, want = _work_case(name)
    kernel = {"bucket": "shard_bucket", "answer": "shard_answer",
              "ext": "shard_ext_step", "walk": "shard_walk_step"}
    assert chip_smoke.shard_work(kernel[name.split()[0]], args, kw) == want
