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
  bound, shard_work, run on them) and over the model (the answer's
  unwritten slots holding garbage) against the plain loops at D = 2
  and 3, on a batch with padding
  rows, in both rank layouts with the SA full and at 32: the same seeds,
  also with every bucket's cap forced to 8 (every routed block overflows
  and runs again through the all-gather route); chip_smoke.edge_reads'
  lanes (compares ending at every offset, an N, the read's end, the
  text's start, MAX_ANCHOR_LEN) both ways and over the replicated index,
  at 7 steps a block, so the longest lanes die in mid-block;
- the smoke's bytes bound of each kernel (chip_smoke.shard_work) against
  a count by hand: only the rank-row pieces occ reads, the owned slots;
- the bucket kernel's model (its scan, look-back and tail fill) against
  shard_bucket_plain bit for bit at D = 1, 2, 3 and 8, on extension,
  walk and row-id queries, with caps that fit and overflow, whichever
  earlier tiles have published their prefixes; the routed answer's
  model over a sentinel-filled output, with D ranks in this process,
  against the plain answer at every taken slot and through the next
  extension and walk step (the all-gather answer over the whole
  buffer); the smoke's bucket and answer checks against broken kernels.
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
            # each step kernel also at its first list steps below 10% and
            # 1% of its lanes live (chip_smoke.record_shard)
            steps = ["shard_ext_step"] + ["shard_walk_step"] * sampled
            assert list(o["checked"]) == sorted(
                ["shard_bucket", "shard_answer", "shard_bucket ids",
                 "shard_answer sa"] + steps
                + ["shard_bucket walk", "shard_answer walk"] * sampled
                + [f"{k} {t}" for k in steps for t in ("<10%", "<1%")]), msg
            # the pass recorded its first calls and the loops' (no sparse
            # step: finding one reads the card, which the replay does
            # after the pass)
            loop_tags = ["shard_ext"] + ["shard_walk"] * sampled
            assert list(o["recorded"]) == sorted(
                [t for t in o["checked"] if "%" not in t] + loop_tags), msg
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
            # again); the model's run forces the first block's cap to 8,
            # so it runs again through the all-gather route from its
            # saved state, its first step over the flags again
            assert o["edge_plain_m"].max() == 4095
            for tag in ("edge_plain", "edge_model"):
                ec = dict(zip(keys, o[f"{tag}_counts"]))
                assert ec["blocks"] == math.ceil(4096 / 7), (msg, ec)
                assert ec["steps"] == 7 * (ec["blocks"] + ec["redone"])
            ec = dict(zip(keys, o["edge_model_counts"]))
            assert ec["redone"] >= 1, (msg, ec)


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


# ---- seed_shard.cu's bucket and answer kernels: the model (names as in
# the source) against the plain versions, bit for bit ----

BUCKET_SEQ_LEN = 1 << 20
BUCKET_PRIMARY = 12345


def _bucket_case(D, kind, cap_kind):
    """One step's queries and their plain buckets: 35 kernel tiles' worth
    of extension queries (past one look-back round of 32 tiles), half as
    many lanes' walk or row-id queries, 15% of the lanes dead, 40% of the
    rows drawn from owner 0's stripe (uneven buckets), an extension's
    edge rows (k - 1 = -1, l =
    seq_len), a walk's primary rows; the cap fits (the largest bucket
    rounded up to 8), or half the largest bucket (some overflow), or None
    (the all-gather route).  Returns (the model's arguments, the plain
    version's (send, slot, counts, over))."""
    import torch

    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    import torch_shard_model as model

    rng = np.random.default_rng([D, len(kind), len(cap_kind)])
    n, seq_len, primary = 35 * model.kTile // 2, BUCKET_SEQ_LEN, \
        BUCKET_PRIMARY
    ids = kind == "ids"
    n_rows = seq_len // 32 if ids else (seq_len >> 7) + 1
    rps = -(-n_rows // D)
    top = n_rows if ids else seq_len + 1
    first = rps if ids else rps << 7
    k = np.where(rng.random(n) < 0.4, rng.integers(0, min(first, top), n),
                 rng.integers(0, top, n))
    live = rng.random(n) < 0.85
    l = None
    if kind == "ext":
        l = np.minimum(k + rng.integers(0, 5000, n), seq_len)
        k[:5], l[5:10] = 0, seq_len
    elif kind == "walk":
        k[::7] = primary
    meta = None if ids else {"seq_len": seq_len, "primary": primary}
    sl, pr = (0, 0) if ids else (seq_len, primary)
    blk, ask = model.query_block(live, k, l, sl, pr, ids)
    owner = np.minimum(blk[ask] // rps, D - 1)
    most = int(np.bincount(owner, minlength=D).max())
    cap = {"fit": max((most + 7) & ~7, 8),
           "over": max((most // 2 + 7) & ~7, 8), "all_gather": None}[cap_kind]
    Q = len(blk)
    T = torch.from_numpy
    send = torch.full((Q if cap is None else D * cap,), 7)
    slot = torch.full((Q,), 7, dtype=torch.int32)
    counts = torch.full((D,), 7, dtype=torch.int32)
    over = torch.zeros(1, dtype=torch.int32)
    K.shard_bucket_plain(T(live), T(k), None if l is None else T(l), meta,
                         rps, D, cap, send, slot, counts, over, ids=ids)
    args = (live, k, l, sl, pr, rps, D, cap or 0, cap is None, ids)
    return args, (send.numpy(), slot.numpy(), counts.numpy(),
                  int(over[0]))


@pytest.mark.parametrize("cap_kind", ["fit", "over", "all_gather"])
@pytest.mark.parametrize("kind", ["ext", "walk", "ids"])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_bucket_model_matches_plain(D, kind, cap_kind):
    # the kernel's scan (tiles, warps' rounds, look-back, tail fill) gives
    # fm_index.bucket's slots in query order: send, slot, counts and the
    # overflow flag bit for bit, whichever earlier tiles have published
    # their inclusive prefix when a tile looks back (none but tile 0's:
    # every look-back walks to the start, 32 tiles a round)
    import torch_shard_model as model

    args, want = _bucket_case(D, kind, cap_kind)
    for seed, published in enumerate((0.0, 0.3, 1.0)):
        got = model.shard_bucket_kernel(np.random.default_rng(seed), *args,
                                        published=published)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        if cap_kind != "all_gather":
            np.testing.assert_array_equal(got[2], want[2])
            assert got[3] == want[3] == (cap_kind == "over")
    # asked and unasked queries, filled and empty slots
    assert (want[0] >= 0).any()
    assert (want[0] == -1).any() or cap_kind != "all_gather"
    assert (want[1] >= 0).any()
    assert (want[1] < 0).any() == (cap_kind != "all_gather")


def _stripes(full, keys, D):
    """Every rank's stripes of ``keys`` of the arrays ``full``, padded as
    parallel/sharded_index.shard_index_arrays pads them, beside L2."""
    import torch

    out = []
    for r in range(D):
        arrs = {"L2": full["L2"]}
        for key in keys:
            v = full[key]
            rps = -(-v.shape[0] // D)
            st = torch.zeros((rps,) + tuple(v.shape[1:]), dtype=v.dtype)
            part = v[r * rps: (r + 1) * rps]
            st[: part.shape[0]] = part
            arrs[key] = st
        out.append(arrs)
    return out


SENTINEL = -0x5A5A5A5A5A5A5A5B


@pytest.mark.parametrize("layout", ["fused", "split"])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_answer_model_leaves_only_unread_slots(small_index, D, layout):
    # D ranks in this process, the all_to_all written out: the routed
    # answer (the model) over an out filled with a sentinel equals the
    # plain answer at every slot a query took, leaves every empty slot
    # unwritten, and the next extension / walk step and the SA entries'
    # by_slot give the same values as from the plain answer's zeros; the
    # all-gather answer equals the plain one over the whole buffer
    import torch

    import chip_smoke
    import torch_shard_model as model
    from lordfast_tpu_torch.ops import fm_index as fm
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    idx = port_index(small_index[0])
    full = idx.device_arrays("cpu")
    if layout == "split":
        full = chip_smoke.split_layout(idx, full)
        full["occ_cp"] = full["occ_cp"][: full["bwt_blocks"].shape[0]]
    keys = ("fm_blocks",) if layout == "fused" else ("occ_cp", "bwt_blocks")
    ranks = _stripes(full, keys + ("sa_samp",), D)
    meta = dict(idx.meta, sa_intv=32)
    seq_len, primary = meta["seq_len"], meta["primary"]
    rng = np.random.default_rng([D, len(layout)])
    T = torch.from_numpy
    n, B, L = 700, 6, 300
    reads = rng.integers(0, 5, (B, L)).astype(np.uint8)
    rd = fm._Reads(T(reads), T(rng.integers(100, L + 1, B)))

    def lanes():
        k = rng.integers(0, seq_len + 1, n)
        lanes_ = {"live": T(rng.random(n) < 0.85), "k": T(k)}
        lanes_["l"] = T(np.minimum(k + rng.integers(0, 3000, n), seq_len))
        lanes_["k"][:4], lanes_["l"][4:8] = 0, seq_len
        lanes_["rows"] = T(np.where(rng.random(n) < 0.1, primary, k))
        lanes_["ids"] = T(rng.integers(0, len(full["sa_samp"]), n))
        lanes_["m"] = T(rng.integers(0, 60, n))
        lanes_["pos_f"] = T(rng.integers(0, L, n))
        lanes_["b_lane"] = T(rng.integers(0, B, n))
        return lanes_

    per = [lanes() for _ in range(D)]
    for q in ("ext", "walk", "sa"):
        sa = q == "sa"
        stripe = ranks[0]["sa_samp" if sa else keys[0]]
        rps = stripe.shape[0]
        qargs = [(x["live"], x["ids"] if sa else x["rows"] if q == "walk"
                  else x["k"], x["l"] if q == "ext" else None) for x in per]
        Q = 2 * n if q == "ext" else n
        cap = fm.shard_cap(Q, D)
        sends, slots = [], []
        for live, k, l in qargs:
            send = torch.empty(D * cap, dtype=torch.int64)
            slot = torch.empty(Q, dtype=torch.int32)
            K.shard_bucket_plain(live, k, l, None if sa else meta, rps, D,
                                 cap, send, slot,
                                 torch.empty(D, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32), ids=sa)
            sends.append(send)
            slots.append(slot)
        kw = {"key": "sa_samp"} if sa else {}
        backs = {}
        for tag in ("plain", "model"):
            outs = []
            for o in range(D):
                recv = torch.cat([s[o * cap: (o + 1) * cap] for s in sends])
                shape = (D * cap,) + (() if sa else (12,))
                if tag == "plain":
                    out = torch.zeros(shape, dtype=torch.int64)
                    K.shard_answer_plain(recv, ranks[o], o * rps, out, **kw)
                else:
                    out = np.full(shape, SENTINEL, np.int64)
                    _model_answer(model, K, recv, ranks[o], o * rps, out,
                                  True, kw)
                    empty = recv.numpy() == -1
                    assert (out[empty] == SENTINEL).all()
                    assert (out[~empty] != SENTINEL).all()
                    out = T(out)
                outs.append(out)
            backs[tag] = [torch.cat([x[r * cap: (r + 1) * cap] for x in outs])
                          for r in range(D)]
        for r in range(D):
            took = slots[r][slots[r] >= 0].long()
            assert took.numel() > 0
            assert torch.equal(backs["model"][r][took],
                               backs["plain"][r][took])
            got = [fm.by_slot(backs[t][r], slots[r]) for t in backs]
            assert torch.equal(got[0], got[1])
            if sa:
                continue
            x, res = per[r], []
            for t in backs:
                # a block's first step, over the flags
                lanes = K.LaneList(*K.lane_list(x["live"].numel(), "cpu"), 0,
                                   True, 0)
                if q == "ext":
                    st = [x["live"].clone(), x["k"].clone(), x["l"].clone(),
                          x["m"].clone()]
                    K.shard_ext_step_plain(st, x["pos_f"], x["b_lane"], rd,
                                           ranks[r], meta, backs[t][r],
                                           slots[r], lanes=lanes)
                else:
                    st = [x["live"].clone(), x["rows"].clone(),
                          torch.zeros(n, dtype=torch.int64)]
                    K.shard_walk_step_plain(st, ranks[r], meta, backs[t][r],
                                            slots[r], lanes=lanes)
                res.append(st)
            for a, b in zip(*res):
                assert torch.equal(a, b)
        # the all-gather route: every rank's queries to every rank, the
        # slots this rank does not own written as zeros
        recv = torch.cat([torch.where(ask, blk, -1) for blk, ask in (
            K._query_blocks(live, k, l, meta, sa) for live, k, l in qargs)])
        for o in range(D):
            shape = (recv.numel(),) + (() if sa else (12,))
            want = torch.empty(shape, dtype=torch.int64)
            K.shard_answer_plain(recv, ranks[o], o * rps, want, **kw)
            out = np.full(shape, SENTINEL, np.int64)
            _model_answer(model, K, recv, ranks[o], o * rps, out, False, kw)
            np.testing.assert_array_equal(out, want.numpy())


def _model_answer(model, K, recv, arrs, base, out, routed, kw):
    """The answer kernel's model into ``out`` (numpy, in place)."""
    if kw:
        st = arrs["sa_samp"].numpy()
        model.shard_answer_kernel(recv.numpy(), st, None, len(st), base,
                                  True, out, routed, 1)
        return
    fused, a, b = K.rank_stripes(arrs)
    model.shard_answer_kernel(recv.numpy(), a.numpy(),
                              None if b is None else b.numpy(), a.shape[0],
                              base, fused, out, routed)


def _smoke_bucket_call(kind):
    """A recorded shard_bucket call as chip_smoke.record_shard keeps it
    ((live, k, l, meta, rps, D, cap, send, slot, counts, over), kw), at
    D = 1 over _bucket_case's queries, with shard_cap's cap."""
    import torch

    from lordfast_tpu_torch.ops import fm_index as fm

    (live, k, l, sl, pr, rps, _, _, _, ids), _ = _bucket_case(1, kind, "fit")
    Q = 2 * len(live) if l is not None else len(live)
    cap = fm.shard_cap(Q, 1)
    T = torch.from_numpy
    meta = None if ids else {"seq_len": sl, "primary": pr}
    args = (T(live), T(k), None if l is None else T(l), meta, rps, 1, cap,
            torch.empty(cap, dtype=torch.int64),
            torch.empty(Q, dtype=torch.int32),
            torch.empty(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))
    return args, {"ids": True} if ids else {}


@pytest.mark.parametrize("kind", ["ext", "walk", "ids"])
def test_smoke_bucket_check_is_bit_for_bit(kind):
    # chip_smoke._bucket_check holds the kernel to the plain version bit
    # for bit at the recorded D and at D = 2, 3 and 8, each with a cap
    # that fits and one that overflows; a kernel whose slots keep each
    # bucket's queries but not their query order (an atomics-order kernel's
    # freedom) fails it
    import torch

    import chip_smoke
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    args, kw = _smoke_bucket_call(kind)
    asked, done, over = chip_smoke._bucket_check(args, kw, K.shard_bucket,
                                                 K.shard_bucket_plain)
    assert asked > 0 and done == 8 and over >= 4

    def reversed_buckets(live, k, l, meta, rps, D, cap, send, slot, counts,
                         over, ids=False):
        K.shard_bucket_plain(live, k, l, meta, rps, D, cap, send, slot,
                             counts, over, ids)
        took = slot >= 0
        s = slot[took].long()
        o = s // cap
        m = counts.long().clamp(max=cap)[o]
        new = o * cap + (m - 1 - (s - o * cap))
        sent = send.clone()
        send[new] = sent[s]
        slot[took] = new.to(slot.dtype)

    with pytest.raises(AssertionError, match="differs from the plain"):
        chip_smoke._bucket_check(args, kw, reversed_buckets,
                                 K.shard_bucket_plain)


@pytest.mark.parametrize("fault", ["none", "taken slot", "all-gather zeros"])
def test_smoke_answer_check(fault):
    # chip_smoke._answer_check: the routed answer equal at every taken
    # slot, the all-gather answer over the whole buffer; a kernel that
    # writes a wrong value at a taken slot, or leaves an empty slot
    # unwritten on the all-gather route, fails it
    import torch

    import chip_smoke
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    rng = np.random.default_rng(5)
    arrs = {"fm_blocks": torch.from_numpy(rng.integers(0, 2**32, (8, 12))),
            "L2": torch.zeros(5, dtype=torch.int64)}
    recv = torch.tensor([-1, 9, 3, -1, 2, 12, 9, -1])

    def kern(recv, arrs, base, out, routed=False):
        keep = out.clone()
        K.shard_answer_plain(recv, arrs, base, out)
        if fault == "taken slot":
            out[1, 5] += 1
        elif routed or fault == "all-gather zeros":
            out[recv == -1] = keep[recv == -1]

    dst = torch.zeros((8, 12), dtype=torch.int64)
    if fault == "none":
        got, figs = chip_smoke._answer_check(kern, K.shard_answer_plain,
                                             recv, arrs, 2, dst, {})
        assert figs == {"slots": 8, "empty": 3}
        assert (got[recv == -1] == chip_smoke.SENTINEL).all()
        return
    with pytest.raises(AssertionError, match="shard_answer"):
        chip_smoke._answer_check(kern, K.shard_answer_plain, recv, arrs, 2,
                                 dst, {})


def test_bucket_model_sizes_are_the_kernels():
    # the model's and the wrapper's tile and owner limit are the ones
    # csrc/seed_shard.cu compiles (the wrapper sizes the look-back words
    # by the tile; the kernel refuses fewer)
    import re
    from pathlib import Path

    import torch_shard_model as model
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    src = (Path(K.__file__).resolve().parent.parent / "csrc"
           / "seed_shard.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int(?:64_t)? (k\w+) = (\d+);", src)}
    assert const["kBucketThreads"] == model.kBucketThreads
    assert const["kItems"] == model.kItems
    assert const["kMaxOwners"] == model.kMaxOwners == K.MAX_OWNERS
    assert model.kTile == K.BUCKET_TILE
    assert const["kThreads"] == K.STEP_THREADS


# ---- seed_shard.cu's step kernels over a compacted list of live lanes:
# the model (names as in the source) against the plain steps ----

@pytest.mark.parametrize("pos64", [False, True])
@pytest.mark.parametrize("kind", ["ext", "walk"])
def test_list_step_order_does_not_matter(kind, pos64):
    # a block's first step over the flags and its list step over the list
    # the first wrote (in an order drawn at random) give the plain steps'
    # lane state, counter ring and list (as a set), and so does the list
    # step over the same list reversed or shuffled: each lane's step is
    # its own.  A third of 3000 lanes live, rows and intervals at int32
    # positions or at and above 2^31 (the int64 index's)
    import torch_shard_model as model
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    rng = np.random.default_rng([len(kind), pos64])
    seq_len = 2**33 + 12345 if pos64 else 2**30 + 777
    case = model.step_case(rng, kind, 3000, seq_len, 0.3, pos64)
    name = f"shard_{kind}_step"
    plain = getattr(K, name + "_plain")
    saved = model.install(K, np.random.default_rng(3))
    try:
        out = model.list_steps(K, getattr(K, name), plain, case, kind, "cpu",
                               np.random.default_rng(4))
    finally:
        (K.shard_bucket, K.shard_answer, K.shard_ext_step,
         K.shard_walk_step) = saved
    for tag in ("first", "list", "list reversed", "list shuffled"):
        want = out[tag.split()[0] + " plain"]
        for x, y in zip(out[tag][:-1], want[:-1]):
            assert x.equal(y), tag
        assert (out[tag][-1] is None) == (want[-1] is None), tag
        assert want[-1] is None or out[tag][-1].equal(want[-1]), tag
    live0 = int(case["state"][0].sum())
    kept, last = (int(out[t][0].sum()) for t in ("first plain",
                                                 "list plain"))
    assert 0 < last < kept < live0
    # the ring: step 4 reserved its live lanes' slots on count 1 and zeroed
    # count 2; step 5 reserved on count 2 and zeroed count 0; each list
    # holds the kept lanes and a -1 for each lane that died
    ring, lst, live = out["list plain"][-3:]
    assert ring.tolist() == [0, live0, kept]
    assert int(live[0]) == last == int((lst >= 0).sum())
    assert int((out["first plain"][-2] == -1).sum()) == live0 - kept


def test_step_floor_and_live_bands():
    # the smoke's step floor (an empty launch of the step's grid and two
    # dependent loads at the pointer chase's ns) and the live-share bands
    # its summed call times are split by
    import chip_smoke

    assert chip_smoke.step_floor(0.002, 266.7) == pytest.approx(
        0.002 + 2 * 266.7e-6)
    assert [chip_smoke.live_band(x, 1000) for x in (1000, 500, 499, 10, 9,
                                                    0)] == [
        ">=50%", ">=50%", "1-50%", "1-50%", "<1%", "<1%"]
    s = chip_smoke.band_sums([3.0, 2.0, 1.0, 0.5, 0.25], [800, 600, 30, 5, 0],
                             1000)
    assert s["launches"] == 5 and s["ms"] == pytest.approx(6.75)
    assert s["bands"] == {
        ">=50%": {"launches": 2, "ms": 5.0, "mean_ms": 2.5},
        "1-50%": {"launches": 1, "ms": 1.0, "mean_ms": 1.0},
        "<1%": {"launches": 2, "ms": 0.75, "mean_ms": 0.375}}
    with pytest.raises(AssertionError, match="launches traced"):
        chip_smoke.band_sums([1.0], [5, 4], 10)
    ev = [("void shard_bucket_kernel(a)", 1.0),
          ("void (anonymous namespace)::shard_walk_step_kernel<int>(x)", 2.0),
          ("ncclKernel", 9.0), ("void shard_answer_kernel(b)", 0.5),
          ("void (anonymous namespace)::shard_walk_step_kernel<int>(x)", 1.0)]
    c = chip_smoke.call_sums(ev, [50, 0], 100, "shard_walk_step")
    assert c["shard_bucket"] == {"launches": 1, "ms": 1.0}
    assert c["shard_answer"] == {"launches": 1, "ms": 0.5}
    assert c["shard_walk_step"]["bands"] == {
        ">=50%": {"launches": 1, "ms": 2.0, "mean_ms": 2.0},
        "<1%": {"launches": 1, "ms": 1.0, "mean_ms": 1.0}}


@pytest.mark.parametrize("n_live,n,first,want", [
    (700, 1000, True, 1000), (700, 1000, False, 700), (0, 1000, False, 1),
    (5000, 1000, False, 1000)])
def test_step_grid_covers_the_blocks_live_lanes(n_live, n, first, want):
    # a block's first step covers every lane's flag; a list step's grid
    # the group's live lanes at the block's start (at least one thread,
    # which zeroes the ring's next count), at most n
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    lists, ring = K.lane_list(n, "cpu")
    assert K.grid_lanes(n, K.LaneList(lists, ring, 7, first, n_live)) == want
    # step 7: reads list 0 and count 0, writes list 1 reserving on count
    # 1, zeroes count 2
    lanes = K.LaneList(lists, ring, 7, first, n_live)
    list_in, n_in, list_out, cnt, zero = K.lane_ring(lanes)
    assert (list_in is None) == first and (n_in is None) == first
    if not first:
        assert list_in.data_ptr() == lists[0].data_ptr()
        assert n_in.data_ptr() == ring[0:].data_ptr()
    assert list_out.data_ptr() == lists[1].data_ptr()
    assert cnt.data_ptr() == ring[1:].data_ptr()
    assert zero.data_ptr() == ring[2:].data_ptr()
    # the kernels' pointers (the wrappers' order: list_in, n_in, list_out,
    # n_out, live, zero) are the views' own
    import torch

    live = torch.zeros(1, dtype=torch.int32)
    ptrs, grid = K._lanes_ptrs(n, lanes, lists.data_ptr(), ring.data_ptr(),
                               live)
    views = K.lane_ring(lanes)
    assert ptrs == [None if v is None else v.data_ptr()
                    for v in views[:4] + (live, views[4])]
    assert grid == want


def test_step_wrappers_check_a_loops_tensors_once():
    # the step wrappers check their tensors on a loop's first step and
    # then match them by identity, pointer and size (fm_shard_cuda
    # _checked); any other tensor, size or pointer is checked again, and
    # a check that raises is made again on the next call
    import torch

    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    checks = []
    a = [torch.zeros(4), torch.zeros(3, dtype=torch.int32)]

    def run(ts, sizes, ok=True):
        def check():
            checks.append(1)
            if not ok:
                raise ValueError("refused")
        return K._checked("test_step", ts, sizes, check)

    assert run(a, (4,)) == [x.data_ptr() for x in a] and len(checks) == 1
    assert run(a, (4,)) == [x.data_ptr() for x in a] and len(checks) == 1
    b = [a[0].clone(), a[1]]
    run(b, (4,))
    assert len(checks) == 2
    run(b, (5,))
    assert len(checks) == 3
    b[0].set_(torch.zeros(8))  # the same tensor, its data moved
    run(b, (5,))
    assert len(checks) == 4
    for _ in range(2):
        with pytest.raises(ValueError, match="refused"):
            run(a, (4,), ok=False)
    assert len(checks) == 6
    K._last.pop("test_step")
