"""The port's CUDA kernels on the card: ``myers_dist`` (with and without
its last column), ``myers_moves`` and ``extend_batch_cuda`` against
their plain PyTorch versions (exact: every output is an integer), one
test per kind of bucket, the warp kernels' lane edges, and ``-a clasp``
through the engine on the card against the CPU; ``chain_dp`` against
the plain chaining DP (the float bits of dp, prev and every chain field;
both costs, both DP dtypes, both position dtypes; seed counts at the
kernel's 32-seed tile edges with planted exact ties, 1024 full windows
of 512 seeds, and dp-n2's penalty at every entry of its log table against
the C-double formula) and ``seed_ext`` against ``_staged_ext`` (every
lane's k, l, m, rpos, rflag; full and sampled SA, fused and split rank
rows; runs of its 16-char compare ending at every offset of a trip, at
an N, the read's end, the text's start and MAX_ANCHOR_LEN), ``sa_locate``
against ``sa_lookup`` (every row of a small genome's text and edge lanes
at sa_intv 2 to 64, both rank layouts, int32 and int64 sa_samp), and the
dispatch of ``chain_seeds`` and of the seeder to them; ``sa_locate``'s
lane queue below and beyond the lanes the card holds at once; the
sharded seeder on ``csrc/seed_shard.cu``'s kernels over a group of one
(NCCL) against its plain loops and the replicated seeder (every seed;
each kernel against its plain version on its first call, both layouts,
the SA full and at 32), and through the all-gather route with every
bucket's cap forced to 8; ``shard_bucket`` bit for bit against its plain
version at D = 1, 2, 3, 8 and 256 (and D = 257 refused), and
``shard_answer``'s routed route leaving the empty slots as they were.
Needs an
NVIDIA GPU (marker ``cuda``) and skips
without one.  This file imports neither jax nor lordfast_tpu, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lordfast_tpu_torch.config import LordfastConfig
from lordfast_tpu_torch.ops import (affine, affine_cuda, chain, chain_cuda,
                                    fm_index, fm_index_cuda, gap_dp,
                                    gap_dp_cuda)
from lordfast_tpu_torch.ops.gap_dp import myers_dist_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _gaps(rng, Q, T, G):
    """G gaps: related pairs (a mutated copy of the query as target),
    ql at word boundaries, ql = 1, tl = 1, NW and SHW mixed."""
    qs = np.full((G, Q), 4, np.uint8)
    ts = np.zeros((G, T), np.uint8)
    ql = rng.integers(1, Q + 1, G).astype(np.int32)
    tl = rng.integers(1, T + 1, G).astype(np.int32)
    edge = [(s, 1 + s % T) for s in (1, 31, 32, 33, 63, 64, 65) if s <= Q]
    for i, (a, b) in enumerate(edge[:G]):
        ql[i], tl[i] = a, b
    for g in range(G):
        q = rng.integers(0, 4, ql[g]).astype(np.uint8)
        t = np.resize(q, tl[g]).copy()
        sites = rng.integers(0, tl[g], max(1, tl[g] // 8))
        t[sites] = rng.integers(0, 4, len(sites))
        qs[g, : ql[g]] = q
        ts[g, : tl[g]] = t
    return qs, ql, ts, tl, rng.integers(0, 2, G).astype(bool)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [(32, 48, 8192), (64, 2304, 512),
                                    (512, 576, 1024), (2048, 2176, 64),
                                    (4096, 4352, 32)])
def test_cuda_kernel_matches_plain(cuda_device, bucket):
    Q, T, G = bucket
    arrays = _gaps(np.random.default_rng(Q + T), Q, T, min(G, 300))
    cpu = [torch.from_numpy(a) for a in arrays]
    want_d, want_e = myers_dist_plain(*cpu, Q, T)
    before = gap_dp_cuda.myers_dist.launches
    d, e = gap_dp_cuda.myers_dist(*(a.to(cuda_device) for a in cpu), Q, T)
    torch.cuda.synchronize()
    assert gap_dp_cuda.myers_dist.launches == before + 1
    np.testing.assert_array_equal(d.cpu().numpy(), want_d.numpy())
    np.testing.assert_array_equal(e.cpu().numpy(), want_e.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [(64, 2304, 512), (2048, 2176, 64),
                                    (4096, 4352, 32)])
def test_cuda_dist_column_matches_plain(cuda_device, bucket):
    # the last column's words, edlib's Hirschberg split reads them
    Q, T, G = bucket
    arrays = _gaps(np.random.default_rng(Q + 5 * T), Q, T, min(G, 200))
    arrays[4][:] = False  # NW, as the split's fills are
    cpu = [torch.from_numpy(a) for a in arrays]
    want = myers_dist_plain(*cpu, Q, T, want_col=True)
    got = gap_dp_cuda.myers_dist(*(a.to(cuda_device) for a in cpu), Q, T,
                                 want_col=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("dist", "end", "col"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [(32, 48, 8192), (128, 1152, 512),
                                    (512, 576, 1024), (2048, 2176, 64),
                                    (4096, 4352, 32)])
def test_cuda_moves_kernel_matches_plain(cuda_device, bucket):
    Q, T, G = bucket
    arrays = _gaps(np.random.default_rng(Q + 3 * T), Q, T, min(G, 200))
    cpu = [torch.from_numpy(a) for a in arrays]
    want = gap_dp.myers_moves_plain(*cpu, Q, T)
    before = gap_dp_cuda.myers_moves.launches
    got = gap_dp_cuda.myers_moves(*(a.to(cuda_device) for a in cpu), Q, T)
    torch.cuda.synchronize()
    assert gap_dp_cuda.myers_moves.launches == before + 1
    for name, g, w in zip(("dist", "end", "lead", "colcode"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)
    d, e = gap_dp_cuda.myers_dist(*(a.to(cuda_device) for a in cpu), Q, T)
    np.testing.assert_array_equal(d.cpu().numpy(), want[0].numpy())
    np.testing.assert_array_equal(e.cpu().numpy(), want[1].numpy())


def _lane_edge_gaps(rng, Q, T):
    """Gaps for a wide bucket (one warp per gap): ql at every lane
    boundary of the bottom word (32 K l - 1, 32 K l, 32 K l + 1, K =
    ceil(W / 32) words a lane), 1, Q, and 64-row multiples +- 1 (the W64
    term); tl = 1, 2, shorter than the 32-lane skew, and T."""
    W = Q // 32
    K = -(-W // 32)
    qls = [1, Q, Q - 1, 63, 65]
    for lane in range(1, min(W // K, 32)):
        qls += [32 * K * lane - 1, 32 * K * lane, 32 * K * lane + 1]
    tl_cycle = [1, 5, 31, 33, T, T - 7, 17, 2]
    G = len(qls)
    qs = np.full((G, Q), 4, np.uint8)
    ts = np.zeros((G, T), np.uint8)
    ql = np.array(qls, np.int32)
    tl = np.array([tl_cycle[i % 8] for i in range(G)], np.int32)
    for g in range(G):
        q = rng.integers(0, 4, ql[g]).astype(np.uint8)
        t = (rng.integers(0, 4, tl[g]) if g % 3 == 2
             else np.resize(q, tl[g]).copy())
        qs[g, : ql[g]] = q
        ts[g, : tl[g]] = t
    return qs, ql, ts, tl, (np.arange(G) % 2 == 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [(512, 576), (2048, 2176), (4096, 4352)])
def test_cuda_warp_kernel_lane_edges(cuda_device, bucket):
    # the warp-per-gap kernel: bw at each lane boundary, tl below the
    # skew, SHW ties and the W64 term; dist, the last column and the path
    Q, T = bucket
    arrays = _lane_edge_gaps(np.random.default_rng(Q), Q, T)
    cpu = [torch.from_numpy(a) for a in arrays]
    gpu = [a.to(cuda_device) for a in cpu]
    want = myers_dist_plain(*cpu, Q, T, want_col=True)
    got = gap_dp_cuda.myers_dist(*gpu, Q, T, want_col=True)
    want_mv = gap_dp.myers_moves_plain(*cpu, Q, T)
    got_mv = gap_dp_cuda.myers_moves(*gpu, Q, T)
    torch.cuda.synchronize()
    for name, g, w in zip(("dist", "end", "col", "dist", "end", "lead",
                           "colcode"), got + got_mv, want + want_mv):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


def _affine_problems(rng, Qe, Te, G):
    """G extension problems: related pairs (a mutated copy), junk pairs
    (z-drop), N codes, qlen near Qe; clip and split parameter sets."""
    qs = np.zeros((G, Qe), np.uint8)
    ts = np.zeros((G, Te), np.uint8)
    qlen = rng.integers(1, Qe + 1, G).astype(np.int32)
    qlen[: min(G, 4)] = [Qe, Qe - 1, 1, 2][: min(G, 4)]
    tlen = np.minimum(Te, qlen + rng.integers(-20, 40, G)).clip(1)
    tlen = tlen.astype(np.int32)
    for g in range(G):
        q = rng.integers(0, 4, qlen[g]).astype(np.uint8)
        if g % 3 == 2:   # junk pair
            t = rng.integers(0, 5, tlen[g]).astype(np.uint8)
        else:
            t = np.resize(q, tlen[g]).copy()
            sites = rng.integers(0, tlen[g], max(1, tlen[g] // 7))
            t[sites] = rng.integers(0, 5, len(sites))
        qs[g, : qlen[g]] = q
        ts[g, : tlen[g]] = t
    split = rng.integers(0, 2, G).astype(bool)
    sel = lambda a, b: np.where(split, b, a).astype(np.int32)
    od, ed_, oi, ei = sel(0, 8), sel(1, 1), sel(0, 4), sel(1, 1)
    w = sel(40, 100)
    params = dict(qlen=qlen, tlen=tlen, o_del=od, e_del=ed_, o_ins=oi,
                  e_ins=ei, w_eff=affine.clamp_band(qlen, 2, 0, od, ed_, oi,
                                                    ei, w),
                  zdrop=sel(40, 200), h0=qlen.copy(),
                  match=np.full(G, 2, np.int32),
                  mismatch=np.full(G, 16, np.int32))
    return qs, ts, params


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [(512, 544, 128), (2048, 2080, 128),
                                    (8192, 8224, 128)])
def test_cuda_affine_kernel_matches_plain(cuda_device, bucket):
    Qe, Te, G = bucket
    qs, ts, params = _affine_problems(np.random.default_rng(Qe), Qe, Te,
                                      min(G, 48))
    cpu = {k: torch.from_numpy(v) for k, v in params.items()}
    want = affine.extend_batch_plain(torch.from_numpy(qs),
                                     torch.from_numpy(ts), Qe, Te, 256, 100,
                                     **cpu)
    before = affine_cuda.extend_batch_cuda.launches
    got = affine.extend_batch(
        torch.from_numpy(qs).to(cuda_device),
        torch.from_numpy(ts).to(cuda_device), Qe, Te, 256, 100,
        **{k: v.to(cuda_device) for k, v in cpu.items()})
    torch.cuda.synchronize()
    assert affine_cuda.extend_batch_cuda.launches == before + 1
    for name, g, w in zip(affine.ExtendResult._fields, got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("w_max", [15, 40, 100])
def test_cuda_affine_lane_edges(cuda_device, w_max):
    # K = 1, 3 and 7 slots a lane: w_eff on lane edges, the clip and split
    # bands capped at w_max in one launch, tlen = 0 and 1
    Qe, Te = 512, 544
    qs, ts, params = chip_smoke.make_affine_edges(
        np.random.default_rng(7 * w_max), Qe, Te, w_max)
    cpu = {k: torch.from_numpy(v) for k, v in params.items()}
    want = affine.extend_batch_plain(torch.from_numpy(qs),
                                     torch.from_numpy(ts), Qe, Te, 256, w_max,
                                     **cpu)
    got = affine.extend_batch(
        torch.from_numpy(qs).to(cuda_device),
        torch.from_numpy(ts).to(cuda_device), Qe, Te, 256, w_max,
        **{k: v.to(cuda_device) for k, v in cpu.items()})
    torch.cuda.synchronize()
    for name, g, w in zip(affine.ExtendResult._fields, got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


@pytest.mark.cuda
def test_cuda_affine_rejects_wide_band(cuda_device):
    # the band holds at most 8 slots a lane: w_max <= 126
    qs, ts, params = _affine_problems(np.random.default_rng(3), 64, 96, 4)
    args = [torch.from_numpy(a).to(cuda_device) for a in (qs, ts)]
    kw = {k: torch.from_numpy(v).to(cuda_device) for k, v in params.items()}
    before = affine_cuda.extend_batch_cuda.launches
    for w_max in (127, 200, -1):
        with pytest.raises(ValueError):
            affine_cuda.extend_batch_cuda(*args, 64, 96, w_max, **kw)
    got = affine_cuda.extend_batch_cuda(*args, 64, 96, 126, **kw)
    torch.cuda.synchronize()
    assert affine_cuda.extend_batch_cuda.launches == before + 1
    want = affine.extend_batch_plain(torch.from_numpy(qs),
                                     torch.from_numpy(ts), 64, 96, 256, 126,
                                     **{k: torch.from_numpy(v)
                                        for k, v in params.items()})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    qs = torch.zeros((4, 32), dtype=torch.uint8, device=cuda_device)
    ts = torch.zeros((4, 48), dtype=torch.uint8, device=cuda_device)
    n = torch.ones(4, dtype=torch.int32, device=cuda_device)
    shw = torch.zeros(4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        gap_dp_cuda.myers_dist(qs, n.long(), ts, n, shw, 32, 48)
    with pytest.raises(ValueError):
        gap_dp_cuda.myers_dist(qs, n, ts, n, shw, 96, 48)
    with pytest.raises(ValueError):
        gap_dp_cuda.myers_dist(qs, n, ts.cpu(), n, shw, 32, 48)
    # rows must start on 16-byte boundaries
    buf = torch.zeros(4 * 48 + 8, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        gap_dp_cuda.myers_dist(qs, n, buf[8:].view(4, 48), n, shw, 32, 48)
    with pytest.raises(ValueError):
        gap_dp_cuda.myers_dist(qs, n, buf[:160].view(4, 40), n, shw, 32, 40)


@pytest.mark.cuda
def test_cuda_clasp_engine_matches_cpu(cuda_device):
    """-a clasp through the engine on the golden fixture: cuda (the
    escalation offload on) gives the CPU's SAM, and the kernels ran."""
    import io

    from lordfast_tpu_torch.config import LordfastConfig
    from lordfast_tpu_torch.index.builder import build_index
    from lordfast_tpu_torch.pipeline.engine import MappingEngine

    cfg = LordfastConfig(**chip_smoke.GOLDEN_CFG, chain_alg="clasp")
    idx = build_index(chip_smoke.DATA / "ref.fa",
                      LordfastConfig(kmer_cache_k=8), verbose=False)
    sams = {}
    chip_smoke.reset_launches()
    for dev in ("cpu", cuda_device):
        out = io.StringIO()
        MappingEngine(idx, cfg, device=dev).map_file(
            chip_smoke.DATA / "reads.fq", out, "clasp")
        sams[str(dev)] = chip_smoke.sam_records(out.getvalue())
    launches = chip_smoke.read_launches()
    assert len(sams["cpu"]) == 78
    assert sams["cuda"] == sams["cpu"]
    assert launches["myers_dist"] > 0 and launches["affine_extend"] > 0


def _ws(arrays, device):
    q, t, ln, va = arrays
    n = va.sum(-1).astype(np.int32)
    return chain.WindowSeeds(*(torch.from_numpy(np.ascontiguousarray(a)).to(
        device) for a in (q, t, ln, va, n)))


@pytest.mark.cuda
@pytest.mark.parametrize("alg,N,pos,dtype", [
    ("dpn2", 512, "int64", "auto"), ("clasp", 512, "int64", "auto"),
    ("dpn2", 64, "int32", "auto"), ("dpn2", 64, "int64", "f32"),
    ("clasp", 64, "int32", "f32")])
def test_cuda_chain_dp_matches_plain(cuda_device, alg, N, pos, dtype):
    # random windows with empty and full ones, repeated seeds (exact
    # ties) and, with int64 positions, t differences that wrap int32
    rng = np.random.default_rng(N + len(alg) + len(dtype))
    W = 64
    counts = [0, 1, N, 2] + [int(c) for c in rng.integers(0, N + 1, W - 4)]
    q, t, ln, va = chip_smoke.make_windows(rng, W, N, counts,
                                           wrap=pos == "int64")
    ws = _ws((q, t.astype(pos), ln, va), cuda_device)
    cfg = LordfastConfig(chain_alg=alg, max_chain_seeds=N,
                         chain_dp_dtype=dtype)
    before = chain_cuda.chain_dp.launches
    chip_smoke.check_chain_dp(ws, cfg)
    torch.cuda.synchronize()
    assert chain_cuda.chain_dp.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("alg,N,dtype", [
    ("dpn2", 64, "auto"), ("dpn2", 66, "auto"), ("clasp", 100, "auto"),
    ("dpn2", 128, "f32"), ("clasp", 128, "f32"), ("dpn2", 512, "auto"),
    ("clasp", 512, "auto")])
def test_cuda_chain_dp_tile_edges(cuda_device, alg, N, dtype):
    # counts at the tile edges with planted exact ties and int32 wraps
    # (chip_smoke.edge_windows); N = 66 and 100 take the kernel's
    # flag loads one at a time, 66 its output stores one at a time too
    rng = np.random.default_rng(N + len(alg) + len(dtype))
    q, t, ln, va = chip_smoke.edge_windows(rng, N)
    ws = _ws((q, t, ln, va), cuda_device)
    cfg = LordfastConfig(chain_alg=alg, max_chain_seeds=N,
                         chain_dp_dtype=dtype)
    chip_smoke.check_chain_dp(ws, cfg)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("penalty", [11.4, 100.0])
def test_cuda_chain_dp_log_table(cuda_device, penalty):
    # dp-n2's penalty in the kernel at every entry of the log table
    # (chip_smoke.log_windows: one linked pair of each d = 0 .. 3 x
    # seq_max_length - 1, 9,170 and 19,143 among them): the dp bits equal
    # the C-double formula's with the C library's log and the plain
    # version's on the card; no log is computed on the card
    cfg = LordfastConfig(max_chain_seeds=2, chain_penalty=penalty)
    ds = np.arange(chain.log_table_len(cfg))
    ws = _ws(chip_smoke.log_windows(ds), cuda_device)
    chip_smoke.check_chain_dp(ws, cfg)
    _, dp, prev = chain_cuda.chain_dp(ws, cfg, want_dp=True)
    want = np.array(chip_smoke.log_window_dp(ds, cfg))
    np.testing.assert_array_equal(dp[:, 1].cpu().numpy().view(np.int64),
                                  want.view(np.int64))
    assert bool((prev[:, 1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["last", "past"])
def test_cuda_chain_dp_log_table_edge(cuda_device, where):
    # a linked pair at the log table's last entry links; one past it
    # stops the kernel with a trap, which the synchronize raises (in a
    # process of its own: a trap ends the process's CUDA context)
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    d = chain.log_table_len(LordfastConfig()) - (where == "last")
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import numpy as np, torch, chip_smoke\n"
        "from lordfast_tpu_torch.config import LordfastConfig\n"
        "from lordfast_tpu_torch.ops import chain, chain_cuda\n"
        f"a = chip_smoke.log_windows(np.array([{d}]))\n"
        "ws = chain.WindowSeeds(*(torch.from_numpy(x).cuda() for x in "
        "(*a, a[3].sum(-1).astype(np.int32))))\n"
        "_, dp, _ = chain_cuda.chain_dp(ws, LordfastConfig("
        "max_chain_seeds=2), want_dp=True)\n"
        "torch.cuda.synchronize()\n"
        "print(repr(float(dp[0, 1])))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    if where == "last":
        assert r.returncode == 0, r.stderr[-2000:]
        want = chip_smoke.log_window_dp([d], LordfastConfig())[0]
        assert float(r.stdout.split()[-1]) == want
    else:
        assert r.returncode != 0 and "Error" in r.stderr, r.stderr[-2000:]


@pytest.mark.cuda
def test_cuda_chain_dp_full_windows(cuda_device):
    # 1024 windows x 512 slots, every slot a seed, both costs
    out = chip_smoke.phase_full_windows(chip_smoke.INT32_LANES * 1.98e9)
    assert out["full_windows_ms"] > 0


@pytest.mark.cuda
def test_cuda_chain_seeds_uses_the_kernel(cuda_device):
    rng = np.random.default_rng(8)
    arrays = chip_smoke.make_windows(rng, 40, 512, [int(c) for c in
                                                    rng.integers(0, 200, 40)])
    ws = _ws(arrays, cuda_device)
    cfg = LordfastConfig()
    chip_smoke.reset_launches()
    got = chain.chain_seeds(ws, cfg)
    counts = chip_smoke.read_launches()
    assert counts["chain_dp"] == 1 and counts["_chain_bucketed"] == 0
    want = chain.chain_seeds(ws, cfg, plain=True)
    counts = chip_smoke.read_launches()
    assert counts["chain_dp"] == 1 and counts["_chain_bucketed"] == 1
    for name in chain.ChainBatch._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A 30 kb random genome (two contigs) and 8 noisy reads of it."""
    rng = np.random.default_rng(29)
    codes = rng.integers(0, 4, 30000)
    path = tmp_path_factory.mktemp("genome") / "g.fa"
    seq = "".join("ACGT"[c] for c in codes)
    path.write_text(f">a\n{seq[:17000]}\n>b\n{seq[17000:]}\n")
    reads = np.full((8, 2000), 4, np.uint8)
    lens = np.zeros(8, np.int32)
    for b in range(8):
        n = int(rng.integers(1000, 2000))
        st = int(rng.integers(0, 30000 - n))
        frag = codes[st : st + n].astype(np.uint8)
        if b % 2:
            frag = (3 - frag[::-1]).astype(np.uint8)
        sites = rng.integers(0, n, n // 12)
        frag[sites] = rng.integers(0, 4, len(sites))
        if b % 3 == 0:
            frag[rng.integers(0, n)] = 4
        reads[b, :n], lens[b] = frag, n
    return path, reads, lens


@pytest.mark.cuda
@pytest.mark.parametrize("sa_interval,layout", [
    (1, "fused"), (1, "split"), (32, "fused"), (32, "split")])
def test_cuda_seed_ext_matches_plain(cuda_device, genome, sa_interval,
                                     layout):
    from lordfast_tpu_torch.index.builder import build_index

    path, reads, lens = genome
    idx = build_index(path, LordfastConfig(kmer_cache_k=6,
                                           sa_interval=sa_interval),
                      verbose=False)
    assert idx.sa_intv == sa_interval
    arrs = idx.device_arrays(cuda_device)
    if layout == "split":
        arrs = chip_smoke.split_layout(idx, arrs)
    cfg = LordfastConfig(kmer_cache_k=6, sampling_count=200,
                         seed_phase1_steps=3)
    r = torch.from_numpy(reads).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    rec = chip_smoke.seed_lanes(arrs, idx.meta, r, n, cfg)
    stats, _ = chip_smoke.check_seed_ext(rec)
    assert stats[:, 2].sum() > 0 and (sa_interval == 1
                                      or stats[:, 1].sum() > 0)
    # the seeds, through the kernel and through the plain loops
    pos = torch.from_numpy(fm_index.sample_positions_host(
        lens, cfg.sampling_count)).to(cuda_device)
    args = (arrs, r, n, pos, idx.meta, cfg.sampling_count,
            cfg.min_anchor_len, cfg.max_ref_hits, cfg.max_seeds_per_read,
            cfg.seed_phase1_steps)
    chip_smoke.reset_launches()
    got = fm_index._seed_anchors_impl(*args)
    want = fm_index._seed_anchors_impl(*args, plain=True)
    counts = chip_smoke.read_launches()
    assert counts["seed_ext"] == 1 and counts["_staged_ext"] == 1
    for name in fm_index.SeedBatch._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("sa_interval,layout", [
    (1, "fused"), (1, "split"), (32, "fused"), (32, "split")])
def test_cuda_seed_ext_word_compare_edges(cuda_device, genome, sa_interval,
                                          layout):
    # runs of the finish ending at every offset of a 16-char trip, at an
    # N, the read's end, the text's start and MAX_ANCHOR_LEN
    # (chip_smoke.edge_reads)
    from lordfast_tpu_torch.index.builder import build_index

    path, _, _ = genome
    idx = build_index(path, LordfastConfig(kmer_cache_k=6,
                                           sa_interval=sa_interval),
                      verbose=False)
    arrs = idx.device_arrays(cuda_device)
    if layout == "split":
        arrs = chip_smoke.split_layout(idx, arrs)
    reads, lens, kinds, e, lanes = chip_smoke.edge_reads(
        np.random.default_rng(13), chip_smoke.text_of(arrs, idx.meta),
        idx.meta["seq_len"])
    rd = fm_index._Reads(torch.from_numpy(reads).to(cuda_device),
                         torch.from_numpy(lens).to(cuda_device))
    rec = dict(arrs=arrs, meta=idx.meta, rd=rd, phase1_steps=3,
               lanes=[torch.from_numpy(x).to(cuda_device) for x in lanes])
    stats, _ = chip_smoke.check_seed_ext(rec)
    assert stats[:, 3].sum() > 0 and (stats[:, 2] >= 4095 - 16).any()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["fused", "split"])
def test_cuda_seed_ext_need_counts_each_piece_once(cuda_device, genome,
                                                   layout):
    # the kernel's need bitmap (seed_ext's bound): every lane twice needs
    # the same pieces; the whole needs no more than its halves apart and
    # no less than either; each kind within what the steps read
    from lordfast_tpu_torch.index.builder import build_index

    path, reads, lens = genome
    idx = build_index(path, LordfastConfig(kmer_cache_k=6, sa_interval=32),
                      verbose=False)
    arrs = idx.device_arrays(cuda_device)
    if layout == "split":
        arrs = chip_smoke.split_layout(idx, arrs)
    cfg = LordfastConfig(kmer_cache_k=6, sampling_count=200,
                         seed_phase1_steps=3)
    rec = chip_smoke.seed_lanes(arrs, idx.meta,
                                torch.from_numpy(reads).to(cuda_device),
                                torch.from_numpy(lens).to(cuda_device), cfg)
    stats, need = chip_smoke.check_seed_ext(rec)
    n = stats[:, :4].astype(np.int64).sum(0)
    assert 0 < need["rank"] <= 80 * (2 * n[0] + n[1])
    assert 0 < need["sa"] <= arrs["sa_samp"].element_size() * len(stats)
    assert 0 < need["pac"] <= 16 * n[3]
    assert 0 < need["rw"] <= 8 * (n[0] + 2 * n[3])
    twice, need2 = chip_smoke.check_seed_ext(
        dict(rec, lanes=[torch.cat([x, x]) for x in rec["lanes"]]))
    assert need2 == need
    np.testing.assert_array_equal(twice[:, :4],
                                  np.concatenate([stats, stats])[:, :4])
    h = len(stats) // 2
    halves = [chip_smoke.check_seed_ext(
        dict(rec, lanes=[x[s] for x in rec["lanes"]]))[1]
        for s in (slice(0, h), slice(h, None))]
    for k in need:
        assert max(halves[0][k], halves[1][k]) <= need[k] \
            <= halves[0][k] + halves[1][k]


@pytest.mark.cuda
def test_cuda_loop_wrappers_reject_bad_inputs(cuda_device, genome):
    from lordfast_tpu_torch.index.builder import build_index

    arrays = chip_smoke.make_windows(np.random.default_rng(1), 4, 64,
                                     [3, 0, 64, 9])
    ws = _ws(arrays, cuda_device)
    cfg = LordfastConfig(max_chain_seeds=64)
    with pytest.raises(TypeError):
        chain_cuda.chain_dp(ws._replace(q_pos=ws.q_pos.long()), cfg)
    with pytest.raises(ValueError):
        chain_cuda.chain_dp(ws._replace(valid=ws.valid.cpu()), cfg)
    wide = _ws(chip_smoke.make_windows(np.random.default_rng(2), 1,
                                       chain_cuda.MAX_N + 1, [3]),
               cuda_device)
    with pytest.raises(ValueError):
        chain_cuda.chain_dp(wide, cfg)
    # dp-n2 without a log table, or with one shorter than 2 entries:
    # refused; the table's length is the caller's (chain.log_table)
    q, t, ln, ok = ws[:4]
    outs = [torch.empty_like(x) for x in (q, t, ln)] + [
        torch.empty(4, dtype=d, device=cuda_device)
        for d in (torch.int32, torch.float32)]
    table = chain.log_table(chain.log_table_len(cfg), cuda_device,
                            torch.float64)
    for ptr, n_table, rc in ((table.data_ptr(), 1, 1), (None, 1000, 1),
                             (table.data_ptr(), 1000, 0),
                             (table.data_ptr(), table.shape[0], 0)):
        assert chain_cuda._fn()(
            *(x.data_ptr() for x in (q, t, ln, ok, *outs)), None, None,
            ptr, n_table, 4, 64, t.element_size(), 1, 0, 1.0,
            1.0, 1.0, 1.0, None) == rc  # 1: cudaErrorInvalidValue
    torch.cuda.synchronize()
    path, reads, lens = genome
    idx = build_index(path, LordfastConfig(kmer_cache_k=6), verbose=False)
    arrs = idx.device_arrays(cuda_device)
    r = torch.from_numpy(reads).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    rec = chip_smoke.seed_lanes(arrs, idx.meta, r, n,
                                LordfastConfig(kmer_cache_k=6))
    lanes, rd = rec["lanes"], rec["rd"]
    before = fm_index_cuda.seed_ext.launches
    with pytest.raises(TypeError):
        fm_index_cuda.seed_ext(arrs, idx.meta, rd, lanes[0],
                               lanes[1].int(), *lanes[2:], 6)
    with pytest.raises(ValueError):
        fm_index_cuda.seed_ext(arrs, idx.meta, rd, *lanes, 0)
    with pytest.raises(ValueError):  # one diagnostic a launch
        fm_index_cuda.seed_ext(arrs, idx.meta, rd, *lanes, 6,
                               want_stats=True, want_need=True)
    with pytest.raises(ValueError):
        fm_index_cuda.seed_ext(arrs, dict(idx.meta, sa_intv=3), rd,
                               *lanes, 6)
    bad = fm_index._Reads(r, n)
    bad.lens = bad.lens.int()
    with pytest.raises(TypeError):
        fm_index_cuda.seed_ext(arrs, idx.meta, bad, *lanes, 6)
    with pytest.raises(ValueError):  # rank rows off a 16-byte boundary
        fm_index_cuda.seed_ext(
            dict(arrs, fm_blocks=arrs["fm_blocks"].reshape(-1)[1:-11]
                 .reshape(-1, 12)), idx.meta, rd, *lanes, 6)
    assert fm_index_cuda.seed_ext.launches == before


def _sampled(path, sa_interval, device):
    """The genome's index with the full SA sliced to sa_interval
    (chip_smoke.slice_sa), its arrays on device, and the full SA."""
    from lordfast_tpu_torch.index.builder import build_index

    full = build_index(path, LordfastConfig(kmer_cache_k=6, sa_interval=1),
                       verbose=False)
    idx = chip_smoke.slice_sa(full, sa_interval)
    return idx, idx.device_arrays(device), full.sa_samp


@pytest.mark.cuda
@pytest.mark.parametrize("sa_interval", [2, 4, 16, 32, 64])
def test_cuda_sa_locate_matches_plain(cuda_device, genome, sa_interval):
    # every row of the text (90% valid) and the edge lanes, both rank
    # layouts, int32 and int64 sa_samp, the pipeline's instantiation and
    # the two diagnostic ones (chip_smoke.check_sa_locate); each valid
    # row's position is the full SA's
    idx, arrs, sa_full = _sampled(genome[0], sa_interval, cuda_device)
    n = idx.seq_len + 1
    rows = torch.arange(n, device=cuda_device)
    valid = torch.from_numpy(
        np.random.default_rng(sa_interval).random(n) < 0.9).to(cuda_device)
    rec = dict(arrs=arrs, meta=idx.meta, rows=rows, valid=valid)
    got = chip_smoke.check_sa_locate(f"sa_intv {sa_interval}", idx, rec,
                                     16.7e12, timed=True)
    assert got["walk_steps"] > 0 and got["longest_walk"] >= sa_interval - 1
    out = fm_index_cuda.sa_locate(arrs, idx.meta, rows, valid).cpu()
    full = torch.from_numpy(sa_full.astype(np.int64))
    v = valid.cpu()
    assert torch.equal(out[v], full[v]) and bool((out[~v] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5_000, 600_000])
def test_cuda_sa_locate_lane_queue(cuda_device, genome, n):
    # the lane queue below the lanes the card holds at once (every row in
    # a warp's first chunk) and above them (most rows from the queue's
    # counter): random rows of the genome at sa_intv 32 (90% valid) and
    # the edge lanes, both rank layouts, int32 and int64 sa_samp, the
    # pipeline's instantiation and the two diagnostic ones, equal to
    # sa_lookup; each row's steps add up to the warps' lane steps
    idx, arrs, sa_full = _sampled(genome[0], 32, cuda_device)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n)
    rows = torch.randint(0, idx.seq_len + 1, (n,), generator=g,
                         device=cuda_device)
    valid = torch.rand(n, generator=g, device=cuda_device) < 0.9
    rec = dict(arrs=arrs, meta=idx.meta, rows=rows, valid=valid)
    got = chip_smoke.check_sa_locate(f"queue n={n}", idx, rec, 16.7e12,
                                     timed=True)
    assert (32 * got["warps"] < n) == (n > 100_000)
    out = fm_index_cuda.sa_locate(arrs, idx.meta, rows, valid).cpu()
    full = torch.from_numpy(sa_full.astype(np.int64))
    v, r = valid.cpu(), rows.cpu()
    assert torch.equal(out[v], full[r[v]]) and bool((out[~v] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sa_interval", [1, 32])
def test_cuda_seeding_routes_the_locate(cuda_device, genome, sa_interval):
    # a sampled SA's locate launches sa_locate once and walks never on
    # cuda, plain=True walks and launches it never, the seeds are equal;
    # a full SA's is one gather either way.  Anchors from 8 chars: on a
    # 30 kb random genome the default 14 leaves no multi-hit slot to
    # locate (every anchor is resolved by the occ == 1 finish)
    path, reads, lens = genome
    idx, arrs, _ = _sampled(path, sa_interval, cuda_device)
    cfg = LordfastConfig(kmer_cache_k=6, sampling_count=200,
                         min_anchor_len=8)
    r = torch.from_numpy(reads).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    pos = torch.from_numpy(fm_index.sample_positions_host(
        lens, cfg.sampling_count)).to(cuda_device)
    args = (arrs, r, n, pos, idx.meta, cfg.sampling_count,
            cfg.min_anchor_len, cfg.max_ref_hits, cfg.max_seeds_per_read,
            cfg.seed_phase1_steps)
    sampled = sa_interval > 1
    chip_smoke.reset_launches()
    got = fm_index._seed_anchors_impl(*args)
    counts = chip_smoke.read_launches()
    assert (counts["sa_locate"], counts["sa_lookup"]) == (int(sampled), 0)
    chip_smoke.reset_launches()
    want = fm_index._seed_anchors_impl(*args, plain=True)
    counts = chip_smoke.read_launches()
    assert counts["sa_locate"] == 0
    assert (counts["sa_lookup"] > 0) == sampled
    for name in fm_index.SeedBatch._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_cuda_sa_locate_rejects_bad_inputs(cuda_device, genome):
    idx, arrs, _ = _sampled(genome[0], 32, cuda_device)
    meta = idx.meta
    rows = torch.arange(100, device=cuda_device)
    valid = torch.ones(100, dtype=torch.bool, device=cuda_device)
    before = fm_index_cuda.sa_locate.launches
    with pytest.raises(ValueError):  # a full SA is a gather, not a walk
        fm_index_cuda.sa_locate(arrs, dict(meta, sa_intv=1), rows, valid)
    with pytest.raises(ValueError):
        fm_index_cuda.sa_locate(arrs, dict(meta, sa_intv=24), rows, valid)
    with pytest.raises(TypeError):
        fm_index_cuda.sa_locate(arrs, meta, rows.int(), valid)
    with pytest.raises(ValueError):
        fm_index_cuda.sa_locate(arrs, meta, rows, valid.cpu())
    with pytest.raises(TypeError):  # sa_samp and L2 of one dtype
        fm_index_cuda.sa_locate(dict(arrs, L2=arrs["L2"].long()), meta,
                                rows, valid)
    with pytest.raises(ValueError):  # one diagnostic a launch
        fm_index_cuda.sa_locate(arrs, meta, rows, valid, want_stats=True,
                                want_need=True)
    with pytest.raises(ValueError):  # rank rows off a 16-byte boundary
        fm_index_cuda.sa_locate(
            dict(arrs, fm_blocks=arrs["fm_blocks"].reshape(-1)[1:-11]
                 .reshape(-1, 12)), meta, rows, valid)
    assert fm_index_cuda.sa_locate.launches == before
    empty = fm_index_cuda.sa_locate(arrs, meta, rows[:0], valid[:0])
    assert empty.shape == (0,) and fm_index_cuda.sa_locate.launches == before


def _shard_case(genome, sa_interval, layout, device):
    """The genome's index sliced to sa_interval, sharded over a group of
    one (a mesh of this process on the card; its stripes are the whole
    arrays, occ_cp cut to bwt_blocks' rows) in the rank layout asked
    for, beside its replicated arrays; and the seeder's arguments but the
    arrays for the genome's reads (anchors from 8 chars, so a sampled SA
    has multi-hit slots to walk)."""
    from lordfast_tpu_torch.parallel.mesh import make_mesh, mesh_group
    from lordfast_tpu_torch.parallel.sharded_index import shard_index_arrays

    path, reads, lens = genome
    idx, repl, _ = _sampled(path, sa_interval, device)
    mesh = make_mesh("cuda")
    arrs = shard_index_arrays(idx, mesh)
    if layout == "split":
        repl = chip_smoke.split_layout(idx, repl)
        arrs = dict(chip_smoke.split_layout(idx, arrs))
        arrs["occ_cp"] = arrs["occ_cp"][: arrs["bwt_blocks"].shape[0]]
    cfg = LordfastConfig(kmer_cache_k=6, sampling_count=200,
                         min_anchor_len=8)
    r = torch.from_numpy(reads).to(device)
    n = torch.from_numpy(lens).to(device)
    pos = torch.from_numpy(fm_index.sample_positions_host(
        lens, cfg.sampling_count)).to(device)
    rest = (r, n, pos, idx.meta, cfg.sampling_count, cfg.min_anchor_len,
            cfg.max_ref_hits, cfg.max_seeds_per_read, cfg.seed_phase1_steps)
    return idx, arrs, repl, rest, mesh_group(mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("sa_interval,layout", [
    (1, "fused"), (1, "split"), (32, "fused"), (32, "split")])
def test_cuda_shard_loops_match_plain(cuda_device, genome, sa_interval,
                                      layout):
    # the sharded seeder on seed_shard.cu's kernels (NCCL, one rank) ==
    # its plain loops == the replicated seeder; each kernel == its plain
    # version on its first call (chip_smoke.check_shard_kernels); the
    # kernels launch and the plain loops are not entered, and the reverse
    # under plain=True
    idx, arrs, repl, rest, group = _shard_case(genome, sa_interval, layout,
                                               cuda_device)
    sampled = sa_interval > 1
    chip_smoke.reset_launches()
    with chip_smoke.record_shard() as rec:
        got = fm_index._seed_anchors_impl(arrs, *rest, group=group)
    counts = chip_smoke.read_launches()
    assert all(counts[k] > 0 for k in chip_smoke.SHARD_KERNELS[:3])
    assert (counts["shard_walk_step"] > 0) == sampled
    assert not any(counts[k] for k in chip_smoke.SHARD_LOOPS + (
        "seed_ext", "sa_locate", "sa_lookup"))
    c = dict(fm_index.shard_counts)
    assert c["calls"] == 1 and c["redone"] == 0
    assert c["host_reads"] == c["blocks"] + (4 if sampled else 3)
    figs = chip_smoke.check_shard_kernels(rec)
    steps = chip_smoke.STEP_KERNELS[: 2 if sampled else 1]
    assert set(figs) == set(chip_smoke.SHARD_KERNELS[: 4 if sampled else 3]
                            + ("shard_bucket ids", "shard_answer sa")
                            + ("shard_bucket walk",
                               "shard_answer walk") * sampled
                            + tuple(f"{k} {t}" for k in steps
                                    for t in chip_smoke.SPARSE_STEPS))
    assert all(figs[f"{k} <1%"]["list_step"] for k in steps)
    chip_smoke.reset_launches()
    want = fm_index._seed_anchors_impl(arrs, *rest, group=group, plain=True)
    counts = chip_smoke.read_launches()
    assert not any(counts[k] for k in chip_smoke.SHARD_KERNELS)
    assert counts["_shard_ext"] == 1 and counts["_shard_walk"] == sampled
    repl_seeds = fm_index._seed_anchors_impl(repl, *rest)
    for name in fm_index.SeedBatch._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(got, name),
                           getattr(repl_seeds, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("sa_interval", [1, 32])
def test_cuda_shard_loops_all_gather_route(cuda_device, genome, sa_interval,
                                           monkeypatch):
    # every bucket's cap forced to 8: each routed block overflows and runs
    # again through the all-gather route (all_gather_into_tensor and
    # reduce_scatter_tensor under NCCL), with the same seeds
    idx, arrs, repl, rest, group = _shard_case(genome, sa_interval, "fused",
                                               cuda_device)
    want = fm_index._seed_anchors_impl(repl, *rest)
    monkeypatch.setattr(fm_index, "shard_cap", lambda n, D: 8)
    chip_smoke.reset_launches()
    got = fm_index._seed_anchors_impl(arrs, *rest, group=group)
    c = dict(fm_index.shard_counts)
    assert c["redone"] > 0, c
    for name in fm_index.SeedBatch._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _bucket_call(rng, n, D, kind, cap_kind, dev):
    """A bucket step's queries on dev: n lanes over a genome of seq_len
    2^24 (or its rows sampled at 32 for ids), 15% dead, 40% of the rows
    in owner 0's stripe; the cap fits its largest bucket or holds half
    of it.  Returns (args, kw) as chip_smoke.record_shard keeps a call."""
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    seq_len, primary = 1 << 24, 4321
    ids = kind == "ids"
    n_rows = seq_len // 32 if ids else (seq_len >> 7) + 1
    rps = -(-n_rows // D)
    top = n_rows if ids else seq_len + 1
    first = min(rps if ids else rps << 7, top)
    k = np.where(rng.random(n) < 0.4, rng.integers(0, first, n),
                 rng.integers(0, top, n))
    live = rng.random(n) < 0.85
    l = None
    if kind == "ext":
        l = np.minimum(k + rng.integers(0, 5000, n), seq_len)
        k[:5], l[5:10] = 0, seq_len
    elif kind == "walk":
        k[::7] = primary
    meta = None if ids else {"seq_len": seq_len, "primary": primary}
    T = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    live, k = T(live), T(k)
    l = None if l is None else T(l)
    blk, ask = K._query_blocks(live, k, l, meta, ids)
    owner = (blk[ask] // rps).clamp(0, D - 1)
    most = int(torch.bincount(owner, minlength=D).max()) if n else 0
    cap = max(((most if cap_kind == "fit" else most // 2) + 7) & ~7, 8)
    Q = blk.numel()
    args = (live, k, l, meta, rps, D, cap,
            torch.empty(D * cap, dtype=torch.int64, device=dev),
            torch.empty(Q, dtype=torch.int32, device=dev),
            torch.empty(D, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    return args, {"ids": True} if ids else {}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ext", "walk", "ids"])
@pytest.mark.parametrize("D", [1, 2, 3, 8, 256])
def test_cuda_shard_bucket_matches_plain(cuda_device, D, kind):
    # shard_bucket's one-launch scan == fm_index.bucket bit for bit (send,
    # slot, counts, over), launched again and again on the same look-back
    # scratch (each call its epoch): 150,000 lanes (up to 293 tiles),
    # caps that fit and that overflow, at D = 2, 3 and 8 from the same
    # queries (chip_smoke._bucket_check), one lane, and none
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    rng = np.random.default_rng([D, len(kind)])
    for n, cap_kind in ((150_000, "fit"), (150_000, "over"), (1, "fit"),
                        (0, "fit")):
        args, kw = _bucket_call(rng, n, D, kind, cap_kind, cuda_device)
        for _ in range(2):
            before = K.shard_bucket.launches
            asked, done, over = chip_smoke._bucket_check(
                args, kw, K.shard_bucket, K.shard_bucket_plain)
            torch.cuda.synchronize()
            assert K.shard_bucket.launches == before + done
            if n > 1:
                assert over >= 1 + (cap_kind == "over")
    args, kw = _bucket_call(rng, 10, 257, kind, "fit", cuda_device)
    with pytest.raises(ValueError, match="owners"):
        K.shard_bucket(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["fused", "split", "sa32", "sa64"])
def test_cuda_shard_answer_routed_leaves_empty_slots(cuda_device, layout):
    # shard_answer == its plain version at every slot a query took; on the
    # routed route a slot whose id is -1 keeps what it held, on the
    # all-gather route it gets zeros (chip_smoke._answer_check); ids in
    # and out of this rank's stripe, 16-byte pieces of fused and split
    # rows, the SA entries' int32 and int64 stripes
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    rng = np.random.default_rng(len(layout))
    rps, base, n = 5000, 20_000, 300_001
    T = lambda x: torch.from_numpy(x).to(cuda_device)  # noqa: E731
    rows = rng.integers(0, 2**32, (rps, 12))
    if layout == "fused":
        arrs, kw, shape = {"fm_blocks": T(rows)}, {}, (n, 12)
    elif layout == "split":
        arrs = {"occ_cp": T(np.ascontiguousarray(rows[:, :4])),
                "bwt_blocks": T(np.ascontiguousarray(rows[:, 4:]))}
        kw, shape = {}, (n, 12)
    else:
        dt = np.int32 if layout == "sa32" else np.int64
        arrs = {"sa_samp": T(rng.integers(-1, 2**31 - 1, rps).astype(dt))}
        kw, shape = {"key": "sa_samp"}, (n,)
    recv = rng.integers(base - 100, base + rps + 100, n)
    recv[rng.random(n) < 0.5] = -1
    before = K.shard_answer.launches
    got, figs = chip_smoke._answer_check(
        K.shard_answer, K.shard_answer_plain, T(recv), arrs, base,
        torch.empty(shape, dtype=torch.int64, device=cuda_device), kw)
    torch.cuda.synchronize()
    assert K.shard_answer.launches == before + 2
    assert figs["empty"] == int((recv == -1).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pos64", [False, True])
@pytest.mark.parametrize("kind", ["ext", "walk"])
def test_cuda_list_steps_match_plain(cuda_device, kind, pos64):
    # seed_shard.cu's step kernels over a compacted list of live lanes: a
    # block's first step over the flags (2% of 200,000 lanes live: a
    # sparse step) and its list step over the list the first wrote, each
    # == its plain version (lane state, counter ring, the list as a set),
    # the list step also over the list reversed and shuffled; rows and
    # intervals at int32 positions, or at and above 2^31 (the Pos =
    # int64_t instances)
    import torch_shard_model as model
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    rng = np.random.default_rng([len(kind), pos64, 15])
    seq_len = 2**33 + 12345 if pos64 else 2**30 + 777
    case = model.step_case(rng, kind, 200_000, seq_len, 0.02, pos64)
    name = f"shard_{kind}_step"
    before = getattr(K, name).launches
    out = model.list_steps(K, getattr(K, name), getattr(K, name + "_plain"),
                           case, kind, cuda_device, np.random.default_rng(5))
    torch.cuda.synchronize()
    assert getattr(K, name).launches == before + 4
    for tag in ("first", "list", "list reversed", "list shuffled"):
        want = out[tag.split()[0] + " plain"]
        for x, y in zip(out[tag][:-1], want[:-1]):
            assert x.equal(y), tag
        assert want[-1] is None or out[tag][-1].equal(want[-1]), tag
    assert 0 < int(out["list plain"][0].sum()) < int(
        out["first plain"][0].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ext", "walk"])
def test_cuda_step_wrapper_checks_each_new_tensor(cuda_device, kind):
    # a loop's step tensors are checked on its first step and then matched
    # by identity (fm_shard_cuda._checked): steps on the same tensors
    # launch, and a step given another tensor of a type the kernel does
    # not take is refused
    import torch_shard_model as model
    from lordfast_tpu_torch.ops import fm_shard_cuda as K

    rng = np.random.default_rng([len(kind), 16])
    n = 10_000
    case = model.step_case(rng, kind, n, 2**30 + 777, 0.5, False)
    args = model.step_args(case, kind, cuda_device)
    lists, ring = K.lane_list(n, cuda_device)
    step = getattr(K, f"shard_{kind}_step")
    before = step.launches
    for g in range(3):  # a block's first step, then two list steps
        step(*args, lanes=K.LaneList(lists, ring, g, g == 0, n))
    torch.cuda.synchronize()
    assert step.launches == before + 3
    state = list(args[0])
    state[1] = state[1].int()
    with pytest.raises(TypeError, match="int64"):
        step(state, *args[1:], lanes=K.LaneList(lists, ring, 3, False, n))
    assert step.launches == before + 3
