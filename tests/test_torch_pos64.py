"""64-bit text positions in the port, held to the JAX package on the CPU.

An index whose text passes 2**31 - 1 positions (seq_len = 2 l_pac, so
l_pac >= 1,073,741,824: human, mouse, maize) keeps its positions in
int64 (FMIndex.pos_dtype).  Here, with inputs made from a numpy seed:

- voting (flat, wide and paged routes, and the dispatcher), candidate
  compaction and window seed selection on int64 seed positions at and
  above 2**31 and 2**32, next to small ones, against the JAX package
  (x64 on), every field equal; selection over three contig tables: the
  1.2 Gbp smoke genome's (one contig; seed positions are forward
  coordinates, so below l_pac), one whose contigs pass 2**32 (a
  genome with l_pac > 2**32, where the forward coordinates themselves
  pass 2**31), with windows across contig edges at 2**31 and 2**32, and
  GRCh38's chr1-chr13 (tools/torch_g2200.py: l_pac 2,191,407,310, seeds
  across and past 2**31 in chr13, across its edge with chr12 and at the
  genome's end);
- the position dtype at seq_len 2**31 - 2 and 2**31 - 1, and the host
  and device arrays that take it, through the device-layout cache's
  memory-mapped load too;
- the smoke's truth check (chip_smoke.gbp_origins, high_reads,
  origin_check) on a 2 Mbp random genome and 16 reads of
  bench.gen_gbp_reads: the replayed origins equal the fragments the
  generator drew, the port's CPU engine maps every read on its origin,
  a record moved off its origin fails, and the seeding locates a
  forward read's patterns in the text's upper half (the search runs on
  the reverse complement of the read's anchors), which is why
  high_reads takes forward reads.
"""

import dataclasses
import io
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from lordfast_tpu.config import LordfastConfig as JCfg
from lordfast_tpu.ops import chain as jchain
from lordfast_tpu.ops import fm_index as jfm
from lordfast_tpu.ops import voting as jvote
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.index.builder import build_index
from lordfast_tpu_torch.ops import chain as tchain
from lordfast_tpu_torch.ops import fm_index as tfm
from lordfast_tpu_torch.ops import voting as tvote
from lordfast_tpu_torch.pipeline.engine import MappingEngine
from lordfast_tpu_torch.utils.pack import seq_to_codes

from test_torch_fm_index import port_index
from test_torch_voting import assert_cands_equal

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import torch_g2200  # noqa: E402

G2200 = torch_g2200.layout()
# each read's seeds sit at one of these bases plus make_seeds' spread
# (< 62 read lengths): small, across 2**31, at 2**31, past 2**32, and
# between the two
BASES_64 = (0, 2**31 - 3000, 2**31, 2**32 + 5, 3 * 2**30)
# the 1.2 Gbp smoke genome's forward coordinates (below l_pac)
G1200_L_PAC = 1_200_000_000
BASES_G1200 = (0, 600_000_000, G1200_L_PAC - 200_000)
# contig tables (offsets, lengths): the smoke's 1.2 Gbp genome, and
# contigs with edges at 2**31 and 2**32
CONTIGS = {
    "g1200": ((0,), (G1200_L_PAC,)),
    "past_2^32": ((0, 2**31 - 2000, 2**31, 2**32),
                  (2**31 - 2000, 2000, 2**31, 10**9)),
    # tools/torch_g2200.py: GRCh38's chr1-chr13, l_pac 2,191,407,310, the
    # forward coordinates past 2**31 in chr13
    "grch38_13": (G2200.offsets, G2200.lengths),
}


def seeds64(seed, B, MS, max_n, bases=BASES_64):
    """make_seeds' seed slots with int64 t_pos moved to bases[b % n]
    (chip_smoke.vote_seeds, which the smoke's voting checks draw)."""
    return chip_smoke.vote_seeds(np.random.default_rng(seed), B, MS, max_n,
                                 bases)


def both(fields, lens):
    js = jfm.SeedBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = tfm.SeedBatch(**{k: torch.from_numpy(np.array(v))
                          for k, v in fields.items()})
    assert js.t_pos.dtype == jnp.int64 and ts.t_pos.dtype == torch.int64
    return js, ts, jnp.asarray(lens), torch.from_numpy(lens)


def _eq(got, want, fields):
    for name in fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("route,page", [("flat", None), ("wide", None),
                                        ("flat", 1), ("wide", 1)])
def test_vote_windows_64bit_matches_jax(route, page):
    fields, lens = seeds64(31, 10, 256, 256)
    t = fields["t_pos"][fields["valid"]]
    assert (t >= 2**31).any() and (t >= 2**32).any() and (t < 2**20).any()
    js, ts, jl, tl = both(fields, lens)
    cfg = dict(max_candidates=4)
    if route == "flat":
        want = jvote._vote_windows_flat(js, jl, JCfg(**cfg), 8192, page)
        got = tvote._vote_windows_flat(ts, tl, TCfg(**cfg), 8192, page)
    else:
        want = jvote._vote_windows_wide(js, jl, JCfg(**cfg), page)
        got = tvote._vote_windows_wide(ts, tl, TCfg(**cfg), page)
    assert_cands_equal(got, want)
    # candidates at 2**32 and past: window ids times the read length
    start = got.win_id.long() * torch.from_numpy(lens).long()[:, None]
    assert bool((got.valid & (start >= 2**32)).any())


def test_vote_windows_64bit_dispatch_matches_jax():
    """The dispatcher on a batch past 131072 padded votes (flat by total
    votes) and on a small one (wide)."""
    for B, MS, max_n in ((20, 4096, 300), (10, 128, 128)):
        fields, lens = seeds64(32, B, MS, max_n)
        js, ts, jl, tl = both(fields, lens)
        assert_cands_equal(tvote.vote_windows(ts, tl, TCfg()),
                           jvote.vote_windows(js, jl, JCfg()))


@pytest.mark.parametrize("table", sorted(CONTIGS))
def test_compact_select_64bit_matches_jax(table):
    """compact_candidates and select_window_seeds over int64 positions;
    select_window_seeds reads only the contig table of the index arrays,
    so a stub table stands in for the genome."""
    bases = {"g1200": BASES_G1200, "past_2^32": BASES_64,
             "grch38_13": torch_g2200.vote_bases(G2200)}[table]
    fields, lens = seeds64(33, 12, 512, 512, bases)
    js, ts, jl, tl = both(fields, lens)
    offs, lns = (np.asarray(x, np.int64) for x in CONTIGS[table])
    host = {"contig_offsets": offs, "contig_ends": offs + lns}
    jarrs = {k: jnp.asarray(v) for k, v in host.items()}
    tarrs = {k: torch.from_numpy(v) for k, v in host.items()}
    kw = dict(max_candidates=8, max_chain_seeds=64)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    K = len(lens) * jcfg.compact_windows_per_read
    jcw = jchain.compact_candidates(jvote.vote_windows(js, jl, jcfg), jcfg,
                                    K)
    tcw = tchain.compact_candidates(tvote.vote_windows(ts, tl, tcfg), tcfg,
                                    K)
    _eq(tcw, jcw, ("read_idx", "cand_idx", "win_id", "is_rev", "valid",
                   "n_needed"))
    jws = jchain.select_window_seeds(js, jcw, jl, jarrs, jcfg)
    tws = tchain.select_window_seeds(ts, tcw, tl, tarrs, tcfg)
    _eq(tws, jws, ("q_pos", "t_pos", "length", "valid", "n_in_range"))
    sel = tws.t_pos[tws.valid]
    assert len(sel) > 100
    if table == "past_2^32":
        assert bool((sel >= 2**31).any()) and bool((sel >= 2**32).any())
    elif table == "grch38_13":
        assert bool((sel >= 2**31).any()) and bool((sel < 2**31).any())
        # windows past the last contig's edge are cut at it
        edge = G2200.offsets[-1]
        assert bool(((sel >= edge - 100_000) & (sel < edge)).any())
    else:
        assert int(sel.max()) >= G1200_L_PAC - 200_000


@pytest.mark.parametrize("seq_len", [2**31 - 2, 2**31 - 1])
def test_pos_dtype_matches_jax(small_index, seq_len):
    """FMIndex.pos_dtype, torch_pos_dtype and the host and device arrays
    that take it, against the JAX package's FMIndex at the switch."""
    jidx = dataclasses.replace(small_index[0], seq_len=seq_len, _device=None,
                               _host_cache=None)
    tidx = port_index(jidx)
    want = np.int32 if seq_len == 2**31 - 2 else np.int64
    assert jidx.pos_dtype is want and tidx.pos_dtype is want
    assert tfm.torch_pos_dtype(tidx.meta) == getattr(torch, want.__name__)
    jh, th = jidx.host_arrays(), tidx.host_arrays()
    assert sorted(jh) == sorted(th)
    for k in jh:
        assert jh[k].dtype == th[k].dtype, k
        np.testing.assert_array_equal(jh[k], th[k], err_msg=k)
    dev = tidx.device_arrays("cpu")
    for k in ("sa_samp", "kcache_beg", "kcache_end", "L2",
              "contig_offsets", "contig_ends"):
        assert dev[k].dtype == getattr(torch, want.__name__), k


def test_device_cache_64bit_round_trip(small_index, tmp_path):
    """save_device_cache and load_index(mmap=True) at seq_len 2**31 - 1:
    the memory-mapped host layout keeps the int64 position arrays, equal
    to the JAX package's host_arrays at the same size."""
    from lordfast_tpu_torch.index.builder import (load_index,
                                                  save_device_cache,
                                                  save_index)

    jidx = dataclasses.replace(small_index[0], seq_len=2**31 - 1,
                               _device=None, _host_cache=None)
    path = tmp_path / "i.lft.npz"
    save_index(port_index(jidx), path)
    save_device_cache(port_index(jidx), path)
    got = load_index(path, mmap=True)
    assert got.seq_len == 2**31 - 1 and got.pos_dtype is np.int64
    want = jidx.host_arrays()
    host = got.host_arrays()
    assert sorted(host) == sorted(want)
    for k, w in want.items():
        assert host[k].dtype == w.dtype, k
        np.testing.assert_array_equal(host[k], w, err_msg=k)
    dev = got.device_arrays("cpu")
    assert dev["sa_samp"].dtype == dev["contig_ends"].dtype == torch.int64


# ---- the smoke's truth check, on a small genome ----

GBP_SMALL_BP = 2_000_000
GBP_SMALL_READS = 16
SMALL_CFG = dict(kmer_cache_k=8)


@pytest.fixture(scope="module")
def gbp_small(tmp_path_factory):
    """A seeded 2 Mbp random genome in one contig, its port index, and
    16 reads of bench.gen_gbp_reads with the fragment of each read as
    bench._noise received it."""
    d = tmp_path_factory.mktemp("gbp_small")
    rng = np.random.default_rng(20261017)
    codes = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, GBP_SMALL_BP)]
    fa = d / "g.fa"
    fa.write_bytes(b">g\n" + b"\n".join(
        codes[i:i + 100].tobytes()
        for i in range(0, GBP_SMALL_BP, 100)) + b"\n")
    idx = build_index(fa, TCfg(**SMALL_CFG), verbose=False)
    frags, noise = [], bench._noise

    def record(r, frag):
        frags.append(frag)
        return noise(r, frag)

    bench._noise = record
    try:
        bench.gen_gbp_reads(idx, d / "reads.fq", n_reads=GBP_SMALL_READS)
    finally:
        bench._noise = noise
    return idx, d / "reads.fq", frags


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def test_gbp_origins_replay_generator(gbp_small):
    idx, _, frags = gbp_small
    origins = chip_smoke.gbp_origins(idx, GBP_SMALL_READS)
    assert len(frags) == len(origins) == GBP_SMALL_READS
    assert 0 < sum(rev for _, _, rev in origins) < GBP_SMALL_READS
    for (st, ln, rev), frag in zip(origins, frags):
        want = idx.get_ref_str(st, ln).decode()
        assert frag == (_revcomp(want) if rev else want)


def _cpu_sam(idx, reads):
    out = io.StringIO()
    MappingEngine(idx, TCfg(**SMALL_CFG), device="cpu").map_file(
        reads, out, "test")
    return out.getvalue()


def _offsets(idx):
    return {n: int(o) for n, o in zip(idx.contig_names, idx.contig_offsets)}


def test_truth_check_passes_and_catches_a_moved_record(gbp_small):
    idx, reads, _ = gbp_small
    origins = chip_smoke.gbp_origins(idx, GBP_SMALL_READS)
    sam = _cpu_sam(idx, reads)
    ok = chip_smoke.origin_check(sam, origins, _offsets(idx))
    assert sum(ok.values()) >= chip_smoke.MIN_ORIGIN_FRAC * len(origins)
    assert all(ok.values())
    lines = sam.splitlines()
    i = next(j for j, line in enumerate(lines) if line.startswith("g0\t")
             and not int(line.split("\t")[1]) & 0x904)
    st, ln, rev = origins[0]
    for field, value in ((3, str(st + ln + 20_000)),
                         (1, str(int(lines[i].split("\t")[1]) ^ 0x10))):
        f = lines[i].split("\t")
        f[field] = value
        moved = "\n".join(lines[:i] + ["\t".join(f)] + lines[i + 1:])
        bad = chip_smoke.origin_check(moved, origins, _offsets(idx))
        assert not bad[0] and sum(bad.values()) == len(origins) - 1


def test_forward_reads_locate_in_the_upper_half(gbp_small, monkeypatch):
    """The seeding searches the reverse complement of each anchor, so the
    text positions it locates for a forward read lie in [l_pac,
    2 l_pac) and a reverse read's below l_pac: the reads whose located
    positions pass 2**31 at 1.2 Gbp are forward ones
    (chip_smoke.high_reads).  Positions come from _staged_ext's occ == 1
    finish and from sa_lookup, recorded around the CPU seeding."""
    idx, reads, _ = gbp_small
    origins = chip_smoke.gbp_origins(idx, GBP_SMALL_READS)
    seqs = reads.read_text().splitlines()[1::4]
    located = []
    staged, lookup = tfm._staged_ext, tfm.sa_lookup

    def staged_rec(*a, **kw):
        out = staged(*a, **kw)
        located.append(out[3][out[4]])
        return out

    def lookup_rec(arrs, meta, rows, valid, *a, **kw):
        out = lookup(arrs, meta, rows, valid, *a, **kw)
        located.append(out[valid])
        return out

    # each function counts its calls on the module attribute it is
    # called through
    staged_rec.entries = lookup_rec.entries = 0
    monkeypatch.setattr(tfm, "_staged_ext", staged_rec)
    monkeypatch.setattr(tfm, "sa_lookup", lookup_rec)
    cfg = TCfg(**SMALL_CFG)
    arrs = idx.device_arrays("cpu")
    for rev in (False, True):
        sel = [s for s, o in zip(seqs, origins) if o[2] == rev]
        L = max(map(len, sel))
        batch = np.full((len(sel), L), 4, np.uint8)
        for b, s in enumerate(sel):
            batch[b, :len(s)] = seq_to_codes(s)
        lens = np.asarray([len(s) for s in sel], np.int32)
        located.clear()
        tfm.seed_anchors(arrs, idx.meta, batch, lens, cfg)
        pos = torch.cat(located)
        upper = float((pos >= idx.l_pac).double().mean())
        assert len(pos) > 100
        assert upper >= 0.95 if not rev else upper <= 0.05, (rev, upper)
