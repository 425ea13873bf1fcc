"""The 2.2 Gbp genome laid out like GRCh38's chr1-chr13
(tools/torch_g2200.py), held on the CPU:

- its generator: the layout's constants at full size (l_pac, chr13's
  offset, 2**31 at chr13's base 70,440,666, the upper-text reads' end
  87,847,324), and at 1/1000 the FASTA (the port's parser reads the
  generator's codes back, N at each contig end), the reads' truth file
  equal to the draw replayed, each read's sequence equal to its
  fragment's noise replayed, and each group where it should be; no read
  covers an N;
- the port on the 1/1000 genome against the JAX package read by read:
  48 reads, the 16 contig-edge reads among them, equal to the digests
  tools/torch_jax_sams.py --g2200 wrote (tests/data/jax_sam_digests.json
  "g2200"), each non-edge read on its drawn origin;
- the gap descriptors' gather (gap_dp.gather_gap_seqs) at l_pac =
  2,191,407,310 against the JAX package's, with targets across and past
  forward coordinate 2**31, across the last contig edge and past the
  genome's end, in both orientations (only the windows the descriptors
  read hold seeded words: the rest of the 548 MB table stays
  unwritten), and both against tools/torch_g2200.decode_gather;
- the chunked pack and unpack (utils/pack.py) equal to the JAX
  package's at chunk edges, and their transients bounded: the one-shot
  versions took ~8 and ~20 bytes a code, ~50 GB at 2.2 Gbp.
"""

import io
import json
import sys
import tracemalloc
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from lordfast_tpu.ops import gap_dp as jgap
from lordfast_tpu.utils import pack as jpack
from lordfast_tpu_torch.config import LordfastConfig
from lordfast_tpu_torch.index.builder import build_index, parse_fasta
from lordfast_tpu_torch.ops import gap_dp as tgap
from lordfast_tpu_torch.pipeline.engine import MappingEngine
from lordfast_tpu_torch.utils import pack as tpack

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import torch_g2200 as g22  # noqa: E402

torch.set_num_threads(2)
DIV = g22.DIGEST_DIV


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The 1/1000 genome's FASTA and its reads (all 512) with truth."""
    d = tmp_path_factory.mktemp("g2200")
    lay = g22.layout(DIV)
    g22.write_fasta(lay, d / "G.fa")
    truth = g22.write_reads(lay, d / "reads.fq")
    return lay, d, truth


def test_layout_constants():
    lay = g22.layout()
    assert lay.names == tuple(f"chr{i}" for i in range(1, 14))
    assert lay.l_pac == 2_191_407_310 and lay.seq_len == 4_382_814_620
    assert lay.offsets[-1] == 2_077_042_982
    assert lay.high - lay.offsets[-1] == 70_440_666
    assert lay.l_pac - lay.high == 43_923_662
    assert lay.upper_end == 87_847_324 < lay.lengths[0]
    assert (lay.l_pac + 15) // 16 == 136_962_957
    assert lay.seq_len > 2**32 and lay.l_pac > 2**31


@pytest.mark.parametrize("div", [1, DIV])
def test_groups_fall_where_drawn(div):
    """Each group where GROUPS says, at full size and at 1/1000; no
    segment covers an N; the draw replays."""
    lay = g22.layout(div)
    truth = g22.draw_truth(lay)
    assert truth == g22.draw_truth(lay)
    assert [r.name for r in truth] == [f"g{i}" for i in range(512)]
    assert {g: sum(r.group == g for r in truth) for g, _ in g22.GROUPS} == \
        dict(g22.GROUPS)
    offs, tel = lay.offsets, lay.telomere
    for r in truth:
        ln = sum(n for _, _, n in r.segs)
        assert g22.MIN_LEN <= ln < g22.MAX_LEN, r
        for c, s, n in r.segs:
            assert tel <= s and s + n <= lay.lengths[c] - tel, r
        (c, s, n), x = r.segs[0], offs[r.segs[0][0]] + r.segs[0][1]
        if r.group == "fwd_high":
            assert c == 12 and x >= lay.high, r
        elif r.group == "across":
            assert c == 12 and x < lay.high < x + n, r
        elif r.group == "upper":
            assert c == 0 and not r.rev and x + n <= lay.upper_end, r
        elif r.group == "edge":
            (c2, s2, n2), = r.segs[1:]
            assert c2 == c + 1 and s + n == lay.lengths[c] - tel, r
            assert s2 == tel, r
        else:
            assert len(r.segs) == 1
    assert {r.rev for r in truth if r.group == "fwd_high"} == {False, True}


def test_generator_files_replay(small):
    """The FASTA read back by the port's parser is the generator's codes;
    the truth file equals the draw; each read is its fragment (reverse
    complemented on the reverse strand) through bench._noise's replayed
    draws; no fragment holds an N."""
    lay, d, truth = small
    got = dict(parse_fasta(d / "G.fa"))
    assert list(got) == list(lay.names)
    for i, name in enumerate(lay.names):
        want = g22.contig_codes(lay, i, 0, lay.lengths[i])
        np.testing.assert_array_equal(got[name], want, err_msg=name)
        assert (want[:lay.telomere] == 4).all()
        assert (want[-lay.telomere:] == 4).all()
        assert (want[lay.telomere:-lay.telomere] < 4).all()
    assert g22.read_truth(lay, d / "reads.fq") == truth
    lines = (d / "reads.fq").read_text().splitlines()
    for j, r in enumerate(truth):
        frag_codes = g22.read_codes(lay, r)
        assert (frag_codes < 4).all(), r
        frag = g22.ASCII[frag_codes].tobytes().decode()
        if r.rev:
            frag = frag.translate(g22.COMP)[::-1]
        rng = np.random.default_rng([g22.READS_SEED, j])
        assert lines[4 * j] == f"@{r.name}"
        assert lines[4 * j + 1] == bench._noise(rng, frag), r.name
    # a slice drawn alone equals the same slice of the whole contig
    whole = g22.contig_codes(lay, 3, 0, lay.lengths[3])
    np.testing.assert_array_equal(g22.contig_codes(lay, 3, 777, 50_001),
                                  whole[777:50_001])


def test_port_matches_jax_digests(small, tmp_path):
    """The port on the CPU maps the 1/1000 genome's 48 DIGEST_READS (16
    across contig edges) as the JAX package did, read by read
    (jax_sam_digests.json "g2200"), and each non-edge read's primary
    record lies on its drawn contig, strand and span."""
    lay, d, truth = small
    want = json.loads(chip_smoke.JAX_DIGESTS.read_text())["g2200"]
    assert want["div"] == DIV and want["kwargs"] == g22.DIGEST_CONFIG
    picked = g22.pick(truth, g22.DIGEST_READS)
    assert [r.name for r in picked] == list(want["digests"])
    assert sum(r.group == "edge" for r in picked) == 16
    names = {r.name for r in picked}
    chip_smoke._subset(d / "reads.fq", tmp_path / "r48.fq",
                       lambda name, i: name in names)
    cfg = LordfastConfig(**g22.DIGEST_CONFIG)
    eng = MappingEngine(build_index(d / "G.fa", cfg, verbose=False), cfg,
                        device="cpu")
    out = io.StringIO()
    eng.map_file(tmp_path / "r48.fq", out, "test")
    sam = out.getvalue()
    got = chip_smoke.read_digests(sam)
    bad = [n for n in want["digests"] if got.get(n) != want["digests"][n]]
    assert not bad, bad
    ok = chip_smoke.origin_check(sam, g22.origins(lay, truth),
                                 dict(zip(lay.names, lay.offsets)))
    assert all(ok[int(r.name[1:])] for r in picked if r.group != "edge")
    assert g22.sq_check(lay, sam) > 0


@pytest.mark.parametrize("Q,T", [(512, 576), (2048, 2176), (512, 544)])
def test_gather_past_2_31_matches_jax(Q, T):
    """gather_gap_seqs at the full genome's l_pac: the port's (int64
    words, as on the card) equals the JAX package's (uint32 words) and
    the numpy decode."""
    lay = g22.layout()
    n = lay.l_pac
    rng = np.random.default_rng(20261018 + Q + T)
    desc = g22.gather_descs(lay, rng, Q, T)
    assert (desc["t_start"] >= 2**31).sum() > len(desc["t_start"]) // 2
    assert (desc["t_start"] < 2**31).any() and desc["t_start"].max() == n
    rows = g22.gather_rows(desc, T)
    size = (n + 15) // 16 + T // 16 + 2
    assert rows.max() < size
    vals = rng.integers(0, 2**32, len(rows), dtype=np.uint64)
    words64 = np.zeros(size, np.int64)  # pages never written stay unused
    words64[rows] = vals.astype(np.int64)
    words32 = np.zeros(size, np.uint32)
    words32[rows] = vals.astype(np.uint32)
    reads = rng.integers(0, 5, (len(desc["q_read"]), Q + 8)).astype(np.uint8)
    jd = {k: jnp.asarray(v) for k, v in desc.items()}
    want = jgap.gather_gap_seqs(jnp.asarray(words32), jnp.asarray(reads), jd,
                                Q, T, n)
    td = {k: torch.from_numpy(v) for k, v in desc.items()}
    got = tgap.gather_gap_seqs(torch.from_numpy(words64),
                               torch.from_numpy(reads), td, Q, T, n)
    ref = g22.decode_gather(lambda w: words64[w], reads, desc, Q, T, n)
    for name, g, w, r in zip(("qs", "ql", "ts", "tl"), got, want, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        np.testing.assert_array_equal(g.numpy(), r, name)
    ts, tl = got[2].numpy(), got[3].numpy()
    past = desc["t_start"] + tl > n
    assert past.any() and not desc["t_rc"].all()
    # a forward target past the genome's end reads 0 there (3 reversed)
    g = int(np.flatnonzero(past & ~desc["t_rc"] & (tl > 1))[0])
    inside = n - desc["t_start"][g]
    assert (ts[g, inside:tl[g]] == 0).all()


@pytest.mark.parametrize("chunk", [16, 48, 1 << 24])
def test_chunked_pack_matches_jax(chunk):
    rng = np.random.default_rng(chunk)
    for n in (0, 1, 15, 16, 17, 47, 48, 49, 1000, 4099):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        np.testing.assert_array_equal(tpack.pack_bwt_words(codes, chunk),
                                      jpack.pack_bwt_words(codes))
        pac = jpack.pack_pac(codes)
        for st, ln in ((0, n), (3, n - 5), (1, 7), (n - 1, 1)):
            if st >= 0 and ln > 0 and st + ln <= n:
                np.testing.assert_array_equal(
                    tpack.unpack_pac(pac, st, ln, chunk),
                    jpack.unpack_pac(pac, st, ln))
    with pytest.raises(ValueError):
        tpack.pack_bwt_words(np.zeros(40, np.uint8), 24)


def test_pack_transients_are_bounded():
    """pack_bwt_words and unpack_pac over 2**26 codes with 2**20-code
    chunks: numpy's allocations (tracemalloc) peak at the output plus a
    few chunks' transients, where the one-shot versions took ~8 and ~20
    bytes a code (~0.5 and ~1.3 GB here)."""
    n, chunk = 1 << 26, 1 << 20
    codes = np.random.default_rng(7).integers(0, 4, n, dtype=np.uint8)
    pac = jpack.pack_pac(codes)
    tracemalloc.start()
    try:
        words = tpack.pack_bwt_words(codes, chunk)
        _, peak_pack = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        back = tpack.unpack_pac(pac, 0, n, chunk)
        _, peak_unpack = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert words.nbytes == n // 4 and back.nbytes == n
    assert peak_pack < words.nbytes + 24 * chunk, peak_pack
    assert peak_unpack < words.nbytes + back.nbytes + 40 * chunk, peak_unpack
    np.testing.assert_array_equal(back[:4096], codes[:4096])
