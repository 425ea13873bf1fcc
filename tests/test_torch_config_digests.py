"""The JAX package's per-read SAM digests of the non-default
configurations (``configs`` in tests/data/jax_sam_digests.json, made on
the CPU by tools/torch_jax_sams.py --chain / --seeder) and the smoke's
check of a card pass against them (chip_smoke.check_digests with a
configuration and the names of the reads it mapped): the file's form,
the check on a subset, the KNOWN_DIVERGENT keys, and that a read's
records do not depend on the reads mapped beside it, which the smoke's
subsets rely on."""

import importlib.util
import io
import json
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from lordfast_tpu_torch.config import LordfastConfig as TCfg
from lordfast_tpu_torch.pipeline.engine import MappingEngine

from test_golden import TEST_CFG
from test_torch_fm_index import port_index

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
CONFIGS = ("clasp", "extend-whole-2", "extend-whole-3")

torch.set_num_threads(2)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_jax_sams", ROOT / "tools" / "torch_jax_sams.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tag", ["v1", "v2"])
@pytest.mark.parametrize("config", CONFIGS)
def test_config_digests_file(config, tag):
    """configs.<config>.<tag>: the LordfastConfig it ran (the tool's
    --chain / --seeder keywords), the JAX package's commit, 512 v1 or 560
    v2 reads, named as in the default configuration's section and in its
    order (v2: 40 SV/clip and 8 junk reads), one sha256 a read."""
    d = json.loads(chip_smoke.JAX_DIGESTS.read_text())
    entry = d["configs"][config]
    tool = _tool()
    chain = entry["kwargs"].get("chain_alg", "dp-n2")
    seeder = entry["kwargs"].get("seeder", "extend-whole")
    assert tool.config_kwargs(chain, seeder) == entry["kwargs"]
    assert tool.config_name(entry["kwargs"]) == config
    assert entry["config"] == "LordfastConfig(" + ", ".join(
        f"{k}={v!r}" for k, v in entry["kwargs"].items()) + ")"
    TCfg(**entry["kwargs"])
    assert len(entry["jax_package_commit"]) == 40
    int(entry["jax_package_commit"], 16)
    ds = entry[tag]
    assert ds["reads"] == {"v1": 512, "v2": 560}[tag]
    assert list(ds["digests"]) == list(d["datasets"][tag]["digests"])
    assert chip_smoke.jax_digests(config, tag) == ds
    for name, h in ds["digests"].items():
        assert re.fullmatch("[0-9a-f]{64}", h), (config, tag, name)
    if tag == "v2":
        assert sum(n.startswith("sv") for n in ds["digests"]) == 40
        assert sum(n.startswith("junk") for n in ds["digests"]) == 8


def _sam(recs):
    return "@HD\tVN:1.5\n@PG\tID:x\n" + "".join(r + "\n" for r in recs)


def test_check_digests_subset(tmp_path, monkeypatch):
    """check_digests under a configuration, on the reads that were mapped:
    a held subset passes; a mapped read with no records, a read outside
    the dataset and a record of a read that was not mapped fail; a read
    that differs passes only where KNOWN_DIVERGENT names it under its
    configuration."""
    recs = {"a": "a\t0\tc\t1", "b": "b\t4\t*\t0", "c": "c\t16\tc\t7"}
    digests = chip_smoke.read_digests(_sam(recs.values()))
    f = tmp_path / "d.json"
    f.write_text(json.dumps({
        "jax_package_commit": "0" * 40,
        "datasets": {"v1": {"reads": 3, "digests": {}}},
        "configs": {"clasp": {"jax_package_commit": "1" * 40, "v1": {
            "reads": 3, "digests": digests}}}}))
    monkeypatch.setattr(chip_smoke, "JAX_DIGESTS", f)
    check = chip_smoke.check_digests
    check("v1", _sam([recs["a"], recs["c"]]), "clasp", ["a", "c"])
    check("v1", _sam(recs.values()), "clasp")
    with pytest.raises(AssertionError, match="no records"):
        check("v1", _sam([recs["a"]]), "clasp", ["a", "c"])
    with pytest.raises(AssertionError, match="not in the dataset"):
        check("v1", _sam([recs["a"], "z\t4\t*\t0"]), "clasp", ["a", "z"])
    with pytest.raises(AssertionError, match="not mapped"):
        check("v1", _sam([recs["a"], recs["b"]]), "clasp", ["a"])
    changed = _sam([recs["a"], "c\t16\tc\t8"])
    with pytest.raises(AssertionError, match="differ"):
        check("v1", changed, "clasp", ["a", "c"])
    for other in ({("v1", "c"): "ROADMAP Queue 3 item 2"},
                  {("extend-whole-3", "v1", "c"): "ROADMAP Queue 3 item 2"}):
        monkeypatch.setattr(chip_smoke, "KNOWN_DIVERGENT", other)
        with pytest.raises(AssertionError, match="differ"):
            check("v1", changed, "clasp", ["a", "c"])
    monkeypatch.setattr(chip_smoke, "KNOWN_DIVERGENT",
                        {("clasp", "v1", "c"): "ROADMAP Queue 3 item 2"})
    check("v1", changed, "clasp", ["a", "c"])


def test_known_divergent_keys():
    """Every KNOWN_DIVERGENT key names a read of its configuration's
    digests ((dataset, read) under LordfastConfig(), (configuration,
    dataset, read) under another), and its cause a ROADMAP Queue 3 item
    that the ROADMAP has and that names the read."""
    d = json.loads(chip_smoke.JAX_DIGESTS.read_text())
    roadmap = (ROOT / "ROADMAP.md").read_text()
    queue3 = roadmap[roadmap.index("### Queue 3"):]
    for key, cause in chip_smoke.KNOWN_DIVERGENT.items():
        config, tag, read = (None, *key) if len(key) == 2 else key
        assert read in chip_smoke.jax_digests(config, tag)["digests"], key
        if config is not None:
            assert config in d["configs"], key
        item = re.search(r"ROADMAP Queue 3 item (\d+)", cause)
        assert item, (key, cause)
        assert re.search(rf"^{item[1]}\. ", queue3, re.M), (key, cause)
        assert f"`{read}`" in queue3, (key, "not named in ROADMAP Queue 3")


def test_card_seeder_subsets():
    """The v2 reads the smoke's seeder passes map, in the digests' order
    (v2's order): extend-whole-3's 64 are the 40 SV/clip reads, the 8
    junk reads and b0-b15; extend-whole-2's 56 are the same but the 8
    noiseless inversion reads (bench.gen_dataset's SV kind 2)."""
    names = list(chip_smoke.jax_digests("extend-whole-2", "v2")["digests"])

    def subset(keep):
        return [n for i, n in enumerate(names) if keep(n, i)]

    ew3 = subset(chip_smoke._v2_seeder_subset)
    assert len(ew3) == 64
    assert sum(n.startswith("sv") for n in ew3) == 40
    assert sum(n.startswith("junk") for n in ew3) == 8
    assert [n for n in ew3 if n.startswith("b")] == [f"b{i}"
                                                     for i in range(16)]
    inv = [f"sv{i}" for i in range(2, 40, 5)]
    assert subset(chip_smoke._v2_ew2_subset) == [n for n in ew3
                                                 if n not in inv]


def _fastq_parts(dst, n, parts):
    lines = (DATA / "reads.fq").read_text().splitlines(keepends=True)
    reads = ["".join(lines[i : i + 4]) for i in range(0, 4 * n, 4)]
    files = []
    for p in range(parts):
        f = dst / f"part{p}of{parts}.fq"
        f.write_text("".join(reads[p * n // parts : (p + 1) * n // parts]))
        files.append(f)
    return files


@pytest.mark.parametrize("kw", [{"chain_alg": "clasp"},
                                {"seeder": "extend-whole-3"}],
                         ids=["clasp", "extend-whole-3"])
def test_read_records_do_not_depend_on_chunk(ref8_idx, tmp_path, kw):
    """The port on the CPU gives the first 16 golden reads the same
    records, read by read, from one file as from two files of 8: the
    smoke holds subsets of reads, and the tool maps chunks, against
    digests of whole datasets."""
    eng = MappingEngine(port_index(ref8_idx), TCfg(**TEST_CFG, **kw),
                        device="cpu")
    got = []
    for parts in (1, 2):
        digests = {}
        for f in _fastq_parts(tmp_path, 16, parts):
            out = io.StringIO()
            eng.map_file(f, out, "chunk-test")
            digests.update(chip_smoke.read_digests(out.getvalue()))
        got.append(digests)
    assert len(got[0]) == 16
    assert got[0] == got[1]
