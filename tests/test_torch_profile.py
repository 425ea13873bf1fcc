"""``--profile DIR`` in the PyTorch port: the CLI on the golden fixture,
on the CPU, writes a torch.profiler Chrome trace into DIR (made if
missing) that holds the device stage's four named ranges and a range of
every engine stage the run passes through, and the SAM is golden.sam's."""

import re
from pathlib import Path

import torch

from lordfast_tpu_torch import cli
from lordfast_tpu_torch.index.builder import index_path_for, save_index

from test_torch_fm_index import port_index

DATA = Path(__file__).parent / "data"

torch.set_num_threads(2)


def _records(path):
    return [l.rstrip("\n") for l in open(path) if not l.startswith("@")]


def test_profile_writes_trace_with_named_ranges(ref8_idx, tmp_path):
    ref = tmp_path / "ref.fa"
    ref.write_bytes((DATA / "ref.fa").read_bytes())
    save_index(port_index(ref8_idx), index_path_for(ref))
    trace_dir = tmp_path / "trace" / "run"
    out = tmp_path / "out.sam"
    assert cli.main(["--search", str(ref), "--seq", str(DATA / "reads.fq"),
                     "-o", str(out), "--device", "cpu",
                     "--profile", str(trace_dir)]) == 0
    assert _records(out) == _records(DATA / "golden.sam")
    traces = list(trace_dir.glob("lordfast_*.pt.trace.json"))
    assert len(traces) == 1
    # the CPU trace holds every op of the plain Myers loops (~200 MB):
    # scan it line by line for the ranges' names instead of loading it
    names = set()
    with open(traces[0]) as f:
        for line in f:
            names.update(re.findall(r'"name": "(lf_\w+)"', line))
    # the escalation offload is off on the CPU and the default seeder
    # seeds on the device: no lf_esc_* and no lf_host_seed
    assert names == {"lf_seed", "lf_vote", "lf_select", "lf_chain",
                     "lf_read_parse", "lf_batch_pack", "lf_device",
                     "lf_device_fetch", "lf_py_select", "lf_py_jobbuild",
                     "lf_gap_dp", "lf_gap_pack", "lf_gap_wait",
                     "lf_gap_unpack", "lf_stitch", "lf_stitch_pack",
                     "lf_stitch_decode", "lf_assemble", "lf_emit"}

