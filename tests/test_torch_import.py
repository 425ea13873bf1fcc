"""The PyTorch port stands alone: every module of lordfast_tpu_torch (and
chip_smoke.py) imports with jax and lordfast_tpu unavailable, the host
modules copied from the JAX package have not drifted from their
originals, and the native library keeps the JAX loader's ctypes
signatures."""

import difflib
import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "lordfast_tpu"
PORT_PKG = ROOT / "lordfast_tpu_torch"

# host modules copied verbatim (only the package-relative imports could
# differ, and none do)
COPIED = [
    "config.py", "utils/pack.py", "utils/checkpoint.py",
    "index/__init__.py", "index/fm_host.py",
    "index/bwa_io.py", "io/fastx.py", "io/sam.py",
    "align/edlib_eq.py", "align/chain_align.py",
]
# copies that differ on purpose: {file: (defs removed or rewritten in
# the port, module docstring rewritten, [(pattern in the original,
# port text)])}
ALLOWED_DIFF = {
    # profiler_trace (jax.profiler) left out; --profile is refused
    "utils/metrics.py": (["profiler_trace"], True, []),
    # device_arrays(device) returns torch tensors
    "index/container.py": (["device_arrays"], False, []),
    # one comment reworded
    "index/builder.py": ([], False, [(r"fit the \w+'s budget",
                                      "fit its time budget")]),
}

BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "lordfast_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import lordfast_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lordfast_tpu_torch.__path__,
                                               "lordfast_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "lordfast_tpu")
               for m in sys.modules)
print("\n".join(names))
"""


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    for m in ("cli", "native", "ops.fm_index", "ops.voting", "ops.chain",
              "ops.gap_dp", "ops.gap_dp_cuda", "pipeline.device_stage",
              "pipeline.engine", "index.container", "align.chain_align"):
        assert f"lordfast_tpu_torch.{m}" in names


def _normalise(text: str) -> str:
    # reference-source citations are written relative in the port
    text = re.sub(r"/\w+/reference/", "", text)
    return text.replace("lordfast_tpu_torch", "lordfast_tpu")


def _drop_def(text: str, name: str) -> str:
    """Remove the (possibly decorated) def `name` and its body."""
    lines = text.splitlines(keepends=True)
    out, i = [], 0
    while i < len(lines):
        m = re.match(r"(\s*)def " + name + r"\b", lines[i])
        if not m:
            out.append(lines[i])
            i += 1
            continue
        indent = len(m.group(1))
        while out and out[-1].strip().startswith("@"):
            out.pop()
        i += 1
        while i < len(lines) and (not lines[i].strip() or
                                  len(lines[i]) - len(lines[i].lstrip())
                                  > indent):
            i += 1
    return "".join(out)


def _drop_docstring(text: str) -> str:
    return re.sub(r'\A""".*?"""\n', "", text, flags=re.S)


@pytest.mark.parametrize("rel", COPIED + sorted(ALLOWED_DIFF))
def test_copied_host_modules_have_not_drifted(rel):
    orig = _normalise((JAX_PKG / rel).read_text())
    port = _normalise((PORT_PKG / rel).read_text())
    defs, doc, subs = ALLOWED_DIFF.get(rel, ([], False, []))
    for pattern, repl in subs:
        orig, n = re.subn(pattern, repl, orig)
        assert n == 1, pattern
    for name in defs:
        orig, port = _drop_def(orig, name), _drop_def(port, name)
    if doc:
        orig, port = _drop_docstring(orig), _drop_docstring(port)
    diff = "".join(difflib.unified_diff(orig.splitlines(True),
                                        port.splitlines(True), "jax", "port"))
    assert orig.strip() == port.strip(), diff


def test_native_signatures_match_jax_loader():
    jnat = importlib.import_module("lordfast_tpu.native")
    tnat = importlib.import_module("lordfast_tpu_torch.native")
    jlib, tlib = jnat._load(), tnat._load()
    assert jlib is not None
    names = ["sais_u8", "bwt_from_sa", "nw_align", "nw_align_full",
             "edlib_band_path", "edlib_nw_dist", "shw_best_end", "sw_extend",
             "sa_walk_batch", "decode_colcodes", "stitch_chain"]
    for n in names:
        jf, tf = getattr(jlib, n), getattr(tlib, n)
        assert jf.restype == tf.restype, n
        assert list(jf.argtypes) == list(tf.argtypes), n
    assert {m.name for m in pkgutil.iter_modules([str(PORT_PKG)])} >= {
        "native", "ops", "pipeline", "cli"}
