"""The PyTorch port stands alone: every module of lordfast_tpu_torch (and
chip_smoke.py) imports with jax and lordfast_tpu unavailable, the host
modules and native C++ sources copied from the JAX package have not
drifted from their originals, and the native library keeps the JAX
loader's ctypes signatures."""

import difflib
import importlib
import pkgutil
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "lordfast_tpu"
PORT_PKG = ROOT / "lordfast_tpu_torch"

# host modules copied verbatim (only the package-relative imports could
# differ, and none do)
COPIED = [
    "config.py", "utils/checkpoint.py",
    "index/__init__.py", "index/fm_host.py",
    "index/bwa_io.py", "io/fastx.py", "io/sam.py",
    "align/edlib_eq.py", "align/chain_align.py", "ops/seeders.py",
    "align/chain_align_ksw.py",
]
# copies that differ on purpose: {file: (defs removed or rewritten in
# the port, module docstring rewritten, [(pattern in the original,
# port text)])}
ALLOWED_DIFF = {
    # profiler_trace on torch.profiler, and named_range (the device
    # stage's profiler / NVTX ranges, jax.named_scope in the JAX package)
    "utils/metrics.py": (["profiler_trace", "named_range"], True,
                         [(r"import json\n", "import json\nimport os\n")]),
    # maybe_init_distributed and barrier on torch.distributed (gloo)
    "parallel/multihost.py": (["maybe_init_distributed", "barrier"], True,
                              []),
    # device_arrays(device) returns torch tensors
    "index/container.py": (["device_arrays"], False, []),
    # the Gbp-scale pack and unpack run in chunks: the one-shot versions'
    # transients are ~50 GB at 2.2 Gbp
    "utils/pack.py": (["unpack_pac", "pack_bwt_words"], False, []),
    # one comment reworded; the device-layout sidecar records the files
    # it was made from and is refused once they change (devcache_meta)
    "index/builder.py": (["_stamp", "remove_device_cache", "devcache_meta",
                          "save_device_cache", "_load_index_mmap"], False,
                         [(r"fit the \w+'s budget", "fit its time budget"),
                          (r"import json\n",
                           "import json\nimport os\nimport shutil\n")]),
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
from lordfast_tpu_torch.ops import affine, affine_cuda, gap_dp_cuda
# the kernel wrappers and their launch counters
for fn in (gap_dp_cuda.myers_dist, gap_dp_cuda.myers_moves,
           affine_cuda.extend_batch_cuda):
    assert fn.launches == 0
assert callable(affine.extend_batch) and callable(affine.extend_from_desc)
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
              "ops.gap_dp", "ops.gap_dp_cuda", "ops.affine",
              "ops.affine_cuda", "ops.seeders", "pipeline.device_stage",
              "pipeline.engine", "index.container", "align.chain_align",
              "align.chain_align_ksw", "parallel.multihost"):
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


NATIVE_SOURCES = ["sais.cpp", "align_eq.cpp", "stitch.cpp", "edlib_path.cpp"]


@pytest.mark.parametrize("name", NATIVE_SOURCES)
def test_native_sources_are_byte_equal_copies(name):
    from lordfast_tpu_torch import native

    assert native.SRC_DIR == PORT_PKG / "native" / "csrc"
    assert tuple(NATIVE_SOURCES) == native._SRCS
    orig = (JAX_PKG / "native" / name).read_bytes()
    port = (native.SRC_DIR / name).read_bytes()
    assert port == orig, f"{name} differs from lordfast_tpu/native/{name}"


def jax_native_lib(tries: int = 5):
    """The JAX package's native library.  Its loader builds it in place
    with make and remembers a failed load for good; a test worker that
    loads while another process is still writing the file sees that
    failure, so the load is retried, a second apart, after resetting the
    loader's state."""
    jnat = importlib.import_module("lordfast_tpu.native")
    for i in range(tries):
        lib = jnat._load()
        if lib is not None:
            return lib
        time.sleep(1.0)
        jnat._lib_tried = False
    raise AssertionError(f"lordfast_tpu.native did not load in {tries} "
                         "tries")


def test_native_signatures_match_jax_loader():
    tnat = importlib.import_module("lordfast_tpu_torch.native")
    jlib, tlib = jax_native_lib(), tnat._load()
    names = ["sais_u8", "bwt_from_sa", "nw_align", "nw_align_full",
             "edlib_band_path", "edlib_nw_dist", "shw_best_end", "sw_extend",
             "sa_walk_batch", "decode_colcodes", "stitch_chain"]
    for n in names:
        jf, tf = getattr(jlib, n), getattr(tlib, n)
        assert jf.restype == tf.restype, n
        assert list(jf.argtypes) == list(tf.argtypes), n
    assert {m.name for m in pkgutil.iter_modules([str(PORT_PKG)])} >= {
        "native", "ops", "pipeline", "cli"}
