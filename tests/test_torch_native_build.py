"""The port's native builds are safe under concurrency: the host library
(lordfast_tpu_torch.native) built and loaded from 8 threads at once into
a fresh directory compiles and loads once, and the CUDA build module
(ops.cuda_build) gives every build a temporary output of its own and,
driven by 8 threads through a stand-in compiler, builds and loads each
library once.  No nvcc is needed."""

import ctypes
import stat
import sys
import threading

from lordfast_tpu_torch import native
from lordfast_tpu_torch.ops import cuda_build

N_THREADS = 8


def _together(fn):
    """fn() from N_THREADS threads released at once, with a short switch
    interval; their results."""
    gate = threading.Barrier(N_THREADS, timeout=60)
    out, errs = [None] * N_THREADS, []

    def run(i):
        try:
            gate.wait()
            out[i] = fn()
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(N_THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return out


def _count_cdll(monkeypatch):
    calls = []
    real = ctypes.CDLL

    def counting(path, *a, **kw):
        calls.append(str(path))
        return real(path, *a, **kw)

    monkeypatch.setattr(ctypes, "CDLL", counting)
    return calls


def test_native_load_from_threads(tmp_path, monkeypatch):
    lib_path = tmp_path / "build" / "liblordfast_native.so"
    monkeypatch.setattr(native, "BUILD_DIR", lib_path.parent)
    monkeypatch.setattr(native, "_LIB_PATH", lib_path)
    monkeypatch.setattr(native, "_lib", None)
    loads = _count_cdll(monkeypatch)
    libs = _together(native._load)
    assert all(lib is libs[0] for lib in libs)
    assert loads == [str(lib_path)]
    assert [p.name for p in lib_path.parent.iterdir()] == [lib_path.name]
    assert libs[0].edlib_nw_dist.restype is ctypes.c_int64


def test_cuda_build_temp_names_are_unique(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    names = _together(lambda: cuda_build.temp_lib_path("myers"))
    assert len(set(names)) == N_THREADS
    for p in names:
        assert p.parent == tmp_path / "build" and p.exists()
        assert p.name.startswith("libmyers.so.")
        assert p != cuda_build.lib_path("myers")


def test_cuda_load_from_threads(tmp_path, monkeypatch):
    # a stand-in nvcc copies the host library to its -o argument, so the
    # build lock, naming and rename run as they do on the card
    real_lib = native.build()
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys, time\n"
        f"open({str(log)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        "time.sleep(0.2)\n"
        f"shutil.copy({str(real_lib)!r}, "
        "sys.argv[sys.argv.index('-o') + 1])\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    build = tmp_path / "build"
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setenv("NVCC", str(fake))
    loads = _count_cdll(monkeypatch)
    libs = _together(lambda: cuda_build.load("myers"))
    assert all(lib is libs[0] for lib in libs)
    assert loads == [str(build / "libmyers.so")]
    assert log.read_text().split() == [str(cuda_build.CSRC_DIR / "myers.cu")]
    assert [p.name for p in build.iterdir()] == ["libmyers.so"]
