"""The port's CUDA kernel on the card: ``myers_dist`` against its plain
PyTorch version (exact: distances and ends are integers), one test per
kind of gap bucket.  Needs an NVIDIA GPU (marker ``cuda``) and skips
without one.  This file imports neither jax nor lordfast_tpu, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lordfast_tpu_torch.ops import gap_dp_cuda
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
