"""lordfast_tpu_torch: the PyTorch + CUDA port of lordfast_tpu.

The same long-read aligner (lordFAST semantics) with its device stages
written as plain PyTorch functions on tensors and its gap DP as a CUDA
kernel written for Hopper (``ops/gap_dp_cuda.py``, ``csrc/``).  Module
paths and function names follow the JAX package ``lordfast_tpu``, which
stays in the repository as the reference the port is tested against.
This package imports torch and numpy only, never jax or lordfast_tpu.

Every device function takes its device from its tensors; the engine and
``FMIndex.device_arrays`` take an explicit ``device``.  Host modules
(config, index build, FASTX/SAM I/O, the native stitcher bindings) are
copies of the JAX package's, changed only where they touched JAX.
"""

__version__ = "0.1.0"

from .config import LordfastConfig  # noqa: E402,F401
