"""vosesam_tpu_torch — the PyTorch/CUDA port of vosesam_tpu.

The JAX package `vosesam_tpu` stays the reference; this package mirrors its
module layout and public names so each module's counterpart is easy to find
(`vosesam_tpu/memory/manager.py` -> `vosesam_tpu_torch/memory/manager.py`).
It imports torch and never jax, and nothing of `vosesam_tpu`.

Every TPU (Pallas) kernel on the ported path is a hand-written Hopper
kernel: CUDA C++ sources under `csrc/`, built with nvcc on first use and
bound with ctypes (`ops/kernels/`). Each kernel wrapper keeps a plain
PyTorch version beside it, used for CPU tensors only.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

from vosesam_tpu_torch.config import (  # noqa: F401
    FrameworkConfig,
    MemoryConfig,
    RefinementConfig,
    SAMConfig,
    XMemConfig,
)
