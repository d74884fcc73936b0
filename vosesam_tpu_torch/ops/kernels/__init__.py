"""Hand-written CUDA kernels (sources in vosesam_tpu_torch/csrc/), their ctypes
wrappers and plain PyTorch versions."""
