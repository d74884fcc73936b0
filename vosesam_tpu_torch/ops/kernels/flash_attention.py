"""Global attention with a factorised relative-position bias (B3):

    out = softmax(scale * q.k^T + bh[q, k // gw] + bw[q, k % gw]) . v,
    scale = 1 / sqrt(D),

over (BH, N, D) tensors whose N = gh * gw keys lie on a row-major token
grid. Replaces the Pallas TPU kernel
`vosesam_tpu/ops/pallas/flash_attention.py:307 flash_attention_relpos`,
which runs the SAM ViT's global-attention blocks. For CUDA tensors the
wrapper launches the hand-written kernel `csrc/flash_attention.cu` (its
header says what bounds it on the H100 and what the design does about it);
the (N, N) bias never reaches device memory.

Beside it, `flash_attention_relpos_plain` computes the same function
plainly: it materialises the bias, runs an fp32 softmax, casts the
probabilities to v's dtype and does the AV product with fp32 accumulation
(the XLA path of the JAX encoder). The wrapper takes it only for tensors on
the CPU. `COUNTS` counts kernel launches and plain calls.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

# Launches of the kernel, and calls of the plain version.
COUNTS: Dict[str, int] = {"flash_attention_relpos": 0, "plain": 0}

MAX_HEAD_DIM = 128


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def flash_attention_relpos_plain(q, k, v, bias_h, bias_w,
                                 grid_hw: Tuple[int, int]) -> torch.Tensor:
    """The same function with the (BH, N, N) bias and scores materialised."""
    COUNTS["plain"] += 1
    bh_, n, d = q.shape
    gh, gw = grid_hw
    bias = (bias_h.float()[..., :, None] + bias_w.float()[..., None, :]).reshape(bh_, n, n)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d)) + bias
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _lib() -> ctypes.CDLL:
    from vosesam_tpu_torch.ops.kernels import _build

    lib = _build.load("flash_attention")
    fn = lib.vosesam_flash_attention_relpos
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, bias_h, bias_w, grid_hw) -> None:
    fn = "flash_attention_relpos"
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: q must be float32 or bfloat16, got {q.dtype}")
    if q.ndim != 3:
        raise ValueError(f"{fn}: q must be (BH, N, D), got {tuple(q.shape)}")
    bh_, n, d = q.shape
    gh, gw = grid_hw
    if gh * gw != n:
        raise ValueError(f"{fn}: N = {n} != gh * gw = {gh} * {gw}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head dim {d} not in [1, {MAX_HEAD_DIM}]")
    for name, t, shape, dtype in (("k", k, q.shape, q.dtype), ("v", v, q.shape, q.dtype),
                                  ("bias_h", bias_h, (bh_, n, gh), torch.float32),
                                  ("bias_w", bias_w, (bh_, n, gw), torch.float32)):
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, q on {q.device}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{fn}: {name} must be {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias_h", bias_h), ("bias_w", bias_w)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {q.device}")


def flash_attention_relpos(
    q: torch.Tensor,        # (BH, N, D)
    k: torch.Tensor,        # (BH, N, D)
    v: torch.Tensor,        # (BH, N, D)
    bias_h: torch.Tensor,   # (BH, N, gh) fp32 factorised row bias
    bias_w: torch.Tensor,   # (BH, N, gw) fp32 factorised column bias
    grid_hw: Tuple[int, int],
) -> torch.Tensor:
    """(BH, N, D) attention output in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_relpos_plain(q, k, v, bias_h, bias_w, grid_hw)
    _check(q, k, v, bias_h, bias_w, grid_hw)
    bh_, n, d = q.shape
    out = torch.empty_like(q)
    rc = _lib().vosesam_flash_attention_relpos(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(), bias_w.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), bh_, n, d,
        int(grid_hw[0]), int(grid_hw[1]), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_relpos kernel launch failed: CUDA error {rc}")
    COUNTS["flash_attention_relpos"] += 1
    return out
