"""Whole-window attention with a factorised relative-position bias (B4, B5):

    out = softmax(scale * q.k^T + bh[q, k // ww] + bw[q, k % ww]) . v,
    scale = 1 / sqrt(D),

over (W, heads, T, D) tensors whose T = wh * ww tokens are one window on a
row-major grid. Replaces the two Pallas TPU kernels
`vosesam_tpu/ops/pallas/flash_attention.py:161 window_attention_relpos` and
`:258 window_attention_relpos_mh`, which run the SAM ViT's windowed blocks
under `windowed_attention_impl="pallas"` / `"pallas_mh"`. The two compute
one function and differ only in their TPU grid, so for CUDA tensors both
wrappers launch the one hand-written kernel `csrc/window_attention.cu` (its
header says what bounds it on the H100 and what the design does about it:
4-warp blocks over (window, head, 64 query rows), 64-key chunks streamed
through a cp.async ring with an online softmax); each counts its launches
under its own name. `occupancy` reports what the card makes of an instance.

q, k and v may be strided views (any window, head and token strides, dense
last axis): the encoder passes the slices of its fused qkv projection as
they are. The result has shape (W, heads, T, D) over (W, T, heads, D)
memory, so that `out.transpose(1, 2).reshape(W, T, heads * D)` is a view.

Beside them, `window_attention_relpos_plain` computes the same function
plainly, as the JAX encoder's "xla" path does: fp32 scores with the bias
materialised, fp32 softmax, probabilities cast to v's dtype, AV product with
fp32 accumulation. The wrappers take it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from vosesam_tpu_torch.ops.kernels._autograd import refuse_grad

# Launches of the kernel under each TPU kernel's name, and plain calls.
COUNTS: Dict[str, int] = {"window_attention_relpos": 0,
                          "window_attention_relpos_mh": 0, "plain": 0}

MAX_HEAD_DIM = 128
MAX_TOKENS = 256


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def window_attention_relpos_plain(q, k, v, bias_h, bias_w,
                                  window_hw: Tuple[int, int]) -> torch.Tensor:
    """The same function with the (W, heads, T, T) bias and scores
    materialised."""
    COUNTS["plain"] += 1
    w, heads, t, d = q.shape
    bias = (bias_h.float()[..., :, None] + bias_w.float()[..., None, :]).reshape(w, heads, t, t)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d)) + bias
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _lib() -> ctypes.CDLL:
    from vosesam_tpu_torch.ops.kernels import _build

    lib = _build.load("window_attention")
    fn = lib.vosesam_window_attention_relpos
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


OCCUPANCY_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                  "blocks_per_sm", "threads_per_block", "local_bytes")


def occupancy(dtype: torch.dtype, window_hw: Tuple[int, int], d: int) -> Dict[str, int]:
    """Registers, shared memory and resident blocks per SM of the kernel
    instance that a launch at these shapes selects, as the card reports them
    (`cudaFuncGetAttributes`, `cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    wh, ww = window_hw
    fn = _lib().vosesam_window_attention_occupancy
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
    info = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    rc = fn(int(dtype == torch.bfloat16), wh * ww, d, wh, ww, info)
    if rc != 0:
        raise RuntimeError(f"window_attention occupancy query failed: CUDA error {rc}")
    return dict(zip(OCCUPANCY_KEYS, info))


def _check(q, k, v, bias_h, bias_w, window_hw, fn: str = "window_attention_relpos") -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: q must be float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"{fn}: q must be (W, heads, T, D), got {tuple(q.shape)}")
    w, heads, t, d = q.shape
    wh, ww = window_hw
    if wh * ww != t:
        raise ValueError(f"{fn}: T = {t} != wh * ww = {wh} * {ww}")
    if not 1 <= t <= MAX_TOKENS:
        raise ValueError(f"{fn}: {t} tokens per window not in [1, {MAX_TOKENS}]")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head dim {d} not in [1, {MAX_HEAD_DIM}]")
    for name, x, shape, dtype in (("k", k, q.shape, q.dtype), ("v", v, q.shape, q.dtype),
                                  ("bias_h", bias_h, (w, heads, t, wh), torch.float32),
                                  ("bias_w", bias_w, (w, heads, t, ww), torch.float32)):
        if x.device != q.device:
            raise ValueError(f"{fn}: {name} is on {x.device}, q on {q.device}")
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"{fn}: {name} must be {dtype} {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{fn}: {name} must be contiguous along its last axis")
    for name, x in (("bias_h", bias_h), ("bias_w", bias_w)):
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {q.device}")


def _run(name: str, q, k, v, bias_h, bias_w, window_hw) -> torch.Tensor:
    if q.device.type == "cpu":
        return window_attention_relpos_plain(q, k, v, bias_h, bias_w, window_hw)
    _check(q, k, v, bias_h, bias_w, window_hw, name)
    refuse_grad(name, q, k, v, bias_h, bias_w)
    w, heads, t, d = q.shape
    out = torch.empty((w, t, heads, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    rc = _lib().vosesam_window_attention_relpos(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(), bias_w.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), w, heads, t, d,
        int(window_hw[0]), int(window_hw[1]), strides, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    COUNTS[name] += 1
    return out


def window_attention_relpos(
    q: torch.Tensor,        # (W, heads, T, D), W windows (any batch folded in)
    k: torch.Tensor,        # (W, heads, T, D)
    v: torch.Tensor,        # (W, heads, T, D)
    bias_h: torch.Tensor,   # (W, heads, T, wh) fp32 factorised row bias
    bias_w: torch.Tensor,   # (W, heads, T, ww) fp32 factorised column bias
    window_hw: Tuple[int, int],
) -> torch.Tensor:
    """(W, heads, T, D) attention output in q's dtype (B4)."""
    return _run("window_attention_relpos", q, k, v, bias_h, bias_w, window_hw)


def window_attention_relpos_mh(q, k, v, bias_h, bias_w,
                               window_hw: Tuple[int, int]) -> torch.Tensor:
    """The same function under the name of the TPU's heads-in-one-instance
    kernel (B5); on the card it is the same launch."""
    return _run("window_attention_relpos_mh", q, k, v, bias_h, bias_w, window_hw)
