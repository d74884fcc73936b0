"""Global attention with a factorised relative-position bias (B3):

    out = softmax(scale * q.k^T + bh[q, k // gw] + bw[q, k % gw]) . v,
    scale = 1 / sqrt(D),

over (B, heads, N, D) tensors whose N = gh * gw keys lie on a row-major
token grid. Replaces the Pallas TPU kernel
`vosesam_tpu/ops/pallas/flash_attention.py:307 flash_attention_relpos`,
which runs the SAM ViT's global-attention blocks. For CUDA tensors the
wrapper launches the hand-written kernel `csrc/flash_attention.cu` (its
header says what bounds it on the H100 and what the design does about it:
blocks of two warpgroups over 128 query rows, 64-key K / V tiles by TMA
into a two-stage ring, wgmma products); the (N, N) bias never reaches device
memory. `occupancy` reports what the card makes of an instance, `uses_tma`
how a launch on given views stages them.

q, k and v may be strided views (any batch, head and token strides, dense
last axis): the encoder passes the slices of its fused qkv projection as
they are. The kernel's result has shape (B, heads, N, D) over (B, N, heads,
D) memory, so that `out.transpose(1, 2).reshape(B, N, heads * D)` is a view.

Beside it, `flash_attention_relpos_plain` computes the same function
plainly on the same views: it materialises the bias, runs an fp32 softmax,
casts the probabilities to v's dtype and does the AV product with fp32
accumulation (the XLA path of the JAX encoder). The wrapper takes it only
for tensors on the CPU. `COUNTS` counts kernel launches and plain calls.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from vosesam_tpu_torch.ops.kernels._autograd import refuse_grad

# Launches of the kernel, and calls of the plain version.
COUNTS: Dict[str, int] = {"flash_attention_relpos": 0, "plain": 0}

MAX_HEAD_DIM = 128


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def flash_attention_relpos_plain(q, k, v, bias_h, bias_w,
                                 grid_hw: Tuple[int, int]) -> torch.Tensor:
    """The same function with the (B, heads, N, N) bias and scores
    materialised."""
    COUNTS["plain"] += 1
    b, heads, n, d = q.shape
    bias = (bias_h.float()[..., :, None] + bias_w.float()[..., None, :]).reshape(b, heads, n, n)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d)) + bias
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _lib() -> ctypes.CDLL:
    from vosesam_tpu_torch.ops.kernels import _build

    lib = _build.load("flash_attention")
    fn = lib.vosesam_flash_attention_relpos
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


OCCUPANCY_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                  "blocks_per_sm", "threads_per_block", "local_bytes")


def occupancy(dtype: torch.dtype, grid_hw: Tuple[int, int], d: int) -> Dict[str, int]:
    """Registers, shared memory and resident blocks per SM of the kernel
    instance that a launch at these shapes selects, as the card reports them
    (`cudaFuncGetAttributes`, `cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    gh, gw = grid_hw
    fn = _lib().vosesam_flash_attention_occupancy
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
    info = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    rc = fn(int(dtype == torch.bfloat16), d, gh, gw, info)
    if rc != 0:
        raise RuntimeError(f"flash_attention occupancy query failed: CUDA error {rc}")
    return dict(zip(OCCUPANCY_KEYS, info))


def _strides(q, k, v, out):
    return (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))


def _output(q):
    """The kernel's output: (B, heads, N, D) over (B, N, heads, D) memory."""
    b, heads, n, d = q.shape
    return torch.empty((b, n, heads, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def uses_tma(q, k, v) -> bool:
    """Whether a bf16 launch on these tensors stages q / k / v by TMA (else
    by plain loads: D % 8 != 0, a view unaligned or with a stride-0 axis)."""
    fn = _lib().vosesam_flash_attention_uses_tma
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = i
    out = _output(q)
    b, heads, n, d = q.shape
    return bool(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, heads, n, d,
                   _strides(q, k, v, out)))


def _check(q, k, v, bias_h, bias_w, grid_hw) -> None:
    fn = "flash_attention_relpos"
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: q must be float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"{fn}: q must be (B, heads, N, D), got {tuple(q.shape)}")
    b, heads, n, d = q.shape
    gh, gw = grid_hw
    if gh * gw != n:
        raise ValueError(f"{fn}: N = {n} != gh * gw = {gh} * {gw}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head dim {d} not in [1, {MAX_HEAD_DIM}]")
    for name, t, shape, dtype in (("k", k, q.shape, q.dtype), ("v", v, q.shape, q.dtype),
                                  ("bias_h", bias_h, (b, heads, n, gh), torch.float32),
                                  ("bias_w", bias_w, (b, heads, n, gw), torch.float32)):
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, q on {q.device}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{fn}: {name} must be {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{fn}: {name} must be contiguous along its last axis")
    for name, t in (("bias_h", bias_h), ("bias_w", bias_w)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {q.device}")


def flash_attention_relpos(
    q: torch.Tensor,        # (B, heads, N, D), any strides with a dense last axis
    k: torch.Tensor,        # (B, heads, N, D)
    v: torch.Tensor,        # (B, heads, N, D)
    bias_h: torch.Tensor,   # (B, heads, N, gh) fp32 factorised row bias
    bias_w: torch.Tensor,   # (B, heads, N, gw) fp32 factorised column bias
    grid_hw: Tuple[int, int],
) -> torch.Tensor:
    """(B, heads, N, D) attention output in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_relpos_plain(q, k, v, bias_h, bias_w, grid_hw)
    _check(q, k, v, bias_h, bias_w, grid_hw)
    refuse_grad("flash_attention_relpos", q, k, v, bias_h, bias_w)
    b, heads, n, d = q.shape
    out = _output(q)
    strides = _strides(q, k, v, out)
    rc = _lib().vosesam_flash_attention_relpos(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(), bias_w.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), b, heads, n, d,
        int(grid_hw[0]), int(grid_hw[1]), strides, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_relpos kernel launch failed: CUDA error {rc}")
    COUNTS["flash_attention_relpos"] += 1
    return out
