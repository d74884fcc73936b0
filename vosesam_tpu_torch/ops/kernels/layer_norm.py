"""LayerNorm over the channel axis with an optional residual added first:

    sum    = x + residual                  (in x's dtype; x when no residual)
    normed = (sum - mu) * rsqrt(var + eps) * weight + bias,

mu and var the mean and the (biased) variance of `sum` over the last axis,
computed in fp32 with the fp32 affine, and rounded once to x's dtype.
Replaces no TPU kernel: XLA fuses the JAX package's `layer_norm`
(`vosesam_tpu/models/layers.py`) into one or two loop fusions, which eager
PyTorch runs as ~12 kernels. For CUDA tensors the wrapper launches the
hand-written kernel `csrc/layer_norm.cu` (its header says what bounds it on
the H100 and what the design does about it: a warp per row, the row in
registers, 16-byte loads and stores).

x and the residual may be strided views with a dense channel axis (any
token strides: the SAM encoder's residual is a `window_unpartition` slice,
passed without a copy). `layout` gives the launch plan, or None where the
kernel has no instance: another dtype than bf16 or fp32, a channel axis
with a stride, C past 1,280 (vit_h's width, the port's widest) or not a
multiple of 16 bytes of values, a stride or pointer off 16 bytes, more
than three leading dims after merging. For a CUDA tensor
`layer_norm_fused` raises there; `models/layers.layer_norm` calls it for
every LayerNorm on the card outside autograd, so an input the kernel does
not take fails loudly instead of running the chain.

Beside it, `layer_norm_plain` computes the same function as the chain the
port ran before the kernel, expression for expression. `COUNTS` counts
kernel launches and plain calls.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from vosesam_tpu_torch.ops.kernels._autograd import refuse_grad

# Launches of the kernel, and calls of the plain version.
COUNTS: Dict[str, int] = {"layer_norm": 0, "plain": 0}

MAX_VALUES = 40          # fp32 values of a row a lane holds in registers: C <= 1280
DTYPES = (torch.bfloat16, torch.float32)


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     residual: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normed, sum) by the plain chain: fp32 statistics and affine, cast
    back to x's dtype."""
    COUNTS["plain"] += 1
    s = x if residual is None else x + residual
    xf = s.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(s.dtype), s


def affine(weight: torch.Tensor, bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 weight and bias that the kernel can load in 16-byte packs: each
    tensor itself where it is fp32 and 16-byte aligned, else an fp32 copy (a
    checkpoint's parameters may be views into one flat buffer, at any
    offset). The values are the same either way."""
    return tuple(t if t.dtype == torch.float32 and t.data_ptr() % 16 == 0
                 else t.float() if t.dtype != torch.float32 else t.clone()
                 for t in (weight, bias))


class Plan(NamedTuple):
    rows: int
    d1: int              # the rows' leading dims (rows // (d1 * d2), d1, d2)
    d2: int
    strides: Tuple[int, ...]    # x's three, then the residual's three (0s without)
    packs: int           # 16-byte packs a lane


def _leading(shape, tensors) -> Optional[Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]]:
    """The leading dims of `tensors` (all of `shape`) merged where every
    tensor's strides allow, as three sizes and each tensor's three strides;
    None if more than three remain."""
    if all(t.is_contiguous() for t in tensors):
        rows = math.prod(shape[:-1])
        return (1, 1, rows), ((0, 0, shape[-1]),) * len(tensors)
    dims = []
    for i, n in enumerate(shape[:-1]):
        if n == 1:
            continue
        st = tuple(t.stride(i) for t in tensors)
        if dims and all(p == s * n for p, s in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > 3:
        return None
    dims = [(1, (0,) * len(tensors))] * (3 - len(dims)) + dims
    return (tuple(n for n, _ in dims),
            tuple(tuple(st[k] for _, st in dims) for k in range(len(tensors))))


def layout(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           residual: Optional[torch.Tensor] = None) -> Optional[Plan]:
    """The launch plan for these tensors wherever they lie, or None where the
    kernel has no instance for them: dtype, a dense channel axis, matching
    residual, fp32 contiguous (C,) weight and bias, at most three leading
    dims after merging, C, strides and pointers in 16-byte packs, C within
    MAX_VALUES a lane of a warp."""
    if x.dtype not in DTYPES or x.ndim == 0 or x.stride(-1) != 1 or x.shape[-1] < 1:
        return None
    c = x.shape[-1]
    tensors = (x,) if residual is None else (x, residual)
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device or residual.stride(-1) != 1):
        return None
    for p in (weight, bias):
        if (p.dtype != torch.float32 or p.shape != (c,) or p.stride(0) != 1
                or p.device != x.device):
            return None
    lead = _leading(x.shape, tensors)
    if lead is None:
        return None
    (_, d1, d2), strides = lead
    strides = strides[0] + (strides[1] if residual is not None else (0, 0, 0))
    vec = 16 // x.element_size()
    if (c % vec or c > 32 * MAX_VALUES or any(s % vec for s in strides)
            or any(t.data_ptr() % 16 for t in (*tensors, weight, bias))):
        return None
    return Plan(math.prod(x.shape[:-1]), d1, d2, strides, -(-c // (32 * vec)))


def _lib() -> ctypes.CDLL:
    from vosesam_tpu_torch.ops.kernels import _build

    lib = _build.load("layer_norm")
    fn = lib.vosesam_layer_norm
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, ll, i, ll, ll, ctypes.POINTER(ll), ctypes.c_float,
                       i, p]
        fn.restype = i
    return lib


OCCUPANCY_KEYS = ("registers", "static_smem_bytes", "blocks_per_sm")


def occupancy(plan: Plan, dtype: torch.dtype) -> Dict[str, int]:
    """Registers, shared memory and resident blocks per SM of the instance
    `plan` selects, as the card reports them."""
    fn = _lib().vosesam_layer_norm_occupancy
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
    info = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    rc = fn(int(dtype == torch.bfloat16), plan.packs, info)
    if rc != 0:
        raise RuntimeError(f"layer_norm occupancy query failed: CUDA error {rc}")
    return dict(zip(OCCUPANCY_KEYS, info))


def layer_norm_fused(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     residual: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normed, sum): normed contiguous in x's dtype; sum x + residual,
    contiguous, or x itself without a residual. CPU tensors take the plain
    version; CUDA tensors the kernel, or ValueError where it has no
    instance for them."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, residual)
    plan = layout(x, weight, bias, residual)
    if plan is None:
        raise ValueError(
            f"layer_norm_fused: no kernel instance for x {x.dtype} {tuple(x.shape)} strides "
            f"{x.stride()}, residual "
            f"{None if residual is None else (residual.dtype, residual.stride())}, weight "
            f"{weight.dtype} {tuple(weight.shape)}, bias {bias.dtype} {tuple(bias.shape)}")
    refuse_grad("layer_norm_fused", x, residual, weight, bias)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s = x if residual is None else torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if plan.rows == 0:
        return out, s
    rc = _lib().vosesam_layer_norm(
        x.data_ptr(), None if residual is None else residual.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), out.data_ptr(), None if residual is None else s.data_ptr(),
        int(x.dtype == torch.bfloat16), plan.rows, x.shape[-1], plan.d1, plan.d2,
        (ctypes.c_longlong * 6)(*plan.strides), float(eps), plan.packs,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {rc}")
    COUNTS["layer_norm"] += 1
    return out, s
