"""Precision settings of the reference: float32 with TF32 off, and the
control's float8 (e4m3, one scale per tensor, float32 accumulation), which
quantizes both operands of every matrix product and convolution."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


@contextlib.contextmanager
def tf32_off() -> Iterator[None]:
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale, back in x's dtype."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return x
    s = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)


_TWO_OPERANDS = {F.linear, F.conv2d, F.conv_transpose2d}
_ALL_OPERANDS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.bmm,
                 torch.mm, torch.einsum}


class Float8Products(TorchFunctionMode):
    """Every product's operands in float8: (input, weight) of a linear
    layer or convolution, every operand of a matmul or einsum."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _TWO_OPERANDS:
            args = (fp8(args[0]), fp8(args[1])) + tuple(args[2:])
        elif func in _ALL_OPERANDS:
            args = tuple([fp8(t) for t in a] if isinstance(a, (list, tuple)) else fp8(a)
                         for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def mode(name: str) -> Iterator[None]:
    """"fp32": the reference; "fp8": the control."""
    with tf32_off():
        if name == "fp32":
            yield
        elif name == "fp8":
            with Float8Products():
                yield
        else:
            raise ValueError(f"unknown precision {name!r}")
