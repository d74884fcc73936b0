"""Layer library of the port (counterpart of `vosesam_tpu/models/layers.py`).

Parameters live in `nn.Module`s whose state-dict names are the official
PyTorch checkpoint names (`weight`, `bias`, `running_mean`, ...), kept in
`FrameworkConfig.param_dtype`; a bf16 activation runs a bf16 convolution with
fp32 master weights. What a layer derives from its parameters alone (the
weight and bias in the activation dtype, BN's scale and shift, LayerNorm's
fp32 affine) is computed by the same expressions on first use and kept on the
module (`_derived`), one entry per activation dtype and device, while
`stamp_holds`: the port's one rule for what is derived from parameters (XMem's
key-encoder graphs use it too). With grad enabled nothing is kept or read:
training sees the call-time graph. `PARAM_CACHE_COUNTS` counts hits, misses
(builds) and those bypasses.

`layer_norm` runs the hand-written kernel of `ops/kernels/layer_norm.py`
for every CUDA tensor outside autograd, with the residual add before it
when given one, and raises for an input the kernel has no instance for; the
plain fp32 chain runs on the CPU and where autograd wants a graph (the
inpainter's trainer), as the kernel has no backward.

Inside the models activations are NCHW, PyTorch's layout; the models' public
functions take and return the JAX package's channel-last layout.

`init_like_jax` draws random parameters with the JAX `*_init` scheme
(He-normal fan-out convolutions, `layers.py:31-35`) from a numpy generator.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vosesam_tpu_torch.ops.kernels import layer_norm as lnk


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self)


class Linear(nn.Linear):
    """nn.Linear that runs in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self)


class BatchNorm2d(nn.BatchNorm2d):
    """Inference-mode batch norm with fp32 scale/shift cast to the input's
    dtype (`layers.py:126-134`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self)


# Calls of the helpers below that reused kept tensors, that built them, and
# that ran with grad enabled, keeping nothing.
PARAM_CACHE_COUNTS: Dict[str, int] = {"hit": 0, "miss": 0, "bypass": 0}


def reset_param_cache_counts() -> None:
    for name in PARAM_CACHE_COUNTS:
        PARAM_CACHE_COUNTS[name] = 0


def _meta(tensors: Sequence[torch.Tensor]) -> List[Tuple]:
    return [(id(t), t._version, t.data_ptr(), t.dtype, t.shape, t.stride()) for t in tensors]


def param_stamp(tensors: Sequence[torch.Tensor]) -> Tuple:
    """A stamp of `tensors` for `stamp_holds`. While it lives it keeps each
    tensor, so no other object takes its id, and a detached alias of each,
    so no other tensor takes its address."""
    return tuple(tensors), tuple(t.detach() for t in tensors), _meta(tensors)


def stamp_holds(stamp: Tuple, tensors: Sequence[torch.Tensor]) -> bool:
    """Whether `tensors` are the objects `stamp` recorded, each at the same
    `_version`, `data_ptr()`, dtype, shape and strides: `copy_`, `.data =`,
    `module.to` and a replaced or re-wrapped parameter or module all fail it."""
    return _meta(tensors) == stamp[2]


def _derived(module: nn.Module, key: Tuple, sources: Tuple[torch.Tensor, ...],
             build: Callable[[], Tuple]) -> Tuple:
    """`build()`, kept on `module` under `key` while `sources` hold its stamp.
    Each key keeps its own entry; a miss drops those that `sources` fail."""
    if torch.is_grad_enabled():
        PARAM_CACHE_COUNTS["bypass"] += 1
        return build()
    entries = module.__dict__.get("_derived_params", {})
    entry = entries.get(key)
    if entry is not None and stamp_holds(entry[0], sources):
        PARAM_CACHE_COUNTS["hit"] += 1
        return entry[1]
    PARAM_CACHE_COUNTS["miss"] += 1
    out = build()
    entries = {k: e for k, e in entries.items() if stamp_holds(e[0], sources)}
    entries[key] = (param_stamp(sources), out)
    module.__dict__["_derived_params"] = entries
    return out


def _cast_params(mod: nn.Module, x: torch.Tensor):
    """(weight, bias or None) of `mod` in `x`'s dtype."""
    w, b = mod.weight, mod.bias
    sources = (w,) if b is None else (w, b)
    return _derived(mod, (x.dtype, x.device), sources,
                    lambda: (w.to(x.dtype), None if b is None else b.to(x.dtype)))


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    w, b = _cast_params(conv, x)
    return F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation, conv.groups)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    w, b = _cast_params(lin, x)
    return F.linear(x, w, b)


def _bn_scale_shift(bn: nn.BatchNorm2d, dtype: torch.dtype):
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    w = bn.weight.float()
    scale = (w * inv).to(dtype)
    shift = (bn.bias.float() - bn.running_mean.float() * w * inv).to(dtype)
    return scale[:, None, None], shift[:, None, None]


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """NCHW inference BN from running statistics."""
    scale, shift = _derived(
        bn, (x.dtype, x.device, bn.eps),
        (bn.weight, bn.bias, bn.running_mean, bn.running_var),
        lambda: _bn_scale_shift(bn, x.dtype))
    return x * scale + shift


def conv_transpose2d(x: torch.Tensor, conv: nn.ConvTranspose2d) -> torch.Tensor:
    """NCHW transposed convolution with the official IOHW weight, in the
    input's dtype. The JAX package stores the same kernel HWIO and flips it
    (`layers.py:104-123`); `utils/checkpoint.py` converts between the two."""
    w, b = _cast_params(conv, x)
    return F.conv_transpose2d(x, w, b, conv.stride, conv.padding)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, eps: float = 1e-6,
               residual: Optional[torch.Tensor] = None):
    """LayerNorm over the last axis computed in fp32 and cast back
    (`layers.py:137-141`; eps 1e-6 by default, as the JAX package; the
    E2FGVI generator's focal blocks pass the published 1e-5). With
    `residual` it normalises x + residual, rounded to the activations' dtype
    as the sum is, and returns (normed, sum).

    On the card one hand-written kernel computes both, and an input it has
    no instance for raises ValueError (`ops/kernels/layer_norm.layout`
    says which); the plain chain runs on the CPU, and where grad mode is on
    and a tensor requires grad."""
    w, b = _derived(ln, (x.device,), (ln.weight, ln.bias),
                    lambda: lnk.affine(ln.weight, ln.bias))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, residual, w, b)):
        y, s = lnk.layer_norm_plain(x, w, b, eps, residual)
    else:
        y, s = lnk.layer_norm_fused(x, w, b, eps, residual)
    return y if residual is None else (y, s)


def layer_norm_chw(x: torch.Tensor, ln: nn.LayerNorm, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the channel axis of NCHW x (the official LayerNorm2d).
    On the card the channel-last view is copied dense first, as the kernel
    takes only a dense channel axis; on the CPU the chain runs on the view,
    as it always has."""
    y = x.permute(0, 2, 3, 1)
    if y.device.type != "cpu":
        y = y.contiguous()
    return layer_norm(y, ln, eps).permute(0, 3, 1, 2)


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu in bf16, exact erf otherwise (`layers.py:181-196`)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: int = 1) -> torch.Tensor:
    """NCHW max pool; the padding never wins (it is -inf)."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C) mean over H, W."""
    return x.mean(dim=(-2, -1))


def max_pool_global(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C) max over H, W."""
    return x.amax(dim=(-2, -1))


def interpolate_bilinear(x: torch.Tensor, scale: float) -> torch.Tensor:
    """NCHW bilinear resize by `scale` with half-pixel centres — what
    `jax.image.resize(method="linear")` does when it upsamples (the only use,
    x2 and x4), edge rows included."""
    h, w = x.shape[-2], x.shape[-1]
    return F.interpolate(x, size=(int(h * scale), int(w * scale)),
                         mode="bilinear", align_corners=False)


# ----------------------------------------------------------------------- init

@torch.no_grad()
def init_like_jax(module: nn.Module, rng: np.random.Generator) -> None:
    """Random parameters with the JAX package's init scheme (`conv_init`,
    `linear_init`, `bn_init`): conv weight ~ N(0, 2 / (kh*kw*cout)), conv and
    linear biases ~ U(±1/sqrt(fan_in)), linear weight ~ U(±1/sqrt(cin)), BN
    identity. Draws in module order from `rng`; the numbers differ from
    jax.random's, the ranges do not."""
    for mod in module.modules():
        if isinstance(mod, nn.Conv2d):
            cout, cin, kh, kw = mod.weight.shape
            std = math.sqrt(2.0 / (kh * kw * cout))
            mod.weight.copy_(torch.from_numpy(
                rng.standard_normal(mod.weight.shape).astype(np.float32) * std))
            if mod.bias is not None:
                bound = 1.0 / math.sqrt(kh * kw * cin)
                mod.bias.copy_(torch.from_numpy(
                    rng.uniform(-bound, bound, mod.bias.shape).astype(np.float32)))
        elif isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            mod.weight.copy_(torch.from_numpy(
                rng.uniform(-bound, bound, mod.weight.shape).astype(np.float32)))
            if mod.bias is not None:
                mod.bias.copy_(torch.from_numpy(
                    rng.uniform(-bound, bound, mod.bias.shape).astype(np.float32)))
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
