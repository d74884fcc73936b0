"""Layer library of the port (counterpart of `vosesam_tpu/models/layers.py`).

Parameters live in `nn.Module`s whose state-dict names are the official
PyTorch checkpoint names (`weight`, `bias`, `running_mean`, ...), kept in
fp32; every layer casts them to the activation dtype at call time, so a bf16
activation runs a bf16 convolution with fp32 master weights
(`FrameworkConfig.dtype` / `param_dtype`). Inside the models activations are
NCHW, PyTorch's layout; the models' public functions take and return the JAX
package's channel-last layout.

`init_like_jax` draws random parameters with the JAX `*_init` scheme
(He-normal fan-out convolutions, `layers.py:31-35`) from a numpy generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


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


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation, conv.groups)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    w = lin.weight.to(x.dtype)
    b = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, w, b)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """NCHW inference BN from running statistics."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    w = bn.weight.float()
    scale = (w * inv).to(x.dtype)
    shift = (bn.bias.float() - bn.running_mean.float() * w * inv).to(x.dtype)
    return x * scale[:, None, None] + shift[:, None, None]


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
