"""T-PatchGAN video discriminator with spectral normalization (port of
`vosesam_tpu/models/e2fgvi/discriminator.py`).

Reference: inpainter/model/e2fgvi_hq.py:271-344 (six 3-D convolutions,
kernel (3, 5, 5), stride (1, 2, 2), LeakyReLU 0.2, spectral norm on all but
the last) and the vendored torch spectral norm
(inpainter/model/modules/spectral_norm.py:8-160: power iteration on the
(out, rest) weight matrix).

`Discriminator` holds the reference's state-dict names: `conv.{0,2,4,6,8}`
carry `weight_orig` (O, I, kt, kh, kw) and the power-iteration buffers
`weight_u` (O,) / `weight_v` (I kt kh kw,), `conv.10` a plain `weight` and
`bias`. Spectral norm is functional, as in the JAX package: no forward
hook. `spectral_normalize` returns the normalized weight and the (possibly
iterated) vectors; `discriminator_forward(update_sn=True)` stores the new
vectors in place of the old buffers (new tensors, so a graph that used the
old ones is left intact), and with `update_sn=False` reads them as they
are. u and v never get a gradient. Activations are (B, T, H, W, C), the JAX
package's layout.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vosesam_tpu_torch.device import DeviceLike, resolve_device

NF = 32
_EPS = 1e-12
KERNEL = (3, 5, 5)
STRIDE = (1, 2, 2)
# layer 0 pads 1 on every axis (the reference's `padding=1`), the rest (1, 2, 2)
PADDINGS = ((1, 1, 1),) + ((1, 2, 2),) * 5


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x), min=_EPS)


class SNConv3d(nn.Module):
    """A bias-free 3-D convolution under spectral norm: `weight_orig` and the
    buffers `weight_u`, `weight_v` (spectral_norm.py's names)."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.weight_orig = nn.Parameter(torch.zeros(cout, cin, *KERNEL))
        self.register_buffer("weight_u", torch.zeros(cout))
        self.register_buffer("weight_v", torch.zeros(cin * math.prod(KERNEL)))


class Discriminator(nn.Module):
    """e2fgvi_hq.py:271-336: `conv` is the reference's nn.Sequential, the
    convolutions at even indices, LeakyReLU(0.2) between them."""

    def __init__(self, in_channels: int = 3, use_spectral_norm: bool = True) -> None:
        super().__init__()
        chans = [(in_channels, NF), (NF, NF * 2), (NF * 2, NF * 4),
                 (NF * 4, NF * 4), (NF * 4, NF * 4), (NF * 4, NF * 4)]
        layers = []
        for i, (cin, cout) in enumerate(chans):
            if use_spectral_norm and i < 5:
                layers.append(SNConv3d(cin, cout))
            else:
                layers.append(nn.Conv3d(cin, cout, KERNEL, STRIDE, PADDINGS[i]))
            if i < 5:
                layers.append(nn.LeakyReLU(0.2))
        self.conv = nn.Sequential(*layers)


def spectral_normalize(
    weight: torch.Tensor,   # (cout, cin, kt, kh, kw)
    u: torch.Tensor,        # (cout,)
    v: torch.Tensor,        # (cin * kt * kh * kw,)
    update: bool = False,
    n_power_iterations: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """W / sigma_max(W) with torch SpectralNorm semantics on the (cout, rest)
    reshape of the weight: (w_sn, u, v). With `update`, `n_power_iterations`
    steps v = normalize(W^T u), u = normalize(W v) first. u and v are
    buffers: the iteration runs without a gradient and sigma = u . (W v)
    differentiates through W alone."""
    wm = weight.reshape(weight.shape[0], -1)
    u, v = u.detach(), v.detach()
    if update:
        with torch.no_grad():
            for _ in range(n_power_iterations):
                v = _l2norm(wm.T @ u)
                u = _l2norm(wm @ v)
    sigma = u @ (wm @ v)
    return weight / sigma, u, v


@torch.no_grad()
def discriminator_init(in_channels: int = 3, use_spectral_norm: bool = True, seed: int = 0,
                       device: DeviceLike = None) -> Discriminator:
    """Seeded random weights with the JAX package's scheme: He-normal
    weights (2 / (kt kh kw cin)), zero biases, unit-norm random u and v.
    The numbers differ from jax.random's, the distributions do not."""
    net = Discriminator(in_channels, use_spectral_norm)
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    for layer in net.conv:
        if isinstance(layer, SNConv3d):
            w = layer.weight_orig
            layer.weight_u.copy_(_l2norm(draw(*layer.weight_u.shape)))
            layer.weight_v.copy_(_l2norm(draw(*layer.weight_v.shape)))
        elif isinstance(layer, nn.Conv3d):
            w = layer.weight
            layer.bias.zero_()
        else:
            continue
        w.copy_(draw(*w.shape) * math.sqrt(2.0 / math.prod(w.shape[1:])))
    return net.to(resolve_device(device))


def discriminator_forward(
    net: Discriminator,
    video: torch.Tensor,       # (B, T, H, W, C) in [-1, 1]
    use_sigmoid: bool = False,
    update_sn: bool = False,
) -> torch.Tensor:
    """e2fgvi_hq.py:338-344: (B, T', H', W', C') patch logits. With
    `update_sn`, each spectral-norm layer takes one power-iteration step
    and keeps the new u and v."""
    x = video.permute(0, 4, 1, 2, 3)
    convs = [m for m in net.conv if not isinstance(m, nn.LeakyReLU)]
    for i, layer in enumerate(convs):
        if isinstance(layer, SNConv3d):
            w, u, v = spectral_normalize(layer.weight_orig, layer.weight_u, layer.weight_v,
                                         update=update_sn)
            if update_sn:
                layer.weight_u, layer.weight_v = u, v
            x = F.conv3d(x, w.to(x.dtype), None, STRIDE, PADDINGS[i])
        else:
            x = F.conv3d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), STRIDE,
                         PADDINGS[i])
        if i < 5:
            x = F.leaky_relu(x, 0.2)
    if use_sigmoid:
        x = torch.sigmoid(x)
    return x.permute(0, 2, 3, 4, 1)
