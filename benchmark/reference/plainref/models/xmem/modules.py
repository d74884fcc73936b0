"""XMem building blocks (port of `vosesam_tpu/models/xmem/modules.py`).

Reference: tracker/model/modules.py + group_modules.py. Image features are
(C, H, W); group (per-object) features are (O, C, H, W) with the object axis
on the batch axis, NCHW throughout. State-dict names are the official ones.
The GRUs keep the reference's non-standard gate order (modules.py:65-67,
kept for checkpoint parity):
    new_h = forget*h*(1-update) + update*tanh(new_value)
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from plainref.models.cbam import CBAM
from plainref.models.layers import Conv2d, interpolate_bilinear


# ------------------------------------------------------------- group helpers

def distribute(x: torch.Tensor, g: torch.Tensor, method: str = "cat") -> torch.Tensor:
    """Broadcast image features x (C, H, W) onto the object axis of g
    (O, Cg, H, W) (MainToGroupDistributor, group_modules.py:58-80)."""
    xb = x[None].expand(g.shape[0], *x.shape)
    if method == "cat":
        return torch.cat([xb, g], dim=1)
    if method == "add":
        return xb + g
    raise NotImplementedError(method)


def upsample_groups(g: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    return interpolate_bilinear(g, float(ratio))


def downsample_groups_area(g: torch.Tensor, factor: int) -> torch.Tensor:
    """'area' downsampling by an integer factor = average pooling
    (group_modules.py:25)."""
    return F.avg_pool2d(g, factor, factor)


def gru_gate(values: torch.Tensor, h: torch.Tensor, hidden_dim: int) -> torch.Tensor:
    """The XMem GRU update shared by HiddenUpdater and HiddenReinforcer
    (modules.py:61-74 / :90-99), channels on dim 1."""
    forget = torch.sigmoid(values[:, :hidden_dim])
    update = torch.sigmoid(values[:, hidden_dim:hidden_dim * 2])
    new_value = torch.tanh(values[:, hidden_dim * 2:])
    return forget * h * (1 - update) + update * new_value


# ------------------------------------------------------------------- blocks

class GroupResBlock(nn.Module):
    """Pre-activation residual block (group_modules.py:36-54)."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.downsample = Conv2d(cin, cout, 3, padding=1) if cin != cout else None

    def forward(self, g: torch.Tensor) -> torch.Tensor:
        y = self.conv1(torch.relu(g))
        y = self.conv2(torch.relu(y))
        if self.downsample is not None:
            g = self.downsample(g)
        return y + g


class FeatureFusionBlock(nn.Module):
    """Distribute-cat, resblock, CBAM residual, resblock (modules.py:22-41)."""

    def __init__(self, x_in: int, g_in: int, g_mid: int, g_out: int) -> None:
        super().__init__()
        self.block1 = GroupResBlock(x_in + g_in, g_mid)
        self.attention = CBAM(g_mid)
        self.block2 = GroupResBlock(g_mid, g_out)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        g = self.block1(distribute(x, g))
        r = self.attention(g)
        return self.block2(g + r)


class HiddenUpdater(nn.Module):
    """Decoder GRU over multi-scale group features (modules.py:44-74)."""

    def __init__(self, g_dims: Tuple[int, int, int], mid_dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.hidden_dim = hidden_dim
        self.g16_conv = Conv2d(g_dims[0], mid_dim, 1)
        self.g8_conv = Conv2d(g_dims[1], mid_dim, 1)
        self.g4_conv = Conv2d(g_dims[2], mid_dim, 1)
        self.transform = Conv2d(mid_dim + hidden_dim, hidden_dim * 3, 3, padding=1)

    def forward(self, g16, g8, g4, h) -> torch.Tensor:
        g = (self.g16_conv(g16)
             + self.g8_conv(downsample_groups_area(g8, 2))
             + self.g4_conv(downsample_groups_area(g4, 4)))
        values = self.transform(torch.cat([g, h], dim=1))
        return gru_gate(values, h, self.hidden_dim)


class HiddenReinforcer(nn.Module):
    """Value-encoder GRU (modules.py:77-99)."""

    def __init__(self, g_dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.hidden_dim = hidden_dim
        self.transform = Conv2d(g_dim + hidden_dim, hidden_dim * 3, 3, padding=1)

    def forward(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        values = self.transform(torch.cat([g, h], dim=1))
        return gru_gate(values, h, self.hidden_dim)


class KeyProjection(nn.Module):
    """key, shrinkage = d² + 1, selection = σ(e) (modules.py:194-211)."""

    def __init__(self, in_dim: int, key_dim: int) -> None:
        super().__init__()
        self.key_proj = Conv2d(in_dim, key_dim, 3, padding=1)
        self.d_proj = Conv2d(in_dim, 1, 3, padding=1)
        self.e_proj = Conv2d(in_dim, key_dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        shrinkage = torch.square(self.d_proj(x)) + 1
        selection = torch.sigmoid(self.e_proj(x))
        return self.key_proj(x), shrinkage, selection


class UpsampleBlock(nn.Module):
    """Skip conv + x2 bilinear + add + GroupResBlock (modules.py:178-192)."""

    def __init__(self, skip_dim: int, g_up_dim: int, g_out_dim: int) -> None:
        super().__init__()
        self.skip_conv = Conv2d(skip_dim, g_up_dim, 3, padding=1)
        self.out_conv = GroupResBlock(g_up_dim, g_out_dim)

    def forward(self, skip_f: torch.Tensor, up_g: torch.Tensor) -> torch.Tensor:
        skip = self.skip_conv(skip_f[None])[0]
        return self.out_conv(distribute(skip, upsample_groups(up_g, 2), "add"))
