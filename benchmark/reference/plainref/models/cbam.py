"""Convolutional Block Attention Module (port of `vosesam_tpu/models/cbam.py`).

Reference: tracker/model/cbam.py — channel gate (a shared 2-layer MLP over
the global average- and max-pooled descriptors, summed, sigmoid) followed by
a spatial gate (channel max + mean -> 7x7 conv -> sigmoid). State-dict names
are the official ones (`ChannelGate.mlp.1`, `mlp.3`,
`SpatialGate.spatial.conv`). The JAX version's optimization barriers and
2 -> 8 channel pad are TPU compiler workarounds; this is the plain 2 -> 1
convolution.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from plainref.models.layers import (
    Conv2d,
    Linear,
    avg_pool_global,
    max_pool_global,
)


class ChannelGate(nn.Module):
    def __init__(self, channels: int, reduction: int = 16) -> None:
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Flatten(),
            Linear(channels, channels // reduction),
            nn.ReLU(),
            Linear(channels // reduction, channels),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = self.mlp(avg_pool_global(x)) + self.mlp(max_pool_global(x))
        return x * torch.sigmoid(att)[:, :, None, None]


class BasicConv(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.conv = Conv2d(2, 1, 7, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class SpatialGate(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.spatial = BasicConv()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        compress = torch.cat([x.amax(dim=1, keepdim=True),
                              x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial(compress))


class CBAM(nn.Module):
    """NCHW in, NCHW out; the object axis rides the batch axis."""

    def __init__(self, channels: int, reduction: int = 16) -> None:
        super().__init__()
        self.ChannelGate = ChannelGate(channels, reduction)
        self.SpatialGate = SpatialGate()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SpatialGate(self.ChannelGate(x))
