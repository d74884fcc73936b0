"""ResNet trunks for the XMem encoders (port of `vosesam_tpu/models/resnet.py`).

Reference: tracker/model/resnet.py and modules.py — KeyEncoder is resnet50
through layer3 (f4/f8/f16 = 256/512/1024 channels at strides 4/8/16; the
official checkpoint names its first stage `res2`), ValueEncoder is resnet18
with `extra_dim` input channels (mask + others). The stem is the plain
7x7 stride-2 convolution; the JAX package's space-to-depth stem is a TPU
rewrite of the same math.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from vosesam_tpu_torch.models.layers import BatchNorm2d, Conv2d, max_pool

# (block type, blocks per stage, stage widths, expansion)
RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2), (64, 128, 256), 1),
    "resnet50": ("bottleneck", (3, 4, 6), (64, 128, 256), 4),
}


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, 1, stride=stride, bias=False), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int) -> None:
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = (_downsample(cin, cout, stride)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idn = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + idn)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cmid: int, stride: int) -> None:
        super().__init__()
        cout = cmid * 4
        self.conv1 = Conv2d(cin, cmid, 1, bias=False)
        self.bn1 = BatchNorm2d(cmid)
        self.conv2 = Conv2d(cmid, cmid, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(cmid)
        self.conv3 = Conv2d(cmid, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = (_downsample(cin, cout, stride)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idn = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + idn)


class ResNetTrunk(nn.Module):
    """conv1/bn1/maxpool stem and the first three stages, NCHW."""

    def __init__(self, arch: str, extra_dim: int = 0,
                 stage_names: Sequence[str] = ("layer1", "layer2", "layer3")) -> None:
        super().__init__()
        block, stages, widths, exp = RESNET_SPECS[arch]
        self.stage_names = tuple(stage_names)
        self.conv1 = Conv2d(3 + extra_dim, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for si, (n, w) in enumerate(zip(stages, widths)):
            blocks = []
            for bi in range(n):
                stride = 1 if (si == 0 or bi > 0) else 2
                if block == "basic":
                    blocks.append(BasicBlock(cin, w, stride))
                else:
                    blocks.append(Bottleneck(cin, w, stride))
                cin = w * exp
            self.add_module(self.stage_names[si], nn.Sequential(*blocks))

    def features(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NCHW input -> (f4, f8, f16) at strides 4, 8, 16."""
        y = max_pool(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = []
        for name in self.stage_names:
            y = getattr(self, name)(y)
            feats.append(y)
        f4, f8, f16 = feats
        return f4, f8, f16
