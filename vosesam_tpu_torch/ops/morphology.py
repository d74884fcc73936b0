"""Binary-mask morphology (port of `vosesam_tpu/ops/morphology.py:67-84`).

Only the dilate/erode pair the painter needs; the prompt-generation
primitives come with the SAM refinement slice. A 3x3 neighbour count with
zero padding outside the map, exactly as the JAX version, so painted contour
bands are byte-equal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def neighbor_count(mask: torch.Tensor) -> torch.Tensor:
    """3x3 neighbour count (excluding the centre) of an (H, W) mask, zero
    padded; fp32 sums of 0/1 are exact."""
    m = mask.float()
    p = F.pad(m, (1, 1, 1, 1))
    h, w = m.shape
    total = sum(p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))
    return total - m


def dilate(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    m = mask.bool()
    for _ in range(iterations):
        m = m | (neighbor_count(m) > 0)
    return m


def erode(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    m = mask.bool()
    for _ in range(iterations):
        m = m & (neighbor_count(m) >= 8)
    return m
