"""Mask and point painting on the device (port of
`vosesam_tpu/viz/painter.py`: `COLORMAP`, `mask_painter`, `point_painter`,
`background_remover`, `paint_indexed`).

Reference: tools/painter.py (colormap :10-103, alpha blend + contour band
mask_painter :137-157, point dots point_painter :112-135, RGBA cutout
background_remover :159-172). The contour band is dilate & ~erode of each object's
mask with the same zero-padded 3x3 morphology as the JAX package, and the
blend runs in fp32 with the same operations, so painted frames are
byte-equal to the JAX package's for the same indexed mask.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from vosesam_tpu_torch.ops import morphology as morph

# tools/painter.py:10-103 (the public Detectron color table): entry 0 is
# black/background, entry 1 white, objects use entries label+1.
_COLORMAP_FRACTIONS = (
    (0.000, 0.000, 0.000), (1.000, 1.000, 1.000), (1.000, 0.498, 0.313),
    (0.392, 0.581, 0.929), (0.000, 0.447, 0.741), (0.850, 0.325, 0.098),
    (0.929, 0.694, 0.125), (0.494, 0.184, 0.556), (0.466, 0.674, 0.188),
    (0.301, 0.745, 0.933), (0.635, 0.078, 0.184), (0.300, 0.300, 0.300),
    (0.600, 0.600, 0.600), (1.000, 0.000, 0.000), (1.000, 0.500, 0.000),
    (0.749, 0.749, 0.000), (0.000, 1.000, 0.000), (0.000, 0.000, 1.000),
    (0.667, 0.000, 1.000), (0.333, 0.333, 0.000), (0.333, 0.667, 0.000),
    (0.333, 1.000, 0.000), (0.667, 0.333, 0.000), (0.667, 0.667, 0.000),
    (0.667, 1.000, 0.000), (1.000, 0.333, 0.000), (1.000, 0.667, 0.000),
    (1.000, 1.000, 0.000), (0.000, 0.333, 0.500), (0.000, 0.667, 0.500),
    (0.000, 1.000, 0.500), (0.333, 0.000, 0.500), (0.333, 0.333, 0.500),
    (0.333, 0.667, 0.500), (0.333, 1.000, 0.500), (0.667, 0.000, 0.500),
    (0.667, 0.333, 0.500), (0.667, 0.667, 0.500), (0.667, 1.000, 0.500),
    (1.000, 0.000, 0.500), (1.000, 0.333, 0.500), (1.000, 0.667, 0.500),
    (1.000, 1.000, 0.500), (0.000, 0.333, 1.000), (0.000, 0.667, 1.000),
    (0.000, 1.000, 1.000), (0.333, 0.000, 1.000), (0.333, 0.333, 1.000),
    (0.333, 0.667, 1.000), (0.333, 1.000, 1.000), (0.667, 0.000, 1.000),
    (0.667, 0.333, 1.000), (0.667, 0.667, 1.000), (0.667, 1.000, 1.000),
    (1.000, 0.000, 1.000), (1.000, 0.333, 1.000), (1.000, 0.667, 1.000),
    (0.167, 0.000, 0.000), (0.333, 0.000, 0.000), (0.500, 0.000, 0.000),
    (0.667, 0.000, 0.000), (0.833, 0.000, 0.000), (1.000, 0.000, 0.000),
    (0.000, 0.167, 0.000), (0.000, 0.333, 0.000), (0.000, 0.500, 0.000),
    (0.000, 0.667, 0.000), (0.000, 0.833, 0.000), (0.000, 1.000, 0.000),
    (0.000, 0.000, 0.167), (0.000, 0.000, 0.333), (0.000, 0.000, 0.500),
    (0.000, 0.000, 0.667), (0.000, 0.000, 0.833), (0.000, 0.000, 1.000),
    (0.143, 0.143, 0.143), (0.286, 0.286, 0.286), (0.429, 0.429, 0.429),
    (0.571, 0.571, 0.571), (0.714, 0.714, 0.714), (0.857, 0.857, 0.857),
)

COLORMAP = (np.asarray(_COLORMAP_FRACTIONS, np.float32) * 255).astype(np.uint8)


def _color(color: Sequence[float], like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(color, device=like.device).to(dtype)


def mask_painter(
    image: torch.Tensor,              # (H, W, 3) uint8
    mask: torch.Tensor,               # (H, W) bool / float
    color: Sequence[float],           # (3,) RGB, a tensor or a sequence
    alpha: float = 0.7,
    contour_width: int = 2,
) -> torch.Tensor:
    """Alpha-blend a coloured mask and draw a solid contour band
    (painter.py:137-157)."""
    img = image.float()
    m = mask.bool()
    c = _color(color, image, torch.float32)
    blended = torch.where(m[..., None], img * (1.0 - alpha) + c * alpha, img)
    band = morph.dilate(m, contour_width) & ~morph.erode(m, contour_width)
    out = torch.where(band[..., None], c, blended)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def point_painter(
    image: torch.Tensor,              # (H, W, 3) uint8
    points: torch.Tensor,             # (P, 2) xy
    valid: torch.Tensor,              # (P,) bool
    color: Sequence[float],           # (3,)
    radius: int = 5,
) -> torch.Tensor:
    """Paint dots at the valid points (painter.py:112-135) by a distance
    test."""
    h, w = image.shape[:2]
    dev = image.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
    pts = points.float()
    d2 = (xx - pts[:, 0]) ** 2 + (yy - pts[:, 1]) ** 2               # (H, W, P)
    hit = ((d2 <= radius * radius) & valid[None, None, :]).any(-1)
    return torch.where(hit[..., None], _color(color, image, torch.uint8), image)


def background_remover(image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) RGBA cutout (painter.py:159-172)."""
    a = (mask.to(torch.uint8) * 255)[..., None]
    return torch.cat([image.to(torch.uint8), a], dim=-1)


def paint_indexed(
    image: torch.Tensor,              # (H, W, 3) uint8
    indexed: torch.Tensor,            # (H, W) int, 0 = background
    max_objects: int,
    alpha: float = 0.7,
    contour_width: int = 2,
) -> torch.Tensor:
    """Paint every object of an indexed mask (base_tracker.py:197-202):
    object label o takes COLORMAP[o + 1], contours COLORMAP[1]."""
    dev = image.device
    img = image.float()
    cmap = torch.as_tensor(COLORMAP[1: max_objects + 2], dtype=torch.float32, device=dev)
    is_obj = indexed > 0
    color_map = cmap[torch.clamp(indexed, 0, max_objects).long()]
    out = torch.where(is_obj[..., None], img * (1.0 - alpha) + color_map * alpha, img)
    contour_color = torch.as_tensor(COLORMAP[1], dtype=torch.float32, device=dev)
    for o in range(1, max_objects + 1):
        m = indexed == o
        band = morph.dilate(m, contour_width) & ~morph.erode(m, contour_width)
        out = torch.where(band[..., None], contour_color, out)
    return torch.clamp(out, 0, 255).to(torch.uint8)
