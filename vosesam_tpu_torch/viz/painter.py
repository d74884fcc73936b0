"""Mask painting on the device (port of `vosesam_tpu/viz/painter.py`:
`COLORMAP`, `paint_indexed`).

Reference: tools/painter.py (colormap :10-103, alpha blend + contour band
mask_painter :137-157). The contour band is dilate & ~erode of each object's
mask with the same zero-padded 3x3 morphology as the JAX package, and the
blend runs in fp32 with the same operations, so painted frames are
byte-equal to the JAX package's for the same indexed mask.
"""

from __future__ import annotations

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
