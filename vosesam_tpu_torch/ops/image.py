"""Image pre/post ops (port of `vosesam_tpu/ops/image.py:24-82`).

Reference: ImageNet normalization (tracker/util/range_transform.py:5-10) and
pad_divide_by / unpad (tracker/util/tensor_util.py:17-47). Layouts follow
the JAX package: images are (..., H, W, C) channel-last. The SAM resize
helpers come with the SAM slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def im_normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8/float (..., H, W, 3) RGB -> ImageNet-normalized fp32,
    channel-last. Divides by 255 only for uint8 input (ToTensor semantics)."""
    x = img.float()
    if img.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    return (x - mean) / std


def pad_amounts(h: int, w: int, d: int = 16) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) pads making H, W multiples of d; the odd
    pixel lands right/bottom (tensor_util.py:17-31)."""
    new_h = -(-h // d) * d
    new_w = -(-w // d) * d
    lh = (new_h - h) // 2
    uh = new_h - h - lh
    lw = (new_w - w) // 2
    uw = new_w - w - lw
    return lw, uw, lh, uh


def pad_divide_by(x: torch.Tensor, d: int = 16, axes: Tuple[int, int] = (-3, -2)):
    """Zero-pad the two spatial `axes` (default (..., H, W, C)) to multiples
    of d. Returns (padded, (lw, uw, lh, uh))."""
    ah, aw = axes[0] % x.ndim, axes[1] % x.ndim
    lw, uw, lh, uh = pad_amounts(x.shape[ah], x.shape[aw], d)
    # F.pad lists pads from the last axis backwards.
    pads = [0, 0] * x.ndim
    pads[2 * (x.ndim - 1 - ah): 2 * (x.ndim - 1 - ah) + 2] = [lh, uh]
    pads[2 * (x.ndim - 1 - aw): 2 * (x.ndim - 1 - aw) + 2] = [lw, uw]
    return F.pad(x, pads), (lw, uw, lh, uh)


def unpad(x: torch.Tensor, pad: Tuple[int, int, int, int],
          axes: Tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """Invert pad_divide_by (tensor_util.py:34-47)."""
    lw, uw, lh, uh = pad
    ah, aw = axes[0] % x.ndim, axes[1] % x.ndim
    sl = [slice(None)] * x.ndim
    sl[ah] = slice(lh, x.shape[ah] - uh if uh > 0 else None)
    sl[aw] = slice(lw, x.shape[aw] - uw if uw > 0 else None)
    return x[tuple(sl)]
