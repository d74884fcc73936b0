"""Fancy mask painter: background dim + soft contour, four blur modes (port
of `vosesam_tpu/viz/mask_painter.py`).

Reference: tools/mask_painter.py:105-222 — a signed distance map
(cv2.distanceTransform fore − back) drives (a) a background alpha ramp and
(b) a contour band whose softness depends on the mode:

  '00'  hard background mask, hard contour
  '01'  hard background mask, soft contour
  '10'  soft background ramp, hard contour
  '11'  soft background ramp, soft contour   (reference default)

The distance transform is only ever clipped to a few pixels
(background_blur_radius / contour_width defaults 7 / 3), so the exact
clipped signed L2 distance is a minimum over a static (2r+1)² shift window,
computed on the device the image lives on. Images larger than 1024 px are
downsampled first as the reference does (:205-210), through the port's
`ops/image.py` resize (the JAX package's `jax.image.resize`, antialiased).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vosesam_tpu_torch.ops.image import resize_bilinear
from vosesam_tpu_torch.viz.painter import COLORMAP


def clipped_signed_distance(mask: torch.Tensor, clip: float) -> torch.Tensor:
    """Signed L2 distance (fore positive, back negative), exact within
    ±clip. mask: (H, W) {0,1}. Pixels outside the image are neither
    foreground nor background (the transform measures within the image)."""
    m = mask > 0.5
    h, w = m.shape
    r = int(clip) + 1
    inf = torch.full(m.shape, 1e9, dtype=torch.float32, device=m.device)
    d_fore, d_back = inf, inf.clone()   # to the nearest background / foreground pixel
    fore = F.pad(m, (r, r, r, r), value=False)
    back = F.pad(~m, (r, r, r, r), value=False)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            dist = (dy * dy + dx * dx) ** 0.5
            if dist > r:
                continue
            # the pixel (y - dy, x - dx), where it lies inside the image
            win = (slice(r - dy, r - dy + h), slice(r - dx, r - dx + w))
            d_fore = torch.where(back[win], d_fore.clamp(max=dist), d_fore)
            d_back = torch.where(fore[win], d_back.clamp(max=dist), d_back)
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    d_fore = torch.where(m, d_fore.clamp(max=clip), zero)
    d_back = torch.where(~m, d_back.clamp(max=clip), zero)
    return d_fore - d_back


def _background_ramp(dist_map: torch.Tensor, radius: float) -> torch.Tensor:
    b = dist_map.clamp(-radius, radius)
    b = b - b.min()
    return b / b.max().clamp(min=1e-6)


def _contour_band(dist_map: torch.Tensor, radius: float, hard: bool) -> torch.Tensor:
    r = radius + 2
    c = dist_map.clamp(-r, r).abs()
    c = c / c.max().clamp(min=1e-6)
    if hard:
        c = torch.where(c > 0.5, torch.ones((), device=c.device), c)
    return c


def vis_add_mask(
    image: torch.Tensor,             # (H, W, 3) float / uint8
    background_mask: torch.Tensor,   # (H, W) in [0, 1] — 1 keeps the pixel
    contour_mask: torch.Tensor,      # (H, W) in [0, 1] — 0 paints the contour
    background_color,
    contour_color,
    background_alpha: float,
    contour_alpha: float,
) -> torch.Tensor:
    """tools/mask_painter.py:105-120 blend."""
    img = image.float()
    bc = torch.as_tensor(background_color, device=img.device).float()
    cc = torch.as_tensor(contour_color, device=img.device).float()
    bw = (1 - background_alpha + background_mask * background_alpha)[..., None]
    img = img * bw + bc * (1 - bw)
    cw = (1 - contour_alpha + contour_mask * contour_alpha)[..., None]
    img = img * cw + cc * (1 - cw)
    return img.clamp(0, 255).to(torch.uint8)


def fancy_mask_painter(
    image: torch.Tensor,     # (H, W, 3) uint8
    mask: torch.Tensor,      # (H, W) {0,1}
    background_alpha: float = 0.5,
    background_blur_radius: int = 7,
    contour_width: int = 3,
    contour_color: int = 3,
    contour_alpha: float = 1.0,
    mode: str = "11",
) -> torch.Tensor:
    """tools/mask_painter.py:183-222. Returns a (possibly downsampled to
    <= 1024 px) painted uint8 image on the image's device."""
    if background_blur_radius % 2 == 0 or contour_width % 2 == 0:
        raise ValueError("background_blur_radius and contour_width must be odd")
    if mode not in ("00", "01", "10", "11"):
        raise ValueError(f"mode must be one of 00/01/10/11, got {mode!r}")

    image = torch.as_tensor(image)
    mask = torch.as_tensor(mask, device=image.device).float()
    h, w = image.shape[:2]
    ratio = min(1024.0 / max(h, w), 1.0)
    if ratio < 1.0:
        nh, nw = int(h * ratio), int(w * ratio)
        image = resize_bilinear(image.float(), (nh, nw))
        mask = resize_bilinear(mask, (nh, nw), axes=(-2, -1))
    msk = mask.clamp(0, 1)

    bg_radius = (background_blur_radius - 1) // 2
    ct_radius = (contour_width - 1) // 2
    dist_map = clipped_signed_distance(msk, max(bg_radius, ct_radius + 2))

    soft_bg = mode[0] == "1"
    soft_ct = mode[1] == "1"
    background = _background_ramp(dist_map, bg_radius) if soft_bg else msk
    contour = _contour_band(dist_map, ct_radius, hard=not soft_ct)

    return vis_add_mask(
        image, background, contour,
        COLORMAP[0], COLORMAP[contour_color],
        background_alpha, contour_alpha,
    )
