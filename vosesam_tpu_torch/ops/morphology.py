"""Binary-mask morphology for the painter and for prompt generation (port of
`vosesam_tpu/ops/morphology.py`).

Every function takes a batch of maps (..., H, W) and works on all of them
at once (objects, blobs, frames), where the JAX package vmaps. The fixed
budgets are the JAX package's (ROADMAP C6): blob labels propagate for 128
iterations of a 3x3 max on the 4x max-pooled grid, Zhang-Suen thinning
runs a fixed number of iterations. `lax.top_k` keeps the lowest index
first among ties, and blob areas and skeleton scores tie all the time, so
the port selects with a stable descending sort (`_top_k`). Neighbour
counts are zero-padded 3x3 sums, exact in fp32 for 0/1 maps.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from vosesam_tpu_torch.ops.image import resize_nearest


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, lowest index first among ties (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy, xx


def neighbors8(x: torch.Tensor) -> List[torch.Tensor]:
    """The 8 zero-padded neighbours in the JAX package's Zhang-Suen order
    P2..P9. Its shift s(dy, dx) reads the pixel at (y - dy, x - dx)
    (morphology.py:39-50), so "N" is the pixel below; kept, as the thinning
    result depends on the order."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))

    def s(dy, dx):
        return p[..., 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]

    return [s(-1, 0), s(-1, 1), s(0, 1), s(1, 1), s(1, 0), s(1, -1), s(0, -1), s(-1, -1)]


def neighbor_count(mask: torch.Tensor) -> torch.Tensor:
    """3x3 neighbour count (excluding the centre) of (..., H, W) masks, zero
    padded; fp32 sums of 0/1 are exact."""
    m = mask.float()
    p = F.pad(m, (1, 1, 1, 1))
    h, w = m.shape[-2:]
    total = sum(p[..., dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))
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


def boundary(mask: torch.Tensor) -> torch.Tensor:
    """1-px inner boundary: mask minus its erosion."""
    m = mask.bool()
    return m & ~erode(m, 1)


def _as_nchw(x: torch.Tensor):
    lead = x.shape[:-2]
    return x.reshape(-1, 1, *x.shape[-2:]), lead


# ------------------------------------------------------------ blob labeling

def label_blobs(mask: torch.Tensor, iterations: int = 128) -> torch.Tensor:
    """Connected components by 8-neighbour max-label propagation: every
    pixel of a blob carries the blob's largest 1-based linear pixel index
    (0 outside the mask), after a fixed `iterations` budget. int32."""
    h, w = mask.shape[-2:]
    m, lead = _as_nchw(mask.bool())
    idx = (torch.arange(h * w, dtype=torch.float32, device=mask.device) + 1.0).reshape(h, w)
    zero = torch.zeros((), device=mask.device)
    labels = torch.where(m, idx, zero)
    for _ in range(iterations):
        labels = torch.where(m, F.max_pool2d(labels, 3, 1, 1), zero)
    return labels.reshape(*lead, h, w).to(torch.int32)


def top_blobs(mask: torch.Tensor, num_blobs: int, min_area: float,
              label_iterations: int = 128, downsample: int = 4
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `num_blobs` largest connected components of (..., H, W) masks,
    labelled on the `downsample`x max-pooled grid, returned at full
    resolution: (blobs (..., B, H, W) bool, valid (..., B) with full-res
    area >= min_area)."""
    h, w = mask.shape[-2:]
    m = mask.bool()
    if downsample > 1:
        hd, wd = h // downsample, w // downsample
        mc, lead = _as_nchw(m[..., : hd * downsample, : wd * downsample].float())
        small = F.max_pool2d(mc, downsample, downsample).reshape(*lead, hd, wd) > 0
    else:
        small = m
    labels = label_blobs(small, label_iterations)
    flat = labels.reshape(*labels.shape[:-2], -1).long()
    areas = torch.zeros(*flat.shape[:-1], flat.shape[-1] + 1, device=mask.device)
    areas.scatter_add_(-1, flat, (flat > 0).float())
    areas[..., 0] = 0.0
    _, top_label = _top_k(areas, num_blobs)
    lab_up = resize_nearest(labels, (h, w), axes=(-2, -1)) if downsample > 1 else labels
    tl = top_label[..., :, None, None]
    blobs = (lab_up[..., None, :, :] == tl) & (tl > 0) & m[..., None, :, :]
    full_area = blobs.sum(dim=(-2, -1)).float()
    valid = (top_label > 0) & (full_area >= min_area)
    return blobs, valid


# --------------------------------------------------------- mask measurements

def mask_centroid(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Moments centroid of (..., H, W) masks -> ((..., 2) xy fp32, valid).
    The moment sums are exact (integers) before the fp32 division."""
    m = mask.bool().long()
    h, w = mask.shape[-2:]
    ys = torch.arange(h, device=mask.device)[:, None]
    xs = torch.arange(w, device=mask.device)[None, :]
    total = m.sum(dim=(-2, -1))
    sy = (m * ys).sum(dim=(-2, -1)).float()
    sx = (m * xs).sum(dim=(-2, -1)).float()
    denom = torch.clamp(total, min=1).float()
    return torch.stack([sx / denom, sy / denom], dim=-1), total > 0


def snap_into_mask(point_xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Nearest mask pixel to (x, y) (first in raster order among equals)."""
    h, w = mask.shape[-2:]
    yy, xx = _grid(h, w, mask.device)
    px = point_xy[..., 0, None, None]
    py = point_xy[..., 1, None, None]
    d2 = (xx - px) ** 2 + (yy - py) ** 2
    d2 = torch.where(mask.bool(), d2, torch.full((), math.inf, device=mask.device))
    flat = torch.argmin(d2.reshape(*d2.shape[:-2], -1), dim=-1)
    return torch.stack([flat % w, flat // w], dim=-1).float()


def mask_bbox(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tight inclusive bbox (..., 4) xyxy fp32 and valid (zeros if empty)."""
    m = mask.bool()
    h, w = m.shape[-2:]
    any_row = m.any(dim=-1)
    any_col = m.any(dim=-2)
    ys = torch.arange(h, device=m.device)
    xs = torch.arange(w, device=m.device)
    y0 = torch.where(any_row, ys, h).amin(-1)
    y1 = torch.where(any_row, ys, -1).amax(-1)
    x0 = torch.where(any_col, xs, w).amin(-1)
    x1 = torch.where(any_col, xs, -1).amax(-1)
    valid = m.flatten(-2).any(-1)
    box = torch.stack([x0, y0, x1, y1], dim=-1).float()
    return torch.where(valid[..., None], box, torch.zeros((), device=m.device)), valid


# ------------------------------------------------------- boundary sampling

def angular_boundary_points(mask: torch.Tensor, center_xy: torch.Tensor,
                            num_points: int, farthest: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boundary pixels at `num_points` evenly spaced angles around
    `center_xy` (..., 2): per angular bin the pixel nearest the bin centre
    or, with `farthest`, the largest-radius one. ((..., P, 2) xy, (..., P))."""
    h, w = mask.shape[-2:]
    dev = mask.device
    b = boundary(mask)
    yy, xx = _grid(h, w, dev)
    dx = xx - center_xy[..., 0, None, None]
    dy = yy - center_xy[..., 1, None, None]
    ang = torch.atan2(dy, dx)
    r2 = dx * dx + dy * dy
    bins = (torch.arange(num_points, dtype=torch.float32, device=dev) + 0.5) / num_points
    centers = (bins * 2.0 * math.pi - math.pi)[:, None, None]
    diff = torch.abs(ang[..., None, :, :] - centers)
    diff = torch.minimum(diff, 2.0 * math.pi - diff)
    in_bin = diff <= (math.pi / num_points)
    bmask = b[..., None, :, :] & in_bin
    neg_inf = torch.full((), -math.inf, device=dev)
    score = torch.where(bmask, r2[..., None, :, :] if farthest else -diff, neg_inf)
    idx = torch.argmax(score.flatten(-2), dim=-1)
    valid = bmask.flatten(-2).any(-1)
    pts = torch.stack([idx % w, idx // w], dim=-1).float()
    return torch.where(valid[..., None], pts, torch.zeros((), device=dev)), valid


# ------------------------------------------------------------------ skeleton

def skeletonize(mask: torch.Tensor, iterations: int = 64) -> torch.Tensor:
    """Zhang-Suen thinning with a fixed iteration budget."""
    m = mask.bool()

    def subiter(m, first: bool):
        ns = [n.bool() for n in neighbors8(m.float())]
        bcount = sum(n.float() for n in ns)
        seq = ns + [ns[0]]
        a = sum((~seq[i] & seq[i + 1]).float() for i in range(8))
        p2, p4, p6, p8 = ns[0], ns[2], ns[4], ns[6]
        if first:
            c1, c2 = ~(p2 & p4 & p6), ~(p4 & p6 & p8)
        else:
            c1, c2 = ~(p2 & p4 & p8), ~(p2 & p6 & p8)
        remove = m & (bcount >= 2) & (bcount <= 6) & (a == 1) & c1 & c2
        return m & ~remove

    for _ in range(iterations):
        m = subiter(subiter(m, True), False)
    return m


def skeleton_keypoints(skel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(endpoints, branchpoints) by neighbour counts (base_tracker.py:414-420)."""
    s = skel.bool()
    n = neighbor_count(s)
    return s & (n == 1), s & (n >= 3)


def select_mask_points(score_mask: torch.Tensor, num_points: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to `num_points` pixels of the highest score per map, lowest raster
    index first among ties. ((..., P, 2) xy, (..., P) valid = score > 0)."""
    w = score_mask.shape[-1]
    vals, idx = _top_k(score_mask.float().flatten(-2), num_points)
    valid = vals > 0
    pts = torch.stack([idx % w, idx // w], dim=-1).float()
    return torch.where(valid[..., None], pts, torch.zeros((), device=pts.device)), valid


def dedup_points(pts: torch.Tensor, valid: torch.Tensor, radius: float) -> torch.Tensor:
    """Greedy radius dedup (DBSCAN(eps) stand-in): point i survives if no
    surviving earlier point lies within `radius`. (..., P) validity."""
    n = pts.shape[-2]
    d2 = ((pts[..., :, None, :] - pts[..., None, :, :]) ** 2).sum(-1)
    close = d2 <= radius * radius
    keep = valid.clone()
    for i in range(1, n):
        earlier = keep[..., :i] & valid[..., :i]
        hit = (close[..., i, :i] & earlier).any(-1)
        keep[..., i] = keep[..., i] & ~hit
    return keep
