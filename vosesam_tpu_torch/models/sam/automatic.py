"""Automatic mask generation (port of `vosesam_tpu/models/sam/automatic.py`;
SamAutomaticMaskGenerator capability).

A regular point grid is prompted in batches of single-point packs (the
decoder is batched over the packs, as `refine_masks` batches it over
objects), masks are filtered by predicted IoU and stability score and
deduplicated with a greedy mask-IoU NMS. Everything up to the NMS runs on
the device; the NMS stays on the host in numpy.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from vosesam_tpu_torch.config import SAMConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device
from vosesam_tpu_torch.models.sam import predictor


class AutoMasks(NamedTuple):
    masks: np.ndarray       # (N, H, W) bool
    scores: np.ndarray      # (N,)
    points: np.ndarray      # (N, 2) the generating point


def _stability_score(logits: torch.Tensor, threshold: float, offset: float) -> torch.Tensor:
    """IoU between the thresholdings at (t + o) and (t - o) (official
    stability score)."""
    hi = (logits > threshold + offset).sum(dim=(-2, -1))
    lo = (logits > threshold - offset).sum(dim=(-2, -1))
    return hi / torch.clamp(lo, min=1)


@torch.no_grad()
def generate_masks(
    sam: predictor.Sam,
    image: np.ndarray,
    cfg: SAMConfig,
    points_per_side: int = 16,
    pred_iou_thresh: float = 0.88,
    stability_thresh: float = 0.90,
    nms_iou: float = 0.7,
    batch: int = 16,
    device: DeviceLike = None,
) -> AutoMasks:
    dev = resolve_device(device)
    h, w = image.shape[:2]
    emb = predictor.encode_image(
        sam, torch.from_numpy(np.ascontiguousarray(image)).to(dev)[None], cfg)

    xs = (np.arange(points_per_side) + 0.5) / points_per_side * w
    ys = (np.arange(points_per_side) + 0.5) / points_per_side * h
    grid = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)

    def predict_batch(pts: torch.Tensor):
        """(B, 2) points -> the best multimask token of each single-point
        pack: (masks (B, H, W), iou (B,), stability (B,))."""
        b = pts.shape[0]
        pred = predictor.predict(sam, emb, pts[:, None], torch.ones((b, 1), dtype=torch.long,
                                                                    device=dev), None, cfg)
        best = torch.argmax(pred.iou[:, 1:4], dim=1) + 1
        pick = best[:, None, None, None].expand(-1, 1, h, w)
        logits = torch.gather(pred.logits_full, 1, pick)[:, 0]
        return (torch.gather(pred.masks, 1, pick)[:, 0],
                torch.gather(pred.iou, 1, best[:, None])[:, 0].float(),
                _stability_score(logits, cfg.mask_threshold, 1.0))

    all_masks, all_iou, all_stab = [], [], []
    for i in range(0, len(grid), batch):
        chunk = grid[i: i + batch]
        if len(chunk) < batch:      # the last batch is padded, then cut
            chunk = np.pad(chunk, ((0, batch - len(chunk)), (0, 0)))
        m, iou, stab = predict_batch(torch.from_numpy(chunk.astype(np.float32)).to(dev))
        all_masks.append(m.cpu().numpy()[: len(grid) - i])
        all_iou.append(iou.cpu().numpy()[: len(grid) - i])
        all_stab.append(stab.cpu().numpy()[: len(grid) - i])

    masks = np.concatenate(all_masks)
    ious = np.concatenate(all_iou)
    stabs = np.concatenate(all_stab)

    keep = (ious >= pred_iou_thresh) & (stabs >= stability_thresh) & (masks.sum((1, 2)) > 0)
    masks, ious, pts = masks[keep], ious[keep], grid[keep]

    # greedy mask-IoU NMS, highest predicted IoU first
    order = np.argsort(-ious)
    kept: List[int] = []
    flat = masks.reshape(len(masks), h * w)     # (0, h * w) when nothing passed
    areas = flat.sum(-1)
    for idx in order:
        ok = True
        for j in kept:
            inter = np.logical_and(flat[idx], flat[j]).sum()
            union = areas[idx] + areas[j] - inter
            if union > 0 and inter / union > nms_iou:
                ok = False
                break
        if ok:
            kept.append(idx)
    return AutoMasks(masks[kept], ious[kept], pts[kept])
