"""Matplotlib debug plotting for the refinement loop (port of
`vosesam_tpu/viz/debug_plots.py`).

Reference: tracker/base_tracker.py:536-637 — `print_image_bbox` (frame +
bbox rectangles + pos/neg prompt points), `print_by_objects` (per-object
mask panels with their prompts), `save_masks` (xmem vs refinement masks
side by side). They take the framework's static prompt packs
(`ops/prompts.py`) with validity masks and drop the padded entries.

Host-side, matplotlib only (the Agg backend), never on the compute path.
Every array argument may be a numpy array or a tensor on any device: it is
moved to the host first.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _fig():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _valid_points(coords, labels, want: int) -> np.ndarray:
    """Select rows of a padded (P, 2) pack whose label == want."""
    return _host(coords)[_host(labels) == want]


def _save(plt, fig, save_path: Optional[str]) -> None:
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def print_image_bbox(
    image,
    bounding_boxes: Optional[Sequence[Tuple[float, float, float, float]]],
    pos_points: Optional[Sequence] = None,
    neg_points: Optional[Sequence] = None,
    save_path: Optional[str] = None,
):
    """base_tracker.py:536-573: frame + red bboxes + red/blue prompt dots."""
    plt = _fig()
    import matplotlib.patches as patches

    fig, ax = plt.subplots()
    ax.imshow(_host(image))
    ax.set_axis_off()
    for bbox in bounding_boxes or []:
        x, y, mx, my = (float(v) for v in _host(bbox))
        ax.add_patch(patches.Rectangle(
            (x, y), mx - x, my - y, linewidth=2, edgecolor="r", facecolor="none"))
    for pts, color in [(p, "red") for p in pos_points or []] + \
                      [(p, "blue") for p in neg_points or []]:
        pts = _host(pts)
        if pts.size:
            ax.scatter(pts[:, 0], pts[:, 1], color=color, marker="o", s=20)
    _save(plt, fig, save_path)
    return fig


def print_by_objects(
    masks,                              # (O, H, W)
    coords=None,                        # (O, P, 2) padded prompt packs
    labels=None,                        # (O, P) with {-1 pad, 0 neg, 1 pos}
    obj_valid=None,
    save_path: Optional[str] = None,
):
    """base_tracker.py:575-613: one panel per object with its prompts."""
    plt = _fig()
    masks = _host(masks)
    valid = None if obj_valid is None else _host(obj_valid)
    keep = [i for i in range(masks.shape[0]) if valid is None or bool(valid[i])]
    fig, axes = plt.subplots(1, max(len(keep), 1), squeeze=False)
    for col, i in enumerate(keep):
        ax = axes[0][col]
        ax.imshow(masks[i], cmap="gray")
        ax.set_axis_off()
        ax.set_title(f"object {i + 1}", fontsize=8)
        if coords is not None and labels is not None:
            pos = _valid_points(coords[i], labels[i], 1)
            neg = _valid_points(coords[i], labels[i], 0)
            if pos.size:
                ax.scatter(pos[:, 0], pos[:, 1], color="red", s=16)
            if neg.size:
                ax.scatter(neg[:, 0], neg[:, 1], color="blue", s=16)
    _save(plt, fig, save_path)
    return fig


def save_masks_side_by_side(xmem_mask, refined_mask, save_path: str):
    """base_tracker.py:615-637: XMem input vs SAM refinement output."""
    plt = _fig()
    fig, (a, b) = plt.subplots(1, 2)
    for ax, mask, title in ((a, xmem_mask, "xmem"), (b, refined_mask, "refined")):
        ax.imshow(_host(mask))
        ax.set_title(title, fontsize=8)
        ax.set_axis_off()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
