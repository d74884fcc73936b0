"""SAM prompt generation on the device: the C / CP / CPS point algorithms
and the 10 refinement prompt modes (port of `vosesam_tpu/ops/prompts.py`).

Reference (tracker/base_tracker.py): C = get_very_very_best_point_of_interest
(:326-362), CP = get_best_points_of_interest_PolyLine (:383-412), CPS =
get_skeleton_and_poly (:482-500), negative points = find_neg_points
(:646-656), the modes at :698-950. Everything is computed from the
(..., O, H, W) mask stack with static point budgets and validity flags
(SAM's label -1 makes padded points free), batched over frames, objects
and blobs, with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from plainref.config import RefinementConfig
from plainref.ops import morphology as morph

NUM_BLOBS = 4  # static per-object connected-component budget


class PointSet(NamedTuple):
    coords: torch.Tensor   # (..., P, 2) xy fp32, frame space
    valid: torch.Tensor    # (..., P) bool


def _blob_points(mask: torch.Tensor, cfg: RefinementConfig, n_contour: int,
                 farthest: bool) -> PointSet:
    """Per blob: snapped centroid + angular boundary points, flattened over
    blobs -> (..., B * (1 + n_contour))."""
    blobs, bvalid = morph.top_blobs(mask, NUM_BLOBS, cfg.min_region_area)
    c, c_ok = morph.mask_centroid(blobs)
    c = morph.snap_into_mask(c, blobs)
    bpts, bok = morph.angular_boundary_points(blobs, c, n_contour, farthest)
    coords = torch.cat([c[..., None, :], bpts], dim=-2)             # (..., B, 1+P, 2)
    valid = torch.cat([(c_ok & bvalid)[..., None], bok & bvalid[..., None]], dim=-1)
    lead = mask.shape[:-2]
    return PointSet(coords.reshape(*lead, -1, 2), valid.reshape(*lead, -1))


def points_C(mask: torch.Tensor, cfg: RefinementConfig) -> PointSet:
    """Centroid + evenly spread contour points per blob (C algorithm)."""
    return _blob_points(mask, cfg, cfg.contour_points, farthest=False)


def points_CP(mask: torch.Tensor, cfg: RefinementConfig) -> PointSet:
    """Centroid + polyline-vertex-like (farthest per angular bin) points."""
    return _blob_points(mask, cfg, cfg.polyline_points, farthest=True)


def points_CPS(mask: torch.Tensor, cfg: RefinementConfig) -> PointSet:
    """CP points + skeleton endpoints / branchpoints / pixels, deduplicated."""
    cp = points_CP(mask, cfg)
    skel = morph.skeletonize(mask, iterations=48)
    endpoints, branches = morph.skeleton_keypoints(skel)
    score = endpoints.float() * 3.0 + branches.float() * 2.0 + skel.float()
    spts, svalid = morph.select_mask_points(score, cfg.skeleton_points)
    coords = torch.cat([cp.coords, spts], dim=-2)
    valid = torch.cat([cp.valid, svalid], dim=-1)
    return PointSet(coords, morph.dedup_points(coords, valid, cfg.dedup_radius))


def generate_points(mask: torch.Tensor, cfg: RefinementConfig) -> PointSet:
    """Dispatch on cfg.point_algorithm (base_tracker.py:677-680)."""
    if cfg.point_algorithm == "C":
        return points_C(mask, cfg)
    if cfg.point_algorithm == "CP":
        return points_CP(mask, cfg)
    if cfg.point_algorithm == "CPS":
        return points_CPS(mask, cfg)
    raise ValueError(cfg.point_algorithm)


def point_in_box(pts: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """(..., P, 2) xy inside (..., 4) xyxy boxes, inclusive (point_inside :641)."""
    b = box[..., None, :]
    return ((pts[..., 0] >= b[..., 0]) & (pts[..., 0] <= b[..., 2])
            & (pts[..., 1] >= b[..., 1]) & (pts[..., 1] <= b[..., 3]))


def negative_points(all_points: torch.Tensor, all_valid: torch.Tensor,
                    boxes: torch.Tensor, box_valid: torch.Tensor, max_neg: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each object: the other objects' positive points inside its bbox,
    in point order (find_neg_points :646-656). all_points (..., O, P, 2) ->
    ((..., O, max_neg, 2), (..., O, max_neg))."""
    *lead, o, p, _ = all_points.shape
    dev = all_points.device
    flat_pts = all_points.reshape(*lead, 1, o * p, 2)
    flat_valid = all_valid.reshape(*lead, 1, o * p)
    owner = torch.arange(o, device=dev).repeat_interleave(p)
    me = torch.arange(o, device=dev)[:, None]
    cand = (flat_valid & (owner[None] != me) & point_in_box(flat_pts, boxes)
            & box_valid[..., None])                                   # (..., O, O*P)
    # candidates first, each group in point order (the score is tie-free)
    score = cand.float() * (2.0 * o * p) - torch.arange(o * p, device=dev, dtype=torch.float32)
    _, idx = morph._top_k(score, max_neg)
    sel_valid = torch.gather(cand, -1, idx)
    pts = torch.gather(flat_pts.expand(*lead, o, o * p, 2), -2,
                       idx[..., None].expand(*idx.shape, 2))
    return torch.where(sel_valid[..., None], pts, torch.zeros((), device=dev)), sel_valid


class PromptPack(NamedTuple):
    """Fixed-size per-object SAM prompts for one refinement mode."""
    coords: torch.Tensor      # (..., O, T, 2) frame-space xy
    labels: torch.Tensor      # (..., O, T) int64 in {-1, 0, 1, 2, 3}
    use_mask: bool            # feed the mask prompt?
    has_prompt: torch.Tensor  # (..., O) any live prompt (else keep the XMem mask)


def build_prompt_pack(mode: str, masks: torch.Tensor, obj_valid: torch.Tensor,
                      cfg: RefinementConfig) -> PromptPack:
    """The 10 prompt modes (custom_sam_refinement :698-950) from (..., O, H, W)
    binary masks and (..., O) validity."""
    *lead, o, _, _ = masks.shape
    dev = masks.device
    use_pos = mode in ("point", "both", "both_neg", "mask_pos", "mask_bbox_pos",
                       "mask_bbox_pos_neg")
    use_neg = mode in ("both_neg", "mask_bbox_neg", "mask_bbox_pos_neg")
    use_box = mode in ("bbox", "both", "both_neg", "mask_bbox", "mask_bbox_pos",
                       "mask_bbox_neg", "mask_bbox_pos_neg")
    use_mask = mode.startswith("mask")

    boxes, box_ok = morph.mask_bbox(masks)
    box_ok = box_ok & obj_valid
    if use_pos or use_neg:
        ps = generate_points(masks, cfg)
        pos_pts, pos_ok = ps.coords, ps.valid & obj_valid[..., None]

    parts_c, parts_l, parts_v = [], [], []

    def add(c, label, v):
        parts_c.append(c)
        parts_l.append(torch.full(v.shape, label, dtype=torch.long, device=dev)
                       if isinstance(label, int) else label)
        parts_v.append(v)

    if use_pos:
        add(pos_pts, 1, pos_ok)
    if use_neg:
        neg_pts, neg_ok = negative_points(pos_pts, pos_ok, boxes, box_ok, cfg.max_neg_points)
        add(neg_pts, 0, neg_ok)
    if use_box:
        corners = torch.stack([boxes[..., :2], boxes[..., 2:]], dim=-2)   # (..., O, 2, 2)
        clabels = torch.arange(2, 4, device=dev).expand(*lead, o, 2)
        add(corners, clabels, box_ok[..., None].expand(*lead, o, 2))
    if not parts_c:   # pure 'mask' mode still needs a (padded) point array
        add(torch.zeros(*lead, o, 1, 2, device=dev), -1,
            torch.zeros(*lead, o, 1, dtype=torch.bool, device=dev))

    coords = torch.cat(parts_c, dim=-2)
    labels = torch.cat(parts_l, dim=-1)
    valid = torch.cat(parts_v, dim=-1)
    labels = torch.where(valid, labels, -1)
    coords = torch.where(valid[..., None], coords, torch.zeros((), device=dev))
    has = valid.any(-1)
    if use_mask:   # a nonempty mask prompt alone is a live prompt
        has = has | (masks.flatten(-2).sum(-1) > 0)
    return PromptPack(coords, labels, use_mask, obj_valid & has)
