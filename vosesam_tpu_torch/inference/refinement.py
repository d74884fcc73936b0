"""Vanishing-mask SAM refinement and the XMem mask/score helpers (port of
`vosesam_tpu/inference/refinement.py`).

Reference: tracker/base_tracker.py custom_sam_refinement (:683-976): each
XMem object mask is refined by prompting SAM with generated geometry (10
modes x 3 point algorithms); the optional IoU gate reverts low-confidence
SAM masks to the XMem mask (:954-958); objects are composited
lowest-score-first so the more confident mask wins overlaps (:960-964), here
an argmax over score-ranked claims. An object with no live prompt keeps its
XMem mask and score (:736-739).

`refine_masks` takes F frames at once (one per frame, or a whole chunk):
one decode per (frame, object), batched; the token is picked before the
full-resolution upsample. It runs with no host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from vosesam_tpu_torch.config import FrameworkConfig
from vosesam_tpu_torch.models.sam import predictor
from vosesam_tpu_torch.ops import prompts as prompt_ops
from vosesam_tpu_torch.ops.image import resize_bilinear, resize_mask_prompt


class RefinementResult(NamedTuple):
    masks: torch.Tensor      # (F, O, H, W) bool final per-object masks
    scores: torch.Tensor     # (F, O) SAM IoU or XMem score (-inf if invalid)
    indexed: torch.Tensor    # (F, H, W) int32 composited label map (0 = bg)
    used_sam: torch.Tensor   # (F, O) bool SAM output kept


@torch.no_grad()
def refine_masks(
    sam: predictor.Sam,
    emb: predictor.ImageEmbedding,   # F frames
    xmem_masks: torch.Tensor,        # (F, O, H, W) binary XMem masks
    xmem_logits: torch.Tensor,       # (F, O, H, W) aggregated logits (no bg)
    xmem_scores: torch.Tensor,       # (F, O) max probability
    obj_valid: torch.Tensor,         # (F, O) bool
    cfg: FrameworkConfig,
) -> RefinementResult:
    rcfg, scfg = cfg.refinement, cfg.sam
    f, o, h, w = xmem_masks.shape
    dev = xmem_masks.device
    pack = prompt_ops.build_prompt_pack(rcfg.mode, xmem_masks, obj_valid, rcfg)

    mask_prompts = None
    if pack.use_mask:
        # 4x the embedding grid; stretched over the whole prompt under
        # encode_fixed_hw, else aspect-fit and filled with the minimum
        prompt_hw = (emb.embedding.shape[1] * 4, emb.embedding.shape[2] * 4)
        lg = xmem_logits.reshape(f * o, h, w)
        if scfg.encode_fixed_hw is not None:
            mask_prompts = resize_bilinear(lg, prompt_hw, axes=(-2, -1)).to(lg.dtype)
        else:
            mask_prompts = resize_mask_prompt(lg, prompt_hw)

    frame_of = torch.arange(f, device=dev).repeat_interleave(o)
    low_res, iou = predictor.predict_low_res(
        sam, emb, pack.coords.reshape(f * o, -1, 2), pack.labels.reshape(f * o, -1),
        mask_prompts, scfg, frame_of=frame_of)
    tok = predictor.select_token(iou, scfg, scfg.multimask_output)
    best = torch.gather(low_res, 1, tok[:, None, None, None].expand(
        -1, 1, *low_res.shape[-2:]))[:, 0]
    logits_full = predictor.postprocess_masks(best, emb.input_hw, emb.orig_hw)
    sam_masks = (logits_full > scfg.mask_threshold).reshape(f, o, h, w)
    sam_scores = torch.gather(iou, 1, tok[:, None])[:, 0].reshape(f, o).float()

    keep = pack.has_prompt
    if rcfg.optimized:
        keep = keep & (sam_scores >= rcfg.score_gate)
    final_masks = torch.where(keep[..., None, None], sam_masks, xmem_masks > 0.5) \
        & obj_valid[..., None, None]
    neg_inf = torch.full((), -math.inf, device=dev)
    final_scores = torch.where(keep, sam_scores, xmem_scores.float())
    final_scores = torch.where(obj_valid, final_scores, neg_inf)

    claim = torch.where(final_masks, final_scores[..., None, None], neg_inf)
    winner = torch.argmax(claim, dim=1)
    indexed = torch.where(final_masks.any(1), winner + 1, 0).to(torch.int32)
    return RefinementResult(final_masks, final_scores, indexed, keep)


def xmem_object_scores(prob_no_bg: torch.Tensor) -> torch.Tensor:
    """Per-object confidence = max probability (base_tracker.py:163-165)."""
    return prob_no_bg.amax(dim=(-2, -1))


def masks_from_prob(prob_with_bg: torch.Tensor, max_objects: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmax over the (1+O) distribution (first index wins ties) ->
    ((O, H, W) fp32 binary masks, (H, W) int32 indexed map)
    (base_tracker.py:153-160)."""
    idx = torch.argmax(prob_with_bg, dim=0)
    obj_ids = torch.arange(1, max_objects + 1, device=idx.device)
    masks = idx[None] == obj_ids[:, None, None]
    return masks.float(), idx.to(torch.int32)
