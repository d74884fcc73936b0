"""XMem training losses (port of `vosesam_tpu/models/xmem/losses.py`).

Reference: tracker/model/losses.py — dice loss (:8), bootstrapped
cross-entropy with a top-p hard-pixel schedule (:23-43), and the per-frame
LossComputer (:46-68). Functional; the bootstrap warm-up is driven by the
iteration counter passed in (no mutable state).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def dice_loss(pred_logits: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """pred_logits / gt: (O, H, W) per object; valid: (O,). losses.py:8-20."""
    p = torch.sigmoid(pred_logits.float())
    g = gt.float()
    num = 2.0 * torch.sum(p * g, dim=(-2, -1)) + 1.0
    den = torch.sum(p, dim=(-2, -1)) + torch.sum(g, dim=(-2, -1)) + 1.0
    loss = 1.0 - num / den
    v = valid.float()
    return torch.sum(loss * v) / torch.clamp(torch.sum(v), min=1.0)


def bootstrapped_ce(
    logits: torch.Tensor,     # (1+O, H, W) aggregated logits (background first)
    target: torch.Tensor,     # (H, W) int labels in [0, O]
    it: int,                  # the current iteration (for the warm-up schedule)
    top_p: float = 0.15,
    warmup_start: int = 20000,
    warmup_end: int = 70000,
) -> torch.Tensor:
    """Top-p hard-pixel CE (losses.py:23-43): average over all pixels at
    first, then anneal linearly to the hardest `top_p` fraction."""
    logp = torch.log_softmax(logits.float(), dim=0)
    nll = -torch.gather(logp.reshape(logp.shape[0], -1), 0,
                        target.reshape(1, -1).long())[0]          # (H*W,)
    # the schedule in fp32, as the JAX package computes it on the device
    frac = min(max((torch.tensor(float(it), dtype=torch.float32) - warmup_start)
                   / float(warmup_end - warmup_start), torch.tensor(0.0)), torch.tensor(1.0))
    this_p = 1.0 + frac * (top_p - 1.0)                             # 1.0 -> top_p
    n = nll.shape[0]
    k = max(int((this_p * n).to(torch.int32)), 1)
    selected = torch.topk(nll, k).values                            # the k largest
    return torch.sum(selected) / float(k)


def frame_loss(
    agg_logits: torch.Tensor,   # (1+O, H, W)
    obj_logits: torch.Tensor,   # (O, H, W) per-object logits before aggregation
    gt_indexed: torch.Tensor,   # (H, W) int
    obj_valid: torch.Tensor,    # (O,)
    it: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-frame ce + dice (losses.py:52-68)."""
    ce = bootstrapped_ce(agg_logits, gt_indexed, it)
    o = obj_logits.shape[0]
    labels = torch.arange(1, o + 1, device=gt_indexed.device)[:, None, None]
    dl = dice_loss(obj_logits, gt_indexed[None] == labels, obj_valid)
    total = ce + dl
    return total, {"ce": ce, "dice": dl, "total": total}
