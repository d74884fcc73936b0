"""XMem mask and score helpers of the refinement module (port of
`vosesam_tpu/inference/refinement.py:112-123`).

`refine_masks` (the SAM vanishing-mask refinement) comes with the SAM slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
