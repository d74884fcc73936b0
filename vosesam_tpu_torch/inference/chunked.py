"""Chunked tracking: K XMem steps, one batched SAM encode and refinement
(port of `vosesam_tpu/inference/chunked.py:track_chunk`).

The only frame-to-frame dependency is the XMem memory state; SAM
refinement is a pure function of (frame, XMem output) and never feeds back
(base_tracker.py:178 runs it after the memory update). So a chunk of K
frames runs as: one batched ViT encode of the K frames (the global blocks
run kernel B3 with K x heads in its batch axis), the K XMem steps in order,
then one refinement batched over frames x objects. The outputs equal
per-frame tracking's up to the batching of the same operations.

`track_chunk_fused` is not ported: it exists to keep a chunk inside one
traced JAX program (an XMem `lax.scan`); in eager PyTorch it would be this
same code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vosesam_tpu_torch.config import FrameworkConfig
from vosesam_tpu_torch.inference import core
from vosesam_tpu_torch.inference.refinement import (
    masks_from_prob,
    refine_masks,
    xmem_object_scores,
)
from vosesam_tpu_torch.models.sam import predictor
from vosesam_tpu_torch.models.xmem.network import XMem
from vosesam_tpu_torch.utils import profiling


@torch.no_grad()
def track_chunk(
    net: XMem,
    sam: Optional[predictor.Sam],
    state: core.TrackerState,
    frames: torch.Tensor,             # (K, H, W, 3) uint8 on the device
    cfg: FrameworkConfig,
) -> Tuple[core.TrackerState, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Track K propagation frames. Returns (state, indexed (K, H, W) int32,
    scores (K, O), used_sam (K, O) bool or None without refinement)."""
    with profiling.span("track.chunk"):
        refine = cfg.refinement.use_refinement
        if refine:
            if sam is None:
                raise ValueError("refinement enabled but no SAM model given")
            emb = predictor.encode_image(sam, frames, cfg.sam)
        o = cfg.xmem.max_objects
        masks, logits, scores, indexed, valid = [], [], [], [], []
        for f in frames:
            state, prob, lg = core.step(net, state, f, cfg)
            with profiling.span("track.masks"):
                m, idx = masks_from_prob(prob, o)
                masks.append(m)
                logits.append(lg[1:])
                scores.append(xmem_object_scores(prob[1:]))
                indexed.append(idx)
                valid.append(state.memory.obj_valid)
        with profiling.span("track.masks"):
            if not refine:
                return state, torch.stack(indexed), torch.stack(scores), None
            stacked = (torch.stack(masks), torch.stack(logits), torch.stack(scores),
                       torch.stack(valid))
        res = refine_masks(sam, emb, *stacked, cfg)
        return state, res.indexed, res.scores, res.used_sam
