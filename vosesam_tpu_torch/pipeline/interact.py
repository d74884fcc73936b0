"""Interactive first-frame seeding by click prompts (port of
`vosesam_tpu/pipeline/interact.py`).

Reference: tools/interact_tools.py SamControler.first_frame_click (:49-89):
one point-prompt pass (multimask, best predicted IoU); when the click
history holds a negative click and the latest click is positive, a second
pass feeds the first pass's best low-res logit back as a mask prompt ('both'
mode, :57-71); the chosen mask and the click points are painted for the UI.

Prompt pack: the click history travels raw plus exactly ONE (0, 0, -1) pad
point, the official predictor's `_embed_points(pad=True)`. Pad tokens are
real decoder tokens (the `not_a_point` embedding attends), so a pack padded
to a fixed size is not equivalent.

The image is encoded once per `set_image` and the embedding stays on the
device. A click uploads the image and the pack, runs decode, selection and
the three paint layers with no host sync (the trigger of the second pass
depends only on the labels, which the host knows), and then downloads its
three results.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vosesam_tpu_torch.config import SAMConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device
from vosesam_tpu_torch.models.sam import predictor
from vosesam_tpu_torch.utils import profiling
from vosesam_tpu_torch.viz.painter import mask_painter, point_painter

MASK_COLOR = (255, 99, 71)
POSITIVE_COLOR = (0, 255, 0)
NEGATIVE_COLOR = (255, 0, 0)


@torch.no_grad()
def click_full(sam: predictor.Sam, emb: predictor.ImageEmbedding, image: torch.Tensor,
               coords: torch.Tensor, labels: torch.Tensor, cfg: SAMConfig,
               multimask: bool, two_pass: bool):
    """The whole click on the device: predict (and the optional second
    'both'-mode pass), mask selection and the three paint layers. Returns
    (mask (H, W) bool, low_res (4h, 4w) logits, painted (H, W, 3) uint8)."""
    with profiling.span("click.full"):
        pred = predictor.predict(sam, emb, coords, labels, None, cfg)
        mask, _, _, low_res = predictor.select_best(pred, cfg, multimask)
        if two_pass:   # interact_tools.py:57-71
            pred = predictor.predict(sam, emb, coords, labels, low_res, cfg)
            mask, _, _, low_res = predictor.select_best(pred, cfg, multimask)
        painted = mask_painter(image, mask, MASK_COLOR)
        painted = point_painter(painted, coords, labels == 1, POSITIVE_COLOR)
        painted = point_painter(painted, coords, labels == 0, NEGATIVE_COLOR)
        return mask, low_res, painted


class SamController:
    """Host-side controller: the cached embedding and click-driven
    predictions, on the device the SAM model lives on."""

    def __init__(self, sam: predictor.Sam, cfg: SAMConfig,
                 device: DeviceLike = None) -> None:
        self.sam = sam
        self.cfg = cfg
        self.device = resolve_device(device)
        self.emb: Optional[predictor.ImageEmbedding] = None

    def _upload(self, image: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(image)).to(self.device)

    def set_image(self, image: np.ndarray) -> None:
        """BaseSegmenter.set_image (:31-40): encode once, keep the embedding."""
        self.emb = predictor.encode_image(self.sam, self._upload(image)[None], self.cfg)

    def reset_image(self) -> None:
        self.emb = None

    def first_frame_click(
        self,
        image: np.ndarray,
        points: np.ndarray,      # (P, 2) xy click history
        labels: np.ndarray,      # (P,) 1 pos / 0 neg
        multimask: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (mask (H, W) bool, logit (4h, 4w), painted image)."""
        if self.emb is None:
            self.set_image(image)
        labels_np = np.asarray(labels)
        pts = np.concatenate([np.asarray(points, np.float32).reshape(-1, 2),
                              np.zeros((1, 2), np.float32)], 0)
        lbl = np.concatenate([labels_np.astype(np.int64), [-1]], 0)
        # two passes when positive and negative clicks mix (:57-71)
        two_pass = bool(len(labels_np) > 1 and labels_np[-1] == 1
                        and (labels_np == 0).any())
        with profiling.span("click.upload"):
            image_t = self._upload(image)
            pts_t = torch.from_numpy(pts).to(self.device)
            lbl_t = torch.from_numpy(lbl).to(self.device)
        mask, low_res, painted = click_full(self.sam, self.emb, image_t, pts_t, lbl_t,
                                            self.cfg, multimask, two_pass)
        with profiling.span("click.download"):
            return mask.cpu().numpy(), low_res.cpu().numpy(), painted.cpu().numpy()
