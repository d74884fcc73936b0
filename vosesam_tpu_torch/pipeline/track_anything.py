"""TrackingAnything facade: the public pipeline entry point (port of
`vosesam_tpu/pipeline/track_anything.py`).

Reference: track_anything.py (:14-95). Builds the XMem tracker and, when
refinement is on (or a SAM checkpoint is given), the SAM / SAM-HQ model with
its click controller (`samcontroler`, the reference's spelling);
`first_frame_click` seeds a video from clicks, `generator` tracks frame by
frame, `generator_chunked` seeds frame 0 and runs the rest through the
chunked path. With `e2fgvi_checkpoint=` the facade also holds the E2FGVI
video inpainter as `baseinpainter` (`pipeline/inpaint.py`): track, then
`baseinpainter.inpaint(frames, masks)` removes the tracked objects.

Weights: an official checkpoint when the path names an existing file, else
seeded random weights with the JAX package's schemes (XMem from `seed`, SAM
from `seed + 1`, mirroring the JAX facade's PRNGKey(0) / PRNGKey(1); the
inpainter from `seed + 2`); real evaluations must pass real checkpoints.
SAM's weights are held in `cfg.dtype`, the inpainter's in fp32.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vosesam_tpu_torch.config import FrameworkConfig, SAMConfig, XMemConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from vosesam_tpu_torch.inference.tracker import Tracker
from vosesam_tpu_torch.models.sam.predictor import Sam, sam_init
from vosesam_tpu_torch.models.xmem.network import XMem, xmem_init
from vosesam_tpu_torch.pipeline.interact import SamController


def load_or_init_xmem(checkpoint: Optional[str], cfg: XMemConfig,
                      device: DeviceLike = None, seed: int = 0
                      ) -> Tuple[XMem, XMemConfig]:
    dev = resolve_device(device)
    if checkpoint and os.path.exists(checkpoint):
        from vosesam_tpu_torch.utils.checkpoint import load_xmem_checkpoint

        sd, cfg = load_xmem_checkpoint(checkpoint, cfg)
        net = XMem(cfg)
        net.load_state_dict(sd, strict=True)
        return net.to(dev).eval(), cfg
    return xmem_init(cfg, seed=seed, device=dev).eval(), cfg


def load_or_init_sam(checkpoint: Optional[str], cfg: SAMConfig,
                     device: DeviceLike = None, seed: int = 1,
                     dtype: torch.dtype = torch.float32) -> Sam:
    dev = resolve_device(device)
    if checkpoint and os.path.exists(checkpoint):
        from vosesam_tpu_torch.utils.checkpoint import load_sam_checkpoint

        with torch.device("meta"):    # every tensor comes from the file
            sam = Sam(cfg)
        sam.load_state_dict(load_sam_checkpoint(checkpoint), strict=True, assign=True)
        return sam.to(device=dev, dtype=dtype).eval()
    return sam_init(cfg, seed=seed, device=dev, dtype=dtype)


class TrackingAnything:
    """track_anything.py:14-33 equivalent. Runs on the card unless
    `device="cpu"`."""

    def __init__(
        self,
        sam_checkpoint: Optional[str] = None,
        xmem_checkpoint: Optional[str] = None,
        cfg: Optional[FrameworkConfig] = None,
        device: DeviceLike = None,
        seed: int = 0,
        e2fgvi_checkpoint: Optional[str] = None,
        save_inner_masks_folder: Optional[str] = None,
        inpaint_mesh=None,
    ) -> None:
        """`save_inner_masks_folder`: the tracker writes each propagated
        frame's XMem and refined masks under <folder>/inner/ (`Tracker`).
        `inpaint_mesh`: a `parallel.mesh.Mesh`; the inpainter's static
        windows then run data-parallel over its data axis."""
        self.cfg = cfg or FrameworkConfig()
        self.device = resolve_device(device)
        net, xmem_cfg = load_or_init_xmem(xmem_checkpoint, self.cfg.xmem,
                                          self.device, seed)
        self.cfg = dataclasses.replace(self.cfg, xmem=xmem_cfg)
        self.xmem_net = net
        self.sam = (
            load_or_init_sam(sam_checkpoint, self.cfg.sam, self.device, seed + 1,
                             torch_dtype(self.cfg.dtype))
            if (self.cfg.refinement.use_refinement or sam_checkpoint) else None)
        self.samcontroler = (SamController(self.sam, self.cfg.sam, self.device)
                             if self.sam is not None else None)
        self.xmem = Tracker(net, self.cfg, device=self.device, sam=self.sam,
                            save_inner_masks_folder=save_inner_masks_folder)
        self.baseinpainter = None
        if e2fgvi_checkpoint:
            from vosesam_tpu_torch.pipeline.inpaint import Inpainter

            self.baseinpainter = Inpainter(e2fgvi_checkpoint, self.cfg.inpainter,
                                           mesh=inpaint_mesh, device=self.device,
                                           seed=seed + 2)

    def first_frame_click(self, image: np.ndarray, points: np.ndarray, labels: np.ndarray,
                          multimask: bool = True):
        """track_anything.py:48-50: (mask (H, W) bool, logit, painted image)."""
        return self.samcontroler.first_frame_click(image, points, labels, multimask)

    def generator(
        self, images: Sequence[np.ndarray], template_mask: np.ndarray
    ) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], List[list]]:
        """track_anything.py:56-81: frame 0 seeds with the template mask, the
        rest propagate. Returns (masks, logits, painted_images, scores)."""
        masks, logits, painted, scores = [], [], [], []
        for i, img in enumerate(images):
            m, lg, p, s = self.xmem.track(img, template_mask if i == 0 else None)
            masks.append(m)
            logits.append(lg)
            painted.append(p)
            scores.append(s)
        return masks, logits, painted, scores

    def generator_chunked(self, images: Sequence[np.ndarray], template_mask: np.ndarray,
                          chunk: int = 4, paint: bool = False):
        """Throughput variant of generator(): frame 0 seeds per frame, the
        rest run through `Tracker.track_batch`. Returns (masks, scores); with
        `paint=True`, (masks, painted_images, scores)."""
        m0, _lg, p0, s0 = self.xmem.track(images[0], template_mask)
        if paint:
            masks, painted, scores = self.xmem.track_batch(list(images[1:]), chunk=chunk,
                                                           paint=True)
            return [m0] + masks, [p0] + painted, [s0] + scores
        masks, scores = self.xmem.track_batch(list(images[1:]), chunk=chunk)
        return [m0] + masks, [s0] + scores


def parse_augment() -> argparse.Namespace:
    """track_anything.py:84-95."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--sam_model_type", type=str, default="vit_h")
    parser.add_argument("--port", type=int, default=6080)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--mask_save", type=bool, default=False)
    return parser.parse_args()
