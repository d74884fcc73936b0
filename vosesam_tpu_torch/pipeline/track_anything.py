"""TrackingAnything facade: the public pipeline entry point (port of
`vosesam_tpu/pipeline/track_anything.py`, XMem part).

Reference: track_anything.py (:14-95). This slice builds the XMem tracker
(config 1 of the reference, `RefinementConfig(use_refinement=False)`) and
`generator`; the SAM controller, `first_frame_click`, `generator_chunked`
and the inpainter come with later slices.

Weights: an official XMem `.pth` when `xmem_checkpoint` names an existing
file, else a seeded random init with the JAX package's scheme (lets the
pipeline run end to end without the original weights; real evaluations
must pass real checkpoints).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vosesam_tpu_torch.config import FrameworkConfig, XMemConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device
from vosesam_tpu_torch.inference.tracker import Tracker
from vosesam_tpu_torch.models.xmem.network import XMem, xmem_init


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


class TrackingAnything:
    """track_anything.py:14-33 equivalent (XMem tracker only).

    Runs on the card unless `device="cpu"`."""

    def __init__(
        self,
        xmem_checkpoint: Optional[str] = None,
        cfg: Optional[FrameworkConfig] = None,
        device: DeviceLike = None,
        seed: int = 0,
    ) -> None:
        self.cfg = cfg or FrameworkConfig()
        if self.cfg.refinement.use_refinement:
            raise NotImplementedError("SAM refinement: slice 2")
        self.device = resolve_device(device)
        net, xmem_cfg = load_or_init_xmem(xmem_checkpoint, self.cfg.xmem,
                                          self.device, seed)
        self.cfg = dataclasses.replace(self.cfg, xmem=xmem_cfg)
        self.xmem_net = net
        self.xmem = Tracker(net, self.cfg, device=self.device)

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
