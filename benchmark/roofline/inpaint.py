"""E2FGVI-HQ's work in one inpainting window, counted from the plain
reference's algorithm (`reference/plainref/models/e2fgvi/generator.py`):
`torch.utils.flop_counter` over its forward on the meta device (no data,
no kernel) at the window's shape. The count is the unpadded window's: its
valid frames, the first `num_local` of them local. It holds SPyNet's 7x7
convolutions at the flows' multiple of 32, the encoder, the propagation's
offset convolutions, backbones and the deformable convolutions' products,
the focal blocks' linear layers and attention products, the soft split and
composite, and the decoder; the bilinear sampling, folds, norms and
softmax are not counted. Counts are cached by shape."""

from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


class GeneratorFlops:
    """FLOPs of one window of the generator for one configuration file."""

    def __init__(self, cfg: Dict) -> None:
        import harness  # noqa: F401  (puts the reference on the path)
        from plainref.models.e2fgvi import generator as R

        self._r = R
        with torch.device("meta"):
            self.net = R.InpaintGenerator(R.E2FGVIConfig.from_section(cfg["e2fgvi"]))

    @functools.lru_cache(maxsize=None)
    def window(self, frames: int, num_local: int, h: int, w: int) -> float:
        """FLOPs of one window of `frames` valid frames of h x w pixels."""
        x = torch.empty(1, frames, 3, h, w, device="meta")
        with FlopCounterMode(display=False) as fcm, torch.no_grad():
            self._r.forward(self.net, x, num_local)
        return float(fcm.get_total_flops())
