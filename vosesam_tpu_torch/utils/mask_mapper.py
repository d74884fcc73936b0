"""Palette-index mask <-> contiguous one-hot conversion (host side, numpy;
the port's own copy of `vosesam_tpu/utils/mask_mapper.py`).

Reference: tracker/util/mask_mapper.py — DAVIS palette masks can carry
non-contiguous labels (e.g. {0, 3, 7}); MaskMapper remaps them to contiguous
object slots for the network and restores the original labels on output
(consumed at base_tracker.py:187-191)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class MaskMapper:
    """Stateful label remapping for one video."""

    def __init__(self) -> None:
        self.labels: List[int] = []          # original labels, slot order
        self.remappings: Dict[int, int] = {}  # original -> contiguous (1-based)

    def clear(self) -> None:
        self.labels = []
        self.remappings = {}

    def convert_mask(self, mask: np.ndarray) -> Tuple[np.ndarray, List[int]]:
        """Indexed (H, W) mask -> ((N, H, W) float32 one-hot of NEW labels,
        list of new contiguous labels). Already-seen labels are skipped
        (mask_mapper.py:40-67 semantics)."""
        found = sorted(int(l) for l in np.unique(mask) if l != 0)
        new_labels = [l for l in found if l not in self.remappings]
        for l in new_labels:
            self.remappings[l] = len(self.labels) + 1
            self.labels.append(l)
        onehot = np.stack(
            [(mask == l).astype(np.float32) for l in new_labels], axis=0
        ) if new_labels else np.zeros((0,) + mask.shape, np.float32)
        return onehot, [self.remappings[l] for l in new_labels]

    def remap_index_mask(self, indexed: np.ndarray) -> np.ndarray:
        """Contiguous-slot indexed mask -> original labels (inverse map)."""
        out = np.zeros_like(indexed)
        for orig, new in self.remappings.items():
            out[indexed == new] = orig
        return out

    @property
    def num_objects(self) -> int:
        return len(self.labels)

