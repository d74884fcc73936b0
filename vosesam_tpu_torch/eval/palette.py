"""DAVIS palette PNG IO (port of `vosesam_tpu/eval/palette.py`), on the
port's own PNG codec: the same palette and index bytes as Pillow writes and
reads."""

from __future__ import annotations

import numpy as np

from vosesam_tpu_torch.eval import codec


def pascal_colormap(n: int = 256) -> np.ndarray:
    """Standard PASCAL VOC colormap (bit-reversal construction)."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def save_palette_mask(mask: np.ndarray, path: str) -> None:
    codec.write_png_palette(path, mask.astype(np.uint8), pascal_colormap())


def load_palette_mask(path: str) -> np.ndarray:
    return codec.png_indices(path)
