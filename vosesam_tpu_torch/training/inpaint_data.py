"""Inpaint training data: video clips and free-form stroke masks (port of
`vosesam_tpu/training/inpaint_data.py`; host side, feeds
`inpaint_trainer.train_step`).

The reference ships E2FGVI's training-only modules (discriminator,
flow-completion loss) but neither a trainer nor the data recipe they exist
for (SURVEY.md §2.9). This is the JAX package's clip protocol, on the host
with numpy and Pillow's `ImageDraw`, in the JAX package's order of random
draws, so that one seed and one tree give the same frames and masks bit for
bit:

  - clips: `num_local` consecutive frames (random temporal jitter) plus
    `num_nonlocal` frames drawn uniformly from the rest of the video (the
    generator's local / non-local split);
  - masks: free-form brush strokes (random walks of thick line segments
    with discs at the joints), drawn anew per clip; with probability
    `moving_prob` the stroke field drifts across the frames by a random
    walk, else all frames share one mask;
  - frames in [-1, 1] at a fixed (h, w), masks in {0, 1} as (T, h, w, 1):
    `train_step`'s layout.

Pillow is imported where a mask is drawn or a frame resized: without it
those raise ImportError (the strokes are not drawn another way).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class StrokeConfig:
    parts: Tuple[int, int] = (2, 5)          # strokes per mask (lo, hi)
    vertices: Tuple[int, int] = (3, 8)       # walk length per stroke
    brush_width: Tuple[int, int] = (8, 28)   # px, scaled to 432-wide frames
    segment_len: Tuple[int, int] = (10, 60)
    motion_step: int = 8                     # max px of per-frame mask drift


def random_stroke_mask(rng: np.random.Generator, h: int, w: int,
                       cfg: StrokeConfig = StrokeConfig()) -> np.ndarray:
    """One (h, w) uint8 free-form mask of thick random-walk strokes."""
    from PIL import Image, ImageDraw

    scale = w / 432.0
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for _ in range(int(rng.integers(cfg.parts[0], cfg.parts[1] + 1))):
        width = max(2, int(rng.integers(*cfg.brush_width) * scale))
        x = float(rng.integers(0, w))
        y = float(rng.integers(0, h))
        ang = rng.uniform(0, 2 * np.pi)
        for _ in range(int(rng.integers(cfg.vertices[0], cfg.vertices[1] + 1))):
            ang += rng.uniform(-0.8, 0.8)
            ln = float(rng.integers(*cfg.segment_len)) * scale
            nx = float(np.clip(x + ln * np.cos(ang), 0, w - 1))
            ny = float(np.clip(y + ln * np.sin(ang), 0, h - 1))
            draw.line([(x, y), (nx, ny)], fill=255, width=width)
            draw.ellipse([nx - width / 2, ny - width / 2,
                          nx + width / 2, ny + width / 2], fill=255)
            x, y = nx, ny
    return (np.asarray(img) > 0).astype(np.uint8)


def random_mask_sequence(rng: np.random.Generator, t: int, h: int, w: int,
                         moving_prob: float = 0.5,
                         cfg: StrokeConfig = StrokeConfig()) -> np.ndarray:
    """(t, h, w) uint8: one stroke field, stationary or randomly drifting."""
    base = random_stroke_mask(rng, h, w, cfg)
    if rng.uniform() >= moving_prob:
        return np.broadcast_to(base, (t, h, w)).copy()
    out = np.empty((t, h, w), np.uint8)
    dy = dx = 0
    for i in range(t):
        out[i] = np.roll(np.roll(base, dy, 0), dx, 1)
        dy += int(rng.integers(-cfg.motion_step, cfg.motion_step + 1))
        dx += int(rng.integers(-cfg.motion_step, cfg.motion_step + 1))
    return out


class InpaintClipSampler:
    """Samples (frames, masks, num_local) for the GAN train step. `dataset`
    follows `eval.datasets.DavisDataset`'s protocol (`videos`,
    `video_info`, `load_frame`; annotations are not read)."""

    def __init__(self, dataset, num_local: int = 5, num_nonlocal: int = 3,
                 size: Tuple[int, int] = (240, 432), moving_prob: float = 0.5,
                 stroke: StrokeConfig = StrokeConfig(), seed: int = 0) -> None:
        self.ds = dataset
        self.nl = num_local
        self.nn = num_nonlocal
        self.h, self.w = size
        self.moving_prob = moving_prob
        self.stroke = stroke
        self.rng = np.random.default_rng(seed)
        self._videos: List[Tuple[str, List[str]]] = [
            (v, dataset.video_info(v)["frames"]) for v in dataset.videos]
        self._videos = [(v, f) for v, f in self._videos if len(f) >= num_local]
        if not self._videos:
            raise ValueError(f"no videos with >= {num_local} frames")

    def sample(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """-> (frames (T, h, w, 3) float32 in [-1, 1], masks (T, h, w, 1)
        float32 in {0, 1}, num_local) with T = num_local + num_nonlocal."""
        from PIL import Image

        v, files = self._videos[int(self.rng.integers(0, len(self._videos)))]
        n = len(files)
        start = int(self.rng.integers(0, max(0, n - self.nl) + 1))
        local = list(range(start, min(start + self.nl, n)))
        while len(local) < self.nl:
            local.append(local[-1])
        rest = [i for i in range(n) if i not in local] or local
        nonlocal_ = [int(self.rng.integers(0, len(rest))) for _ in range(self.nn)]
        picks = local + [rest[i] for i in nonlocal_]

        frames = np.empty((len(picks), self.h, self.w, 3), np.float32)
        for i, fi in enumerate(picks):
            img = Image.fromarray(np.asarray(self.ds.load_frame(v, files[fi])))
            img = img.resize((self.w, self.h), Image.BILINEAR)
            frames[i] = np.asarray(img, np.float32) / 127.5 - 1.0

        masks = random_mask_sequence(self.rng, len(picks), self.h, self.w, self.moving_prob,
                                     self.stroke).astype(np.float32)[..., None]
        return frames, masks, self.nl
