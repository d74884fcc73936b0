"""Training clip sampler for DAVIS-style trees (port of
`vosesam_tpu/training/data.py`; host side, feeds `trainer.train_step`).

The reference ships a vestigial DDP trainer with no data pipeline
(`tracker/model/trainer.py`'s imports cannot resolve, SURVEY.md §2.3). Its
hyperparameters (`num_frames`, `deep_update_prob`, max-skip curriculum)
are those of the standard XMem VOS training recipe, which this implements
on the host with numpy and Pillow, in the JAX package's order of random
draws, so that one seed and one tree give the same clips bit for bit:

  frames (B, T, H, W, 3) float32, ImageNet-normalized
  gt     (B, T, H, W)    int32 in [0, max_objects]  (0 = background)
  valid  (B, O)          bool  (slot seeded in frame 0)

  - temporal: T frames in order with random gaps <= max_jump (curriculum via
    `set_max_jump`, the reference config's increase_skip schedule);
  - spatial (paired): random resized crop to a square `crop` (bilinear for
    frames, nearest for masks) + horizontal flip, retried up to 5 times
    until at least one object survives in frame 0;
  - photometric (frames only): brightness / contrast jitter;
  - labels: objects present in the augmented frame 0 are remapped to
    contiguous slots 1..O (at most `max_objects`, a random subset beyond).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

# ImageNet statistics (ops/image.py uses the same constants on the device)
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class ClipSamplerConfig:
    seq_length: int = 8          # T frames per clip (trainer config num_frames)
    max_jump: int = 5            # max inter-frame gap (max-skip curriculum)
    crop: int = 384              # square crop fed to the model (XMem stage 3)
    min_scale: float = 0.36      # area fraction bounds of the resized crop
    max_scale: float = 1.0
    hflip_prob: float = 0.5
    brightness: float = 0.1      # photometric jitter half-ranges
    contrast: float = 0.1
    retries: int = 5             # crop retries until an object survives


class ClipSampler:
    """Samples augmented training clips from a DavisDataset-style source.

    `dataset` needs: `videos` (list of names), `video_info(v) ->
    {"frames": [...]}`, `load_frame(v, f) -> (H, W, 3) uint8`,
    `load_mask(v, f) -> (H, W) int or None` (`eval/datasets.py`
    DavisDataset), and optionally `has_mask(v, f)`. Only annotated frames
    are sampled."""

    def __init__(self, dataset, cfg: ClipSamplerConfig, max_objects: int,
                 seed: int = 0) -> None:
        self.ds = dataset
        self.cfg = cfg
        self.o = max_objects
        self.rng = np.random.default_rng(seed)
        self._annotated: List[Tuple[str, List[str]]] = []
        probe = getattr(dataset, "has_mask", None) or (
            lambda v, f: dataset.load_mask(v, f) is not None)
        for v in dataset.videos:
            frames = [f for f in dataset.video_info(v)["frames"] if probe(v, f)]
            if len(frames) >= 2:
                self._annotated.append((v, frames))
        if not self._annotated:
            raise ValueError("no videos with >=2 annotated frames")

    # -- curriculum hook (reference config's increase_skip_fraction) --------
    def set_max_jump(self, max_jump: int) -> None:
        self.cfg = dataclasses.replace(self.cfg, max_jump=max_jump)

    # ----------------------------------------------------------------------
    def _pick_frames(self, frames: List[str]) -> List[str]:
        t = self.cfg.seq_length
        n = len(frames)
        idx = [int(self.rng.integers(0, n))]
        for _ in range(t - 1):
            lo = idx[-1] + 1
            if lo >= n:                       # ran off the end: walk back
                idx = [max(0, i - 1) for i in idx]
                lo = idx[-1] + 1
            hi = min(n - 1, idx[-1] + max(1, self.cfg.max_jump))
            idx.append(int(self.rng.integers(lo, hi + 1)) if hi >= lo else n - 1)
        return [frames[min(i, n - 1)] for i in idx]

    def _crop_params(self, h: int, w: int) -> Tuple[int, int, int]:
        area = h * w
        scale = self.rng.uniform(self.cfg.min_scale, self.cfg.max_scale)
        side = int(round(np.sqrt(area * scale)))
        side = max(16, min(side, h, w))
        y0 = int(self.rng.integers(0, h - side + 1))
        x0 = int(self.rng.integers(0, w - side + 1))
        return y0, x0, side

    def _apply(self, imgs: List[np.ndarray], masks: List[np.ndarray],
               y0: int, x0: int, side: int, flip: bool) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        c = self.cfg.crop
        out_i = np.empty((len(imgs), c, c, 3), np.uint8)
        out_m = np.empty((len(masks), c, c), np.int32)
        for i, (im, mk) in enumerate(zip(imgs, masks)):
            im = im[y0:y0 + side, x0:x0 + side]
            mk = mk[y0:y0 + side, x0:x0 + side]
            if flip:
                im, mk = im[:, ::-1], mk[:, ::-1]
            out_i[i] = np.array(Image.fromarray(im).resize((c, c), Image.BILINEAR))
            out_m[i] = np.array(Image.fromarray(mk.astype(np.uint8)).resize(
                (c, c), Image.NEAREST))
        return out_i, out_m

    def sample_clip(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (frames (T, c, c, 3) float32 normalized, gt (T, c, c) int32
        in [0, O], obj_valid (O,) bool)."""
        v, frames = self._annotated[int(self.rng.integers(0, len(self._annotated)))]
        picks = self._pick_frames(frames)
        imgs = [np.asarray(self.ds.load_frame(v, f)) for f in picks]
        masks = [np.asarray(self.ds.load_mask(v, f)).astype(np.int32) for f in picks]
        h, w = imgs[0].shape[:2]

        for attempt in range(self.cfg.retries):
            y0, x0, side = self._crop_params(h, w)
            flip = bool(self.rng.uniform() < self.cfg.hflip_prob)
            ci, cm = self._apply(imgs, masks, y0, x0, side, flip)
            labels = np.unique(cm[0])
            labels = labels[labels > 0]
            if len(labels) > 0 or attempt == self.cfg.retries - 1:
                break

        # remap present-in-frame-0 labels to contiguous slots 1..O
        if len(labels) > self.o:
            labels = self.rng.choice(labels, self.o, replace=False)
        gt = np.zeros_like(cm)
        valid = np.zeros((self.o,), bool)
        for slot, lbl in enumerate(sorted(int(v) for v in labels)):
            gt[cm == lbl] = slot + 1
            valid[slot] = True

        # photometric jitter (frames only), then ImageNet normalize
        fimg = ci.astype(np.float32) / 255.0
        b = self.rng.uniform(-self.cfg.brightness, self.cfg.brightness)
        cmul = 1.0 + self.rng.uniform(-self.cfg.contrast, self.cfg.contrast)
        fimg = np.clip((fimg - 0.5) * cmul + 0.5 + b, 0.0, 1.0)
        fimg = (fimg - _MEAN) / _STD
        return fimg, gt, valid

    def sample_batch(self, batch: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> stacked (B, T, c, c, 3), (B, T, c, c), (B, O)."""
        clips = [self.sample_clip() for _ in range(batch)]
        return (np.stack([c[0] for c in clips]), np.stack([c[1] for c in clips]),
                np.stack([c[2] for c in clips]))
