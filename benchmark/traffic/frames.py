"""Synthetic 480p frame families, frozen copies of the port's bench
generators (`vosesam_tpu_torch/bench.py` at the commit that added this
benchmark: `moving_frames`, `seed_mask`, `tri`, `_OBJ_COLORS`, `_anchor`,
`multi_object_frames`, `multi_object_seed_mask`, `soak_frames`,
`soak_seed_mask`), bit-equal to them. A later change to the port's bench
does not move these.

Each takes its own numpy seed; `generate.py` derives those seeds from the
run's `--seed`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# the object colours of `multi_object_frames`, one per object
OBJ_COLORS = (
    (220, 60, 60), (60, 200, 220), (60, 220, 90), (230, 200, 50),
    (200, 60, 220), (240, 140, 40), (80, 90, 230), (160, 230, 160),
)


def moving_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """n frames with two objects translating over textured noise."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 255, (h, w, 3), np.uint8)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        y0 = 100 + 2 * i
        x0 = (150 + 5 * i) % (w - 360)
        f[y0:y0 + 220, x0:x0 + 350] = (220, 60, 60)
        y1 = (50 + 3 * i) % (h - 110)
        f[y1:y1 + 100, 600:750] = (60, 200, 220)
        out[i] = f
    return out


def seed_mask(h: int, w: int, max_objects: int) -> np.ndarray:
    """The two objects of `moving_frames` on frame 0, (max_objects, H, W)."""
    m = np.zeros((max_objects, h, w), np.float32)
    m[0, 100:320, 150:500] = 1.0
    m[1, 50:150, 600:750] = 1.0
    return m


def tri(t: int, amp: int) -> int:
    """Triangle wave in [0, amp]: bounded periodic motion."""
    m = t % (2 * amp)
    return amp - abs(amp - m)


def anchor(k: int) -> Tuple[int, int]:
    """Top-left corner of object k's trajectory in `multi_object_frames`."""
    return 30 + (k // 4) * 240, 20 + (k % 4) * 210


def multi_object_frames(n: int, h: int, w: int, o: int, seed: int = 0) -> np.ndarray:
    """n frames with `o` 120x160 rectangles on distinct periodic
    trajectories (grid-anchored, per-object velocities)."""
    if not 1 <= o <= 8:
        raise ValueError(f"multi_object_frames: 1 <= o <= 8, got {o}")
    r = np.random.default_rng(seed)
    base = r.integers(0, 255, (h, w, 3), np.uint8)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        for k in range(o):
            yb, xb = anchor(k)
            y0 = yb + tri((2 + k % 3) * i, 60)
            x0 = xb + tri((3 + k % 2) * i, 40)
            f[y0:y0 + 120, x0:x0 + 160] = OBJ_COLORS[k]
        out[i] = f
    return out


def multi_object_seed_mask(h: int, w: int, o: int, max_objects: int) -> np.ndarray:
    """Frame-0 masks of `multi_object_frames`' o objects, (max_objects, H, W)."""
    m = np.zeros((max_objects, h, w), np.float32)
    for k in range(o):
        yb, xb = anchor(k)
        m[k, yb:yb + 120, xb:xb + 160] = 1.0
    return m


def soak_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """n frames with two objects on periodic (triangle-wave) trajectories
    that stay in the frame for any length of rollout."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 255, (h, w, 3), np.uint8)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        y0 = 40 + tri(2 * i, 180)
        x0 = 10 + tri(5 * i, 470)
        f[y0:y0 + 220, x0:x0 + 350] = (220, 60, 60)
        y1 = 30 + tri(3 * i, 340)
        x1 = 560 + tri(2 * i, 140)
        f[y1:y1 + 100, x1:x1 + 150] = (60, 200, 220)
        out[i] = f
    return out


def soak_seed_mask(h: int, w: int, max_objects: int) -> np.ndarray:
    """The two objects of `soak_frames` on frame 0, (max_objects, H, W)."""
    m = np.zeros((max_objects, h, w), np.float32)
    m[0, 40:260, 10:360] = 1.0
    m[1, 30:130, 560:710] = 1.0
    return m
