"""The general traffic generator: a traffic file (`traffic/<name>.json`)
and the run's seed in, the inputs of every request out. Its `kind` picks
the shape of the traffic; everything else comes from the file's
parameters, so a new mix of a known kind is a data file alone.

Kinds:
  videos   a pool of videos run back to back, each annotated on frame 0
           (`multi_object_frames` with its objects' frame-0 masks);
  stream   one continuing video played from a pool of distinct frames,
           forward and back (`soak_frames`);
  clicks   click sessions on a pool of images: each session clicks 1 to 5
           times on one object, the point history growing by one click.
The same seed gives the same inputs; every seed gives the same sizes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from harness.seeds import derive as sub_seed
from harness.seeds import rng
from traffic import frames as F

def indexed_annotation(masks: np.ndarray) -> np.ndarray:
    """(O, H, W) binary masks -> (H, W) uint8 labels 1..O (0 = background)."""
    out = np.zeros(masks.shape[1:], np.uint8)
    for k in range(masks.shape[0]):
        out[masks[k] > 0.5] = k + 1
    return out


def videos(spec: Dict, seed: int) -> List[Dict]:
    """[{frames (L, H, W, 3) uint8, annotation (H, W) uint8, objects}] in
    the file's order."""
    h, w = spec["height"], spec["width"]
    out = []
    for i, (length, o) in enumerate(spec["videos"]):
        fr = F.multi_object_frames(length, h, w, o, seed=sub_seed(seed, 1, i))
        out.append({"frames": fr, "objects": o,
                    "annotation": indexed_annotation(F.multi_object_seed_mask(h, w, o, o))})
    return out


def stream(spec: Dict, seed: int) -> Dict:
    """{pool (P, H, W, 3) uint8, annotation (H, W) uint8, objects}; frame t
    of the stream is pool[pingpong(t)]."""
    h, w = spec["height"], spec["width"]
    if spec["objects"] != 2:
        raise ValueError("stream traffic: soak_frames carries 2 objects")
    pool = F.soak_frames(spec["pool_frames"], h, w, seed=sub_seed(seed, 2))
    return {"pool": pool, "objects": 2,
            "annotation": indexed_annotation(F.soak_seed_mask(h, w, 2))}


def pingpong(t: int, n: int) -> int:
    """Pool index of stream frame t: 0, 1, ..., n-1, n-2, ..., 1, 0, 1, ..."""
    period = 2 * (n - 1)
    m = t % period
    return m if m < n else period - m


def clicks(spec: Dict, seed: int, n_sessions: int) -> Dict:
    """{images (N, H, W, 3) uint8, sessions: [{image, object, points (P, 2)
    xy float32, labels (P,) int}]}: session j clicks P times, its request p
    sends the first p points."""
    h, w = spec["height"], spec["width"]
    n_img, n_obj = spec["images"], spec["objects"]
    imgs = F.multi_object_frames(n_img, h, w, n_obj, seed=sub_seed(seed, 3))
    r = rng(seed, 4)
    lengths = spec["session_clicks"]
    sessions = []
    while len(sessions) < n_sessions:
        for p in r.permutation(lengths).tolist():
            img = int(r.integers(n_img))
            k = int(r.integers(n_obj))
            # the object's box on this image (its trajectory at frame img)
            yb, xb = F.anchor(k)
            y0 = yb + F.tri((2 + k % 3) * img, 60)
            x0 = xb + F.tri((3 + k % 2) * img, 40)
            pts, lbl = [], []
            for c in range(p):
                neg = c > 0 and r.random() < spec["negative_share"]
                if neg:
                    while True:
                        x, y = r.uniform(0, w), r.uniform(0, h)
                        if not (x0 <= x < x0 + 160 and y0 <= y < y0 + 120):
                            break
                else:
                    x, y = r.uniform(x0, x0 + 160), r.uniform(y0, y0 + 120)
                pts.append((x, y))
                lbl.append(0 if neg else 1)
            sessions.append({"image": img, "object": k,
                             "points": np.asarray(pts, np.float32),
                             "labels": np.asarray(lbl, np.int64)})
    return {"images": imgs, "sessions": sessions[:n_sessions]}
