"""Synthetic dataset trees for the evaluation harness, made from a seed with
numpy at any H x W:

    python -m vosesam_tpu_torch.eval.synthetic --out DIR [--seed 0]
        [--hw 480x854] [--format png|jpg]

Writes the layouts the loaders read (the data half of `run_parity.py`'s
`_syn_data`):

  DIR/DAVIS/JPEGImages/480p/<video>/NNNNN.<ext>, Annotations/480p/<video>/NNNNN.png,
      ImageSets/2016/val.txt (bear: one object), ImageSets/2017/val.txt
      (bear, bike-packing: two objects, both on frame 0)
  DIR/LongDataset/JPEGImages/clip/..., Annotations/clip/ every `long_every`-th
      frame (sparse ground truth), val.txt
  DIR/LVOS/JPEGImages/clip/..., Annotations/clip/00000.png only, test.txt
  DIR/OVIS/train_images/<video>/NNNNN.<ext>, DIR/OVIS/annotations.json
      (COCO-VIS: `videos`, per-frame compressed RLE `segmentations`)

Each video is textured noise with filled ellipses of fixed colours moving on
straight lines; the annotations are exactly the ellipses. Frames are
lossless PNG (the standard-library writer) or JPEG (`--format jpg`, where
the codec can encode: Pillow). `write_tree` returns every annotation it
wrote, so a check can compare the harness's inputs with their source.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from vosesam_tpu_torch.eval import codec
from vosesam_tpu_torch.eval.palette import save_palette_mask

COLOURS = ((220, 60, 60), (60, 200, 220), (240, 220, 40), (140, 70, 200))


def encode_rle_string(mask: np.ndarray) -> Dict:
    """(h, w) binary mask -> compressed COCO RLE {"size", "counts": str}
    (cocoapi's rleToString: 6 bits a character, deltas against the count two
    back)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)          # column-major
    changes = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], changes, [flat.size]])).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    out = []
    for i, c in enumerate(runs):
        x = c - runs[i - 2] if i > 2 else c
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = x != -1 if ch & 0x10 else x != 0
            if more:
                ch |= 0x20
            out.append(chr(ch + 48))
    return {"size": [h, w], "counts": "".join(out)}


class _Scene:
    """Moving ellipses over a fixed noise texture."""

    def __init__(self, rng: np.random.Generator, h: int, w: int, n_objects: int) -> None:
        self.h, self.w = h, w
        self.texture = rng.integers(0, 256, (h, w, 3), np.uint8)
        self.objects = []
        for i in range(n_objects):
            ry, rx = rng.uniform(0.08, 0.16) * h, rng.uniform(0.06, 0.12) * w
            cy = rng.uniform(0.25, 0.75) * h
            cx = (0.3 + 0.4 * i / max(n_objects - 1, 1)) * w
            vy, vx = rng.uniform(-0.004, 0.004) * h, rng.uniform(-0.006, 0.006) * w
            self.objects.append((cy, cx, ry, rx, vy, vx, COLOURS[i % len(COLOURS)]))

    def frame(self, t: int, present: Sequence[bool]) -> Tuple[np.ndarray, np.ndarray]:
        """(RGB frame, indexed mask) at time t; object i is label i + 1,
        later objects drawn over earlier ones."""
        yy, xx = np.mgrid[0:self.h, 0:self.w]
        img = self.texture.copy()
        mask = np.zeros((self.h, self.w), np.uint8)
        for i, (cy, cx, ry, rx, vy, vx, colour) in enumerate(self.objects):
            if not present[i]:
                continue
            inside = ((yy - cy - vy * t) / ry) ** 2 + ((xx - cx - vx * t) / rx) ** 2 <= 1.0
            img[inside] = (0.75 * np.asarray(colour) + 0.25 * img[inside]).astype(np.uint8)
            mask[inside] = i + 1
        return img, mask


def _write_frame(path: str, rgb: np.ndarray, fmt: str) -> str:
    path = f"{path}.{fmt}"
    if fmt == "png":
        codec.write_png_rgb(path, rgb)
    else:
        codec.write_jpeg(path, rgb)
    return path


def _video(root_img: str, root_ann: str, scene: _Scene, n: int, fmt: str,
           annotated: Sequence[int], appear: Sequence[int]) -> Dict[int, np.ndarray]:
    """Write one video's frames and the annotations of the `annotated`
    frames; object i is on screen from frame appear[i]."""
    os.makedirs(root_img, exist_ok=True)
    os.makedirs(root_ann, exist_ok=True)
    masks = {}
    for t in range(n):
        img, mask = scene.frame(t, [t >= a for a in appear])
        _write_frame(os.path.join(root_img, f"{t:05d}"), img, fmt)
        if t in annotated:
            save_palette_mask(mask, os.path.join(root_ann, f"{t:05d}.png"))
            masks[t] = mask
    return masks


def write_tree(out: str, h: int = 480, w: int = 854, seed: int = 0, fmt: str = "png",
               davis_frames: int = 16, long_frames: int = 24, long_every: int = 8,
               lvos_frames: int = 12, ovis_frames: int = 8) -> Dict[str, Dict]:
    """Write all four trees under `out`. Returns {"DAVIS/<video>" |
    "LongDataset/clip" | "LVOS/clip" | "OVIS/<video>": {frame: mask}} of
    every annotation written (OVIS: the indexed masks its RLEs decode to)."""
    if fmt not in ("png", "jpg"):
        raise ValueError(f"frame format must be png or jpg, got {fmt!r}")
    if fmt == "jpg" and not codec.jpeg_encoder_available():
        raise ImportError("JPEG frames need Pillow to encode them; use --format png")
    rng = np.random.default_rng(seed)
    written: Dict[str, Dict] = {}

    davis = os.path.join(out, "DAVIS")
    for year, videos in (("2016", ("bear",)), ("2017", ("bear", "bike-packing"))):
        os.makedirs(os.path.join(davis, "ImageSets", year), exist_ok=True)
        with open(os.path.join(davis, "ImageSets", year, "val.txt"), "w") as f:
            f.write("".join(v + "\n" for v in videos))
    for video, n_obj in (("bear", 1), ("bike-packing", 2)):
        written[f"DAVIS/{video}"] = _video(
            os.path.join(davis, "JPEGImages", "480p", video),
            os.path.join(davis, "Annotations", "480p", video),
            _Scene(rng, h, w, n_obj), davis_frames, fmt, range(davis_frames), [0] * n_obj)

    for name, n, every, split in (("LongDataset", long_frames, long_every, "val.txt"),
                                  ("LVOS", lvos_frames, 0, "test.txt")):
        root = os.path.join(out, name)
        written[f"{name}/clip"] = _video(
            os.path.join(root, "JPEGImages", "clip"), os.path.join(root, "Annotations", "clip"),
            _Scene(rng, h, w, 2), n, fmt, range(0, n, every) if every else [0], [0, 0])
        with open(os.path.join(root, split), "w") as f:
            f.write("clip\n")

    # OVIS: the second object enters on frame 2 (absent before: a null RLE)
    ovis = os.path.join(out, "OVIS")
    scene = _Scene(rng, h, w, 2)
    appear = (0, 2)
    video = "ovis-clip"
    os.makedirs(os.path.join(ovis, "train_images", video), exist_ok=True)
    files, segs, gt = [], [[], []], {}
    for t in range(ovis_frames):
        img, mask = scene.frame(t, [t >= a for a in appear])
        path = _write_frame(os.path.join(ovis, "train_images", video, f"{t:05d}"), img, fmt)
        files.append(os.path.relpath(path, os.path.join(ovis, "train_images")))
        for i in range(2):
            segs[i].append(encode_rle_string(mask == i + 1) if t >= appear[i] else None)
        gt[t] = mask
    ann = {"videos": [{"id": 1, "file_names": files, "height": h, "width": w, "length": ovis_frames}],
           "annotations": [{"id": i + 1, "video_id": 1, "category_id": 1, "iscrowd": 0,
                            "segmentations": segs[i]} for i in range(2)],
           "categories": [{"id": 1, "name": "object"}]}
    with open(os.path.join(ovis, "annotations.json"), "w") as f:
        json.dump(ann, f)
    written[f"OVIS/{video}"] = gt
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hw", default="480x854", help="frame height x width")
    ap.add_argument("--format", default="png", choices=("png", "jpg"))
    args = ap.parse_args(argv)
    h, w = (int(v) for v in args.hw.split("x"))
    written = write_tree(args.out, h, w, args.seed, args.format)
    print(json.dumps({k: sorted(v) for k, v in written.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
