"""Dataset loaders: DAVIS 2016/2017, LongDataset, LVOS (port of
`vosesam_tpu/eval/datasets.py`).

Reference: dataset/dataset.py (DAVIS_MO_Test :12-93), dataset/longdataset.py
(LongVideoDataset :8-101 — used for both LongDataset and LVOS), and
tools/video_loading.py. Images are loaded lazily per frame; masks come from
palette PNGs. Frames are listed by directory, as in JAX. `.jpg` / `.jpeg`
frames decode through the JPEG path of `codec.py` (the native libjpeg
loader); any other frame file is read by its content (a PNG on the
standard-library reader), as the JAX harness reads every non-JPEG through
Pillow.

Layouts:
  DAVIS:       <root>/JPEGImages/480p/<video>/*.jpg
               <root>/Annotations/480p/<video>/*.png
               <root>/ImageSets/<year>/<split>.txt
  LongDataset: <root>/JPEGImages/<video>/*.jpg, Annotations/<video>/*.png,
               val.txt/test.txt at the root (sparse GT: only some frames
               annotated).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from vosesam_tpu_torch.eval import codec

JPEG_SUFFIXES = (".jpg", ".jpeg")


def load_image(path: str) -> np.ndarray:
    """RGB uint8 (tools/video_loading.py:6-20)."""
    if path.lower().endswith(JPEG_SUFFIXES):
        return codec.decode_jpegs([path])[0]
    return codec.read_rgb(path)


def load_images(paths: List[str]) -> List[np.ndarray]:
    """Frames in order; an all-JPEG list decodes in one native batch."""
    if paths and all(p.lower().endswith(JPEG_SUFFIXES) for p in paths):
        return codec.decode_jpegs(paths)
    return [load_image(p) for p in paths]


def load_indexed_mask(path: str, void_to_zero: bool = True) -> np.ndarray:
    """Palette PNG -> (H, W) uint8 label map; void 255 -> 0
    (longdataset.py:90-92)."""
    m = codec.png_indices(path).copy()
    if void_to_zero:
        m[m == 255] = 0
    return m


class DavisDataset:
    """DAVIS_MO_Test equivalent (dataset/dataset.py:12-93)."""

    def __init__(
        self,
        root: str,
        imset: str = "2017/val.txt",
        resolution: str = "480p",
        single_object: bool = False,
    ) -> None:
        self.root = root
        self.single_object = single_object  # DAVIS-2016 binarization (:86)
        self.image_dir = os.path.join(root, "JPEGImages", resolution)
        self.mask_dir = os.path.join(root, "Annotations", resolution)
        imset_path = os.path.join(root, "ImageSets", imset)
        with open(imset_path) as f:
            self.videos = [ln.strip() for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.videos)

    def video_info(self, video: str) -> Dict:
        frames = sorted(os.listdir(os.path.join(self.image_dir, video)))
        first_mask = load_indexed_mask(os.path.join(self.mask_dir, video, "00000.png"))
        num_objects = int(first_mask.max())  # frame-0 palette max (:36)
        if self.single_object:
            num_objects = 1
        return {
            "name": video,
            "frames": frames,
            "num_frames": len(frames),
            "num_objects": num_objects,
        }

    def load_frame(self, video: str, frame_file: str) -> np.ndarray:
        return load_image(os.path.join(self.image_dir, video, frame_file))

    def load_frames(self, video: str, frames: List[str]) -> List[np.ndarray]:
        return load_images([os.path.join(self.image_dir, video, f) for f in frames])

    def has_mask(self, video: str, frame_file: str) -> bool:
        """Cheap annotation-existence probe (no PNG decode)."""
        return os.path.exists(os.path.join(
            self.mask_dir, video, frame_file.replace(".jpg", ".png")))

    def load_mask(self, video: str, frame_file: str) -> Optional[np.ndarray]:
        path = os.path.join(self.mask_dir, video, frame_file.replace(".jpg", ".png"))
        if not os.path.exists(path):
            return None
        m = load_indexed_mask(path)
        if self.single_object:
            m = (m > 0).astype(np.uint8)  # dataset.py:86
        return m

    def iter_videos(self):
        for v in self.videos:
            yield self.video_info(v)


class LongVideoDataset:
    """LongVideoDataset equivalent (dataset/longdataset.py:8-101); also used
    for LVOS (sequence list from val.txt / test.txt; sparse annotations)."""

    def __init__(self, root: str, split_file: str = "val.txt") -> None:
        self.root = root
        self.image_dir = os.path.join(root, "JPEGImages")
        self.mask_dir = os.path.join(root, "Annotations")
        split_path = os.path.join(root, split_file)
        if os.path.exists(split_path):
            with open(split_path) as f:
                self.videos = [ln.strip() for ln in f if ln.strip()]
        else:
            self.videos = sorted(os.listdir(self.image_dir))

    def __len__(self) -> int:
        return len(self.videos)

    def video_info(self, video: str) -> Dict:
        frames = sorted(os.listdir(os.path.join(self.image_dir, video)))
        mask_files = sorted(os.listdir(os.path.join(self.mask_dir, video)))
        annotated = {os.path.splitext(m)[0] for m in mask_files}
        test_ids = [
            i for i, fr in enumerate(frames)
            if os.path.splitext(fr)[0] in annotated
        ]  # sparse GT frame ids (runner.py:152-153)
        first = load_indexed_mask(os.path.join(self.mask_dir, video, mask_files[0]))
        return {
            "name": video,
            "frames": frames,
            "num_frames": len(frames),
            "num_objects": int(first.max()),
            "test_ids": test_ids,
        }

    def load_frame(self, video: str, frame_file: str) -> np.ndarray:
        return load_image(os.path.join(self.image_dir, video, frame_file))

    def load_frames(self, video: str, frames: List[str]) -> List[np.ndarray]:
        return load_images([os.path.join(self.image_dir, video, f) for f in frames])

    def has_mask(self, video: str, frame_file: str) -> bool:
        """Cheap annotation-existence probe (no PNG decode)."""
        return os.path.exists(os.path.join(
            self.mask_dir, video, os.path.splitext(frame_file)[0] + ".png"))

    def load_mask(self, video: str, frame_file: str) -> Optional[np.ndarray]:
        path = os.path.join(self.mask_dir, video, os.path.splitext(frame_file)[0] + ".png")
        if not os.path.exists(path):
            return None
        return load_indexed_mask(path)

    def get_all_masks(self, video: str) -> Dict[int, np.ndarray]:
        """Per-object boolean split of every annotated frame
        (longdataset.py:85-101)."""
        info = self.video_info(video)
        out = {}
        for i in info["test_ids"]:
            m = self.load_mask(video, info["frames"][i])
            if m is not None:
                out[i] = m
        return out

    def iter_videos(self):
        for v in self.videos:
            yield self.video_info(v)


def unify_masks(per_object: List[np.ndarray], labels: List[int]) -> np.ndarray:
    """Combine per-object binary masks into one indexed mask
    (tools/masks_handler.py unifyMasks, consumed at runner.py:55-57)."""
    out = np.zeros(per_object[0].shape, np.uint8)
    for m, l in zip(per_object, labels):
        out[m > 0] = l
    return out
