"""OVIS (occluded video instance segmentation) evaluation (port of
`vosesam_tpu/eval/ovis.py`).

Reference: videoPipeline.ipynb cells 2-3 + `run_model_on_ovis_set` (cell 13)
— a COCO-VIS-style annotations JSON holds `videos` (file_names, width,
height) and `annotations` (per-video per-frame RLE segmentations); the first
annotated frame seeds the tracker, the generator propagates, and J&F/AP are
computed against the decoded RLE ground truth. RLE decoding is eval/rle.py
(pure Python); frames are read by `datasets.load_images` (JPEG through the
native loader, PNG on the standard library).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from vosesam_tpu_torch.eval.datasets import load_images
from vosesam_tpu_torch.eval.palette import save_palette_mask
from vosesam_tpu_torch.eval.rle import decode_rle
from vosesam_tpu_torch.eval.runner import (
    _aggregate,
    _append_global_ledger,
    _eval_one_video,
    _result_dir,
    _rows,
    _write_video_csvs,
)


class OvisDataset:
    """Loader for an OVIS-style annotations JSON + image tree."""

    def __init__(self, images_root: str, annotations_json: str) -> None:
        self.images_root = images_root
        with open(annotations_json) as f:
            data = json.load(f)
        self.videos: List[Dict] = data["videos"]
        self.annotations: List[Dict] = data.get("annotations", [])
        self.categories = data.get("categories", [])

    def video_annotations(self, video: Dict) -> List[Dict]:
        return [a for a in self.annotations if a["video_id"] == video["id"]]

    def load_frames(self, video: Dict) -> List[np.ndarray]:
        return load_images([os.path.join(self.images_root, f) for f in video["file_names"]])

    @staticmethod
    def ann_to_mask(ann: Dict, frame_idx: int) -> Optional[np.ndarray]:
        """videoPipeline annToMask: decode one object's RLE at one frame
        (None when the object is absent)."""
        segs = ann.get("segmentations") or []
        if frame_idx >= len(segs) or segs[frame_idx] is None:
            return None
        return decode_rle(segs[frame_idx])

    def indexed_gt(self, video: Dict, frame_idx: int) -> Optional[np.ndarray]:
        """All objects' RLEs at a frame -> indexed mask (object i -> label
        i+1, annotation order; matches the notebook's `(annToMask(a, 0) *
        (i + 1))` + unifyMasks composite where later objects overwrite)."""
        anns = self.video_annotations(video)
        if not anns:
            return None
        out = np.zeros((video["height"], video["width"]), np.uint8)
        any_mask = False
        for i, a in enumerate(anns):
            m = self.ann_to_mask(a, frame_idx)
            if m is not None:
                out[m > 0] = i + 1
                any_mask = True
        return out if any_mask else None


def run_model_on_ovis_set(
    runname: str,
    model,
    dataset: OvisDataset,
    compute_metrics: bool = True,
    save_masks: bool = False,
    max_videos: Optional[int] = None,
    chunk: Optional[int] = None,
) -> List[Dict]:
    """videoPipeline.ipynb run_model_on_ovis_set equivalent.
    `chunk`: route propagation through generator_chunked (see
    eval/runner._eval_one_video)."""
    run_dir = _result_dir(runname)
    per_video: List[Dict] = []
    for vi, video in enumerate(dataset.videos):
        if max_videos is not None and vi >= max_videos:
            break
        name = video["file_names"][0].split("/")[0]
        frames = dataset.load_frames(video)
        template = dataset.indexed_gt(video, 0)
        if template is None:
            continue
        gts = ([dataset.indexed_gt(video, i) for i in range(len(frames))]
               if compute_metrics else [template] + [None] * (len(frames) - 1))
        vm = _eval_one_video(model, frames, template, gts, chunk=chunk)
        vm["video"] = name
        per_video.append(vm)
        if save_masks:
            mask_dir = os.path.join(run_dir, "masks", name)
            os.makedirs(mask_dir, exist_ok=True)
            for fname, m in zip(video["file_names"], vm["masks"]):
                out = os.path.join(mask_dir, os.path.splitext(os.path.basename(fname))[0] + ".png")
                save_palette_mask(m, out)

    _write_video_csvs(run_dir, per_video)
    _append_global_ledger(_aggregate(runname, "OVIS", per_video))
    return _rows(per_video)
