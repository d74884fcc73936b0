"""Sequence-data-parallel evaluation: independent videos spread over the
ranks of a mesh's data axis (port of `vosesam_tpu/parallel/evaluation.py`).

Each rank owns whole videos (per-video memory state has no cross-rank
traffic) and runs them one after another through the sequential
`Tracker`: `track` for the annotation frame and, per frame, for the rest,
or `track_batch` with `chunk > 1` (`inference/chunked.py:track_chunk` on
full chunks, the remainder per frame). The JAX class steps its lanes in
lockstep under one `shard_map`ped jit, padding the batch with copies of
video 0 and stepping finished lanes on their last frame; a rank here has
no batched step to fill, so it runs each video's true frames only, and the
outputs are the ones JAX keeps. At the end the ranks all-gather their
videos' results, so every rank returns the whole list in video order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from vosesam_tpu_torch.config import FrameworkConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device
from vosesam_tpu_torch.inference.tracker import Tracker
from vosesam_tpu_torch.models.sam.predictor import Sam
from vosesam_tpu_torch.models.xmem.network import XMem
from vosesam_tpu_torch.parallel import mesh as meshlib


def _label_scores(tracker: Tracker, mask: np.ndarray, scores: list) -> dict:
    """{original label: score} of the objects present in `mask` (original
    labels), from the slot-ordered `scores` the tracker returned for it."""
    present = set(np.unique(mask).tolist())
    labels = [orig for orig, _ in sorted(tracker.mapper.remappings.items(), key=lambda kv: kv[1])
              if orig in present]
    return dict(zip(labels, scores))


class BatchedGenerator:
    """Dataset-level multi-video generator over the mesh's data axis, with
    the JAX class's outputs:

      - per-video labels: each video's palette labels are remapped to
        contiguous slots by its own MaskMapper and written back on output;
      - frame 0 injects the template with no refinement; propagation frames
        refine per `cfg.refinement`;
      - `chunk > 1` runs propagation in chunks of `chunk` frames;
      - the videos are split into contiguous runs, one per data index, as
        JAX lays its lanes out.

    All videos of one run() must share (H, W): group by resolution upstream
    (eval/runner.py does). Without a mesh, one over the default process
    group (or this process alone) is made."""

    def __init__(self, net: XMem, sam: Optional[Sam], cfg: FrameworkConfig,
                 mesh: Optional[meshlib.Mesh] = None, chunk: int = 1,
                 device: DeviceLike = None) -> None:
        if cfg.refinement.use_refinement and sam is None:
            raise ValueError("refinement enabled but no SAM model given")
        self.tracker = Tracker(net, cfg, resolve_device(device), sam=sam, paint=False)
        self.mesh = mesh if mesh is not None else meshlib.make_mesh(cfg.parallel)
        self.chunk = max(1, int(chunk))

    def _video(self, frames: Sequence[np.ndarray], template: np.ndarray) -> dict:
        tr = self.tracker
        tr.clear_memory()
        m0, _, _, s0 = tr.track(frames[0], template)
        if self.chunk > 1:
            masks, scores = tr.track_batch(list(frames[1:]), chunk=self.chunk)
        else:
            masks, scores = [], []
            for f in frames[1:]:
                m, _, _, s = tr.track(f)
                masks.append(m)
                scores.append(s)
        masks, scores = [m0] + masks, [s0] + scores
        return {"masks": masks, "scores": scores,
                "label_scores": [_label_scores(tr, m, s) for m, s in zip(masks, scores)]}

    def run(self, videos: Sequence[Sequence[np.ndarray]], templates: Sequence[np.ndarray]):
        """videos: per-video lists of (H, W, 3) uint8 frames, one (H, W) for
        all; templates: per-video (H, W) indexed uint8 masks. Returns, on
        every rank, a list (one per video) of {"masks": [(H, W) uint8 per
        frame], "scores": [slot-ordered scores of the objects present],
        "label_scores": [{original label: score}]}."""
        assert len(videos) == len(templates) > 0
        hw = videos[0][0].shape[:2]
        for v in videos:
            if v[0].shape[:2] != hw:
                raise ValueError("all videos in one batched run must share (H, W); "
                                 "group by resolution first")
        dp, d = self.mesh.data_size, self.mesh.data_index
        per_rank = -(-len(videos) // dp)
        mine = range(d * per_rank, min(len(videos), (d + 1) * per_rank))
        local = {i: self._video(videos[i], templates[i]) for i in mine}
        merged = {}
        for part in meshlib.all_gather_data_object(local, self.mesh):
            merged.update(part)
        return [merged[i] for i in range(len(videos))]
