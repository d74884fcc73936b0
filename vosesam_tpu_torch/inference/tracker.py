"""Tracker: the per-frame XMem orchestrator (port of
`vosesam_tpu/inference/tracker.py`).

Reference: tracker/base_tracker.py BaseTracker (:30-212). The host-side
`Tracker` keeps the reference's session API:
  track(frame, first_frame_annotation=None) ->
      (mask (H, W) uint8, logits, painted_image, scores)   (:97-212)
  clear_memory()                                            (:1092-1096)

With `RefinementConfig(use_refinement=True)` every propagation frame is
refined by SAM after the XMem step (the annotation frame skips SAM, as the
reference does); `track_batch` runs the chunked path
(`inference/chunked.py`). The `live_objects` hint bookkeeping is
the JAX package's, because it decides which memory-read kernel runs: the
annotation frame reads with no hint (per-object kernel), propagation frames
with the seeded object count (shared-validity kernel), and every frame after
a mid-video object add goes back to the per-object kernel.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from vosesam_tpu_torch.config import FrameworkConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device
from vosesam_tpu_torch.inference import core
from vosesam_tpu_torch.inference.chunked import track_chunk
from vosesam_tpu_torch.inference.refinement import (
    masks_from_prob,
    refine_masks,
    xmem_object_scores,
)
from vosesam_tpu_torch.memory.rings import grow_objects
from vosesam_tpu_torch.models.sam import predictor
from vosesam_tpu_torch.models.xmem.network import XMem
from vosesam_tpu_torch.utils import profiling
from vosesam_tpu_torch.utils.mask_mapper import MaskMapper
from vosesam_tpu_torch.viz.painter import paint_indexed


def track_frame(
    net: XMem,
    sam: Optional[predictor.Sam],
    state: core.TrackerState,
    frame: torch.Tensor,              # (H, W, 3) uint8 RGB
    cfg: FrameworkConfig,
    paint: bool = True,
):
    """One propagation frame: the XMem step, then (with refinement on) one
    SAM encode and `refine_masks`. Returns (state, indexed_mask (H, W)
    int32, logits (1+O, H, W), scores (O,), painted (H, W, 3) uint8 or,
    with `paint=False`, the frame itself, used_sam (O,) bool or None
    without refinement)."""
    o = cfg.xmem.max_objects
    state, prob, logits = core.step(net, state, frame, cfg)
    with profiling.span("track.masks"):
        masks, indexed = masks_from_prob(prob, o)
        scores = xmem_object_scores(prob[1:])
    if cfg.refinement.use_refinement:
        if sam is None:
            raise ValueError("refinement enabled but no SAM model given")
        emb = predictor.encode_image(sam, frame[None], cfg.sam)
        res = refine_masks(sam, emb, masks[None], logits[None, 1:], scores[None],
                           state.memory.obj_valid[None], cfg)
        indexed, scores, used_sam = res.indexed[0], res.scores[0], res.used_sam[0]
    else:
        used_sam = None
    with profiling.span("track.remap"):
        painted = paint_indexed(frame, indexed, o) if paint else frame
    return state, indexed, logits, scores, painted, used_sam


def track_first_frame(
    net: XMem,
    state: core.TrackerState,
    frame: torch.Tensor,
    mask: torch.Tensor,               # (O, H, W) one-hot
    mask_valid: torch.Tensor,         # (O,) bool
    cfg: FrameworkConfig,
    paint: bool = True,
):
    """Annotation frame: GT injection, no refinement (the reference skips SAM
    on the first frame, base_tracker.py:121-131)."""
    o = cfg.xmem.max_objects
    state, prob, logits = core.step_with_mask(net, state, frame, mask, mask_valid, cfg)
    with profiling.span("track.masks"):
        _, indexed = masks_from_prob(prob, o)
        scores = xmem_object_scores(prob[1:])
    with profiling.span("track.remap"):
        painted = paint_indexed(frame, indexed, o) if paint else frame
    return state, indexed, logits, scores, painted


class Tracker:
    """Host-side session wrapper (BaseTracker-compatible surface)."""

    def __init__(
        self,
        net: XMem,
        cfg: FrameworkConfig,
        device: DeviceLike = None,
        sam: Optional[predictor.Sam] = None,
        paint: bool = True,
        save_inner_masks_folder: Optional[str] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.net = net
        self.sam = sam
        self.cfg = cfg
        # paint=False: `track` computes no paint and returns the frame
        # itself in the painted slot (callers that only want masks)
        self.paint = paint
        self.mapper = MaskMapper()
        self.state: Optional[core.TrackerState] = None
        self._frame_hw: Optional[Tuple[int, int]] = None
        # Per-video object-axis capacity: state is allocated at the seeded
        # object count and grown on a mid-video annotation.
        self._o_cap: Optional[int] = None
        # live_objects hint: valid while every object was registered before
        # any propagation frame; a mid-video annotation drops it.
        self._frames_tracked = 0
        self._mid_video_add = False
        self._cfg_cache: dict = {}
        # per object, the refined frames on which SAM's mask was kept: a
        # device count, read by callers that want the gate's keep rate
        self.sam_kept: Optional[torch.Tensor] = None
        # base_tracker.py:80-89's debug dumps: per propagated frame, the raw
        # XMem mask and the refined mask as palette PNGs under
        # <folder>/inner/{xmem_masks,refinement_masks}/<n>.png
        self._inner_dir: Optional[str] = save_inner_masks_folder
        self._inner_ti = 0
        if self._inner_dir:
            for sub in ("xmem_masks", "refinement_masks"):
                os.makedirs(os.path.join(self._inner_dir, "inner", sub), exist_ok=True)

    def clear_memory(self) -> None:
        """base_tracker.py:1092-1096."""
        self.state = None
        self._frame_hw = None
        self._o_cap = None
        self.mapper.clear()
        self._frames_tracked = 0
        self._mid_video_add = False
        self.sam_kept = None

    def _count_kept(self, used_sam: Optional[torch.Tensor]) -> None:
        """Add (..., O) keep decisions to `sam_kept` on the device."""
        if used_sam is None:
            return
        kept = used_sam.reshape(-1, used_sam.shape[-1]).sum(0, dtype=torch.int32)
        if self.sam_kept is not None:
            kept[:self.sam_kept.shape[0]] += self.sam_kept
        self.sam_kept = kept

    def _session_cfg(self, live_hint: Optional[int]) -> FrameworkConfig:
        """cfg specialized to this video: object axis = current capacity,
        MemoryConfig.live_objects = the shared-validity hint (or None)."""
        o = self._o_cap if self._o_cap is not None else self.cfg.xmem.max_objects
        key = (o, live_hint)
        if key not in self._cfg_cache:
            cfg = self.cfg
            if o != cfg.xmem.max_objects:
                cfg = dataclasses.replace(
                    cfg, xmem=dataclasses.replace(cfg.xmem, max_objects=o))
            if live_hint != cfg.memory.live_objects:
                cfg = dataclasses.replace(
                    cfg, memory=dataclasses.replace(cfg.memory, live_objects=live_hint))
            self._cfg_cache[key] = cfg
        return self._cfg_cache[key]

    def _track_cfg(self) -> FrameworkConfig:
        n = self.mapper.num_objects
        hint = None if (self._mid_video_add or n == 0) else n
        return self._session_cfg(hint)

    def _ensure_state(self, frame: np.ndarray, n_objects: Optional[int] = None) -> None:
        hw = frame.shape[:2]
        if self.state is None or self._frame_hw != hw:
            self._o_cap = (n_objects if n_objects is not None
                           else self.cfg.xmem.max_objects)
            self.state = core.init_tracker_state(self._session_cfg(None), hw, self.device)
            self._frame_hw = hw
        elif n_objects is not None and n_objects > (self._o_cap or 0):
            self.state.memory = grow_objects(self.state.memory, n_objects)
            self._o_cap = n_objects

    def track(
        self,
        frame: np.ndarray,                                    # (H, W, 3) uint8 RGB
        first_frame_annotation: Optional[np.ndarray] = None,  # (H, W) indexed
    ):
        """base_tracker.py:97-212. Returns (final_mask (H, W) uint8 with the
        original palette labels, logits, painted_image, scores list)."""
        with profiling.span("track.loop"):
            with profiling.span("track.upload"):
                ft = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
            if first_frame_annotation is not None:
                if self._frames_tracked > 0:
                    self._mid_video_add = True
                with profiling.span("track.remap"):
                    onehot, new_labels = self.mapper.convert_mask(first_frame_annotation)
                n = self.mapper.num_objects
                budget = self.cfg.xmem.max_objects
                if n > budget:
                    raise ValueError(
                        f"{n} objects exceed the static budget max_objects={budget}")
                self._ensure_state(frame, n_objects=n)
                o = self._o_cap
                with profiling.span("track.upload"):
                    mask = np.zeros((o,) + frame.shape[:2], np.float32)
                    valid = np.zeros((o,), bool)
                    for i, lbl in enumerate(new_labels):
                        mask[lbl - 1] = onehot[i]
                        valid[lbl - 1] = True
                    mask_t = torch.from_numpy(mask).to(self.device)
                    valid_t = torch.from_numpy(valid).to(self.device)
                self.state, indexed, logits, scores, painted = track_first_frame(
                    self.net, self.state, ft, mask_t, valid_t, self._session_cfg(None),
                    self.paint)
            else:
                self._ensure_state(frame)
                self.state, indexed, logits, scores, painted, used_sam = track_frame(
                    self.net, self.sam, self.state, ft, self._track_cfg(), self.paint)
                with profiling.span("track.masks"):
                    self._count_kept(used_sam)
            self._frames_tracked += 1

            with profiling.span("track.download"):
                indexed_np = indexed.cpu().numpy()
                logits_np = logits.cpu().numpy()
                painted_np = painted.cpu().numpy() if self.paint else frame
                scores_np = scores.cpu().numpy()
            with profiling.span("track.remap"):
                if self._inner_dir and first_frame_annotation is None:
                    self._dump_inner(logits_np, indexed_np)
                final = self.mapper.remap_index_mask(indexed_np).astype(np.uint8)
                live = self._live_scores(scores_np, indexed_np)
            return final, logits_np, painted_np, live

    def _dump_inner(self, logits: np.ndarray, refined: np.ndarray) -> None:
        """The XMem mask (re-derived from the logits, which refinement does
        not change) and the refined mask of one frame, numbered from 1."""
        from vosesam_tpu_torch.eval.palette import save_palette_mask

        self._inner_ti += 1
        base = os.path.join(self._inner_dir, "inner")
        name = f"{self._inner_ti:05d}.png"
        save_palette_mask(np.argmax(logits, axis=0).astype(np.uint8),
                          os.path.join(base, "xmem_masks", name))
        save_palette_mask(refined.astype(np.uint8), os.path.join(base, "refinement_masks", name))

    def _live_scores(self, scores_np: np.ndarray,
                     indexed_np: Optional[np.ndarray] = None) -> list:
        """Scores of the objects present in this frame's mask
        (base_tracker.py:163-165), ordered by remapped slot."""
        live_slots = sorted(self.mapper.remappings.values())
        if not live_slots:
            return scores_np.tolist()
        if indexed_np is not None:
            present = set(np.unique(indexed_np).tolist())
            live_slots = [s for s in live_slots if s in present]
        return [float(scores_np[s - 1]) for s in live_slots]

    def track_batch(self, frames, chunk: int = 4, paint: bool = False):
        """Throughput path (`inference/chunked.py:track_chunk`): full chunks
        of `chunk` frames run K XMem steps and one batched SAM encode and
        refinement; the remainder runs per frame, so padded duplicates
        never touch the memory. Must be seeded first with
        track(frame, annotation). Returns (masks, scores), or with `paint`
        (masks, painted, scores), painted as per-frame tracking paints."""
        if self.state is None:
            raise RuntimeError("track_batch needs a seeded tracker: call "
                               "track(frame, first_frame_annotation) first")
        with profiling.span("track.loop"):
            masks_out, painted_out, scores_out = [], [], []
            n_full = (len(frames) // chunk) * chunk
            for i0 in range(0, n_full, chunk):
                cfg = self._track_cfg()
                o = cfg.xmem.max_objects
                with profiling.span("track.upload"):
                    fb = torch.from_numpy(np.ascontiguousarray(np.stack(frames[i0:i0 + chunk]))
                                          ).to(self.device)
                self.state, indexed, scores, used_sam = track_chunk(
                    self.net, self.sam, self.state, fb, cfg)
                with profiling.span("track.masks"):
                    self._count_kept(used_sam)
                self._frames_tracked += chunk
                if paint:
                    with profiling.span("track.remap"):
                        painted = [paint_indexed(fb[j], indexed[j], o) for j in range(chunk)]
                with profiling.span("track.download"):
                    idx_np = indexed.cpu().numpy()
                    sc_np = scores.cpu().numpy()
                    if paint:
                        painted_out += [p.cpu().numpy() for p in painted]
                with profiling.span("track.remap"):
                    for j in range(chunk):
                        masks_out.append(self.mapper.remap_index_mask(idx_np[j]).astype(np.uint8))
                        scores_out.append(self._live_scores(sc_np[j], idx_np[j]))
            for f in frames[n_full:]:
                m, _lg, p, s = self.track(f)
                masks_out.append(m)
                scores_out.append(s)
                if paint:
                    painted_out.append(p)
            if paint:
                return masks_out, painted_out, scores_out
            return masks_out, scores_out
