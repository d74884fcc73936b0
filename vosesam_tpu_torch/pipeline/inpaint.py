"""The video inpainting pipeline (port of `vosesam_tpu/pipeline/inpaint.py`, the
BaseInpainter equivalent).

Reference: inpainter/base_inpainter.py —
  - `inpaint` (:176-247): split the video into `num_subset_frames`=50 chunks
    with `num_external_ref`=2 temporal-context frames at stride `step`=10
    prepended/appended; remainder folded into the first split;
  - `inpaint_efficient` (:53-174): dilate masks (radius 15), optional
    downscale, per-window loop with stride `neighbor_stride`=5 plus strided
    reference frames (`get_ref_index` :37-51), pad H to mod-60 / W to mod-108
    by flip-reflection, composite predictions into the masked region and
    50/50-average overlapping windows.

The subset's video is uploaded once; mask dilation, the optional downscale,
normalisation and the flip-pad run on the device, and each window is
gathered there. With `InpainterConfig.device_composite` (the default) the
composite buffer and the overlap blend stay on the device too (the buffer
is updated in place) and one uint8 array comes back per subset; without it
every window's prediction is downloaded and composited on the host, the
reference-shaped path kept as the equality baseline. The generator runs in
fp32 at the process's precision settings: PyTorch's default runs fp32
convolutions in TF32 on the card (`torch.backends.cudnn.allow_tf32`), as it
does for the reference implementation; pixels outside the dilated mask are
the input's in either setting.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vosesam_tpu_torch.config import InpainterConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device
from vosesam_tpu_torch.models.e2fgvi import generator as G
from vosesam_tpu_torch.ops import morphology as morph
from vosesam_tpu_torch.ops.image import resize_bilinear, resize_nearest

MOD_H, MOD_W = 60, 108     # the generator's sizes are multiples of these


def get_ref_index(f: int, neighbor_ids: List[int], length: int,
                  num_ref: int, ref_length: int) -> List[int]:
    """Strided reference-frame selection (base_inpainter.py:37-51)."""
    ref_index = []
    if num_ref == -1:
        for i in range(0, length, ref_length):
            if i not in neighbor_ids:
                ref_index.append(i)
    else:
        start = max(0, f - ref_length * (num_ref // 2))
        end = min(length, f + ref_length * (num_ref // 2))
        for i in range(start, end + 1, ref_length):
            if i not in neighbor_ids:
                ref_index.append(i)
                if len(ref_index) >= num_ref:
                    break
    return ref_index


def static_window_plan(f: int, t: int, stride: int, step: int, r_static: int):
    """Fixed-shape window plan for anchor `f` (InpainterConfig.static_windows).

    Returns (ids, num_local, n_valid, write_ids) with len(ids) == num_local
    + r_static and num_local == min(t, 2*stride+1), both constant across all
    anchors of a t-frame subset, so every window of the video has one shape:
      - neighbors: the 2*stride+1 window clamped inside [0, t): edge windows
        slide inward and gain real context frames instead of shrinking
        (interior anchors get exactly the reference's neighbors);
      - refs: the reference's rule (stride-`step` frames outside the
        neighbor set, base_inpainter.py:37-51), padded to `r_static` slots
        with dummy frames that the generator masks out of every attention
        softmax (frame_valid), so a padded window's predictions are those of
        the unpadded computation;
      - write_ids: the reference's neighbor set (base_inpainter.py:123-128):
        compositing and blending stay exactly reference-shaped.
    """
    n_nb = min(t, 2 * stride + 1)
    start = min(max(0, f - stride), t - n_nb)
    neighbor_ids = list(range(start, start + n_nb))
    write_ids = list(range(max(0, f - stride), min(t, f + stride + 1)))
    refs = [i for i in range(0, t, step) if i not in neighbor_ids]
    n_valid = n_nb + len(refs)
    ids = neighbor_ids + refs + [0] * (r_static - len(refs))
    return ids, n_nb, n_valid, write_ids


def static_ref_budget(t: int, stride: int, step: int) -> int:
    """max_f len(refs) for the static plan: the padded ref-slot count."""
    n_nb = min(t, 2 * stride + 1)
    best = 0
    for f in range(0, t, stride):
        start = min(max(0, f - stride), t - n_nb)
        nb = range(start, start + n_nb)
        best = max(best, len([i for i in range(0, t, step) if i not in nb]))
    return best


def _flip_pad(x: torch.Tensor, mod_h: int = MOD_H, mod_w: int = MOD_W) -> torch.Tensor:
    """Pad H / W of (T, H, W, ...) to the generator's sizes by flip
    reflection (base_inpainter.py:149-158)."""
    h = x.shape[1]
    ph = -h % mod_h
    if ph:
        x = torch.cat([x, x[:, h - ph:].flip(1)], dim=1)
    w = x.shape[2]
    pw = -w % mod_w
    if pw:
        x = torch.cat([x, x[:, :, w - pw:].flip(2)], dim=2)
    return x


class Inpainter:
    """Holds the generator and the windowing policy. Runs on the
    card unless `device="cpu"`."""

    def __init__(
        self,
        checkpoint: Optional[str] = None,
        cfg: InpainterConfig = InpainterConfig(),
        net: Optional[G.InpaintGenerator] = None,
        mesh=None,
        device: DeviceLike = None,
        seed: int = 0,
    ) -> None:
        """Weights: `net` when given, else the official checkpoint when the
        path names an existing file, else seeded random weights (every rank
        of a mesh builds the same ones). `mesh`: a `parallel.mesh.Mesh`; the
        static windows then run data-parallel over its data axis, one group
        of data size x `window_batch` windows at a time, each rank its share
        one window at a time (`parallel/inpaint_shard.py`); grouping, tail
        padding and compositing are otherwise unchanged."""
        if mesh is not None:
            from vosesam_tpu_torch.parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"Inpainter(mesh=...) takes a parallel.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
        self.mesh = mesh
        self.cfg = cfg
        self.device = resolve_device(device)
        if net is not None:
            self.net = net.to(self.device).eval()
        elif checkpoint and os.path.exists(checkpoint):
            from vosesam_tpu_torch.utils.checkpoint import load_e2fgvi_checkpoint

            self.net = G.InpaintGenerator(cfg)
            self.net.load_state_dict(load_e2fgvi_checkpoint(checkpoint), strict=True)
            self.net = self.net.to(self.device).eval()
        else:
            self.net = G.generator_init(cfg, seed=seed, device=self.device)

    # ------------------------------------------------------------- core

    @torch.no_grad()
    def _predict(self, padded: torch.Tensor, plans) -> List[torch.Tensor]:
        """The predictions of a group of window plans, one (T, H, W, 3)
        tensor each: frames `ids` of the padded device video are gathered and
        run through the generator; slots from `n_valid` on are padding. A
        group of several plans (static windows, one shape) is one batched
        generator call, or with a mesh one window at a time on each rank."""
        if self.mesh is not None and plans[0][2] is not None:
            from vosesam_tpu_torch.parallel.inpaint_shard import sharded_predictions

            return sharded_predictions(lambda p: self._predict_local(padded, [p])[0], plans,
                                       self.mesh, self.cfg.window_batch)
        return self._predict_local(padded, plans)

    def _predict_local(self, padded: torch.Tensor, plans) -> List[torch.Tensor]:
        dev = padded.device
        idx = torch.as_tensor([list(p[0]) for p in plans], device=dev)        # (B, T)
        valid = None
        if plans[0][2] is not None:
            n_valid = torch.as_tensor([p[2] for p in plans], device=dev)
            valid = torch.arange(idx.shape[1], device=dev)[None] < n_valid[:, None]
        windows = padded.index_select(0, idx.flatten()).reshape(*idx.shape, *padded.shape[1:])
        return list(G.generator_forward(self.net, windows, plans[0][1], self.cfg,
                                        frame_valid=valid)[0])

    @torch.no_grad()
    def _preprocess(self, frames, masks, ratio: float, radius: int):
        """Upload, mask dilation, optional downscale, normalisation and
        flip-pad, all on the device. Returns ([0, 255] frames (T, H, W, 3),
        float masks (T, H, W), the padded [-1, 1] masked video, H, W)."""
        h, w = frames[0].shape[:2]
        frames_u8 = torch.from_numpy(np.stack([np.asarray(f) for f in frames])).to(self.device)
        masks_b = torch.from_numpy(np.stack([np.asarray(m) > 0 for m in masks])).to(self.device)
        if radius > 0:
            # the reference dilates once with a (2r+1) kernel; r rounds of
            # 3x3 are the same set
            masks_b = morph.dilate(masks_b, radius)
        masks_f = masks_b.float()
        if ratio != 1.0:
            nh = max(50, int(h * ratio)) // 2 * 2
            nw = max(50, int(w * ratio)) // 2 * 2
            frames_f = resize_bilinear(frames_u8.float(), (nh, nw))
            masks_f = resize_nearest(masks_f, (nh, nw), axes=(-2, -1))
            h, w = nh, nw
        else:
            frames_f = frames_u8.float()
        masked = (frames_f / 127.5 - 1.0) * (1.0 - masks_f[..., None])
        return frames_f, masks_f, _flip_pad(masked), h, w

    def _windows(self, t: int):
        """The subset's window plans in anchor order, each (ids, num_local,
        n_valid or None, write_ids), in the groups that run together: static
        plans (one shape for the whole subset) when the config asks for them
        and the clip is long enough, `window_batch` of them per group (with a
        mesh, data size x `window_batch`); else the reference's variable
        windows, one per group."""
        cfg = self.cfg
        use_static = (cfg.static_windows and cfg.num_ref == -1
                      and t > 2 * cfg.neighbor_stride + 1)
        anchors = list(range(0, t, cfg.neighbor_stride))
        if use_static:
            r_static = static_ref_budget(t, cfg.neighbor_stride, cfg.step)
            plans = [static_window_plan(f, t, cfg.neighbor_stride, cfg.step, r_static)
                     for f in anchors]
            wb = max(1, cfg.window_batch)
            if self.mesh is not None:
                from vosesam_tpu_torch.parallel.inpaint_shard import group_size

                wb = group_size(self.mesh, cfg.window_batch)
            return [plans[i:i + wb] for i in range(0, len(plans), wb)]
        groups = []
        for f in anchors:
            write_ids = list(range(max(0, f - cfg.neighbor_stride),
                                   min(t, f + cfg.neighbor_stride + 1)))
            ref_ids = get_ref_index(f, write_ids, t, cfg.num_ref, cfg.step)
            groups.append([(write_ids + ref_ids, len(write_ids), None, write_ids)])
        return groups

    def inpaint_efficient(
        self, frames: Sequence[np.ndarray], masks: Sequence[np.ndarray],
        ratio: float = 1.0, dilate_radius: Optional[int] = None,
    ) -> List[np.ndarray]:
        """base_inpainter.py:53-174 for one subset. With
        `InpainterConfig.window_batch` > 1, that many static windows go
        through one batched generator call (a short tail group runs at its
        own size); windows are independent until compositing, which keeps
        the anchors' order."""
        cfg = self.cfg
        radius = cfg.dilate_radius if dilate_radius is None else dilate_radius
        t = len(frames)
        frames_f, masks_f, padded, h, w = self._preprocess(frames, masks, ratio, radius)
        groups = self._windows(t)
        if cfg.device_composite:
            return self._composite_device(groups, frames_f, masks_f, padded, t, h, w)
        return self._composite_host(groups, frames_f, masks_f, padded, t, h, w)

    # ---------------------------------------------- device composite path

    @torch.no_grad()
    def _composite_device(self, groups, frames_f, masks_f, padded, t, h, w) -> List[np.ndarray]:
        """The reference's masked composite and 50/50 overlap blend
        (base_inpainter.py:129-146, the host path's order and arithmetic)
        against a device-resident buffer, updated in place; one uint8
        download per subset."""
        comp = torch.zeros((t, h, w, 3), dtype=torch.float32, device=self.device)
        seen = torch.zeros((t,), dtype=torch.bool, device=self.device)
        for plans in groups:
            for (ids, _, _, write_ids), pred in zip(plans, self._predict(padded, plans)):
                w0, n = write_ids[0], len(write_ids)
                seg = pred[w0 - ids[0]: w0 - ids[0] + n, :h, :w]
                seg = (seg + 1.0) / 2.0 * 255.0
                m = masks_f[w0:w0 + n, ..., None]
                compseg = seg * m + frames_f[w0:w0 + n] * (1.0 - m)
                old = comp[w0:w0 + n]
                comp[w0:w0 + n] = torch.where(seen[w0:w0 + n, None, None, None],
                                              0.5 * old + 0.5 * compseg, compseg)
                seen[w0:w0 + n] = True
        out = comp.clamp(0, 255).to(torch.uint8).cpu().numpy()
        return [out[i] for i in range(t)]

    # ------------------------------------------------- host composite path

    @torch.no_grad()
    def _composite_host(self, groups, frames_f, masks_f, padded, t, h, w) -> List[np.ndarray]:
        """base_inpainter.py:123-146 with host compositing: every window's
        prediction is downloaded and blended in numpy."""
        frames_np = frames_f.cpu().numpy()
        masks_np = masks_f.cpu().numpy()
        comp_frames: List[Optional[np.ndarray]] = [None] * t
        for plans in groups:
            for (ids, _, _, write_ids), pred in zip(plans, self._predict(padded, plans)):
                pred = (pred[:, :h, :w].cpu().numpy() + 1.0) / 2.0 * 255.0
                for idx in write_ids:
                    m = masks_np[idx][..., None]
                    comp = pred[idx - ids[0]] * m + frames_np[idx] * (1.0 - m)
                    if comp_frames[idx] is None:
                        comp_frames[idx] = comp
                    else:
                        comp_frames[idx] = 0.5 * comp_frames[idx] + 0.5 * comp
        return [np.clip(c, 0, 255).astype(np.uint8) for c in comp_frames]

    def inpaint(
        self, frames: Sequence[np.ndarray], masks: Sequence[np.ndarray],
        ratio: float = 1.0, dilate_radius: Optional[int] = None,
    ) -> List[np.ndarray]:
        """base_inpainter.py:176-247: subset splitting with temporal context."""
        cfg = self.cfg
        t = len(frames)
        n = cfg.num_subset_frames
        if t <= n:
            return self.inpaint_efficient(frames, masks, ratio, dilate_radius)

        out: List[np.ndarray] = []
        for a, b, pre_ids, post_ids in subset_splits(t, cfg):
            ids = pre_ids + list(range(a, b)) + post_ids
            comp = self.inpaint_efficient([frames[i] for i in ids], [masks[i] for i in ids],
                                          ratio, dilate_radius)
            out.extend(comp[len(pre_ids): len(pre_ids) + (b - a)])
        return out


def subset_splits(t: int, cfg: InpainterConfig) -> List[Tuple[int, int, List[int], List[int]]]:
    """The (start, end, context before, context after) of each subset of a
    t-frame video (base_inpainter.py:200-235): the remainder folds into the
    first split ("if OOM, let it happen at the beginning")."""
    n = cfg.num_subset_frames
    first_len = n + (t % n)
    bounds = [(0, first_len)]
    s = first_len
    while s < t:
        bounds.append((s, min(s + n, t)))
        s += n
    splits = []
    for a, b in bounds:
        pre_ids = [max(0, a - cfg.step * (i + 1))
                   for i in range(cfg.num_external_ref)][::-1] if a > 0 else []
        post_ids = [min(t - 1, b - 1 + cfg.step * (i + 1))
                    for i in range(cfg.num_external_ref)] if b < t else []
        splits.append((a, b, pre_ids, post_ids))
    return splits
