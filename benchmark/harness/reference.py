"""The plain reference put beside the program: `plainref` (a frozen copy of
the port's plain model code, `benchmark/reference/`) in float32 with TF32
off, on the benchmark's own weights, or the control (`precision="fp8"`).

Tracking is followed stage by stage (`harness/tracking.py` says why): each
method below takes the program's own inputs of one stage, and the raw
frame where the stage reads the image.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import configs, precision


def _fp32_sd(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: (v.float() if v.is_floating_point() else v) for k, v in sd.items()}


class Reference:
    def __init__(self, cfg: Dict, weights: Dict, device: torch.device,
                 precision_name: str = "fp32") -> None:
        from plainref import config as RC
        from plainref.models.sam.predictor import Sam
        from plainref.models.xmem.network import XMem

        self.cfg = configs.framework(cfg, RC, dtype="float32")
        self.device = device
        self.precision = precision_name
        with torch.device("meta"):
            net = XMem(self.cfg.xmem)
        net.load_state_dict(_fp32_sd(weights["xmem"]), strict=True, assign=True)
        self.net = net.eval()
        self.sam = None
        if weights.get("sam") is not None:
            with torch.device("meta"):
                sam = Sam(self.cfg.sam)
            sam.load_state_dict(_fp32_sd(weights["sam"]), strict=True, assign=True)
            self.sam = sam.eval()

    # ---------------------------------------------------------------- helpers

    def _cfg_o(self, o: int):
        return dataclasses.replace(self.cfg, xmem=dataclasses.replace(self.cfg.xmem, max_objects=o))

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.no_grad()
    def encode(self, frames: torch.Tensor):
        """ImageEmbedding of (F, H, W, 3) frames, encoded one at a time."""
        from plainref.models.sam import predictor

        with precision.mode(self.precision):
            embs = [predictor.encode_image(self.sam, frames[i:i + 1], self.cfg.sam)
                    for i in range(frames.shape[0])]
        interm = None if embs[0].interm is None else torch.cat([e.interm for e in embs])
        return predictor.ImageEmbedding(torch.cat([e.embedding for e in embs]), interm,
                                        embs[0].input_hw, embs[0].orig_hw)

    def memory_from(self, m):
        """The reference's MemoryState holding a program MemoryState in float32."""
        from plainref.memory import rings

        def copy(v):      # always a copy: the reference updates its state in place
            if not isinstance(v, torch.Tensor):
                return v
            return v.to(torch.float32, copy=True) if v.is_floating_point() else v.clone()

        def conv(src, cls):
            return cls(**{f.name: copy(getattr(src, f.name)) for f in dataclasses.fields(cls)})

        return rings.MemoryState(work=conv(m.work, rings.WorkMemory),
                                 long=conv(m.long, rings.LongTermMemory),
                                 hidden=copy(m.hidden), obj_valid=copy(m.obj_valid))

    # ------------------------------------------------------------ XMem stages

    @torch.no_grad()
    def key_stage(self, frame: np.ndarray):
        """(key, shrinkage, selection, features) of a raw (H, W, 3) frame."""
        from plainref.inference import core
        from plainref.models.xmem import network as xnet

        with precision.mode(self.precision):
            fp, _, _ = core._prepare(self._up(frame), self.cfg)
            return xnet.encode_key(self.net, fp)

    @torch.no_grad()
    def read_stage(self, memory, qk, qe, n_obj: int):
        """The readout of the program's memory state for its query key."""
        from plainref.memory import manager

        cfg = self._cfg_o(n_obj)
        with precision.mode(self.precision):
            return manager.match_memory(self.memory_from(memory), qk.float(),
                                        None if qe is None else qe.float(), cfg.memory)[0]

    @torch.no_grad()
    def segment_stage(self, feats, readout, hidden, valid, h_out: bool, n_obj: int):
        """The decoder on the program's features, readout and hidden state:
        (hidden, logits, prob, the low-resolution mask logits)."""
        from plainref.models.xmem import network as xnet

        f = xnet.MultiScaleFeatures(*(t.float() for t in feats))
        seen: Dict[str, List] = {}
        with precision.mode(self.precision), self._outputs(seen):
            out = xnet.segment(self.net, f, readout.float(),
                               None if hidden is None else hidden.float(), valid,
                               self._cfg_o(n_obj).xmem, h_out=h_out)
        return tuple(out) + (seen["pred"][-1]["out"],)

    @torch.no_grad()
    def value_stage(self, frame: np.ndarray, f16, hidden, masks, valid, deep: bool, n_obj: int):
        """The value encoder on the raw frame and the program's features,
        hidden state and masks: (value, hidden, the fusion block's mask
        features in, its output)."""
        from plainref.inference import core
        from plainref.models.xmem import network as xnet

        seen: Dict[str, List] = {}
        with precision.mode(self.precision), self._outputs(seen):
            fp, _, _ = core._prepare(self._up(frame), self.cfg)
            out = xnet.encode_value(self.net, fp, f16.float(),
                                    None if hidden is None else hidden.float(),
                                    masks.float(), valid, self._cfg_o(n_obj).xmem,
                                    is_deep_update=deep)
        fu = seen["value_fuser"][-1]
        return tuple(out) + (fu["in"][1], fu["out"])

    def _outputs(self, seen):
        from harness import capture

        return capture.module_outputs(capture.xmem_modules(self.net), seen)

    @torch.no_grad()
    def write_stage(self, memory, key, shrinkage, selection, value, valid, hw: int):
        """One memory write (and its consolidation when due) applied to the
        program's memory state before it, with the program's inputs."""
        from plainref.memory import manager

        with precision.mode(self.precision):
            return manager.add_memory(self.memory_from(memory), key.float(), shrinkage.float(),
                                      selection.float(), value.float(), valid,
                                      self.cfg.memory, hw)

    @torch.no_grad()
    def compose(self, emb, masks, scores, valid, low_res, iou, has_prompt):
        """The refinement's answer from the program's own parts: its XMem
        masks and scores, its SAM decodes (the kept token upsampled, the
        score gate) and the prompt packs' liveness, composited
        lowest-score-first. Returns (F, H, W) labels."""
        import math

        from plainref.models.sam import predictor

        scfg, rcfg = self.cfg.sam, self.cfg.refinement
        f, o, h, w = masks.shape
        tok = predictor.select_token(iou, scfg, scfg.multimask_output)
        idx = torch.arange(tok.shape[0], device=tok.device)
        best = low_res[idx, tok].float()
        full = predictor.postprocess_masks(best, emb.input_hw, emb.orig_hw)
        sam_masks = (full > scfg.mask_threshold).reshape(f, o, h, w)
        sam_scores = iou[idx, tok].float().reshape(f, o)
        keep = has_prompt.reshape(f, o)
        if rcfg.optimized:
            keep = keep & (sam_scores >= rcfg.score_gate)
        final = torch.where(keep[..., None, None], sam_masks, masks > 0.5) & valid[..., None, None]
        neg_inf = torch.full((), -math.inf, device=masks.device)
        sc = torch.where(valid, torch.where(keep, sam_scores, scores.float()), neg_inf)
        claim = torch.where(final, sc[..., None, None], neg_inf)
        return torch.where(final.any(1), torch.argmax(claim, dim=1) + 1, 0)

    @torch.no_grad()
    def sam_stage(self, emb, masks, logits, valid) -> Dict[str, torch.Tensor]:
        """The refinement's SAM decode on given inputs (the program's): the
        prompt pack and, per (frame, object) pack, the kept token's low-res
        logits and predicted IoU, before the score gate."""
        from plainref.models.sam import predictor
        from plainref.ops import prompts as prompt_ops
        from plainref.ops.image import resize_bilinear, resize_mask_prompt

        cfg = self.cfg
        rcfg, scfg = cfg.refinement, cfg.sam
        f, o, h, w = masks.shape
        with precision.mode(self.precision):
            pack = prompt_ops.build_prompt_pack(rcfg.mode, masks.float(), valid, rcfg)
            mask_prompts = None
            if pack.use_mask:
                prompt_hw = (emb.embedding.shape[1] * 4, emb.embedding.shape[2] * 4)
                lg = logits.float().reshape(f * o, h, w)
                if scfg.encode_fixed_hw is not None:
                    mask_prompts = resize_bilinear(lg, prompt_hw, axes=(-2, -1))
                else:
                    mask_prompts = resize_mask_prompt(lg, prompt_hw)
            frame_of = torch.arange(f, device=masks.device).repeat_interleave(o)
            coords = pack.coords.reshape(f * o, -1, 2)
            labels = pack.labels.reshape(f * o, -1)
            low_res, iou = predictor.predict_low_res(self.sam, emb, coords, labels,
                                                     mask_prompts, scfg, frame_of=frame_of)
            tok = predictor.select_token(iou, scfg, scfg.multimask_output)
        return {"coords": coords, "labels": labels, "tok": tok, "low_res": low_res,
                "iou": iou, "live": (pack.has_prompt & valid).reshape(-1),
                "has_prompt": pack.has_prompt}

    # ---------------------------------------------------------------- clicks

    @torch.no_grad()
    def click(self, emb, image: np.ndarray, points: np.ndarray, labels: np.ndarray):
        """`first_frame_click` with multimask on: the history plus one pad
        point, a second 'both'-mode pass when a negative click precedes a
        final positive one. Returns (mask (H, W) bool, low-res logits)."""
        from plainref.models.sam import predictor

        scfg = self.cfg.sam
        with precision.mode(self.precision):
            pts = np.concatenate([np.asarray(points, np.float32).reshape(-1, 2),
                                  np.zeros((1, 2), np.float32)], 0)
            lbl = np.concatenate([np.asarray(labels).astype(np.int64), [-1]], 0)
            two_pass = bool(len(labels) > 1 and labels[-1] == 1 and (np.asarray(labels) == 0).any())
            c, l = self._up(pts), self._up(lbl)
            pred = predictor.predict(self.sam, emb, c, l, None, scfg)
            mask, _, _, low_res = predictor.select_best(pred, scfg, True)
            if two_pass:
                pred = predictor.predict(self.sam, emb, c, l, low_res, scfg)
                mask, _, _, low_res = predictor.select_best(pred, scfg, True)
        return mask, low_res
