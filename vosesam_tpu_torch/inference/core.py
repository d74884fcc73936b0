"""Per-video inference core: the XMem frame step (port of
`vosesam_tpu/inference/core.py`).

Reference: tracker/inference/inference_core.py:43-150. `TrackerState`
threads the memory and the schedule counters through
  - `step(net, state, frame, cfg)`                       — propagation frames
  - `step_with_mask(net, state, frame, mask, mask_valid, cfg)` — frame 0 and
    interactive corrections (GT-mask injection, inference_core.py:99-113).

Scheduling (inference_core.py:55-61): is_mem_frame = (ti - last_mem_ti >=
mem_every) or mask given. The schedule is known on the host, so the JAX
package's `lax.cond` branches are Python `if`s here.

Sync mode (deep_update_every = -1, the shipped config): memory frames
deep-update the hidden state through the value encoder's reinforcer, other
frames take the decoder GRU's hidden state.

Async mode (deep_update_every >= 0): the decoder GRU updates the hidden
state on every segmented frame, memory frames included (before
encode_value sees it); the reinforcer replaces it only on memory frames
where ti - last_deep_update_ti >= deep_update_every (the counter starts at
-deep_update_every, so frame 0 qualifies).

The state is updated in place and returned.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from vosesam_tpu_torch.config import FrameworkConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from vosesam_tpu_torch.memory import manager
from vosesam_tpu_torch.memory.rings import MemoryState, init_memory
from vosesam_tpu_torch.models.xmem import network as xnet
from vosesam_tpu_torch.ops.aggregate import soft_aggregate
from vosesam_tpu_torch.ops.image import im_normalize, pad_divide_by, unpad


@dataclasses.dataclass
class TrackerState:
    memory: MemoryState
    curr_ti: int               # -1 before the first frame
    last_mem_ti: int
    last_deep_update_ti: int


def init_tracker_state(cfg: FrameworkConfig, frame_hw: Tuple[int, int],
                       device: DeviceLike = None) -> TrackerState:
    """Allocate all per-video state for an (H, W) frame size on `device`
    (default: the card)."""
    h, w = frame_hw
    ph = -(-h // 16) * 16
    pw = -(-w // 16) * 16
    mem = init_memory(cfg.memory, cfg.xmem, (ph // 16, pw // 16),
                      dtype=torch_dtype(cfg.dtype), device=resolve_device(device))
    due = cfg.memory.deep_update_every
    return TrackerState(memory=mem, curr_ti=-1, last_mem_ti=0,
                        last_deep_update_ti=-due if due >= 0 else 0)


def _prepare(frame: torch.Tensor, cfg: FrameworkConfig):
    frame_n = im_normalize(frame).to(torch_dtype(cfg.dtype))
    frame_p, pad = pad_divide_by(frame_n, 16)
    hw = (frame_p.shape[0] // 16) * (frame_p.shape[1] // 16)
    return frame_p, pad, hw


def _encode_and_read(net, cfg, state, frame_p):
    key, shrinkage, selection, feats = xnet.encode_key(net, frame_p)
    readout, _ = manager.match_memory(state.memory, key, selection, cfg.memory,
                                      cfg.parallel)
    return key, shrinkage, selection, feats, readout


def _maybe_memorize(
    net, cfg, state: TrackerState, frame_p, feats, key, shrinkage, selection,
    prob_no_bg, hidden_normal, is_mem_frame: bool, deep_due: bool, obj_valid, hw,
) -> TrackerState:
    """Memory frame: encode_value + add_memory (+ the reinforced hidden when
    a deep update is due). Other frames: the decoder's hidden, if given."""
    if not is_mem_frame:
        if hidden_normal is not None:
            state.memory.hidden = hidden_normal
        return state
    deep = cfg.memory.deep_update_every < 0 or deep_due
    value, hidden_deep = xnet.encode_value(
        net, frame_p, feats.f16, state.memory.hidden, prob_no_bg, obj_valid,
        cfg.xmem, is_deep_update=deep)
    if deep:
        state.memory.hidden = hidden_deep
        state.last_deep_update_ti = state.curr_ti
    state.memory = manager.add_memory(state.memory, key, shrinkage, selection,
                                      value, obj_valid, cfg.memory, hw)
    state.last_mem_ti = state.curr_ti
    return state


@torch.no_grad()
def step(
    net: xnet.XMem,
    state: TrackerState,
    frame: torch.Tensor,              # (H, W, 3) uint8 or float RGB
    cfg: FrameworkConfig,
) -> Tuple[TrackerState, torch.Tensor, torch.Tensor]:
    """Propagate one frame. Returns (state, prob_with_bg (1+O, H, W),
    logits_with_bg (1+O, H, W))."""
    state.curr_ti += 1
    frame_p, pad, hw = _prepare(frame, cfg)
    obj_valid = state.memory.obj_valid

    key, shrinkage, selection, feats, readout = _encode_and_read(
        net, cfg, state, frame_p)
    hidden_dec, logits_with_bg, prob_with_bg = xnet.segment(
        net, feats, readout.to(frame_p.dtype), state.memory.hidden, obj_valid,
        cfg.xmem, h_out=True)

    is_mem_frame = state.curr_ti - state.last_mem_ti >= cfg.memory.mem_every
    if cfg.memory.deep_update_every < 0:       # sync mode
        hidden_normal, deep_due = hidden_dec, True
    else:                                      # async: decoder GRU every frame
        if hidden_dec is not None:
            state.memory.hidden = hidden_dec
        hidden_normal = None
        deep_due = (state.curr_ti - state.last_deep_update_ti
                    >= cfg.memory.deep_update_every)
    state = _maybe_memorize(net, cfg, state, frame_p, feats, key, shrinkage,
                            selection, prob_with_bg[1:], hidden_normal,
                            is_mem_frame, deep_due, obj_valid, hw)
    return (state, unpad(prob_with_bg, pad, axes=(-2, -1)),
            unpad(logits_with_bg, pad, axes=(-2, -1)))


@torch.no_grad()
def step_with_mask(
    net: xnet.XMem,
    state: TrackerState,
    frame: torch.Tensor,              # (H, W, 3)
    mask: torch.Tensor,               # (O, H, W) binary per-object ground truth
    mask_valid: torch.Tensor,         # (O,) bool — which objects the mask labels
    cfg: FrameworkConfig,
) -> Tuple[TrackerState, torch.Tensor, torch.Tensor]:
    """GT-mask injection step (frame 0 or an interactive correction).

    Predicted probabilities are zeroed wherever the mask claims any object;
    labelled objects take the mask; unlabelled tracked objects keep their
    prediction. Always a memory frame."""
    state.curr_ti += 1
    frame_p, pad, hw = _prepare(frame, cfg)
    mask_p, _ = pad_divide_by(mask, 16, axes=(-2, -1))
    obj_valid = state.memory.obj_valid
    obj_valid_new = obj_valid | mask_valid

    key, shrinkage, selection, feats, readout = _encode_and_read(
        net, cfg, state, frame_p)

    if state.curr_ti == 0:
        # nothing is tracked yet: the JAX step decodes and then zeroes this
        pred_no_bg = torch.zeros(mask_p.shape, dtype=torch.float32, device=mask_p.device)
    else:
        _, _, prob_pred = xnet.segment(
            net, feats, readout.to(frame_p.dtype), state.memory.hidden,
            obj_valid, cfg.xmem, h_out=False)
        pred_no_bg = prob_pred[1:]

    mask_regions = mask_p.sum(dim=0) > 0.5
    zero = torch.zeros((), device=pred_no_bg.device)
    pred_no_bg = torch.where(mask_regions[None], zero, pred_no_bg)
    merged = torch.where(mask_valid[:, None, None], mask_p.to(pred_no_bg.dtype), pred_no_bg)
    prob_with_bg, logits_with_bg = soft_aggregate(merged, obj_valid_new, dim=0,
                                                  return_logits=True)

    # fresh hidden state for newly introduced objects (create_hidden_state)
    newly = mask_valid & ~obj_valid
    state.memory.hidden = torch.where(newly[:, None, None, None],
                                      torch.zeros((), dtype=state.memory.hidden.dtype,
                                                  device=zero.device),
                                      state.memory.hidden)

    if cfg.memory.deep_update_every < 0:
        deep_due = True
    else:
        deep_due = state.curr_ti - state.last_deep_update_ti >= cfg.memory.deep_update_every
    state = _maybe_memorize(net, cfg, state, frame_p, feats, key, shrinkage,
                            selection, prob_with_bg[1:], None, True, deep_due,
                            obj_valid_new, hw)
    return (state, unpad(prob_with_bg, pad, axes=(-2, -1)),
            unpad(logits_with_bg, pad, axes=(-2, -1)))
