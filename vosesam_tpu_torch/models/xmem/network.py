"""XMem top-level network (port of `vosesam_tpu/models/xmem/network.py`).

Reference: tracker/model/network.py (+ modules.py). `XMem` holds the
parameters under the official XMem-s012 state-dict names, so an official
checkpoint loads with `load_state_dict(strict=True)`
(`utils/checkpoint.py`). The public functions keep the JAX package's
signatures and channel-last layouts:
  - image features (H, W, C), group features (O, H, W, C), one video, a
    static padded object axis with an (O,) validity mask;
  - `encode_value` zeroes padded objects' values;
  - `segment` returns the aggregated distribution including background.
Internally the convolutions run NCHW (the channel-last tensors are permuted
views, so no copy is made when the memory format is channels_last).
`encode_key` replays one CUDA graph of the key encoder per frame signature
on the card until the parameters fail `layers.stamp_holds` (`KEY_GRAPH_COUNTS`
counts replays, captures and eager calls).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.nn.modules.module import _global_forward_hooks, _global_forward_pre_hooks

from vosesam_tpu_torch.config import XMemConfig
from vosesam_tpu_torch.models.layers import (Conv2d, init_like_jax, interpolate_bilinear,
                                             param_stamp, stamp_holds)
from vosesam_tpu_torch.models.resnet import ResNetTrunk
from vosesam_tpu_torch.models.xmem import modules as M
from vosesam_tpu_torch.ops.aggregate import soft_aggregate


class MultiScaleFeatures(NamedTuple):
    f16: torch.Tensor  # (H/16, W/16, 1024)
    f8: torch.Tensor   # (H/8,  W/8,  512)
    f4: torch.Tensor   # (H/4,  W/4,  256)


def _chw(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., C, H, W) view."""
    return x.movedim(-1, -3)


def _hwc(x: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) -> (..., H, W, C) view."""
    return x.movedim(-3, -1)


class KeyEncoder(ResNetTrunk):
    def __init__(self) -> None:
        super().__init__("resnet50", stage_names=("res2", "layer2", "layer3"))


class ValueEncoder(ResNetTrunk):
    def __init__(self, cfg: XMemConfig) -> None:
        super().__init__("resnet18", extra_dim=1 if cfg.single_object else 2)
        self.fuser = M.FeatureFusionBlock(1024, 256, cfg.value_dim, cfg.value_dim)
        self.hidden_reinforce = (M.HiddenReinforcer(cfg.value_dim, cfg.hidden_dim)
                                 if cfg.use_hidden else None)


class Decoder(nn.Module):
    def __init__(self, cfg: XMemConfig) -> None:
        super().__init__()
        self.fuser = M.FeatureFusionBlock(1024, cfg.value_dim + cfg.hidden_dim, 512, 512)
        self.hidden_update = (M.HiddenUpdater((512, 256, 256 + 1), 256, cfg.hidden_dim)
                              if cfg.use_hidden else None)
        self.up_16_8 = M.UpsampleBlock(512, 512, 256)
        self.up_8_4 = M.UpsampleBlock(256, 256, 256)
        self.pred = Conv2d(256, 1, 3, padding=1)


class XMem(nn.Module):
    """The XMem parameters (no forward: the tracker calls the functions
    below)."""

    def __init__(self, cfg: XMemConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.key_encoder = KeyEncoder()
        self.key_proj = M.KeyProjection(1024, cfg.key_dim)
        self.value_encoder = ValueEncoder(cfg)
        self.decoder = Decoder(cfg)


def xmem_init(cfg: XMemConfig, seed: int = 0,
              device: Optional[torch.device] = None) -> XMem:
    """XMem with random parameters drawn from a numpy generator with the JAX
    package's `xmem_init` scheme (`models/layers.py:init_like_jax`)."""
    net = XMem(cfg)
    init_like_jax(net, np.random.default_rng(seed))
    return net.to(device) if device is not None else net


# ------------------------------------------------------------------- encoders

def encode_key(net: XMem, frame: torch.Tensor):
    """(H, W, 3) normalized frame -> (key (H/16, W/16, Ck), shrinkage
    (H/16, W/16, 1), selection (H/16, W/16, Ck), MultiScaleFeatures) —
    network.py:40-70.

    On a CUDA device with grad disabled, outside another capture, the trunk
    and the projection replay a CUDA graph captured for the frame's
    signature (`_key_graphs`); elsewhere they run eagerly. Both run the
    same kernels in the same order and return tensors of their own. A
    forward hook on the trunk's modules keeps it eager (a replay would not
    call it)."""
    out = _replay_key(net, frame) if _graphable(frame) else None
    if out is None:
        KEY_GRAPH_COUNTS["eager"] += 1
        out = _key_trunk(net, _chw(frame)[None])
    key, shrinkage, selection, f16, f8, f4 = out
    return (_hwc(key[0]), _hwc(shrinkage[0]), _hwc(selection[0]),
            MultiScaleFeatures(_hwc(f16[0]), _hwc(f8[0]), _hwc(f4[0])))


def _key_trunk(net: XMem, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(1, 3, H, W) -> NCHW (key, shrinkage, selection, f16, f8, f4)."""
    f4, f8, f16 = net.key_encoder.features(x)
    key, shrinkage, selection = net.key_proj(f16)
    return key, shrinkage, selection, f16, f8, f4


def compute_others(masks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-object sum of all other valid objects' masks (network.py:74-84)."""
    v = valid.to(masks.dtype)[:, None, None]
    total = torch.sum(masks * v, dim=0, keepdim=True)
    return (total - masks * v) * v


def encode_value(
    net: XMem,
    frame: torch.Tensor,              # (H, W, 3) normalized
    f16: torch.Tensor,                # (H/16, W/16, 1024)
    hidden: Optional[torch.Tensor],   # (O, H/16, W/16, Ch) or None
    masks: torch.Tensor,              # (O, H, W) fg probability
    valid: torch.Tensor,              # (O,) bool
    cfg: XMemConfig,
    is_deep_update: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ((O, H/16, W/16, Cv) value, updated hidden)."""
    ve = net.value_encoder
    masks = masks.to(frame.dtype)
    if cfg.single_object:
        g = masks[:, None]
    else:
        g = torch.stack([masks, compute_others(masks, valid)], dim=1)  # (O, 2, H, W)
    g = M.distribute(_chw(frame), g)                                  # (O, 3+extra, H, W)
    _, _, g16 = ve.features(g)
    g16 = ve.fuser(_chw(f16), g16)                                    # (O, Cv, h, w)
    if is_deep_update and cfg.use_hidden and hidden is not None:
        hidden = _hwc(ve.hidden_reinforce(g16, _chw(hidden)))
    # zero padded objects so arena writes stay clean
    g16 = g16 * valid.to(g16.dtype)[:, None, None, None]
    return _hwc(g16), hidden


# -------------------------------------------------------------------- decoder

def segment(
    net: XMem,
    feats: MultiScaleFeatures,
    memory_readout: torch.Tensor,     # (O, H/16, W/16, Cv)
    hidden: Optional[torch.Tensor],   # (O, H/16, W/16, Ch)
    valid: torch.Tensor,              # (O,) bool
    cfg: XMemConfig,
    h_out: bool = True,
):
    """Decoder + soft aggregation (network.py:107-120, modules.py:214-250).

    Returns (new_hidden or None, logits (1+O, H, W), prob (1+O, H, W)), the
    background first (the JAX function's `strip_bg=False`)."""
    dec = net.decoder
    f16, f8, f4 = _chw(feats.f16), _chw(feats.f8), _chw(feats.f4)
    g_in = _chw(memory_readout)
    if cfg.use_hidden and hidden is not None:
        g_in = torch.cat([g_in, _chw(hidden)], dim=1)
    g16 = dec.fuser(f16, g_in)
    g8 = dec.up_16_8(f8, g16)
    g4 = dec.up_8_4(f4, g8)
    logits_lr = dec.pred(torch.relu(g4))                    # (O, 1, H/4, W/4)

    new_hidden = None
    if h_out and cfg.use_hidden and hidden is not None:
        g4_cat = torch.cat([g4, logits_lr], dim=1)
        new_hidden = _hwc(dec.hidden_update(g16, g8, g4_cat, _chw(hidden)))

    logits = interpolate_bilinear(logits_lr, 4.0)[:, 0].float()
    prob = torch.sigmoid(logits)
    agg, agg_logits = soft_aggregate(prob, valid, dim=0, return_logits=True)
    return new_hidden, agg_logits, agg


# --------------------------------------------------------- key-encoder graphs

# Frame signatures whose key-encoder graph a net keeps; the least recently
# used goes first (the app and the server see any frame size).
KEY_GRAPH_LIMIT = 4
# Eager runs on a new signature before its capture: they build the derived
# parameters (`layers._derived`) and settle cuDNN's plans and workspace.
KEY_GRAPH_WARMUP = 3
# Calls of `encode_key` that replayed a graph, that captured one (and
# replayed it), and that ran eagerly.
KEY_GRAPH_COUNTS: Dict[str, int] = {"replay": 0, "capture": 0, "eager": 0}


def reset_key_graph_counts() -> None:
    for name in KEY_GRAPH_COUNTS:
        KEY_GRAPH_COUNTS[name] = 0


class _KeyGraphs(collections.OrderedDict):
    """Signature -> (graph, static input, static outputs as `_key_trunk`'s),
    all captured from the parameters and buffers that `stamp` recorded. A
    net that is copied or pickled starts with none. A graph's static
    tensors serve one call at a time, so calls on one net must not overlap
    (the server serves one request at a time)."""

    stamp = param_stamp(())

    def __reduce__(self):
        return type(self), ()

    def lookup(self, sig: Tuple, sources: List[torch.Tensor],
               capture: Callable[[], Tuple]) -> Tuple:
        """The graph for `sig`, captured by `capture()` unless one is kept.
        Every kept graph goes once `sources` fail the stamp."""
        if not stamp_holds(self.stamp, sources):
            self.clear()
            self.stamp = param_stamp(sources)
        entry = self.get(sig)
        if entry is not None:
            KEY_GRAPH_COUNTS["replay"] += 1
            self.move_to_end(sig)
            return entry
        KEY_GRAPH_COUNTS["capture"] += 1
        entry = self[sig] = capture()
        while len(self) > KEY_GRAPH_LIMIT:
            self.popitem(last=False)
        return entry


def _graphable(frame: torch.Tensor) -> bool:
    """Whether `encode_key` may replay a graph for `frame`: on a CUDA device,
    with grad disabled (the trainer), outside another capture."""
    return frame.is_cuda and not torch.is_grad_enabled() and \
        not torch.cuda.is_current_stream_capturing()


def _key_sources(net: XMem) -> Optional[List[torch.Tensor]]:
    """Every parameter and buffer that the key encoder's graph reads, or None
    where a forward hook is set on one of its modules or on every module (a
    replay would not call it)."""
    mods = [net.key_proj, net.key_encoder]
    for m in mods:          # grows while walked; cheaper than `Module.modules()`
        if m is not None:
            mods += m._modules.values()
    mods = [m for m in mods if m is not None]
    if _global_forward_hooks or _global_forward_pre_hooks or any(
            m._forward_hooks or m._forward_pre_hooks for m in mods):
        return None
    out: List[Optional[torch.Tensor]] = []
    for m in mods:
        out += m._parameters.values()
        out += m._buffers.values()
    return [t for t in out if t is not None]


def _key_signature(frame: torch.Tensor) -> Tuple:
    """What a capture depends on besides the parameters: the frame's shape,
    dtype (which is the derived weights' dtype, `layers._cast_params`),
    strides and device, and the cuDNN flags that choose the convolutions
    (`allow_tf32` for an fp32 frame)."""
    c = torch.backends.cudnn
    return (frame.shape, frame.dtype, frame.stride(), frame.device,
            c.enabled, c.allow_tf32, c.deterministic, c.benchmark)


def _capture_key(net: XMem, frame: torch.Tensor) -> Tuple:
    """A graph of `_key_trunk` on a static copy of `frame`. It reads the
    weights `layers._derived` keeps while the graphs' stamp holds."""
    with torch.cuda.device(frame.device):
        with torch.inference_mode(False):     # a static input later calls can write
            static = torch.empty_strided(frame.shape, frame.stride(), dtype=frame.dtype,
                                         device=frame.device)
        static.copy_(frame)
        x = _chw(static)[None]
        # the warm-up runs on the caller's stream, so the derived parameters
        # it builds belong to the stream that reads them, as eager calls' do
        for _ in range(KEY_GRAPH_WARMUP):
            _key_trunk(net, x)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(),
                              capture_error_mode="thread_local"):
            out = _key_trunk(net, x)
    return graph, static, out


def _replay_key(net: XMem, frame: torch.Tensor) -> Optional[Tuple[torch.Tensor, ...]]:
    """`_key_trunk`'s outputs by the graph for `frame`, copied out so that no
    later call writes them (callers keep them past the next frame); None
    where a hook asks for the eager path."""
    sources = _key_sources(net)
    if sources is None:
        return None
    graphs = net.__dict__.get("_key_graphs")
    if graphs is None:
        graphs = net.__dict__["_key_graphs"] = _KeyGraphs()
    graph, static, out = graphs.lookup(_key_signature(frame), sources,
                                       lambda: _capture_key(net, frame))
    static.copy_(frame)
    graph.replay()
    return tuple(t.clone() for t in out)
