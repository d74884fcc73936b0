"""E2FGVI-HQ inpainting generator (port of
`vosesam_tpu/models/e2fgvi/generator.py`).

Reference: inpainter/model/e2fgvi_hq.py — grouped-conv Encoder (:71-110 with
the group fusion trick), InpaintGenerator (:134-263: SPyNet flows at 1/4 res,
BasicVSR++-style bidirectional propagation with second-order deformable
alignment, SoftSplit/SoftComp token fold/unfold, 8 temporal-focal transformer
blocks — hidden 512, heads 4, window (5, 9), focal level 2 — and a deconv
decoder with tanh output). The HQ variant's arbitrary-resolution
SoftSplit/SoftComp (output size passed at call time) is used.

`InpaintGenerator` holds the weights under the official checkpoint's names
(`encoder.layers.N`, `feat_prop_module.deform_align.backward_`,
`transformer.N.attn.qkv`, `update_spynet.basic_module...`), so an official
state dict loads with `strict=True`; the functions mirror the JAX package's
and take and return its channel-last activations. Two roundings follow the
published code rather than the JAX package: the focal blocks' LayerNorm eps
is nn.LayerNorm's 1e-5 (`LN_EPS`; the JAX package's `layer_norm` takes
1e-6), and the flows go back from SPyNet's multiple of 32 by plain bilinear
interpolation (F.interpolate, as flow_comp.py's SPyNet; jax.image.resize antialiases
that downscale).

The temporal focal window attention (tfocal_transformer_hq.py:173-428) is
one fused softmax over [window | rolled | pooled] keys per window and stays
plain PyTorch, as it stays an XLA path in the JAX package: its windows are
T x 5 x 9 tokens. The deformable alignment of the propagation runs through
the hand-written sampling kernel (`modules.modulated_deform_conv`), whose
gradient is the kernel's backward on the card. `generator_forward(remat=True)`
is the GAN trainer's (`training/inpaint_trainer.py`). `generator_forward`
marks its stages with profiler spans (`utils/profiling.span`):
`e2fgvi.flow`, `e2fgvi.encode`, `e2fgvi.propagate`, `e2fgvi.transformer`
(soft split, the focal blocks, soft composite) and `e2fgvi.decode`.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vosesam_tpu_torch.config import InpainterConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device
from vosesam_tpu_torch.models.e2fgvi import modules as M
from vosesam_tpu_torch.models.layers import Conv2d, Linear, layer_norm, linear
from vosesam_tpu_torch.ops.image import device_const, resize_bilinear, \
    resize_bilinear_align_corners
from vosesam_tpu_torch.utils import profiling

WINDOW = (5, 9)
EXPAND = (2, 4)           # window // 2
KERNEL = (7, 7)
STRIDE = (3, 3)
PADDING = (3, 3)
HIDDEN = 512
CHANNEL = 128             # encoder output channels (channel // 2 in the reference)
HEADS = 4
FOCAL_LEVEL = 2           # the window's keys plus one pooled level
LN_EPS = 1e-5             # nn.LayerNorm's default, which e2fgvi_hq.py's blocks use

ENC_SPEC = [
    # (cin, cout, stride, groups)
    (3, 64, 2, 1), (64, 64, 1, 1), (64, 128, 2, 1), (128, 256, 1, 1),
    (256, 384, 1, 1), (640, 512, 1, 2), (768, 384, 1, 4), (640, 256, 1, 8),
    (512, 128, 1, 1),
]


# ------------------------------------------------------------------- encoder

class Encoder(nn.Module):
    """`layers.{0,2,...,16}`: convolutions at the even indices, the
    reference's LeakyReLUs at the odd ones."""

    def __init__(self) -> None:
        super().__init__()
        layers: List[nn.Module] = []
        for cin, cout, stride, groups in ENC_SPEC:
            layers += [Conv2d(cin, cout, 3, stride=stride, padding=1, groups=groups),
                       nn.LeakyReLU(0.2)]
        self.layers = nn.ModuleList(layers)


def encoder_forward(p: Encoder, x: torch.Tensor) -> torch.Tensor:
    """(BT, H, W, 3) -> (BT, H/4, W/4, 128) with the group-fusion trick
    (e2fgvi_hq.py:96-110: from layer 5 on, the stride-4 feature x0 is
    re-interleaved group-wise with the running activation)."""
    bt = x.shape[0]
    out = x
    x0 = None
    for i, (_cin, _cout, _stride, g) in enumerate(ENC_SPEC):
        if i == 4:
            x0 = out
        if i > 4:
            h, w = x0.shape[1], x0.shape[2]
            out = torch.cat([x0.reshape(bt, h, w, g, -1), out.reshape(bt, h, w, g, -1)],
                            dim=-1).reshape(bt, h, w, -1)
        out = M.leaky_relu(M.conv_nhwc(out, p.layers[2 * i]), 0.2)
    return out


class _Deconv(nn.Module):
    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=1)


class Decoder(nn.ModuleDict):
    """`0.conv`, `2`, `4.conv`, `6`: the parametrised entries of the
    reference's Sequential."""

    def __init__(self) -> None:
        super().__init__({"0": _Deconv(CHANNEL, 128), "2": Conv2d(128, 64, 3, padding=1),
                          "4": _Deconv(64, 64), "6": Conv2d(64, 3, 3, padding=1)})


def _deconv(x: torch.Tensor, p: _Deconv) -> torch.Tensor:
    # x2 bilinear upsample with align_corners=True (e2fgvi_hq.py:127-130)
    x = resize_bilinear_align_corners(x, (x.shape[1] * 2, x.shape[2] * 2))
    return M.conv_nhwc(x, p.conv)


def decoder_forward(p: Decoder, x: torch.Tensor) -> torch.Tensor:
    x = M.leaky_relu(_deconv(x, p["0"]), 0.2)
    x = M.leaky_relu(M.conv_nhwc(x, p["2"]), 0.2)
    x = M.leaky_relu(_deconv(x, p["4"]), 0.2)
    return M.conv_nhwc(x, p["6"])


# ------------------------------------------------- bidirectional propagation

DIRECTIONS = ("backward_", "forward_")


class BidirectionalPropagation(nn.Module):
    """feat_prop.py:60-149: `deform_align.<dir>`, `backbone.<dir>.{0,2}`,
    `fusion`."""

    def __init__(self, channel: int = CHANNEL) -> None:
        super().__init__()
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, name in enumerate(DIRECTIONS):
            self.deform_align[name] = M.SecondOrderDeformableAlignment(channel)
            self.backbone[name] = nn.Sequential(
                Conv2d((2 + i) * channel, channel, 3, padding=1), nn.LeakyReLU(0.1),
                Conv2d(channel, channel, 3, padding=1))
        self.fusion = Conv2d(2 * channel, channel, 1)


def bidirectional_propagation(
    p: BidirectionalPropagation,
    x: torch.Tensor,                # (T, H, W, C) local features, or (B, T, H, W, C)
    flows_backward: torch.Tensor,   # (T-1, H, W, 2), or (B, T-1, H, W, 2)
    flows_forward: torch.Tensor,    # the same
) -> torch.Tensor:
    """feat_prop.py:60-149: two deformable alignments per frame after the
    first, in each direction. One window as `pipeline/inpaint.py` runs it, or a
    batch of independent windows, each step of the chain over all of them."""
    batched = x.ndim == 5
    if not batched:
        x, flows_backward, flows_forward = x[None], flows_backward[None], flows_forward[None]
    b, t, h, w, c = x.shape
    spatial = [x[:, i] for i in range(t)]
    feats = {}
    for mi, name in enumerate(DIRECTIONS):
        out: List[torch.Tensor] = []
        frame_idx = list(range(t))
        flow_idx = list(range(-1, t - 1))
        if name == "backward_":
            frame_idx = frame_idx[::-1]
            flows = flows_backward
        else:
            flows = flows_forward
        feat_prop = x.new_zeros((b, h, w, c))
        for i, idx in enumerate(frame_idx):
            feat_current = spatial[idx]
            if i > 0:
                flow_n1 = flows[:, flow_idx[i]]
                cond_n1 = M.flow_warp(feat_prop, flow_n1)
                feat_n2 = torch.zeros_like(feat_prop)
                flow_n2 = torch.zeros_like(flow_n1)
                cond_n2 = torch.zeros_like(cond_n1)
                if i > 1:
                    feat_n2 = out[-2]
                    flow_n2 = flows[:, flow_idx[i - 1]]
                    flow_n2 = flow_n1 + M.flow_warp(flow_n2, flow_n1)
                    cond_n2 = M.flow_warp(feat_n2, flow_n2)
                cond = torch.cat([cond_n1, feat_current, cond_n2], dim=-1)
                packed = torch.cat([feat_prop, feat_n2], dim=-1)
                feat_prop = M.second_order_deform_align(
                    p.deform_align[name], packed, cond, flow_n1, flow_n2)
            cat = [feat_current]
            if mi == 1:            # the forward pass also sees the backward features
                cat.append(feats["backward_"][idx])
            cat.append(feat_prop)
            bb = p.backbone[name]
            y = M.leaky_relu(M.conv_nhwc(torch.cat(cat, dim=-1), bb[0]), 0.1)
            feat_prop = feat_prop + M.conv_nhwc(y, bb[2])
            out.append(feat_prop)
        if name == "backward_":
            out = out[::-1]
        feats[name] = out
    both = torch.cat([torch.stack(feats["backward_"], 1), torch.stack(feats["forward_"], 1)],
                     dim=-1)
    fused = M.conv_nhwc(both.flatten(0, 1), p.fusion).reshape(b, t, h, w, c) + x
    return fused if batched else fused[0]


# -------------------------------------------------- temporal focal attention

def _rolled_valid_indices() -> np.ndarray:
    """Static key selection of the 4 diagonally rolled windows
    (tfocal_transformer_hq.py:190-205)."""
    wh, ww = WINDOW
    eh, ew = EXPAND
    masks = []
    for corner in ("tl", "tr", "bl", "br"):
        m = np.ones((wh, ww), np.float32)
        if corner == "tl":
            m[:-eh, :-ew] = 0
        elif corner == "tr":
            m[:-eh, ew:] = 0
        elif corner == "bl":
            m[eh:, :-ew] = 0
        else:
            m[eh:, ew:] = 0
        masks.append(m)
    return np.nonzero(np.stack(masks, 0).reshape(-1))[0]


ROLLED_IDX = _rolled_valid_indices()


def _window_partition(x: torch.Tensor, win: Tuple[int, int]) -> torch.Tensor:
    """(T, H, W, C) -> (nW, T, wh*ww, C), or (B, T, H, W, C) -> (B*nW, T,
    wh*ww, C) batch-major; H, W must be multiples of win."""
    t, h, w, c = x.shape[-4:]
    wh, ww = win
    x = x.reshape(-1, t, h // wh, wh, w // ww, ww, c).permute(0, 2, 4, 1, 3, 5, 6)
    return x.reshape(-1, t, wh * ww, c)


def _window_reverse(x: torch.Tensor, win: Tuple[int, int], hw: Tuple[int, int],
                    batch: Optional[int] = None) -> torch.Tensor:
    """(nW, T, wh*ww, C) -> (T, H, W, C), or with `batch` (B*nW, ...) ->
    (B, T, H, W, C)."""
    h, w = hw
    wh, ww = win
    t = x.shape[1]
    x = x.reshape(-1, h // wh, w // ww, t, wh, ww, x.shape[-1])
    x = x.permute(0, 3, 1, 4, 2, 5, 6).reshape(-1, t, h, w, x.shape[-1])
    return x[0] if batch is None else x


class _FocalAttention(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.qkv = Linear(HIDDEN, 3 * HIDDEN)
        self.proj = Linear(HIDDEN, HIDDEN)


class FocalBlock(nn.Module):
    """TemporalFocalTransformerBlock: `norm1`, `attn.{qkv,proj}`,
    `pool_layers.0`, `norm2`, `mlp.{conv1.0,conv2.1}`."""

    def __init__(self) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(HIDDEN)
        self.attn = _FocalAttention()
        self.pool_layers = nn.ModuleList([Linear(WINDOW[0] * WINDOW[1], 1)])
        self.norm2 = nn.LayerNorm(HIDDEN)
        self.mlp = M.FusionFeedForward(HIDDEN)


def focal_attention(p: FocalBlock, x: torch.Tensor, pooled: torch.Tensor,
                    pooled_valid: torch.Tensor,
                    frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (T, H, W, C) padded to window multiples; pooled: (T, nWh, nWw, C);
    pooled_valid: (nWh, nWw) bool (False on padding). One fused softmax over
    [window | rolled | pooled-context] keys per window. With a leading batch
    axis on x and pooled (and on `frame_valid`), the windows of all batch
    entries go through the same products.

    `frame_valid` ((T,) bool, optional): frames marked False contribute no
    keys anywhere (additive -1e9 before the fp32 softmax: exactly zero
    weight), so a window padded with invalid frames gives the valid frames
    the outputs of the unpadded computation: the static-shape inpaint
    windows of `pipeline/inpaint.py`."""
    batched = x.ndim == 5
    if not batched:
        x, pooled = x[None], pooled[None]
        frame_valid = None if frame_valid is None else frame_valid[None]
    b, t, h, w, c = x.shape
    wh, ww = WINDOW
    hd = c // HEADS

    qkv = linear(x, p.attn.qkv).reshape(b, t, h, w, 3, c)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]

    def part(a):  # (B*nW, T, wa, heads, hd)
        win = _window_partition(a, WINDOW)
        return win.reshape(win.shape[0], t, wh * ww, HEADS, hd)

    def heads_of(a):  # (N, T, n, C) or (N, T, n, heads, hd) -> (N, heads, T*n, hd)
        nwl, tl, nl = a.shape[:3]
        return a.reshape(nwl, tl, nl, HEADS, hd).permute(0, 3, 1, 2, 4).reshape(
            nwl, HEADS, tl * nl, hd)

    qw, kw, vw = part(q), part(k), part(v)
    nw = qw.shape[0] // b
    wa = t * wh * ww
    qf = heads_of(qw)

    # rolled expansions (4 diagonal shifts, static valid-index selection)
    ridx = device_const(("e2fgvi_rolled_idx",), lambda: ROLLED_IDX, x.device)
    shifts = ((-EXPAND[0], -EXPAND[1]), (-EXPAND[0], EXPAND[1]),
              (EXPAND[0], -EXPAND[1]), (EXPAND[0], EXPAND[1]))
    k_rolled = torch.cat([part(torch.roll(k, s, dims=(2, 3))) for s in shifts], dim=2)
    v_rolled = torch.cat([part(torch.roll(v, s, dims=(2, 3))) for s in shifts], dim=2)
    k_rolled = k_rolled.index_select(2, ridx)
    v_rolled = v_rolled.index_select(2, ridx)
    n_roll = k_rolled.shape[2]

    # pooled focal context: per-window (5, 9) neighbourhood of the pooled map
    qkv_p = linear(pooled, p.attn.qkv).reshape(b, t, *pooled.shape[2:4], 3, c)
    half = (WINDOW[0] // 2, WINDOW[1] // 2)

    def unfold_ctx(a):  # (B, T, nWh, nWw, C) -> (B*nW, T, 45, C)
        u = M.unfold(a.flatten(0, 1), WINDOW, (1, 1), half)   # (B*T, nW, C*45), channel-major
        return u.reshape(b, t, -1, c, wh * ww).permute(0, 2, 1, 4, 3).reshape(
            b * nw, t, wh * ww, c)

    k_pool = unfold_ctx(qkv_p[..., 1, :])
    v_pool = unfold_ctx(qkv_p[..., 2, :])
    n_pool = k_pool.shape[2]
    vmask = M.unfold(pooled_valid[None, :, :, None].float(), WINDOW, (1, 1), half
                     ).reshape(-1, wh * ww)                          # (nW, 45)
    pool_bias = torch.where(vmask > 0, 0.0, -100.0)

    k_all = torch.cat([heads_of(kw), heads_of(k_rolled), heads_of(k_pool)], dim=2)
    v_all = torch.cat([heads_of(vw), heads_of(v_rolled), heads_of(v_pool)], dim=2)

    scale = 1.0 / math.sqrt(hd)
    attn = torch.matmul((qf * scale).float(), k_all.float().transpose(-1, -2))
    # additive -100 bias on invalid pooled keys (per frame, tiled)
    bias = torch.cat([attn.new_zeros((nw, wa + t * n_roll)), pool_bias.repeat(1, t)], dim=1)
    attn = attn + bias.repeat(b, 1)[:, None, None, :]
    if frame_valid is not None:
        fb = torch.where(frame_valid, 0.0, -1e9).to(torch.float32)       # (B, T)
        frame_bias = torch.cat([fb.repeat_interleave(wh * ww, dim=1),   # window keys, T-major
                                fb.repeat_interleave(n_roll, dim=1),    # rolled keys
                                fb.repeat_interleave(n_pool, dim=1)], dim=1)   # pooled keys
        attn = attn + frame_bias.repeat_interleave(nw, dim=0)[:, None, None, :]
    attn = torch.softmax(attn, dim=-1).to(v_all.dtype)
    out = torch.matmul(attn, v_all)
    out = out.permute(0, 2, 1, 3).reshape(b * nw, t, wh * ww, c)
    out = linear(_window_reverse(out, WINDOW, (h, w), batch=b), p.attn.proj)
    return out if batched else out[0]


def focal_block_forward(p: FocalBlock, x: torch.Tensor, output_size: Tuple[int, int],
                        frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TemporalFocalTransformerBlock (:430-530). x: (T, fh, fw, C), or
    (B, T, fh, fw, C) with `frame_valid` (B, T)."""
    batched = x.ndim == 5
    if not batched:
        x = x[None]
        frame_valid = None if frame_valid is None else frame_valid[None]
    b, t, fh, fw, c = x.shape
    wh, ww = WINDOW
    shortcut = x
    y = layer_norm(x, p.norm1, LN_EPS)

    # pad to window multiples
    ph = -fh % wh
    pw = -fw % ww
    yp = torch.nn.functional.pad(y, (0, 0, 0, pw, 0, ph))
    hh, wwid = fh + ph, fw + pw

    # fc-pooled focal map: one pooled token per window (pool_layers.0)
    nwh, nww = hh // wh, wwid // ww
    win = yp.reshape(b, t, nwh, wh, nww, ww, c).permute(0, 1, 2, 4, 6, 3, 5)
    win = win.reshape(b, t, nwh, nww, c, wh * ww)
    pooled = linear(win, p.pool_layers[0])[..., 0]
    # every window of the padded grid counts as a valid pool, as in the reference
    valid = torch.ones((nwh, nww), dtype=torch.bool, device=x.device)

    att = focal_attention(p, yp, pooled, valid, frame_valid)[:, :, :fh, :fw]
    x = shortcut + att

    y = layer_norm(x, p.norm2, LN_EPS)
    y = M.fusion_feed_forward(p.mlp, y.reshape(b, t * fh * fw, c), output_size, KERNEL, STRIDE,
                              PADDING).reshape(b, t, fh, fw, c)
    x = x + y
    return x if batched else x[0]


# ----------------------------------------------------------------- generator

def check_widths(cfg: InpainterConfig) -> None:
    """Raise unless `cfg` states the widths this generator builds (the
    checkpoint's: hidden 512, 4 heads, (5, 9) windows, focal level 2)."""
    built = {"hidden_dim": HIDDEN, "num_heads": HEADS, "window_size": WINDOW,
             "focal_level": FOCAL_LEVEL}
    stated = {"hidden_dim": cfg.hidden_dim, "num_heads": cfg.num_heads,
              "window_size": tuple(cfg.window_size), "focal_level": cfg.focal_level}
    wrong = {k: v for k, v in stated.items() if v != built[k]}
    if wrong:
        raise ValueError(f"InpainterConfig states {wrong}, but InpaintGenerator builds the "
                         f"E2FGVI-HQ checkpoint's widths {built}")


class InpaintGenerator(nn.Module):
    """The generator's weights under the official state-dict names. Refuses
    a config whose widths are not the ones it builds (`check_widths`)."""

    def __init__(self, cfg: InpainterConfig = InpainterConfig()) -> None:
        super().__init__()
        check_widths(cfg)
        self.encoder = Encoder()
        self.decoder = Decoder()
        self.feat_prop_module = BidirectionalPropagation(CHANNEL)
        self.ss = M.SoftSplit(CHANNEL, HIDDEN, KERNEL)
        self.sc = M.SoftComp(CHANNEL, HIDDEN, KERNEL, hq=cfg.hq)
        self.transformer = nn.ModuleList(FocalBlock() for _ in range(cfg.num_blocks))
        self.update_spynet = M.SPyNet()


@torch.no_grad()
def generator_init(cfg: InpainterConfig = InpainterConfig(), seed: int = 0,
                   device: DeviceLike = None) -> InpaintGenerator:
    """The generator with seeded random fp32 weights drawn on `device`
    (default: the card) with the JAX package's `generator_init` scheme:
    He-normal convolutions, uniform linear layers and biases, identity
    LayerNorms; the deformable convolutions' own bias zero and their last
    offset convolution zero (feat_prop.py:33), the pooling layers a mean
    over the window, the non-HQ SoftComp bias zero. The numbers differ from
    jax.random's, the distributions do not."""
    from vosesam_tpu_torch.models.sam.predictor import init_like_jax

    dev = resolve_device(device)
    with torch.device("meta"):
        net = InpaintGenerator(cfg)
    net = net.to_empty(device=dev)
    for t in net.parameters():
        t.fill_(float("nan"))           # anything the init misses shows up
    gen = torch.Generator(device=dev).manual_seed(seed)
    init_like_jax(net, gen)
    for align in net.feat_prop_module.deform_align.values():
        cout = align.weight.shape[0]
        align.weight.copy_(torch.randn(align.weight.shape, generator=gen, device=dev)
                           * math.sqrt(2.0 / (9 * cout)))
        align.bias.zero_()
        align.conv_offset[6].weight.zero_()
        align.conv_offset[6].bias.zero_()
    for blk in net.transformer:
        blk.pool_layers[0].weight.fill_(1.0 / (WINDOW[0] * WINDOW[1]))
        blk.pool_layers[0].bias.zero_()
    if not cfg.hq:
        net.sc.bias.zero_()
    return net.eval()


def _resize_quarter(x: torch.Tensor) -> torch.Tensor:
    # align_corners=True per forward_bidirect_flow (e2fgvi_hq.py:214-221)
    return resize_bilinear_align_corners(x, (x.shape[-3] // 4, x.shape[-2] // 4))


def quarter_flows(spynet: M.SPyNet, frames01: torch.Tensor, run=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, W, 3) frames in [0, 1] -> (forward, backward) flows of
    consecutive frames, (B, T-1, H/4, W/4, 2): a 1/4 align-corners resize,
    up to a multiple of 32 for SPyNet, the flows resized back and rescaled
    (flow_comp.py:137-170). `run(fn, *args)` calls each SPyNet pass (the
    generator's remat wrapper); the flow-completion loss calls it on the
    frozen SPyNet, so both sides resize alike."""
    b, t = frames01.shape[:2]
    small = _resize_quarter(frames01)
    sh, sw = small.shape[2:4]
    # spynet needs /32: resize up, then scale the flow back
    uh = -(-sh // 32) * 32
    uw = -(-sw // 32) * 32
    up = resize_bilinear(small, (uh, uw))
    first, second = up[:, :-1].flatten(0, 1), up[:, 1:].flatten(0, 1)
    run = run or (lambda fn, *args: fn(*args))
    f_fwd = run(M.spynet_flow, spynet, first, second)
    f_bwd = run(M.spynet_flow, spynet, second, first)

    def down_flow(f):
        # plain bilinear, no antialiasing, as the published SPyNet resizes back
        f = F.interpolate(f.permute(0, 3, 1, 2), size=(sh, sw), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
        f = f * torch.tensor([sw / uw, sh / uh], dtype=f.dtype, device=f.device)
        return f.reshape(b, t - 1, sh, sw, 2)

    return down_flow(f_fwd), down_flow(f_bwd)


def generator_forward(
    net: InpaintGenerator,
    masked_frames: torch.Tensor,     # (T, H, W, 3) in [-1, 1], or (B, T, H, W, 3)
    num_local: int,
    cfg: InpainterConfig,
    frame_valid: Optional[torch.Tensor] = None,    # (T,) or (B, T) bool; pads False
    remat: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """e2fgvi_hq.py:235-263. Returns ((T, H, W, 3) tanh output, (forward,
    backward) 1/4-res flows of the local frames).

    `frame_valid` marks padded non-local slots (static windows): they are
    excluded from every attention softmax, so the valid frames' outputs are
    those of the unpadded window. All local frames must be valid (they feed
    the flow and propagation path).

    With a leading batch axis, B independent windows of one shape go through
    every layer together (`InpainterConfig.window_batch`); outputs and flows
    carry the same axis.

    Differentiable: inference callers run it under `torch.no_grad()`. `remat`
    (training) wraps each stage (both SPyNet calls, the encoder, the
    propagation, every focal block, the decoder) in
    `torch.utils.checkpoint.checkpoint(use_reentrant=False)`, as the JAX
    package wraps each in `jax.checkpoint`: the backward recomputes a
    stage's activations instead of keeping them. Forward values are the
    same with and without it."""
    batched = masked_frames.ndim == 5
    if not batched:
        masked_frames = masked_frames[None]
        frame_valid = None if frame_valid is None else frame_valid[None]
    b, t, h, w, _ = masked_frames.shape
    lt = num_local
    if hasattr(net.sc, "bias"):
        # Non-HQ E2FGVI: SoftComp's learned additive bias is pinned to the
        # (60, 108) feature grid, so only the 240x432 training size is valid.
        bh, bw = net.sc.bias.shape[1:]
        if (h, w) != (bh * 4, bw * 4):
            raise ValueError(
                f"InpainterConfig(hq=False) only supports {bh * 4}x{bw * 4} inputs "
                f"(SoftComp's learned bias is pinned to the ({bh}, {bw}) feature grid); "
                f"got {h}x{w}. Use hq=True for arbitrary resolutions.")

    def ckpt(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    # bidirectional flows on the local window (frames mapped back to [0, 1])
    with profiling.span("e2fgvi.flow"):
        flows_forward, flows_backward = quarter_flows(
            net.update_spynet, (masked_frames[:, :lt] + 1.0) / 2.0, ckpt)

    with profiling.span("e2fgvi.encode"):
        # (B*T, h/4, w/4, 128)
        enc = ckpt(encoder_forward, net.encoder, masked_frames.flatten(0, 1))
    eh, ew = enc.shape[1:3]
    enc = enc.reshape(b, t, eh, ew, CHANNEL)
    with profiling.span("e2fgvi.propagate"):
        local_feat = ckpt(bidirectional_propagation, net.feat_prop_module, enc[:, :lt],
                          flows_backward, flows_forward)
    enc_feat = torch.cat([local_feat, enc[:, lt:]], dim=1)

    with profiling.span("e2fgvi.transformer"):
        tokens = M.soft_split(net.ss, enc_feat.flatten(0, 1), KERNEL, STRIDE, PADDING)
        fh = (eh + 2 * PADDING[0] - KERNEL[0]) // STRIDE[0] + 1
        fw = (ew + 2 * PADDING[1] - KERNEL[1]) // STRIDE[1] + 1
        x = tokens.reshape(b, t, fh, fw, HIDDEN)
        for blk in net.transformer[:cfg.num_blocks]:
            x = ckpt(lambda b_, x_: focal_block_forward(b_, x_, (eh, ew),
                                                        frame_valid=frame_valid), blk, x)
        trans = M.soft_comp(net.sc, x.reshape(b * t, fh * fw, HIDDEN), (eh, ew), KERNEL,
                            STRIDE, PADDING)
    enc_feat = enc_feat + trans.reshape(b, t, eh, ew, CHANNEL)

    with profiling.span("e2fgvi.decode"):
        out = torch.tanh(ckpt(decoder_forward, net.decoder, enc_feat.flatten(0, 1))
                         ).reshape(b, t, h, w, 3)
    if batched:
        return out, (flows_forward, flows_backward)
    return out[0], (flows_forward[0], flows_backward[0])
