"""E2FGVI-HQ building blocks (port of `vosesam_tpu/models/e2fgvi/modules.py`).

Reference: inpainter/model/modules/ —
  - flow_comp.py: SPyNet (:49-185, 6 pyramid levels, 7x7 conv stacks) and
    flow_warp (:345, grid_sample with align_corners=True);
  - feat_prop.py: SecondOrderDeformableAlignment (:13-59, mmcv
    ModulatedDeformConv2d with flow-guided offsets);
  - tfocal_transformer_hq.py: SoftSplit (:19), SoftComp (:49),
    FusionFeedForward (:82).

Parameters live in `nn.Module`s under the official checkpoint's names; the
functions here take the module that holds their weights, and take and return
the JAX package's channel-last activations ((B, H, W, C)). Convolutions run
on a channel-first view of the same memory (`conv_nhwc`), which cuDNN reads
as channels-last without a copy.

The modulated deformable convolution samples through the hand-written
kernel `ops/kernels/deform_align.py:deform_patches_bounded` (its plain
PyTorch version on CPU tensors) and contracts with the 3x3 weight in one
`torch.matmul`. `flow_warp` keeps the JAX arithmetic (absolute pixel
coordinates, floor, four gathers) rather than `F.grid_sample`, whose
normalised coordinates floor differently on integer positions. `unfold` and
`fold` are `F.unfold` / `F.fold`, whose (C, kh, kw) patch order the JAX
versions reproduce.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vosesam_tpu_torch.models.layers import Conv2d, Linear, conv2d, linear
from vosesam_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD, device_const, \
    resize_bilinear_align_corners
from vosesam_tpu_torch.ops.kernels.deform_align import deform_patches_bounded


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """(B, H, W, Cin) -> (B, H', W', Cout) through an `nn.Conv2d`."""
    return conv2d(x.permute(0, 3, 1, 2), conv).permute(0, 2, 3, 1)


# ----------------------------------------------------------------- flow warp

def flow_warp(x: torch.Tensor, flow: torch.Tensor, padding_zero: bool = True) -> torch.Tensor:
    """Warp (..., H, W, C) by flow (..., H, W, 2[xy]): bilinear grid_sample
    with align_corners=True semantics on absolute pixel offsets
    (flow_comp.py:345). Out-of-range samples read zeros (or the clamped
    border)."""
    if x.ndim == 3:
        return flow_warp(x[None], flow[None], padding_zero)[0]
    b, h, w, c = x.shape
    yy = torch.arange(h, dtype=flow.dtype, device=x.device)[:, None]
    xx = torch.arange(w, dtype=flow.dtype, device=x.device)[None, :]
    gx = xx + flow[..., 0]
    gy = yy + flow[..., 1]
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    flat = x.reshape(b, h * w, c)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()).reshape(b, h * w, 1)
        v = torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(b, h, w, c)
        if padding_zero:
            v = v * inb[..., None].to(v.dtype)
        return v

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


# -------------------------------------------------------------------- SPyNet

SPYNET_CHANNELS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))


class _ConvModule(nn.Module):
    """mmcv's ConvModule as the checkpoint names it: `.conv`."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.conv = Conv2d(cin, cout, 7, padding=3)


class SPyNetBasicModule(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.basic_module = nn.ModuleList(_ConvModule(ci, co) for ci, co in SPYNET_CHANNELS)


class SPyNet(nn.Module):
    """`update_spynet.basic_module.<level>.basic_module.<i>.conv`. The
    reference's `mean` / `std` buffers are constants here."""

    def __init__(self) -> None:
        super().__init__()
        self.basic_module = nn.ModuleList(SPyNetBasicModule() for _ in range(6))


def _spynet_basic(x: torch.Tensor, level: SPyNetBasicModule) -> torch.Tensor:
    last = len(SPYNET_CHANNELS) - 1
    for i, m in enumerate(level.basic_module):
        x = conv_nhwc(x, m.conv)
        if i < last:
            x = torch.relu(x)
    return x


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def spynet_flow(net: SPyNet, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
    """ref, supp: (B, H, W, 3) in [0, 1] -> flow (B, H, W, 2) ref->supp.

    flow_comp.py:87-170: 6-level coarse-to-fine with x2 upsampled flow
    residuals; inputs resized to a multiple of 32 by the caller."""
    b, h, w, _ = ref.shape
    if h % 32 or w % 32:
        raise ValueError(f"spynet inputs must be multiples of 32, got {h}x{w}")
    mean = device_const(("imagenet_mean",), lambda: np.asarray(IMAGENET_MEAN, np.float32),
                        ref.device).to(ref.dtype)
    std = device_const(("imagenet_std",), lambda: np.asarray(IMAGENET_STD, np.float32),
                       ref.device).to(ref.dtype)
    refs, supps = [(ref - mean) / std], [(supp - mean) / std]
    for _ in range(5):
        refs.append(_avg_pool2(refs[-1]))
        supps.append(_avg_pool2(supps[-1]))
    refs, supps = refs[::-1], supps[::-1]

    flow = torch.zeros((b, h // 32, w // 32, 2), dtype=ref.dtype, device=ref.device)
    for lvl in range(6):
        if lvl == 0:
            flow_up = flow
        else:
            # align_corners=True x2 upsample (flow_comp.py:121-124)
            flow_up = resize_bilinear_align_corners(flow, refs[lvl].shape[1:3]) * 2.0
        warped = flow_warp(supps[lvl], flow_up, padding_zero=False)
        inp = torch.cat([refs[lvl], warped, flow_up], dim=-1)
        flow = flow_up + _spynet_basic(inp, net.basic_module[lvl])
    return flow


# ------------------------------------------------- modulated deformable conv

def _deform_conv(x, offset, mask, weight, bias, deform_groups: int,
                 radius: Optional[int]) -> torch.Tensor:
    cout, cin = weight.shape[:2]
    if mask.shape[-1] != deform_groups * 9:
        raise ValueError(f"mask has {mask.shape[-1]} channels, expected {deform_groups} * 9")
    patches = deform_patches_bounded(x, offset, mask, radius)          # (B, H, W, 9, Cin)
    wmat = weight.to(patches.dtype).permute(2, 3, 1, 0).reshape(9 * cin, cout)
    out = torch.matmul(patches.reshape(*patches.shape[:3], 9 * cin), wmat)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def modulated_deform_conv(
    x: torch.Tensor,        # (B, H, W, Cin)
    offset: torch.Tensor,   # (B, H, W, 2*G*K): (y, x) interleaved per mmcv
    mask: torch.Tensor,     # (B, H, W, G*K)
    weight: torch.Tensor,   # (Cout, Cin, 3, 3), the checkpoint's layout
    bias: Optional[torch.Tensor],
    deform_groups: int,
) -> torch.Tensor:
    """ModulatedDeformConv2d (mmcv): for each kernel tap k and deform group
    g, bilinearly sample x_g at (p + p_k + dp_gk) and scale by the
    modulation mask (one kernel), then contract with the 3x3 weight as one
    matmul."""
    return _deform_conv(x, offset, mask, weight, bias, deform_groups, None)


def modulated_deform_conv_bounded(x, offset, mask, weight, bias, deform_groups: int,
                                  radius: int = 16) -> torch.Tensor:
    """The same convolution with the bounded window's drop rule: corners
    displaced by more than `radius` rows or columns contribute nothing. Equal
    to `modulated_deform_conv` wherever every corner fits the window."""
    return _deform_conv(x, offset, mask, weight, bias, deform_groups, radius)


class SecondOrderDeformableAlignment(nn.Module):
    """feat_prop.py:13-59: `weight`, `bias`, `conv_offset.{0,2,4,6}`."""

    def __init__(self, channel: int, deform_groups: int = 16, max_residue: float = 10.0) -> None:
        super().__init__()
        self.deform_groups = deform_groups
        self.max_residue = max_residue
        self.weight = nn.Parameter(torch.zeros(channel, 2 * channel, 3, 3))
        self.bias = nn.Parameter(torch.zeros(channel))
        lrelu = nn.LeakyReLU(0.1)
        self.conv_offset = nn.Sequential(
            Conv2d(3 * channel + 4, channel, 3, padding=1), lrelu,
            Conv2d(channel, channel, 3, padding=1), lrelu,
            Conv2d(channel, channel, 3, padding=1), lrelu,
            Conv2d(channel, 27 * deform_groups, 3, padding=1))


def second_order_deform_align(
    p: SecondOrderDeformableAlignment,
    x: torch.Tensor,          # (B, H, W, 2*C): [feat_prop, feat_n2]
    extra: torch.Tensor,      # (B, H, W, 3*C): [cond_n1, feat_current, cond_n2]
    flow1: torch.Tensor,      # (B, H, W, 2)
    flow2: torch.Tensor,
) -> torch.Tensor:
    """feat_prop.py:36-59."""
    feat = torch.cat([extra, flow1, flow2], dim=-1)
    co = p.conv_offset
    y = leaky_relu(conv_nhwc(feat, co[0]), 0.1)
    y = leaky_relu(conv_nhwc(y, co[2]), 0.1)
    y = leaky_relu(conv_nhwc(y, co[4]), 0.1)
    out = conv_nhwc(y, co[6])                         # (B, H, W, 27*G)

    o1, o2, mask = torch.chunk(out, 3, dim=-1)        # each (B, H, W, 9*G)
    offset = p.max_residue * torch.tanh(torch.cat([o1, o2], dim=-1))
    off1, off2 = torch.chunk(offset, 2, dim=-1)
    # add the flow, flipped to (y, x), to every tap of every group
    off1 = off1 + flow1.flip(-1).repeat(1, 1, 1, off1.shape[-1] // 2)
    off2 = off2 + flow2.flip(-1).repeat(1, 1, 1, off2.shape[-1] // 2)
    mask = torch.sigmoid(mask)
    # first-order offsets act on x[:C], second-order on x[C:]: one deform
    # conv over the 2C input whose groups' offsets are o1 | o2
    offset_all = torch.cat([off1, off2], dim=-1)
    return modulated_deform_conv(x, offset_all, mask, p.weight, p.bias, p.deform_groups)


# ------------------------------------------------------------ unfold / fold

def unfold(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
           padding: Tuple[int, int]) -> torch.Tensor:
    """torch.nn.Unfold on channel-last input: (B, H, W, C) -> (B, L, C*kh*kw)
    with the (C, kh, kw) patch-channel order."""
    return F.unfold(x.permute(0, 3, 1, 2), kernel, padding=padding, stride=stride
                    ).transpose(1, 2)


def fold(x: torch.Tensor, output_size: Tuple[int, int], kernel: Tuple[int, int],
         stride: Tuple[int, int], padding: Tuple[int, int]) -> torch.Tensor:
    """torch.nn.Fold: overlap-add of (B, L, C*kh*kw) patches -> (B, H, W, C)."""
    return F.fold(x.transpose(1, 2), tuple(output_size), kernel, padding=padding,
                  stride=stride).permute(0, 2, 3, 1)


# ----------------------------------------------------- soft split / compose

class SoftSplit(nn.Module):
    def __init__(self, channel: int, hidden: int, kernel: Tuple[int, int]) -> None:
        super().__init__()
        self.embedding = Linear(kernel[0] * kernel[1] * channel, hidden)


def soft_split(p: SoftSplit, x: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    """(B*T, H, W, C) -> (B*T, fh*fw, hidden) token embedding (SoftSplit :19)."""
    return linear(unfold(x, kernel, stride, padding), p.embedding)


class SoftComp(nn.Module):
    """`embedding` plus the HQ variant's `bias_conv` or, for the original
    E2FGVI (tfocal_transformer.py:56-63), the learned additive `bias` pinned
    to the (60, 108) feature grid, stored (C, H, W) as in its checkpoint."""

    def __init__(self, channel: int, hidden: int, kernel: Tuple[int, int], hq: bool = True,
                 output_size: Tuple[int, int] = (60, 108)) -> None:
        super().__init__()
        self.embedding = Linear(hidden, kernel[0] * kernel[1] * channel)
        if hq:
            self.bias_conv = Conv2d(channel, channel, 3, padding=1)
        else:
            self.bias = nn.Parameter(torch.zeros(channel, *output_size))


def soft_comp(p: SoftComp, x: torch.Tensor, output_size, kernel, stride, padding) -> torch.Tensor:
    """(B*T, L, hidden) -> (B*T, H, W, C) token fold (SoftComp :49); the
    module's form (`bias_conv` or `bias`) decides the variant."""
    out = fold(linear(x, p.embedding), output_size, kernel, stride, padding)
    if hasattr(p, "bias_conv"):
        return conv_nhwc(out, p.bias_conv)
    return out + p.bias.to(out.dtype).permute(1, 2, 0)[None]


class FusionFeedForward(nn.Module):
    """`conv1.0` and `conv2.1` (the reference's Sequentials hold the linear
    layers at these indices)."""

    def __init__(self, d_model: int, hidden: int = 1960) -> None:
        super().__init__()
        self.conv1 = nn.ModuleDict({"0": Linear(d_model, hidden)})
        self.conv2 = nn.ModuleDict({"1": Linear(hidden, d_model)})


def fusion_feed_forward(p: FusionFeedForward, x: torch.Tensor, output_size, kernel, stride,
                        padding) -> torch.Tensor:
    """F3N (tfocal_transformer_hq.py:82-118): a token MLP whose hidden state
    is fold/unfold-normalised to blend overlapping patches."""
    b, n, _ = x.shape
    x = linear(x, p.conv1["0"])
    c = x.shape[-1]
    kk = kernel[0] * kernel[1]
    fh = (output_size[0] + 2 * padding[0] - kernel[0]) // stride[0] + 1
    fw = (output_size[1] + 2 * padding[1] - kernel[1]) // stride[1] + 1
    n_vecs = fh * fw
    bt = (b * n) // n_vecs
    ones = torch.ones((1, n_vecs, kk), dtype=x.dtype, device=x.device)
    normalizer = fold(ones, output_size, kernel, stride, padding)     # (1, H, W, 1)
    folded = fold(x.reshape(bt, n_vecs, c), output_size, kernel, stride, padding)
    renorm = folded / normalizer.clamp_min(1e-9)
    x = unfold(renorm, kernel, stride, padding).reshape(b, n, c)
    return linear(F.gelu(x), p.conv2["1"])
