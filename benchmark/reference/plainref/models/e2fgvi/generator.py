"""E2FGVI-HQ's generator in plain PyTorch, float32, channel-first as the
published code has it (model/e2fgvi_hq.py with model/modules/flow_comp.py,
feat_prop.py and tfocal_transformer_hq.py):

  - SPyNet flows between consecutive local frames at a quarter of the
    resolution: a 6-level pyramid, each level a residual on the support
    frame warped by the flow so far;
  - the grouped-convolution encoder with its group fusion;
  - second-order flow-guided deformable alignment, backward then forward,
    each alignment a modulated deformable 3x3 convolution written out as
    bilinear sampling (zeros outside the field, no bound on the
    displacement) and one product with the weight;
  - soft split (7x7 unfold at stride 3 into 512-wide tokens), the temporal
    focal transformer blocks (4 heads, 5x9 windows over all frames, keys of
    the window, of the four rolled windows and of the pooled windows
    around it; the fold/unfold feed-forward 1960 wide), soft composite;
  - the deconvolution decoder and tanh.

Module names are the official state-dict names, so one state dict loads
strictly here and into the port. There is no kernel, cache or batching
trick: every window runs alone, one frame pair or tap at a time where the
published code loops.

Departures from the published code:
  - `frame_valid`: window slots marked False (the port's padded reference
    slots) give no key to any attention softmax (-inf before it). With
    every slot valid it is the published attention.
  - SPyNet's `mean` / `std` and the attention's rolled-key index are
    constants, not state-dict buffers (the port's loader drops those
    buffers from the official checkpoint).
  - The token grid must be a multiple of the (5, 9) window, as it is at
    480x864 (the app's 480x854, flip-padded) and at 60x108: the published
    block's padding of other grids is not written out.
  - The flows are paired with the propagation directions and indexed as
    in the published feat_prop.py: the backward pass reads
    `flows_backward` (SPyNet of frame i+1 against frame i) at the step's
    own index, not the frame's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class E2FGVIConfig:
    """The published E2FGVI-HQ widths (e2fgvi_hq.py InpaintGenerator)."""

    encoder_channels: int = 128         # channel // 2 of the published 256
    hidden_dim: int = 512
    num_blocks: int = 8
    num_heads: int = 4
    window_size: Tuple[int, int] = (5, 9)
    focal_level: int = 2
    ffn_hidden_dim: int = 1960
    kernel: Tuple[int, int] = (7, 7)
    stride: Tuple[int, int] = (3, 3)
    padding: Tuple[int, int] = (3, 3)
    deform_groups: int = 16
    max_residue: float = 10.0

    @classmethod
    def from_section(cls, section: dict) -> "E2FGVIConfig":
        """What a configuration file's `e2fgvi` section states (lists read
        as tuples); other keys are ignored."""
        kw = {f.name: section[f.name] for f in dataclasses.fields(cls) if f.name in section}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()})


# ------------------------------------------------------------------ flow warp

def flow_warp(x: torch.Tensor, flow: torch.Tensor, padding_mode: str = "zeros") -> torch.Tensor:
    """flow_comp.py flow_warp: x (N, C, H, W) sampled at the pixel grid plus
    flow (N, H, W, 2) in (x, y) pixels, bilinear, align_corners=True."""
    _, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=x.device, dtype=x.dtype),
                            torch.arange(w, device=x.device, dtype=x.dtype), indexing="ij")
    grid = torch.stack((gx, gy), 2) + flow
    gx = 2.0 * grid[..., 0] / max(w - 1, 1) - 1.0
    gy = 2.0 * grid[..., 1] / max(h - 1, 1) - 1.0
    return F.grid_sample(x, torch.stack((gx, gy), dim=3), mode="bilinear",
                         padding_mode=padding_mode, align_corners=True)


# --------------------------------------------------------------------- SPyNet

class ConvModule(nn.Module):
    """mmcv's ConvModule as SPyNet uses it: a 7x7 convolution, then ReLU
    unless it is the level's last."""

    def __init__(self, cin: int, cout: int, act: bool) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 7, stride=1, padding=3)
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x) if self.act else x


class SPyNetBasicModule(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.basic_module = nn.Sequential(
            ConvModule(8, 32, True), ConvModule(32, 64, True), ConvModule(64, 32, True),
            ConvModule(32, 16, True), ConvModule(16, 2, False))

    def forward(self, x):
        return self.basic_module(x)


class SPyNet(nn.Module):
    MEAN = (0.485, 0.456, 0.406)
    STD = (0.229, 0.224, 0.225)

    def __init__(self) -> None:
        super().__init__()
        self.basic_module = nn.ModuleList([SPyNetBasicModule() for _ in range(6)])

    def compute_flow(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) frames in [0, 1], H and W multiples of 32 -> the flow
        (N, 2, H, W) that carries supp onto ref."""
        n, _, h, w = ref.shape
        mean = torch.tensor(self.MEAN, device=ref.device, dtype=ref.dtype).view(1, 3, 1, 1)
        std = torch.tensor(self.STD, device=ref.device, dtype=ref.dtype).view(1, 3, 1, 1)
        ref = [(ref - mean) / std]
        supp = [(supp - mean) / std]
        for _ in range(5):
            ref.append(F.avg_pool2d(ref[-1], kernel_size=2, stride=2, count_include_pad=False))
            supp.append(F.avg_pool2d(supp[-1], kernel_size=2, stride=2, count_include_pad=False))
        ref, supp = ref[::-1], supp[::-1]
        flow = ref[0].new_zeros(n, 2, h // 32, w // 32)
        for level in range(len(ref)):
            if level == 0:
                flow_up = flow
            else:
                flow_up = F.interpolate(flow, scale_factor=2, mode="bilinear",
                                        align_corners=True) * 2.0
            warped = flow_warp(supp[level], flow_up.permute(0, 2, 3, 1), padding_mode="border")
            flow = flow_up + self.basic_module[level](torch.cat([ref[level], warped, flow_up], 1))
        return flow

    def forward(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        """Any size: resized up to multiples of 32, the flow resized back and
        its components rescaled."""
        h, w = ref.shape[2:4]
        w_up = w if w % 32 == 0 else 32 * (w // 32 + 1)
        h_up = h if h % 32 == 0 else 32 * (h // 32 + 1)
        ref = F.interpolate(ref, size=(h_up, w_up), mode="bilinear", align_corners=False)
        supp = F.interpolate(supp, size=(h_up, w_up), mode="bilinear", align_corners=False)
        flow = F.interpolate(self.compute_flow(ref, supp), size=(h, w), mode="bilinear",
                             align_corners=False)
        scale = torch.tensor([w / w_up, h / h_up], device=flow.device, dtype=flow.dtype)
        return flow * scale.view(1, 2, 1, 1)


# -------------------------------------------------------------------- encoder

class Encoder(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.group = [1, 2, 4, 8, 1]
        spec = [(3, 64, 2, 1), (64, 64, 1, 1), (64, 128, 2, 1), (128, 256, 1, 1),
                (256, 384, 1, 1), (640, 512, 1, 2), (768, 384, 1, 4), (640, 256, 1, 8),
                (512, 128, 1, 1)]
        layers: List[nn.Module] = []
        for cin, cout, stride, groups in spec:
            layers += [nn.Conv2d(cin, cout, 3, stride=stride, padding=1, groups=groups),
                       nn.LeakyReLU(0.2)]
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(BT, 3, H, W) -> (BT, 128, H/4, W/4); from layer 8 on, each
        grouped convolution sees the stride-4 feature x0 and the running
        activation interleaved group by group."""
        bt = x.shape[0]
        out = x
        for i, layer in enumerate(self.layers):
            if i == 8:
                x0 = out
                h, w = x0.shape[2:4]
            if i > 8 and i % 2 == 0:
                g = self.group[(i - 8) // 2]
                out = torch.cat([x0.view(bt, g, -1, h, w), out.view(bt, g, -1, h, w)],
                                2).view(bt, -1, h, w)
            out = layer(out)
        return out


class Deconv(nn.Module):
    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=1, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True))


# ------------------------------------------------- second-order deformable align

def modulated_deform_conv(x, offset, mask, weight, bias, deform_groups: int,
                          record: Optional[list] = None) -> torch.Tensor:
    """mmcv's modulated_deform_conv2d at 3x3, stride 1, padding 1: for each
    tap k and deform group g, x's group-g channels bilinearly sampled at
    p + (dy_k, dx_k) + offset[g, k] (zeros outside the field), times the
    modulation mask[g, k]; then one product with the (Cout, Cin * 9)
    weight. offset (N, G * 9 * 2, H, W) holds (y, x) pairs, mask
    (N, G * 9, H, W). `record`, when a list, gets (samples inside the field,
    samples) of this call."""
    n, cin, h, w = x.shape
    g = deform_groups
    off = offset.view(n, g, 9, 2, h, w)
    msk = mask.view(n, g, 9, h, w)
    yy, xx = torch.meshgrid(torch.arange(h, device=x.device, dtype=x.dtype),
                            torch.arange(w, device=x.device, dtype=x.dtype), indexing="ij")
    xg = x.reshape(n * g, cin // g, h, w)
    cols = []
    inside = 0
    for k in range(9):
        dy, dx = k // 3 - 1, k % 3 - 1
        sy = yy + dy + off[:, :, k, 0]
        sx = xx + dx + off[:, :, k, 1]
        if record is not None:
            inside += int(((sy > -1) & (sy < h) & (sx > -1) & (sx < w)).sum())
        grid = torch.stack([2.0 * sx / max(w - 1, 1) - 1.0, 2.0 * sy / max(h - 1, 1) - 1.0],
                           dim=-1).view(n * g, h, w, 2)
        v = F.grid_sample(xg, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        cols.append(v.view(n, g, cin // g, h, w) * msk[:, :, k, None])
    if record is not None:
        record.append((inside, n * g * 9 * h * w))
    patches = torch.stack(cols, dim=3).reshape(n, cin * 9, h * w)     # (c, k) order
    out = torch.matmul(weight.reshape(weight.shape[0], cin * 9), patches).view(n, -1, h, w)
    return out + bias.view(1, -1, 1, 1)


class SecondOrderDeformableAlignment(nn.Module):
    """feat_prop.py: a modulated deformable convolution (2C -> C) whose
    offsets are the flows plus a bounded residue predicted from the
    warped neighbours."""

    def __init__(self, cin: int, cout: int, deform_groups: int, max_residue: float) -> None:
        super().__init__()
        self.deform_groups = deform_groups
        self.max_residue = max_residue
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.conv_offset = nn.Sequential(
            nn.Conv2d(3 * cout + 4, cout, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(cout, cout, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(cout, cout, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(cout, 27 * deform_groups, 3, 1, 1))

    def forward(self, x, extra_feat, flow_1, flow_2, record=None):
        out = self.conv_offset(torch.cat([extra_feat, flow_1, flow_2], dim=1))
        o1, o2, mask = torch.chunk(out, 3, dim=1)
        offset = self.max_residue * torch.tanh(torch.cat((o1, o2), dim=1))
        offset_1, offset_2 = torch.chunk(offset, 2, dim=1)
        offset_1 = offset_1 + flow_1.flip(1).repeat(1, offset_1.size(1) // 2, 1, 1)
        offset_2 = offset_2 + flow_2.flip(1).repeat(1, offset_2.size(1) // 2, 1, 1)
        offset = torch.cat([offset_1, offset_2], dim=1)
        return modulated_deform_conv(x, offset, torch.sigmoid(mask), self.weight, self.bias,
                                     self.deform_groups, record)


class BidirectionalPropagation(nn.Module):
    def __init__(self, channel: int, deform_groups: int, max_residue: float) -> None:
        super().__init__()
        self.channel = channel
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, name in enumerate(("backward_", "forward_")):
            self.deform_align[name] = SecondOrderDeformableAlignment(
                2 * channel, channel, deform_groups, max_residue)
            self.backbone[name] = nn.Sequential(
                nn.Conv2d((2 + i) * channel, channel, 3, 1, 1), nn.LeakyReLU(0.1),
                nn.Conv2d(channel, channel, 3, 1, 1))
        self.fusion = nn.Conv2d(2 * channel, channel, 1, 1, 0)

    def forward(self, x, flows_backward, flows_forward, record=None):
        """x (B, T, C, H, W); flows (B, T-1, 2, H, W). Each frame's feature
        after the first in a direction is the alignment of the previous
        two propagated features (the second-order one warped along the
        composed flow) plus a residual backbone."""
        b, t, c, h, w = x.shape
        feats = {"spatial": [x[:, i] for i in range(t)]}
        for name in ("backward_", "forward_"):
            feats[name] = []
            frame_idx = list(range(t))
            flow_idx = list(range(-1, t - 1))
            if name == "backward_":
                frame_idx = frame_idx[::-1]
                flows = flows_backward
            else:
                flows = flows_forward
            feat_prop = x.new_zeros(b, self.channel, h, w)
            for i, idx in enumerate(frame_idx):
                feat_current = feats["spatial"][idx]
                if i > 0:
                    flow_n1 = flows[:, flow_idx[i]]
                    cond_n1 = flow_warp(feat_prop, flow_n1.permute(0, 2, 3, 1))
                    feat_n2 = torch.zeros_like(feat_prop)
                    flow_n2 = torch.zeros_like(flow_n1)
                    cond_n2 = torch.zeros_like(cond_n1)
                    if i > 1:
                        feat_n2 = feats[name][-2]
                        flow_n2 = flows[:, flow_idx[i - 1]]
                        flow_n2 = flow_n1 + flow_warp(flow_n2, flow_n1.permute(0, 2, 3, 1))
                        cond_n2 = flow_warp(feat_n2, flow_n2.permute(0, 2, 3, 1))
                    cond = torch.cat([cond_n1, feat_current, cond_n2], dim=1)
                    feat_prop = self.deform_align[name](torch.cat([feat_prop, feat_n2], dim=1),
                                                         cond, flow_n1, flow_n2, record)
                feat = [feat_current] + [feats[k][idx] for k in feats
                                         if k not in ("spatial", name)] + [feat_prop]
                feat_prop = feat_prop + self.backbone[name](torch.cat(feat, dim=1))
                feats[name].append(feat_prop)
            if name == "backward_":
                feats[name] = feats[name][::-1]
        outputs = [self.fusion(torch.cat([feats["backward_"][i], feats["forward_"][i]], dim=1))
                   for i in range(t)]
        return torch.stack(outputs, dim=1) + x


# ------------------------------------------------ soft split / soft composite

class SoftSplit(nn.Module):
    def __init__(self, cfg: E2FGVIConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Linear(cfg.kernel[0] * cfg.kernel[1] * cfg.encoder_channels, cfg.hidden_dim)

    def forward(self, x: torch.Tensor, b: int, output_size: Tuple[int, int]) -> torch.Tensor:
        """(B*T, C, h, w) -> (B, T, fh, fw, hidden) tokens."""
        c = self.cfg
        f_h = (output_size[0] + 2 * c.padding[0] - c.kernel[0]) // c.stride[0] + 1
        f_w = (output_size[1] + 2 * c.padding[1] - c.kernel[1]) // c.stride[1] + 1
        feat = F.unfold(x, c.kernel, padding=c.padding, stride=c.stride).permute(0, 2, 1)
        return self.embedding(feat).view(b, -1, f_h, f_w, c.hidden_dim)


class SoftComp(nn.Module):
    def __init__(self, cfg: E2FGVIConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Linear(cfg.hidden_dim, cfg.kernel[0] * cfg.kernel[1] * cfg.encoder_channels)
        self.bias_conv = nn.Conv2d(cfg.encoder_channels, cfg.encoder_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor, t: int, output_size: Tuple[int, int]) -> torch.Tensor:
        """(B, T, fh, fw, hidden) -> (B*T, C, h, w): the tokens folded back
        (overlaps added) and the HQ bias convolution."""
        c = self.cfg
        feat = self.embedding(x.reshape(x.shape[0], -1, x.shape[-1]))
        b, _, ch = feat.shape
        feat = feat.view(b * t, -1, ch).permute(0, 2, 1)
        feat = F.fold(feat, output_size=output_size, kernel_size=c.kernel, stride=c.stride,
                      padding=c.padding)
        return self.bias_conv(feat)


# ---------------------------------------------------- temporal focal attention

def window_partition(x: torch.Tensor, ws: Tuple[int, int]) -> torch.Tensor:
    """(B, T, H, W, C) -> (B * nW, T, wh * ww, C), windows batch-major."""
    b, t, h, w, c = x.shape
    x = x.view(b, t, h // ws[0], ws[0], w // ws[1], ws[1], c)
    return x.permute(0, 2, 4, 1, 3, 5, 6).reshape(-1, t, ws[0] * ws[1], c)


def window_reverse(windows: torch.Tensor, ws: Tuple[int, int], t: int, h: int, w: int):
    """(B * nW, T, wh, ww, C) -> (B, T, H, W, C)."""
    b = windows.shape[0] // ((h // ws[0]) * (w // ws[1]))
    x = windows.view(b, h // ws[0], w // ws[1], t, ws[0], ws[1], -1)
    return x.permute(0, 3, 1, 4, 2, 5, 6).reshape(b, t, h, w, -1)


def rolled_key_index(ws: Tuple[int, int], expand: Tuple[int, int]) -> torch.Tensor:
    """The keys of the four diagonally rolled windows that lie outside the
    window itself (tfocal_transformer_hq.py valid_ind_rolled)."""
    masks = []
    for top in (True, False):
        for left in (True, False):
            m = torch.ones(ws)
            rows = slice(None, -expand[0]) if top else slice(expand[0], None)
            cols = slice(None, -expand[1]) if left else slice(expand[1], None)
            m[rows, cols] = 0
            masks.append(m)
    return torch.stack(masks, 0).flatten().nonzero(as_tuple=False).view(-1)


class WindowAttention(nn.Module):
    def __init__(self, cfg: E2FGVIConfig) -> None:
        super().__init__()
        self.dim, self.num_heads = cfg.hidden_dim, cfg.num_heads
        self.window_size = cfg.window_size
        self.expand_size = tuple(i // 2 for i in cfg.window_size)
        self.scale = (cfg.hidden_dim // cfg.num_heads) ** -0.5
        # focal level 2: one pooled level, unfolded over the (5, 9) windows around
        self.pool_kernel = cfg.window_size
        self.qkv = nn.Linear(cfg.hidden_dim, 3 * cfg.hidden_dim)
        self.proj = nn.Linear(cfg.hidden_dim, cfg.hidden_dim)

    def forward(self, x: torch.Tensor, pooled: torch.Tensor,
                frame_valid: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, T, H, W, C); pooled (B, nWh, nWw, T, C), one token per
        window; frame_valid (B, T) bool or None. Returns (B * nW, T * 45, C)."""
        b, t, nh, nw, c = x.shape
        wh, ww = self.window_size
        heads, hd = self.num_heads, c // self.num_heads
        qkv = self.qkv(x).reshape(b, t, nh, nw, 3, c).permute(4, 0, 1, 2, 3, 5)
        q, k, v = qkv[0], qkv[1], qkv[2]

        def windows(a):       # -> (B*nW, heads, T*45, hd)
            a = window_partition(a, self.window_size).view(-1, t, wh * ww, heads, hd)
            return a.permute(0, 3, 1, 2, 4).reshape(-1, heads, t * wh * ww, hd)

        q_windows, k_windows, v_windows = windows(q), windows(k), windows(v)

        eh, ew = self.expand_size
        shifts = ((-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew))   # tl, tr, bl, br
        idx = rolled_key_index(self.window_size, self.expand_size).to(x.device)

        def rolled(a):        # -> (B*nW, heads, T*n_roll, hd)
            parts = [window_partition(torch.roll(a, s, dims=(2, 3)), self.window_size)
                     .view(-1, t, wh * ww, heads, hd) for s in shifts]
            r = torch.cat(parts, 2).permute(0, 3, 1, 2, 4)[:, :, :, idx]
            return r.reshape(-1, heads, t * idx.numel(), hd)

        k_rolled = torch.cat((k_windows, rolled(k)), 2)
        v_rolled = torch.cat((v_windows, rolled(v)), 2)

        # the pooled level: the (5, 9) pooled windows around each window, zero
        # padded at the map's edge, the padding masked with -100
        kh, kw = self.pool_kernel
        pad = (kh // 2, kw // 2)
        x_pooled = pooled.permute(0, 3, 1, 2, 4)                       # (B, T, nWh, nWw, C)
        nwh, nww = x_pooled.shape[2:4]
        ones = x_pooled.new_ones(t, 1, nwh, nww)
        unfolded_mask = F.unfold(ones, (kh, kw), padding=pad, stride=1).view(
            1, t, kh, kw, -1).permute(4, 1, 2, 3, 0).reshape(nwh * nww, -1)   # (L, T*45)
        pool_mask = torch.zeros_like(unfolded_mask).masked_fill(unfolded_mask == 0, -100.0)
        qkv_p = self.qkv(x_pooled).reshape(b, t, nwh, nww, 3, c).permute(4, 0, 1, 5, 2, 3)

        def pooled_keys(a):   # (B, T, C, nWh, nWw) -> (B*L, heads, T*45, hd)
            u = F.unfold(a.reshape(-1, c, nwh, nww), (kh, kw), padding=pad, stride=1)
            u = u.view(b, t, c, kh, kw, -1).permute(0, 5, 1, 3, 4, 2)
            u = u.reshape(-1, t, kh * kw, heads, hd).permute(0, 3, 1, 2, 4)
            return u.reshape(-1, heads, t * kh * kw, hd)

        k_all = torch.cat([k_rolled, pooled_keys(qkv_p[1])], 2)
        v_all = torch.cat([v_rolled, pooled_keys(qkv_p[2])], 2)

        attn = torch.matmul(q_windows * self.scale, k_all.transpose(-2, -1))
        window_area = t * wh * ww
        offset = k_rolled.shape[2]
        n_win = attn.shape[0] // b
        attn[:, :, :window_area, offset:offset + t * kh * kw] += \
            pool_mask.repeat(b, 1)[:, None, None, :]
        if frame_valid is not None:
            n_roll = idx.numel()
            keys = torch.cat([frame_valid.repeat_interleave(wh * ww, 1),
                              frame_valid.repeat_interleave(n_roll, 1),
                              frame_valid.repeat_interleave(kh * kw, 1)], 1)   # (B, N)
            attn = attn.masked_fill(~keys.repeat_interleave(n_win, 0)[:, None, None, :],
                                    float("-inf"))
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v_all).transpose(1, 2).reshape(attn.shape[0], window_area, c)
        return self.proj(out)


class FusionFeedForward(nn.Module):
    def __init__(self, cfg: E2FGVIConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Sequential(nn.Linear(cfg.hidden_dim, cfg.ffn_hidden_dim))
        self.conv2 = nn.Sequential(nn.GELU(), nn.Linear(cfg.ffn_hidden_dim, cfg.hidden_dim))

    def forward(self, x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
        """(B, T*fh*fw, hidden): the hidden state folded onto the feature
        map, divided by the overlap count and unfolded again."""
        c = self.cfg
        n_vecs = 1
        for i, d in enumerate(c.kernel):
            n_vecs *= (output_size[i] + 2 * c.padding[i] - (d - 1) - 1) // c.stride[i] + 1
        kk = c.kernel[0] * c.kernel[1]
        x = self.conv1(x)
        b, n, ch = x.shape
        normalizer = x.new_ones(b, n, kk).view(-1, n_vecs, kk).permute(0, 2, 1)
        normalizer = F.fold(normalizer, output_size=output_size, kernel_size=c.kernel,
                            padding=c.padding, stride=c.stride)
        x = F.fold(x.view(-1, n_vecs, ch).permute(0, 2, 1), output_size=output_size,
                   kernel_size=c.kernel, padding=c.padding, stride=c.stride)
        x = F.unfold(x / normalizer, kernel_size=c.kernel, padding=c.padding,
                     stride=c.stride).permute(0, 2, 1).reshape(b, n, ch)
        return self.conv2(x)


class TemporalFocalTransformerBlock(nn.Module):
    def __init__(self, cfg: E2FGVIConfig) -> None:
        super().__init__()
        self.window_size = cfg.window_size
        self.norm1 = nn.LayerNorm(cfg.hidden_dim)
        self.attn = WindowAttention(cfg)
        # focal level 2: one pooling layer over a whole window
        self.pool_layers = nn.ModuleList([nn.Linear(cfg.window_size[0] * cfg.window_size[1], 1)])
        self.norm2 = nn.LayerNorm(cfg.hidden_dim)
        self.mlp = FusionFeedForward(cfg)

    def forward(self, x: torch.Tensor, output_size: Tuple[int, int],
                frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, h, w, c = x.shape
        wh, ww = self.window_size
        if h % wh or w % ww:
            raise ValueError(f"the token grid {h}x{w} is not a multiple of the window {wh}x{ww}")
        shortcut = x
        x = self.norm1(x)
        nwh, nww = h // wh, w // ww
        win = x.view(b, t, nwh, wh, nww, ww, c).permute(0, 2, 4, 1, 3, 5, 6)
        win = win.reshape(b, nwh, nww, t, wh * ww, c).transpose(4, 5)     # (B, nWh, nWw, T, C, 45)
        pooled = self.pool_layers[0](win).flatten(-2)                      # (B, nWh, nWw, T, C)
        attn = self.attn(x, pooled, frame_valid)
        x = shortcut + window_reverse(attn.view(-1, t, wh, ww, c), self.window_size, t, h, w)
        y = self.norm2(x)
        return x + self.mlp(y.view(b, t * h * w, c), output_size).view(b, t, h, w, c)


# ----------------------------------------------------------------- generator

class InpaintGenerator(nn.Module):
    def __init__(self, cfg: E2FGVIConfig = E2FGVIConfig()) -> None:
        super().__init__()
        self.cfg = cfg
        ch = cfg.encoder_channels
        self.encoder = Encoder()
        self.decoder = nn.Sequential(
            Deconv(ch, 128), nn.LeakyReLU(0.2),
            nn.Conv2d(128, 64, 3, 1, 1), nn.LeakyReLU(0.2),
            Deconv(64, 64), nn.LeakyReLU(0.2),
            nn.Conv2d(64, 3, 3, 1, 1))
        self.feat_prop_module = BidirectionalPropagation(ch, cfg.deform_groups, cfg.max_residue)
        self.ss = SoftSplit(cfg)
        self.sc = SoftComp(cfg)
        self.transformer = nn.ModuleList([TemporalFocalTransformerBlock(cfg)
                                          for _ in range(cfg.num_blocks)])
        self.update_spynet = SPyNet()


# Each stage on its own, so the check can give a stage the program's own
# inputs; `forward` chains them as e2fgvi_hq.py does.

def flows(net: InpaintGenerator, local01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """forward_bidirect_flow: (B, Lt, 3, H, W) local frames in [0, 1] ->
    (forward, backward) flows (B, Lt-1, 2, H/4, W/4): SPyNet of each frame
    against the next, and of each next frame against its predecessor, at a
    quarter of the resolution (align_corners=True)."""
    b, lt, c, h, w = local01.shape
    small = F.interpolate(local01.reshape(-1, c, h, w), scale_factor=1 / 4, mode="bilinear",
                          align_corners=True, recompute_scale_factor=True)
    small = small.view(b, lt, c, h // 4, w // 4)
    mlf_1 = small[:, :-1].reshape(-1, c, h // 4, w // 4)
    mlf_2 = small[:, 1:].reshape(-1, c, h // 4, w // 4)
    fwd = net.update_spynet(mlf_1, mlf_2).view(b, lt - 1, 2, h // 4, w // 4)
    bwd = net.update_spynet(mlf_2, mlf_1).view(b, lt - 1, 2, h // 4, w // 4)
    return fwd, bwd


def encode(net: InpaintGenerator, frames: torch.Tensor) -> torch.Tensor:
    """(B, T, 3, H, W) -> (B, T, C, H/4, W/4)."""
    b, t = frames.shape[:2]
    enc = net.encoder(frames.flatten(0, 1))
    return enc.view(b, t, *enc.shape[1:])


def propagate(net: InpaintGenerator, local_feat: torch.Tensor, flows_forward: torch.Tensor,
              flows_backward: torch.Tensor, record: Optional[list] = None) -> torch.Tensor:
    """The local frames' features after bidirectional propagation."""
    return net.feat_prop_module(local_feat, flows_backward, flows_forward, record)


def transform(net: InpaintGenerator, enc_feat: torch.Tensor,
              frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, C, h, w) features -> the transformer's (B, T, C, h, w) output
    (soft split, the focal blocks, soft composite), before it is added to
    the features."""
    b, t, c, h, w = enc_feat.shape
    x = net.ss(enc_feat.reshape(-1, c, h, w), b, (h, w))
    for blk in net.transformer:
        x = blk(x, (h, w), frame_valid)
    return net.sc(x, t, (h, w)).view(b, t, c, h, w)


def decode(net: InpaintGenerator, feat: torch.Tensor) -> torch.Tensor:
    """(B, T, C, h, w) -> (B, T, 3, 4h, 4w) frames in [-1, 1] (tanh)."""
    b, t = feat.shape[:2]
    out = torch.tanh(net.decoder(feat.flatten(0, 1)))
    return out.view(b, t, *out.shape[1:])


def forward(net: InpaintGenerator, masked_frames: torch.Tensor, num_local: int,
            frame_valid: Optional[torch.Tensor] = None, record: Optional[list] = None):
    """e2fgvi_hq.py InpaintGenerator.forward: masked frames (B, T, 3, H, W)
    in [-1, 1], the first `num_local` of them local -> ((B, T, 3, H, W)
    frames, (forward, backward) flows of the local frames)."""
    lt = num_local
    fwd, bwd = flows(net, (masked_frames[:, :lt] + 1) / 2)
    enc = encode(net, masked_frames)
    local = propagate(net, enc[:, :lt], fwd, bwd, record)
    enc = torch.cat([local, enc[:, lt:]], dim=1)
    return decode(net, enc + transform(net, enc, frame_valid)), (fwd, bwd)
