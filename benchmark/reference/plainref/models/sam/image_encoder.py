"""SAM ViT image encoder, plain (frozen from the port's `models/sam/image_encoder.py`).

segment_anything's ImageEncoderViT: patch embed, absolute position embed,
`depth` blocks of windowed attention (global attention at the variant's
global indexes) with decomposed relative-position bias, and the
256-channel neck, under the official checkpoint's module names.

Every attention here is the plain one: the (N, N) bias and scores
materialised, softmax in fp32, no kernel and no tensor parallelism.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from plainref.config import SAMConfig
from plainref.models.layers import gelu_fast, layer_norm, linear
from plainref.ops.image import device_const, resize_bilinear


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, rel_size: int, head_dim: int):
        super().__init__()
        self.heads = heads       # this rank's heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_size, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_size, head_dim))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, rel_size: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _Attention(dim, heads, rel_size, dim // heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _MLP(dim, dim * 4)


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        dim, depth, heads, global_idx = cfg.encoder_dims()
        tokens = cfg.image_size // cfg.patch_size
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg.patch_size, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, tokens, dim))
        self.blocks = nn.ModuleList()
        for i in range(depth):
            glob = i in global_idx
            wsz = tokens if glob else cfg.window_size
            self.blocks.append(_Block(dim, heads, 0 if glob else cfg.window_size, 2 * wsz - 1))
        self.neck = nn.Sequential(
            nn.Conv2d(dim, 256, 1, bias=False), nn.LayerNorm(256),
            nn.Conv2d(256, 256, 3, padding=1, bias=False), nn.LayerNorm(256))


# ------------------------------------------------------------------ attention

def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Relative position embeddings (image_encoder.py:81-104): when the
    table is larger than needed and q_size == k_size (the encode_rect and
    fixed-grid cases), the centre crop of the table, not the official
    interpolation."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        if q_size == k_size and rel_pos.shape[0] > max_rel:
            lo = (rel_pos.shape[0] - max_rel) // 2
            rel_pos = rel_pos[lo: lo + max_rel]
        else:
            rel_pos = resize_bilinear(rel_pos, (max_rel, rel_pos.shape[1]),
                                      axes=(0, 1)).to(rel_pos.dtype)
    def index():
        qc = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
        kc = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
        return ((qc - kc) + (k_size - 1) * max(q_size / k_size, 1.0)).astype(np.int64)

    return rel_pos[device_const(("rel_pos", q_size, k_size), index, rel_pos.device)]


def factorized_rel_pos_bias(q: torch.Tensor, rel_pos_h, rel_pos_w,
                            hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, N, heads, hd) -> fp32 (bias_h (B, heads, N, h), bias_w
    (B, heads, N, w)) with bias[q, k] = bias_h[q, row(k)] + bias_w[q, col(k)]
    (image_encoder.py:107-129)."""
    h, w = hw
    rh = get_rel_pos(h, h, rel_pos_h).float()
    rw = get_rel_pos(w, w, rel_pos_w).float()
    b, _, heads, hd = q.shape
    rq = q.reshape(b, h, w, heads, hd).float()
    bias_h = torch.einsum("bhwnc,hkc->bnhwk", rq, rh)
    bias_w = torch.einsum("bhwnc,wkc->bnhwk", rq, rw)
    return bias_h.reshape(b, heads, h * w, h), bias_w.reshape(b, heads, h * w, w)


def _attention(x: torch.Tensor, attn: _Attention, hw: Tuple[int, int]) -> torch.Tensor:
    """x (B, h, w, C) tokens of B windows or B frames: multi-head attention
    with the decomposed rel-pos bias, scores and softmax in fp32."""
    b, h, w, c = x.shape
    heads = attn.heads
    hd = attn.rel_pos_h.shape[1]
    n = h * w
    qkv = linear(x.reshape(b, n, c), attn.qkv).reshape(b, n, 3, heads, hd)
    q, k, v = qkv.unbind(2)
    bias_h, bias_w = factorized_rel_pos_bias(q, attn.rel_pos_h, attn.rel_pos_w, hw)
    s = torch.einsum("bqnc,bknc->bnqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    s = s + (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, heads, n, n)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnqk,bknc->bqnc", p, v.float()).to(x.dtype).reshape(b, n, c)
    return linear(out, attn.proj).reshape(b, h, w, c)


def window_partition(x: torch.Tensor, wsz: int):
    b, h, w, c = x.shape
    ph, pw = (wsz - h % wsz) % wsz, (wsz - w % wsz) % wsz
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // wsz, wsz, wp // wsz, wsz, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, wsz, wsz, c), (hp, wp)


def window_unpartition(x: torch.Tensor, wsz: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // wsz) * (wp // wsz))
    x = x.reshape(b, hp // wsz, wp // wsz, wsz, wsz, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _block(x: torch.Tensor, blk: _Block, cfg: SAMConfig) -> torch.Tensor:
    shortcut = x
    y = layer_norm(x, blk.norm1)
    if blk.window > 0:
        y, pad_hw = window_partition(y, blk.window)
        y = _attention(y, blk.attn, (blk.window, blk.window))
        y = window_unpartition(y, blk.window, pad_hw, (x.shape[1], x.shape[2]))
    else:
        y = _attention(y, blk.attn, (x.shape[1], x.shape[2]))
    x = shortcut + y
    y = layer_norm(x, blk.norm2)
    return x + linear(gelu_fast(linear(y, blk.mlp.lin1)), blk.mlp.lin2)


def _conv_hwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1)


def vit_encode(enc: ImageEncoderViT, x: torch.Tensor, return_interm: bool = False):
    """x (B, H, W, 3) preprocessed images -> (B, H/16, W/16, 256) embeddings;
    with `return_interm` also the outputs of the global blocks (the SAM-HQ
    decoder uses the first)."""
    cfg = enc.cfg
    y = _conv_hwc(x, enc.patch_embed.proj)
    pe = enc.pos_embed
    gh, gw = y.shape[1], y.shape[2]
    if pe.shape[1] != gh or pe.shape[2] != gw:
        if cfg.encode_fixed_hw is None and pe.shape[1] >= gh and pe.shape[2] >= gw:
            pe = pe[:, :gh, :gw]          # sub-grid: the top-left crop
        else:
            pe = resize_bilinear(pe, (gh, gw), axes=(1, 2))
    y = y + pe.to(y.dtype)
    interm: List[torch.Tensor] = []
    for blk in enc.blocks:
        y = _block(y, blk, cfg)
        if return_interm and blk.window == 0:
            interm.append(y)
    y = _conv_hwc(y, enc.neck[0])
    y = layer_norm(y, enc.neck[1])
    y = _conv_hwc(y, enc.neck[2])
    y = layer_norm(y, enc.neck[3])
    return (y, interm) if return_interm else y
