"""SAM ViT image encoder (port of `vosesam_tpu/models/sam/image_encoder.py`).

segment_anything's ImageEncoderViT: patch embed, absolute position embed,
`depth` blocks of 14x14 windowed attention (global attention at the
variant's global indexes) with decomposed relative-position bias, and the
256-channel neck. Module names are the official checkpoint's
(`image_encoder.blocks.N.attn.qkv`, `.rel_pos_h`, `neck.0`, ...).

Activations are channel-last (B, H, W, C), as in the JAX package; the
encoder takes a batch of frames. The global blocks run kernel B3
(`ops/kernels/flash_attention.py`) whenever `use_flash_attention` is set,
at any batch and any N; with it off they run the kernel's plain version.
The windowed blocks follow `windowed_attention_impl`: "pallas" and
"pallas_mh" run kernels B4 / B5 (`ops/kernels/window_attention.py`: fp32
rel-pos factors, then the whole-window kernel on the strided q, k, v views
of the fused qkv projection); the default "xla_fused_bias" is plain torch,
as it is an XLA path in JAX: one QK matmul in the activations' dtype with
the rel-pos bias folded in as extra lanes, fp32 softmax, cast to v's dtype,
matmul; "xla" keeps fp32 scores and a broadcast bias add. As in JAX, a
frame that is a single window takes the "xla" path whatever the impl.

An encoder sharded by `parallel/mesh.py:shard_sam_params_tp` holds a
slice of each block's heads and MLP width: its attention and kernels run
on the local heads, and proj and lin2 are summed over the model group.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from vosesam_tpu_torch.config import SAMConfig
from vosesam_tpu_torch.models.layers import gelu_fast, layer_norm, linear
from vosesam_tpu_torch.ops.image import device_const, resize_bilinear
from vosesam_tpu_torch.ops.kernels import flash_attention as fa
from vosesam_tpu_torch.ops.kernels import window_attention as wa


class _Attention(nn.Module):
    tp_group = None      # the model group of a tensor-parallel encoder

    def __init__(self, dim: int, heads: int, rel_size: int, head_dim: int):
        super().__init__()
        self.heads = heads       # this rank's heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_size, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_size, head_dim))


class _MLP(nn.Module):
    tp_group = None

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


def _row_parallel(x: torch.Tensor, lin: nn.Linear, group) -> torch.Tensor:
    """`linear` of a row-parallel layer: this rank's partial product, summed
    over the model group by one all-reduce, the bias added once after it.
    Without a group, `linear` itself (the unsharded encoder's ops)."""
    if group is None:
        return linear(x, lin)
    y = F.linear(x, lin.weight.to(x.dtype))
    dist.all_reduce(y, group=group)
    return y + lin.bias.to(y.dtype)


def _attention(x: torch.Tensor, attn: _Attention, hw: Tuple[int, int],
               global_block: bool, cfg: SAMConfig,
               windows_per_frame: Optional[int] = None) -> torch.Tensor:
    """x (B, h, w, C) tokens of B windows (windowed) or B frames (global).
    `windows_per_frame` (default: all B windows are one frame's) picks the
    windowed path per frame, as JAX does under `vmap`: a frame of one window
    keeps fp32 scores ("xla") whatever the impl (image_encoder.py:150-225).
    Under tensor parallelism `attn` holds this rank's heads: the attention
    runs on them at the local width heads·hd, and proj sums over ranks."""
    b, h, w, c = x.shape
    heads = attn.heads
    hd = attn.rel_pos_h.shape[1]
    cl = heads * hd
    n = h * w
    qkv = linear(x.reshape(b, n, c), attn.qkv).reshape(b, n, 3, heads, hd)
    q, k, v = qkv.unbind(2)
    if global_block:
        bias_h, bias_w = factorized_rel_pos_bias(q, attn.rel_pos_h, attn.rel_pos_w, hw)
        # the strided (b, heads, n, hd) views of the fused projection, as they are
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                bias_h.contiguous(), bias_w.contiguous(), hw)
        if cfg.use_flash_attention:
            out = fa.flash_attention_relpos(*args)
        else:
            out = fa.flash_attention_relpos_plain(*args)
        return _row_parallel(out.transpose(1, 2).reshape(b, n, cl), attn.proj,
                             attn.tp_group).reshape(b, h, w, c)
    impl = cfg.windowed_attention_impl
    if (b if windows_per_frame is None else windows_per_frame) == 1:
        impl = "xla"
    if impl in ("pallas", "pallas_mh"):
        bias_h, bias_w = factorized_rel_pos_bias(q, attn.rel_pos_h, attn.rel_pos_w, hw)
        kernel = (wa.window_attention_relpos_mh if impl == "pallas_mh"
                  else wa.window_attention_relpos)
        out = kernel(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     bias_h.contiguous(), bias_w.contiguous(), hw)     # (b, heads, n, hd)
        return _row_parallel(out.transpose(1, 2).reshape(b, n, cl), attn.proj,
                             attn.tp_group).reshape(b, h, w, c)
    scale = 1.0 / math.sqrt(hd)
    if impl == "xla_fused_bias":
        s = _fused_bias_scores(q, k, attn, hw, scale)
    else:
        bias_h, bias_w = factorized_rel_pos_bias(q, attn.rel_pos_h, attn.rel_pos_w, hw)
        s = torch.einsum("bqnc,bknc->bnqk", q.float(), k.float()) * scale
        s = s + (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, heads, n, n)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bnqk,bknc->bqnc", p, v).reshape(b, n, cl)
    return _row_parallel(out, attn.proj, attn.tp_group).reshape(b, h, w, c)


def _fused_bias_scores(q: torch.Tensor, k: torch.Tensor, attn: _Attention,
                       hw: Tuple[int, int], scale: float) -> torch.Tensor:
    """Windowed scores as the JAX default "xla_fused_bias" computes them
    (image_encoder.py:174-221): the rel-pos bias rides the QK product as
    extra lanes, [q*scale | q.rh | q.rw] . [k | onehot(row) | onehot(col)],
    all in q's dtype. In bf16 the operands are bf16, the products accumulate
    in fp32, and q*scale, the two bias factors and the scores are each
    rounded to bf16 once, where JAX rounds them. Returns (b, heads, N, N)."""
    b, n, heads, hd = q.shape
    h, w = hw
    dt = q.dtype
    rh = get_rel_pos(h, h, attn.rel_pos_h).to(dt)          # (h, h, hd)
    rw = get_rel_pos(w, w, attn.rel_pos_w).to(dt)          # (w, w, hd)
    rq = q.reshape(b, h, w, heads, hd)
    scale_dt = torch.tensor(scale, dtype=dt).item()        # JAX scales by dt(scale)
    qp = torch.cat([
        q * scale_dt,
        torch.einsum("bhwnc,hkc->bhwnk", rq, rh).reshape(b, n, heads, h),
        torch.einsum("bhwnc,wkc->bhwnk", rq, rw).reshape(b, n, heads, w),
    ], dim=-1)

    def onehot():
        idx = np.arange(n)
        eye = np.concatenate([np.eye(h, dtype=np.float32)[idx // w],
                              np.eye(w, dtype=np.float32)[idx % w]], axis=1)
        return torch.from_numpy(eye).to(dt)                # (N, h + w)

    e = device_const(("rowcol_onehot", h, w, str(dt)), onehot, q.device)
    kp = torch.cat([k, e[None, :, None, :].expand(b, n, heads, h + w)], dim=-1)
    return torch.einsum("bqnc,bknc->bnqk", qp, kp)


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
        y = _attention(y, blk.attn, (blk.window, blk.window), False, cfg,
                       windows_per_frame=y.shape[0] // x.shape[0])
        y = window_unpartition(y, blk.window, pad_hw, (x.shape[1], x.shape[2]))
    else:
        y = _attention(y, blk.attn, (x.shape[1], x.shape[2]), True, cfg)
    x = shortcut + y
    y = layer_norm(x, blk.norm2)
    return x + _row_parallel(gelu_fast(linear(y, blk.mlp.lin1)), blk.mlp.lin2,
                             blk.mlp.tp_group)


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
