"""SAM mask decoder with the SAM-HQ variant (port of
`vosesam_tpu/models/sam/mask_decoder.py`).

segment_anything's MaskDecoder / TwoWayTransformer (depth 2) and sam_hq's
MaskDecoderHQ (hf_token, hf_mlp, compress_vit_feat, embedding_encoder,
embedding_maskfeature). Module names are the official checkpoint's. The
attention is plain matmul + fp32 softmax, as the JAX package leaves it to
XLA. Decodes are batched: B prompt packs against F frame embeddings, each
pack naming its frame; the per-frame HQ features are computed once per
frame. Dtypes follow the JAX package's promotion (fp32 prompt tokens meet
the embedding's dtype and win).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vosesam_tpu_torch.config import SAMConfig
from vosesam_tpu_torch.models.layers import conv2d, conv_transpose2d, layer_norm, linear

NUM_MASK_TOKENS = 4  # 1 primary + 3 multimask


class _Attention(nn.Module):
    def __init__(self, dim: int, rate: int, heads: int = 8):
        super().__init__()
        internal = dim // rate
        self.heads = heads
        self.q_proj = nn.Linear(dim, internal)
        self.k_proj = nn.Linear(dim, internal)
        self.v_proj = nn.Linear(dim, internal)
        self.out_proj = nn.Linear(internal, dim)


class _MLP(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))


class _MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)


class _TwoWayLayer(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.self_attn = _Attention(dim, 1)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = _Attention(dim, 2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _MLPBlock(dim, mlp_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = _Attention(dim, 2)
        self.norm4 = nn.LayerNorm(dim)


class _TwoWayTransformer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.layers = nn.ModuleList([_TwoWayLayer(dim, 2048), _TwoWayLayer(dim, 2048)])
        self.final_attn_token_to_image = _Attention(dim, 2)
        self.norm_final_attn = nn.LayerNorm(dim)


def _convt_ln_convt(d_in: int, d_mid: int, d_out: int) -> nn.Sequential:
    return nn.Sequential(nn.ConvTranspose2d(d_in, d_mid, 2, stride=2), nn.LayerNorm(d_mid),
                         nn.GELU(), nn.ConvTranspose2d(d_mid, d_out, 2, stride=2))


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.hq = cfg.hq
        n_tokens = NUM_MASK_TOKENS + (1 if cfg.hq else 0)
        self.transformer = _TwoWayTransformer(d)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(NUM_MASK_TOKENS, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), nn.LayerNorm(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            _MLP((d, d, d, d // 8)) for _ in range(NUM_MASK_TOKENS))
        self.iou_prediction_head = _MLP((d, d, d, n_tokens))
        if cfg.hq:
            vit_dim = cfg.encoder_dims()[0]
            self.hf_token = nn.Embedding(1, d)
            self.hf_mlp = _MLP((d, d, d, d // 8))
            self.compress_vit_feat = _convt_ln_convt(vit_dim, d, d // 8)
            self.embedding_encoder = _convt_ln_convt(d, d // 4, d // 8)
            self.embedding_maskfeature = nn.Sequential(
                nn.Conv2d(d // 8, d // 4, 3, padding=1), nn.LayerNorm(d // 4), nn.GELU(),
                nn.Conv2d(d // 4, d // 8, 3, padding=1))


# ------------------------------------------------------------------ forward

def _common(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _attn(q, k, v, p: _Attention):
    """Multi-head attention over (B, T, C) with projection to the internal
    dim (mask_decoder.py:132-146): fp32 logits and softmax, probabilities
    cast to v's dtype."""
    qp, kp, vp = linear(q, p.q_proj), linear(k, p.k_proj), linear(v, p.v_proj)
    b, tq, internal = qp.shape
    hd = internal // p.heads
    qh = qp.reshape(b, tq, p.heads, hd)
    kh = kp.reshape(b, kp.shape[1], p.heads, hd)
    vh = vp.reshape(b, vp.shape[1], p.heads, hd)
    qh, kh = _common(qh, kh)
    logits = torch.einsum("bqnc,bknc->bnqk", qh.float(), kh.float()) / math.sqrt(hd)
    w = torch.softmax(logits, dim=-1).to(vh.dtype)
    out = torch.einsum("bnqk,bknc->bqnc", w, vh).reshape(b, tq, internal)
    return linear(out, p.out_proj)


def _mlp(x, mlp: _MLP):
    n = len(mlp.layers)
    for i, lin in enumerate(mlp.layers):
        x = linear(x, lin)
        if i < n - 1:
            x = torch.relu(x)
    return x


def two_way_transformer(t: _TwoWayTransformer, keys, key_pe, point_embedding):
    """keys (B, hw, C), key_pe (hw, C), point_embedding (B, T, C) ->
    (queries, keys) (mask_decoder.py:159-197)."""
    queries = point_embedding
    for i, lp in enumerate(t.layers):
        if i == 0:
            queries = _attn(queries, queries, queries, lp.self_attn)
        else:
            q = queries + point_embedding
            queries = queries + _attn(q, q, queries, lp.self_attn)
        queries = layer_norm(queries, lp.norm1)
        q = queries + point_embedding
        k = keys + key_pe
        queries = queries + _attn(q, k, keys, lp.cross_attn_token_to_image)
        queries = layer_norm(queries, lp.norm2)
        queries = queries + linear(torch.relu(linear(queries, lp.mlp.lin1)), lp.mlp.lin2)
        queries = layer_norm(queries, lp.norm3)
        q = queries + point_embedding
        k = keys + key_pe
        keys = keys + _attn(k, q, queries, lp.cross_attn_image_to_token)
        keys = layer_norm(keys, lp.norm4)
    q = queries + point_embedding
    k = keys + key_pe
    queries = queries + _attn(q, k, keys, t.final_attn_token_to_image)
    queries = layer_norm(queries, t.norm_final_attn)
    return queries, keys


def _ln_chw(y, ln):
    return layer_norm(y.permute(0, 2, 3, 1), ln).permute(0, 3, 1, 2)


def _convt_ln_gelu_convt(x, seq: nn.Sequential):
    """(N, C, h, w) -> (N, C', 4h, 4w): ConvT-LN-GELU-ConvT."""
    y = F.gelu(_ln_chw(conv_transpose2d(x, seq[0]), seq[1]))
    return conv_transpose2d(y, seq[3])


def decode_masks(
    dec: MaskDecoder,
    image_embedding: torch.Tensor,   # (F, h, w, C)
    frame_of: torch.Tensor,          # (B,) long: frame index of each pack
    image_pe: torch.Tensor,          # (h, w, C)
    sparse_prompt: torch.Tensor,     # (B, P, C)
    dense_prompt: torch.Tensor,      # (B, h, w, C) or (h, w, C) shared
    interm_vit: Optional[torch.Tensor] = None,   # (F, h, w, vit_dim), HQ
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (masks (B, n_tokens, 4h, 4w) fp32 logits, iou (B, n_tokens)).
    Token 0 is the single-mask output, 1..3 the multimask outputs, 4 (HQ
    only) the high-quality output (mask_decoder.py:214-278)."""
    f, h, w, c = image_embedding.shape
    b = sparse_prompt.shape[0]
    toks = [dec.iou_token.weight, dec.mask_tokens.weight]
    if dec.hq:
        toks.append(dec.hf_token.weight)
    output_tokens = torch.cat(toks, dim=0)
    n_tokens = output_tokens.shape[0] - 1
    tokens = torch.cat(_common(output_tokens[None].expand(b, -1, -1), sparse_prompt), dim=1)

    emb_b = image_embedding.index_select(0, frame_of)
    src = emb_b + dense_prompt
    hs, src_out = two_way_transformer(dec.transformer, src.reshape(b, h * w, c),
                                      image_pe.reshape(h * w, c), tokens)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1:1 + n_tokens]

    src_img = src_out.reshape(b, h, w, c).permute(0, 3, 1, 2)
    up = dec.output_upscaling
    upscaled = F.gelu(_ln_chw(conv_transpose2d(src_img, up[0]), up[1]))
    upscaled = F.gelu(conv_transpose2d(upscaled, up[3]))               # (B, C/8, 4h, 4w)

    hyper = [_mlp(mask_tokens_out[:, i], dec.output_hypernetworks_mlps[i])
             for i in range(NUM_MASK_TOKENS)]
    if dec.hq:
        hyper.append(_mlp(mask_tokens_out[:, NUM_MASK_TOKENS], dec.hf_mlp))
    hyper_in = torch.stack(hyper, dim=1)                             # (B, n_tokens, C/8)

    _, uc, uh, uw = upscaled.shape
    masks = torch.einsum("btc,bcp->btp", hyper_in[:, :NUM_MASK_TOKENS].float(),
                         upscaled.reshape(b, uc, uh * uw).float())
    masks = masks.reshape(b, NUM_MASK_TOKENS, uh, uw)
    if dec.hq:
        if interm_vit is None:
            raise ValueError("SAM-HQ decoding needs the early ViT features")
        hq_feat = (_convt_ln_gelu_convt(image_embedding.permute(0, 3, 1, 2),
                                        dec.embedding_encoder)
                   + _convt_ln_gelu_convt(interm_vit.permute(0, 3, 1, 2),
                                          dec.compress_vit_feat))       # (F, C/8, 4h, 4w)
        mf = dec.embedding_maskfeature
        up_hq = F.gelu(_ln_chw(conv2d(upscaled, mf[0]), mf[1]))
        up_hq = conv2d(up_hq, mf[3]) + hq_feat.index_select(0, frame_of)
        mask_hq = torch.einsum("bc,bcp->bp", hyper_in[:, NUM_MASK_TOKENS].float(),
                               up_hq.reshape(b, uc, uh * uw).float())
        masks = torch.cat([masks, mask_hq.reshape(b, 1, uh, uw)], dim=1)
    iou_pred = _mlp(iou_token_out, dec.iou_prediction_head)
    return masks, iou_pred
