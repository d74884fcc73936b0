"""SAM predictor: preprocess -> encode -> decode (port of
`vosesam_tpu/models/sam/predictor.py`).

`Sam` holds the three official sub-modules (`image_encoder`,
`prompt_encoder`, `mask_decoder`), so an official `sam_vit_*` /
`sam_hq_vit_h` state dict loads into it with `strict=True`. `encode_image`
takes a batch of frames (the chunked path encodes K at once) and returns
an `ImageEmbedding` the caller carries. Points arrive as (..., P, 2) xy in
original-image pixels with labels {-1 pad, 0 neg, 1 pos, 2 / 3 box corners}.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vosesam_tpu_torch.config import SAMConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device
from vosesam_tpu_torch.models.sam import image_encoder, mask_decoder, prompt_encoder
from vosesam_tpu_torch.ops.image import device_const, resize_bilinear, sam_input_resize
from vosesam_tpu_torch.utils import profiling

SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


class Sam(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = image_encoder.ImageEncoderViT(cfg)
        self.prompt_encoder = prompt_encoder.PromptEncoder(cfg)
        self.mask_decoder = mask_decoder.MaskDecoder(cfg)


class ImageEmbedding(NamedTuple):
    embedding: torch.Tensor           # (F, h, w, 256)
    interm: Optional[torch.Tensor]    # (F, h, w, vit_dim) early features (HQ)
    input_hw: Tuple[int, int]         # pre-pad model-input size
    orig_hw: Tuple[int, int]          # original frame size


@torch.no_grad()
def init_like_jax(module: nn.Module, gen: torch.Generator) -> None:
    """Random parameters with the JAX package's SAM init scheme, drawn on
    the generator's device: conv (and conv-transpose) weight
    ~ N(0, 2 / (kh*kw*cout)), bias ~ U(+-1/sqrt(kh*kw*cin)); linear weight and
    bias ~ U(+-1/sqrt(cin)); LayerNorm identity; token / point / mask
    embeddings and the position embedding ~ 0.02 N(0, 1); the Fourier matrix
    ~ N(0, 1); relative-position tables zero. The numbers differ from
    jax.random's, the distributions do not."""
    dev = gen.device

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * std)

    def uniform(t, bound):
        t.copy_((torch.rand(t.shape, generator=gen, device=dev) * 2 - 1) * bound)

    for name, mod in module.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            if isinstance(mod, nn.Conv2d):
                cout, cin, kh, kw = mod.weight.shape
            else:
                cin, cout, kh, kw = mod.weight.shape
            normal(mod.weight, math.sqrt(2.0 / (kh * kw * cout)))
            if mod.bias is not None:
                uniform(mod.bias, 1.0 / math.sqrt(kh * kw * cin))
        elif isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            uniform(mod.weight, bound)
            uniform(mod.bias, bound)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, 0.02)
        elif isinstance(mod, image_encoder.ImageEncoderViT):
            normal(mod.pos_embed, 0.02)
        elif isinstance(mod, image_encoder._Attention):
            mod.rel_pos_h.zero_()
            mod.rel_pos_w.zero_()
        elif isinstance(mod, prompt_encoder._PositionEmbeddingRandom):
            normal(mod.positional_encoding_gaussian_matrix, 1.0)


def sam_init(cfg: SAMConfig, seed: int = 1, device: DeviceLike = None,
             dtype: torch.dtype = torch.float32) -> Sam:
    """SAM with seeded random weights drawn on `device` (default: the card),
    held in `dtype` (cast once)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        sam = Sam(cfg)
    sam = sam.to_empty(device=dev)
    with torch.no_grad():
        for t in list(sam.parameters()) + list(sam.buffers()):
            t.fill_(float("nan"))       # anything the init misses shows up
    init_like_jax(sam, torch.Generator(device=dev).manual_seed(seed))
    return sam.to(dtype).eval()


# ------------------------------------------------------------------ encode

def _pixel_stats(device):
    mean = device_const(("sam_mean",), lambda: np.asarray(SAM_PIXEL_MEAN, np.float32), device)
    std = device_const(("sam_std",), lambda: np.asarray(SAM_PIXEL_STD, np.float32), device)
    return mean, std


def preprocess(img: torch.Tensor, cfg: SAMConfig) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(F, H, W, 3) uint8/float RGB -> normalized, padded model input
    (predictor.py:59-94): the official square, `encode_rect`,
    `encode_fixed_hw` (stretched, no pad) or `encode_letterbox_hw` (fit,
    bottom/right zero pad); the padding is re-zeroed after normalising."""
    x = img.float()
    mean, std = _pixel_stats(x.device)
    if cfg.encode_fixed_hw is not None:
        fh, fw = cfg.encode_fixed_hw
        return (resize_bilinear(x, (fh, fw)) - mean) / std, (fh, fw)
    if cfg.encode_letterbox_hw is not None:
        fh, fw = cfg.encode_letterbox_hw
        h0, w0 = x.shape[-3:-1]
        scale = min(fh / h0, fw / w0)
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        norm = (resize_bilinear(x, (nh, nw)) - mean) / std
        return F.pad(norm, (0, 0, 0, fw - nw, 0, fh - nh)), (nh, nw)
    resized, (h, w) = sam_input_resize(x, cfg.image_size, rect=cfg.encode_rect,
                                       patch=cfg.patch_size)
    ph, pw = resized.shape[-3:-1]
    norm = (resized[..., :h, :w, :] - mean) / std
    return F.pad(norm, (0, 0, 0, pw - w, 0, ph - h)), (h, w)


@torch.no_grad()
def encode_image(sam: Sam, img: torch.Tensor, cfg: SAMConfig) -> ImageEmbedding:
    """(F, H, W, 3) frames -> ImageEmbedding of F frames; compute dtype
    follows the weights."""
    with profiling.span("sam.encode"):
        x, input_hw = preprocess(img, cfg)
        x = x.to(sam.image_encoder.patch_embed.proj.weight.dtype)
        orig_hw = tuple(img.shape[-3:-1])
        if cfg.hq:
            emb, interm = image_encoder.vit_encode(sam.image_encoder, x, return_interm=True)
            return ImageEmbedding(emb, interm[0], tuple(input_hw), orig_hw)
        emb = image_encoder.vit_encode(sam.image_encoder, x)
        return ImageEmbedding(emb, None, tuple(input_hw), orig_hw)


# ------------------------------------------------------------------ decode

def transform_coords(coords: torch.Tensor, orig_hw: Tuple[int, int],
                     cfg: SAMConfig) -> torch.Tensor:
    """Original-image xy -> model-input xy (ResizeLongestSide.apply_coords;
    per-axis stretch under encode_fixed_hw)."""
    h, w = orig_hw
    if cfg.encode_fixed_hw is not None:
        fh, fw = cfg.encode_fixed_hw
        return torch.stack([coords[..., 0] * (fw / w), coords[..., 1] * (fh / h)], dim=-1)
    if cfg.encode_letterbox_hw is not None:
        fh, fw = cfg.encode_letterbox_hw
        return coords * min(fh / h, fw / w)
    return coords * (cfg.image_size / max(h, w))


@torch.no_grad()
def predict_low_res(
    sam: Sam,
    emb: ImageEmbedding,
    coords: torch.Tensor,              # (B, P, 2) original-space xy
    labels: torch.Tensor,              # (B, P)
    mask_input: Optional[torch.Tensor],  # (B, 4h, 4w) logits or None
    cfg: SAMConfig,
    frame_of: Optional[torch.Tensor] = None,   # (B,) frame of each pack
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode without full-resolution postprocessing: (low_res (B, n_tokens,
    4h, 4w) logits, iou (B, n_tokens)), so that callers upsample only the
    token they keep."""
    with profiling.span("sam.decode"):
        grid = tuple(emb.embedding.shape[1:3])
        model_hw = (grid[0] * cfg.patch_size, grid[1] * cfg.patch_size)
        pe = sam.prompt_encoder
        if frame_of is None:
            frame_of = torch.zeros(coords.shape[0], dtype=torch.long, device=coords.device)
        sparse = prompt_encoder.encode_points(
            pe, transform_coords(coords, emb.orig_hw, cfg), labels, model_hw)
        if mask_input is not None:
            dense = prompt_encoder.encode_mask(pe, mask_input)
        else:
            dense = prompt_encoder.no_mask_dense(pe, grid)
        return mask_decoder.decode_masks(
            sam.mask_decoder, emb.embedding, frame_of, prompt_encoder.dense_pe(pe, grid),
            sparse, dense, interm_vit=emb.interm)


class SamPrediction(NamedTuple):
    masks: torch.Tensor        # (..., n, H, W) bool at the original resolution
    logits_full: torch.Tensor  # (..., n, H, W) float logits at the original resolution
    iou: torch.Tensor          # (..., n)
    low_res: torch.Tensor      # (..., n, 4h, 4w) logits (reusable as a mask prompt)


@torch.no_grad()
def predict(
    sam: Sam,
    emb: ImageEmbedding,               # of one frame
    coords: torch.Tensor,              # (P, 2) or (B, P, 2) original-space xy
    labels: torch.Tensor,              # (P,) or (B, P)
    mask_input: Optional[torch.Tensor],  # (4h, 4w) or (B, 4h, 4w) logits, or None
    cfg: SAMConfig,
) -> SamPrediction:
    """One prompt pack -> all mask tokens at the original resolution
    (predictor.py:134-163); callers pick single / multi / HQ with
    `select_best`. With a leading batch axis, B packs on the one frame."""
    single = coords.ndim == 2
    if single:
        coords, labels = coords[None], labels[None]
        mask_input = None if mask_input is None else mask_input[None]
    low_res, iou = predict_low_res(sam, emb, coords, labels, mask_input, cfg)
    logits_full = postprocess_masks(low_res, emb.input_hw, emb.orig_hw)
    pred = SamPrediction(logits_full > cfg.mask_threshold, logits_full, iou, low_res)
    return SamPrediction(*(t[0] for t in pred)) if single else pred


def select_best(pred: SamPrediction, cfg: SAMConfig, multimask: bool):
    """Reference-predictor mask selection on one pack's prediction: token 0
    when single-mask, the best IoU of tokens 1..3 with multimask, the HQ
    token under SAM-HQ (predictor.py:218-235). Returns (mask (H, W) bool,
    logits (H, W), score (), low_res (4h, 4w)); the index stays on the
    device."""
    idx = select_token(pred.iou[None], cfg, multimask)
    return tuple(t.index_select(0, idx)[0] for t in pred)


def postprocess_masks(low_res: torch.Tensor, input_hw: Tuple[int, int],
                      orig_hw: Tuple[int, int]) -> torch.Tensor:
    """Official Sam.postprocess_masks over (..., mh, mw): upsample x4 to the
    model input, crop the un-padded region, resize to the original size."""
    mh, mw = low_res.shape[-2] * 4, low_res.shape[-1] * 4
    up = resize_bilinear(low_res, (mh, mw), axes=(-2, -1))
    up = up[..., : input_hw[0], : input_hw[1]]
    return resize_bilinear(up, orig_hw, axes=(-2, -1))


def select_token(iou: torch.Tensor, cfg: SAMConfig, multimask: bool) -> torch.Tensor:
    """Best-token index per pack (B,): the HQ token under SAM-HQ, the best
    IoU of tokens 1..3 with multimask, else token 0."""
    b = iou.shape[0]
    if cfg.hq:
        return torch.full((b,), mask_decoder.NUM_MASK_TOKENS, dtype=torch.long, device=iou.device)
    if multimask:
        return torch.argmax(iou[:, 1:4], dim=1) + 1
    return torch.zeros((b,), dtype=torch.long, device=iou.device)
