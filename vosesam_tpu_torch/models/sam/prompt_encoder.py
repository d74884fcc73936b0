"""SAM prompt encoder (port of `vosesam_tpu/models/sam/prompt_encoder.py`).

segment_anything's PromptEncoder: random-Fourier positional encoding of
point and box prompts, learned per-label embeddings, and the convolutional
mask-prompt downscaler. Points come as fixed-size packs with labels
  -1 = padding (not-a-point, zero positional encoding), 0 = negative,
   1 = positive, 2 / 3 = box corners,
the official label convention. Module names are the official checkpoint's.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vosesam_tpu_torch.config import SAMConfig
from vosesam_tpu_torch.models.layers import conv2d, layer_norm


class _PositionEmbeddingRandom(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, d // 2))


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.pe_layer = _PositionEmbeddingRandom(d)
        self.point_embeddings = nn.ModuleList([nn.Embedding(1, d) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, 4, 2, stride=2), nn.LayerNorm(4), nn.GELU(),
            nn.Conv2d(4, 16, 2, stride=2), nn.LayerNorm(16), nn.GELU(),
            nn.Conv2d(16, d, 1))


def _pe_encode(coords01: torch.Tensor, gauss: torch.Tensor) -> torch.Tensor:
    """coords in [0, 1] -> random Fourier features (prompt_encoder.py:55-61)."""
    c = 2.0 * coords01.float() - 1.0
    c = torch.matmul(c, gauss.float())
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(pe: PromptEncoder, grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Positional encoding over the embedding grid -> (h, w, 256) fp32."""
    h, w = grid_hw
    g = pe.pe_layer.positional_encoding_gaussian_matrix
    ys = (torch.arange(h, dtype=torch.float32, device=g.device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=g.device) + 0.5) / w
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)   # (h, w, [x, y])
    return _pe_encode(grid, g)


def encode_points(pe: PromptEncoder, coords: torch.Tensor, labels: torch.Tensor,
                  input_hw: Tuple[int, int]) -> torch.Tensor:
    """coords (..., P, 2) xy in model-input pixels, labels (..., P) ->
    (..., P, 256) sparse embeddings; coordinates are normalised by the
    padded model input `input_hw` (official forward_with_coords)."""
    g = pe.pe_layer.positional_encoding_gaussian_matrix
    ih, iw = input_hw
    pts = torch.stack([(coords[..., 0] + 0.5) / iw, (coords[..., 1] + 0.5) / ih], dim=-1)
    enc = _pe_encode(pts, g)
    enc = torch.where((labels == -1)[..., None], torch.zeros((), device=enc.device), enc)
    table = torch.cat([pe.not_a_point_embed.weight] +
                      [pe.point_embeddings[i].weight for i in range(4)], dim=0)
    return enc + table[(labels + 1).long()]


def encode_mask(pe: PromptEncoder, mask: torch.Tensor) -> torch.Tensor:
    """mask (B, 4h, 4w) logits -> (B, h, w, 256) dense embeddings (official
    mask_downscaling: conv-LN-GELU twice, then a 1x1 conv)."""
    md = pe.mask_downscaling

    def ln_chw(y, ln):
        return layer_norm(y.permute(0, 2, 3, 1), ln).permute(0, 3, 1, 2)

    y = mask[:, None]
    y = F.gelu(ln_chw(conv2d(y, md[0]), md[1]))
    y = F.gelu(ln_chw(conv2d(y, md[3]), md[4]))
    return conv2d(y, md[6]).permute(0, 2, 3, 1)


def no_mask_dense(pe: PromptEncoder, grid_hw: Tuple[int, int]) -> torch.Tensor:
    """(h, w, 256) broadcast of the no-mask embedding."""
    wgt = pe.no_mask_embed.weight
    return wgt.reshape(1, 1, -1).expand(grid_hw[0], grid_hw[1], wgt.shape[-1])
