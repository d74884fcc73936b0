"""FLOPs of one frame's SAM ViT encode: a frozen copy of `encode_flops` of
the port's bench (`vosesam_tpu_torch/bench.py` at the commit that added
this benchmark), taking the encoder's numbers instead of a `SAMConfig`."""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def encode_flops(dim: int, depth: int, heads: int, global_idx: Sequence[int],
                 window_size: int, patch_size: int, windowed_attention_impl: str,
                 grid_hw: Tuple[int, int]) -> float:
    """FLOPs (2 per multiply-add) of one frame's `vit_encode` at a (gh, gw)
    token grid, counted from the algorithm: the patch embed; per block the
    qkv and proj products over its attention's tokens (a windowed block's
    padded windows), the MLP's over the grid's tokens, the rel-pos factors
    q.R_h and q.R_w, QK^T (with the h + w bias lanes the "xla_fused_bias"
    path adds to its contraction, on frames of more than one window) and
    PV; the neck's 1x1 and 3x3 convolutions. Norms, softmax, GELU and adds
    are not counted."""
    hd = dim // heads
    gh, gw = grid_hw
    ws, p = window_size, patch_size
    n_glob = gh * gw
    n_win = math.ceil(gh / ws) * math.ceil(gw / ws)
    flops = 2 * n_glob * dim * 3 * p * p
    for i in range(depth):
        if i in global_idx:
            t, n, bh, bw, lanes = n_glob, n_glob, gh, gw, 0
        else:
            fused = windowed_attention_impl == "xla_fused_bias" and n_win > 1
            t, n, bh, bw = n_win * ws * ws, ws * ws, ws, ws
            lanes = bh + bw if fused else 0
        flops += 2 * t * dim * (3 * dim + dim) + 2 * n_glob * dim * 8 * dim
        flops += 2 * t * heads * hd * (bh + bw)
        flops += 2 * t * heads * n * (hd + lanes) + 2 * t * heads * n * hd
    flops += 2 * n_glob * dim * 256 + 2 * n_glob * 256 * 256 * 9
    return float(flops)


def algorithm_encode_flops(dim: int, depth: int, heads: int, global_idx: Sequence[int],
                           window_size: int, patch_size: int, grid_hw: Tuple[int, int]) -> float:
    """The encode's work as the algorithm states it: `encode_flops` without
    the bias lanes, which are one implementation's way to add the rel-pos
    bias (the plain path adds it as a tensor)."""
    return encode_flops(dim, depth, heads, global_idx, window_size, patch_size, "xla", grid_hw)
