"""Global attention's work: a frozen copy of `_attn_bound` of `chip_smoke.py`
(at the commit that added this benchmark), extended by the rel-pos factors
that the global blocks compute before the attention."""

from __future__ import annotations

from typing import Tuple


def attn_bound(bh: int, gh: int, gw: int, d: int, itemsize: int, flop_rate: float,
               bytes_per_s: float) -> Tuple[float, str]:
    """`_attn_bound`: (ms, what bounds it) of softmax(q.k^T + bias).v over
    bh (batch x heads) rows of an (gh, gw) token grid, head size d, with
    the factorised fp32 biases read as inputs."""
    n = gh * gw
    flops = 4 * bh * n * n * d
    bytes_moved = 4 * bh * n * d * itemsize + bh * n * (gh + gw) * 4
    t_ops = flops / flop_rate * 1e3
    t_bytes = bytes_moved / bytes_per_s * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def global_attention_work(b: int, heads: int, gh: int, gw: int, d: int,
                          itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one global block's attention over b frames: the
    rel-pos factors q.R_h and q.R_w (2 * N * (gh + gw) * d a head), q.k^T
    and p.v (4 * N^2 * d a head); q, k and v read once and the output
    written once, in the activations' dtype. The biases and scores are the
    algorithm's intermediates and move no bytes."""
    n = gh * gw
    bh = b * heads
    flops = 4 * bh * n * n * d + 2 * bh * n * (gh + gw) * d
    bytes_moved = 4 * bh * n * d * itemsize
    return float(flops), float(bytes_moved)
