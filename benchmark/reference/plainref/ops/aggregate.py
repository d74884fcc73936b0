"""STM soft-aggregation of per-object probabilities (port of
`vosesam_tpu/ops/aggregate.py`).

Reference: tracker/model/aggregate.py:6-17 — background = prod(1 - p_i), all
(bg + N) channels go through a logit transform and a softmax. Padded objects
contribute p = 0 and get -1e9 logits. The clips are `clip`, whose
gradient at a bound is JAX's (`jnp.clip` is a maximum and a minimum, each
splitting a tie's gradient in half; `torch.clamp` passes all of it), so a
trainer differentiates saturated probabilities as the JAX trainer does.
"""

from __future__ import annotations

from typing import Optional

import torch


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)`: the values of `torch.clamp`, and half the
    gradient where x equals a bound."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def soft_aggregate(
    prob: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    dim: int = 0,
    return_logits: bool = False,
    eps: float = 1e-7,
):
    """prob: (N, ...) fg probabilities; valid: optional (N,) bool.

    Returns the (1+N, ...) distribution (background first), and the logits
    if requested. Always fp32."""
    prob = prob.float()
    v = None
    if valid is not None:
        vshape = [1] * prob.ndim
        vshape[dim] = prob.shape[dim]
        v = valid.reshape(vshape)
        prob = torch.where(v, prob, torch.zeros((), device=prob.device))

    bg = torch.prod(clip(1.0 - prob, eps, 1.0), dim=dim, keepdim=True)
    stacked = torch.cat([bg, prob], dim=dim)
    clipped = clip(stacked, eps, 1.0 - eps)
    logits = torch.log(clipped) - torch.log1p(-clipped)
    if v is not None:
        vfull = torch.cat([torch.ones_like(v[:1]), v], dim=dim)
        logits = torch.where(vfull, logits, torch.full((), -1e9, device=logits.device))
    out = torch.softmax(logits, dim=dim)
    if return_logits:
        return out, logits
    return out
