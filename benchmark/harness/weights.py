"""Random weights under the official state-dict names, made on the device
from the run's seed in a few large calls: one normal draw for the whole
state dict, scaled and shifted per tensor by two `repeat_interleave`d
vectors, then cast to the type the weights are served in.

Per tensor: batch-norm running statistics and every 1-D `.weight` (a norm's
scale) are the identity; biases, position tables and rel-pos tables are
N(0, 0.02); SAM's Fourier matrix is N(0, 1), as the official init draws
it; every other matrix or convolution weight is N(0, 1 / (3 fan_in)), the
variance of PyTorch's default init for linear and convolution layers. (He's
N(0, 2 / fan_in) grows XMem's residual trunks, whose batch norms sit at the
identity, to activations of ~1e6, where the fusion blocks' attention gates
act as steps that a rounding flips.) The names and shapes come from the plain reference's
modules, built on the meta device, so the program must accept them as
they are (`load_state_dict(strict=True)`)."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_ZERO_ONE = (0.0, 0.0)


def _stats(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of one tensor's entries."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_mean":
        return _ZERO_ONE
    if leaf == "running_var":
        return (1.0, 0.0)
    if leaf == "positional_encoding_gaussian_matrix":
        return (0.0, 1.0)
    if leaf in ("pos_embed", "rel_pos_h", "rel_pos_w") or leaf == "bias" or len(shape) < 2:
        return (1.0, 0.0) if leaf == "weight" else (0.0, 0.02)
    return (0.0, math.sqrt(1.0 / (3.0 * math.prod(shape[1:]))))


def make(module_meta: torch.nn.Module, seed: int, device: torch.device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A state dict for `module_meta`'s names and shapes, floats in
    `dtype`, on `device`."""
    spec = module_meta.state_dict()
    floats = [(k, tuple(v.shape)) for k, v in spec.items() if v.dtype.is_floating_point]
    sizes = [math.prod(s) for _, s in floats]
    total = sum(sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    stats = torch.tensor([_stats(k, s) for k, s in floats], dtype=torch.float32)
    counts = torch.tensor(sizes, dtype=torch.long)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(torch.repeat_interleave(stats[:, 1].to(device), counts.to(device),
                                      output_size=total))
    flat.add_(torch.repeat_interleave(stats[:, 0].to(device), counts.to(device),
                                      output_size=total))
    flat = flat.to(dtype)
    out: Dict[str, torch.Tensor] = {}
    for (k, s), part in zip(floats, torch.split(flat, sizes)):
        out[k] = part.view(s)
    for k, v in spec.items():
        if not v.dtype.is_floating_point:       # num_batches_tracked
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return {k: out[k] for k in spec}
