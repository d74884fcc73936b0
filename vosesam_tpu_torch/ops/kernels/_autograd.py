"""B1-B5 and B7's wrappers compute forward passes only: each writes a fresh
tensor through ctypes, so autograd sees no graph through a launch. Rather
than hand back a result that silently carries no gradient, such a wrapper
calls `refuse_grad` on its CUDA branch and raises when autograd would want
one. The plain PyTorch versions (the CPU branch) stay differentiable. B6
(`deform_align.DeformPatches`) has a backward kernel and needs no refusal."""

from __future__ import annotations

import torch


def refuse_grad(fn: str, *tensors) -> None:
    """Raise if grad mode is on and any tensor among `tensors` (None and
    non-tensors are skipped) requires grad."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                f"{fn}: the CUDA kernel has no backward; call it under torch.no_grad() "
                f"or with inputs that do not require grad")
