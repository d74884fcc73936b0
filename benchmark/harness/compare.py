"""The numbers that decide `correct`, each a gap between two readings of
the same call: the program's (or the control's) and the float32
reference's."""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def relerr(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = _t(a).double(), _t(b).to(_t(a).device).double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def mismatch(a, b) -> float:
    """Share of entries that differ."""
    a, b = _t(a), _t(b).to(_t(a).device)
    return float((a.long() != b.long()).double().mean())


def maxgap(a, b) -> float:
    a, b = _t(a).double(), _t(b).to(_t(a).device).double()
    return float((a - b).abs().max()) if a.numel() else 0.0
