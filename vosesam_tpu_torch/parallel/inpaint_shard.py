"""Inpaint windows data-parallel over ranks (port of
`vosesam_tpu/parallel/inpaint_shard.py`).

The inpaint pipeline's static windows read only the shared padded video and
meet only at compositing, so they split across ranks: a group of dp x
`window_batch` window plans (the tail group padded with its last plan)
gives each rank of the data axis its k = group / dp consecutive windows,
which it runs one at a time through the unbatched generator (B6 on every
alignment), as the JAX package runs one window per chip. An all-gather of
the (k, T, H, W, 3) predictions then gives every rank the group's
predictions, so every rank composites the same video. Weights are
replicated: every rank builds them from the same seed or checkpoint.

Used by `pipeline.inpaint.Inpainter(mesh=...)`.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from vosesam_tpu_torch.parallel import mesh as meshlib


def group_size(mesh: meshlib.Mesh, window_batch: int) -> int:
    """Windows per group: one per rank of the data axis, times `window_batch`."""
    return mesh.data_size * max(1, window_batch)


def sharded_predictions(predict_one: Callable, plans: Sequence, mesh: meshlib.Mesh,
                        window_batch: int) -> List[torch.Tensor]:
    """The predictions of a group of static window plans (at most
    `group_size` of them): padded with the last plan, this rank's
    consecutive share run one at a time through `predict_one(plan)` ->
    (T, H, W, 3), then gathered over the data axis. Returns one prediction
    per real plan, in order, on every rank."""
    n_real = len(plans)
    wb = group_size(mesh, window_batch)
    padded = list(plans) + [plans[-1]] * (wb - n_real)
    k = wb // mesh.data_size
    d = mesh.data_index
    local = torch.stack([predict_one(p) for p in padded[d * k:(d + 1) * k]])
    gathered = torch.cat(meshlib.all_gather_data(local, mesh))
    return list(gathered[:n_real])
