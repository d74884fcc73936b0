"""E2FGVI training losses (port of `vosesam_tpu/models/e2fgvi/losses.py`).

Reference: inpainter/model/modules/flow_comp.py:11-46 `FlowCompletionLoss`,
the only inpainter training loss the reference ships. The ground-truth
flows come from a frozen SPyNet (the reference's own copy, flow_comp.py:15-17)
under `torch.no_grad()`, never from the generator's trained
`update_spynet`; both sides go through the generator's `quarter_flows`, so
they resize alike.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vosesam_tpu_torch.models.e2fgvi import modules as M
from vosesam_tpu_torch.models.e2fgvi.generator import quarter_flows


@torch.no_grad()
def _quarter_flows(spynet: M.SPyNet, frames01: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, H, W, 3) frames in [0, 1] -> (forward, backward) 1/4-res flows
    (T-1, H/4, W/4, 2), as `generator_forward` computes its own."""
    fwd, bwd = quarter_flows(spynet, frames01[None])
    return fwd[0], bwd[0]


def flow_completion_loss(
    frozen_spynet: M.SPyNet,
    pred_flows: Tuple[torch.Tensor, torch.Tensor],   # (fwd, bwd) (T-1, h/4, w/4, 2)
    gt_local_frames01: torch.Tensor,                 # (T, H, W, 3) in [0, 1]
) -> torch.Tensor:
    """L1 between the generator's completed flows and the frozen SPyNet's
    flows of the unmasked frames (flow_comp.py:21-46)."""
    gt_fwd, gt_bwd = _quarter_flows(frozen_spynet, gt_local_frames01)
    return (torch.mean(torch.abs(pred_flows[0] - gt_fwd))
            + torch.mean(torch.abs(pred_flows[1] - gt_bwd)))
