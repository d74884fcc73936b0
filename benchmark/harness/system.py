"""The system under test: the port's `TrackingAnything` facade, built from
a configuration file with the benchmark's own weights."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from harness import configs, seeds, weights

# the reference's modules name the weights; the program loads them as they are
_XMEM_SALT, _SAM_SALT = 11, 12


def reference_modules(cfg: Dict, device: torch.device):
    """Meta-device (XMem, Sam or None) of the plain reference, at `cfg`."""
    from plainref import config as RC
    from plainref.models.sam.predictor import Sam
    from plainref.models.xmem.network import XMem

    fc = configs.framework(cfg, RC)
    with torch.device("meta"):
        net = XMem(fc.xmem)
        sam = Sam(fc.sam) if configs.refines(cfg) else None
    return net, sam


def make_weights(cfg: Dict, seed: int, device: torch.device) -> Dict[str, Optional[Dict]]:
    """{"xmem": state dict (float32), "sam": state dict in the activation
    dtype, or None without refinement}."""
    net, sam = reference_modules(cfg, device)
    out = {"xmem": weights.make(net, seeds.derive(seed, _XMEM_SALT), device, torch.float32),
           "sam": None}
    if sam is not None:
        out["sam"] = weights.make(sam, seeds.derive(seed, _SAM_SALT), device,
                                  getattr(torch, cfg["dtype"]))
    return out


@dataclasses.dataclass
class System:
    cfg: Dict                 # the configuration file
    fcfg: object              # the port's FrameworkConfig
    model: object             # the port's TrackingAnything
    weights: Dict             # the benchmark's state dicts, shared with the reference
    device: torch.device


def build(cfg: Dict, seed: int, device: torch.device, fcfg=None) -> System:
    """The facade as users build it, its loaders handed the benchmark's
    weights (`load_state_dict(strict=True)` into the port's modules)."""
    from vosesam_tpu_torch import config as PC
    from vosesam_tpu_torch.models.sam.predictor import Sam
    from vosesam_tpu_torch.models.xmem.network import XMem
    from vosesam_tpu_torch.pipeline import track_anything as TA

    fcfg = fcfg or configs.framework(cfg, PC)
    w = make_weights(cfg, seed, device)

    def load_xmem(checkpoint, xcfg, device=None, seed=0):
        with torch.device("meta"):
            net = XMem(xcfg)
        net.load_state_dict(w["xmem"], strict=True, assign=True)
        return net.eval(), xcfg

    def load_sam(checkpoint, scfg, device=None, seed=1, dtype=torch.float32):
        with torch.device("meta"):
            sam = Sam(scfg)
        sam.load_state_dict(w["sam"], strict=True, assign=True)
        return sam.eval()

    orig = TA.load_or_init_xmem, TA.load_or_init_sam
    TA.load_or_init_xmem, TA.load_or_init_sam = load_xmem, load_sam
    try:
        model = TA.TrackingAnything(cfg=fcfg, device=device)
    finally:
        TA.load_or_init_xmem, TA.load_or_init_sam = orig
    return System(cfg=cfg, fcfg=fcfg, model=model, weights=w, device=device)
