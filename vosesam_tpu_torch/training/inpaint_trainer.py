"""E2FGVI inpainter training step: generator and T-PatchGAN (port of
`vosesam_tpu/training/inpaint_trainer.py`).

The reference ships the training-only modules (the spectral-norm
Discriminator, inpainter/model/e2fgvi_hq.py:271-344, and
FlowCompletionLoss, inpainter/model/modules/flow_comp.py:11-46) but no
trainer. This runs the JAX package's recipe:

  gen loss  = hole L1 + valid L1 + flow-completion L1 + adversarial (hinge)
  disc loss = hinge real / fake on the composited video, spectral norm's
              power iteration once on the real pass and again on the fake

The alternation is simultaneous: the generator's gradients use the current
discriminator (its stored u and v, not iterated), the discriminator's use
the detached composite. Both optimizers are optax's `adam(1e-4, b1=0,
b2=0.99)` in torch arithmetic (`trainer.adam_update`); u and v are buffers,
with no gradient and no Adam update. The networks are trained in place.
On the card the generator's deformable alignments run the B6 kernel forward
(again under remat's recompute) and its backward kernel. Its focal blocks'
LayerNorms run the plain fp32 chain here: `models/layers.layer_norm` takes
its kernel, which has no backward, only where no tensor requires grad.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vosesam_tpu_torch.config import InpainterConfig
from vosesam_tpu_torch.models.e2fgvi import discriminator as D
from vosesam_tpu_torch.models.e2fgvi import generator as G
from vosesam_tpu_torch.models.e2fgvi import modules as M
from vosesam_tpu_torch.models.e2fgvi.losses import flow_completion_loss
from vosesam_tpu_torch.training.trainer import adam_update


@dataclasses.dataclass(frozen=True)
class InpaintTrainConfig:
    lr: float = 1e-4                  # upstream E2FGVI Adam(1e-4, (0, 0.99))
    beta1: float = 0.0
    beta2: float = 0.99
    hole_weight: float = 1.0
    valid_weight: float = 1.0
    flow_weight: float = 1.0
    adversarial_weight: float = 0.01
    # stage-level remat of the generator in its backward pass
    # (generator_forward(remat=...)): activations recomputed, not kept
    remat: bool = True


@dataclasses.dataclass
class AdamState:
    """optax adam's state per leaf name: moments and the step count."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0

    @classmethod
    def zeros(cls, net: torch.nn.Module) -> "AdamState":
        leaves = dict(net.named_parameters())
        return cls({k: torch.zeros_like(v) for k, v in leaves.items()},
                   {k: torch.zeros_like(v) for k, v in leaves.items()})


@dataclasses.dataclass
class InpaintTrainState:
    gen: G.InpaintGenerator
    disc: D.Discriminator
    gen_opt: AdamState
    disc_opt: AdamState
    it: int
    # The flow-completion loss's frozen pretrained SPyNet (flow_comp.py:15-17
    # holds its own copy): never the generator's trained update_spynet, which
    # would let the target drift toward its own prediction.
    spynet_frozen: M.SPyNet


def init_train_state(gen: G.InpaintGenerator, disc: D.Discriminator,
                     tcfg: InpaintTrainConfig = InpaintTrainConfig(),
                     spynet_frozen: Optional[M.SPyNet] = None) -> InpaintTrainState:
    """`spynet_frozen` should hold the pretrained SPyNet weights; by default
    a copy of the generator's SPyNet now (right when `gen` was just loaded
    from the pretrained checkpoint)."""
    del tcfg                     # the recipe's optimizer state has no knobs
    if spynet_frozen is None:
        spynet_frozen = copy.deepcopy(gen.update_spynet)
    spynet_frozen.requires_grad_(False)
    return InpaintTrainState(gen, disc, AdamState.zeros(gen), AdamState.zeros(disc), 0,
                             spynet_frozen)


def _masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The torch recipe's l1_loss(pred * mask, gt * mask) / mean(mask): both
    means over their own element counts, so the broadcast channel axis
    cancels."""
    return torch.mean(torch.abs(pred - target) * mask) / torch.clamp(torch.mean(mask), min=1e-8)


def generator_loss(state: InpaintTrainState, frames: torch.Tensor, masks: torch.Tensor,
                   num_local: int, cfg: InpainterConfig, tcfg: InpaintTrainConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """(total, its parts, the composite video) of the generator's loss."""
    masked = frames * (1.0 - masks)
    pred, pred_flows = G.generator_forward(state.gen, masked, num_local, cfg, remat=tcfg.remat)
    comp = frames * (1.0 - masks) + pred * masks
    hole = _masked_l1(pred, frames, masks)
    valid = _masked_l1(pred, frames, 1.0 - masks)
    # ground-truth flows of the unmasked local frames, mapped to [0, 1]
    flow = flow_completion_loss(state.spynet_frozen, pred_flows,
                                (frames[:num_local] + 1.0) / 2.0)
    adv = -torch.mean(D.discriminator_forward(state.disc, comp[None]))   # hinge
    total = (tcfg.hole_weight * hole + tcfg.valid_weight * valid
             + tcfg.flow_weight * flow + tcfg.adversarial_weight * adv)
    parts = {"hole_l1": hole, "valid_l1": valid, "flow_l1": flow, "gen_adv": adv,
             "gen_total": total}
    return total, parts, comp


def discriminator_loss(state: InpaintTrainState, frames: torch.Tensor, comp: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, real term, fake term) of the hinge loss. The real pass
    iterates spectral norm's vectors and the fake pass iterates again from
    there, as torch's hook does on every train-mode forward."""
    d_real = D.discriminator_forward(state.disc, frames[None], update_sn=True)
    d_fake = D.discriminator_forward(state.disc, comp.detach()[None], update_sn=True)
    real = torch.mean(F.relu(1.0 - d_real))
    fake = torch.mean(F.relu(1.0 + d_fake))
    return (real + fake) / 2.0, real, fake


def _grads(loss: torch.Tensor, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d loss / d leaf by name; zeros for a leaf the loss does not reach
    (as jax.grad gives them)."""
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), gs)}


def step_gradients(state: InpaintTrainState, frames: torch.Tensor, masks: torch.Tensor,
                   num_local: int, cfg: InpainterConfig, tcfg: InpaintTrainConfig
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """(generator gradients, discriminator gradients, metrics) of one step,
    by parameter name. Advances the discriminator's u and v."""
    gen_leaves = dict(state.gen.named_parameters())
    disc_leaves = dict(state.disc.named_parameters())
    gen_total, metrics, comp = generator_loss(state, frames, masks, num_local, cfg, tcfg)
    gen_grads = _grads(gen_total, gen_leaves)
    disc_total, real, fake = discriminator_loss(state, frames, comp)
    disc_grads = _grads(disc_total, disc_leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update(disc_total=disc_total.detach(), disc_real=real.detach(),
                   disc_fake=fake.detach())
    return gen_grads, disc_grads, metrics


def apply_adam(net: torch.nn.Module, opt: AdamState, grads: Dict[str, torch.Tensor],
               tcfg: InpaintTrainConfig) -> None:
    """One optax.adam(lr, b1, b2) step of `net`'s parameters, in place."""
    opt.count += 1
    adam_update(dict(net.named_parameters()), grads, opt.mu, opt.nu, opt.count, tcfg.lr,
                tcfg.beta1, tcfg.beta2)


def train_step(
    state: InpaintTrainState,
    frames: torch.Tensor,       # (T, H, W, 3) ground truth in [-1, 1]
    masks: torch.Tensor,        # (T, H, W, 1) 1 = hole to inpaint
    num_local: int,
    cfg: InpainterConfig,
    tcfg: InpaintTrainConfig,
) -> Tuple[InpaintTrainState, Dict[str, torch.Tensor]]:
    """One simultaneous GAN step, in place on `state`: both networks' Adam
    steps from the gradients of `step_gradients`. Returns the state and the
    losses (hole_l1, valid_l1, flow_l1, gen_adv, gen_total, disc_total,
    disc_real, disc_fake)."""
    gen_grads, disc_grads, metrics = step_gradients(state, frames, masks, num_local, cfg, tcfg)
    apply_adam(state.gen, state.gen_opt, gen_grads, tcfg)
    apply_adam(state.disc, state.disc_opt, disc_grads, tcfg)
    state.it += 1
    return state, metrics
