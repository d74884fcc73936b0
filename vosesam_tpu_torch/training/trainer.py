"""XMem trainer: multi-frame unrolled memory-attention training (port of
`vosesam_tpu/training/trainer.py`).

Reference: tracker/model/trainer.py — a vestigial torch loop with DDP + AMP
whose imports are broken (trainer.py:15-16, SURVEY.md §2.3). This one runs
the JAX package's recipe: an unrolled clip (do_pass :55-117) where frame 0
is ground truth and later frames read the accumulated in-clip memory with
the train-time full softmax affinity (network.py:89-105: no top-k, so no
memory-read kernel), per-frame bootstrapped CE + dice losses, and one
optimizer step of the JAX package's optax chain written out in torch
arithmetic with the same numbers:

  clip_by_global_norm(3.0)   g * (max / ‖g‖) only when ‖g‖ >= max
                             (no +1e-6 as `clip_grad_norm_` adds);
  adamw                      optax's defaults: b1 0.9, b2 0.999, eps 1e-8,
                             decoupled decay 0.05 on every leaf;
  piecewise_constant         lr x 0.1 once the step count reaches 80 000,
                             again at 100 000.

The JAX package's batch norms read their running statistics as leaves of
the parameter tree (`models/layers.py:batch_norm`), so its trainer
differentiates and updates them like every other leaf; here they are
buffers of `nn.BatchNorm2d`, and `init_train_state` makes them trained
tensors too (`trained_leaves`). Per-frame remat is
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`; gradient
accumulation runs sequential microbatches. Checkpoints are `torch.save`
files holding the official-name XMem state dict under "network" (so
`TrackingAnything(xmem_checkpoint=...)` loads them), `it` and the
optimizer state.

Data parallelism (the JAX trainer's contract: shard the clip batch over the
mesh's data axis, the gradient all-reduce inserted by jit): `train_step(...,
mesh=)` takes the global batch, the same on every rank; each rank computes
the gradients of its B / data-size clips (`grad_accum` microbatches of
them), one all-reduce sums the gradients (the batch-norm statistics'
leaves included) and the losses over the data axis, divides them by its
size, and every rank applies the same AdamW update: one step equals the
single-process step over all B clips up to the order of the sums.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from vosesam_tpu_torch.config import FrameworkConfig
from vosesam_tpu_torch.models.xmem import losses as L
from vosesam_tpu_torch.models.xmem import network as xnet
from vosesam_tpu_torch.ops.aggregate import clip
from vosesam_tpu_torch.ops.memory_attention import get_similarity, readout
from vosesam_tpu_torch.parallel import mesh as meshlib
from vosesam_tpu_torch.utils.profiling import StageTimer

BN_STATS = ("running_mean", "running_var")
B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adamw's defaults


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-5                   # trainer.py:41 (AdamW)
    weight_decay: float = 0.05
    lr_schedule_steps: Tuple[int, ...] = (80000, 100000)
    lr_schedule_gamma: float = 0.1
    clip_norm: float = 3.0
    seq_length: int = 8                # unrolled frames per clip
    deep_update_prob: float = 0.2
    # Recompute each unrolled frame's forward in the backward pass: only the
    # per-frame boundaries (growing memory tokens + hidden) stay live.
    remat: bool = True
    # Sequential microbatches inside one optimizer step; the update is the
    # full-batch mean up to summation order.
    grad_accum: int = 1


@dataclasses.dataclass
class TrainState:
    """The network (its trained leaves updated in place), the AdamW moments
    per leaf name, the optimizer's step count and the iteration."""

    net: xnet.XMem
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0
    it: int = 0


def trained_leaves(net: xnet.XMem) -> Dict[str, torch.Tensor]:
    """Every leaf of the JAX parameter tree, by official name: the
    parameters and the batch norms' running statistics (made to require
    grad here). `num_batches_tracked` is no leaf."""
    leaves = dict(net.named_parameters())
    for name, buf in net.named_buffers():
        if name.rsplit(".", 1)[-1] in BN_STATS:
            buf.requires_grad_(True)
            leaves[name] = buf
    return leaves


def init_train_state(net: xnet.XMem, tcfg: TrainConfig) -> TrainState:
    leaves = trained_leaves(net)
    return TrainState(net, {k: torch.zeros_like(v) for k, v in leaves.items()},
                      {k: torch.zeros_like(v) for k, v in leaves.items()})


def learning_rate(tcfg: TrainConfig, count: int) -> float:
    """optax.piecewise_constant_schedule(lr, {step: gamma}) at `count`
    optimizer steps taken, in fp32 as optax computes it."""
    v = np.float32(tcfg.lr)
    for step in sorted(tcfg.lr_schedule_steps):
        if count >= step:
            v = np.float32(tcfg.lr_schedule_gamma) * v
    return float(v)


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Dict[str, torch.Tensor]:
    """optax.clip_by_global_norm: unchanged when ‖g‖ < max_norm, else each
    g / ‖g‖ * max_norm (equal norms take the scaled form, as optax does)."""
    norm = global_norm(grads)
    if bool(norm < max_norm):
        return grads
    return {k: (g / norm) * max_norm for k, g in grads.items()}


@torch.no_grad()
def adam_update(leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor], count: int,
                lr: float, b1: float = B1, b2: float = B2, weight_decay: float = 0.0) -> None:
    """optax's scale_by_adam (eps 1e-8, eps_root 0), then
    add_decayed_weights where `weight_decay` is set, then the -lr scale, in
    torch arithmetic and in place: `count` is the optimizer's step count
    after this step; `mu` / `nu` are updated per leaf name."""
    # the bias corrections in fp32, as optax computes decay ** count
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
    step = -lr
    for name, g in grads.items():
        p = leaves[name]
        m = (1 - b1) * g + b1 * mu[name]
        v = (1 - b2) * (g * g) + b2 * nu[name]
        mu[name], nu[name] = m, v
        u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        if weight_decay:
            u = u + weight_decay * p
        p.copy_(p + step * u)


@torch.no_grad()
def apply_adamw(state: TrainState, grads: Dict[str, torch.Tensor], tcfg: TrainConfig) -> None:
    """One optax.chain(clip_by_global_norm, adamw(schedule)) step, in place."""
    grads = clip_by_global_norm(grads, tcfg.clip_norm)
    lr = learning_rate(tcfg, state.count)
    state.count += 1
    adam_update(trained_leaves(state.net), grads, state.mu, state.nu, state.count, lr,
                weight_decay=tcfg.weight_decay)


def _train_read_memory(mem_keys, mem_shrink, mem_values, qk, qe) -> torch.Tensor:
    """Train-time read: full softmax affinity (network.py:89-105)."""
    aff = torch.softmax(get_similarity(mem_keys, mem_shrink, qk, qe), dim=-1)
    return torch.stack([readout(aff, v) for v in mem_values])


def clip_forward_loss(
    net: xnet.XMem,
    frames: torch.Tensor,       # (T, H, W, 3) normalized
    gt_indexed: torch.Tensor,   # (T, H, W) int
    obj_valid: torch.Tensor,    # (O,) bool
    it: int,
    cfg: FrameworkConfig,
    remat: bool = True,
    timer: Optional[StageTimer] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One clip's unrolled forward + losses (trainer.py:75-117); `remat`
    recomputes each frame's body in the backward pass. A frame is three
    pieces in the reference's order, each its own remat region (the graph
    and the values are those of one region): the read and the decoder
    ("forward" of `timer`), the losses ("loss"), the memorised value
    ("forward")."""
    timer = timer or StageTimer(enabled=False)
    t, h, w, _ = frames.shape
    o = cfg.xmem.max_objects
    h16, w16 = h // 16, w // 16
    hw = h16 * w16
    labels = torch.arange(1, o + 1, device=frames.device)[:, None, None]
    gt0 = (gt_indexed[0][None] == labels).to(frames.dtype)
    with timer.stage("forward"):
        key0, sh0, _sel0, feats0 = xnet.encode_key(net, frames[0])
        hidden = torch.zeros((o, h16, w16, max(cfg.xmem.hidden_dim, 1)), dtype=frames.dtype,
                             device=frames.device)
        v0, hidden = xnet.encode_value(net, frames[0], feats0.f16, hidden, gt0, obj_valid,
                                       cfg.xmem)
        timer.record(v0)
    mem_keys = key0.reshape(hw, -1)
    mem_shrink = sh0.reshape(hw)
    mem_values = v0.reshape(o, hw, -1)

    def read_and_segment(frame, mem_keys, mem_shrink, mem_values, hidden):
        key, sh, sel, feats = xnet.encode_key(net, frame)
        read = _train_read_memory(mem_keys, mem_shrink, mem_values, key.reshape(hw, -1),
                                  sel.reshape(hw, -1)).reshape(o, h16, w16, -1)
        hidden_new, agg_logits, prob = xnet.segment(net, feats, read.to(frame.dtype), hidden,
                                                    obj_valid, cfg.xmem, h_out=True)
        hidden2 = hidden_new if hidden_new is not None else hidden
        return key, sh, feats.f16, hidden2, agg_logits, prob

    def losses(agg_logits, prob, gt_t):
        # per-object logits for the dice term, from the probabilities
        obj_logits = (torch.log(clip(prob[1:], 1e-7, 1.0))
                      - torch.log(clip(1.0 - prob[1:], 1e-7, 1.0)))
        return L.frame_loss(agg_logits, obj_logits, gt_t, obj_valid, it)

    def memorize(frame, f16, hidden2, prob):
        # memorize this frame with the predicted mask (self-supervised rollout)
        return xnet.encode_value(net, frame, f16, hidden2, prob[1:], obj_valid, cfg.xmem)

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    total = 0.0
    aux: Dict[str, torch.Tensor] = {}
    for ti in range(1, t):
        with timer.stage("forward"):
            key, sh, f16, hidden2, agg_logits, prob = run(
                read_and_segment, frames[ti], mem_keys, mem_shrink, mem_values, hidden)
            timer.record(prob)
        with timer.stage("loss"):
            loss, parts = run(losses, agg_logits, prob, gt_indexed[ti])
            timer.record(loss)
        with timer.stage("forward"):
            v, hidden = run(memorize, frames[ti], f16, hidden2, prob)
            timer.record(v)
        total = total + loss
        if ti == 1:
            aux = parts
        mem_keys = torch.cat([mem_keys, key.reshape(hw, -1)], 0)
        mem_shrink = torch.cat([mem_shrink, sh.reshape(hw)], 0)
        mem_values = torch.cat([mem_values, v.reshape(o, hw, -1)], 1)
    return total / (t - 1), aux


def batch_gradients(state: TrainState, frames, gt, obj_valid, cfg: FrameworkConfig,
                    tcfg: TrainConfig, timer: Optional[StageTimer] = None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Dict[str, torch.Tensor]]:
    """Gradients of the batch's mean loss, the mean loss and the mean aux:
    `grad_accum` sequential microbatches, each the mean over its clips
    (one clip's graph alive at a time), summed and divided by the count.
    `timer` times the clips' "forward" and "loss" and their "backward"
    (with remat, the recomputed forward with it)."""
    timer = timer or StageTimer(enabled=False)
    b = frames.shape[0]
    ga = tcfg.grad_accum
    if b % ga:
        raise ValueError(f"batch {b} not divisible by grad_accum={ga}")
    mb = b // ga
    leaves = trained_leaves(state.net)
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    loss_sum = torch.zeros((), device=frames.device)
    aux_sum: Dict[str, torch.Tensor] = {}
    for m in range(ga):
        for v in leaves.values():
            v.grad = None
        m_loss = torch.zeros((), device=frames.device)
        m_aux: Dict[str, torch.Tensor] = {}
        for i in range(m * mb, (m + 1) * mb):
            loss, aux = clip_forward_loss(state.net, frames[i], gt[i], obj_valid[i], state.it,
                                          cfg, remat=tcfg.remat, timer=timer)
            with timer.stage("backward"):
                (loss / mb).backward()
                timer.record(next(iter(leaves.values())).grad)
            m_loss = m_loss + loss.detach() / mb
            for k, a in aux.items():
                m_aux[k] = m_aux.get(k, 0.0) + a.detach() / mb
        for k, v in leaves.items():
            if v.grad is not None:
                grads[k] += v.grad
            v.grad = None
        loss_sum = loss_sum + m_loss
        for k, a in m_aux.items():
            aux_sum[k] = aux_sum.get(k, 0.0) + a
    if ga > 1:
        grads = {k: g / ga for k, g in grads.items()}
        loss_sum = loss_sum / ga
        aux_sum = {k: a / ga for k, a in aux_sum.items()}
    return grads, loss_sum, aux_sum


def all_reduce_mean(grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                    aux: Dict[str, torch.Tensor], mesh: "meshlib.Mesh"):
    """The means over the data axis of the gradients, the loss and the aux
    losses: one all-reduce (SUM) of all of them packed in one buffer, in the
    leaves' order, divided by the data size."""
    if mesh.data_group is None:
        return grads, loss, aux
    names, aux_names = list(grads), list(aux)
    flat = torch.cat([grads[k].reshape(-1) for k in names]
                     + [loss.reshape(1)] + [aux[k].reshape(1) for k in aux_names])
    torch.distributed.all_reduce(flat, group=mesh.data_group)
    flat = flat / mesh.data_size
    out, at = {}, 0
    for k in names:
        n = grads[k].numel()
        out[k] = flat[at:at + n].reshape(grads[k].shape)
        at += n
    loss = flat[at]
    aux = {k: flat[at + 1 + i] for i, k in enumerate(aux_names)}
    return out, loss, aux


def train_step(
    state: TrainState,
    frames: torch.Tensor,       # (B, T, H, W, 3) normalized
    gt: torch.Tensor,           # (B, T, H, W) int
    obj_valid: torch.Tensor,    # (B, O) bool
    cfg: FrameworkConfig,
    tcfg: TrainConfig,
    mesh: Optional["meshlib.Mesh"] = None,
    timer: Optional[StageTimer] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step over a clip batch (in place on `state`). Returns
    the state and the batch's mean losses ("loss", "ce", "dice", "total").
    With `mesh`, data parallel over its data axis (the module docstring).
    `timer` (a `utils.profiling.StageTimer`) times the step's parts:
    "forward", "loss", "backward" (`batch_gradients`), "all_reduce" with a
    mesh, and "optimizer"; each syncs the device at its end."""
    timer = timer or StageTimer(enabled=False)
    if mesh is not None:
        frames, gt, obj_valid = meshlib.shard_batch((frames, gt, obj_valid), mesh)
    grads, loss, aux = batch_gradients(state, frames, gt, obj_valid, cfg, tcfg, timer)
    if mesh is not None:
        with timer.stage("all_reduce"):
            grads, loss, aux = all_reduce_mean(grads, loss, aux, mesh)
            timer.record(loss)
    with timer.stage("optimizer"):
        apply_adamw(state, grads, tcfg)
        timer.record(next(iter(state.mu.values())))
    state.it += 1
    aux = dict(aux)
    aux["loss"] = loss
    return state, aux


def save_checkpoint(state: TrainState, path: str) -> None:
    """The official-name XMem state dict under "network" (what
    `utils/checkpoint.py:load_xmem_checkpoint` reads), the iteration and the
    optimizer state."""
    network = {k: v.detach().cpu() for k, v in state.net.state_dict().items()}
    torch.save({"network": network, "it": state.it,
                "optimizer": {"count": state.count,
                              "mu": {k: v.cpu() for k, v in state.mu.items()},
                              "nu": {k: v.cpu() for k, v in state.nu.items()}}}, path)


def load_checkpoint(path: str, state: TrainState,
                    device: Optional[torch.device] = None) -> TrainState:
    """Restore a `save_checkpoint` file into `state` (network, optimizer,
    iteration), in place."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    dev = device or next(state.net.parameters()).device
    with torch.no_grad():
        state.net.load_state_dict(ck["network"], strict=True)
    trained_leaves(state.net)
    opt = ck["optimizer"]
    state.mu = {k: v.to(dev) for k, v in opt["mu"].items()}
    state.nu = {k: v.to(dev) for k, v in opt["nu"].items()}
    state.count = int(opt["count"])
    state.it = int(ck["it"])
    return state
