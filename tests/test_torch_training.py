"""The port's XMem trainer (`vosesam_tpu_torch/training/trainer.py`,
`models/xmem/losses.py`) against the JAX package's on the CPU, fp32: the
losses, the optimizer and one train step at toy dims (Ck 8, Cv 16, Ch 4,
two object slots, 3-frame clips at 32 x 32). The port's step against
itself, checkpoints and `train_xmem.py` are in `test_torch_training_step.py`.

Tolerances:
  - losses: 1e-5 relative (fp32 sums in another order; the top-p CE sums
    its k largest values where JAX masks a sorted vector);
  - one `train_step` against JAX's: the loss within 1e-4 relative, every
    parameter and batch-norm statistic within 1e-5 absolute after the step
    (lr 1e-5, the recipe's; the first AdamW step moves an element by about
    lr x sign(g), so a gradient of the wrong sign shows as 2e-5), and the
    batch-norm statistics moved by at least lr / 2 on >= 90% of their
    elements and on some element of each (they are trained leaves, as in
    JAX). The frames are scaled by 0.01:
    at unit scale random-weight XMem saturates its probabilities (ROADMAP
    C8) and gradients become sums of cancelling 1e7-sized terms whose sign
    rounding decides;
  - the optimizer against optax on the same gradients: 1e-6 relative.

This file keeps torch's default thread count: the one-step comparison's
gradient signs depend on the CPU reduction order, and it holds on an
8-core machine at 8 threads, not at 1, 2 or 4 (some hundred near-zero
gradients of `decoder.fuser.block1.conv1.weight` flip sign).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vosesam_tpu.config import FrameworkConfig as JFrameworkConfig
from vosesam_tpu.config import MemoryConfig as JMemoryConfig
from vosesam_tpu.config import XMemConfig as JXMemConfig
from vosesam_tpu.models.xmem import losses as JL
from vosesam_tpu.models.xmem import network as jxnet
from vosesam_tpu.training import trainer as JT
from vosesam_tpu_torch.config import FrameworkConfig, XMemConfig
from vosesam_tpu_torch.models.xmem import losses as TL
from vosesam_tpu_torch.models.xmem.network import XMem
from vosesam_tpu_torch.training import trainer as T
from vosesam_tpu_torch.utils.checkpoint import params_from_jax

DIMS = dict(key_dim=8, value_dim=16, hidden_dim=4, max_objects=2)
JCFG = JFrameworkConfig(xmem=JXMemConfig(**DIMS), memory=JMemoryConfig(top_k=4),
                        dtype="float32")
TCFG = FrameworkConfig(xmem=XMemConfig(**DIMS), dtype="float32")


@pytest.fixture(scope="module")
def jparams():
    return jxnet.xmem_init(jax.random.PRNGKey(0), JCFG.xmem)


def _net(jparams):
    net = XMem(TCFG.xmem)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), strict=True)
    return net


def _batch(b=2, t=3, hw=32, scale=0.01, seed=0):
    rng = np.random.default_rng(seed)
    frames = (scale * rng.normal(size=(b, t, hw, hw, 3))).astype(np.float32)
    gt = np.zeros((b, t, hw, hw), np.int32)
    gt[:, :, 8:20, 8:20] = 1
    gt[1:, :, 20:30, 2:12] = 2
    ov = np.zeros((b, 2), bool)
    ov[:, 0] = True
    ov[1:, 1] = True
    return frames, gt, ov


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ------------------------------------------------------------------ losses

def test_dice_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = (5 * rng.normal(size=(3, 12, 16))).astype(np.float32)
    gt = rng.random((3, 12, 16)) > 0.6
    valid = np.array([True, False, True])
    want = float(JL.dice_loss(jnp.asarray(logits), jnp.asarray(gt), jnp.asarray(valid)))
    got = float(TL.dice_loss(*_torch(logits, gt, valid)))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("it", [0, 19999, 20000, 45000, 69999, 70000, 10 ** 6])
def test_bootstrapped_ce_matches_jax_through_the_warm_up(it):
    rng = np.random.default_rng(2)
    logits = (3 * rng.normal(size=(3, 16, 20))).astype(np.float32)
    target = rng.integers(0, 3, (16, 20)).astype(np.int32)
    want = float(JL.bootstrapped_ce(jnp.asarray(logits), jnp.asarray(target), jnp.int32(it)))
    got = float(TL.bootstrapped_ce(*_torch(logits, target), it))
    assert got == pytest.approx(want, rel=1e-5)


def test_frame_loss_matches_jax():
    rng = np.random.default_rng(3)
    agg = (3 * rng.normal(size=(3, 16, 20))).astype(np.float32)
    obj = (3 * rng.normal(size=(2, 16, 20))).astype(np.float32)
    gt = rng.integers(0, 3, (16, 20)).astype(np.int32)
    valid = np.array([True, True])
    jt, jparts = JL.frame_loss(*(jnp.asarray(x) for x in (agg, obj, gt, valid)), jnp.int32(30000))
    tt, tparts = TL.frame_loss(*_torch(agg, obj, gt, valid), 30000)
    assert float(tt) == pytest.approx(float(jt), rel=1e-5)
    for k in ("ce", "dice", "total"):
        assert float(tparts[k]) == pytest.approx(float(jparts[k]), rel=1e-5)


# --------------------------------------------------------- the optimizer

@pytest.mark.parametrize("count", [0, 1, 79999, 80000, 99999, 100000, 10 ** 6])
def test_lr_schedule_boundaries_match_optax(count):
    tcfg = T.TrainConfig(lr=1e-5)
    sched = optax.piecewise_constant_schedule(1e-5, {80000: 0.1, 100000: 0.1})
    assert T.learning_rate(tcfg, count) == float(np.float32(sched(count)))
    want = 1e-5 * 0.1 ** ((count >= 80000) + (count >= 100000))
    assert T.learning_rate(tcfg, count) == pytest.approx(want, rel=1e-6)


def _grads(scale, seed=4):
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(size=(5, 3)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values()))
    return {k: (v * (scale / norm)).astype(np.float32) for k, v in g.items()}


@pytest.mark.parametrize("scale", [1.0, 3.0, 7.5])
def test_clip_by_global_norm_matches_optax(scale):
    """Under, at and above the norm: under it nothing changes; at and above
    it each gradient is divided by the norm and multiplied by 3."""
    g = _grads(scale)
    want, _ = optax.clip_by_global_norm(3.0).update({k: jnp.asarray(v) for k, v in g.items()},
                                                      optax.EmptyState())
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    got = T.clip_by_global_norm(tg, 3.0)
    if scale < 3.0:
        assert all(got[k] is tg[k] for k in g)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    norm = float(T.global_norm(got))
    assert norm == pytest.approx(min(scale, 3.0), rel=1e-5)


def test_adamw_steps_match_optax_on_the_same_gradients():
    """Three steps of the chain on given gradients, with decay, from the
    same parameters: the moments, the bias corrections and the updates."""
    tcfg = T.TrainConfig(lr=1e-3)
    rng = np.random.default_rng(5)
    net = torch.nn.Module()
    net.a = torch.nn.Parameter(torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)))
    net.b = torch.nn.Parameter(torch.from_numpy(rng.normal(size=(7,)).astype(np.float32)))
    state = T.TrainState(net, {k: torch.zeros_like(v) for k, v in net.named_parameters()},
                         {k: torch.zeros_like(v) for k, v in net.named_parameters()})
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in net.named_parameters()}
    opt = JT.make_optimizer(JT.TrainConfig(lr=1e-3))
    opt_state = opt.init(params)
    for step, scale in enumerate((10.0, 0.5, 4.0)):
        g = _grads(scale, seed=6 + step)
        updates, opt_state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                        params)
        params = optax.apply_updates(params, updates)
        T.apply_adamw(state, {k: torch.from_numpy(v) for k, v in g.items()}, tcfg)
        for k, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7)
    assert state.count == 3


# ------------------------------------------------------- one step vs JAX

def test_one_train_step_matches_jax_on_every_leaf(jparams):
    frames, gt, ov = _batch()
    tcfg = T.TrainConfig()
    js = JT.init_train_state(jparams, JT.TrainConfig())
    js2, jaux = JT.train_step(js, *(jnp.asarray(x) for x in (frames, gt, ov)), JCFG,
                              JT.TrainConfig())
    state = T.init_train_state(_net(jparams), tcfg)
    state, aux = T.train_step(state, *_torch(frames, gt, ov), TCFG, tcfg)
    assert state.it == 1 and state.count == 1
    for k in ("loss", "ce", "dice", "total"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=1e-4)
    before = params_from_jax(jax.tree.map(np.asarray, jparams))
    want = params_from_jax(jax.tree.map(np.asarray, js2.params))
    got = state.net.state_dict()
    leaves = [k for k in want if not k.endswith("num_batches_tracked")]
    assert set(leaves) == set(T.trained_leaves(state.net))
    for k in leaves:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    stats = [k for k in leaves if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100
    moved = {}
    for name, new in (("port", got), ("jax", want)):
        steps = [(new[k] - before[k]).abs().flatten() for k in stats]
        assert all(bool((s >= tcfg.lr / 2).any()) for s in steps), name
        moved[name] = float((torch.cat(steps) >= tcfg.lr / 2).float().mean())
    assert moved["port"] >= 0.9 and moved["jax"] >= 0.9, moved
