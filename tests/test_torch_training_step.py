"""The port's XMem trainer against itself on the CPU, fp32, at toy dims
(Ck 8, Cv 16, Ch 4, two object slots, 3-frame clips at 32 x 32), from the
JAX package's initial weights: `grad_accum` 2 against the full batch, remat
on against off, checkpoints through the trainer and the facade, and the
`train_xmem` entry point. The losses, the optimizer and one step against
JAX's are in `test_torch_training.py`.

Tolerances: `grad_accum` 2 against the full batch and remat on against off
1e-6 absolute on the parameters; checkpoints exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vosesam_tpu.config import FrameworkConfig as JFrameworkConfig
from vosesam_tpu.config import MemoryConfig as JMemoryConfig
from vosesam_tpu.config import XMemConfig as JXMemConfig
from vosesam_tpu.models.xmem import network as jxnet
from vosesam_tpu_torch.config import FrameworkConfig, XMemConfig
from vosesam_tpu_torch.models.xmem.network import XMem
from vosesam_tpu_torch.training import trainer as T
from vosesam_tpu_torch.utils.checkpoint import load_xmem_checkpoint, params_from_jax

DIMS = dict(key_dim=8, value_dim=16, hidden_dim=4, max_objects=2)
JCFG = JFrameworkConfig(xmem=JXMemConfig(**DIMS), memory=JMemoryConfig(top_k=4),
                        dtype="float32")
TCFG = FrameworkConfig(xmem=XMemConfig(**DIMS), dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side: keep this
    process's torch work from taking every core (a pool of one thread per
    core in each worker oversubscribes the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jparams():
    return jxnet.xmem_init(jax.random.PRNGKey(0), JCFG.xmem)


@pytest.fixture(scope="module")
def stepped(jparams):
    """One port step from the JAX weights (remat on, the full batch)."""
    return _step(jparams)


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


# ----------------------------------------------- the port against itself

def _step(jparams, **kw):
    tcfg = T.TrainConfig(lr=1e-4, **kw)
    state = T.init_train_state(_net(jparams), tcfg)
    frames, gt, ov = _batch(b=2, seed=7)
    state, aux = T.train_step(state, *_torch(frames, gt, ov), TCFG, tcfg)
    return state, aux


def _same_params(a, b, atol):
    sa, sb = a.net.state_dict(), b.net.state_dict()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=atol, msg=k)


def test_grad_accum_2_equals_the_full_batch(jparams, stepped):
    full, faux = stepped
    acc, aaux = _step(jparams, grad_accum=2)
    for k in faux:
        assert float(aaux[k]) == pytest.approx(float(faux[k]), rel=1e-6)
    _same_params(full, acc, 1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        _step(jparams, grad_accum=3)


def test_remat_on_equals_off(jparams, stepped):
    on, aon = stepped
    off, aoff = _step(jparams, remat=False)
    assert float(aon["loss"]) == float(aoff["loss"])
    _same_params(on, off, 1e-6)


def test_checkpoint_round_trip(jparams, stepped, tmp_path):
    state, _ = stepped
    path = str(tmp_path / "xmem_train.pth")
    T.save_checkpoint(state, path)
    # the network loads where an official XMem checkpoint does
    sd, cfg = load_xmem_checkpoint(path, XMemConfig(max_objects=2))
    assert (cfg.key_dim, cfg.value_dim, cfg.hidden_dim) == (8, 16, 4)
    net = XMem(cfg)
    net.load_state_dict(sd, strict=True)
    for k, v in state.net.state_dict().items():
        torch.testing.assert_close(net.state_dict()[k], v, rtol=0, atol=0)
    # and the trainer resumes: network, moments, count and iteration
    fresh = T.init_train_state(_net(jparams), T.TrainConfig())
    T.load_checkpoint(path, fresh)
    assert (fresh.it, fresh.count) == (state.it, state.count) == (1, 1)
    _same_params(fresh, state, 0)
    for k in state.mu:
        torch.testing.assert_close(fresh.mu[k], state.mu[k], rtol=0, atol=0)
        torch.testing.assert_close(fresh.nu[k], state.nu[k], rtol=0, atol=0)
    assert all(fresh.net.get_buffer(k).requires_grad for k in fresh.mu if "running" in k)


def test_facade_loads_a_trainer_checkpoint(stepped, tmp_path):
    from vosesam_tpu_torch.config import RefinementConfig
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

    state, _ = stepped
    path = str(tmp_path / "xmem_train.pth")
    T.save_checkpoint(state, path)
    cfg = dataclasses.replace(TCFG, refinement=RefinementConfig(use_refinement=False))
    ta = TrackingAnything(xmem_checkpoint=path, cfg=cfg, device="cpu")
    assert ta.cfg.xmem.key_dim == 8
    for k, v in state.net.state_dict().items():
        torch.testing.assert_close(ta.xmem_net.state_dict()[k], v, rtol=0, atol=0)


# ------------------------------------------------------------ entry point

def test_train_xmem_entry_point(tmp_path):
    from vosesam_tpu_torch import train_xmem
    from vosesam_tpu_torch.eval.synthetic import write_tree

    write_tree(str(tmp_path / "syn"), h=48, w=64, davis_frames=5, long_frames=2,
               lvos_frames=1, ovis_frames=2)
    data = str(tmp_path / "syn" / "DAVIS")
    save = str(tmp_path / "ck.pth")
    args = ["--data", data, "--imset", "2017/val.txt", "--steps", "2", "--batch", "2",
            "--grad-accum", "2", "--seq-length", "2", "--crop", "32", "--key-dim", "8",
            "--value-dim", "16", "--hidden-dim", "4", "--max-objects", "2", "--log-every",
            "1", "--device", "cpu"]
    assert train_xmem.main(args + ["--save", save]) == 0
    ck = torch.load(save, weights_only=True)
    assert ck["it"] == 2 and ck["optimizer"]["count"] == 2
    assert train_xmem.main(args + ["--steps", "3", "--resume", save, "--save", save]) == 0
    assert torch.load(save, weights_only=True)["it"] == 3
    # --dp: a process group of one (gloo on the CPU), closed again on return
    dp_save = str(tmp_path / "dp.pth")
    assert train_xmem.main(args + ["--dp", "--save", dp_save]) == 0
    assert torch.load(dp_save, weights_only=True)["it"] == 2
    assert not torch.distributed.is_initialized()


def test_step_timer_times_each_part_and_changes_nothing(jparams, stepped):
    """`train_step(timer=)` (a `utils.profiling.StageTimer`, as the chip
    script's phase 11 uses it): every part timed the expected number of
    times, and the step bit-equal to the untimed one."""
    from vosesam_tpu_torch.utils.profiling import StageTimer

    tcfg = T.TrainConfig(lr=1e-4)
    state = T.init_train_state(_net(jparams), tcfg)
    frames, gt, ov = _batch(b=2, seed=7)
    timer = StageTimer()
    state, aux = T.train_step(state, *_torch(frames, gt, ov), TCFG, tcfg, timer=timer)
    full, faux = stepped
    assert float(aux["loss"]) == float(faux["loss"])
    _same_params(state, full, 0)
    # 2 clips of 3 frames: frame 0, then read + decode and memorize per later frame
    assert dict(timer.counts) == {"forward": 2 * (1 + 2 * 2), "loss": 2 * 2, "backward": 2,
                                  "optimizer": 1}
    assert all(v > 0 for v in timer.summary().values())
