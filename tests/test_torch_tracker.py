"""The slice as a whole: the port's XMem-only `TrackingAnything` against the
JAX package's, on one 10-frame clip.

Both get the same XMem parameters (the JAX `xmem_init`, written as an
official-schema checkpoint and read by the port's `load_xmem_checkpoint`)
and the same frames: two objects seeded on frame 0, a third added on
frame 5. The JAX side runs its Pallas memory-read kernels in interpret mode;
the port runs the plain versions of its kernels on the CPU. fp32 on both.

Tolerances. Under random weights the decoder's per-object logits reach
|z| ~ 1e3, so fp32 reassociation between XLA:CPU and PyTorch (~1e-5
relative after a few recurrent frames) moves z by ~1e-2 and sigmoid(z) by up
to ~2.5e-3 on the few pixels where z crosses 0 (measured max 4e-3 on < 0.1%
of the pixels). Probabilities (softmax of the returned logits): within 1e-2
everywhere and within 1e-4 on 99.9% of the pixels of every frame. Returned
logits where they are well conditioned (|logit| < 8; beyond, the 1e-7
probability clip makes one fp32 ulp of p worth ~0.6 of logit): within 5e-2
(measured max 1.7e-2). Indexed masks equal on the annotation frames; at
least 99.9% pixel agreement on the others (argmax near-ties are the only
allowed difference; measured 100%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.config import FrameworkConfig as JFrameworkConfig
from vosesam_tpu.config import MemoryConfig as JMemoryConfig
from vosesam_tpu.config import RefinementConfig as JRefinementConfig
from vosesam_tpu.config import XMemConfig as JXMemConfig
from vosesam_tpu.pipeline.track_anything import TrackingAnything as JTrackingAnything
from vosesam_tpu.utils.checkpoint import tree_to_state_dict
from vosesam_tpu.viz.painter import paint_indexed as jpaint
from vosesam_tpu_torch.config import FrameworkConfig, MemoryConfig, RefinementConfig, XMemConfig
from vosesam_tpu_torch.models.xmem.network import XMem
from vosesam_tpu_torch.ops.kernels import memory_read as tmr
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything
from vosesam_tpu_torch.utils.checkpoint import load_xmem_checkpoint, params_from_jax
from vosesam_tpu_torch.viz.painter import paint_indexed as tpaint

H, W = 48, 64
N_FRAMES = 10
ADD_AT = 5
MEM = dict(max_mid_term_frames=3, min_mid_term_frames=2, max_long_term_elements=64,
           num_prototypes=8, top_k=8, mem_every=2)
PROB_TOL = 1e-2
PROB_TOL_999 = 1e-4
LOGIT_TOL = 5e-2
AGREEMENT = 0.999


def _cfgs():
    jcfg = JFrameworkConfig(xmem=JXMemConfig(max_objects=3), memory=JMemoryConfig(**MEM),
                            refinement=JRefinementConfig(use_refinement=False),
                            dtype="float32")
    tcfg = FrameworkConfig(xmem=XMemConfig(max_objects=3), memory=MemoryConfig(**MEM),
                           refinement=RefinementConfig(use_refinement=False),
                           dtype="float32")
    return jcfg, tcfg


def _clip():
    r = np.random.default_rng(0)
    base = r.integers(0, 255, (H, W, 3), np.uint8)
    frames = []
    for i in range(N_FRAMES):
        f = base.copy()
        f[6 + i:18 + i, 4 + 2 * i:20 + 2 * i] = (220, 60, 60)
        f[30:42, 44 - i:58 - i] = (60, 200, 220)
        f[20:28, 26:36] = (60, 220, 90)
        frames.append(f)
    seed = np.zeros((H, W), np.uint8)
    seed[6:18, 4:20] = 1
    seed[30:42, 44:58] = 2
    add = np.zeros((H, W), np.uint8)
    add[20:28, 26:36] = 3
    return frames, seed, add


def _run(ta, frames, seed, add):
    masks, logits, painted, _ = ta.generator(frames[:ADD_AT], seed)
    for i in range(ADD_AT, N_FRAMES):
        m, lg, p, _ = ta.xmem.track(frames[i], add if i == ADD_AT else None)
        masks.append(m)
        logits.append(lg)
        painted.append(p)
    return masks, logits, painted


def _softmax(x):
    e = np.exp(x - x.max(axis=0, keepdims=True))
    return e / e.sum(axis=0, keepdims=True)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    ta = JTrackingAnything(cfg=jcfg)
    return ta, jax.tree.map(np.asarray, ta.xmem_params)


@pytest.fixture(scope="module")
def checkpoint(jax_params, tmp_path_factory):
    _, tree = jax_params
    path = tmp_path_factory.mktemp("ckpt") / "xmem_synthetic.pth"
    torch.save(params_from_jax(tree), path)
    return str(path)


@pytest.fixture(scope="module")
def rollouts(jax_params, checkpoint):
    jta, _ = jax_params
    _, tcfg = _cfgs()
    frames, seed, add = _clip()
    jout = _run(jta, frames, seed, add)
    tmr.reset_counts()
    tta = TrackingAnything(xmem_checkpoint=checkpoint, cfg=tcfg, device="cpu")
    tout = _run(tta, frames, seed, add)
    return jout, tout, dict(tmr.COUNTS), frames


@pytest.mark.parametrize("i", range(N_FRAMES))
def test_frame_matches_jax(rollouts, i):
    (jm, jl, _), (tm, tl, _), _, _ = rollouts
    n_obj = 2 if i < ADD_AT else 3
    assert tl[i].shape == jl[i].shape == (1 + n_obj, H, W)
    assert np.isfinite(tl[i]).all()
    tp, jp = _softmax(tl[i]), _softmax(jl[i])
    np.testing.assert_allclose(tp, jp, atol=PROB_TOL)
    assert (np.abs(tp - jp) <= PROB_TOL_999).mean() >= 0.999
    cond = np.abs(jl[i]) < 8
    np.testing.assert_allclose(tl[i][cond], jl[i][cond], atol=LOGIT_TOL)
    if i in (0, ADD_AT):
        np.testing.assert_array_equal(tm[i], jm[i])
    else:
        assert (tm[i] == jm[i]).mean() >= AGREEMENT


def test_masks_carry_all_objects(rollouts):
    _, (tm, _, _), counts, _ = rollouts
    assert set(np.unique(tm[0]).tolist()) == {0, 1, 2}
    assert set(np.unique(tm[ADD_AT]).tolist()) == {0, 1, 2, 3}
    # CPU tensors: every read went through the kernels' plain versions
    assert counts["plain"] == N_FRAMES
    assert counts["fused_memory_read_shared"] == counts["fused_memory_read"] == 0


def test_paint_indexed_byte_equal(rollouts):
    (jm, _, jp), (_, _, tp), _, frames = rollouts
    for i in (0, ADD_AT, N_FRAMES - 1):
        idx = jm[i].astype(np.int32)
        ref = np.asarray(jpaint(jnp.asarray(frames[i]), jnp.asarray(idx), 3))
        port = tpaint(torch.from_numpy(frames[i]), torch.from_numpy(idx), 3).numpy()
        np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(tp[0], jp[0])


def test_params_from_jax_load_strict(jax_params):
    _, tree = jax_params
    net = XMem(XMemConfig(max_objects=3))
    net.load_state_dict(params_from_jax(tree), strict=True)
    sd = net.state_dict()
    assert "key_encoder.res2.0.conv1.weight" in sd
    assert "key_encoder.layer1.0.conv1.weight" not in sd
    # conv HWIO -> OIHW, linear (in, out) -> (out, in)
    np.testing.assert_array_equal(
        sd["key_proj.key_proj.weight"].numpy(),
        np.transpose(tree["key_proj"]["key_proj"]["weight"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        sd["decoder.fuser.attention.ChannelGate.mlp.1.weight"].numpy(),
        tree["decoder"]["fuser"]["attention"]["ChannelGate"]["mlp"]["1"]["weight"].T)


@pytest.mark.parametrize("in_channels", [5, 4])
def test_official_schema_checkpoint_loads(jax_params, tmp_path, in_channels):
    """A synthetic official-schema XMem dict (`res2.` names, OIHW, with
    num_batches_tracked) loads strictly; a single-object 4-channel value
    encoder gets the zero 5th channel, as in the JAX loader."""
    _, tree = jax_params
    sd = tree_to_state_dict(tree, renames={"key_encoder.layer1.": "key_encoder.res2."})
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    for k in list(sd):
        if k.endswith(".running_var"):
            sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    if in_channels == 4:
        sd["value_encoder.conv1.weight"] = sd["value_encoder.conv1.weight"][:, :4].clone()
    path = tmp_path / "xmem.pth"
    torch.save({"network": sd}, path)
    loaded, cfg = load_xmem_checkpoint(str(path), XMemConfig(max_objects=3))
    assert (cfg.key_dim, cfg.value_dim, cfg.hidden_dim, cfg.max_objects) == (64, 512, 64, 3)
    net = XMem(cfg)
    net.load_state_dict(loaded, strict=True)
    w = net.value_encoder.conv1.weight
    assert w.shape[1] == 5
    if in_channels == 4:
        assert not w[:, 4].any()
    assert int(net.key_encoder.res2[0].bn1.num_batches_tracked) == 7


def test_entry_point_without_cuda_raises(monkeypatch):
    _, tcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrackingAnything(cfg=tcfg)


def test_refinement_waits_for_slice_2():
    """SAM refinement is ported: turning it on builds the SAM model instead
    of raising (tests/test_torch_refinement.py drives it)."""
    _, tcfg = _cfgs()
    cfg = dataclasses.replace(
        tcfg, refinement=RefinementConfig(use_refinement=True),
        sam=dataclasses.replace(tcfg.sam, model_type="vit_b", image_size=128, window_size=7,
                                vit_dims=(("vit_b", 64, 2, 2, (1,)),)))
    ta = TrackingAnything(cfg=cfg, device="cpu")
    assert ta.xmem.sam is ta.sam is not None
