"""The port's video-inpainting pipeline (`pipeline/inpaint.py`, and the
facade's `baseinpainter`) against `vosesam_tpu.pipeline.inpaint`.

Weights come from the JAX `generator_init` through `params_from_jax`; videos
are made from a numpy seed; everything runs in fp32 on the CPU. The window
plans are compared exactly. Whole videos are compared by the invariant that
holds across programs: outside the dilated mask the output is the (resized)
input, bit for bit; inside it, rounding noise can flip a warp's floor() and
is amplified through the propagation under random weights, so a share of
the inpainted pixels is held (>= 98% within 2 grey levels of 255) rather
than all of them. Equalities between two runs of the port itself (static
against variable windows, device against host compositing, batched against
sequential windows) are exact or within one grey level, as stated at each.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.config import InpainterConfig as JInpainterConfig
from vosesam_tpu.models.e2fgvi import generator as JG
from vosesam_tpu.pipeline import inpaint as jinp
from vosesam_tpu_torch.config import FrameworkConfig, InpainterConfig, RefinementConfig
from vosesam_tpu_torch.models.e2fgvi import generator as TG
from vosesam_tpu_torch.ops import morphology as morph
from vosesam_tpu_torch.ops.image import resize_nearest
from vosesam_tpu_torch.pipeline import inpaint as tinp
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything
from vosesam_tpu_torch.utils.checkpoint import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side: keep this
    file's convolutions from taking every core in each of them."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


JCFG = JInpainterConfig(num_blocks=1)
TCFG = InpainterConfig(num_blocks=1)


@pytest.fixture(scope="module")
def weights():
    jparams = JG.generator_init(jax.random.PRNGKey(0), JCFG)
    net = TG.InpaintGenerator(TCFG)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), strict=True)
    return jparams, net.eval()


def _video(t, hw=(60, 108), seed=0):
    r = np.random.default_rng(seed)
    frames = [r.integers(0, 255, hw + (3,), dtype=np.uint8) for _ in range(t)]
    masks = []
    for i in range(t):
        m = np.zeros(hw, np.uint8)
        m[20 + i % 3:35, 40:70 + i % 4] = 1
        masks.append(m)
    return frames, masks


def _dilated(masks, radius, out_hw=None):
    m = morph.dilate(torch.from_numpy(np.stack([x > 0 for x in masks])), radius).float()
    if out_hw is not None:
        m = resize_nearest(m, out_hw, axes=(-2, -1))
    return m.numpy() > 0


def _port(net, **kw):
    return tinp.Inpainter(cfg=dataclasses.replace(TCFG, **kw), net=net, device="cpu")


# --------------------------------------------------------------------- plans

@pytest.mark.parametrize("t", [6, 12, 13, 28, 54, 99])
def test_window_plans_equal_jax(t):
    r = tinp.static_ref_budget(t, 5, 10)
    assert r == jinp.static_ref_budget(t, 5, 10)
    for f in range(0, t, 5):
        assert tinp.static_window_plan(f, t, 5, 10, r) == jinp.static_window_plan(f, t, 5, 10, r)
        nb = list(range(max(0, f - 5), min(t, f + 6)))
        for num_ref in (-1, 4):
            assert (tinp.get_ref_index(f, nb, t, num_ref, 10)
                    == jinp.get_ref_index(f, nb, t, num_ref, 10))


@pytest.mark.parametrize("t,n", [(23, 8), (16, 8), (61, 50), (120, 50)])
def test_subset_split_equals_jax(t, n, weights):
    """`inpaint`'s subsets, each with its context frames, and the frames it
    keeps of each: both `Inpainter`s with `inpaint_efficient` replaced by a
    recorder that returns its input frames."""
    frames = [np.full((2, 2, 3), i, np.uint8) for i in range(t)]
    masks = [np.zeros((2, 2), np.uint8)] * t
    calls = {}

    def recorder(name):
        def fake(fr, mk, ratio=1.0, dilate_radius=None):
            calls.setdefault(name, []).append([int(f[0, 0, 0]) for f in fr])
            return list(fr)
        return fake

    jd = jinp.Inpainter(cfg=dataclasses.replace(JCFG, num_subset_frames=n), params={})
    jd.inpaint_efficient = recorder("jax")
    td = _port(weights[1], num_subset_frames=n)
    td.inpaint_efficient = recorder("port")
    jout, tout = jd.inpaint(frames, masks), td.inpaint(frames, masks)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == max(1, t // n)
    assert [int(f[0, 0, 0]) for f in tout] == [int(f[0, 0, 0]) for f in jout] == list(range(t))


# --------------------------------------------------------------- against JAX

def test_small_video_matches_jax(weights):
    """Six 60x108 frames (one variable window, shorter than the static
    regime), dilation 2."""
    jparams, net = weights
    frames, masks = _video(6)
    want = jinp.Inpainter(cfg=JCFG, params=jparams).inpaint_efficient(
        frames, masks, dilate_radius=2)
    got = _port(net).inpaint_efficient(frames, masks, dilate_radius=2)
    dil = _dilated(masks, 2)
    assert len(got) == 6
    inside = []
    for i in range(6):
        assert got[i].shape == (60, 108, 3) and got[i].dtype == np.uint8
        np.testing.assert_array_equal(got[i][~dil[i]], frames[i][~dil[i]])
        np.testing.assert_array_equal(got[i][~dil[i]], want[i][~dil[i]])
        inside.append(np.abs(got[i].astype(np.int32) - want[i].astype(np.int32))[dil[i]])
    inside = np.concatenate(inside)
    assert inside.size > 0 and float((inside <= 2).mean()) >= 0.98, float((inside <= 2).mean())
    # the mask is really filled with something else than the masked input
    assert np.abs(got[0].astype(np.int32) - frames[0].astype(np.int32))[dil[0]].max() > 0


def test_ratio_matches_jax_outside_the_mask(weights):
    """`ratio=0.5` from 120x216: the antialiased frame downscale and the
    nearest mask downscale are the JAX package's. The resized frames are
    no integers any more (the edge rows' weights are renormalised), the two
    frameworks sum the separable resize in different orders, and the output
    truncates to uint8: outside the resized dilated mask the two outputs
    agree within one grey level everywhere and are equal on >= 99.9% of the
    values."""
    jparams, net = weights
    frames, masks = _video(4, (120, 216), seed=2)
    want = jinp.Inpainter(cfg=JCFG, params=jparams).inpaint_efficient(
        frames, masks, ratio=0.5, dilate_radius=3)
    got = _port(net).inpaint_efficient(frames, masks, ratio=0.5, dilate_radius=3)
    dil = _dilated(masks, 3, (60, 108))
    outside, inside = [], []
    for i in range(4):
        assert got[i].shape == (60, 108, 3)
        d = np.abs(got[i].astype(np.int32) - want[i].astype(np.int32))
        outside.append(d[~dil[i]])
        inside.append(d[dil[i]])
    outside, inside = np.concatenate(outside), np.concatenate(inside)
    assert outside.max() <= 1 and float((outside == 0).mean()) >= 0.999
    assert float((inside <= 2).mean()) >= 0.98


# ------------------------------------------------------- the port with itself

def test_static_windows_match_variable_on_interior_frames(weights):
    """The static plan's padded reference slots weigh exactly zero, so the
    frames that only interior anchors write (6..19 of 28) are the variable
    path's within one grey level."""
    frames, masks = _video(28, seed=3)
    out_var = _port(weights[1], static_windows=False).inpaint_efficient(
        frames, masks, dilate_radius=2)
    out_st = _port(weights[1], static_windows=True).inpaint_efficient(
        frames, masks, dilate_radius=2)
    for i in range(6, 20):
        np.testing.assert_allclose(out_st[i].astype(np.int32), out_var[i].astype(np.int32),
                                   atol=1, err_msg=f"frame {i}")
    assert any((a != b).any() for a, b in zip(out_st[:6], out_var[:6]))     # edge windows differ


@pytest.mark.parametrize("t,hw,ratio", [(13, (60, 108), 1.0), (6, (60, 108), 1.0),
                                        (12, (120, 216), 0.5)])
def test_device_composite_matches_host(weights, t, hw, ratio):
    """Same windows, same blend order and arithmetic: equal arrays, in the
    static and the variable regime and with a downscale."""
    frames, masks = _video(t, hw, seed=5)
    out_d = _port(weights[1], device_composite=True).inpaint_efficient(
        frames, masks, ratio=ratio, dilate_radius=2)
    out_h = _port(weights[1], device_composite=False).inpaint_efficient(
        frames, masks, ratio=ratio, dilate_radius=2)
    assert len(out_d) == len(out_h) == t
    for a, b in zip(out_d, out_h):
        np.testing.assert_array_equal(a, b)


def test_window_batch_matches_sequential(weights):
    """13 frames: anchors 0, 5, 10, so `window_batch=2` runs one batched
    generator call of two windows and a tail group of one. The windows are
    independent, so the output is the sequential one: equal outside the
    dilated mask, within one grey level inside (a batched convolution sums in
    another order; the JAX package's test of its vmapped windows holds the
    same bound)."""
    frames, masks = _video(13, seed=7)
    seq_drv, bat_drv = _port(weights[1]), _port(weights[1], window_batch=2)
    assert [len(g) for g in seq_drv._windows(13)] == [1, 1, 1]
    assert [len(g) for g in bat_drv._windows(13)] == [2, 1]
    assert [len(g) for g in _port(weights[1], window_batch=2)._windows(6)] == [1, 1]   # variable
    seq = seq_drv.inpaint_efficient(frames, masks, dilate_radius=2)
    bat = bat_drv.inpaint_efficient(frames, masks, dilate_radius=2)
    dil = _dilated(masks, 2)
    for i, (a, b) in enumerate(zip(seq, bat)):
        np.testing.assert_array_equal(a[~dil[i]], b[~dil[i]])
        np.testing.assert_allclose(a.astype(np.int32), b.astype(np.int32), atol=1,
                                   err_msg=f"frame {i}")


@torch.no_grad()
def test_batched_generator_matches_single_windows(weights):
    """`generator_forward` on a batch of two windows with different
    `frame_valid` rows against the two windows run alone: outputs and flows
    within 1e-4 (fp32; only the summation order of batched convolutions and
    products differs)."""
    r = np.random.default_rng(21)
    win = torch.from_numpy(r.uniform(-1, 1, (2, 5, 60, 108, 3)).astype(np.float32))
    valid = torch.tensor([[True, True, True, True, False], [True, True, True, True, True]])
    out, (ff, fb) = TG.generator_forward(weights[1], win, 3, TCFG, frame_valid=valid)
    assert out.shape == (2, 5, 60, 108, 3) and ff.shape == fb.shape == (2, 2, 15, 27, 2)
    for i in range(2):
        o1, (f1, b1) = TG.generator_forward(weights[1], win[i], 3, TCFG, frame_valid=valid[i])
        assert o1.shape == (5, 60, 108, 3)
        np.testing.assert_allclose(out[i].numpy(), o1.numpy(), atol=1e-4)
        np.testing.assert_allclose(ff[i].numpy(), f1.numpy(), atol=1e-4)
        np.testing.assert_allclose(fb[i].numpy(), b1.numpy(), atol=1e-4)


def test_subset_split_runs_and_keeps_the_input_outside_the_mask(weights):
    """`inpaint` over 20 frames with 8-frame subsets: two subsets (the
    remainder folds into the first), each with its context frames."""
    frames, masks = _video(20, seed=9)
    out = _port(weights[1], num_subset_frames=8).inpaint(frames, masks, dilate_radius=2)
    dil = _dilated(masks, 2)
    assert len(out) == 20
    for i in range(20):
        np.testing.assert_array_equal(out[i][~dil[i]], frames[i][~dil[i]])
    whole = _port(weights[1]).inpaint(frames, masks, dilate_radius=2)
    assert any((a != b).any() for a, b in zip(out, whole))     # other windows, other fill


def test_flip_pad_and_default_dilation(weights):
    """A 50x100 video is flip-padded to 60x108 and cut back; the default
    dilation radius is the config's 15."""
    frames, masks = _video(3, (50, 100), seed=11)
    x = torch.arange(2 * 50 * 100, dtype=torch.float32).reshape(2, 50, 100, 1)
    padded = tinp._flip_pad(x)
    assert padded.shape == (2, 60, 108, 1)
    np.testing.assert_array_equal(padded.numpy(), jinp._flip_pad(x.numpy()))
    out = _port(weights[1]).inpaint_efficient(frames, masks)
    dil = _dilated(masks, 15)
    assert out[0].shape == (50, 100, 3)
    for i in range(3):
        np.testing.assert_array_equal(out[i][~dil[i]], frames[i][~dil[i]])


# ------------------------------------------------------------- entry points

def test_mesh_raises_and_no_cuda_raises(weights):
    """A mesh that is no `parallel.mesh.Mesh` raises (the mesh path itself:
    test_torch_parallel_inpaint.py)."""
    with pytest.raises(TypeError, match="mesh"):
        tinp.Inpainter(cfg=TCFG, net=weights[1], mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tinp.Inpainter(cfg=TCFG, net=weights[1])


def test_facade_builds_the_inpainter():
    """`TrackingAnything(e2fgvi_checkpoint=...)` holds `baseinpainter`
    (random weights when the path names no file); without it, none."""
    cfg = FrameworkConfig(refinement=RefinementConfig(use_refinement=False), inpainter=TCFG,
                          dtype="float32")
    assert TrackingAnything(cfg=cfg, device="cpu").baseinpainter is None
    ta = TrackingAnything(cfg=cfg, device="cpu", e2fgvi_checkpoint="no-such-file.pth")
    assert isinstance(ta.baseinpainter, tinp.Inpainter) and ta.baseinpainter.cfg == TCFG
    frames, masks = _video(3, seed=13)
    out = ta.baseinpainter.inpaint(frames, masks, dilate_radius=1)
    assert len(out) == 3 and out[0].shape == (60, 108, 3) and out[0].dtype == np.uint8
