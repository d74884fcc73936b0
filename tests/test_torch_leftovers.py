"""The port's small public helpers and options against the JAX package's on
the CPU: `im_denormalize`, `sam_coords_transform` (ops/image.py),
`amplify_bbox` (ops/morphology.py), `box_to_points`
(models/sam/prompt_encoder.py), `all_to_onehot` (utils/mask_mapper.py),
`core.step(end=True)` and `Tracker(save_inner_masks_folder=...)` with its
`TrackingAnything` pass-through.

Tolerances: the helpers exactly or to one fp32 rounding (1e-6). The
tracker runs are the XMem-only toy clip of `tests/test_torch_tracker.py`
(48 x 64, random weights from the JAX `xmem_init`, fp32), which holds the
step's probabilities against JAX frame by frame; here the end step's
probabilities are held within 1e-2 and its masks (their argmax) on
>= 99.9% of the pixels, the saved masks likewise. (A first bound of 1e-4
on 99.9% of the probabilities, test_torch_tracker's, read 99.84% on this
clip's fifth frame: under random weights |logit| ~ 1e3 makes per-pixel
probabilities rounding-sensitive, ROADMAP C8.)
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.config import FrameworkConfig as JFrameworkConfig
from vosesam_tpu.config import MemoryConfig as JMemoryConfig
from vosesam_tpu.config import RefinementConfig as JRefinementConfig
from vosesam_tpu.config import XMemConfig as JXMemConfig
from vosesam_tpu.inference import core as jcore
from vosesam_tpu.models.sam import prompt_encoder as jpe
from vosesam_tpu.ops import image as jimage
from vosesam_tpu.ops import morphology as jmorph
from vosesam_tpu.pipeline.track_anything import TrackingAnything as JTrackingAnything
from vosesam_tpu.utils import mask_mapper as jmm
from vosesam_tpu_torch.config import FrameworkConfig, MemoryConfig, RefinementConfig, XMemConfig
from vosesam_tpu_torch.eval.palette import load_palette_mask
from vosesam_tpu_torch.inference import core as tcore
from vosesam_tpu_torch.models.sam import prompt_encoder as tpe
from vosesam_tpu_torch.ops import image as timage
from vosesam_tpu_torch.ops import morphology as tmorph
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything
from vosesam_tpu_torch.utils import mask_mapper as tmm
from vosesam_tpu_torch.utils.checkpoint import params_from_jax


def test_im_denormalize_matches_jax_and_inverts_normalize():
    r = np.random.default_rng(0)
    x = r.standard_normal((5, 7, 3)).astype(np.float32)
    got = timage.im_denormalize(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jimage.im_denormalize(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    img = r.integers(0, 256, (4, 6, 3), np.uint8)
    back = timage.im_denormalize(timage.im_normalize(torch.from_numpy(img)))
    np.testing.assert_allclose(back.numpy() * 255.0, img, rtol=0, atol=1e-3)


@pytest.mark.parametrize("hw, target", [((480, 854), 1024), ((600, 400), 1024), ((37, 53), 64)])
def test_sam_coords_transform_matches_jax(hw, target):
    coords = np.random.default_rng(1).uniform(0, max(hw), (3, 4, 2)).astype(np.float32)
    want = np.asarray(jimage.sam_coords_transform(jnp.asarray(coords), hw, target))
    got = timage.sam_coords_transform(torch.from_numpy(coords), hw, target)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("box, pixels", [((10.0, 12.0, 30.0, 40.0), 5.0),
                                         ((1.0, 2.0, 60.0, 45.0), 8.0),     # clamped
                                         ((0.0, 0.0, 0.0, 0.0), 0.0)])
def test_amplify_bbox_matches_jax(box, pixels):
    b = np.asarray(box, np.float32)
    want = np.asarray(jmorph.amplify_bbox(jnp.asarray(b), pixels, (48, 64)))
    got = tmorph.amplify_bbox(torch.from_numpy(b), pixels, (48, 64))
    np.testing.assert_array_equal(got.numpy(), want)


def test_box_to_points_matches_jax():
    b = np.asarray([3.5, 4.0, 20.25, 31.0], np.float32)
    jp, jl = jpe.box_to_points(jnp.asarray(b))
    tp, tl = tpe.box_to_points(torch.from_numpy(b))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.int32


def test_all_to_onehot_matches_jax():
    m = np.random.default_rng(2).choice([0, 3, 7], (9, 11)).astype(np.uint8)
    for labels in ([3, 7], [7], [0, 3, 7, 9]):
        got = tmm.all_to_onehot(m, labels)
        assert got.dtype == np.uint8 and got.shape == (len(labels), 9, 11)
        np.testing.assert_array_equal(got, jmm.all_to_onehot(m, labels))


# ------------------------------------------- the tracker's options, vs JAX

H, W = 48, 64
MEM = dict(max_mid_term_frames=3, min_mid_term_frames=2, max_long_term_elements=64,
           num_prototypes=8, top_k=8, mem_every=2)


def _clip(n=5):
    r = np.random.default_rng(0)
    base = r.integers(0, 255, (H, W, 3), np.uint8)
    frames = []
    for i in range(n):
        f = base.copy()
        f[6 + i:18 + i, 4 + 2 * i:20 + 2 * i] = (220, 60, 60)
        f[30:42, 44 - i:58 - i] = (60, 200, 220)
        frames.append(f)
    seed = np.zeros((H, W), np.uint8)
    seed[6:18, 4:20] = 1
    seed[30:42, 44:58] = 2
    return frames, seed


@pytest.fixture(scope="module")
def trackers(tmp_path_factory):
    """Both facades with the same XMem weights, each dumping its inner masks,
    after the seed frame and three propagated frames."""
    root = tmp_path_factory.mktemp("inner")
    mem_j, mem_t = JMemoryConfig(**MEM), MemoryConfig(**MEM)
    jcfg = JFrameworkConfig(xmem=JXMemConfig(max_objects=2), memory=mem_j,
                            refinement=JRefinementConfig(use_refinement=False), dtype="float32")
    tcfg = FrameworkConfig(xmem=XMemConfig(max_objects=2), memory=mem_t,
                           refinement=RefinementConfig(use_refinement=False), dtype="float32")
    jta = JTrackingAnything(cfg=jcfg, save_inner_masks_folder=str(root / "jax"))
    ckpt = str(root / "xmem.pth")
    torch.save(params_from_jax(jax.tree.map(np.asarray, jta.xmem_params)), ckpt)
    tta = TrackingAnything(xmem_checkpoint=ckpt, cfg=tcfg, device="cpu",
                           save_inner_masks_folder=str(root / "port"))
    frames, seed = _clip()
    out = {}
    for name, ta in (("jax", jta), ("port", tta)):
        masks = [ta.xmem.track(frames[0], seed)[0]]
        masks += [ta.xmem.track(f)[0] for f in frames[1:4]]
        out[name] = masks
    return jta, tta, frames, out, root


def test_save_inner_masks_folder_writes_the_jax_files(trackers):
    _, tta, _, masks, root = trackers
    for sub in ("xmem_masks", "refinement_masks"):
        names = sorted(os.listdir(root / "port" / "inner" / sub))
        assert names == sorted(os.listdir(root / "jax" / "inner" / sub))
        assert names == ["00001.png", "00002.png", "00003.png"]   # propagated frames only
        for i, n in enumerate(names):
            got = load_palette_mask(str(root / "port" / "inner" / sub / n))
            want = load_palette_mask(str(root / "jax" / "inner" / sub / n))
            assert got.shape == (H, W) and float((got == want).mean()) >= 0.999, (sub, n)
    # without refinement the refined mask is the returned mask
    for i, n in enumerate(("00001.png", "00002.png", "00003.png")):
        np.testing.assert_array_equal(
            load_palette_mask(str(root / "port" / "inner" / "refinement_masks" / n)),
            masks["port"][i + 1])
    assert tta.xmem._inner_ti == 3


def test_step_end_true_matches_jax(trackers):
    """The last frame's step: the same probabilities as a normal step, and
    no memory frame (frame 4 would be one: mem_every 2)."""
    jta, tta, frames, _, _ = trackers
    frame = frames[4]
    jstate, jcfg = jta.xmem.state, jta.xmem._track_cfg()
    tstate, tcfg = tta.xmem.state, tta.xmem._track_cfg()
    probs = {}
    for end in (True, False):
        js, jprob, _ = jcore.step(jta.xmem_params, jstate, jnp.asarray(frame), jcfg, end=end)
        ts = copy.deepcopy(tstate)
        ts, tprob, _ = tcore.step(tta.xmem_net, ts, torch.from_numpy(frame), tcfg, end=end)
        jprob, tprob = np.asarray(jprob), tprob.numpy()
        assert float(np.abs(tprob - jprob).max()) <= 1e-2, end
        assert float((tprob.argmax(0) == jprob.argmax(0)).mean()) >= 0.999, end
        probs[end] = tprob
        assert int(ts.last_mem_ti) == int(js.last_mem_ti)
        assert ts.memory.work.count == int(js.memory.work.count)
        same_keys = torch.equal(ts.memory.work.keys, tstate.memory.work.keys)
        if end:
            assert ts.last_mem_ti == tstate.last_mem_ti and same_keys
            assert ts.memory.work.count == tstate.memory.work.count
        else:                       # memorized (the full memory consolidates)
            assert ts.last_mem_ti == tstate.curr_ti + 1 and not same_keys
    np.testing.assert_array_equal(probs[True], probs[False])
