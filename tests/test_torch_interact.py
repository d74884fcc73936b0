"""The port's interactive SAM entry points against the JAX package on the
CPU, fp32: `predict` / `select_best`, `SamController.first_frame_click`
(one pass and two), the click painters, `generate_masks`, the facade's
`first_frame_click` / `parse_augment`, and `Tracker(paint=False)`.

Both sides get the same weights (the JAX `sam_init`, converted by the
port's `params_from_jax`) and the same numpy inputs, at the TINY config of
`tests/test_pipeline.py` (vit_b at 64 wide, 2 blocks, 7x7 windows, a 128
square: an 8x8 token grid, four windows).

Tolerances: full-resolution and low-res logits within atol 1e-3 / rtol 1e-4
and predicted IoU within 1e-4 (fp32 summation order, as the decoder test of
test_torch_sam.py); masks >= 99.9% of pixels equal (a logit that crosses 0
within that error may flip; measured 100% here); painted images at most 1
apart in uint8 wherever the masks agree within the contour band's reach.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.config import SAMConfig as JSAMConfig
from vosesam_tpu.models.sam import automatic as jauto
from vosesam_tpu.models.sam import predictor as jpred
from vosesam_tpu.pipeline.interact import SamController as JSamController
from vosesam_tpu.viz import painter as jpaint
from vosesam_tpu_torch.config import (
    FrameworkConfig,
    MemoryConfig,
    RefinementConfig,
    SAMConfig,
    XMemConfig,
)
from vosesam_tpu_torch.models.sam import automatic as tauto
from vosesam_tpu_torch.models.sam import predictor as tpred
from vosesam_tpu_torch.pipeline import track_anything as tta
from vosesam_tpu_torch.pipeline.interact import SamController
from vosesam_tpu_torch.utils.checkpoint import params_from_jax
from vosesam_tpu_torch.viz import painter as tpaint

H, W = 48, 64
TINY = dict(model_type="vit_b", image_size=128, window_size=7,
            vit_dims=(("vit_b", 64, 2, 2, (1,)),))
LOGIT_ATOL, LOGIT_RTOL = 1e-3, 1e-4
IOU_TOL = 1e-4
AGREEMENT = 0.999


def _image():
    img = np.random.default_rng(0).integers(0, 255, (H, W, 3), np.uint8)
    img[10:24, 10:30] = [255, 40, 40]
    return img


_PAIRS = {}


def _pair(hq: bool):
    """(JAX params, JAX cfg, port model, port cfg) with equal weights."""
    if hq not in _PAIRS:
        jc, tc = JSAMConfig(**TINY, hq=hq), SAMConfig(**TINY, hq=hq)
        params = jpred.sam_init(jax.random.PRNGKey(1), jc)
        sam = tpred.Sam(tc)
        sam.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
        _PAIRS[hq] = (params, jc, sam.eval(), tc)
    return _PAIRS[hq]


def _agree(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("hq", [False, True])
def test_predict_and_select_best_match_jax(hq, multimask):
    params, jc, sam, tc = _pair(hq)
    img = _image()
    je = jpred.encode_image(params, jnp.asarray(img), jc)
    te = tpred.encode_image(sam, torch.from_numpy(img)[None], tc)
    coords = np.array([[20.0, 15.0], [50.0, 40.0], [0.0, 0.0]], np.float32)
    labels = np.array([1, 0, -1], np.int32)
    mask_in = np.random.default_rng(3).standard_normal((32, 32)).astype(np.float32)
    for mi in (None, mask_in):
        want = jpred.predict(params, je, jnp.asarray(coords), jnp.asarray(labels),
                             None if mi is None else jnp.asarray(mi), jc)
        got = tpred.predict(sam, te, torch.from_numpy(coords), torch.from_numpy(labels).long(),
                            None if mi is None else torch.from_numpy(mi), tc)
        n = 5 if hq else 4
        assert got.masks.shape == (n, H, W) and got.masks.dtype == torch.bool
        assert got.low_res.shape == (n, 32, 32) and got.iou.shape == (n,)
        np.testing.assert_allclose(got.logits_full.numpy(), np.asarray(want.logits_full),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        np.testing.assert_allclose(got.low_res.numpy(), np.asarray(want.low_res),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        np.testing.assert_allclose(got.iou.numpy(), np.asarray(want.iou), atol=IOU_TOL,
                                   rtol=IOU_TOL)
        assert _agree(got.masks.numpy(), want.masks) >= AGREEMENT
        jm, jl, js, jlow = jpred.select_best(want, jc, multimask)
        tm, tl, ts, tlow = tpred.select_best(got, tc, multimask)
        assert tm.shape == (H, W) and tlow.shape == (32, 32) and ts.shape == ()
        assert _agree(tm.numpy(), jm) >= AGREEMENT
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        np.testing.assert_allclose(tlow.numpy(), np.asarray(jlow), atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL)
        np.testing.assert_allclose(float(ts), float(js), atol=IOU_TOL, rtol=IOU_TOL)


def test_predict_batch_equals_single_packs():
    """`predict` over a batch of packs (as `generate_masks` calls it) gives
    each pack's single-pack prediction."""
    _, _, sam, tc = _pair(False)
    te = tpred.encode_image(sam, torch.from_numpy(_image())[None], tc)
    pts = torch.tensor([[[20.0, 15.0]], [[50.0, 40.0]], [[5.0, 30.0]]])
    lbl = torch.ones((3, 1), dtype=torch.long)
    batch = tpred.predict(sam, te, pts, lbl, None, tc)
    assert batch.masks.shape == (3, 4, H, W)
    for i in range(3):
        one = tpred.predict(sam, te, pts[i], lbl[i], None, tc)
        np.testing.assert_allclose(batch.logits_full[i].numpy(), one.logits_full.numpy(),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(batch.iou[i].numpy(), one.iou.numpy(), atol=1e-5, rtol=1e-5)


def _grow(diff: np.ndarray, r: int) -> np.ndarray:
    """Pixels within r (Chebyshev) of a True pixel."""
    out = diff.copy()
    p = np.pad(diff, r)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            out |= p[dy:dy + diff.shape[0], dx:dx + diff.shape[1]]
    return out


CLICKS = {
    "one_pass": (np.array([[20.0, 15.0]]), np.array([1])),
    "two_pass": (np.array([[20.0, 15.0], [50.0, 40.0], [22.0, 16.0]]), np.array([1, 0, 1])),
    "negative_last": (np.array([[20.0, 15.0], [50.0, 40.0]]), np.array([1, 0])),
}


@pytest.mark.parametrize("case", sorted(CLICKS))
@pytest.mark.parametrize("hq", [False, True])
def test_first_frame_click_matches_jax(hq, case):
    params, jc, sam, tc = _pair(hq)
    img = _image()
    pts, lbl = CLICKS[case]
    jm, jlogit, jpainted = JSamController(params, jc).first_frame_click(img, pts, lbl)
    ctl = SamController(sam, tc, device="cpu")
    tm, tlogit, tpainted = ctl.first_frame_click(img, pts, lbl)
    assert tm.shape == (H, W) and tm.dtype == bool
    assert tlogit.shape == (32, 32) and tlogit.dtype == np.float32
    assert tpainted.shape == (H, W, 3) and tpainted.dtype == np.uint8
    assert _agree(tm, jm) >= AGREEMENT
    np.testing.assert_allclose(tlogit, jlogit, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    # the contour band reaches 2 pixels (dilate / erode by 2): compare the
    # paint wherever the masks agree within that reach
    same = ~_grow(tm != jm, 3)
    d = np.abs(tpainted.astype(np.int16) - jpainted.astype(np.int16))
    assert d[same].max() <= 1
    # the cached embedding answers the next click; reset drops it
    assert ctl.emb is not None
    again = ctl.first_frame_click(img, pts, lbl)
    np.testing.assert_array_equal(again[0], tm)
    ctl.reset_image()
    assert ctl.emb is None


def test_click_pack_and_two_pass_rule(monkeypatch):
    """The pack is the raw clicks plus ONE (0, 0, -1) pad point; the second
    pass runs only with more than one click, the last positive and a negative
    among them."""
    from vosesam_tpu_torch.pipeline import interact

    _, _, sam, tc = _pair(False)
    seen = []
    real = interact.click_full

    def spy(sam_, emb, image, coords, labels, cfg, multimask, two_pass):
        seen.append((coords.numpy().copy(), labels.numpy().copy(), two_pass))
        return real(sam_, emb, image, coords, labels, cfg, multimask, two_pass)

    monkeypatch.setattr(interact, "click_full", spy)
    ctl = SamController(sam, tc, device="cpu")
    for case, want_two in (("one_pass", False), ("two_pass", True), ("negative_last", False)):
        pts, lbl = CLICKS[case]
        ctl.first_frame_click(_image(), pts, lbl)
        coords, labels, two_pass = seen[-1]
        assert two_pass is want_two
        np.testing.assert_array_equal(coords, np.concatenate([pts, [[0.0, 0.0]]]))
        np.testing.assert_array_equal(labels, np.concatenate([lbl, [-1]]))


def test_painters_match_jax():
    """uint8 outputs at most 1 apart (both blend in fp32 and truncate)."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (H, W, 3), np.uint8)
    mask = np.zeros((H, W), bool)
    mask[8:30, 12:40] = True
    mask[20:25, 20:30] = False
    mask |= rng.random((H, W)) > 0.97
    pts = np.array([[20.0, 15.0], [50.5, 40.2], [0.0, 0.0], [63.0, 47.0]], np.float32)
    valid = np.array([True, True, False, True])
    color = np.array([255, 99, 71], np.uint8)
    want = np.asarray(jpaint.mask_painter(jnp.asarray(img), jnp.asarray(mask),
                                          jnp.asarray(color)))
    got = tpaint.mask_painter(torch.from_numpy(img), torch.from_numpy(mask), (255, 99, 71))
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(np.int16) - want.astype(np.int16)).max() <= 1
    # a float mask and a tensor colour, alpha and width set
    want = np.asarray(jpaint.mask_painter(jnp.asarray(img), jnp.asarray(mask, jnp.float32),
                                          jnp.asarray(color), alpha=0.4, contour_width=1))
    got = tpaint.mask_painter(torch.from_numpy(img), torch.from_numpy(mask).float(),
                              torch.from_numpy(color), alpha=0.4, contour_width=1)
    assert np.abs(got.numpy().astype(np.int16) - want.astype(np.int16)).max() <= 1
    want = np.asarray(jpaint.point_painter(jnp.asarray(img), jnp.asarray(pts),
                                           jnp.asarray(valid), jnp.asarray([0, 255, 0])))
    got = tpaint.point_painter(torch.from_numpy(img), torch.from_numpy(pts),
                               torch.from_numpy(valid), (0, 255, 0))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != img).any() and (got.numpy()[2, 2] == img[2, 2]).all()
    want = np.asarray(jpaint.background_remover(jnp.asarray(img), jnp.asarray(mask)))
    got = tpaint.background_remover(torch.from_numpy(img), torch.from_numpy(mask))
    assert got.shape == (H, W, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_masks_matches_jax():
    """A 4x4 point grid in batches of 6 (the last batch is padded and cut),
    thresholds low enough that random-weight masks survive: the same points
    kept in the same order, scores within 1e-4, masks by agreement."""
    params, jc, sam, tc = _pair(False)
    img = _image()
    kw = dict(points_per_side=4, pred_iou_thresh=-1e3, stability_thresh=0.0, nms_iou=0.7,
              batch=6)
    want = jauto.generate_masks(params, img, jc, **kw)
    got = tauto.generate_masks(sam, img, tc, device="cpu", **kw)
    assert len(want.masks) > 0
    assert got.masks.dtype == bool and got.masks.shape[1:] == (H, W)
    np.testing.assert_allclose(got.points, want.points)
    np.testing.assert_allclose(got.scores, want.scores, atol=IOU_TOL, rtol=IOU_TOL)
    for a, b in zip(got.masks, want.masks):
        assert _agree(a, b) >= AGREEMENT
    # the thresholds filter: nothing passes an impossible IoU threshold
    none = tauto.generate_masks(sam, img, tc, device="cpu", **dict(kw, pred_iou_thresh=1e3))
    assert none.masks.shape == (0, H, W) and none.points.shape == (0, 2)


@pytest.mark.parametrize("value", [0.0, -3.0, 2.5])
def test_stability_score_matches_jax(value):
    logits = np.random.default_rng(8).standard_normal((3, 20, 30)).astype(np.float32) * 3
    want = np.asarray(jauto._stability_score(jnp.asarray(logits), value, 1.0))
    got = tauto._stability_score(torch.from_numpy(logits), value, 1.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def _tracking_cfg(use_refinement: bool) -> FrameworkConfig:
    return FrameworkConfig(
        xmem=XMemConfig(max_objects=2),
        memory=MemoryConfig(max_mid_term_frames=3, min_mid_term_frames=2,
                            max_long_term_elements=64, num_prototypes=8, top_k=8, mem_every=2),
        sam=SAMConfig(**TINY),
        refinement=RefinementConfig(use_refinement=use_refinement, mode="both_neg",
                                    min_region_area=10.0),
        dtype="float32")


def test_facade_click_and_parse_augment(monkeypatch):
    ta = tta.TrackingAnything(cfg=_tracking_cfg(True), device="cpu")
    assert isinstance(ta.samcontroler, SamController)
    pts, lbl = CLICKS["two_pass"]
    mask, logit, painted = ta.first_frame_click(_image(), pts, lbl)
    assert mask.shape == (H, W) and mask.dtype == bool
    assert logit.shape == (32, 32) and painted.shape == (H, W, 3)
    direct = SamController(ta.sam, ta.cfg.sam, device="cpu").first_frame_click(
        _image(), pts, lbl)
    np.testing.assert_array_equal(mask, direct[0])
    assert tta.TrackingAnything(cfg=_tracking_cfg(False), device="cpu").samcontroler is None
    monkeypatch.setattr(sys, "argv", ["prog"])
    args = tta.parse_augment()
    assert args.device == "cuda" and args.sam_model_type == "vit_h" and args.port == 6080
    monkeypatch.setattr(sys, "argv", ["prog", "--device", "cpu", "--debug"])
    assert tta.parse_augment().device == "cpu"


@pytest.mark.parametrize("use_refinement", [False, True])
def test_tracker_without_paint(use_refinement):
    """`Tracker(paint=False)`: the masks, logits and scores of `paint=True`,
    and the frame itself in the painted slot."""
    from vosesam_tpu_torch.inference.tracker import Tracker

    ta = tta.TrackingAnything(cfg=_tracking_cfg(use_refinement), device="cpu")
    bare = Tracker(ta.xmem_net, ta.cfg, device="cpu", sam=ta.sam, paint=False)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (H, W, 3), np.uint8)
    seed = np.zeros((H, W), np.uint8)
    seed[10:24, 10:30] = 3
    for i in range(3):
        f = base.copy()
        f[10 + i:24 + i, 10 + i:30 + i] = [255, 40, 40]
        ann = seed if i == 0 else None
        m1, lg1, p1, s1 = ta.xmem.track(f, ann)
        m0, lg0, p0, s0 = bare.track(f, ann)
        assert p0 is f
        assert p1.shape == (H, W, 3) and p1 is not f
        np.testing.assert_array_equal(m0, m1)
        np.testing.assert_array_equal(lg0, lg1)
        assert s0 == s1
