"""The port's app session (`vosesam_tpu_torch/app.py`) against the JAX
repo's `app.AppSession` on the CPU, on the same weights (the facades of
`tests/test_torch_serve.py`): the click -> add -> track -> inpaint flow,
`template_mask` selection, the resize path, `build_ui` without gradio,
video loading, and the inpaint guard that catches only
`torch.OutOfMemoryError`.

Tolerances: masks and painted frames >= 99.9% equal (fp32 summation order
may flip a logit near 0; ROADMAP C8); template masks equal; inpainted
frames equal to the input outside the dilated mask, bit for bit, and
inside it >= 98% of the values within 2 grey levels of JAX's (random
weights amplify rounding through the propagation; ROADMAP C19).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_serve import clip, jax_cfg, port_cfg, save_jax_weights
from vosesam_tpu.config import InpainterConfig as JInpainterConfig
from vosesam_tpu.models.e2fgvi import generator as JG
from vosesam_tpu.pipeline import inpaint as jinp
from vosesam_tpu.pipeline.track_anything import TrackingAnything as JTrackingAnything
from vosesam_tpu_torch import app as tapp
from vosesam_tpu_torch.config import InpainterConfig
from vosesam_tpu_torch.models.e2fgvi import generator as TG
from vosesam_tpu_torch.ops import morphology as morph
from vosesam_tpu_torch.pipeline import inpaint as tinp
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything
from vosesam_tpu_torch.utils.checkpoint import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import app as japp  # noqa: E402  (the JAX repo's root app.py)

AGREEMENT = 0.999
CLICKS = [(14.0, 12.0, True), (50.0, 35.0, False)]
SECOND = (48.0, 34.0, True)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jta = JTrackingAnything(cfg=jax_cfg())
    xpath, spath = save_jax_weights(jta, tmp_path_factory.mktemp("ckpt"))
    tta = TrackingAnything(sam_checkpoint=spath, xmem_checkpoint=xpath, cfg=port_cfg(),
                           device="cpu")
    return jta, tta


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def _sessions(models, **kw):
    jta, tta = models
    frames, _ = clip()
    js, ts = japp.AppSession(jta, **kw), tapp.AppSession(tta, **kw)
    js.frames, ts.frames = list(frames), list(frames)
    return js, ts


def _click_two_objects(js, ts):
    for s in (js, ts):
        s.select_template(0)
    for x, y, pos in CLICKS:
        jp, tp = js.click(x, y, pos), ts.click(x, y, pos)
        assert tp.shape == jp.shape and tp.dtype == np.uint8
        assert _agree(tp, jp) >= AGREEMENT
        assert _agree(ts.current_mask, js.current_mask) >= AGREEMENT
    assert ts.add_mask() == js.add_mask() == 1
    x, y, pos = SECOND
    js.click(x, y, pos)
    ts.click(x, y, pos)
    assert ts.add_mask() == js.add_mask() == 2


def test_click_add_track_inpaint_flow_matches_jax(models):
    js, ts = _sessions(models)
    _click_two_objects(js, ts)
    assert ts.clicks == [] and ts.current_mask is None
    assert _agree(ts.template_mask(), js.template_mask()) >= AGREEMENT
    jm, jp, jsc = js.track()
    tm, tp, tsc = ts.track()
    assert len(tm) == len(jm) == len(ts.frames)
    assert ts.last_masks is tm
    for a, b in zip(tm, jm):
        assert _agree(a, b) >= AGREEMENT
    for a, b in zip(tp, jp):
        assert _agree(a, b) >= AGREEMENT
    for a, b in zip(tsc, jsc):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)

    # inpaint the tracked masks with the same E2FGVI weights on both sides
    jcfg = JInpainterConfig(num_blocks=1)
    jparams = JG.generator_init(jax.random.PRNGKey(0), jcfg)
    tcfg = InpainterConfig(num_blocks=1)
    net = TG.InpaintGenerator(tcfg)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), strict=True)
    js.model.baseinpainter = jinp.Inpainter(cfg=jcfg, params=jparams)
    ts.model.baseinpainter = tinp.Inpainter(cfg=tcfg, net=net, device="cpu")
    try:
        want = np.stack(js.inpaint(tm))
        got = np.stack(ts.inpaint(tm))
    finally:
        js.model.baseinpainter = ts.model.baseinpainter = None
    frames = np.stack(ts.frames)
    dil = morph.dilate(torch.from_numpy(np.stack([m > 0 for m in tm])),
                       tcfg.dilate_radius).numpy()
    assert got.shape == frames.shape and dil.any()
    np.testing.assert_array_equal(got[~dil], frames[~dil])
    # neither side fell back to the originals: the holes were filled
    assert (got[dil] != frames[dil]).mean() > 0.5 and (want[dil] != frames[dil]).mean() > 0.5
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))[dil]
    assert (d <= 2).mean() >= 0.98, (d <= 2).mean()


def test_template_mask_selection_matches_jax(models):
    js, ts = _sessions(models)
    with pytest.raises(ValueError, match="no masks"):
        ts.template_mask()
    a = np.zeros((48, 64), bool)
    a[2:10, 3:12] = True
    b = np.zeros((48, 64), bool)
    b[20:30, 30:50] = True
    # the in-progress click mask when nothing is saved
    js.current_mask, ts.current_mask = a, a
    np.testing.assert_array_equal(ts.template_mask(), js.template_mask())
    js.masks, ts.masks = [a, b], [a, b]
    for sel in (None, [1], [0, 1], [1, 0], [5, 1]):
        np.testing.assert_array_equal(ts.template_mask(sel), js.template_mask(sel))
    for s in (ts, js):
        with pytest.raises(ValueError, match="no masks"):
            s.template_mask([])
    assert ts.template_mask([1]).max() == 1 and ts.template_mask([1])[25, 40] == 1
    assert ts.remove_mask() == 1 and ts.remove_mask() == 0 and ts.remove_mask() == 0


def test_resize_path_matches_jax(models):
    js, ts = _sessions(models, resize_ratio=0.5, track_chunk=None)
    _click_two_objects(js, ts)
    jm, _, _ = js.track()
    tm, tp, _ = ts.track()
    assert tm[0].shape == (24, 32) and tp[0].shape == (24, 32, 3)
    for a, b in zip(tm, jm):
        assert _agree(a, b) >= AGREEMENT


def test_track_end_and_template_index(models):
    js, ts = _sessions(models)
    _click_two_objects(js, ts)
    for s in (js, ts):
        s.select_template(1)
        s.track_end = 4
    tm, _, _ = ts.track()
    jm, _, _ = js.track()
    assert len(tm) == len(jm) == 3
    for a, b in zip(tm, jm):
        assert _agree(a, b) >= AGREEMENT


def test_build_ui_raises_without_gradio(models):
    _, tta = models
    with pytest.raises(ImportError, match="gradio"):
        tapp.build_ui(tapp.AppSession(tta))


class _Failing:
    def __init__(self, exc):
        self.exc = exc

    def inpaint(self, *a, **k):
        raise self.exc


def test_inpaint_guard_catches_only_out_of_memory(models, capsys):
    _, tta = models
    frames, _ = clip(3)
    session = tapp.AppSession(tta, frames=list(frames))
    masks = [np.ones((48, 64), np.uint8)] * 3
    try:
        tta.baseinpainter = _Failing(torch.OutOfMemoryError("CUDA out of memory"))
        out = session.inpaint(masks)
        assert all(np.array_equal(a, b) for a, b in zip(out, frames))
        assert "out of device memory" in capsys.readouterr().err
        tta.baseinpainter = _Failing(RuntimeError("memory_read kernel launch failed"))
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            session.inpaint(masks)
    finally:
        tta.baseinpainter = None


def test_inpaint_builds_an_inpainter_on_the_models_device(models, monkeypatch):
    _, tta = models
    made = []

    class Recorder:
        def __init__(self, checkpoint, cfg, device=None):
            made.append((checkpoint, cfg, device))

        def inpaint(self, frames, masks, ratio):
            return [f.copy() for f in frames]

    monkeypatch.setattr(tinp, "Inpainter", Recorder)
    frames, _ = clip(2)
    session = tapp.AppSession(tta, frames=list(frames), resize_ratio=0.5)
    try:
        out = session.inpaint([np.zeros((48, 64), np.uint8)] * 2)
        assert made == [(None, tta.cfg.inpainter, tta.device)]
        assert isinstance(tta.baseinpainter, Recorder) and len(out) == 2
    finally:
        tta.baseinpainter = None


def test_load_video_resets_the_session(models, tmp_path):
    imageio = pytest.importorskip("imageio")
    _, tta = models
    frames, _ = clip(4)
    path = str(tmp_path / "clip.gif")
    imageio.mimwrite(path, frames)
    session = tapp.AppSession(tta, template_idx=2, masks=[np.ones((2, 2))],
                              clicks=[[1.0, 1.0]], click_labels=[1])
    assert session.load_video(path) == 4
    assert session.template_idx == 0 and session.masks == [] and session.clicks == []
    assert session.frames[0].shape == (48, 64, 3)
    assert tapp.get_frames_from_video(path)[1].shape == (48, 64, 3)


def test_sessions_keep_their_own_state(models):
    _, tta = models
    a, b = tapp.AppSession(tta), tapp.AppSession(tta)
    a.masks.append(np.ones((2, 2)))
    assert b.masks == [] and dataclasses.fields(tapp.AppSession)
