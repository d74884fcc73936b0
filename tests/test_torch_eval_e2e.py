"""End to end, `baseline` (XMem only): the port and the JAX package track
the same synthetic DAVIS (2 videos) and LongDataset (sparse ground truth)
trees with the same weights (the JAX inits, carried across as
official-schema checkpoints), through their own runners. The refining
config (`both_neg_C`) is test_torch_eval_refined.py, with these helpers.

Tolerance: indexed masks agree per frame on >= 99.9% of pixels. Where every
frame's masks are equal the metrics must be equal (the same numpy code on
the same inputs). Where d pixels of a frame differ, an object's J moves by
at most 2 d / (its union with the ground truth), and so does the mean over
objects and frames; F and AP are not bounded by a pixel count (a boundary
pixel or an IoU threshold can flip), so they are held equal only on equal
masks. No test reads the reference checkout (ROADMAP C1).
"""

import math
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_eval import small_tree
from vosesam_tpu.config import FrameworkConfig as JFrameworkConfig
from vosesam_tpu.config import MemoryConfig as JMemoryConfig
from vosesam_tpu.config import RefinementConfig as JRefinementConfig
from vosesam_tpu.config import SAMConfig as JSAMConfig
from vosesam_tpu.config import XMemConfig as JXMemConfig
from vosesam_tpu.eval import datasets as jds
from vosesam_tpu.eval import palette as jpal
from vosesam_tpu.eval import runner as jrun
from vosesam_tpu.pipeline.track_anything import TrackingAnything as JTrackingAnything
from vosesam_tpu.utils.checkpoint import tree_to_state_dict
from vosesam_tpu_torch.config import (
    FrameworkConfig,
    MemoryConfig,
    RefinementConfig,
    SAMConfig,
    XMemConfig,
)
from vosesam_tpu_torch.eval import datasets as tds
from vosesam_tpu_torch.eval import palette as tpal
from vosesam_tpu_torch.eval import runner as trun
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything
from vosesam_tpu_torch.utils.checkpoint import params_from_jax

AGREEMENT = 0.999


TINY = dict(model_type="vit_b", image_size=128, window_size=7,
            vit_dims=(("vit_b", 64, 2, 2, (1,)),), hq=True, encode_rect=True)
MEM = dict(max_mid_term_frames=3, min_mid_term_frames=2, max_long_term_elements=64,
           num_prototypes=8, top_k=8, mem_every=2)
CONVT = {f"mask_decoder.{m}.{i}.weight": "conv_transpose"
         for m in ("output_upscaling", "compress_vit_feat", "embedding_encoder") for i in (0, 3)}
E2E_CONFIGS = {"baseline": dict(use_refinement=False),
               "both_neg_C": dict(mode="both_neg", point_algorithm="C", optimized=False,
                                  min_region_area=10.0)}


def _cfgs(name):
    rk = E2E_CONFIGS[name]
    j = JFrameworkConfig(xmem=JXMemConfig(max_objects=2), memory=JMemoryConfig(**MEM),
                         sam=JSAMConfig(**TINY), refinement=JRefinementConfig(**rk),
                         dtype="float32")
    t = FrameworkConfig(xmem=XMemConfig(max_objects=2), memory=MemoryConfig(**MEM),
                        sam=SAMConfig(**TINY), refinement=RefinementConfig(**rk),
                        dtype="float32")
    return j, t


def make_models(name, d):
    """The JAX facade (XMem PRNGKey(0), SAM PRNGKey(1)) and the port's facade
    on the same weights, read from official-schema files written under d."""
    jc, tc = _cfgs(name)
    jta = JTrackingAnything(cfg=jc)
    xpath = d / "xmem.pth"
    torch.save(params_from_jax(jax.tree.map(np.asarray, jta.xmem_params)), xpath)
    spath = None
    if jta.sam_params is not None:
        spath = d / "sam_hq.pth"
        sd = tree_to_state_dict(jax.tree.map(np.asarray, jta.sam_params)._asdict(),
                                transpose_spec=CONVT)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, spath)
    tta = TrackingAnything(sam_checkpoint=str(spath) if spath else None,
                           xmem_checkpoint=str(xpath), cfg=tc, device="cpu")
    return jta, tta


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    return small_tree(str(tmp_path_factory.mktemp("tree")))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return make_models("baseline", tmp_path_factory.mktemp("ckpt"))


def _agreement(a, b):
    return min(float((x == y).mean()) for x, y in zip(a, b))


def _hold(trow, jrow, tmasks, jmasks, gts):
    """J / F / AP of one video: equal where every frame's masks are equal,
    else J within 2 d / (smallest union of an object with its ground truth)."""
    d = max(int((x != y).sum()) for x, y in zip(tmasks, jmasks))
    if d == 0:
        for k in ("J_mean", "F_mean", "JF_mean", "AP", "AP50", "AP75"):
            assert trow[k] == jrow[k] or (math.isnan(trow[k]) and math.isnan(jrow[k])), k
        return
    unions = [int(((m == lab) | (g == lab)).sum()) for m, g in zip(tmasks, gts) if g is not None
              for lab in np.unique(g)[1:]]
    assert abs(trow["J_mean"] - jrow["J_mean"]) <= 2 * d / max(min(unions), 1)


def davis_end_to_end(jta, tta, png_tree):
    """Both runners on the DAVIS 2017 tree (cwd: a fresh directory); masks
    and metrics held per video."""
    root = os.path.join(png_tree[0], "DAVIS")
    jrows = jrun.run_model_on_davis_set("jax", jta, jds.DavisDataset(root), save_masks=True)
    trows = trun.run_model_on_davis_set("port", tta, tds.DavisDataset(root), save_masks=True)
    for (_, jrow), trow in zip(jrows.iterrows(), trows):
        video = trow["video"]
        mdir = f"result/{{}}/masks/{video}"
        files = sorted(os.listdir(mdir.format("jax")))
        tm_ = [tpal.load_palette_mask(os.path.join(mdir.format("port"), f)) for f in files]
        jm_ = [jpal.load_palette_mask(os.path.join(mdir.format("jax"), f)) for f in files]
        assert _agreement(tm_, jm_) >= AGREEMENT, video
        gts = [tds.DavisDataset(root).load_mask(video, f) for f in files]
        _hold(trow, jrow, tm_, jm_, gts)


def test_davis_end_to_end_matches_jax(models, png_tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    davis_end_to_end(*models, png_tree)


def test_longdataset_end_to_end_matches_jax(models, png_tree, tmp_path, monkeypatch):
    """Sparse ground truth (every 2nd frame): the generator's masks are kept
    on every frame, the metrics read at the annotated ones."""
    jta, tta = models
    root = os.path.join(png_tree[0], "LongDataset")
    monkeypatch.chdir(tmp_path)
    masks, rows = {}, {}
    for pkg, ds, model, rn in ((jrun, jds, jta, "jax"), (trun, tds, tta, "port")):
        real = model.generator

        def keep(frames, template, real=real, rn=rn):
            out = real(frames, template)
            masks[rn] = out[0]
            return out

        model.generator = keep
        try:
            got = pkg.run_model_on_longdata_set(rn, model, ds.LongVideoDataset(root))
        finally:
            del model.generator
        rows[rn] = got.iloc[0].to_dict() if rn == "jax" else got[0]
    assert _agreement(masks["port"], masks["jax"]) >= AGREEMENT
    info = tds.LongVideoDataset(root).video_info("clip")
    gts = [tds.LongVideoDataset(root).load_mask("clip", f) if i in info["test_ids"] else None
           for i, f in enumerate(info["frames"])]
    _hold(rows["port"], rows["jax"], masks["port"], masks["jax"], gts)
