"""The port's evaluation harness (`vosesam_tpu_torch/eval/`, the
`run_*_test` entry points) against the JAX package's, on the CPU.

  - metrics: the same seeded masks through both packages' functions, equal
    results (the port's metrics are the same numpy code);
  - RLE (both COCO forms), palette PNGs written by one package and read by
    the other, the PNG codec against Pillow, the native JPEG path;
  - the dataset loaders on a PNG tree written by the port's synthetic writer
    and on a JPEG tree: the same frames, test ids, object counts, frames
    and masks;
  - harness parity: both packages' runners driven by one deterministic mock
    model (fixed masks and scores, non-contiguous labels) write the same
    whole_metrics / per_object_metrics / <video>_scores / all_tests rows,
    compared as parsed CSV apart from the fps columns;
  - the DAVIS entry point on the CPU; `batched=` through a stand-in
    generator and `--mesh` larger than the process group raising (the
    batched runs themselves: test_torch_parallel_eval.py).

The two packages tracking the same trees end to end: test_torch_eval_e2e.py
(`baseline`) and test_torch_eval_refined.py (`both_neg_C`). No test reads
the reference checkout (ROADMAP C1).
"""

import csv
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from vosesam_tpu.eval import datasets as jds
from vosesam_tpu.eval import metrics as jm
from vosesam_tpu.eval import ovis as jovis
from vosesam_tpu.eval import palette as jpal
from vosesam_tpu.eval import rle as jrle
from vosesam_tpu.eval import runner as jrun
from vosesam_tpu.utils.mask_mapper import MaskMapper as JMaskMapper
from vosesam_tpu_torch import run_davis_test
from vosesam_tpu_torch.eval import codec, synthetic
from vosesam_tpu_torch.eval import datasets as tds
from vosesam_tpu_torch.eval import metrics as tm
from vosesam_tpu_torch.eval import ovis as tovis
from vosesam_tpu_torch.eval import palette as tpal
from vosesam_tpu_torch.eval import rle as trle
from vosesam_tpu_torch.eval import runner as trun
from vosesam_tpu_torch.utils.mask_mapper import MaskMapper as TMaskMapper

H, W = 48, 64
FPS = "fps"


# ------------------------------------------------------------------ metrics

def _masks(seed, n=6, labels=(0, 3, 7)):
    """Blobby label maps: a few seeded rectangles per frame."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = np.zeros((H, W), np.uint8)
        for lab in labels[1:]:
            y, x = r.integers(0, H - 12), r.integers(0, W - 14)
            m[y:y + r.integers(4, 12), x:x + r.integers(4, 14)] = lab
        out.append(m)
    return out


@pytest.fixture(scope="module")
def pair():
    return _masks(1), _masks(2)


@pytest.mark.parametrize("fn", ["calculate_iou", "frame_iou", "compute_f_measure"])
def test_frame_metrics_equal_jax(pair, fn):
    for p, g in zip(*pair):
        assert getattr(tm, fn)(p, g) == getattr(jm, fn)(p, g)


@pytest.mark.parametrize("bound_th", [0.008, 0.05, 3])
def test_boundary_equals_jax(pair, bound_th):
    for p, g in zip(*pair):
        np.testing.assert_array_equal(tm.seg2bmap(p), jm.seg2bmap(p))
        assert tm.db_eval_boundary(p > 0, g > 0, bound_th) == \
            jm.db_eval_boundary(p > 0, g > 0, bound_th)


@pytest.mark.parametrize("n", [0, 3, 4, 9])
def test_db_statistics_equal_jax(n):
    v = np.random.default_rng(n).random(n)
    assert tm.db_statistics(v) == jm.db_statistics(v)


def test_true_positives_and_ap_equal_jax(pair):
    rows_t, rows_j = [], []
    r = np.random.default_rng(3)
    for p, g in zip(*pair):
        scores = {3: float(r.random()), 7: float(r.random())}
        rows_t += tm.true_positives(p, g, scores)
        rows_j += jm.true_positives(p, g, scores)
    assert rows_t == rows_j
    at, aj = tm.calculate_video_AP(rows_t), jm.calculate_video_AP(rows_j)
    assert at.keys() == aj.keys()
    for k in at:
        assert at[k] == aj[k] or (math.isnan(at[k]) and math.isnan(aj[k])), k


def test_video_metrics_equal_jax(pair):
    pred, gt = pair
    gt = [g if i % 2 == 0 else None for i, g in enumerate(gt)]   # sparse GT
    a, b = tm.compute_all_video_metrics(pred, gt), jm.compute_all_video_metrics(pred, gt)
    assert a == b


def test_rle_both_forms_equal_jax(pair):
    for m in pair[0]:
        obj = (m == 3).astype(np.uint8)
        plain = jrle.encode_rle(obj)
        assert trle.encode_rle(obj) == plain
        packed = synthetic.encode_rle_string(obj)
        assert isinstance(packed["counts"], str)
        for rle in (plain, packed):
            np.testing.assert_array_equal(trle.decode_rle(rle), obj)
            np.testing.assert_array_equal(jrle.decode_rle(rle), obj)


# ------------------------------------------------------------------- images

def test_palette_png_round_trips_across_packages(tmp_path, pair):
    np.testing.assert_array_equal(tpal.pascal_colormap(), jpal.pascal_colormap())
    m = pair[0][0]
    tpal.save_palette_mask(m, str(tmp_path / "t.png"))
    jpal.save_palette_mask(m, str(tmp_path / "j.png"))
    for f in ("t.png", "j.png"):
        np.testing.assert_array_equal(jpal.load_palette_mask(str(tmp_path / f)), m)
        np.testing.assert_array_equal(tpal.load_palette_mask(str(tmp_path / f)), m)
    im = Image.open(tmp_path / "t.png")
    assert im.mode == "P"
    assert im.getpalette()[:768] == tpal.pascal_colormap().reshape(-1).tolist()


def test_small_palettes_and_greyscale_read_as_pillow(tmp_path):
    """Pillow writes a 4-colour palette at 2 bits a pixel, 16 colours at 4:
    the port's reader unpacks them; a greyscale PNG reads as Pillow's
    convert("P") reads it."""
    r = np.random.default_rng(0)
    for n in (2, 4, 16):
        idx = r.integers(0, n, (H, W + 3)).astype(np.uint8)
        im = Image.fromarray(idx, "P")
        im.putpalette(list(range(3 * n)))
        im.save(tmp_path / f"p{n}.png")
        np.testing.assert_array_equal(codec.png_indices(str(tmp_path / f"p{n}.png")), idx)
        np.testing.assert_array_equal(codec.png_rgb(str(tmp_path / f"p{n}.png")),
                                      np.array(Image.open(tmp_path / f"p{n}.png").convert("RGB")))
    grey = r.integers(0, 256, (H, W)).astype(np.uint8)
    Image.fromarray(grey, "L").save(tmp_path / "g.png")
    np.testing.assert_array_equal(codec.png_indices(str(tmp_path / "g.png")),
                                  np.array(Image.open(tmp_path / "g.png").convert("P")))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_png_frames_read_as_pillow(tmp_path, mode):
    """Pillow's PNGs (its row filters included) read as Pillow's
    convert("RGB"); the port's RGB PNGs read back through Pillow."""
    r = np.random.default_rng(1)
    ch = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
    px = r.integers(0, 256, (H, W, ch)).astype(np.uint8)
    px[:, :W // 2] //= 8                    # smooth half: other row filters win there
    Image.fromarray(px[..., 0] if ch == 1 else px, mode).save(tmp_path / "f.png")
    want = np.array(Image.open(tmp_path / "f.png").convert("RGB"))
    np.testing.assert_array_equal(codec.read_rgb(str(tmp_path / "f.png")), want)
    codec.write_png_rgb(str(tmp_path / "o.png"), want)
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "o.png")), want)


def test_jpeg_without_a_decoder_raises(monkeypatch, tmp_path):
    """No native loader and no Pillow: an ImportError that names both,
    never another decoder."""
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "a.jpg")
    broken = codec._Native()
    monkeypatch.setattr(broken, "_load", lambda: (None, "no libjpeg here"))
    monkeypatch.setattr(codec, "_NATIVE", broken)
    monkeypatch.setattr(codec, "_pillow", lambda: None)
    with pytest.raises(ImportError, match="native loader.*no libjpeg here.*Pillow"):
        codec.decode_jpegs([str(tmp_path / "a.jpg")])


# ----------------------------------------------------------------- datasets

def small_tree(root):
    """The synthetic trees at 48 x 64, PNG frames, a few frames a video."""
    return root, synthetic.write_tree(root, H, W, seed=0, davis_frames=4, long_frames=5,
                                      long_every=2, lvos_frames=3, ovis_frames=4)


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    return small_tree(str(tmp_path_factory.mktemp("tree")))


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jtree"))
    synthetic.write_tree(root, H, W, seed=1, fmt="jpg", davis_frames=3, long_frames=4,
                         long_every=2, lvos_frames=2, ovis_frames=2)
    return root


def _same_davis(root, imset, single):
    t = tds.DavisDataset(os.path.join(root, "DAVIS"), imset, single_object=single)
    j = jds.DavisDataset(os.path.join(root, "DAVIS"), imset, single_object=single)
    assert t.videos == j.videos
    for it, ij in zip(t.iter_videos(), j.iter_videos()):
        assert it == ij
        for a, b in zip(t.load_frames(it["name"], it["frames"]),
                        j.load_frames(ij["name"], ij["frames"])):
            np.testing.assert_array_equal(a, b)
        for f in it["frames"]:
            np.testing.assert_array_equal(t.load_mask(it["name"], f), j.load_mask(ij["name"], f))
            assert t.has_mask(it["name"], f) == j.has_mask(ij["name"], f)
    return t


@pytest.mark.parametrize("imset,single", [("2016/val.txt", True), ("2017/val.txt", False)])
def test_davis_loaders_equal_jax_on_png_tree(png_tree, imset, single):
    root, written = png_tree
    t = _same_davis(root, imset, single)
    info = next(t.iter_videos())
    assert info["num_frames"] == 4 and info["frames"][0] == "00000.png"
    gt = written[f"DAVIS/{info['name']}"][0]
    np.testing.assert_array_equal(t.load_mask(info["name"], "00000.png"),
                                  (gt > 0).astype(np.uint8) if single else gt)


@pytest.mark.parametrize("name,split", [("LongDataset", "val.txt"), ("LVOS", "test.txt")])
def test_long_loaders_equal_jax(png_tree, jpeg_tree, name, split):
    for root in (png_tree[0], jpeg_tree):
        t = tds.LongVideoDataset(os.path.join(root, name), split)
        j = jds.LongVideoDataset(os.path.join(root, name), split)
        assert t.videos == j.videos == ["clip"]
        it, ij = t.video_info("clip"), j.video_info("clip")
        assert it == ij
        for a, b in zip(t.load_frames("clip", it["frames"]), j.load_frames("clip", ij["frames"])):
            np.testing.assert_array_equal(a, b)
        assert t.get_all_masks("clip").keys() == j.get_all_masks("clip").keys()
    assert tds.LongVideoDataset(os.path.join(png_tree[0], "LongDataset")).video_info(
        "clip")["test_ids"] == [0, 2, 4]


def test_jpeg_frames_equal_jax_through_the_native_loader(jpeg_tree):
    assert codec._NATIVE.lib() is not None, "g++ and libjpeg are expected here"
    _same_davis(jpeg_tree, "2017/val.txt", False)


def test_ovis_dataset_equals_jax(png_tree):
    root, written = png_tree
    ann = os.path.join(root, "OVIS", "annotations.json")
    t = tovis.OvisDataset(os.path.join(root, "OVIS", "train_images"), ann)
    j = jovis.OvisDataset(os.path.join(root, "OVIS", "train_images"), ann)
    video = t.videos[0]
    for a, b in zip(t.load_frames(video), j.load_frames(video)):
        np.testing.assert_array_equal(a, b)
    for i in range(len(video["file_names"])):
        np.testing.assert_array_equal(t.indexed_gt(video, i), j.indexed_gt(video, i))
        np.testing.assert_array_equal(t.indexed_gt(video, i), written["OVIS/ovis-clip"][i])


def test_unify_masks_equals_jax(pair):
    objs = [(pair[0][0] == 3), (pair[0][0] == 7)]
    np.testing.assert_array_equal(tds.unify_masks(objs, [3, 7]), jds.unify_masks(objs, [3, 7]))


# ---------------------------------------------------- harness with a mock model

class _MockTracker:
    def __init__(self, mapper):
        self.mapper = mapper

    def clear_memory(self):
        self.mapper.clear()


class _MockModel:
    """Fixed masks and scores: each frame's template labels, shifted by the
    frame index and with a seeded speck, scores per remapped slot."""

    def __init__(self, mapper):
        self.xmem = _MockTracker(mapper)

    def _run(self, frames, template):
        self.xmem.mapper.convert_mask(template)
        r = np.random.default_rng(int(template.sum()) % 1000)
        masks, scores = [], []
        for i in range(len(frames)):
            m = np.roll(template, i, axis=1).copy()
            m[r.integers(0, m.shape[0]), r.integers(0, m.shape[1])] = template.max()
            masks.append(m)
            scores.append([float(v) for v in r.random(len(self.xmem.mapper.remappings))]
                          + [-np.inf])
        return masks, scores

    def generator(self, frames, template):
        masks, scores = self._run(frames, template)
        return masks, None, frames, scores

    def generator_chunked(self, frames, template, chunk=4):
        return self._run(frames, template)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def _same_csv(a, b):
    ha, ra = _read_csv(a)
    hb, rb = _read_csv(b)
    assert ha == hb, (a, ha, hb)
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        x.pop(FPS, None), y.pop(FPS, None)
        x.pop("run", None), y.pop("run", None)
        assert x == y, (a, x, y)


@pytest.fixture()
def relabelled_tree(png_tree, tmp_path):
    """The PNG tree's DAVIS 2017 part with labels {3, 7} (non-contiguous)."""
    import shutil

    root = str(tmp_path / "DAVIS")
    shutil.copytree(os.path.join(png_tree[0], "DAVIS"), root)
    ann = os.path.join(root, "Annotations", "480p", "bike-packing")
    for f in os.listdir(ann):
        m = tpal.load_palette_mask(os.path.join(ann, f))
        tpal.save_palette_mask(np.choose(m, [0, 3, 7]).astype(np.uint8), os.path.join(ann, f))
    return root


@pytest.mark.parametrize("chunk", [None, 2])
def test_davis_harness_writes_what_jax_writes(relabelled_tree, tmp_path, monkeypatch, chunk):
    monkeypatch.chdir(tmp_path)
    jrows = jrun.run_model_on_davis_set("jax", _MockModel(JMaskMapper()),
                                        jds.DavisDataset(relabelled_tree), save_masks=True,
                                        chunk=chunk)
    trows = trun.run_model_on_davis_set("port", _MockModel(TMaskMapper()),
                                        tds.DavisDataset(relabelled_tree), save_masks=True,
                                        chunk=chunk)
    assert [list(r) for r in trows] == [list(jrows.columns)] * len(trows)
    for name in ("whole_metrics.csv", "per_object_metrics.csv", "bear_scores.csv",
                 "bike-packing_scores.csv"):
        _same_csv(f"result/jax/{name}", f"result/port/{name}")
    # the ledger: one row each, the same columns
    header, rows = _read_csv("result/all_tests.csv")
    assert header == ["run", "dataset", "JF_mean", "J_mean", "F_mean", "AP", FPS]
    assert [r["run"] for r in rows] == ["jax", "port"]
    for r in rows:
        r.pop("run"), r.pop(FPS)
    assert rows[0] == rows[1]
    for v in ("bear", "bike-packing"):
        files = sorted(os.listdir(f"result/jax/masks/{v}"))
        assert files == sorted(os.listdir(f"result/port/masks/{v}"))
        for f in files:
            np.testing.assert_array_equal(tpal.load_palette_mask(f"result/port/masks/{v}/{f}"),
                                          jpal.load_palette_mask(f"result/jax/masks/{v}/{f}"))


def test_long_ovis_and_lvos_harness_write_what_jax_writes(png_tree, tmp_path, monkeypatch):
    root = png_tree[0]
    monkeypatch.chdir(tmp_path)
    for pkg, rn, mapper in ((jrun, "jax", JMaskMapper), (trun, "port", TMaskMapper)):
        ds = (jds if pkg is jrun else tds).LongVideoDataset(os.path.join(root, "LongDataset"))
        pkg.run_model_on_longdata_set(f"{rn}_long", _MockModel(mapper()), ds, save_masks=True)
        lv = (jds if pkg is jrun else tds).LongVideoDataset(os.path.join(root, "LVOS"),
                                                            "test.txt")
        pkg.run_model_on_longvos_set(f"{rn}_lvos", _MockModel(mapper()), lv)
        ov = (jovis if pkg is jrun else tovis)
        ods = ov.OvisDataset(os.path.join(root, "OVIS", "train_images"),
                             os.path.join(root, "OVIS", "annotations.json"))
        ov.run_model_on_ovis_set(f"{rn}_ovis", _MockModel(mapper()), ods, save_masks=True)
    for kind in ("long", "ovis"):
        for name in ("whole_metrics.csv", "per_object_metrics.csv"):
            _same_csv(f"result/jax_{kind}/{name}", f"result/port_{kind}/{name}")
    header, rows = _read_csv("result/all_tests.csv")
    assert [r["dataset"] for r in rows] == ["LongDataset", "OVIS", "LongDataset", "OVIS"]
    for a, b in ((0, 2), (1, 3)):
        for k in ("JF_mean", "J_mean", "F_mean", "AP"):
            assert rows[a][k] == rows[b][k]
    for kind, video in (("long", "clip"), ("lvos", "clip"), ("ovis", "ovis-clip")):
        files = sorted(os.listdir(f"result/jax_{kind}/masks/{video}"))
        assert files and files == sorted(os.listdir(f"result/port_{kind}/masks/{video}"))
        for f in files:
            np.testing.assert_array_equal(
                tpal.load_palette_mask(f"result/port_{kind}/masks/{video}/{f}"),
                jpal.load_palette_mask(f"result/jax_{kind}/masks/{video}/{f}"))


def test_csv_writer_formats_as_pandas(tmp_path):
    import pandas as pd

    rows = [{"a": 1, "b": 2.0, "s": [0.5, -np.inf], "t": True},
            {"a": 2.5, "c": "x,y", "s": np.array([0.25, 1.0], np.float32), "t": None},
            {"a": None, "b": float("nan"), "c": 'q"', "s": [], "t": False}]
    pd.DataFrame(rows).to_csv(tmp_path / "p.csv", index=False)
    trun.write_csv(str(tmp_path / "t.csv"), rows)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "p.csv").read_text()
    pd.DataFrame([{"x": 1}]).to_csv(tmp_path / "p2.csv", mode="a", header=True, index=False)
    pd.DataFrame([{"x": 2}]).to_csv(tmp_path / "p2.csv", mode="a", header=False, index=False)
    trun.write_csv(str(tmp_path / "t2.csv"), [{"x": 1}], append=True)
    trun.write_csv(str(tmp_path / "t2.csv"), [{"x": 2}], append=True)
    assert (tmp_path / "t2.csv").read_text() == (tmp_path / "p2.csv").read_text()


class _StandInBatched:
    """A BatchedGenerator stand-in: the mock model's masks per video."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def run(self, videos, templates):
        self.calls.append(len(videos))
        out = []
        for frames, template in zip(videos, templates):
            self.model.xmem.clear_memory()
            masks, _, _, scores = self.model.generator(frames, template)
            labels = [int(v) for v in np.unique(template) if v]
            out.append({"masks": masks, "scores": scores,
                        "label_scores": [dict(zip(labels, s)) for s in scores]})
        return out


def test_batched_and_mesh_raise(png_tree, tmp_path, monkeypatch):
    """`batched=` runs every dataset's videos through the generator's `run`,
    one call per resolution, with the sequential rows but fps; `--mesh`
    larger than the process group raises JAX's error, and the group the
    entry point opened is closed again."""
    monkeypatch.chdir(tmp_path)
    ds = tds.DavisDataset(os.path.join(png_tree[0], "DAVIS"))
    seq = trun.run_model_on_davis_set("s", _MockModel(TMaskMapper()), ds)
    stand_in = _StandInBatched(_MockModel(TMaskMapper()))
    got = trun.run_model_on_davis_set("b", None, ds, batched=stand_in)
    assert stand_in.calls == [len(seq)]

    def but_fps(rows):      # NaN as a string, so that == holds it
        return [{k: "nan" if isinstance(v, float) and math.isnan(v) else v
                 for k, v in r.items() if k != "fps"} for r in rows]

    assert but_fps(got) == but_fps(seq)
    lds = tds.LongVideoDataset(os.path.join(png_tree[0], "LongDataset"))
    for fn in (trun.run_model_on_longdata_set, trun.run_model_on_longvos_set):
        stand_in = _StandInBatched(_MockModel(TMaskMapper()))
        fn("b", None, lds, batched=stand_in)
        assert stand_in.calls == [1]
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        run_davis_test.main(["--davis_root", os.path.join(png_tree[0], "DAVIS"),
                             "--device", "cpu", "--configs", "baseline", "--batch",
                             "--mesh", "2x1"])
    assert not torch.distributed.is_initialized()


def test_davis_entry_point_runs_on_the_cpu(png_tree, tmp_path, monkeypatch, capsys):
    """`python -m vosesam_tpu_torch.run_davis_test --device cpu` on a
    synthetic tree: XMem at its published widths, random weights."""
    monkeypatch.chdir(tmp_path)
    run_davis_test.main(["--davis_root", os.path.join(png_tree[0], "DAVIS"), "--year", "2016",
                         "--configs", "baseline", "--device", "cpu", "--save_masks"])
    out = capsys.readouterr().out
    runs = os.listdir("result")
    run = next(r for r in runs if r.startswith("davis2016_baseline_"))
    assert f"=== {run} ===" in out and "JF_mean" in out
    header, rows = _read_csv(f"result/{run}/whole_metrics.csv")
    assert [r["video"] for r in rows] == ["bear"] and 0.0 <= float(rows[0]["JF_mean"]) <= 1.0
    assert _read_csv(f"result/{run}/per_object_metrics.csv")[0][:2] == ["video", "object"]
    assert [r["run"] for r in _read_csv("result/all_tests.csv")[1]] == [run]
    assert sorted(os.listdir(f"result/{run}/masks/bear")) == [f"{i:05d}.png" for i in range(4)]


def test_synthetic_tree_layout(png_tree):
    root, written = png_tree
    assert sorted(written) == ["DAVIS/bear", "DAVIS/bike-packing", "LVOS/clip",
                               "LongDataset/clip", "OVIS/ovis-clip"]
    assert sorted(written["LongDataset/clip"]) == [0, 2, 4]
    assert set(np.unique(written["DAVIS/bike-packing"][0]).tolist()) == {0, 1, 2}
    with open(os.path.join(root, "OVIS", "annotations.json")) as f:
        ann = json.load(f)
    assert ann["annotations"][1]["segmentations"][:2] == [None, None]
    assert dataclasses.is_dataclass(run_davis_test.CONFIGS["both_neg_C"])
