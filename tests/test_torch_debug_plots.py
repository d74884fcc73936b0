"""The port's debug plots (`vosesam_tpu_torch/viz/debug_plots.py`) against
the JAX package's (`vosesam_tpu/viz/debug_plots.py`): the inputs of
`tests/test_viz.py::TestDebugPlots` go through both, as numpy arrays and,
on the port's side, as tensors too; the PNGs decode to equal pixel arrays.
Padded prompt entries (label -1) and invalid objects are dropped on both
sides.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from vosesam_tpu.viz import debug_plots as jplots
from vosesam_tpu_torch.viz import debug_plots as tplots


def pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def inputs():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (32, 48, 3), np.uint8)
    masks = np.zeros((2, 32, 48))
    masks[0, 8:20, 8:24] = 1
    coords = np.zeros((2, 4, 2))
    coords[0, 0] = [12, 12]
    coords[0, 1] = [20, 9]
    labels = np.full((2, 4), -1)
    labels[0, 0] = 1
    labels[0, 1] = 0
    return img, masks, coords, labels


def as_tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("tensors", [False, True])
def test_print_image_bbox_equals_jax(tmp_path, tensors):
    img, *_ = inputs()
    pos, neg = [np.array([[10.0, 10.0]])], [np.array([[30.0, 8.0]])]
    jplots.print_image_bbox(img, [(4, 4, 20, 20)], pos_points=pos, neg_points=neg,
                            save_path=str(tmp_path / "j.png"))
    if tensors:
        img, pos, neg = as_tensors(img)[0], as_tensors(*pos), as_tensors(*neg)
    tplots.print_image_bbox(img, [(4, 4, 20, 20)], pos_points=pos, neg_points=neg,
                            save_path=str(tmp_path / "t" / "t.png"))
    np.testing.assert_array_equal(pixels(tmp_path / "t" / "t.png"), pixels(tmp_path / "j.png"))


@pytest.mark.parametrize("tensors", [False, True])
def test_print_by_objects_equals_jax(tmp_path, tensors):
    _, masks, coords, labels = inputs()
    valid = np.array([True, False])
    jplots.print_by_objects(masks, coords, labels, obj_valid=valid,
                            save_path=str(tmp_path / "j.png"))
    if tensors:
        masks, coords, labels, valid = as_tensors(masks, coords, labels, valid)
    tplots.print_by_objects(masks, coords, labels, obj_valid=valid,
                            save_path=str(tmp_path / "t.png"))
    np.testing.assert_array_equal(pixels(tmp_path / "t.png"), pixels(tmp_path / "j.png"))


def test_print_by_objects_without_prompts_or_validity(tmp_path):
    _, masks, *_ = inputs()
    jplots.print_by_objects(masks, save_path=str(tmp_path / "j.png"))
    tplots.print_by_objects(torch.from_numpy(masks).to(torch.bfloat16),
                            save_path=str(tmp_path / "t.png"))
    np.testing.assert_array_equal(pixels(tmp_path / "t.png"), pixels(tmp_path / "j.png"))


@pytest.mark.parametrize("tensors", [False, True])
def test_save_masks_side_by_side_equals_jax(tmp_path, tensors):
    _, masks, *_ = inputs()
    refined = masks[0].copy()
    refined[10:14, 10:14] = 0
    jplots.save_masks_side_by_side(masks[0], refined, str(tmp_path / "j.png"))
    a, b = as_tensors(masks[0], refined) if tensors else (masks[0], refined)
    tplots.save_masks_side_by_side(a, b, str(tmp_path / "t.png"))
    np.testing.assert_array_equal(pixels(tmp_path / "t.png"), pixels(tmp_path / "j.png"))
