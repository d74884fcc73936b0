"""The port's fancy mask painter (`vosesam_tpu_torch/viz/mask_painter.py`)
against the JAX package's on the CPU: the clipped signed distance, the
background ramp and contour band, the four modes, the >1024 px downsample,
and the invalid arguments.

Tolerances: the signed distance, ramp and band are exact (the same fp32
minima, clips and one division); the painted uint8 images may differ by 1
grey level where a blend's fp32 rounding (XLA may contract a multiply-add)
lands on the other side of an integer before the truncation, on at most
0.5% of the values; the downsampled image, whose resize sums in another
order, within 1 grey level on 99% of the values. Measured here: every
painted image equal, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.viz import mask_painter as jmp
from vosesam_tpu_torch.viz import mask_painter as tmp


def _case(seed=0, h=40, w=52):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w, 3), np.uint8)
    m = np.zeros((h, w), np.float32)
    m[8:24, 10:34] = 1.0
    m[30:36, 40:50] = 1.0
    m[0:3, 0:5] = 1.0           # touches the image border
    return img, m


def _close_u8(got, want, share=0.005):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= share, (d > 0).mean()


@pytest.mark.parametrize("clip", [1.0, 3.0, 4.0])
def test_signed_distance_matches_jax(clip):
    _, m = _case()
    want = np.asarray(jmp.clipped_signed_distance(jnp.asarray(m), clip))
    got = tmp.clipped_signed_distance(torch.from_numpy(m), clip).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_signed_distance_values():
    m = torch.zeros((12, 12))
    m[4:8, 4:8] = 1.0
    d = tmp.clipped_signed_distance(m, 3.0)
    assert d[5, 5] > 0 and d[0, 0] < 0
    assert float(d[4, 4]) == pytest.approx(1.0)     # corner: 1 px to background
    assert float(d[3, 4]) == pytest.approx(-1.0)    # just outside
    assert float(d[0, 0]) == pytest.approx(-3.0)    # clipped


@pytest.mark.parametrize("hard", [False, True])
def test_ramp_and_band_match_jax(hard):
    _, m = _case(1)
    dist = np.array(jmp.clipped_signed_distance(jnp.asarray(m), 3.0))
    td = torch.from_numpy(dist)
    np.testing.assert_array_equal(tmp._background_ramp(td, 3).numpy(),
                                  np.asarray(jmp._background_ramp(jnp.asarray(dist), 3)))
    np.testing.assert_array_equal(tmp._contour_band(td, 1, hard).numpy(),
                                  np.asarray(jmp._contour_band(jnp.asarray(dist), 1, hard)))


@pytest.mark.parametrize("mode", ["00", "01", "10", "11"])
def test_modes_match_jax(mode):
    img, m = _case(2)
    want = np.asarray(jmp.fancy_mask_painter(jnp.asarray(img), jnp.asarray(m), mode=mode))
    got = tmp.fancy_mask_painter(torch.from_numpy(img), torch.from_numpy(m), mode=mode)
    assert got.dtype == torch.uint8 and tuple(got.shape) == img.shape
    _close_u8(got.numpy(), want)
    # the background is blended toward black outside the mask
    assert int(got[20, 45].int().sum()) <= int(img[20, 45].astype(int).sum())


def test_non_default_arguments_match_jax():
    img, m = _case(3)
    kw = dict(background_alpha=0.3, background_blur_radius=9, contour_width=5,
              contour_color=7, contour_alpha=0.8, mode="11")
    want = np.asarray(jmp.fancy_mask_painter(jnp.asarray(img), jnp.asarray(m), **kw))
    got = tmp.fancy_mask_painter(torch.from_numpy(img), torch.from_numpy(m.astype(np.uint8)),
                                 **kw)
    _close_u8(got.numpy(), want)


def test_large_image_is_downsampled_like_jax():
    """Longest side 1100 > 1024: both sides resize to 1024 wide first."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (60, 1100, 3), np.uint8)
    m = np.zeros((60, 1100), np.float32)
    m[10:40, 200:700] = 1.0
    want = np.asarray(jmp.fancy_mask_painter(jnp.asarray(img), jnp.asarray(m)))
    got = tmp.fancy_mask_painter(torch.from_numpy(img), torch.from_numpy(m)).numpy()
    assert got.shape == want.shape == (55, 1024, 3)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (d <= 1).mean() >= 0.99, (d <= 1).mean()


def test_invalid_args():
    img = torch.zeros((8, 8, 3), dtype=torch.uint8)
    m = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="odd"):
        tmp.fancy_mask_painter(img, m, background_blur_radius=6)
    with pytest.raises(ValueError, match="odd"):
        tmp.fancy_mask_painter(img, m, contour_width=4)
    with pytest.raises(ValueError, match="mode"):
        tmp.fancy_mask_painter(img, m, mode="12")
