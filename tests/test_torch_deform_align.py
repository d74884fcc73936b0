"""The port's B6 wrapper (`deform_patches_bounded`: modulated deformable
3x3 bilinear sampling, optionally inside a bounded window) and B7 wrapper
(`binscan_probe`: the bin scan's inner operation) against the JAX package.

Same numpy inputs, made from a seed, through both. The JAX Pallas kernels
run in interpret mode; the port's wrappers, given CPU tensors, run their
plain PyTorch versions (the CUDA kernels themselves are held against those
versions on the card by chip_smoke.py). Tolerances are the JAX kernel
tests' own (`tests/test_deform_align_kernel.py`): patches within 2e-6 (the
TPU kernel folds the modulation mask into the column weights, the gather
form multiplies it last), the full convolution within 2e-5 (summation order
of the 9 * Cin contraction). The bin-scan probe agrees within 1e-5 (the
order of the selected terms' sum).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vosesam_tpu.models.e2fgvi import modules as JM
from vosesam_tpu.ops.pallas import deform_align as DA
from vosesam_tpu_torch.models.e2fgvi import modules as TM
from vosesam_tpu_torch.ops.kernels import binscan_probe as tbp
from vosesam_tpu_torch.ops.kernels import deform_align as tda


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side: keep this
    file's convolutions from taking every core in each of them."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


H, W, G, KT, CIN = 12, 20, 16, 9, 256
PATCH_TOL = 2e-6
CONV_TOL = 2e-5
PROBE_TOL = 1e-5


def _inputs(flow_scale, seed=0, h=H, w=W, g=G, cin=CIN, b=1):
    """A 3 * tanh residual plus a flow bounded by `flow_scale`, so that
    'within the window' is provable: max |corner displacement| <= 3 +
    flow_scale + 1 (tap) + 1 (upper corner)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, h, w, cin)).astype(np.float32)
    resid = 3.0 * np.tanh(r.standard_normal((b, h, w, g, KT, 2)))
    flow = flow_scale * np.tanh(r.standard_normal((b, h, w, 1, 1, 2)))
    off = (resid + flow).reshape(b, h, w, g * KT * 2).astype(np.float32)
    mask = (1.0 / (1.0 + np.exp(-r.standard_normal((b, h, w, g * KT))))).astype(np.float32)
    return x, off, mask


def _port(x, off, mask, radius):
    tda.reset_counts()
    out = tda.deform_patches_bounded(torch.from_numpy(x), torch.from_numpy(off),
                                     torch.from_numpy(mask), radius=radius)
    assert tda.COUNTS == {"deform_patches_bounded": 0, "plain": 1}
    assert out.dtype == torch.float32 and out.shape == (*x.shape[:3], KT, x.shape[-1])
    return out.numpy()


def _pallas(x, off, mask, radius):
    """The TPU kernel in interpret mode, back in the natural channel order."""
    perm = np.concatenate([DA._field_perm(), DA.CH + DA._field_perm()])
    got = DA.deform_patches_bounded(jnp.asarray(x[0]), jnp.asarray(off[0]), jnp.asarray(mask[0]),
                                    H, W, radius=radius, interpret=True)
    return np.asarray(got)[None][..., np.argsort(perm)]


def _gather_form(x, off, mask, g):
    """The JAX product's gather path, stopped before the contraction: its
    patches are the convolution with an identity weight per tap."""
    b, h, w, cin = x.shape
    eye = np.zeros((3, 3, cin, KT * cin), np.float32)
    for k in range(KT):
        eye[k // 3, k % 3, :, k * cin:(k + 1) * cin] = np.eye(cin, dtype=np.float32)
    out = JM.modulated_deform_conv(jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
                                   jnp.asarray(eye), None, g)
    return np.asarray(out).reshape(b, h, w, KT, cin)


@pytest.mark.parametrize("flow_scale,radius,seed", [(2.0, 8, 0), (1.0, 16, 2)])
def test_plain_matches_pallas_within_window(flow_scale, radius, seed):
    """Every corner fits the window: the TPU kernel, the port with the same
    radius and the port's unbounded function are one function."""
    x, off, mask = _inputs(flow_scale, seed)
    want = _pallas(x, off, mask, radius)
    np.testing.assert_allclose(_port(x, off, mask, radius), want, rtol=PATCH_TOL, atol=PATCH_TOL)
    np.testing.assert_array_equal(_port(x, off, mask, radius), _port(x, off, mask, None))


def test_plain_matches_pallas_beyond_window():
    """Flows beyond the window: the port drops the corners the TPU kernel
    drops, and the drop rule did fire."""
    x, off, mask = _inputs(9.0, seed=1)
    got = _port(x, off, mask, 6)
    np.testing.assert_allclose(got, _pallas(x, off, mask, 6), rtol=PATCH_TOL, atol=PATCH_TOL)
    assert np.abs(got - _port(x, off, mask, None)).max() > 1e-3


@pytest.mark.parametrize("h,w,g,cin,b,flow_scale", [
    (12, 20, 16, 256, 1, 9.0),      # the model's groups and channels, flows leaving the field
    (8, 10, 16, 32, 2, 3.0),        # Cin 32 (two channels per group), a batch of two
    (12, 16, 4, 32, 1, 2.0),        # four groups
])
def test_unbounded_matches_gather_form(h, w, g, cin, b, flow_scale):
    """`radius=None` is the product's gather path everywhere, out-of-field
    samples included."""
    x, off, mask = _inputs(flow_scale, seed=3, h=h, w=w, g=g, cin=cin, b=b)
    np.testing.assert_allclose(_port(x, off, mask, None), _gather_form(x, off, mask, g),
                               rtol=PATCH_TOL, atol=PATCH_TOL)


def test_integer_offsets_floor_to_the_same_cell():
    """Samples on integer coordinates (zero residual, integer flow): the
    (offset + tap) + grid order keeps floor() on the JAX side's cell, so the
    patches are the shifted input itself."""
    x, off, mask = _inputs(0.0, seed=4, h=8, w=10, cin=32)
    off = np.round(3.0 * np.sin(np.arange(off.size, dtype=np.float32))).reshape(off.shape)
    got = _port(x, off, mask, None)
    np.testing.assert_allclose(got, _gather_form(x, off, mask, G), rtol=PATCH_TOL, atol=PATCH_TOL)


@pytest.mark.parametrize("cin,cout,bounded", [(256, 64, False), (256, 64, True), (32, 16, False)])
def test_full_conv_matches_jax(cin, cout, bounded):
    """`modulated_deform_conv` (and its bounded twin at in-window flows)
    against the JAX gather-plus-matmul convolution, weight and bias in the
    checkpoint's layout on the port's side."""
    x, off, mask = _inputs(1.0, seed=5, cin=cin)
    r = np.random.default_rng(7)
    wgt = (0.05 * r.standard_normal((3, 3, cin, cout))).astype(np.float32)     # HWIO
    bias = r.standard_normal((cout,)).astype(np.float32)
    want = np.asarray(JM.modulated_deform_conv(jnp.asarray(x), jnp.asarray(off),
                                               jnp.asarray(mask), jnp.asarray(wgt),
                                               jnp.asarray(bias), G))
    fn = TM.modulated_deform_conv_bounded if bounded else TM.modulated_deform_conv
    got = fn(torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(mask),
             torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias), G)
    np.testing.assert_allclose(got.numpy(), want, rtol=CONV_TOL, atol=CONV_TOL)
    if bounded and cin == 2 * DA.CH:
        pallas = DA.modulated_deform_conv_bounded(
            jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask), jnp.asarray(wgt),
            jnp.asarray(bias), G, radius=16, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=CONV_TOL, atol=CONV_TOL)


def test_zero_offset_equals_conv():
    """Zero offsets and a mask of ones: the plain 3x3 convolution
    (`tests/test_inpainter.py`'s check at Cin 32, G 16)."""
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((1, 8, 10, 32)).astype(np.float32))
    wt = torch.from_numpy((r.standard_normal((16, 32, 3, 3)) * 0.1).astype(np.float32))
    got = TM.modulated_deform_conv(x, torch.zeros((1, 8, 10, 2 * 16 * 9)),
                                   torch.ones((1, 8, 10, 16 * 9)), wt, None, 16)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), wt, padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("what", ["x dtype", "x rank", "offset shape", "mask channels",
                                  "groups", "radius", "offset dtype"])
def test_bad_inputs_raise(what):
    x, off, mask = (torch.from_numpy(a) for a in _inputs(1.0, h=4, w=5, cin=32))
    radius = None
    if what == "x dtype":
        x = x.double()
    elif what == "x rank":
        x = x[0]
    elif what == "offset shape":
        off = off[..., :-2]
    elif what == "mask channels":
        mask, off = mask[..., :-1], off[..., :-2]
    elif what == "groups":
        x = x[..., :24]                       # 24 channels over 16 groups
    elif what == "radius":
        radius = -1
    elif what == "offset dtype":
        off = off.half()
    with pytest.raises((ValueError, TypeError)):
        tda.deform_patches_bounded(x, off, mask, radius)


def test_cuda_tensor_never_takes_the_plain_version():
    """On the CPU the wrapper runs the plain version only because the tensor
    lies there; a tensor on a device without a kernel raises."""
    x, off, mask = (torch.from_numpy(a).to("meta") for a in _inputs(1.0, h=4, w=5, cin=32))
    with pytest.raises(ValueError, match="no kernel for device"):
        tda.deform_patches_bounded(x, off, mask)


# ------------------------------------------------------------------ B7

def _load_probe_script():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "exp_vpu_binscan.py")
    spec = importlib.util.spec_from_file_location("exp_vpu_binscan", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_inputs(n_tiles, p, pad, g, cg, taps, bins, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n_tiles, p + pad, g * cg)).astype(np.float32)
    y0 = r.integers(0, bins, (n_tiles, p, g * taps)).astype(np.int32)
    wy = r.uniform(0, 1, (n_tiles, p, g * taps)).astype(np.float32)
    return x, y0, wy


def _numpy_probe(x, y0, wy, bins, g):
    """A transcription of `make_kernel`'s body: tap-major fields, the (P, G)
    weight tile-repeated cg times over the channels."""
    n_tiles, p, kg = y0.shape
    cg = x.shape[-1] // g
    acc = np.zeros((n_tiles, p, x.shape[-1]), np.float32)
    for s in range(bins):
        xs = x[:, s:s + p]
        for k in range(kg // g):
            y0k, wyk = y0[..., k * g:(k + 1) * g], wy[..., k * g:(k + 1) * g]
            w = np.where(y0k == s, 1.0 - wyk, 0.0) + np.where(y0k == s - 1, wyk, 0.0)
            acc = acc + np.tile(w, (1, 1, cg)).astype(np.float32) * xs
    return acc


@pytest.mark.parametrize("n_tiles,p,pad,g,cg,taps,bins", [
    (2, 16, 16, 16, 16, 9, 12),       # the probe's groups, channels and taps
    (3, 8, 8, 4, 8, 5, 8),
])
def test_probe_plain_matches_make_kernel(n_tiles, p, pad, g, cg, taps, bins):
    """The port's plain scan against the TPU probe's own kernel body, run
    through `pl.pallas_call(interpret=True)` with the script's BlockSpecs
    (one (P + pad)-row source block per tile), and against a numpy
    transcription of that body."""
    x, y0, wy = _probe_inputs(n_tiles, p, pad, g, cg, taps, bins)
    tbp.reset_counts()
    got = tbp.binscan_probe(torch.from_numpy(x), torch.from_numpy(y0), torch.from_numpy(wy),
                            bins, groups=g)
    assert tbp.COUNTS == {"binscan_probe": 0, "plain": 1}
    assert got.shape == (n_tiles, p, g * cg) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _numpy_probe(x, y0, wy, bins, g),
                               rtol=PROBE_TOL, atol=PROBE_TOL)

    cin = g * cg
    kern = _load_probe_script().make_kernel(p, bins, g, cg, taps)
    fn = pl.pallas_call(
        kern, grid=(n_tiles,),
        in_specs=[pl.BlockSpec((p + pad, cin), lambda i: (i, 0)),
                  pl.BlockSpec((p, g * taps), lambda i: (i, 0)),
                  pl.BlockSpec((p, g * taps), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((p, cin), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n_tiles * p, cin), jnp.float32), interpret=True)
    want = np.asarray(fn(jnp.asarray(x.reshape(-1, cin)), jnp.asarray(y0.reshape(-1, g * taps)),
                         jnp.asarray(wy.reshape(-1, g * taps)))).reshape(n_tiles, p, cin)
    np.testing.assert_allclose(got.numpy(), want, rtol=PROBE_TOL, atol=PROBE_TOL)


@pytest.mark.parametrize("what", ["y0 dtype", "rows", "groups", "cg", "taps"])
def test_probe_bad_inputs_raise(what):
    x, y0, wy = (torch.from_numpy(a) for a in _probe_inputs(1, 8, 8, 4, 8, 5, 8))
    bins, groups = 8, 4
    if what == "y0 dtype":
        y0 = y0.long()
    elif what == "rows":
        bins = 10                      # needs P + 9 source rows, has P + 8
    elif what == "groups":
        groups = 3
    elif what == "cg":
        x, groups = x[..., :12], 4     # 3 channels per group
        y0, wy = y0, wy
    elif what == "taps":
        groups = 1                     # 20 taps
    with pytest.raises((ValueError, TypeError)):
        tbp.binscan_probe(x, y0, wy, bins, groups=groups)


def test_probe_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbp.run_probe()
