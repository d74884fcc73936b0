"""The port's E2FGVI-HQ generator against `vosesam_tpu.models.e2fgvi`.

Parameters come from the JAX `generator_init` (the zero-initialised last
offset convolution replaced by small random weights, so that the deformable
alignment sees residual offsets and a non-constant mask) and are carried
over by `params_from_jax`; inputs are made from a numpy seed; everything is
fp32 on the CPU, channel-last on both sides.

Tolerances. Single layers differ by the summation order of the two
frameworks' fp32 convolutions and matmuls: max|diff| <= 1e-4 * max|ref|
(`REL`). Functions that warp (flow_warp with computed flows, the
propagation, the whole generator) floor a sampling position, and under
random weights rounding noise in a flow can move a sample across a cell
border or be amplified through the propagation, so there a share of the
values is held tightly (`_share_close`: >= 99% within 2e-3 of the
reference's scale) and the maximum only loosely.

Roundings. In two places the port follows the published E2FGVI code where
the JAX package does not: the focal blocks' LayerNorm eps is nn.LayerNorm's
1e-5 (the JAX package's `layer_norm` takes 1e-6), and the flows go back from
SPyNet's multiple of 32 by plain bilinear interpolation (jax.image.resize
antialiases that downscale). `published_roundings` runs the JAX package's
generator and flow-completion loss with the published two; every comparison
with JAX in the port's tests of the generator runs under it.
"""

import contextlib
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.config import InpainterConfig as JInpainterConfig
from vosesam_tpu.models.e2fgvi import generator as JG
from vosesam_tpu.models.e2fgvi import losses as JL
from vosesam_tpu.models.e2fgvi import modules as JM
from vosesam_tpu.models.layers import conv_init
from vosesam_tpu.ops.image import resize_bilinear_align_corners as j_align_corners
from vosesam_tpu.utils.checkpoint import tree_to_state_dict
from vosesam_tpu_torch.config import InpainterConfig
from vosesam_tpu_torch.models.e2fgvi import generator as TG
from vosesam_tpu_torch.models.e2fgvi import modules as TM
from vosesam_tpu_torch.ops.image import resize_bilinear_align_corners as t_align_corners
from vosesam_tpu_torch.utils.checkpoint import load_e2fgvi_checkpoint, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side: keep this
    file's convolutions from taking every core in each of them."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


class _PublishedJax:
    """`jax` as the JAX package's generator and flow loss see it under
    `published_roundings`: `jax.image.resize` does not antialias."""

    image = types.SimpleNamespace(resize=functools.partial(jax.image.resize, antialias=False))

    def __getattr__(self, name):
        return getattr(jax, name)


@contextlib.contextmanager
def published_roundings():
    """The JAX package's E2FGVI generator and flow-completion loss at the
    port's (the published) roundings: LayerNorm eps `TG.LN_EPS` in the focal
    blocks, the flows resized without antialiasing. JAX's caches are cleared
    on the way in and out, so no trace made under it outlives it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JG, "layer_norm", functools.partial(JG.layer_norm, eps=TG.LN_EPS))
        mp.setattr(JG, "jax", _PublishedJax())
        mp.setattr(JL, "jax", _PublishedJax())
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def _published_roundings():
    with published_roundings():
        yield


REL = 1e-4
JCFG = JInpainterConfig(num_blocks=2)
TCFG = InpainterConfig(num_blocks=2)
K, S, P = TG.KERNEL, TG.STRIDE, TG.PADDING


def _close(port, ref, rel=REL):
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"max|diff| {err} > {rel} * {scale}"


def _share_close(port, ref, tol=2e-3, share=0.99, worst=0.5):
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy()
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    d = np.abs(port - ref) / scale
    got = float((d <= tol).mean())
    assert got >= share, f"only {got} of the values within {tol} of the scale"
    assert float(d.max()) <= worst, f"max relative diff {d.max()}"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _tree(hq=True):
    cfg = dataclasses.replace(JCFG, hq=hq)
    tree = jax.tree.map(np.asarray, JG.generator_init(jax.random.PRNGKey(0), cfg))
    r = np.random.default_rng(11)
    for d in TG.DIRECTIONS:
        last = tree["feat_prop_module"]["deform_align"][d]["conv_offset"]["6"]
        last["weight"] = (0.02 * r.standard_normal(last["weight"].shape)).astype(np.float32)
        last["bias"] = (0.1 * r.standard_normal(last["bias"].shape)).astype(np.float32)
    if not hq:
        tree["sc"]["bias"] = r.standard_normal(tree["sc"]["bias"].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models():
    tree = _tree()
    net = TG.InpaintGenerator(TCFG)
    net.load_state_dict(params_from_jax(tree), strict=True)
    return jax.tree.map(jnp.asarray, tree), net.eval()


@pytest.fixture
def r():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


# ------------------------------------------------------------------- modules

def test_leaky_relu_and_align_corners_resize(r):
    x = r.standard_normal((2, 7, 9, 3)).astype(np.float32)
    _close(TM.leaky_relu(_t(x), 0.1), JM.leaky_relu(jnp.asarray(x), 0.1), 1e-7)
    for out_hw in ((14, 18), (3, 5), (7, 9), (1, 1)):
        _close(t_align_corners(_t(x), out_hw), j_align_corners(jnp.asarray(x), out_hw), 1e-6)


@pytest.mark.parametrize("padding_zero", [True, False])
def test_flow_warp(r, padding_zero):
    """Flows that leave the field on every side; 3-D and 4-D inputs."""
    x = r.standard_normal((2, 10, 14, 3)).astype(np.float32)
    flow = (r.standard_normal((2, 10, 14, 2)) * 4).astype(np.float32)
    flow[0, :3] = np.round(flow[0, :3])                 # samples on integer positions
    want = JM.flow_warp(jnp.asarray(x), jnp.asarray(flow), padding_zero)
    _close(TM.flow_warp(_t(x), _t(flow), padding_zero), want, 1e-6)
    _close(TM.flow_warp(_t(x[0]), _t(flow[0]), padding_zero), np.asarray(want)[0], 1e-6)


def test_unfold_fold(r):
    x = r.standard_normal((2, 12, 15, 4)).astype(np.float32)
    _close(TM.unfold(_t(x), K, S, P), JM.unfold(jnp.asarray(x), K, S, P), 1e-7)
    _close(TM.unfold(_t(x), (5, 9), (1, 1), (2, 4)),
           JM.unfold(jnp.asarray(x), (5, 9), (1, 1), (2, 4)), 1e-7)
    y = r.standard_normal((2, 20, 4 * 49)).astype(np.float32)
    _close(TM.fold(_t(y), (12, 15), K, S, P), JM.fold(jnp.asarray(y), (12, 15), K, S, P), 1e-6)


def test_spynet_flow(models, r):
    jp, net = models
    ref = r.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    supp = r.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    want = jax.jit(JM.spynet_flow)(jp["update_spynet"], jnp.asarray(ref), jnp.asarray(supp))
    got = TM.spynet_flow(net.update_spynet, _t(ref), _t(supp))
    assert got.shape == (2, 64, 96, 2)
    _share_close(got, want, tol=1e-3, share=0.995, worst=0.05)
    with pytest.raises(ValueError, match="multiples of 32"):
        TM.spynet_flow(net.update_spynet, _t(ref[:, :60]), _t(supp[:, :60]))


def test_second_order_deform_align(models, r):
    """Offsets come out as o1 | o2 with the flipped flows added per half;
    a wrong half, (x, y) order or tiling moves every sample."""
    jp, net = models
    c = TG.CHANNEL
    x = r.standard_normal((1, 12, 20, 2 * c)).astype(np.float32)
    extra = r.standard_normal((1, 12, 20, 3 * c)).astype(np.float32)
    f1 = (3 * r.standard_normal((1, 12, 20, 2))).astype(np.float32)
    f2 = (3 * r.standard_normal((1, 12, 20, 2))).astype(np.float32)
    jparams = jp["feat_prop_module"]["deform_align"]["backward_"]
    want = JM.second_order_deform_align(jparams, *(jnp.asarray(a) for a in (x, extra, f1, f2)))
    got = TM.second_order_deform_align(net.feat_prop_module.deform_align["backward_"],
                                       _t(x), _t(extra), _t(f1), _t(f2))
    _share_close(got, want, tol=1e-4, share=0.999, worst=0.05)


@pytest.mark.parametrize("hq", [True, False])
def test_soft_split_and_soft_comp(r, hq):
    """HQ (`bias_conv`) at a free size, non-HQ (`bias`, stored (C, H, W) in
    the port as in its checkpoint) at the (60, 108) grid it is pinned to."""
    tree = _tree(hq)
    net = TG.InpaintGenerator(dataclasses.replace(TCFG, hq=hq))
    net.load_state_dict(params_from_jax(tree), strict=True)
    assert hasattr(net.sc, "bias_conv") == hq and hasattr(net.sc, "bias") != hq
    size = (12, 18) if hq else (60, 108)
    x = r.standard_normal((2, *size, TG.CHANNEL)).astype(np.float32)
    jtok = JM.soft_split(jax.tree.map(jnp.asarray, tree["ss"]), jnp.asarray(x), K, S, P)
    ttok = TM.soft_split(net.ss, _t(x), K, S, P)
    _close(ttok, jtok)
    want = JM.soft_comp(jax.tree.map(jnp.asarray, tree["sc"]), jtok, size, K, S, P)
    _close(TM.soft_comp(net.sc, ttok, size, K, S, P), want)


def test_fusion_feed_forward(models, r):
    jp, net = models
    size = (12, 18)
    n = 2 * 4 * 6                                        # two frames of (4, 6) tokens
    x = r.standard_normal((1, n, TG.HIDDEN)).astype(np.float32)
    want = JM.fusion_feed_forward(jp["transformer"]["0"]["mlp"], jnp.asarray(x), size, K, S, P)
    _close(TM.fusion_feed_forward(net.transformer[0].mlp, _t(x), size, K, S, P), want)


# ----------------------------------------------------------------- generator

def test_encoder_decoder(models, r):
    """The grouped convolutions take cin // groups input channels and the
    group-fusion interleave feeds them."""
    jp, net = models
    x = r.uniform(-1, 1, (2, 24, 36, 3)).astype(np.float32)
    want = jax.jit(JG.encoder_forward)(jp["encoder"], jnp.asarray(x))
    got = TG.encoder_forward(net.encoder, _t(x))
    assert got.shape == (2, 6, 9, 128)
    _close(got, want)
    _close(TG.decoder_forward(net.decoder, got), jax.jit(JG.decoder_forward)(jp["decoder"], want))


def test_bidirectional_propagation(r):
    """Four frames, so both second-order branches run. Every step feeds its
    aligned feature to the next one's offset convolutions, and under
    He-initialised weights each step multiplies a rounding difference about
    tenfold (white-noise features and the full-size test offsets reach a
    25% mismatch by the fourth frame with both sides correct), so this test
    uses spatially smooth features and the last offset convolution at a
    quarter of the other tests' scale: 99% of the values within 2e-4 of the
    scale, none beyond 5e-3."""
    tree = _tree()
    for d in TG.DIRECTIONS:
        tree["feat_prop_module"]["deform_align"][d]["conv_offset"]["6"]["weight"] *= 0.25
    net = TG.InpaintGenerator(TCFG)
    net.load_state_dict(params_from_jax(tree), strict=True)
    coarse = torch.from_numpy(r.standard_normal((4, TG.CHANNEL, 3, 5)).astype(np.float32))
    x = torch.nn.functional.interpolate(coarse, size=(12, 20), mode="bilinear",
                                        align_corners=True).permute(0, 2, 3, 1).contiguous()
    fb = (2 * r.standard_normal((3, 12, 20, 2))).astype(np.float32)
    ff = (2 * r.standard_normal((3, 12, 20, 2))).astype(np.float32)
    want = jax.jit(JG.bidirectional_propagation)(
        jax.tree.map(jnp.asarray, tree["feat_prop_module"]), jnp.asarray(x.numpy()),
        jnp.asarray(fb), jnp.asarray(ff))
    got = TG.bidirectional_propagation(net.feat_prop_module, x, _t(fb), _t(ff))
    _share_close(got, want, tol=2e-4, share=0.99, worst=5e-3)


def test_rolled_index_and_window_partition(r):
    np.testing.assert_array_equal(TG.ROLLED_IDX, JG.ROLLED_IDX)
    x = r.standard_normal((3, 10, 18, 8)).astype(np.float32)
    win = TG._window_partition(_t(x), TG.WINDOW)
    _close(win, JG._window_partition(jnp.asarray(x), JG.WINDOW), 1e-7)
    _close(TG._window_reverse(win, TG.WINDOW, (10, 18)), x, 1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_focal_attention_and_frame_valid(models, r, masked):
    """One fused softmax over [window | rolled | pooled] keys; with
    `frame_valid` the invalid frames' keys weigh exactly zero, so the valid
    frames' outputs do not depend on what the invalid frames hold."""
    jp, net = models
    t, h, w, c = 3, 10, 18, TG.HIDDEN
    x = r.standard_normal((t, h, w, c)).astype(np.float32)
    pooled = r.standard_normal((t, 2, 2, c)).astype(np.float32)
    pv = np.array([[True, True], [True, False]])
    fv = np.array([True, True, False]) if masked else None
    want = JG.focal_attention(jp["transformer"]["0"], jnp.asarray(x), jnp.asarray(pooled),
                              jnp.asarray(pv), None if fv is None else jnp.asarray(fv))
    blk = net.transformer[0]
    tfv = None if fv is None else torch.from_numpy(fv)
    got = TG.focal_attention(blk, _t(x), _t(pooled), torch.from_numpy(pv), tfv)
    _close(got, want)
    if masked:
        x2, p2 = x.copy(), pooled.copy()
        x2[2], p2[2] = 7.0, -3.0
        other = TG.focal_attention(blk, _t(x2), _t(p2), torch.from_numpy(pv), tfv)
        np.testing.assert_array_equal(other[:2].numpy(), got[:2].numpy())


def test_focal_block_forward(models, r):
    """A token grid that is no multiple of the (5, 9) window: padded,
    pooled and cut back."""
    jp, net = models
    x = r.standard_normal((3, 4, 7, TG.HIDDEN)).astype(np.float32)       # enc (12, 21)
    fv = np.array([True, True, False])
    want = JG.focal_block_forward(jp["transformer"]["1"], jnp.asarray(x), (12, 21),
                                  frame_valid=jnp.asarray(fv))
    got = TG.focal_block_forward(net.transformer[1], _t(x), (12, 21),
                                 frame_valid=torch.from_numpy(fv))
    _close(got, want)


def test_generator_forward(models, r):
    """Five 60x108 frames, three of them local, one padded slot."""
    jp, net = models
    frames = r.uniform(-1, 1, (5, 60, 108, 3)).astype(np.float32)
    fv = np.array([True, True, True, True, False])
    jfwd = jax.jit(lambda p, f, v: JG.generator_forward(p, f, 3, JCFG, frame_valid=v))
    want, (wf, wb) = jfwd(jp, jnp.asarray(frames), jnp.asarray(fv))
    got, (gf, gb) = TG.generator_forward(net, _t(frames), 3, TCFG, frame_valid=torch.from_numpy(fv))
    assert got.shape == (5, 60, 108, 3) and gf.shape == (2, 15, 27, 2)
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) <= 1.0      # tanh
    _share_close(gf, wf, tol=1e-3, share=0.995, worst=0.05)
    _share_close(gb, wb, tol=1e-3, share=0.995, worst=0.05)
    _share_close(got, want)
    # the valid frames are those of the unpadded window
    alone, _ = TG.generator_forward(net, _t(frames[:4]), 3, TCFG)
    _share_close(got[:4], alone.numpy(), tol=1e-4, share=0.999, worst=0.05)


def test_non_hq_refuses_other_sizes():
    net = TG.InpaintGenerator(dataclasses.replace(TCFG, hq=False))
    with pytest.raises(ValueError, match="only supports 240x432"):
        TG.generator_forward(net, torch.zeros((3, 60, 108, 3)), 2, TCFG)


# ------------------------------------------------------------- weights, init

@pytest.mark.parametrize("hq", [True, False])
def test_official_schema_pth_loads_strict(tmp_path, hq):
    """A `.pth` written from the JAX tree with the JAX package's
    `tree_to_state_dict` (under `netG`, with SPyNet's `mean` / `std` buffers
    as the reference's state dict carries them) loads with strict=True and
    holds the values of `params_from_jax`."""
    tree = _tree(hq)
    sd = tree_to_state_dict(tree, transpose_spec={"sc.bias": "chw_to_hwc"})
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    sd["update_spynet.mean"] = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    sd["update_spynet.std"] = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    path = str(tmp_path / "e2fgvi.pth")
    torch.save({"netG": sd}, path)
    loaded = load_e2fgvi_checkpoint(path)
    net = TG.InpaintGenerator(dataclasses.replace(TCFG, hq=hq))
    net.load_state_dict(loaded, strict=True)
    direct = params_from_jax(tree)
    assert set(direct) == set(loaded)
    for k, v in direct.items():
        assert torch.equal(v, loaded[k]), k


def test_conv_init_layout_roundtrip():
    """HWIO -> OIHW of a grouped convolution keeps cin // groups inputs."""
    p = jax.tree.map(np.asarray, conv_init(jax.random.PRNGKey(3), 3, 3, 640 // 2, 512))
    sd = params_from_jax({"layers": {"10": p}})
    assert tuple(sd["layers.10.weight"].shape) == (512, 320, 3, 3)
    assert tuple(TG.Encoder().layers[10].weight.shape) == (512, 320, 3, 3)


def test_generator_init_follows_the_jax_scheme():
    net = TG.generator_init(TCFG, seed=0, device="cpu")
    ref = _tree()
    sd = net.state_dict()
    assert set(sd) == set(params_from_jax(ref))
    assert all(bool(torch.isfinite(v).all()) for v in sd.values())
    for d in TG.DIRECTIONS:
        align = net.feat_prop_module.deform_align[d]
        assert not align.conv_offset[6].weight.any() and not align.bias.any()
        std = float(align.weight.std())
        assert abs(std - np.sqrt(2.0 / (9 * 128))) < 0.1 * std
    assert torch.allclose(net.transformer[0].pool_layers[0].weight, torch.full((1, 45), 1 / 45))
    w = net.encoder.layers[0].weight
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 64))) < 0.1 * float(w.std())
    again = TG.generator_init(TCFG, seed=0, device="cpu")
    assert torch.equal(again.ss.embedding.weight, net.ss.embedding.weight)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")     # nothing to refuse on a GPU machine
        TG.generator_init(TCFG)
