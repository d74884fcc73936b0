"""The pieces of the port's E2FGVI trainer against the JAX package's on the
CPU, fp32: the T-PatchGAN discriminator and its functional spectral norm
(`models/e2fgvi/discriminator.py`), the flow-completion loss
(`models/e2fgvi/losses.py`), the discriminator's weights through
`params_from_jax`, the inpaint clip sampler (`training/inpaint_data.py`)
and the flow colour wheel (`viz/flow.py`).

Tolerances: spectral norm's vectors and the normalized weight 1e-6
relative (a handful of fp32 dot products); the discriminator's logits and
the flow loss 1e-4 of their scale (fp32 convolutions summed in another
order); the sampler's frames and masks and the flow images bit for bit
(the same numpy / Pillow calls in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.eval.datasets import DavisDataset as JDavisDataset
from vosesam_tpu.models.e2fgvi import discriminator as JD
from vosesam_tpu.models.e2fgvi.losses import flow_completion_loss as j_flow_loss
from vosesam_tpu.training import inpaint_data as JDATA
from vosesam_tpu.viz import flow as JFLOW
from vosesam_tpu_torch.eval.datasets import DavisDataset
from vosesam_tpu_torch.eval.synthetic import write_tree
from vosesam_tpu_torch.models.e2fgvi import discriminator as TD
from vosesam_tpu_torch.models.e2fgvi import modules as TM
from vosesam_tpu_torch.models.e2fgvi.losses import flow_completion_loss as t_flow_loss
from vosesam_tpu_torch.training import inpaint_data as TDATA
from vosesam_tpu_torch.utils.checkpoint import params_from_jax
from vosesam_tpu_torch.viz import flow as TFLOW
from tests.test_torch_e2fgvi import published_roundings


@pytest.fixture(autouse=True, scope="module")
def _published_roundings():
    """The JAX package's E2FGVI at the roundings the port follows
    (`tests.test_torch_e2fgvi.published_roundings`)."""
    with published_roundings():
        yield


@pytest.fixture(scope="module")
def disc_tree():
    return jax.tree.map(np.asarray, JD.discriminator_init(jax.random.PRNGKey(1)))


def _port_disc(tree):
    net = TD.Discriminator()
    net.load_state_dict(params_from_jax(tree), strict=True)
    return net


def test_params_from_jax_maps_the_discriminator(disc_tree):
    """THWIO -> OIDHW; u / v under spectral_norm's names; the last layer
    plain; `load_state_dict(strict=True)`."""
    sd = params_from_jax(disc_tree)
    assert set(sd) == set(TD.Discriminator().state_dict())
    for i in (0, 2, 4, 6, 8):
        p = disc_tree["conv"][str(i)]
        np.testing.assert_array_equal(sd[f"conv.{i}.weight_orig"].numpy(),
                                      np.transpose(p["weight"], (4, 3, 0, 1, 2)))
        np.testing.assert_array_equal(sd[f"conv.{i}.weight_u"].numpy(), p["u"])
        np.testing.assert_array_equal(sd[f"conv.{i}.weight_v"].numpy(), p["v"])
    assert tuple(sd["conv.10.weight"].shape) == (128, 128, 3, 5, 5)
    assert tuple(sd["conv.10.bias"].shape) == (128,)
    net = _port_disc(disc_tree)
    assert {k for k, _ in net.named_parameters()} == {
        *(f"conv.{i}.weight_orig" for i in (0, 2, 4, 6, 8)), "conv.10.weight", "conv.10.bias"}


@pytest.mark.parametrize("update", [False, True])
def test_spectral_normalize_matches_jax(disc_tree, update):
    p = disc_tree["conv"]["2"]
    want = JD.spectral_normalize(*(jnp.asarray(p[k]) for k in ("weight", "u", "v")),
                                 update=update, n_power_iterations=2)
    w = torch.from_numpy(np.transpose(p["weight"], (4, 3, 0, 1, 2)).copy()).requires_grad_(True)
    got = TD.spectral_normalize(w, torch.tensor(p["u"]), torch.tensor(p["v"]),
                                update=update, n_power_iterations=2)
    np.testing.assert_allclose(got[0].detach().numpy(),
                               np.transpose(np.asarray(want[0]), (4, 3, 0, 1, 2)), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want[0]).max()))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
        assert not a.requires_grad
    # u, v are buffers: sigma differentiates through the weight alone
    got[0].sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()


def test_discriminator_forward_matches_jax(disc_tree):
    """Logits of a (1, 5, 32, 48, 3) video, without and with the power
    iteration; the stored vectors move only with `update_sn`; the sigmoid
    head."""
    video = np.random.default_rng(0).uniform(-1, 1, (1, 5, 32, 48, 3)).astype(np.float32)
    net = _port_disc(disc_tree)
    jparams = jax.tree.map(jnp.asarray, disc_tree)
    want, _ = JD.discriminator_forward(jparams, jnp.asarray(video))
    got = TD.discriminator_forward(net, torch.from_numpy(video))
    assert tuple(got.shape) == want.shape == (1, 5, 1, 1, 128)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4 * scale)
    assert torch.equal(net.conv[0].weight_u, torch.tensor(disc_tree["conv"]["0"]["u"]))
    want2, new = JD.discriminator_forward(jparams, jnp.asarray(video), update_sn=True)
    got2 = TD.discriminator_forward(net, torch.from_numpy(video), update_sn=True)
    np.testing.assert_allclose(got2.detach().numpy(), np.asarray(want2), rtol=0,
                               atol=1e-4 * float(np.abs(want2).max()))
    for i in (0, 2, 4, 6, 8):
        np.testing.assert_allclose(net.conv[i].weight_u.numpy(),
                                   np.asarray(new["conv"][str(i)]["u"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(net.conv[i].weight_v.numpy(),
                                   np.asarray(new["conv"][str(i)]["v"]), rtol=0, atol=1e-6)
    sig = TD.discriminator_forward(net, torch.from_numpy(video), use_sigmoid=True)
    assert float(sig.min()) >= 0.0 and float(sig.max()) <= 1.0


def test_discriminator_init_is_seeded_and_normalized():
    a, b = TD.discriminator_init(seed=3, device="cpu"), TD.discriminator_init(seed=3, device="cpu")
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    for i in (0, 2, 4, 6, 8):
        assert float(a.conv[i].weight_u.norm()) == pytest.approx(1.0, abs=1e-6)
        fan = float(np.prod(a.conv[i].weight_orig.shape[1:]))
        assert float(a.conv[i].weight_orig.std()) == pytest.approx((2 / fan) ** 0.5, rel=0.1)
    assert not a.conv[10].bias.any()


def test_flow_completion_loss_matches_jax():
    """The frozen SPyNet's quarter flows of 4 frames against flows drawn at
    random: both sides' resizes and SPyNet agree."""
    r = np.random.default_rng(1)
    spy = TM.SPyNet()
    with torch.no_grad():
        for p in spy.parameters():
            p.copy_(torch.from_numpy((0.05 * r.standard_normal(p.shape)).astype(np.float32)))
    jspy = jax.tree.map(jnp.asarray, _spynet_tree(spy))
    frames = r.uniform(0, 1, (4, 96, 128, 3)).astype(np.float32)
    pred = tuple(r.standard_normal((3, 24, 32, 2)).astype(np.float32) for _ in range(2))
    want = float(j_flow_loss(jspy, tuple(map(jnp.asarray, pred)), jnp.asarray(frames)))
    tpred = tuple(torch.from_numpy(p).requires_grad_(True) for p in pred)
    got = t_flow_loss(spy, tpred, torch.from_numpy(frames))
    assert float(got.detach()) == pytest.approx(want, rel=1e-4)
    # the ground truth is a constant: gradients reach the prediction only
    got.backward()
    assert all(p.grad is not None for p in tpred)
    assert all(p.grad is None for p in spy.parameters())


def _spynet_tree(spy):
    """The JAX tree of a port SPyNet (conv OIHW -> HWIO)."""
    from vosesam_tpu.utils.checkpoint import state_dict_to_tree

    return state_dict_to_tree(spy.state_dict())


# ---------------------------------------------------------------- sampler

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("inpaint_syn")
    write_tree(str(root), h=60, w=96, seed=5, davis_frames=9, long_frames=2, lvos_frames=1,
               ovis_frames=2)
    return str(root / "DAVIS")


@pytest.mark.parametrize("seed, h, w, moving", [(0, 240, 432, 0.5), (3, 48, 64, 1.0),
                                                (9, 37, 53, 0.0)])
def test_stroke_masks_bit_equal_to_jax(seed, h, w, moving):
    j, t = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        want = JDATA.random_mask_sequence(j, 4, h, w, moving)
        got = TDATA.random_mask_sequence(t, 4, h, w, moving)
        assert got.dtype == np.uint8 and got.shape == (4, h, w)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TDATA.random_stroke_mask(t, h, w),
                                  JDATA.random_stroke_mask(j, h, w))
    assert t.integers(0, 2 ** 31) == j.integers(0, 2 ** 31)


@pytest.mark.parametrize("seed, nl, nn, size", [(0, 5, 3, (48, 80)), (4, 3, 2, (30, 44))])
def test_clip_sampler_bit_equal_to_jax(tree, seed, nl, nn, size):
    j = JDATA.InpaintClipSampler(JDavisDataset(tree, imset="2017/val.txt"), nl, nn, size,
                                 seed=seed)
    t = TDATA.InpaintClipSampler(DavisDataset(tree, imset="2017/val.txt"), nl, nn, size,
                                 seed=seed)
    for _ in range(3):
        jf, jm, jn = j.sample()
        tf, tm, tn = t.sample()
        assert tf.dtype == np.float32 and tm.dtype == np.float32 and tn == jn == nl
        assert tf.shape == (nl + nn, *size, 3) and tm.shape == (nl + nn, *size, 1)
        assert tf.min() >= -1.0 and tf.max() <= 1.0 and set(np.unique(tm)) <= {0.0, 1.0}
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tm, jm)
    with pytest.raises(ValueError, match="no videos with >= 50 frames"):
        TDATA.InpaintClipSampler(DavisDataset(tree, imset="2017/val.txt"), num_local=50)


# ------------------------------------------------------------ flow viz

def test_flow_to_image_equal_to_jax():
    r = np.random.default_rng(2)
    flow = (r.standard_normal((23, 31, 2)) * 5).astype(np.float32)
    np.testing.assert_array_equal(TFLOW.make_colorwheel(), JFLOW.make_colorwheel())
    for kw in ({}, {"convert_to_bgr": True}, {"clip_flow": 2.0}):
        got = TFLOW.flow_to_image(flow, **kw)
        assert got.dtype == np.uint8 and got.shape == (23, 31, 3)
        np.testing.assert_array_equal(got, JFLOW.flow_to_image(flow, **kw))
    np.testing.assert_array_equal(TFLOW.flow_to_image(np.zeros((4, 5, 2), np.float32)),
                                  JFLOW.flow_to_image(np.zeros((4, 5, 2), np.float32)))
    with pytest.raises(ValueError, match="flow must be"):
        TFLOW.flow_to_image(flow[..., :1])
