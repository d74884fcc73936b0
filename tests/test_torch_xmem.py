"""The port's XMem network against `vosesam_tpu.models.xmem.network`.

Parameters come from the JAX `xmem_init` and are carried over by
`params_from_jax`; inputs are made from a numpy seed. Everything runs in
fp32 on the CPU. Tolerance: the two frameworks' fp32 convolutions sum in a
different order (XLA:CPU vs oneDNN), and with random He-init weights and
identity batch norm the activations grow through the ResNet50 trunk, so
errors are held relative to the output's scale: max|diff| <= 1e-4 *
max|ref| (observed ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.config import XMemConfig as JXMemConfig
from vosesam_tpu.models import layers as jlayers
from vosesam_tpu.models.xmem import network as jnet
from vosesam_tpu_torch.config import XMemConfig
from vosesam_tpu_torch.models import layers as tlayers
from vosesam_tpu_torch.models.xmem import network as tnet
from vosesam_tpu_torch.utils.checkpoint import params_from_jax

H, W = 48, 64
O = 2
REL = 1e-4


def _close(port, ref, rel=REL):
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy()
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"max|diff| {err} > {rel} * {scale}"


@pytest.fixture(scope="module")
def models():
    jparams = jnet.xmem_init(jax.random.PRNGKey(0), JXMemConfig(max_objects=O))
    tree = jax.tree.map(np.asarray, jparams)
    net = tnet.XMem(XMemConfig(max_objects=O))
    net.load_state_dict(params_from_jax(tree), strict=True)
    return jparams, net.eval()


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(0)
    frame = r.standard_normal((H, W, 3)).astype(np.float32)
    masks = (r.uniform(0, 1, (O, H, W)) > 0.5).astype(np.float32)
    hidden = r.standard_normal((O, H // 16, W // 16, 64)).astype(np.float32)
    readout = r.standard_normal((O, H // 16, W // 16, 512)).astype(np.float32)
    return frame, masks, hidden, readout


@pytest.fixture(scope="module")
def keys(models, inputs):
    jparams, net = models
    frame = inputs[0]
    with torch.no_grad():
        tk = tnet.encode_key(net, torch.from_numpy(frame))
    return jnet.encode_key(jparams, jnp.asarray(frame)), tk


@pytest.mark.parametrize("i, name", [(0, "key"), (1, "shrinkage"), (2, "selection")])
def test_encode_key_projections(keys, i, name):
    jk, tk = keys
    _close(tk[i], jk[i])


@pytest.mark.parametrize("name", ["f16", "f8", "f4"])
def test_encode_key_features(keys, name):
    jk, tk = keys
    _close(getattr(tk[3], name), getattr(jk[3], name))


@pytest.mark.parametrize("valid", [(True, True), (True, False)])
def test_encode_value(models, inputs, keys, valid):
    jparams, net = models
    frame, masks, hidden, _ = inputs
    jk, tk = keys
    valid = np.asarray(valid)
    jv, jh = jnet.encode_value(jparams, jnp.asarray(frame), jk[3].f16,
                               jnp.asarray(hidden), jnp.asarray(masks),
                               jnp.asarray(valid), JXMemConfig(max_objects=O))
    with torch.no_grad():
        tv, th = tnet.encode_value(net, torch.from_numpy(frame), tk[3].f16,
                                   torch.from_numpy(hidden), torch.from_numpy(masks),
                                   torch.from_numpy(valid), XMemConfig(max_objects=O))
    _close(tv, jv)
    _close(th, jh)
    if not valid[1]:
        assert not tv[1].any()              # padded objects write zeros


@pytest.mark.parametrize("valid", [(True, True), (True, False)])
def test_segment(models, inputs, keys, valid):
    jparams, net = models
    _, _, hidden, readout = inputs
    jk, tk = keys
    valid = np.asarray(valid)
    jh, jlogits, jprob = jnet.segment(jparams, jk[3], jnp.asarray(readout),
                                      jnp.asarray(hidden), jnp.asarray(valid),
                                      JXMemConfig(max_objects=O), strip_bg=False)
    with torch.no_grad():
        th, tlogits, tprob = tnet.segment(net, tk[3], torch.from_numpy(readout),
                                          torch.from_numpy(hidden), torch.from_numpy(valid),
                                          XMemConfig(max_objects=O))
    _close(th, jh)
    # Under random weights the decoder's per-object logits z reach |z| ~ 2.5e3
    # at this size, so the REL-sized fp32 reassociation difference moves z by
    # ~2.5e-3 and sigmoid(z) by up to ~6e-4 on the few pixels where z
    # crosses 0 (a band widened by the x4 bilinear upsampling). Probabilities:
    # within 2e-3 everywhere, within 1e-5 on 99% of pixels.
    tprob, jprob = tprob.numpy(), np.asarray(jprob)
    np.testing.assert_allclose(tprob, jprob, atol=2e-3)
    assert (np.abs(tprob - jprob) <= 1e-5).mean() >= 0.99
    # Aggregated logits are log(p) - log1p(-p) of probabilities clipped to
    # [1e-7, 1 - 1e-7]: near the clip one fp32 ulp of p moves the logit by
    # ~0.6, so they are compared where they are well conditioned
    # (|logit| < 8); the saturated pixels are covered by the probabilities
    # above. The same transition pixels allow 1e-2. Padded objects' -1e9 is
    # exact.
    jlogits = np.asarray(jlogits)
    nv = 1 + int(valid.sum())
    cond = np.abs(jlogits[:nv]) < 8
    assert cond.any()
    np.testing.assert_allclose(tlogits[:nv].numpy()[cond], jlogits[:nv][cond],
                               atol=1e-2)
    np.testing.assert_array_equal(tlogits[nv:].numpy(), jlogits[nv:])


@pytest.mark.parametrize("scale", [2.0, 4.0])
def test_interpolate_bilinear_edges(scale):
    """F.interpolate(align_corners=False) == jax.image.resize(linear) when
    upsampling, the clamped edge rows and columns included."""
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jlayers.interpolate_bilinear(jnp.asarray(x), scale))
    port = tlayers.interpolate_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), scale)
    port = port.permute(0, 2, 3, 1).numpy()
    assert port.shape == ref.shape
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(port[sl], ref[sl], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(port, ref, atol=1e-6, rtol=1e-6)
