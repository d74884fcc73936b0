"""The port's small ops against the JAX package's: image normalize/pad/unpad,
soft aggregation, morphology, the mask helpers and the XMem GRU gate.

Same numpy inputs through both, on the CPU in fp32. Integer and boolean
results must be equal; float results agree to 1e-6 (the same elementwise
formulas, evaluated by two libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.inference import refinement as jref
from vosesam_tpu.models.xmem import modules as jmod
from vosesam_tpu.models.xmem import network as jnet
from vosesam_tpu.ops import aggregate as jagg
from vosesam_tpu.ops import image as jimg
from vosesam_tpu.ops import morphology as jmorph
from vosesam_tpu_torch.device import resolve_device, torch_dtype
from vosesam_tpu_torch.inference import refinement as tref
from vosesam_tpu_torch.models.xmem import modules as tmod
from vosesam_tpu_torch.models.xmem import network as tnet
from vosesam_tpu_torch.ops import aggregate as tagg
from vosesam_tpu_torch.ops import image as timg
from vosesam_tpu_torch.ops import morphology as tmorph

TOL = 1e-6


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_im_normalize(dtype):
    r = np.random.default_rng(0)
    img = (r.integers(0, 255, (5, 7, 3)) if dtype == np.uint8
           else r.uniform(0, 1, (5, 7, 3))).astype(dtype)
    ref = np.asarray(jimg.im_normalize(jnp.asarray(img)))
    port = timg.im_normalize(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(port, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("hw", [(37, 53), (480, 854), (48, 64)])
def test_pad_divide_by_and_unpad(hw):
    h, w = hw
    assert timg.pad_amounts(h, w) == jimg.pad_amounts(h, w)
    x = np.random.default_rng(1).standard_normal((h, w, 3)).astype(np.float32)
    jp, jpad = jimg.pad_divide_by(jnp.asarray(x), 16)
    tp, tpad = timg.pad_divide_by(torch.from_numpy(x), 16)
    assert tpad == jpad
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(timg.unpad(tp, tpad).numpy(), x)
    # channel-first axes, as used for (O, H, W) masks and probabilities
    m = np.random.default_rng(2).uniform(0, 1, (2, h, w)).astype(np.float32)
    jm, _ = jimg.pad_divide_by(jnp.asarray(m), 16, axes=(-2, -1))
    tm, pad = timg.pad_divide_by(torch.from_numpy(m), 16, axes=(-2, -1))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(timg.unpad(tm, pad, axes=(-2, -1)).numpy(), m)
    if hw == (480, 854):
        assert tp.shape[:2] == (480, 864)


@pytest.mark.parametrize("valid", [None, (True, False, True)])
def test_soft_aggregate(valid):
    prob = np.random.default_rng(3).uniform(0, 1, (3, 6, 5)).astype(np.float32)
    prob[0, 0, 0], prob[1, 0, 1] = 0.0, 1.0             # the eps clip
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.tensor(valid)
    jout, jlog = jagg.soft_aggregate(jnp.asarray(prob), jv, return_logits=True)
    tout, tlog = tagg.soft_aggregate(torch.from_numpy(prob), tv, return_logits=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=1e-5)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("op", ["dilate", "erode"])
@pytest.mark.parametrize("iterations", [1, 2])
def test_morphology(op, iterations):
    m = np.random.default_rng(4).uniform(0, 1, (17, 23)) > 0.4
    m[0, :] = True                                      # borders: zero padding
    ref = np.asarray(getattr(jmorph, op)(jnp.asarray(m), iterations))
    port = getattr(tmorph, op)(torch.from_numpy(m), iterations).numpy()
    np.testing.assert_array_equal(port, ref)


def test_masks_from_prob_and_scores():
    prob = np.random.default_rng(5).uniform(0, 1, (4, 9, 11)).astype(np.float32)
    prob[:, 0, 0] = 0.5                                 # a tie: first index wins
    jm, ji = jref.masks_from_prob(jnp.asarray(prob), 3)
    tm, ti = tref.masks_from_prob(torch.from_numpy(prob), 3)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tref.xmem_object_scores(torch.from_numpy(prob[1:])).numpy(),
                                  np.asarray(jref.xmem_object_scores(jnp.asarray(prob[1:]))))


def test_compute_others_and_gru_gate():
    r = np.random.default_rng(6)
    masks = r.uniform(0, 1, (3, 4, 5)).astype(np.float32)
    valid = np.array([True, True, False])
    np.testing.assert_allclose(
        tnet.compute_others(torch.from_numpy(masks), torch.from_numpy(valid)).numpy(),
        np.asarray(jnet.compute_others(jnp.asarray(masks), jnp.asarray(valid))), atol=TOL)
    hd = 4
    values = r.standard_normal((2, 3, 5, 3 * hd)).astype(np.float32)   # NHWC
    h = r.standard_normal((2, 3, 5, hd)).astype(np.float32)
    ref = np.asarray(jmod.gru_gate(jnp.asarray(values), jnp.asarray(h), hd))
    port = tmod.gru_gate(torch.from_numpy(values).permute(0, 3, 1, 2),
                         torch.from_numpy(h).permute(0, 3, 1, 2), hd)
    np.testing.assert_allclose(port.permute(0, 2, 3, 1).numpy(), ref, atol=TOL, rtol=TOL)


def test_device_policy(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        torch_dtype("float99")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
