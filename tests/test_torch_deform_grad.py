"""The gradient of the deformable sampling (B6) on the CPU.

`deform_patches_backward_plain` is the backward kernel's formula written out
in plain PyTorch; the autograd Function `DeformPatches` runs it on the CPU
(the kernel on the card). Held here:
  - against autograd of `deform_patches_plain`, radius None / 6 / 2, offsets
    of the model's form, integer offsets (frac 0: both corners still count)
    and offsets far outside the field: grad_offset and grad_mask within
    1e-6 (the same per-element products and sums; autograd may add the
    three contributions to frac in another order), grad_x within 1e-6
    (scatter-adds in another order);
  - the Function's plumbing: radius gets no gradient, only inputs that
    require grad get one, a non-contiguous incoming gradient, the counts;
  - the port's `modulated_deform_conv` under autograd against `jax.vjp` of
    the JAX package's gather form (`models/e2fgvi/modules.py
    modulated_deform_conv`) on the same numpy-seeded inputs, for x, offset,
    mask, weight and bias: within 1e-5 of each gradient's largest value
    (fp32 sums in another order: the contraction's matmul and the
    per-channel reductions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.models.e2fgvi import modules as JM
from vosesam_tpu_torch.models.e2fgvi import modules as TM
from vosesam_tpu_torch.ops.kernels import deform_align as da

PLAIN_TOL = 1e-6
JAX_REL = 1e-5


def _inputs(rng, b=2, h=7, w=9, cin=16, g=4, kind="model", resid=4.0):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    off = (resid * np.tanh(rng.standard_normal((b, h, w, 2 * g * 9))) + 0.37).astype(np.float32)
    if kind == "integer":
        off = np.round(off).astype(np.float32)
    elif kind == "far":
        off = off + np.float32(100.0)
    mask = rng.uniform(0, 1, (b, h, w, g * 9)).astype(np.float32)
    grad = rng.standard_normal((b, h, w, 9, cin)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, off, mask, grad)]


def _leaves(*ts):
    return [t.clone().requires_grad_(True) for t in ts]


def _maxdiff(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("radius", [None, 6, 2])
@pytest.mark.parametrize("kind", ["model", "integer", "far"])
def test_plain_backward_matches_autograd_of_plain(radius, kind):
    x, off, mask, grad = _inputs(np.random.default_rng(3), kind=kind)
    lx, loff, lmask = _leaves(x, off, mask)
    da.deform_patches_plain(lx, loff, lmask, radius).backward(grad)
    gx, goff, gmask = da.deform_patches_backward_plain(grad, x, off, mask, radius)
    assert gx.shape == x.shape and goff.shape == off.shape and gmask.shape == mask.shape
    assert _maxdiff(goff, loff.grad) <= PLAIN_TOL
    assert _maxdiff(gmask, lmask.grad) <= PLAIN_TOL
    assert _maxdiff(gx, lx.grad) <= PLAIN_TOL
    if kind == "far":
        assert not gx.any() and not gmask.any() and not goff.any()
    else:
        assert goff.abs().sum() > 0 and gx.abs().sum() > 0


def test_function_plumbing_on_the_cpu():
    """radius gets no gradient; only inputs that require grad get one; a
    non-contiguous incoming gradient; the forward and backward counts."""
    x, off, mask, grad = _inputs(np.random.default_rng(4))
    da.reset_counts()
    lx, loff = _leaves(x, off)
    out = da.deform_patches_bounded(lx, loff, mask, 6)
    assert isinstance(out.grad_fn, da.DeformPatches._backward_cls)
    assert torch.equal(out, da.deform_patches_plain(x, off, mask, 6))
    strided = grad.permute(0, 2, 1, 3, 4).contiguous().permute(0, 2, 1, 3, 4)
    assert not strided.is_contiguous()
    out.backward(strided)
    gx, goff, _ = da.deform_patches_backward_plain(grad, x, off, mask, 6)
    assert _maxdiff(lx.grad, gx) == 0.0 and _maxdiff(loff.grad, goff) == 0.0
    assert mask.grad is None
    assert da.COUNTS == {"deform_patches_bounded": 0, "deform_patches_backward": 0,
                         "plain": 2, "plain_backward": 2}
    with torch.no_grad():
        assert not da.deform_patches_bounded(lx, loff, mask).requires_grad
    da.reset_counts()


def test_radius_16_gradients_equal_unbounded():
    """A radius every corner fits gives the unbounded gradients exactly."""
    x, off, mask, grad = _inputs(np.random.default_rng(5), resid=3.0)
    a = da.deform_patches_backward_plain(grad, x, off, mask, None)
    b = da.deform_patches_backward_plain(grad, x, off, mask, 16)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("bias", [True, False])
def test_modulated_deform_conv_grads_match_jax_vjp(bias):
    rng = np.random.default_rng(6)
    x, off, mask, _ = _inputs(rng, b=1, h=6, w=8, cin=16, g=4)
    weight = (0.1 * rng.standard_normal((5, 16, 3, 3))).astype(np.float32)   # (Cout, Cin, 3, 3)
    b_np = rng.standard_normal(5).astype(np.float32) if bias else None
    cot = rng.standard_normal((1, 6, 8, 5)).astype(np.float32)

    def jfn(xx, oo, mm, ww, bb):
        return JM.modulated_deform_conv(xx, oo, mm, ww, bb, 4)

    jargs = [jnp.asarray(a.numpy()) for a in (x, off, mask)]
    jargs += [jnp.asarray(weight.transpose(2, 3, 1, 0)), None if b_np is None else jnp.asarray(b_np)]
    want_out, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jnp.asarray(cot))

    leaves = _leaves(x, off, mask, torch.from_numpy(weight))
    tb = torch.from_numpy(b_np).requires_grad_(True) if bias else None
    out = TM.modulated_deform_conv(*leaves[:3], leaves[3], tb, 4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0,
                               atol=JAX_REL * float(np.abs(want_out).max()))
    out.backward(torch.from_numpy(cot))
    got = [leaves[0].grad, leaves[1].grad, leaves[2].grad,
           leaves[3].grad.permute(2, 3, 1, 0), None if tb is None else tb.grad]
    for name, g, w in zip(("x", "offset", "mask", "weight", "bias"), got, want):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=JAX_REL * float(np.abs(w).max()), err_msg=name)
