"""The port's B4 / B5 wrappers (`window_attention_relpos`,
`window_attention_relpos_mh`: whole-window attention with a factorised
rel-pos bias) against the JAX package's two Pallas kernels.

Same numpy inputs, made from a seed, through both. The JAX kernels run in
Pallas interpret mode; the port's wrappers, given CPU tensors, run their
plain PyTorch version (the CUDA kernel itself is held against that version
on the card by chip_smoke.py). Tolerances are the JAX kernel tests' own
(`tests/test_flash_attention.py`): fp32 within 2e-3 (summation order, and
the Pallas kernels add the bias through one-hot matmuls); bf16 within 2e-2
(the probabilities are rounded to bf16 before the AV product on both sides,
the output is rounded to bf16 once more).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.ops.pallas.flash_attention import (
    window_attention_relpos as jwindow,
    window_attention_relpos_mh as jwindow_mh,
)
from vosesam_tpu_torch.ops.kernels import window_attention as twa

FP32_TOL = 2e-3
BF16_TOL = 2e-2
# JAX's own test shapes (5x9 windows: a token count that is no multiple of
# 8), then the ViT's 14x14 window at vit_h's head dim
SHAPES = [(3, 2, 5, 9, 64), (3, 4, 5, 9, 80), (2, 2, 14, 14, 80)]
KERNELS = {"window_attention_relpos": (jwindow, twa.window_attention_relpos),
           "window_attention_relpos_mh": (jwindow_mh, twa.window_attention_relpos_mh)}


def _inputs(rng, w, heads, wh, ww, d):
    t = wh * ww
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((w, heads, t, d), (w, heads, t, d), (w, heads, t, d),
                      (w, heads, t, wh), (w, heads, t, ww))]


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("w,heads,wh,ww,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(name, w, heads, wh, ww, d, dtype):
    jfn, tfn = KERNELS[name]
    a = _inputs(np.random.default_rng(wh * 100 + d + heads), w, heads, wh, ww, d)
    dj, dt = getattr(jnp, dtype), getattr(torch, dtype)
    twa.reset_counts()
    ta = [torch.from_numpy(x).to(dt) for x in a[:3]] + [torch.from_numpy(x) for x in a[3:]]
    port = tfn(*ta, (wh, ww))
    assert twa.COUNTS == {"window_attention_relpos": 0, "window_attention_relpos_mh": 0,
                          "plain": 1}
    assert port.dtype == dt and port.shape == (w, heads, wh * ww, d)
    ja = [jnp.asarray(x, dj) for x in a[:3]] + [jnp.asarray(x) for x in a[3:]]
    pallas = np.asarray(jfn(*ja, (wh, ww), interpret=True).astype(jnp.float32))
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(port.float().numpy(), pallas, atol=tol, rtol=tol)


def test_plain_takes_the_encoder_views():
    """q, k, v as the encoder passes them: strided views of one fused qkv
    projection give what contiguous copies give."""
    rng = np.random.default_rng(7)
    b, n, heads, hd = 3, 49, 2, 16
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, heads, hd)).astype(np.float32))
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    bh = torch.from_numpy(rng.standard_normal((b, heads, n, 7)).astype(np.float32))
    bw = torch.from_numpy(rng.standard_normal((b, heads, n, 7)).astype(np.float32))
    assert not q.is_contiguous()
    got = twa.window_attention_relpos(q, k, v, bh, bw, (7, 7))
    want = twa.window_attention_relpos(q.contiguous(), k.contiguous(), v.contiguous(),
                                       bh, bw, (7, 7))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_kernel_checks_and_cpu_routing():
    """CUDA tensors launch the kernel or raise; the checks run before it."""
    a = [torch.from_numpy(x) for x in _inputs(np.random.default_rng(1), 2, 2, 4, 4, 16)]
    with pytest.raises(ValueError, match="wh \\* ww"):
        twa._check(*a, (4, 5))
    with pytest.raises(ValueError, match="k must be"):
        twa._check(a[0], a[1][..., :10].contiguous(), *a[2:], (4, 4))
    with pytest.raises(ValueError, match="bias_w"):
        twa._check(*a[:4], a[4][..., :3].contiguous(), (4, 4))
    with pytest.raises(ValueError, match="must be \\(W, heads, T, D\\)"):
        twa._check(a[0][0], *a[1:], (4, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        twa._check(a[0].double(), *a[1:], (4, 4))
    wide = torch.zeros((2, 2, 16, 32))
    with pytest.raises(ValueError, match="q must be contiguous along its last axis"):
        twa._check(wide[..., ::2], *a[1:], (4, 4))
    with pytest.raises(ValueError, match="bias_h must be contiguous"):
        twa._check(*a[:3], torch.zeros((2, 2, 4, 16)).transpose(2, 3), a[4], (4, 4))
    with pytest.raises(ValueError, match="tokens per window"):
        big = torch.zeros((1, 1, 17 * 17, 8))
        twa._check(big, big, big, torch.zeros((1, 1, 289, 17)), torch.zeros((1, 1, 289, 17)),
                   (17, 17))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        twa._check(*a, (4, 4))
