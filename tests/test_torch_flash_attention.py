"""The port's B3 wrapper (`flash_attention_relpos`, global attention with a
factorised rel-pos bias) against the JAX package's Pallas kernel.

Same numpy inputs through both. The JAX kernel runs in Pallas interpret
mode, and beside it the XLA reference of `tests/test_flash_attention.py`;
the port's wrapper, given CPU tensors, runs its plain PyTorch version (the
CUDA kernel itself is held against that version on the card by
chip_smoke.py). fp32 within 1e-4: the three differ only in summation order
(tile by tile in the kernel, one matmul in the others). The Pallas kernel
needs N divisible by its q tile (256 here) and by whole grid rows.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.ops.pallas.flash_attention import flash_attention_relpos as jflash
from vosesam_tpu_torch.ops.kernels import flash_attention as tfa

TOL = 1e-4


def _xla_reference(q, k, v, bh, bw):
    heads, n, d = q.shape
    attn = jnp.einsum("hqd,hkd->hqk", q, k) / math.sqrt(d)
    bias = (bh[..., :, None] + bw[..., None, :]).reshape(heads, n, n)
    return jnp.einsum("hqk,hkd->hqd", jax.nn.softmax(attn + bias, axis=-1), v)


def _inputs(rng, bh, gh, gw, d):
    n = gh * gw
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((bh, n, d), (bh, n, d), (bh, n, d), (bh, n, gh), (bh, n, gw))]


@pytest.mark.parametrize("gh,gw,d,bh", [(16, 16, 64, 2), (16, 16, 80, 3), (8, 32, 64, 2),
                                        (8, 32, 80, 4)])
def test_plain_matches_pallas_and_xla(gh, gw, d, bh):
    a = _inputs(np.random.default_rng(gh * 100 + d + bh), bh, gh, gw, d)
    tfa.reset_counts()
    port = tfa.flash_attention_relpos(*map(torch.from_numpy, a), (gh, gw)).numpy()
    assert tfa.COUNTS == {"flash_attention_relpos": 0, "plain": 1}
    ja = [jnp.asarray(x) for x in a]
    pallas = np.asarray(jflash(*ja, (gh, gw), interpret=True))
    xla = np.asarray(_xla_reference(*ja))
    np.testing.assert_allclose(port, pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port, xla, atol=TOL, rtol=TOL)


def test_plain_bf16_casts_probabilities_to_v_dtype():
    """bf16: the plain version rounds the probabilities to bf16 before the AV
    product, as the Pallas kernel does (flash_attention.py:106-110)."""
    a = _inputs(np.random.default_rng(3), 2, 8, 8, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in a[:3])
    out = tfa.flash_attention_relpos(tq, tk, tv, torch.from_numpy(a[3]),
                                     torch.from_numpy(a[4]), (8, 8))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 64, 64)
    ja = [jnp.asarray(x, jnp.bfloat16) for x in a[:3]] + [jnp.asarray(x) for x in a[3:]]
    pallas = np.asarray(jflash(*ja, (8, 8), q_tile=64, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=2e-2, rtol=2e-2)


def test_kernel_checks_and_cpu_routing():
    """CUDA tensors launch the kernel or raise; the checks run before it."""
    a = [torch.from_numpy(x) for x in _inputs(np.random.default_rng(1), 2, 4, 4, 16)]
    with pytest.raises(ValueError, match="gh \\* gw"):
        tfa._check(*a, (4, 5))
    with pytest.raises(ValueError, match="bias_w"):
        tfa._check(*a[:4], a[4][..., :3].contiguous(), (4, 4))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tfa._check(*a, (4, 4))
