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


def _port(a, dtype=torch.float32):
    """The JAX kernel's (heads, N, ...) arrays as the port's (1, heads, N, ...)
    tensors, q / k / v in `dtype`."""
    return [torch.from_numpy(x)[None].to(dtype if i < 3 else torch.float32)
            for i, x in enumerate(a)]


@pytest.mark.parametrize("gh,gw,d,bh", [(16, 16, 64, 2), (16, 16, 80, 3), (8, 32, 64, 2),
                                        (8, 32, 80, 4)])
def test_plain_matches_pallas_and_xla(gh, gw, d, bh):
    a = _inputs(np.random.default_rng(gh * 100 + d + bh), bh, gh, gw, d)
    tfa.reset_counts()
    port = tfa.flash_attention_relpos(*_port(a), (gh, gw))[0].numpy()
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
    out = tfa.flash_attention_relpos(*_port(a, torch.bfloat16), (8, 8))[0]
    assert out.dtype == torch.bfloat16 and out.shape == (2, 64, 64)
    ja = [jnp.asarray(x, jnp.bfloat16) for x in a[:3]] + [jnp.asarray(x) for x in a[3:]]
    pallas = np.asarray(jflash(*ja, (8, 8), q_tile=64, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=2e-2, rtol=2e-2)


def test_kernel_checks_and_cpu_routing():
    """CUDA tensors launch the kernel or raise; the checks run before it."""
    a = _port(_inputs(np.random.default_rng(1), 2, 4, 4, 16))
    with pytest.raises(ValueError, match="gh \\* gw"):
        tfa._check(*a, (4, 5))
    with pytest.raises(ValueError, match="bias_w"):
        tfa._check(*a[:4], a[4][..., :3].contiguous(), (4, 4))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tfa._check(*a, (4, 4))
    with pytest.raises(ValueError, match="last axis"):
        tfa._check(a[0].transpose(2, 3).contiguous().transpose(2, 3), *a[1:], (4, 4))


def _fused_views(rng, b, heads, gh, gw, d):
    """q, k, v as the encoder hands them over: the (b, heads, N, D) views of
    one (b, N, 3, heads, D) projection (token stride 3 * heads * D, head
    stride D), and the fp32 (b, heads, N, gh) / (b, heads, N, gw) factors."""
    n = gh * gw
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, heads, d)).astype(np.float32))
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    bh = torch.from_numpy(rng.standard_normal((b, heads, n, gh)).astype(np.float32))
    bw = torch.from_numpy(rng.standard_normal((b, heads, n, gw)).astype(np.float32))
    return q, k, v, bh, bw


# N 96 and 130 are not multiples of the kernel's 64-key tile; 130 has an odd
# grid width, whose key pairs can straddle a grid row
@pytest.mark.parametrize("b,heads,gh,gw,d", [(2, 3, 8, 12, 16), (1, 2, 10, 13, 80),
                                             (2, 2, 8, 8, 80)])
def test_plain_on_strided_views_matches_pallas(b, heads, gh, gw, d):
    """The plain version on the encoder's strided views equals itself on
    contiguous copies, and each batch item matches the Pallas kernel
    (interpret mode, one q tile of N)."""
    q, k, v, bh, bw = _fused_views(np.random.default_rng(gh * gw + d), b, heads, gh, gw, d)
    assert not q.is_contiguous() and q.stride(-1) == 1
    tfa.reset_counts()
    out = tfa.flash_attention_relpos(q, k, v, bh, bw, (gh, gw))
    dense = tfa.flash_attention_relpos_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                             bh, bw, (gh, gw))
    assert tfa.COUNTS == {"flash_attention_relpos": 0, "plain": 2}
    assert out.shape == (b, heads, gh * gw, d)
    torch.testing.assert_close(out, dense, atol=0, rtol=0)
    for i in range(b):
        ja = [jnp.asarray(x[i].contiguous().numpy()) for x in (q, k, v, bh, bw)]
        pallas = np.asarray(jflash(*ja, (gh, gw), q_tile=gh * gw, interpret=True))
        np.testing.assert_allclose(out[i].numpy(), pallas, atol=TOL, rtol=TOL)


def test_plain_bf16_strided_views_match_contiguous():
    """bf16 views of one projection: the same result as contiguous copies,
    and within the bf16 tolerance of the Pallas kernel."""
    q, k, v, bh, bw = _fused_views(np.random.default_rng(7), 2, 2, 8, 12, 64)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    assert q.stride(-1) == 1 and not q.is_contiguous()
    out = tfa.flash_attention_relpos(q, k, v, bh, bw, (8, 12))
    dense = tfa.flash_attention_relpos(q.contiguous(), k.contiguous(), v.contiguous(), bh, bw,
                                       (8, 12))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, dense, atol=0, rtol=0)
    for i in range(2):
        ja = ([jnp.asarray(x[i].float().contiguous().numpy(), jnp.bfloat16) for x in (q, k, v)]
              + [jnp.asarray(x[i].numpy()) for x in (bh, bw)])
        pallas = np.asarray(jflash(*ja, (8, 12), q_tile=96, interpret=True).astype(jnp.float32))
        np.testing.assert_allclose(out[i].float().numpy(), pallas, atol=2e-2, rtol=2e-2)
