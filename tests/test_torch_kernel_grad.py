"""B1-B5 and B7's wrappers compute forward passes only. On the card each
refuses, through `ops/kernels/_autograd.refuse_grad`, an input that
requires grad under grad mode (chip_smoke.py checks that on the card); on
the CPU the wrappers run their plain PyTorch versions, which stay
differentiable. B6 is an autograd Function with a backward kernel on the
card and the plain backward on the CPU (`tests/test_torch_deform_grad.py`
holds its numbers). Held here on the CPU: the helper itself, a backward
pass through each wrapper's CPU branch, and which wrappers still refuse."""

import numpy as np
import pytest
import torch

from vosesam_tpu_torch.ops.kernels import binscan_probe as tbp
from vosesam_tpu_torch.ops.kernels import deform_align as tda
from vosesam_tpu_torch.ops.kernels import flash_attention as tfa
from vosesam_tpu_torch.ops.kernels import memory_read as tmr
from vosesam_tpu_torch.ops.kernels import window_attention as twa
from vosesam_tpu_torch.ops.kernels._autograd import refuse_grad


def test_refuse_grad_raises_for_an_input_that_requires_grad():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="kern: the CUDA kernel has no backward"):
        refuse_grad("kern", torch.zeros(2), x)


def test_refuse_grad_passes_without_grad_mode_or_grad_inputs():
    x = torch.zeros(3, requires_grad=True)
    with torch.no_grad():
        refuse_grad("kern", x)
    with torch.inference_mode():
        refuse_grad("kern", torch.zeros(3))
    refuse_grad("kern", torch.zeros(3), None, 3, x.detach())


def _r(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _leaf(t):
    return t.clone().requires_grad_(True)


def _case(name, rng):
    """(call, inputs that require grad) of one wrapper on CPU tensors."""
    if name == "fused_memory_read_shared":
        mk, qk, mv = _leaf(_r(rng, 40, 8)), _r(rng, 6, 8), _leaf(_r(rng, 2, 40, 4))
        valid = torch.ones(40, dtype=torch.bool)
        return (lambda: tmr.fused_memory_read_shared(mk, None, qk, None, mv, valid, 4)[0],
                (mk, mv))
    if name == "fused_memory_read":
        mk, qk, mv = _leaf(_r(rng, 40, 8)), _r(rng, 6, 8), _leaf(_r(rng, 2, 40, 4))
        valid = torch.ones((2, 40), dtype=torch.bool)
        return lambda: tmr.fused_memory_read(mk, None, qk, None, mv, valid, 4)[0], (mk, mv)
    if name == "flash_attention_relpos":
        q, k, v = (_leaf(_r(rng, 1, 2, 12, 8)) for _ in range(3))
        bh, bw = _leaf(_r(rng, 1, 2, 12, 3)), _r(rng, 1, 2, 12, 4)
        return lambda: tfa.flash_attention_relpos(q, k, v, bh, bw, (3, 4)), (q, k, v, bh)
    if name in ("window_attention_relpos", "window_attention_relpos_mh"):
        q, k, v = (_leaf(_r(rng, 2, 2, 6, 8)) for _ in range(3))
        bh, bw = _r(rng, 2, 2, 6, 2), _leaf(_r(rng, 2, 2, 6, 3))
        fn = getattr(twa, name)
        return lambda: fn(q, k, v, bh, bw, (2, 3)), (q, k, v, bw)
    if name == "deform_patches_bounded":
        x = _leaf(_r(rng, 1, 5, 6, 8))
        off = _leaf(torch.from_numpy(
            (2.0 * np.tanh(rng.standard_normal((1, 5, 6, 36))) + 0.37).astype(np.float32)))
        mask = _leaf(torch.sigmoid(_r(rng, 1, 5, 6, 18)))
        return lambda: tda.deform_patches_bounded(x, off, mask), (x, off, mask)
    assert name == "binscan_probe"
    x, y0, wy = tbp.probe_inputs(torch.Generator().manual_seed(0), 8, 3, 1, 2, 2, 3, pad=3)
    x, wy = _leaf(x), _leaf(wy)
    return lambda: tbp.binscan_probe(x, y0, wy, 3, groups=2), (x, wy)


@pytest.mark.parametrize("name", ["fused_memory_read_shared", "fused_memory_read",
                                  "flash_attention_relpos", "window_attention_relpos",
                                  "window_attention_relpos_mh", "deform_patches_bounded",
                                  "binscan_probe"])
def test_cpu_branch_backpropagates(name):
    """Given CPU tensors, every wrapper runs its plain version under grad
    mode (no refusal) and gradients reach each input that requires grad."""
    fn, leaves = _case(name, np.random.default_rng(len(name)))
    out = fn()
    assert out.requires_grad
    (out.float() ** 2).sum().backward()
    for t in leaves:
        assert t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0


def test_b6_is_a_function_and_the_others_refuse_on_the_card():
    """B6's wrapper routes through `DeformPatches` (no refusal); the other
    wrappers' modules still call `refuse_grad` on their CUDA branch."""
    import inspect

    fn, leaves = _case("deform_patches_bounded", np.random.default_rng(1))
    assert isinstance(fn().grad_fn, tda.DeformPatches._backward_cls)
    assert "refuse_grad" not in inspect.getsource(tda)
    for mod in (tbp, tfa, tmr, twa):
        assert "refuse_grad(" in inspect.getsource(mod), mod.__name__
