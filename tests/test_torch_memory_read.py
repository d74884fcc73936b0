"""The port's fused memory-read wrappers (B1 `fused_memory_read_shared`, B2
`fused_memory_read`) against the JAX package's Pallas kernels.

Same numpy inputs through both. The JAX kernels run in Pallas interpret mode
on the CPU; the port's wrappers, given CPU tensors, run their plain PyTorch
versions (the CUDA kernel itself is held against those versions on the card
by chip_smoke.py). Tolerances are the JAX kernel tests' own: 1e-4 abs/rel in
fp32 (summation order differs: the Pallas kernel accumulates tile by tile,
the plain version in one matmul), 5e-3 with bf16 keys/values (bf16 inputs
round identically in both frameworks; the rest is fp32 reassociation
amplified by bf16-sized similarities). Inputs are continuous, so no
similarity ties decide a result (the Pallas kernel collapses in-tile
duplicates, memory_read.py:24-28).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.ops.pallas import memory_read as jmr
from vosesam_tpu_torch.ops.kernels import memory_read as tmr

ATOL = RTOL = 1e-4
BF16_TOL = 5e-3


def _case(rng, o=3, m=300, q=100, ck=64, cv=96):
    return dict(
        mk=rng.standard_normal((m, ck)).astype(np.float32),
        ms=rng.uniform(1, 5, (m,)).astype(np.float32),
        qk=rng.standard_normal((q, ck)).astype(np.float32),
        qe=rng.uniform(0, 1, (q, ck)).astype(np.float32),
        mv=rng.standard_normal((o, m, cv)).astype(np.float32),
        kv=rng.uniform(0, 1, (m,)) > 0.2,
        vv=rng.uniform(0, 1, (o, m)) > 0.3,
    )


def _args(c, lib, drop_ms=False, drop_qe=False, bf16=False):
    if lib == "jax":
        conv = (lambda a: jnp.asarray(a, jnp.bfloat16)) if bf16 else jnp.asarray
    else:
        conv = ((lambda a: torch.from_numpy(a).to(torch.bfloat16)) if bf16
                else torch.from_numpy)
    as_f32 = jnp.asarray if lib == "jax" else torch.from_numpy
    return dict(mk=conv(c["mk"]), ms=None if drop_ms else as_f32(c["ms"]),
                qk=conv(c["qk"]), qe=None if drop_qe else conv(c["qe"]),
                mv=conv(c["mv"]))


def _valid(a, lib):
    return jnp.asarray(a) if lib == "jax" else torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, tol=ATOL):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------ B2 per-object

@pytest.mark.parametrize("name, shape, top_k, q_tile", [
    ("basic", dict(o=3, m=300, q=100), 12, 416),
    ("multi_tile", dict(o=2, m=1100, q=200, cv=64), 16, 104),
])
def test_per_object_matches_pallas(rng, name, shape, top_k, q_tile):
    c = _case(rng, **shape)
    valid = c["kv"][None] & c["vv"]
    valid[-1] = False                       # one object without any memory
    ref_out, ref_use = jmr.fused_memory_read(
        **_args(c, "jax"), valid=_valid(valid, "jax"), top_k=top_k,
        return_usage=True, q_tile=q_tile, m_tile=512, interpret=True)
    out, use = tmr.fused_memory_read(
        **_args(c, "torch"), valid=_valid(valid, "torch"), top_k=top_k,
        return_usage=True)
    _close(out, ref_out)
    _close(use, ref_use)
    assert not out[-1].any()


def test_per_object_fewer_than_k_valid(rng):
    """Rows with < k valid slots: the threshold falls to NEG_INF and every
    valid slot is admitted."""
    c = _case(rng, o=2, m=200, q=40)
    valid = np.zeros((2, 200), bool)
    valid[0, [3, 50, 77, 120, 199]] = True  # 5 < k = 12
    valid[1] = c["kv"] & c["vv"][1]
    ref_out, ref_use = jmr.fused_memory_read(
        **_args(c, "jax"), valid=_valid(valid, "jax"), top_k=12,
        return_usage=True, interpret=True)
    out, use = tmr.fused_memory_read(
        **_args(c, "torch"), valid=_valid(valid, "torch"), top_k=12, return_usage=True)
    _close(out, ref_out)
    _close(use, ref_use)
    # usage of object 0's five slots: each query row spreads mass 1 over them
    assert use[[3, 50, 77, 120, 199]].sum() >= 40 - 1e-3


def test_per_object_no_selection_no_shrinkage(rng):
    c = _case(rng, o=2, m=128, q=48)
    valid = c["kv"][None] & c["vv"]
    ref_out, _ = jmr.fused_memory_read(
        **_args(c, "jax", drop_ms=True, drop_qe=True), valid=_valid(valid, "jax"),
        top_k=8, interpret=True)
    out, use = tmr.fused_memory_read(
        **_args(c, "torch", drop_ms=True, drop_qe=True),
        valid=_valid(valid, "torch"), top_k=8)
    _close(out, ref_out)
    assert use is None


def test_per_object_bf16_inputs(rng):
    c = _case(rng, o=2, m=256, q=64)
    valid = c["kv"][None] & c["vv"]
    ref_out, _ = jmr.fused_memory_read(
        **_args(c, "jax", bf16=True), valid=_valid(valid, "jax"), top_k=8,
        interpret=True)
    out, _ = tmr.fused_memory_read(
        **_args(c, "torch", bf16=True), valid=_valid(valid, "torch"), top_k=8)
    _close(out, ref_out, BF16_TOL)


# ------------------------------------------------------------ B1 shared

def _shared_valid(rng, c):
    m = c["mk"].shape[0]
    return c["kv"] & (rng.uniform(0, 1, (m,)) > 0.3)


@pytest.mark.parametrize("name, shape, top_k, q_tile", [
    ("basic", dict(o=3, m=300, q=100), 12, 416),
    ("multi_tile", dict(o=2, m=1100, q=200, cv=64), 16, 104),
])
def test_shared_matches_pallas(rng, name, shape, top_k, q_tile):
    c = _case(rng, **shape)
    shared = _shared_valid(rng, c)
    ref_out, ref_use = jmr.fused_memory_read_shared(
        **_args(c, "jax"), valid=_valid(shared, "jax"), top_k=top_k,
        return_usage=True, q_tile=q_tile, m_tile=512, interpret=True)
    out, use = tmr.fused_memory_read_shared(
        **_args(c, "torch"), valid=_valid(shared, "torch"), top_k=top_k,
        return_usage=True)
    _close(out, ref_out)
    _close(use, ref_use)


@pytest.mark.parametrize("live", [0, 700])
def test_shared_live_end(rng, live):
    """live_end = 0 (empty arena) and mid-arena: slots past it hold no valid
    entry and must not change anything."""
    c = _case(rng, o=2, m=1600, q=200, cv=64)
    shared = _shared_valid(rng, c) & (np.arange(1600) < live)
    ref_out, ref_use = jmr.fused_memory_read_shared(
        **_args(c, "jax"), valid=_valid(shared, "jax"), top_k=16,
        return_usage=True, live_end=jnp.int32(live), q_tile=104, m_tile=512,
        interpret=True)
    out, use = tmr.fused_memory_read_shared(
        **_args(c, "torch"), valid=_valid(shared, "torch"), top_k=16,
        return_usage=True, live_end=live)
    _close(out, ref_out)
    _close(use, ref_use)
    assert not use[live:].any()
    if live == 0:
        assert torch.isfinite(out).all() and not out.any()


@pytest.mark.parametrize("shared", [True, False])
def test_empty_memory(rng, shared):
    """Frame-0 read: nothing valid -> zero readout, zero usage, no NaN."""
    c = _case(rng, o=2, m=64, q=32)
    if shared:
        out, use = tmr.fused_memory_read_shared(
            **_args(c, "torch"), valid=torch.zeros(64, dtype=torch.bool), top_k=8,
            return_usage=True)
    else:
        out, use = tmr.fused_memory_read(
            **_args(c, "torch"), valid=torch.zeros((2, 64), dtype=torch.bool), top_k=8,
            return_usage=True)
    assert torch.isfinite(out).all()
    assert not out.any() and not use.any()


def test_shared_bf16_matches_per_object(rng):
    """Identical validity rows: B1 equals B2 with the row broadcast, in bf16,
    and both match the JAX shared kernel."""
    c = _case(rng, o=2, m=256, q=64)
    shared = _shared_valid(rng, c)
    ref_out, ref_use = jmr.fused_memory_read_shared(
        **_args(c, "jax", bf16=True), valid=_valid(shared, "jax"), top_k=8,
        return_usage=True, interpret=True)
    out, use = tmr.fused_memory_read_shared(
        **_args(c, "torch", bf16=True), valid=_valid(shared, "torch"), top_k=8,
        return_usage=True)
    out2, use2 = tmr.fused_memory_read(
        **_args(c, "torch", bf16=True),
        valid=_valid(np.broadcast_to(shared, (2, 256)), "torch"), top_k=8,
        return_usage=True)
    _close(out, ref_out, BF16_TOL)
    _close(use, ref_use, BF16_TOL)
    torch.testing.assert_close(out, out2, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(use, use2, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fn", ["fused_memory_read_shared", "fused_memory_read"])
def test_top_k_above_32_raises(rng, fn):
    c = _case(rng, o=2, m=100, q=8)
    valid = torch.ones(100, dtype=torch.bool)
    if fn == "fused_memory_read":
        valid = torch.ones((2, 100), dtype=torch.bool)
    with pytest.raises(ValueError, match="top_k <= 32"):
        getattr(tmr, fn)(**_args(c, "torch"), valid=valid, top_k=33)


def test_cpu_tensors_take_the_plain_version(rng):
    c = _case(rng, o=2, m=64, q=16)
    tmr.reset_counts()
    tmr.fused_memory_read_shared(**_args(c, "torch"), valid=torch.ones(64, dtype=torch.bool),
                                 top_k=8)
    tmr.fused_memory_read(**_args(c, "torch"), valid=torch.ones((2, 64), dtype=torch.bool),
                          top_k=8)
    assert tmr.COUNTS == {"fused_memory_read_shared": 0, "fused_memory_read": 0, "plain": 2}


# ------------------------------------- the kernels' inputs (host side)

from vosesam_tpu_torch.ops.memory_attention import get_similarity  # noqa: E402


def _torch_case(rng, m=900, q=120, ck=64, bf16=True):
    c = _case(rng, o=1, m=m, q=q, ck=ck, cv=8)
    dt = torch.bfloat16 if bf16 else torch.float32
    return (torch.from_numpy(c["mk"]).to(dt), torch.from_numpy(c["ms"]),
            torch.from_numpy(c["qk"]).to(dt), torch.from_numpy(c["qe"]).to(dt))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("drop_ms, drop_qe", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_kernel_inputs_are_get_similarity_for_every_dtype(rng, bf16, drop_ms, drop_qe):
    """The kernels stream `get_similarity`'s fp32 matrix for bf16 and fp32
    keys alike, with and without shrinkage and selection: bit for bit the
    values `topk_softmax` selects from in the plain versions (ROADMAP C24),
    contiguous for the kernels' row-pitch reads; the validity rows go as
    contiguous uint8."""
    mk, ms, qk, qe = _torch_case(rng, m=300, q=40, bf16=bf16)
    ms = None if drop_ms else ms
    qe = None if drop_qe else qe
    valid = torch.from_numpy(rng.random((2, 300)) > 0.3)
    sim, valid_u8 = tmr.kernel_inputs(mk, ms, qk, qe, valid[:, ::1])
    want = get_similarity(mk, ms, qk, qe)
    assert sim.dtype == torch.float32 and sim.is_contiguous()
    assert torch.equal(sim, want)
    assert valid_u8.dtype == torch.uint8 and valid_u8.is_contiguous()
    assert torch.equal(valid_u8.bool(), valid)
    # a strided validity view is made contiguous, not reinterpreted
    strided = torch.from_numpy(rng.random((600, 2)) > 0.5).T
    _, vu8 = tmr.kernel_inputs(mk, ms, qk, qe, strided[:, :300])
    assert vu8.is_contiguous() and torch.equal(vu8.bool(), strided[:, :300])


@pytest.mark.parametrize("q, groups, live_end, slots, want", [
    (1620, 1, 15580, 660, 6),     # DAVIS 480p, shared mode: one round of 5 blocks x 132 SMs
    (1620, 1, 17200, 528, 5),     # per-object mode, two objects in a block, 4 blocks an SM
    (1620, 4, 17200, 528, 1),     # eight objects: four block groups
    (1620, 1, 100, 660, 2),       # a short memory: at most one split per chunk
    (1620, 1, 0, 660, 1),         # an empty memory still launches one split
    (16, 1, 17200, 660, 8),       # one row tile: at most eight splits
])
def test_splits_for(q, groups, live_end, slots, want):
    assert tmr.splits_for(q, groups, live_end, slots) == want


def test_row_groups_and_tensor_core_choice(rng):
    """Blocks along the validity rows: one per row in shared mode, two rows a
    block in per-object mode. No instance takes the tensor cores any more:
    every input reaches the kernels as `get_similarity`'s matrix."""
    assert [tmr._row_groups(r, True) for r in (1, 2, 3)] == [1, 2, 3]
    assert [tmr._row_groups(r, False) for r in (1, 2, 3, 8)] == [1, 1, 2, 4]
    assert not hasattr(tmr, "_tensor_cores") and not hasattr(tmr, "similarity_operands")
