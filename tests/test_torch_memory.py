"""The port's memory hierarchy (rings + manager) against `vosesam_tpu.memory`.

A sequence of reads and writes on the same numpy inputs runs through both
packages: `match_memory` (shared-validity or per-object fused read, chosen
by `MemoryConfig.live_objects` exactly as in JAX, or the plain chain with
`fused_read=False`; the JAX side runs its Pallas kernels in interpret mode) and `add_memory` until consolidation has
filled the long-term arena and then overwritten its least-used slots. After
every step every arena tensor is compared, slot placement included (the
stable top-k makes prototype and victim order equal to `lax.top_k`'s).

Tolerances: copied keys/values/validity and counts exactly; usage counts
and consolidated prototypes (softmax-weighted sums) at 1e-5 abs/rel, the
fp32 summation-order difference between XLA:CPU and PyTorch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.config import MemoryConfig as JMemoryConfig
from vosesam_tpu.config import XMemConfig as JXMemConfig
from vosesam_tpu.memory import manager as jman
from vosesam_tpu.memory import rings as jrings
from vosesam_tpu_torch.config import MemoryConfig, XMemConfig
from vosesam_tpu_torch.memory import manager as tman
from vosesam_tpu_torch.memory import rings as trings

H16, W16 = 3, 4
HW = H16 * W16
O = 2
CK, CV = 16, 32
TOL = 1e-5

MEM = dict(max_mid_term_frames=3, min_mid_term_frames=2, max_long_term_elements=16,
           num_prototypes=8, top_k=8, mem_every=2)
XM = dict(key_dim=CK, value_dim=CV, hidden_dim=8, max_objects=O)


def _frame_inputs(r):
    return dict(
        key=r.standard_normal((H16, W16, CK)).astype(np.float32),
        shrinkage=(1.0 + r.standard_normal((H16, W16, 1)) ** 2).astype(np.float32),
        selection=r.uniform(0, 1, (H16, W16, CK)).astype(np.float32),
        value=r.standard_normal((O, H16, W16, CV)).astype(np.float32),
    )


def _compare(tstate, jstate):
    for part in ("work", "long"):
        t, j = getattr(tstate, part), getattr(jstate, part)
        for f in dataclasses.fields(t):
            tv = getattr(t, f.name)
            jv = getattr(j, f.name)
            if f.name == "count":
                assert tv == int(jv)
                continue
            tv, jv = tv.numpy(), np.asarray(jv)
            if tv.dtype == bool or f.name in ("keys", "selection"):
                np.testing.assert_array_equal(tv, jv, err_msg=f"{part}.{f.name}")
            else:
                np.testing.assert_allclose(tv, jv, atol=TOL, rtol=TOL,
                                           err_msg=f"{part}.{f.name}")
    np.testing.assert_array_equal(tstate.obj_valid.numpy(), np.asarray(jstate.obj_valid))


@pytest.mark.parametrize("live_objects,fused_read", [(O, True), (None, True), (O, False)],
                         ids=["shared", "per_object", "plain_chain"])
def test_read_write_consolidate_matches_jax(live_objects, fused_read):
    tcfg = MemoryConfig(**MEM, live_objects=live_objects, fused_read=fused_read)
    jcfg = JMemoryConfig(**MEM, live_objects=live_objects, fused_read=fused_read)
    tstate = trings.init_memory(tcfg, XMemConfig(**XM), (H16, W16))
    jstate = jrings.init_memory(jcfg, JXMemConfig(**XM), (H16, W16))
    r = np.random.default_rng(0)
    obj_valid = np.array([True, True])
    lt_keys_before_overwrite = None
    for step in range(7):
        q = _frame_inputs(r)
        tread, tstate = tman.match_memory(
            tstate, torch.from_numpy(q["key"]), torch.from_numpy(q["selection"]), tcfg)
        jread, jstate = jman.match_memory(
            jstate, jnp.asarray(q["key"]), jnp.asarray(q["selection"]), jcfg)
        np.testing.assert_allclose(tread.numpy(), np.asarray(jread), atol=1e-4, rtol=1e-4)
        _compare(tstate, jstate)

        a = _frame_inputs(r)
        if step == 6:                       # before the last consolidation
            lt_keys_before_overwrite = tstate.long.keys.clone()
        tstate = tman.add_memory(tstate, *(torch.from_numpy(a[k]) for k in
                                           ("key", "shrinkage", "selection", "value")),
                                 torch.from_numpy(obj_valid), tcfg, HW)
        jstate = jman.add_memory(jstate, *(jnp.asarray(a[k]) for k in
                                           ("key", "shrinkage", "selection", "value")),
                                 jnp.asarray(obj_valid), jcfg, HW)
        _compare(tstate, jstate)
    # consolidations filled the 16-slot LT arena, then overwrote valid slots
    assert bool(tstate.long.key_valid.all())
    changed = (tstate.long.keys != lt_keys_before_overwrite).any(dim=1)
    assert 0 < int(changed.sum()) <= MEM["num_prototypes"]


def test_unfused_read_counts_as_plain(monkeypatch):
    """`fused_read=False` takes the plain chain on any device and never
    reaches a kernel wrapper, so it shows in `COUNTS["plain"]` on the card
    as well; with `fused_read=True` the wrapper is reached."""
    from vosesam_tpu_torch.ops.kernels import memory_read as kernels

    def kernel(*args, **kwargs):
        raise AssertionError("kernel wrapper reached")

    monkeypatch.setattr(kernels, "fused_memory_read_shared", kernel)
    monkeypatch.setattr(kernels, "fused_memory_read", kernel)
    q = torch.from_numpy(_frame_inputs(np.random.default_rng(2))["key"])
    for live_objects in (O, None):
        cfg = MemoryConfig(**MEM, live_objects=live_objects, fused_read=False)
        state = trings.init_memory(cfg, XMemConfig(**XM), (H16, W16))
        kernels.reset_counts()
        tman.match_memory(state, q, q, cfg)
        assert kernels.COUNTS == {"fused_memory_read_shared": 0, "fused_memory_read": 0,
                                  "plain": 1}
        with pytest.raises(AssertionError, match="kernel wrapper reached"):
            tman.match_memory(state, q, q, dataclasses.replace(cfg, fused_read=True))
    kernels.reset_counts()


def test_drop_oldest_chunk_without_long_term():
    tcfg = MemoryConfig(**MEM, enable_long_term=False)
    jcfg = JMemoryConfig(**MEM, enable_long_term=False)
    tstate = trings.init_memory(tcfg, XMemConfig(**XM), (H16, W16))
    jstate = jrings.init_memory(jcfg, JXMemConfig(**XM), (H16, W16))
    r = np.random.default_rng(1)
    obj_valid = np.array([True, False])
    for _ in range(5):
        a = _frame_inputs(r)
        tstate = tman.add_memory(tstate, *(torch.from_numpy(a[k]) for k in
                                           ("key", "shrinkage", "selection", "value")),
                                 torch.from_numpy(obj_valid), tcfg, HW)
        jstate = jman.add_memory(jstate, *(jnp.asarray(a[k]) for k in
                                           ("key", "shrinkage", "selection", "value")),
                                 jnp.asarray(obj_valid), jcfg, HW)
        _compare(tstate, jstate)
    assert tstate.work.count == tstate.work.capacity


def test_grow_objects_pads_invalid():
    cfg = MemoryConfig(**MEM)
    state = trings.init_memory(cfg, XMemConfig(**XM), (H16, W16))
    state.obj_valid[:] = True
    grown = trings.grow_objects(state, O + 1)
    assert grown.work.values.shape[0] == O + 1
    assert grown.hidden.shape[0] == O + 1
    assert grown.obj_valid.tolist() == [True, True, False]
    assert not grown.long.value_valid[O].any()
    assert trings.grow_objects(grown, O) is grown


def test_sharded_read_waits_for_multi_device():
    """Two memory shards need a process group of two ranks (the sharded
    read itself: test_torch_parallel.py)."""
    from vosesam_tpu_torch.config import ParallelConfig

    cfg = MemoryConfig(**MEM)
    state = trings.init_memory(cfg, XMemConfig(**XM), (H16, W16))
    q = torch.zeros((H16, W16, CK))
    with pytest.raises(ValueError, match="process group"):
        tman.match_memory(state, q, q, cfg, ParallelConfig(memory_axis_shards=2))
