"""Memory manager: read / write / consolidation over MemoryState (port of
`vosesam_tpu/memory/manager.py`).

Reference: tracker/inference/memory_manager.py.
  - `match_memory` (memory_manager.py:57-150): one shared similarity over
    the LT+work arena, per-object masked top-k softmax + readout, usage
    recording. Which fused kernel runs follows the JAX package exactly: the
    shared-validity kernel when `MemoryConfig.live_objects` holds, the
    per-object kernel otherwise.
  - `add_memory` (memory_manager.py:152-190): append an HW-token chunk; when
    the work arena is full, consolidate with static windows
      candidates = slots [HW, Cw-min_work+HW)   (memory_manager.py:211-243)
      keep       = frame-0 slots + the most recent min_work-HW slots.
  - `_consolidate` (memory_manager.py:245-285): top-P usage candidates become
    prototypes (potentiated values and shrinkage); they overwrite the P
    least-used LT slots, invalid slots first.
The arenas are updated in place (the JAX functions return new pytrees);
each function still returns the state so call sites read the same.

Ties: prototype and LT-victim choice use a stable descending sort, which
picks the lowest index first among equal scores like `lax.top_k` (the
eviction score starts as all-`inf` ties), so slot placement matches JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from vosesam_tpu_torch.config import MemoryConfig, ParallelConfig
from vosesam_tpu_torch.memory.rings import MemoryState
from vosesam_tpu_torch.ops.kernels import memory_read as kernels
from vosesam_tpu_torch.ops.memory_attention import (
    get_similarity,
    read_memory_multiobject,
)
from vosesam_tpu_torch.utils import profiling


def _top_indices(score: torch.Tensor, p: int) -> torch.Tensor:
    """Indices of the p largest scores, lowest index first among ties."""
    return torch.sort(score, descending=True, stable=True).indices[:p]


def match_memory(
    state: MemoryState,
    qk: torch.Tensor,                 # (H16, W16, Ck)
    qe: Optional[torch.Tensor],       # (H16, W16, Ck) selection
    cfg: MemoryConfig,
    pcfg: Optional[ParallelConfig] = None,
) -> Tuple[torch.Tensor, MemoryState]:
    """Read memory for all objects; returns ((O, H16, W16, Cv), state).

    `cfg.fused_read=False` (or top_k > 32) takes the plain chain on any
    device, as the JAX package takes its XLA chain; it counts as a plain
    call in `kernels.COUNTS`, so a run on the card shows it.
    `pcfg.memory_axis_shards` > 1 reads with the memory axis split over the
    ranks of the default process group (`parallel/memory_shard.py`; the
    group's size must equal the shard count, M must divide by it), also a
    plain call."""
    with profiling.span("memory.read"):
        if cfg.top_k_approx:
            raise NotImplementedError(
                "top_k_approx: the approximate top-k threshold is the TPU's lax.approx_max_k; "
                "the port reads with the exact top-k only")
        h16, w16, ck = qk.shape
        q = qk.reshape(-1, ck)
        e = qe.reshape(-1, ck) if qe is not None else None
        work, lt = state.work, state.long

        if cfg.enable_long_term:
            mk = torch.cat([lt.keys, work.keys], 0)
            ms = torch.cat([lt.shrinkage, work.shrinkage], 0)
            mv = torch.cat([lt.values, work.values], 1)
            kv = torch.cat([lt.key_valid, work.key_valid()], 0)
            vv = torch.cat([lt.value_valid, work.value_valid], 1)
        else:
            mk, ms, mv = work.keys, work.shrinkage, work.values
            kv, vv = work.key_valid(), work.value_valid

        # Static live-object hint: dead arena rows read out zeros, so slicing
        # them off and zero-padding the readout afterwards changes nothing.
        o_full = mv.shape[0]
        vv_full = vv
        n_live = cfg.live_objects
        slice_live = n_live is not None and 0 < n_live <= o_full
        if slice_live:
            mv = mv[:n_live]
            vv = vv[:n_live]
        fused = cfg.fused_read and cfg.top_k <= 32
        n_shards = pcfg.memory_axis_shards if pcfg is not None else 0
        if n_shards > 1:
            # the memory axis split over the ranks of the default group, queries
            # replicated; exact (gathered candidates + summed softmax parts).
            # qe=None and qe=ones differ by a per-query constant, which the
            # top-k and the softmax ignore. No memory-read kernel: a plain call.
            from vosesam_tpu_torch.parallel.memory_shard import sharded_read
            from vosesam_tpu_torch.parallel.mesh import world

            if world()[1] != n_shards:
                raise ValueError(f"memory_axis_shards={n_shards} needs a process group of that "
                                 f"size, not {world()[1]} rank(s)")
            kernels.COUNTS["plain"] += 1
            readout_flat, usage = sharded_read(mk, ms, q, e if e is not None else torch.ones_like(q),
                                               mv, kv[None, :] & vv, cfg.top_k)
        elif slice_live and fused:
            # every valid slot sits below lt_capacity + work.count in the
            # concat layout, so the kernel never reads past it
            live_end = (lt.capacity if cfg.enable_long_term else 0) + work.count
            readout_flat, usage = kernels.fused_memory_read_shared(
                mk, ms, q, e, mv, kv & vv[0], cfg.top_k, return_usage=True,
                live_end=live_end)
        elif fused:
            readout_flat, usage = kernels.fused_memory_read(
                mk, ms, q, e, mv, kv[None, :] & vv, cfg.top_k, return_usage=True)
        else:
            kernels.COUNTS["plain"] += 1
            readout_flat, usage = read_memory_multiobject(
                mk, ms, mv, q, e, kv, vv, cfg.top_k, return_usage=True)
        cv = mv.shape[-1]
        if slice_live and n_live < o_full:
            readout_flat = torch.cat([readout_flat, readout_flat.new_zeros(
                (o_full - n_live,) + tuple(readout_flat.shape[1:]))], 0)
        readout = readout_flat.reshape(o_full, h16, w16, cv)
        # objects with no valid value slot at all read out zeros
        has_mem = vv_full.any(dim=1)
        readout = readout * has_mem[:, None, None, None].to(readout.dtype)

        # usage recording (memory_manager.py:109-119)
        nl = lt.capacity
        work.use_count += usage[nl:] if cfg.enable_long_term else usage
        work.life_count += work.key_valid().float()
        if cfg.enable_long_term and cfg.enable_long_term_count_usage:
            lt.use_count += usage[:nl]
            lt.life_count += lt.key_valid.float()
        return readout, state


def add_memory(
    state: MemoryState,
    key: torch.Tensor,                # (H16, W16, Ck)
    shrinkage: torch.Tensor,          # (H16, W16, 1)
    selection: torch.Tensor,          # (H16, W16, Ck)
    value: torch.Tensor,              # (O, H16, W16, Cv)
    obj_valid: torch.Tensor,          # (O,) bool
    cfg: MemoryConfig,
    hw: int,
) -> MemoryState:
    """Append one frame's tokens; consolidate when the arena is full."""
    if not cfg.enable_long_term and state.work.count + hw > state.work.capacity:
        # the reference grows without bound in this mode; the static arena
        # drops the oldest non-frame-0 chunk instead
        state = _drop_oldest_chunk(state, hw)
    work = state.work
    ck = key.shape[-1]
    o, cv = value.shape[0], value.shape[-1]
    at = work.count
    sl = slice(at, at + hw)
    work.keys[sl] = key.reshape(hw, ck).to(work.keys.dtype)
    work.shrinkage[sl] = shrinkage.reshape(hw).to(work.shrinkage.dtype)
    work.selection[sl] = selection.reshape(hw, ck).to(work.selection.dtype)
    work.values[:, sl] = value.reshape(o, hw, cv).to(work.values.dtype)
    work.value_valid[:, sl] = obj_valid[:, None]
    work.use_count[sl] = 0.0
    work.life_count[sl] = 0.0
    work.count = at + hw
    state.obj_valid = state.obj_valid | obj_valid

    if cfg.enable_long_term and work.count >= work.capacity:
        state = _consolidate(state, cfg, hw)
    return state


def _drop_oldest_chunk(state: MemoryState, hw: int) -> MemoryState:
    """LT-disabled fallback: shift out the oldest post-frame-0 HW chunk."""
    w = state.work

    def shift(a: torch.Tensor, axis: int) -> torch.Tensor:
        head = a.narrow(axis, 0, hw)
        upper = a.narrow(axis, 2 * hw, a.shape[axis] - 2 * hw)
        return torch.cat([head, upper, torch.zeros_like(head)], dim=axis)

    state.work = dataclasses.replace(
        w, keys=shift(w.keys, 0), shrinkage=shift(w.shrinkage, 0),
        selection=shift(w.selection, 0), values=shift(w.values, 1),
        value_valid=shift(w.value_valid, 1), use_count=shift(w.use_count, 0),
        life_count=shift(w.life_count, 0), count=w.count - hw,
    )
    return state


def _masked_softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    s = torch.where(mask[None, :], s, torch.full((), -1e30, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask[None, :], torch.exp(s - m), torch.zeros((), device=s.device))
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def _consolidate(state: MemoryState, cfg: MemoryConfig, hw: int) -> MemoryState:
    """memory_manager.py:211-285 with static windows; see module docstring."""
    with profiling.span("memory.consolidate"):
        work, lt = state.work, state.long
        cw = work.capacity
        min_work = cfg.min_mid_term_frames * hw
        nc = cw - min_work                 # candidate count
        keep_tail = min_work - hw          # recent tokens kept
        p = min(cfg.num_prototypes, nc)    # tiny maps: fewer candidates than P
        o = work.values.shape[0]

        cand = slice(hw, hw + nc)
        cand_keys = work.keys[cand]
        cand_shrink = work.shrinkage[cand]
        cand_sel = work.selection[cand]
        cand_vals = work.values[:, cand]
        cand_vv = work.value_valid[:, cand]

        # prototypes: top-P usage candidates (memory_manager.py:251)
        proto_idx = _top_indices(work.usage()[cand], p)
        proto_keys = cand_keys[proto_idx]
        proto_sel = cand_sel[proto_idx]
        proto_vv = cand_vv[:, proto_idx]

        # potentiation (memory_manager.py:263-284)
        sim = get_similarity(cand_keys, cand_shrink, proto_keys, proto_sel)  # (P, Nc)
        proto_vals = torch.stack([
            _masked_softmax(sim, cand_vv[i]) @ cand_vals[i].float() for i in range(o)])
        aff_full = _masked_softmax(sim, torch.ones(nc, dtype=torch.bool, device=sim.device))
        proto_shrink = aff_full @ cand_shrink.float()

        # overwrite the P least-used LT slots (invalid slots first)
        evict_score = torch.where(lt.key_valid, -lt.usage(),
                                  torch.full((), float("inf"), device=lt.use_count.device))
        slots = _top_indices(evict_score, p)
        lt.keys[slots] = proto_keys.to(lt.keys.dtype)
        lt.shrinkage[slots] = proto_shrink.to(lt.shrinkage.dtype)
        lt.values[:, slots] = proto_vals.to(lt.values.dtype)
        lt.key_valid[slots] = True
        lt.value_valid[:, slots] = proto_vv
        lt.use_count[slots] = 0.0
        lt.life_count[slots] = 0.0

        # compact work memory: [0, hw) + the most recent keep_tail slots
        def compact(a: torch.Tensor, axis: int) -> torch.Tensor:
            head = a.narrow(axis, 0, hw)
            tail = a.narrow(axis, cw - keep_tail, keep_tail)
            pad_shape = list(a.shape)
            pad_shape[axis] = cw - min_work
            return torch.cat([head, tail, a.new_zeros(pad_shape)], dim=axis)

        state.work = dataclasses.replace(
            work, keys=compact(work.keys, 0), shrinkage=compact(work.shrinkage, 0),
            selection=compact(work.selection, 0), values=compact(work.values, 1),
            value_valid=compact(work.value_valid, 1),
            use_count=compact(work.use_count, 0),
            life_count=compact(work.life_count, 0),
            count=min_work,
        )
        return state
