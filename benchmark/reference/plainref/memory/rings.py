"""Static-size memory state for the XMem three-tier memory hierarchy (port of
`vosesam_tpu/memory/rings.py`).

Fixed-capacity arenas with validity masks instead of the reference's
growing concat tensors (tracker/inference/kv_memory_store.py):
  - work memory: tokens are (slot, channel) rows appended contiguously;
    `count` (a host int — adds are HW-sized and scheduled by the host) is the
    number of live slots. Consolidation fires when count reaches capacity;
  - per-(object, slot) `value_valid` replaces the reference's per-group
    temporal extents; keys are shared;
  - use/life counts are fp32 (LFU usage = use / max(life, 1));
  - long-term memory is a fixed arena whose least-used slots are overwritten.
Arena tensors have the compute dtype (`FrameworkConfig.dtype`). The manager
updates them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from plainref.config import MemoryConfig, XMemConfig


@dataclasses.dataclass
class WorkMemory:
    keys: torch.Tensor         # (Cw, Ck)
    shrinkage: torch.Tensor    # (Cw,)
    selection: torch.Tensor    # (Cw, Ck) — kept for consolidation potentiation
    values: torch.Tensor       # (O, Cw, Cv)
    value_valid: torch.Tensor  # (O, Cw) bool
    use_count: torch.Tensor    # (Cw,) fp32
    life_count: torch.Tensor   # (Cw,) fp32
    count: int                 # live slots in [0, Cw]

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def key_valid(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.keys.device) < self.count

    def usage(self) -> torch.Tensor:
        return self.use_count / torch.clamp(self.life_count, min=1.0)


@dataclasses.dataclass
class LongTermMemory:
    keys: torch.Tensor         # (Cl, Ck)
    shrinkage: torch.Tensor    # (Cl,)
    values: torch.Tensor       # (O, Cl, Cv)
    key_valid: torch.Tensor    # (Cl,) bool
    value_valid: torch.Tensor  # (O, Cl) bool
    use_count: torch.Tensor    # (Cl,)
    life_count: torch.Tensor   # (Cl,)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def usage(self) -> torch.Tensor:
        return self.use_count / torch.clamp(self.life_count, min=1.0)


@dataclasses.dataclass
class MemoryState:
    work: WorkMemory
    long: LongTermMemory
    hidden: torch.Tensor       # (O, H16, W16, Ch) sensory memory (GRU state)
    obj_valid: torch.Tensor    # (O,) bool


def _pad_objects(a: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], dim=0)


def grow_objects(mem: MemoryState, o_new: int) -> MemoryState:
    """Widen the object axis to `o_new` slots with invalid (zero/False)
    padding; results for existing objects are unchanged."""
    o = mem.obj_valid.shape[0]
    if o_new <= o:
        return mem
    pad = o_new - o
    return MemoryState(
        work=dataclasses.replace(
            mem.work, values=_pad_objects(mem.work.values, pad),
            value_valid=_pad_objects(mem.work.value_valid, pad)),
        long=dataclasses.replace(
            mem.long, values=_pad_objects(mem.long.values, pad),
            value_valid=_pad_objects(mem.long.value_valid, pad)),
        hidden=_pad_objects(mem.hidden, pad),
        obj_valid=_pad_objects(mem.obj_valid, pad),
    )


def init_memory(
    mem_cfg: MemoryConfig,
    xmem_cfg: XMemConfig,
    hw_shape: Tuple[int, int],
    dtype: torch.dtype = torch.float32,
    device: torch.device = torch.device("cpu"),
) -> MemoryState:
    """Allocate all memory for a video at key-map resolution (H16, W16)."""
    h16, w16 = hw_shape
    hw = h16 * w16
    cw = mem_cfg.work_capacity(hw)
    cl = mem_cfg.max_long_term_elements
    o = xmem_cfg.max_objects
    ck, cv, ch = xmem_cfg.key_dim, xmem_cfg.value_dim, max(xmem_cfg.hidden_dim, 1)
    z = dict(device=device)
    work = WorkMemory(
        keys=torch.zeros((cw, ck), dtype=dtype, **z),
        shrinkage=torch.ones((cw,), dtype=dtype, **z),
        selection=torch.zeros((cw, ck), dtype=dtype, **z),
        values=torch.zeros((o, cw, cv), dtype=dtype, **z),
        value_valid=torch.zeros((o, cw), dtype=torch.bool, **z),
        use_count=torch.zeros((cw,), dtype=torch.float32, **z),
        life_count=torch.zeros((cw,), dtype=torch.float32, **z),
        count=0,
    )
    long = LongTermMemory(
        keys=torch.zeros((cl, ck), dtype=dtype, **z),
        shrinkage=torch.ones((cl,), dtype=dtype, **z),
        values=torch.zeros((o, cl, cv), dtype=dtype, **z),
        key_valid=torch.zeros((cl,), dtype=torch.bool, **z),
        value_valid=torch.zeros((o, cl), dtype=torch.bool, **z),
        use_count=torch.zeros((cl,), dtype=torch.float32, **z),
        life_count=torch.zeros((cl,), dtype=torch.float32, **z),
    )
    return MemoryState(
        work=work,
        long=long,
        hidden=torch.zeros((o, h16, w16, ch), dtype=dtype, **z),
        obj_valid=torch.zeros((o,), dtype=torch.bool, **z),
    )
