"""Fused XMem memory read: an exact top-k threshold -> sparse softmax ->
value readout over the (Q, M) similarity, with the per-slot usage
side-output.

Replaces the Pallas TPU kernels of `vosesam_tpu/ops/pallas/memory_read.py`:
  - `fused_memory_read_shared` (:262): one validity row shared by all
    objects (the `MemoryConfig.live_objects` path), usage = column sums x O,
    slots >= `live_end` never read;
  - `fused_memory_read` (:382): one validity row per object, usage summed
    over objects.
Both launch the hand-written CUDA kernel `csrc/memory_read.cu` (its header
says what bounds it on the H100 and what the design does about it). The
input contract is the JAX kernel's: `get_similarity` computes the fp32
(Q, M) matrix once and the kernels stream it (`kernel_inputs` prepares
what they read), so the kernels and the plain versions select their top k
from the same values, for bf16 and fp32 keys alike.

Beside each wrapper is its plain PyTorch version, built from
`ops/memory_attention.py`. A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
`COUNTS` counts kernel launches per wrapper and plain-version calls.

Usage is deterministic (per-tile partial column sums added in a fixed
order, no float atomics); it matches the plain version to fp32 rounding of
the summation order, checked at 1e-4 abs/rel like the readout.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from vosesam_tpu_torch.ops.kernels._autograd import refuse_grad
from vosesam_tpu_torch.ops.memory_attention import (
    get_similarity,
    read_memory_multiobject,
    readout,
    topk_softmax,
)

MAX_TOP_K = 32

# Launches of each kernel wrapper, and calls of the plain versions.
COUNTS: Dict[str, int] = {
    "fused_memory_read_shared": 0,
    "fused_memory_read": 0,
    "plain": 0,
}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _check_top_k(fn: str, top_k: int, m: int) -> int:
    if min(top_k, m) > MAX_TOP_K:
        raise ValueError(f"{fn} supports top_k <= {MAX_TOP_K}; got {top_k}")
    if top_k < 1:
        raise ValueError(f"{fn}: top_k must be >= 1; got {top_k}")
    return min(top_k, m)


# --------------------------------------------------------------- plain versions

def fused_memory_read_shared_plain(
    mk, ms, qk, qe, mv, valid, top_k: int, return_usage: bool = False,
    live_end: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`fused_memory_read_shared` in plain PyTorch: one top-k softmax against
    the shared validity, read out for every object, usage x O. Slots at or
    past `live_end` are masked, which is what the kernel's skip computes."""
    COUNTS["plain"] += 1
    o, m, _ = mv.shape
    _check_top_k("fused_memory_read_shared", top_k, m)
    if live_end is not None:
        valid = valid & (torch.arange(m, device=valid.device) < int(live_end))
    sim = get_similarity(mk, ms, qk, qe)
    aff, use = topk_softmax(sim, valid, top_k, return_usage=return_usage)
    out = torch.stack([readout(aff, mv[i]) for i in range(o)]) if o else \
        torch.zeros((0, qk.shape[0], mv.shape[-1]), device=mv.device)
    return out, (use * float(o) if return_usage else None)


def fused_memory_read_plain(
    mk, ms, qk, qe, mv, valid, top_k: int, return_usage: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`fused_memory_read` in plain PyTorch: `read_memory_multiobject` with
    the combined (O, M) validity."""
    COUNTS["plain"] += 1
    _check_top_k("fused_memory_read", top_k, mv.shape[1])
    key_valid = torch.ones(mk.shape[0], dtype=torch.bool, device=mk.device)
    return read_memory_multiobject(mk, ms, mv, qk, qe, key_valid, valid,
                                   top_k, return_usage=return_usage)


# ------------------------------------------------------------------ the kernel

def _lib() -> ctypes.CDLL:
    from vosesam_tpu_torch.ops.kernels import _build

    lib = _build.load("memory_read")
    fn = lib.vosesam_memory_read
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


OCCUPANCY_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                  "blocks_per_sm", "threads_per_block", "local_bytes")
KERNELS = ("select", "apply", "finish", "usage", "select_2", "apply_2")
ROWS_PER_BLOCK = 16
WARPS = 4      # warps per block: each keeps its own admitted-entry lists
ENTRIES = 16   # admitted entries a (row, warp) list keeps before it is flushed
MAX_SPLITS = 8


def occupancy(kernel: str, mv_dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Registers, shared memory and resident blocks per SM of one of the
    kernels (`KERNELS`; "_2": two validity rows per block, the per-object
    mode) with bf16 or fp32 values, as the card reports them."""
    fn = _lib().vosesam_memory_read_occupancy
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
    info = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    rc = fn(int(mv_dtype == torch.bfloat16), KERNELS.index(kernel), info)
    if rc != 0:
        raise RuntimeError(f"memory_read occupancy query failed: CUDA error {rc}")
    return dict(zip(OCCUPANCY_KEYS, info))


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(torch.device("cuda", index)).multi_processor_count


def _row_groups(r: int, shared: bool) -> int:
    """Blocks along the validity rows: per-object mode puts two in a block."""
    return r if shared or r < 2 else -(-r // 2)


def splits_for(q: int, groups: int, live_end: int, slots: int) -> int:
    """Splits of the memory axis: as many as keep every block in one round of
    the card's `slots` resident blocks (a second, partial round would double
    the time), at most one per 64-slot chunk and at most 8."""
    tiles = -(-q // ROWS_PER_BLOCK) * groups
    chunks = -(-live_end // 64)
    return max(1, min(MAX_SPLITS, chunks, slots // max(tiles, 1)))


@functools.lru_cache(maxsize=None)
def _slots(index: Optional[int], mv_bf16: bool, pair: bool) -> int:
    """Blocks of the select and apply kernels the card keeps resident at once."""
    mv_dtype = torch.bfloat16 if mv_bf16 else torch.float32
    per_sm = min(occupancy(k + ("_2" if pair else ""), mv_dtype)["blocks_per_sm"]
                 for k in ("select", "apply"))
    return max(1, per_sm) * _sm_count(index)


def _check_inputs(fn: str, mk, ms, qk, qe, mv, valid, valid_shape) -> None:
    dev = mv.device
    for name, t in (("mk", mk), ("ms", ms), ("qk", qk), ("qe", qe),
                    ("valid", valid)):
        if t is not None and t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, mv on {dev}")
    if mv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: mv must be float32 or bfloat16, got {mv.dtype}")
    if mv.ndim != 3 or not mv.is_contiguous():
        raise ValueError(f"{fn}: mv must be a contiguous (O, M, Cv) tensor")
    o, m, _ = mv.shape
    if mk.ndim != 2 or mk.shape[0] != m or qk.ndim != 2 or qk.shape[1] != mk.shape[1]:
        raise ValueError(f"{fn}: mk (M, Ck) / qk (Q, Ck) do not match mv {tuple(mv.shape)}")
    if qe is not None and qe.shape != qk.shape:
        raise ValueError(f"{fn}: qe {tuple(qe.shape)} != qk {tuple(qk.shape)}")
    if ms is not None and tuple(ms.shape) != (m,):
        raise ValueError(f"{fn}: ms must be (M,) = ({m},)")
    if valid.dtype != torch.bool or tuple(valid.shape) != valid_shape:
        raise ValueError(f"{fn}: valid must be bool {valid_shape}, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")


def _workspace(dev, parts) -> Dict[str, torch.Tensor]:
    """Views of one uint8 allocation (4-byte types), each part 256-byte aligned."""
    sizes = [4 * math.prod(shape) for _, shape, _ in parts]
    offsets = [sum(-(-n // 256) * 256 for n in sizes[:i]) for i in range(len(sizes))]
    buf = torch.empty((max(offsets[-1] + sizes[-1], 1),), dtype=torch.uint8, device=dev)
    return {name: buf[off:off + n].view(dtype).view(shape)
            for (name, shape, dtype), off, n in zip(parts, offsets, sizes)}


def kernel_inputs(mk, ms, qk, qe, valid_rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernels read besides the values: `get_similarity`'s (Q, M)
    fp32 matrix, contiguous, for every key and query dtype (the same values
    the plain versions select from), and the (R, M) validity rows as uint8."""
    sim = get_similarity(mk, ms, qk, qe).contiguous()
    return sim, valid_rows.contiguous().view(torch.uint8)


def _launch(sim, valid_u8, mv, k: int, live_end: int, shared: bool, usage_scale: float,
            return_usage: bool):
    """Run csrc/memory_read.cu on `kernel_inputs`' (sim, valid_u8); returns
    (out, usage)."""
    o, m, cv = mv.shape
    q = sim.shape[0]
    r = valid_u8.shape[0]
    dev = mv.device
    groups = _row_groups(r, shared)
    slots = _slots(dev.index, mv.dtype == torch.bfloat16, groups < r)
    splits = splits_for(q, groups, live_end, slots)
    n_feat = (o if shared else 1) * cv
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((o, q, cv), **f32)
    usage = torch.empty((m,), **f32) if return_usage else None
    # the scratch in one allocation: split lists; admitted entries per
    # (validity row, split, query, warp) and the readout partials of the
    # lists that overflow them (written only then); usage partials
    i32 = torch.int32
    ws = _workspace(dev, [
        ("lists", (r, q, splits, MAX_TOP_K), torch.float32),
        ("ecount", (r, splits, q, WARPS), i32),
        ("eslot", (r, splits, q, WARPS, ENTRIES), i32),
        ("eaff", (r, splits, q, WARPS, ENTRIES), torch.float32),
        ("rflag", (r, splits, q, WARPS), i32),
        ("upart", (groups * -(-q // ROWS_PER_BLOCK), m), torch.float32),
        ("rpart", (r, splits, q, WARPS, n_feat), torch.float32)])
    lists, ecount, eslot, eaff, rflag, upart, rpart = (
        ws[k] for k in ("lists", "ecount", "eslot", "eaff", "rflag", "upart", "rpart"))
    rc = _lib().vosesam_memory_read(
        sim.data_ptr(), valid_u8.data_ptr(), mv.data_ptr(), int(mv.dtype == torch.bfloat16),
        out.data_ptr(), lists.data_ptr(), ecount.data_ptr(), eslot.data_ptr(), eaff.data_ptr(),
        rpart.data_ptr(), rflag.data_ptr(), upart.data_ptr(),
        usage.data_ptr() if usage is not None else None, q, m, live_end, o, cv, k, r,
        int(shared), splits, float(usage_scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"memory_read kernel launch failed: CUDA error {rc}")
    return out, usage


def fused_memory_read_shared(
    mk: torch.Tensor,                 # (M, Ck)
    ms: Optional[torch.Tensor],       # (M,) shrinkage or None
    qk: torch.Tensor,                 # (Q, Ck)
    qe: Optional[torch.Tensor],       # (Q, Ck) selection or None
    mv: torch.Tensor,                 # (O, M, Cv) — all rows live, one validity
    valid: torch.Tensor,              # (M,) bool — shared slot validity
    top_k: int,
    return_usage: bool = False,
    live_end: Optional[int] = None,   # all valid slots are < live_end
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Shared-validity fused read. Returns ((O, Q, Cv) fp32 readout, (M,)
    usage summed over objects, or None). `live_end` (a host int) promises
    that no slot at or past it is valid; the kernel never reads them."""
    if mv.device.type == "cpu":
        return fused_memory_read_shared_plain(
            mk, ms, qk, qe, mv, valid, top_k, return_usage, live_end)
    o, m, _ = mv.shape
    k = _check_top_k("fused_memory_read_shared", top_k, m)
    _check_inputs("fused_memory_read_shared", mk, ms, qk, qe, mv, valid, (m,))
    refuse_grad("fused_memory_read_shared", mk, ms, qk, qe, mv)
    live = m if live_end is None else max(0, min(int(live_end), m))
    if m == 0:
        usage = torch.zeros((0,), device=mv.device) if return_usage else None
        return torch.zeros((o, qk.shape[0], mv.shape[-1]), device=mv.device), usage
    out, usage = _launch(*kernel_inputs(mk, ms, qk, qe, valid[None]), mv, k, live, True,
                         float(o), return_usage)
    COUNTS["fused_memory_read_shared"] += 1
    return out, usage


def fused_memory_read(
    mk: torch.Tensor,                 # (M, Ck)
    ms: Optional[torch.Tensor],       # (M,) shrinkage or None
    qk: torch.Tensor,                 # (Q, Ck)
    qe: Optional[torch.Tensor],       # (Q, Ck) selection or None
    mv: torch.Tensor,                 # (O, M, Cv)
    valid: torch.Tensor,              # (O, M) bool — key & value validity
    top_k: int,
    return_usage: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-object fused read. Returns ((O, Q, Cv) fp32 readout, (M,) usage
    summed over objects, or None)."""
    if mv.device.type == "cpu":
        return fused_memory_read_plain(mk, ms, qk, qe, mv, valid, top_k, return_usage)
    o, m, _ = mv.shape
    k = _check_top_k("fused_memory_read", top_k, m)
    _check_inputs("fused_memory_read", mk, ms, qk, qe, mv, valid, (o, m))
    refuse_grad("fused_memory_read", mk, ms, qk, qe, mv)
    if m == 0 or o == 0:
        usage = torch.zeros((m,), device=mv.device) if return_usage else None
        return torch.zeros((o, qk.shape[0], mv.shape[-1]), device=mv.device), usage
    out, usage = _launch(*kernel_inputs(mk, ms, qk, qe, valid), mv, k, m, False, 1.0,
                         return_usage)
    COUNTS["fused_memory_read"] += 1
    return out, usage
