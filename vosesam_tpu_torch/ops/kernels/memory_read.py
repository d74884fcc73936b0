"""Fused XMem memory read: the similarity, an exact top-k threshold ->
sparse softmax -> value readout, with the per-slot usage side-output.

Replaces the Pallas TPU kernels of `vosesam_tpu/ops/pallas/memory_read.py`:
  - `fused_memory_read_shared` (:262): one validity row shared by all
    objects (the `MemoryConfig.live_objects` path), usage = column sums x O,
    slots >= `live_end` never read;
  - `fused_memory_read` (:382): one validity row per object, usage summed
    over objects.
Both launch the hand-written CUDA kernel `csrc/memory_read.cu` (its header
says what bounds it on the H100 and what the design does about it). The
kernel computes the (Q, M) similarity itself, tile by tile, so it never
reaches device memory: the wrapper prepares only the query-side operands
(`similarity_operands`: for bf16 keys, qe * qk split exactly into bf16 hi +
lo parts for the tensor cores) and the kernel splits mk^2 the same way
(`square_split` is its torch form).

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
from typing import Dict, NamedTuple, Optional, Tuple

import torch

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


# ------------------------------------------------ the kernel's operands

class SimilarityOperands(NamedTuple):
    """What the kernels rebuild the similarity from:
    sim = (a . b_m + rb) * cs / sqrt(Ck), b_m = [sq_hi, sq_lo, mk, mk] with
    sq_hi + sq_lo = mk^2 (`square_split`)."""
    a: torch.Tensor             # (Q, 4 Ck) bf16: [-qe, -qe, 2 p_hi, 2 p_lo]
    rb: torch.Tensor            # (Q,) fp32 row term, -sum(qe qk^2) or 0
    cs: Optional[torch.Tensor]  # (M,) fp32 shrinkage or None
    mk: torch.Tensor            # (M, Ck) contiguous bf16 keys


def bf16_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 x -> bf16 (hi, lo) with hi = bf16(x), lo = bf16(x - hi). Exact
    (hi + lo == x) when x has at most 16 significant bits, as a product of
    two bf16 values has."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def square_split(mk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mk^2 of bf16 keys as bf16 (hi, lo): the split the kernel makes as each
    chunk of keys arrives in shared memory."""
    sq = mk.float() * mk.float()
    return bf16_split(sq)


def similarity_operands(mk, ms, qk, qe) -> SimilarityOperands:
    """The torch form of the operands the kernels build for bf16 keys and
    queries with Ck in {16, 32, 48, 64} (the main path): every product of
    a . b_m is exact in fp32, so the similarity equals `get_similarity` up
    to fp32 summation order. Other inputs are not tensor-core inputs: the
    kernels then take `get_similarity`'s similarity."""
    if not _tensor_cores(mk, qk, qe):
        raise ValueError("similarity_operands: bf16 keys and queries with Ck in "
                         "{16, 32, 48, 64} only")
    e32 = qe.float() if qe is not None else None
    q32 = qk.float()
    if qe is not None:
        p = e32 * q32                                   # exact for bf16 inputs
        rb = -torch.sum(e32 * q32 * q32, dim=-1)        # -b_sq, as get_similarity
        p_hi, p_lo = bf16_split(p)
        a = torch.cat([-qe, -qe, 2 * p_hi, 2 * p_lo], dim=1)
    else:
        rb = torch.zeros(qk.shape[0], dtype=torch.float32, device=qk.device)
        ones = torch.ones_like(qk)
        a = torch.cat([-ones, -ones, 2 * qk, torch.zeros_like(qk)], dim=1)
    cs = ms.float().contiguous() if ms is not None else None
    return SimilarityOperands(a.contiguous(), rb.contiguous(), cs, mk.contiguous())


def similarity_from_operands(ops: SimilarityOperands) -> torch.Tensor:
    """The (Q, M) similarity the kernel computes from `ops`, in fp32
    matmuls (its order of summation aside)."""
    mk = ops.mk.float()
    hi, lo = square_split(ops.mk)
    b = torch.cat([hi.float(), lo.float(), mk, mk], dim=1)
    sim = ops.a.float() @ b.T + ops.rb[:, None]
    if ops.cs is not None:
        sim = sim * ops.cs[None, :]
    return sim / math.sqrt(mk.shape[-1])


# ------------------------------------------------------------------ the kernel

def _lib() -> ctypes.CDLL:
    from vosesam_tpu_torch.ops.kernels import _build

    lib = _build.load("memory_read")
    fn = lib.vosesam_memory_read
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, p, p, i, p, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


OCCUPANCY_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                  "blocks_per_sm", "threads_per_block", "local_bytes")
KERNELS = ("select", "apply", "finish", "usage", "select_2", "apply_2")
ROWS_PER_BLOCK = 16
WARPS = 4      # warps per block: each keeps its own admitted-entry lists
ENTRIES = 16   # admitted entries a (row, warp) list keeps before it is flushed
MAX_SPLITS = 8


def occupancy(kernel: str, tensor_cores: bool = True, ck: int = 64,
              mv_dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Registers, shared memory and resident blocks per SM of one of the
    kernels (`KERNELS`; select / apply at the instance the arguments pick,
    "_2": two validity rows per block, the per-object mode), as the card
    reports them."""
    fn = _lib().vosesam_memory_read_occupancy
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
    info = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    rc = fn(int(tensor_cores), ck, int(mv_dtype == torch.bfloat16), KERNELS.index(kernel), info)
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
def _slots(index: Optional[int], tensor_cores: bool, ck: int, mv_bf16: bool, pair: bool) -> int:
    """Blocks of the select and apply kernels the card keeps resident at once."""
    mv_dtype = torch.bfloat16 if mv_bf16 else torch.float32
    per_sm = min(occupancy(k + ("_2" if pair else ""), tensor_cores, ck, mv_dtype)["blocks_per_sm"]
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


def _tensor_cores(mk, qk, qe) -> bool:
    bf16 = torch.bfloat16
    ck = mk.shape[-1]
    return (mk.dtype == bf16 and qk.dtype == bf16 and (qe is None or qe.dtype == bf16)
            and ck % 16 == 0 and ck <= 64)


def _workspace(dev, parts) -> Dict[str, torch.Tensor]:
    """Views of one uint8 allocation (4-byte types), each part 256-byte aligned."""
    sizes = [4 * math.prod(shape) for _, shape, _ in parts]
    offsets = [sum(-(-n // 256) * 256 for n in sizes[:i]) for i in range(len(sizes))]
    buf = torch.empty((max(offsets[-1] + sizes[-1], 1),), dtype=torch.uint8, device=dev)
    return {name: buf[off:off + n].view(dtype).view(shape)
            for (name, shape, dtype), off, n in zip(parts, offsets, sizes)}


def _launch(mk, ms, qk, qe, valid_rows, mv, k: int, live_end: int, shared: bool,
            usage_scale: float, return_usage: bool):
    """Run csrc/memory_read.cu; returns (out, usage). With bf16 keys the
    kernels build the operands of `similarity_operands` themselves from qk /
    qe / mk; other inputs (the fp32 checks) hand them `get_similarity`'s
    similarity, so that the kernels and the plain chain select from the same
    values."""
    o, m, cv = mv.shape
    q = qk.shape[0]
    r = valid_rows.shape[0]
    dev = mv.device
    tc = _tensor_cores(mk, qk, qe)
    sim = None
    if tc:
        mk, qk = mk.contiguous(), qk.contiguous()
        qe = qe.contiguous() if qe is not None else None
        if mk.data_ptr() % 16:                 # the kernel's 16-byte copies
            mk = mk.clone()
    else:
        sim = get_similarity(mk, ms, qk, qe).contiguous()
    cs = ms.float().contiguous() if ms is not None and tc else None
    groups = _row_groups(r, shared)
    slots = _slots(dev.index, tc, mk.shape[1], mv.dtype == torch.bfloat16, groups < r)
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
    valid_u8 = valid_rows.contiguous().view(torch.uint8)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    rc = _lib().vosesam_memory_read(
        qk.data_ptr(), ptr(qe), mk.data_ptr(), ptr(sim), ptr(cs), int(tc),
        valid_u8.data_ptr(), mv.data_ptr(), int(mv.dtype == torch.bfloat16),
        out.data_ptr(), lists.data_ptr(), ecount.data_ptr(), eslot.data_ptr(), eaff.data_ptr(),
        rpart.data_ptr(), rflag.data_ptr(),
        upart.data_ptr(), ptr(usage), q, m, mk.shape[1], live_end, o, cv, k, r, int(shared),
        splits, float(usage_scale), torch.cuda.current_stream(dev).cuda_stream,
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
    live = m if live_end is None else max(0, min(int(live_end), m))
    if m == 0:
        usage = torch.zeros((0,), device=mv.device) if return_usage else None
        return torch.zeros((o, qk.shape[0], mv.shape[-1]), device=mv.device), usage
    out, usage = _launch(mk, ms, qk, qe, valid[None], mv, k, live, True, float(o),
                         return_usage)
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
    if m == 0 or o == 0:
        usage = torch.zeros((m,), device=mv.device) if return_usage else None
        return torch.zeros((o, qk.shape[0], mv.shape[-1]), device=mv.device), usage
    out, usage = _launch(mk, ms, qk, qe, valid, mv, k, m, False, 1.0, return_usage)
    COUNTS["fused_memory_read"] += 1
    return out, usage
