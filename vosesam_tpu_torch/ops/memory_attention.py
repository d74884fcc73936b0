"""XMem memory-read attention, plain PyTorch (port of
`vosesam_tpu/ops/memory_attention.py`).

Reference math: tracker/model/memory_util.py:7-80 —
  similarity(q, m) = ms_m * ( -Σ_c e_qc k_mc² + 2 Σ_c e_qc q_qc k_mc
                              - Σ_c e_qc q_qc² ) / sqrt(C_k)
then a top-k sparse softmax over the memory axis and a value readout.

These functions are the plain versions of the fused memory-read kernel
(`ops/kernels/memory_read.py`) and the oracle it is tested against. The
top-k softmax uses the threshold formulation of the JAX package: affinity
is nonzero only where sim >= the k-th largest valid similarity, so ties at
the threshold are all admitted. Layouts are (tokens, channels).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def get_similarity(
    mk: torch.Tensor,                 # (M, Ck) memory keys
    ms: Optional[torch.Tensor],       # (M,) shrinkage (>= 1) or None
    qk: torch.Tensor,                 # (Q, Ck) query keys
    qe: Optional[torch.Tensor],       # (Q, Ck) query selection or None
) -> torch.Tensor:
    """(Q, M) similarity in fp32 (memory_util.py:7-39).

    Full-fp32 matmuls: on the card this needs
    `torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default)."""
    ck = mk.shape[-1]
    mk32 = mk.float()
    qk32 = qk.float()
    if qe is not None:
        qe32 = qe.float()
        a_sq = qe32 @ (mk32 * mk32).T
        ab = (qe32 * qk32) @ mk32.T
        b_sq = torch.sum(qe32 * qk32 * qk32, dim=-1, keepdim=True)
        sim = -a_sq + 2.0 * ab - b_sq
    else:
        a_sq = torch.sum(mk32 * mk32, dim=-1)[None, :]
        ab = qk32 @ mk32.T
        sim = -a_sq + 2.0 * ab  # -b_sq is constant per query; dropped as in ref
    if ms is not None:
        sim = sim * ms.float()[None, :]
    return sim / math.sqrt(ck)


def hierarchical_top_k(sim: torch.Tensor, k: int, chunk: int = 512) -> torch.Tensor:
    """The k largest values over the last axis, descending, computed per
    chunk of `chunk` slots (padded with NEG_INF) and then over the chunks'
    candidates: exact, since the global top-k lies among the per-chunk
    top-ks (port of `vosesam_tpu/ops/memory_attention.py:63`, which does
    this because a full `lax.top_k` over M is slow on a TPU; here it is the
    sharded read's local candidate list)."""
    m = sim.shape[-1]
    k = min(k, m)
    if m <= 2 * chunk:
        return torch.topk(sim, k, dim=-1).values
    pad = (-m) % chunk
    x = sim
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=NEG_INF)
    x = x.reshape(*sim.shape[:-1], -1, chunk)
    cand = torch.topk(x, min(k, chunk), dim=-1).values
    return torch.topk(cand.reshape(*sim.shape[:-1], -1), k, dim=-1).values


def topk_softmax(
    sim: torch.Tensor,                # (Q, M) fp32
    valid: Optional[torch.Tensor],    # (M,) or (Q, M) bool
    top_k: int,
    return_usage: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Top-k sparse softmax over the memory axis (memory_util.py:41-65).

    The k-th largest value (counting duplicates, as `lax.top_k`) is the
    admission threshold. Rows with fewer than k valid slots get a NEG_INF
    threshold, so every valid slot is admitted. Returns (affinity (Q, M)
    fp32, usage (M,) or None)."""
    v = None
    if valid is not None:
        v = valid if valid.ndim == 2 else valid[None, :]
        sim = torch.where(v, sim, torch.full((), NEG_INF, device=sim.device))
    m = sim.shape[-1]
    k = min(top_k, m)
    topv = torch.topk(sim, k, dim=-1).values        # (Q, k) descending
    maxv = topv[:, :1]
    kth = topv[:, -1:]
    mask = sim >= kth
    if v is not None:
        # all-invalid rows: every sim is NEG_INF, so `sim >= kth` alone
        # would spread uniform affinity over invalid slots
        mask = mask & v
    e = torch.where(mask, torch.exp(sim - maxv), torch.zeros((), device=sim.device))
    affinity = e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)
    usage = torch.sum(affinity, dim=0) if return_usage else None
    return affinity, usage


def readout(affinity: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
    """(Q, M) fp32 affinity x (M, Cv) values -> (Q, Cv) fp32."""
    return affinity.float() @ mv.float()


def read_memory_multiobject(
    mk: torch.Tensor,                 # (M, Ck) shared memory keys
    ms: Optional[torch.Tensor],       # (M,)
    mv: torch.Tensor,                 # (O, M, Cv) per-object values
    qk: torch.Tensor,                 # (Q, Ck)
    qe: Optional[torch.Tensor],       # (Q, Ck)
    key_valid: torch.Tensor,          # (M,) bool
    value_valid: torch.Tensor,        # (O, M) bool
    top_k: int,
    return_usage: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-object top-k read over one shared similarity. Returns ((O, Q, Cv)
    readout, (M,) usage summed over objects or None)."""
    sim = get_similarity(mk, ms, qk, qe)
    outs, usage = [], None
    for o in range(mv.shape[0]):
        aff, use = topk_softmax(sim, key_valid & value_valid[o], top_k,
                                return_usage=return_usage)
        outs.append(readout(aff, mv[o]))
        if return_usage:
            # a key slot's usage accumulates over every object that read it
            # (memory_manager.py:109-119)
            usage = use if usage is None else usage + use
    if not outs:
        out = torch.zeros((0, qk.shape[0], mv.shape[-1]), device=mv.device)
        usage = torch.zeros(mk.shape[0], device=mv.device) if return_usage else None
        return out, usage
    return torch.stack(outs), usage
