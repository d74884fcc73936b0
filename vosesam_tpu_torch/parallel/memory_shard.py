"""The memory-axis-sharded XMem read (port of
`vosesam_tpu/parallel/memory_shard.py`).

For memories beyond one card or very long rollouts, the LT + work memory
tokens are split over the ranks of a process group, queries replicated:

  1. each rank computes `get_similarity` against its slice of the memory;
  2. its exact top-k candidate values (k per query) are all-gathered and
     reduced to the exact global k-th value and maximum: the global top-k
     lies among the ranks' top-ks, so the read is exact, not approximate;
  3. each rank computes its masked-exp numerator and denominator, and one
     all-reduce (SUM) gives the softmax readout on every rank;
  4. usage is computed for the local slice; `sharded_read` all-gathers it
     back to the full (M,), as JAX's `out_specs=P(axis)` reassembles it.

Per read: an all-gather of (O, Q, k) fp32 and an all-reduce of (O, Q, Cv + 1),
independent of M. The plain chain (no memory-read kernel) runs on each
slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from vosesam_tpu_torch.ops.memory_attention import NEG_INF, get_similarity, hierarchical_top_k


def _group_size(group) -> int:
    """The group's size; 0 without a process group (no collective runs)."""
    return dist.get_world_size(group) if dist.is_initialized() else 0


def sharded_memory_read_local(
    mk: torch.Tensor,                 # (M_local, Ck) this rank's keys
    ms: Optional[torch.Tensor],       # (M_local,)
    qk: torch.Tensor,                 # (Q, Ck) replicated queries
    qe: Optional[torch.Tensor],       # (Q, Ck)
    mv: torch.Tensor,                 # (O, M_local, Cv)
    valid: torch.Tensor,              # (O, M_local) bool
    top_k: int,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The read over `group` (default: the default group; without a process
    group, this process alone and no collective). Returns ((O, Q, Cv) fp32
    readout, the same on every rank, and this rank's (M_local,) usage summed
    over objects)."""
    sim = get_similarity(mk, ms, qk, qe)                                  # (Q, M_local)
    s = torch.where(valid[:, None, :], sim[None], torch.full((), NEG_INF, device=sim.device))
    local_top = hierarchical_top_k(s, min(top_k, s.shape[-1]))            # (O, Q, k)
    n = _group_size(group)
    if n:
        parts = [torch.empty_like(local_top) for _ in range(n)]
        dist.all_gather(parts, local_top.contiguous(), group=group)
        cand = torch.cat(parts, dim=-1)                                   # (O, Q, n k)
    else:
        cand = local_top
    k = min(top_k, cand.shape[-1])
    topv = torch.topk(cand, k, dim=-1).values
    kth, maxv = topv[..., -1:], topv[..., :1]
    e = torch.where((s >= kth) & valid[:, None, :], torch.exp(s - maxv),
                    torch.zeros((), device=s.device))                     # (O, Q, M_local)
    num = torch.matmul(e, mv.float())                                     # (O, Q, Cv)
    den = e.sum(-1, keepdim=True)                                         # (O, Q, 1)
    if n:
        both = torch.cat([num, den], dim=-1)
        dist.all_reduce(both, group=group)
        num, den = both[..., :-1], both[..., -1:]
    den = torch.clamp(den, min=1e-30)
    usage = (e / den).sum(dim=1).sum(dim=0)                               # (M_local,)
    return num / den, usage


def sharded_read(mk, ms, qk, qe, mv, valid, top_k: int, group=None):
    """The same read from the FULL (replicated) memory: each rank takes its
    contiguous 1 / n of the memory axis (M must divide by the group's size),
    and the usage comes back as the full (M,) on every rank. Returns
    ((O, Q, Cv) readout, (M,) usage)."""
    n = _group_size(group)
    m = mk.shape[0]
    if m % max(n, 1):
        raise ValueError(f"memory capacity {m} not divisible by the {n} shards")
    r = dist.get_rank(group) if n else 0
    part = m // max(n, 1)
    sl = slice(r * part, (r + 1) * part)
    out, usage = sharded_memory_read_local(
        mk[sl], None if ms is None else ms[sl], qk, qe, mv[:, sl], valid[:, sl], top_k, group)
    if n:
        parts = [torch.empty_like(usage) for _ in range(n)]
        dist.all_gather(parts, usage.contiguous(), group=group)
        usage = torch.cat(parts)
    return out, usage


def make_sharded_read(top_k: int, group=None):
    """`sharded_read` bound to `top_k` and `group`: fn(mk, ms, qk, qe, mv,
    valid) -> (readout, usage), the counterpart of JAX's jitted shard_map."""
    def read(mk, ms, qk, qe, mv, valid):
        return sharded_read(mk, ms, qk, qe, mv, valid, top_k, group)

    return read
