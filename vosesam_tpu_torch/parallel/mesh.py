"""Process groups for multi-device runs (port of `vosesam_tpu/parallel/mesh.py`).

One process per rank, the PyTorch idiom. Every rank runs the same program
on the same host inputs, as the JAX package's multi-host path assumes; the
ranks are laid out as a data x model grid with the JAX function's shape
rule. The `data` axis carries whole videos, inpaint windows and training
clips. The `model` axis carries the SAM encoder's tensor parallelism
(`shard_sam_params_tp`), which no entry point turns on: `--mesh DPxMP`
places ranks as JAX places devices and leaves the parameters replicated,
as JAX's batched step does.

Backends follow the device: NCCL for `cuda`, gloo for `cpu`. There is no
fallback from one to the other: a failed `init_process_group` raises, and
every group gets a timeout so that a lost rank fails the run instead of
hanging it. `run_ranks` starts `world` local processes through
`torch.multiprocessing.spawn` with a `file://` rendezvous (the CPU tests,
and a box with several cards); `torchrun` works too, through its
environment variables.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vosesam_tpu_torch.config import ParallelConfig
from vosesam_tpu_torch.device import DeviceLike, resolve_device

TIMEOUT_S = 120.0      # every collective of a group, and run_ranks' default deadline


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: DeviceLike = None,
                     timeout_s: float = TIMEOUT_S,
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Join (or, alone, open) the default process group; returns (rank,
    world size). `coordinator_address` is a `tcp://host:port` or `file://`
    URL (a bare `host:port` means tcp); without one the group comes from
    torchrun's environment (RANK / WORLD_SIZE / MASTER_ADDR) where it is
    set, else it is a group of one process over a rendezvous file in a
    fresh temporary directory. `backend` defaults to NCCL on `cuda` (each
    process takes the card of its local rank) and gloo on `cpu`; gloo on
    `cuda` lets several processes share one card (NCCL refuses two ranks on
    one device)."""
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    kwargs = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed: a coordinator address needs num_processes "
                             "and process_id")
        kwargs.update(init_method=url, world_size=num_processes, rank=process_id)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kwargs.update(init_method="env://")
    else:
        tmp = tempfile.mkdtemp(prefix="vosesam-pg-")
        atexit.register(shutil.rmtree, tmp, True)
        kwargs.update(init_method=f"file://{os.path.join(tmp, 'rendezvous')}", world_size=1,
                      rank=0)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0) or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kwargs)
    return dist.get_rank(), dist.get_world_size()


def ensure_distributed(device: DeviceLike = None) -> Tuple[int, int]:
    """The default group, opened by `init_distributed` when none is open yet:
    what the entry points' `--batch` / `--dp` use, inside `owned_group`."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return init_distributed(device=device)


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def owned_group():
    """Close, on leaving the block, a default process group that was opened
    inside it (a group open before is left to its owner)."""
    was_open = dist.is_initialized()
    try:
        yield
    finally:
        if not was_open:
            destroy()


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_writer() -> bool:
    """Whether this rank writes files: rank 0, or a process without a group."""
    return world()[0] == 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A data x model layout of ranks: rank r sits at (r // model, r % model)
    of `devices`, as JAX's `make_mesh` reshapes its device list.
    `data_group` joins the ranks of this rank's model index (the ranks that
    split the data), `model_group` the ranks of its data index (the ranks
    that split one encoder's heads); each is None without a process group
    (the collectives then return their input)."""

    devices: np.ndarray                  # (data, model) ranks
    axis_names: Tuple[str, str]
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.devices.shape)

    @property
    def data_size(self) -> int:
        return self.devices.shape[0]

    @property
    def model_size(self) -> int:
        return self.devices.shape[1]

    def _cell(self) -> Tuple[int, int]:
        hit = np.argwhere(self.devices == self.rank)
        return (int(hit[0][0]), int(hit[0][1])) if len(hit) else (0, 0)

    @property
    def data_index(self) -> int:
        """This rank's row of the grid (0 for a rank outside it)."""
        return self._cell()[0]

    @property
    def model_index(self) -> int:
        """This rank's column of the grid (0 for a rank outside it)."""
        return self._cell()[1]


def make_mesh(cfg: ParallelConfig, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Lay `ranks` (default: every rank of the default group, or this one
    process) out as (data, model) with the JAX function's rule: model =
    max(1, model_parallel), data = data_parallel where positive, else
    ranks // model; ValueError where data x model != the rank count. The
    groups are made (every rank of the default group must call this) when a
    process group is open and the layout covers it (a group of one rank
    too: its collectives still run, through the backend): the data groups
    (one per model index) first, then the model groups (one per data
    index), in one order on every rank."""
    rank, size = world()
    ranks = list(range(size)) if ranks is None else list(ranks)
    n = len(ranks)
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    grid = np.asarray(ranks).reshape(dp, mp)
    data_group = model_group = None
    if dist.is_initialized() and sorted(ranks) == list(range(size)):
        for m in range(mp):
            grp = dist.group.WORLD if mp == 1 else dist.new_group(grid[:, m].tolist())
            if rank in grid[:, m]:
                data_group = grp
        for d in range(dp):
            grp = dist.group.WORLD if dp == 1 else dist.new_group(grid[d, :].tolist())
            if rank in grid[d, :]:
                model_group = grp
    return Mesh(grid, (cfg.data_axis, cfg.model_axis), rank, data_group, model_group)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: Mesh):
    """This rank's slice of the leading (batch) axis of every tensor or
    array in `tree`: row `data_index` of `data_size` equal slices."""
    dp, d = mesh.data_size, mesh.data_index

    def local(x):
        n = x.shape[0]
        if n % dp:
            raise ValueError(f"batch {n} does not divide over the {dp}-way data axis")
        k = n // dp
        return x[d * k:(d + 1) * k]

    return _tree_map(local, tree)


def replicated(tree, mesh: Mesh):
    """`tree` with every tensor replaced by rank `devices[0, 0]`'s copy
    (a broadcast over the default group): the same values on every rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    src = int(mesh.devices.flat[0])

    def bcast(x):
        if isinstance(x, torch.Tensor):
            x = x.clone()
            dist.broadcast(x, src)
        return x

    return _tree_map(bcast, tree)


def all_gather_data(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every data index's `t` (equal shapes), in data order."""
    if mesh.data_group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(mesh.data_size)]
    dist.all_gather(out, t.contiguous(), group=mesh.data_group)
    return out


def all_gather_data_object(obj, mesh: Mesh) -> list:
    """Every data index's picklable `obj`, in data order."""
    if mesh.data_group is None:
        return [obj]
    out = [None] * mesh.data_size
    dist.all_gather_object(out, obj, group=mesh.data_group)
    return out


def shard_sam_params_tp(sam, mesh: Mesh, cfg: ParallelConfig):
    """Megatron-style tensor parallelism of the SAM image encoder over the
    mesh's model axis (`vosesam_tpu/parallel/mesh.py:shard_sam_params_tp`).
    Returns a SAM whose encoder holds this rank's slices; every other
    tensor (patch embed, position embed, norms, rel-pos tables, the neck,
    the prompt encoder and the mask decoder) is the input's own, shared.

    Rank m of the model group takes heads [m·H/mp, (m+1)·H/mp): the q, k and
    v rows of those heads of each qkv projection (column parallel by heads,
    since the projection's output is laid out (3, heads, hd)) and the same
    columns of proj (row parallel); lin1's rows and lin2's columns over the
    m-th contiguous slice of the MLP's hidden width. Each row-parallel
    product is summed over the model group by one all-reduce, its bias
    added once after it (`models/sam/image_encoder.py`). At model size 1
    the input comes back as it is. `cfg` is the layout the mesh was made
    from (its axis names), as in JAX."""
    mp, m = mesh.model_size, mesh.model_index
    if cfg.model_axis != mesh.axis_names[1]:
        raise ValueError(f"shard_sam_params_tp: the mesh's model axis is "
                         f"{mesh.axis_names[1]!r}, not {cfg.model_axis!r}")
    if mp == 1:
        return sam
    blocks = sam.image_encoder.blocks
    heads, hidden = blocks[0].attn.heads, blocks[0].mlp.lin1.out_features
    if heads % mp or hidden % mp:
        raise ValueError(f"shard_sam_params_tp: {heads} heads / MLP width {hidden} do "
                         f"not divide over the {mp}-way model axis")
    if mesh.model_group is None:
        raise ValueError("shard_sam_params_tp: the mesh's model axis has no process group")
    hl, fl = heads // mp, hidden // mp

    def part(t: torch.Tensor) -> torch.nn.Parameter:
        return torch.nn.Parameter(t.detach().contiguous().clone(), requires_grad=False)

    # deepcopy with a memo: the sharded weights map to their slices, every
    # other tensor to itself, so only module objects are copied
    memo = {id(t): t for t in list(sam.parameters()) + list(sam.buffers())}
    for blk in blocks:
        a, f = blk.attn, blk.mlp
        c = a.qkv.in_features
        hd = c // heads
        qkv_w = a.qkv.weight.reshape(3, heads, hd, c)[:, m * hl:(m + 1) * hl]
        qkv_b = a.qkv.bias.reshape(3, heads, hd)[:, m * hl:(m + 1) * hl]
        memo[id(a.qkv.weight)] = part(qkv_w.reshape(3 * hl * hd, c))
        memo[id(a.qkv.bias)] = part(qkv_b.reshape(3 * hl * hd))
        memo[id(a.proj.weight)] = part(a.proj.weight[:, m * hl * hd:(m + 1) * hl * hd])
        memo[id(f.lin1.weight)] = part(f.lin1.weight[m * fl:(m + 1) * fl])
        memo[id(f.lin1.bias)] = part(f.lin1.bias[m * fl:(m + 1) * fl])
        memo[id(f.lin2.weight)] = part(f.lin2.weight[:, m * fl:(m + 1) * fl])
    out = copy.deepcopy(sam, memo)
    for blk in out.image_encoder.blocks:
        blk.attn.heads = hl
        blk.attn.tp_group = blk.mlp.tp_group = mesh.model_group
        for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.lin1, blk.mlp.lin2):
            lin.out_features, lin.in_features = lin.weight.shape
    return out


# ---------------------------------------------------------------- launcher

def _rank_main(rank: int, fn: Callable, world_size: int, url: str, device: str,
               backend: Optional[str], threads: Optional[int], out_dir: str,
               args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    # the ranks are local processes: gloo meets over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    init_distributed(url, world_size, rank, device=device, backend=backend)
    try:
        result = fn(*args)
    finally:
        destroy()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world_size: int, *args, device: DeviceLike = None,
              timeout_s: float = TIMEOUT_S, threads: Optional[int] = None,
              backend: Optional[str] = None) -> list:
    """Run `fn(*args)` in `world_size` new local processes, ranks 0..n-1 of one
    group that meets through a `file://` rendezvous in a temporary
    directory: NCCL on `cuda`, one card per rank, and gloo on `cpu`, unless
    `backend` says otherwise (gloo on `cuda`: every rank on the current
    card). Returns the ranks' results in rank order. `fn` must be
    importable by name (the processes are spawned); a rank that fails, or a
    run past `timeout_s`, stops every rank and raises."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="vosesam-ranks-")
    try:
        url = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = mp.spawn(_rank_main, args=(fn, world_size, url, dev.type, backend, threads, tmp,
                                         args),
                       nprocs=world_size, join=False)
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(0.1, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(5)
                raise TimeoutError(f"run_ranks: {world_size} ranks of {fn.__name__} still "
                                   f"running after {timeout_s} s")
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
