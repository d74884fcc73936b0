"""Process groups for multi-device runs (port of `vosesam_tpu/parallel/mesh.py`).

One process per rank, the PyTorch idiom. Every rank runs the same program
on the same host inputs, as the JAX package's multi-host path assumes; the
ranks are laid out as a data x model grid with the JAX function's shape
rule. The `data` axis carries whole videos, inpaint windows and training
clips; the `model` axis is laid out (so `--mesh DPxMP` places ranks as JAX
places devices) but left replicated, as JAX's batched step leaves it:
tensor parallelism of the SAM encoder is ROADMAP A13b.

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
                     timeout_s: float = TIMEOUT_S) -> Tuple[int, int]:
    """Join (or, alone, open) the default process group; returns (rank,
    world size). `coordinator_address` is a `tcp://host:port` or `file://`
    URL (a bare `host:port` means tcp); without one the group comes from
    torchrun's environment (RANK / WORLD_SIZE / MASTER_ADDR) where it is
    set, else it is a group of one process over a rendezvous file in a
    fresh temporary directory. On `cuda` each process takes the card of its
    local rank."""
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
    of `devices`, as JAX's `make_mesh` reshapes its device list. `data_group`
    joins the ranks of this rank's model index (the ranks that split the
    data); None without a process group (the collectives then return their
    input). The model axis is laid out but has no group: nothing uses it
    until tensor parallelism (ROADMAP A13b)."""

    devices: np.ndarray                  # (data, model) ranks
    axis_names: Tuple[str, str]
    rank: int
    data_group: Any = None

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.devices.shape)

    @property
    def data_size(self) -> int:
        return self.devices.shape[0]

    @property
    def data_index(self) -> int:
        """This rank's row of the grid (0 for a rank outside it)."""
        hit = np.argwhere(self.devices == self.rank)
        return int(hit[0][0]) if len(hit) else 0


def make_mesh(cfg: ParallelConfig, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Lay `ranks` (default: every rank of the default group, or this one
    process) out as (data, model) with the JAX function's rule: model =
    max(1, model_parallel), data = data_parallel where positive, else
    ranks // model; ValueError where data x model != the rank count. The
    data groups are made (every rank of the default group must call this)
    when a process group is open and the layout covers it (a group of one
    rank too: its collectives still run, through the backend)."""
    rank, size = world()
    ranks = list(range(size)) if ranks is None else list(ranks)
    n = len(ranks)
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    grid = np.asarray(ranks).reshape(dp, mp)
    data_group = None
    if dist.is_initialized() and sorted(ranks) == list(range(size)):
        for m in range(mp):          # every rank makes every group, in one order
            grp = dist.group.WORLD if mp == 1 else dist.new_group(grid[:, m].tolist())
            if rank in grid[:, m]:
                data_group = grp
    return Mesh(grid, (cfg.data_axis, cfg.model_axis), rank, data_group)


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
    """Tensor-parallel SAM encoder over the model axis: not ported."""
    raise NotImplementedError(
        "shard_sam_params_tp: tensor parallelism of the SAM encoder over the model axis "
        "(qkv / MLP hidden split, heads over the model group through B3) is ROADMAP A13b, "
        "not ported yet")


# ---------------------------------------------------------------- launcher

def _rank_main(rank: int, fn: Callable, world_size: int, url: str, device: str,
               threads: Optional[int], out_dir: str, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    init_distributed(url, world_size, rank, device=device)
    try:
        result = fn(*args)
    finally:
        destroy()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world_size: int, *args, device: DeviceLike = None,
              timeout_s: float = TIMEOUT_S, threads: Optional[int] = None) -> list:
    """Run `fn(*args)` in `world_size` new local processes, ranks 0..n-1 of one
    group (NCCL on `cuda`, one card per rank; gloo on `cpu`) that meets
    through a `file://` rendezvous in a temporary directory. Returns the
    ranks' results in rank order. `fn` must be importable by name (the
    processes are spawned); a rank that fails, or a run past `timeout_s`,
    stops every rank and raises."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="vosesam-ranks-")
    try:
        url = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = mp.spawn(_rank_main, args=(fn, world_size, url, dev.type, threads, tmp, args),
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
