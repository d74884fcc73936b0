"""Tracing and profiling utilities (port of `vosesam_tpu/utils/profiling.py`).

  - `StageTimer`: per-stage wall timing with a device sync at each stage's
    exit, on the result the stage recorded;
  - `trace()`: a `torch.profiler` context (CPU and CUDA activities) that
    writes a Chrome trace TensorBoard or Perfetto opens;
  - `device_memory_stats()`: live / peak device bytes from the CUDA
    caching allocator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


def _last_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in reversed(tree):
            found = _last_tensor(leaf)
            if found is not None:
                return found
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return _last_tensor([getattr(tree, f.name) for f in dataclasses.fields(tree)])
    return None


def sync(tree) -> None:
    """Wait for the work feeding `tree` (a tensor, or dicts, lists, tuples
    and dataclasses of them): synchronise the device of its last tensor (a
    CUDA device; a CPU tensor is ready when it exists)."""
    t = _last_tensor(tree)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class StageTimer:
    """Accumulates per-stage latencies across frames.

    Usage:
        timer = StageTimer()
        with timer.stage("xmem"):
            out = step(...)
            timer.record(out)      # synced on exit
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._last_result = None

    @contextlib.contextmanager
    def stage(self, name: str, result=None) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._last_result is not None:
                sync(self._last_result)
                self._last_result = None
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def record(self, result) -> None:
        """Register the stage's output so the timer can sync on it (a
        disabled timer keeps nothing)."""
        if self.enabled:
            self._last_result = result

    def summary(self) -> Dict[str, float]:
        """ms per entry of each stage."""
        return {k: self.totals[k] / max(self.counts[k], 1) * 1e3 for k in self.totals}

    def report(self) -> str:
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1])
        total = sum(v for _, v in rows)
        lines = [f"{k:>24s}: {v:8.2f} ms/frame" for k, v in rows]
        lines.append(f"{'TOTAL':>24s}: {total:8.2f} ms/frame")
        return "\n".join(lines)

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """torch.profiler trace of the block (CPU and, where there is a card,
    CUDA activities), written to `logdir/trace.json` on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats() -> Optional[Dict[str, int]]:
    """Live / peak bytes of the CUDA caching allocator and the card's size
    (the counterpart of `torch.cuda.max_memory_allocated`,
    base_tracker.py:210); None without a card, as the JAX function returns
    on a backend without statistics."""
    if not torch.cuda.is_available():
        return None
    dev = torch.cuda.current_device()
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
    }
