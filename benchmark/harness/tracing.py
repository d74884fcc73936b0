"""The traced run: `torch.profiler.record_function` ranges around the
program's layer entry points (listed in `layers/<layer>.json`, wrapped from
the benchmark's files), the profiler over a stretch of the window, and the
reading of its trace into a `TraceView` that the per-layer metrics read.

A range's device time is the device time of the operations launched while
it was open on the host (matched through the trace's correlation ids); a
range's host time is the union of its intervals. The device's busy time is
the union of its operations' intervals, so overlapping operations count
once."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

from harness import registry
from harness.patching import Patches

LABEL = "layer::"
WINDOW = "bench::window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Ranges:
    """The wrappers of the named layers' files, installed for the whole
    traced run; ranges and probe records only while `active`."""

    def __init__(self, layers: List[str]) -> None:
        self.layers = list(layers)
        self.active = False
        self.store: Dict = {}
        self.records: Dict[str, List[Dict]] = collections.defaultdict(list)
        self.calls: Dict[str, int] = collections.Counter()
        self._patches = Patches()

    def install(self) -> None:
        for name in self.layers:
            spec = registry.layer(name)
            for item in spec["wrap"]:
                item = {"target": item} if isinstance(item, str) else item
                probe = registry.probe(item["probe"]) if "probe" in item else None
                self._patches.wrap(item["target"], self._wrapper(name, probe))

    def _wrapper(self, name: str, probe):
        label = LABEL + name
        always = bool(getattr(probe, "ALWAYS", False))

        def make(fn):
            def w(*a, **k):
                if not self.active:
                    out = fn(*a, **k)
                    if always:
                        probe.probe(a, k, out, self.store)
                    return out
                with torch.profiler.record_function(label):
                    out = fn(*a, **k)
                self.calls[name] += 1
                if probe is not None:
                    self.records[name].append(probe.probe(a, k, out, self.store))
                return out
            return w
        return make

    def undo(self) -> None:
        self._patches.undo()


class Profiler:
    """torch.profiler over the traced calls, the window marked by a range."""

    def __init__(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts,
            record_shapes=False, with_stack=False, profile_memory=False)
        self._win = None

    def start(self) -> None:
        self.prof.start()
        self._win = torch.profiler.record_function(WINDOW)
        self._win.__enter__()

    def stop(self) -> str:
        """Stops and writes the chrome trace to a temporary file; its path."""
        self._win.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(path)
        return path


def warm_profiler() -> None:
    """One short session in set-up, so the window's session does not pay the
    tracer's first start."""
    p = Profiler()
    p.start()
    torch.ones(1, device="cuda").add_(1)
    os.remove(p.stop())


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _inside(starts: List[float], merged: List[Tuple[float, float]], t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= merged[i][1]


class TraceView:
    """What the per-layer metrics read: the traced window, the device's busy
    time, per layer its ranges' device and host time, call count and probe
    records, and the work that the window completed."""

    def __init__(self, events: List[Dict], ranges: Ranges, units: int, unit: str,
                 cfg: Dict, peaks: Optional[Dict]) -> None:
        self.cfg, self.peaks = cfg, peaks
        self.frames = units if unit == "frames" else 0
        self.requests = units if unit == "requests" else 0
        self.records, self.calls = ranges.records, ranges.calls
        self._step = None
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("trace: the window's range is missing")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e:
                c = e["args"].get("correlation")
                if c is not None:
                    launch[c] = float(e["ts"])
        dev = []
        for e in events:
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
                a, d = float(e["ts"]), float(e.get("dur", 0.0))
                if a + d <= w0 or a >= w1:
                    continue
                dev.append((max(a, w0), min(a + d, w1), e.get("name", "?"), e.get("cat"),
                            launch.get(e.get("args", {}).get("correlation"))))
        self.kernels = sum(1 for d in dev if d[3] == "kernel")
        busy = _merge([(a, b) for a, b, *_ in dev])
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        per_layer: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
        for e in events:
            n = e.get("name", "")
            if e.get("cat") == "user_annotation" and n.startswith(LABEL) and e.get("ph") == "X":
                per_layer[n[len(LABEL):]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        self._host: Dict[str, float] = {}
        self._device: Dict[str, float] = {}
        self._ranges = {}
        for name, iv in per_layer.items():
            merged = _merge(iv)
            starts = [a for a, _ in merged]
            self._ranges[name] = (starts, merged)
            self._host[name] = sum(min(b, w1) - max(a, w0) for a, b in merged if b > w0 and a < w1) * 1e-6
            self._device[name] = sum(b - a for a, b, _n, _c, t in dev
                                     if t is not None and _inside(starts, merged, t)) * 1e-6
        by_name: Dict[str, float] = collections.Counter()
        for a, b, n, _c, _t in dev:
            by_name[n] += (b - a) * 1e-6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        self.idle_gaps = self._gaps(busy, w0, w1, events)

    def _gaps(self, busy, w0, w1, events) -> List[Tuple[str, float]]:
        """Idle time between device operations, summed by the innermost
        layer range (or `outside layers`) open on the host when it began."""
        ann = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(LABEL):])
                     for e in events if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith(LABEL) and e.get("ph") == "X")
        starts = [a for a, _, _ in ann]
        gaps, t = [], w0
        for a, b in busy + [(w1, w1)]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        out: Dict[str, float] = collections.Counter()
        for a, b in gaps:
            i = bisect.bisect_right(starts, a) - 1
            name = "outside layers"
            for j in range(i, max(i - 64, -1), -1):      # the latest-opened that is open
                if ann[j][1] >= a:
                    name = ann[j][2]
                    break
            out[name] += (b - a) * 1e-6
        return sorted(out.items(), key=lambda kv: -kv[1])[:10]

    def layer_device_s(self, name: str) -> float:
        return self._device.get(name, 0.0)

    def layer_host_s(self, name: str) -> float:
        return self._host.get(name, 0.0)

    def layer_calls(self, name: str) -> int:
        return self.calls.get(name, 0)

    def probes(self, name: str) -> List[Dict]:
        return self.records.get(name, [])

    @property
    def step(self):
        """The step's FLOP counter for this run's configuration."""
        if self._step is None:
            from roofline.step import StepFlops
            self._step = StepFlops(self.cfg)
        return self._step


def read_trace(path: str) -> List[Dict]:
    with open(path) as f:
        data = json.load(f)
    os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data
