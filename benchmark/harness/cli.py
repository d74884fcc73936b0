"""One run of one cell:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's system from its configuration file and the seed, makes
its traffic, warms up every shape the traffic uses (all of it `setup_s`),
runs the measured window, and then, with the program's state freed, has
the plain reference judge the calls that the check sampled. The last line
of standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
With `--trace 1` the metrics are the cell's per-layer ones, read from a
profiler trace of a stretch of the window."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from harness import isolation, reference, registry, system, tracing, window


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "--id=0"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def program_from_checkout(root: str) -> bool:
    """The port must be the checkout's own, not one installed elsewhere."""
    import vosesam_tpu_torch

    here = os.path.realpath(os.path.dirname(vosesam_tpu_torch.__file__))
    return here.startswith(os.path.realpath(root) + os.sep)


_KERNELS = ("memory_read", "flash_attention", "window_attention")


def kernel_counts() -> Dict[str, Dict[str, int]]:
    """The port's own launch counters of its kernel wrappers (`COUNTS`:
    launches of each kernel and calls of its plain version), read only."""
    import importlib

    return {k: dict(importlib.import_module(f"vosesam_tpu_torch.ops.kernels.{k}").COUNTS)
            for k in _KERNELS}


def fallbacks_allowed(device: torch.device) -> bool:
    """Only off the card do the kernels' plain versions stand in for them."""
    return device.type != "cuda"


def run_cell(bench: Dict, wl: Dict, cfg: Dict, spec: Dict, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float) -> Optional[Dict]:
    """The result line as a dict, or None (with the reason on stderr) when
    the run may print none."""
    ranges = None
    if trace:
        ranges = tracing.Ranges(registry.layers_for(bench, wl["name"]))
        ranges.install()
    marks = [("start", time.perf_counter() - t_start)]
    sysm = system.build(cfg, seed, device)
    marks.append(("weights", time.perf_counter() - t_start))
    driver = registry.driver(spec["kind"]).Driver(sysm, spec, seed)
    marks.append(("traffic", time.perf_counter() - t_start))
    driver.warm_up()
    if trace and device.type == "cuda":
        tracing.warm_profiler()
    plan = driver.plan()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", setup_s))
    log("# set-up, s since start: " + ", ".join(f"{k} {v:.3f}" for k, v in marks))
    counts0 = kernel_counts()
    win = window.run(driver, seconds, plan, ranges, driver.trace_calls() if trace else 0)
    win.setup_s = setup_s
    counts = {k: {n: v - counts0[k][n] for n, v in c.items()} for k, c in kernel_counts().items()}
    log(f"# kernel wrapper calls in the window (launches; plain fallbacks): {counts}")
    log("# " + driver.unit + " per second by 5 s of the window: "
        + ", ".join(f"{r:.2f}" for r in window.rates(win)))
    bad = isolation.forbidden_modules()
    if bad:
        log(f"error: the process holds {', '.join(bad)} after the window")
        return None
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    metrics: Dict[str, Dict] = {}
    extra: Dict = {}
    if trace:
        from roofline import peaks

        events = tracing.read_trace(win.trace_path)
        tv = tracing.TraceView(events, ranges, win.traced_units, driver.unit, cfg,
                               peaks.for_card(kind))
        del events
        dev["busy_s"], dev["window_s"] = tv.busy_s, tv.window_s
        for m in registry.metrics_for(bench, "per_layer", wl["name"]):
            v = registry.per_layer(m["name"]).read(tv)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra["breakdown"] = {"device_ops": [[n, s] for n, s in tv.device_ops],
                              "idle_gaps": [[n, s] for n, s in tv.idle_gaps]}
        ranges.undo()
    else:
        for m in registry.metrics_for(bench, "end_to_end", wl["name"]):
            v = registry.end_to_end(m["name"]).value(win, driver)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if device.type == "cuda":
        dev["power"] = power_limit()
        log(f"# card: {dev['power']}")

    # the check: the program's state freed, the reference in its place
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.Reference(cfg, sysm.weights, device)
    numbers = driver.judge(win.captures, ref)
    lim = registry.limits(wl["name"])["numbers"]
    check = {k: {"value": numbers.get(k), "limit": v["limit"]} for k, v in lim.items()}
    if not fallbacks_allowed(device):
        # a kernel's plain version ran where the card's kernel should have
        check["plain_fallbacks"] = {"value": float(sum(c.get("plain", 0) for c in counts.values())),
                                    "limit": 0.0}
    failed = sum(u for u, ok in zip(win.units, win.ok) if not ok)
    correct = (failed == 0 and len(win.captures) == len(plan) and all(
        c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in check.values()))
    log(f"# window: {win.seconds:.3f} s, {len(win.units)} calls, {sum(win.units)} "
        f"{driver.unit}, setup {setup_s:.3f} s, sampled calls {len(win.captures)}/{len(plan)}")
    for k, c in check.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    out = {"correct": bool(correct), "attempted": int(sum(win.units)), "failed": int(failed),
           "metrics": metrics, "device": dev}
    out.update(extra)
    out["check"] = check
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        log(f"error: the cell needs {wl['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    if not program_from_checkout(registry.ROOT):
        log("error: vosesam_tpu_torch is not this checkout's")
        return 2
    cfg = registry.config(bench, wl["config"])
    spec = registry.traffic(wl["traffic"])
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    result = run_cell(bench, wl, cfg, spec, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), t_start)
    if result is None:
        return 1
    # the check's reference ran after the window: look again before printing
    bad = isolation.forbidden_modules()
    if bad:
        log(f"error: the process holds {', '.join(bad)} after the check")
        return 1
    print(json.dumps(result), flush=True)
    return 0
