"""Discovery by name: every configuration, traffic mix, layer, per-layer
metric, end-to-end metric, probe and limit set is a file of its own under
`benchmark/`, found by the name that `BENCHMARK.json` gives it. A later
change adds a cell or a metric by adding files and entries."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts: str) -> Dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def _module(kind: str, name: str) -> ModuleType:
    """`benchmark/<kind>/<name>.py` loaded under a private module name (a
    metric's name may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Optional[str] = None) -> Dict:
    with open(os.path.join(root or ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(os.path.dirname(BENCH_DIR), c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return _json("traffic", f"{name}.json")


def layer(name: str) -> Dict:
    return _json("layers", f"{name}.json")


def layers_for(bench: Dict, workload_name: str) -> List[str]:
    """The layers whose ranges this cell's traced run opens: those that its
    per-layer metrics name (each metric file's `LAYERS`), and no others."""
    return sorted({name for m in metrics_for(bench, "per_layer", workload_name)
                   for name in per_layer(m["name"]).LAYERS})


def limits(workload_name: str) -> Dict:
    return _json("limits", f"{workload_name}.json")


def metrics_for(bench: Dict, section: str, workload_name: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` entries that this cell reports: those
    that list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or workload_name in m["workloads"]]


def driver(kind: str) -> ModuleType:
    return _module("drivers", kind)


def end_to_end(name: str) -> ModuleType:
    return _module("endtoend", name)


def per_layer(name: str) -> ModuleType:
    return _module("metrics", name)


def probe(name: str) -> ModuleType:
    return _module("probes", name)
