"""Discovery by name, and BENCHMARK.json against the benchmark's contract:
every name it gives finds its file, and every per-layer metric's cells
report the end-to-end metric that it moves."""

import json
import os
import re

import pytest

import tiny  # noqa: F401
from harness import patching, registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        assert m["better"] in ("lower", "higher")
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(w):
    wl = registry.workload(BENCH, w)
    cfg = registry.config(BENCH, wl["config"])
    assert cfg["name"] == wl["config"] and cfg["reduced"] == []
    spec = registry.traffic(wl["traffic"])
    registry.driver(spec["kind"]).Driver
    assert registry.limits(w)["numbers"]
    e2e = [m["name"] for m in registry.metrics_for(BENCH, "end_to_end", w)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = registry.metrics_for(BENCH, "per_layer", w)
    assert per
    for m in per:
        assert m["moves"] in e2e
        assert callable(registry.per_layer(m["name"]).read)
    for name in e2e:
        assert callable(registry.end_to_end(name).value)


def test_per_layer_metrics_name_layers_and_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["layer"] and "\n" not in m["layer"] and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("layer", sorted({n for w in BENCH["workloads"]
                                          for n in registry.layers_for(BENCH, w["name"])}))
def test_layer_targets_resolve(layer):
    spec = registry.layer(layer)
    for item in spec["wrap"]:
        item = {"target": item} if isinstance(item, str) else item
        owner, attr = patching.resolve(item["target"])
        assert callable(getattr(owner, attr))
        if "probe" in item:
            assert callable(registry.probe(item["probe"]).probe)


def test_every_file_under_paths_is_named_from_name_characters():
    ok = re.compile(r"^[A-Za-z0-9_./-]+$")
    for d, _, fs in os.walk(registry.BENCH_DIR):
        if "__pycache__" in d:
            continue
        for f in fs:
            assert ok.match(os.path.relpath(os.path.join(d, f), registry.ROOT)), f
