"""Tiny stand-ins for the CPU tests: the cells' configurations with SAM cut
to two blocks of width 64 at a 128-pixel encode, and their traffic at
128x416 frames (wide enough for two of the generators' objects)."""

from __future__ import annotations

import copy
import os
import sys
from typing import Dict, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402,F401
from harness import registry  # noqa: E402

H, W = 128, 416


def config(name: str) -> Dict:
    cfg = copy.deepcopy(registry.config(registry.benchmark(), name))
    cfg["dtype"] = "float32"
    cfg["memory"].update(max_mid_term_frames=3, min_mid_term_frames=2,
                         max_long_term_elements=64, num_prototypes=8, top_k=8, mem_every=2)
    if "sam" in cfg:
        cfg["sam"].update(model_type="vit_b", image_size=128, window_size=7, embed_dim=64,
                          depth=2, num_heads=2, global_attn_indexes=[1],
                          vit_dims=[["vit_b", 64, 2, 2, [1]]])
        cfg["refinement"]["min_region_area"] = 10.0
    return cfg


def traffic(name: str) -> Dict:
    spec = copy.deepcopy(registry.traffic(name))
    spec.update(height=H, width=W)
    if spec["kind"] == "videos":
        spec.update(chunk=4, videos=[[7, 1], [6, 2]],
                    check={"calls": 3, "first_calls": 1, "consolidating_calls": 1, "within": 5}, trace={"calls": 3})
    elif spec["kind"] == "stream":
        spec.update(chunk=4, pool_frames=12, prefill_frames=20,
                    check={"calls": 2, "consolidating_calls": 1, "within": 4}, trace={"calls": 2})
    else:
        spec.update(images=3, check={"requests": 3, "within": 6}, trace={"requests": 4})
    return spec


def cell(workload: str) -> Tuple[Dict, Dict, Dict, Dict]:
    bench = registry.benchmark()
    wl = registry.workload(bench, workload)
    return bench, wl, config(wl["config"]), traffic(wl["traffic"])
