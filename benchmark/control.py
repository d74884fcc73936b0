"""Readings that the limits of `correct` are set from (see PERF.md): for each
seed, one process-local run of a cell's set-up and a short window at the
cell's own size and load, then the sampled calls judged twice against the
float32 reference, once as the program computed them and once with the
control in the program's place (the reference with every product's
operands in float8, the precision below the configuration's bfloat16).

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--out FILE]

Prints one JSON line per seed: {"seed", "program": {...}, "control": {...}}.
Not part of a benchmark run; it needs the card."""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import torch  # noqa: E402

from harness import reference, registry, system, window  # noqa: E402


def readings(wl_name: str, seed: int, device: torch.device, cfg=None, spec=None):
    bench = registry.benchmark()
    wl = registry.workload(bench, wl_name)
    cfg = cfg or registry.config(bench, wl["config"])
    spec = spec or registry.traffic(wl["traffic"])
    sysm = system.build(cfg, seed, device)
    driver = registry.driver(spec["kind"]).Driver(sysm, spec, seed)
    if spec["kind"] == "stream":
        driver.warm_up()          # the window's memory state needs the prefill
    win = window.run(driver, 0.0, driver.plan())
    driver.release()
    ref = reference.Reference(cfg, sysm.weights, device)
    ctl = reference.Reference(cfg, sysm.weights, device, "fp8")
    prog, ctrl = driver.judge(win.captures, ref, ctl)
    return {"seed": seed, "workload": wl_name, "failed": int(sum(not ok for ok in win.ok)),
            "sampled": len(win.captures), "program": prog, "control": ctrl}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: needs the card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t = time.perf_counter()
        line = readings(args.workload, int(s), torch.device("cuda"))
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
