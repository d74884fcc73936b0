"""Checkpoint-day pipeline: the one command to run when real weights land
(port of the root `scripts/checkpoint_day.py`):

    python -m vosesam_tpu_torch.checkpoint_day --checkpoints DIR --data DIR \\
        [--reference_csv ref.csv] [--max_videos N] [--out result/checkpoint_day] \\
        [--chunk 8] [--letterbox 448x896] [--jf_gate 0.2] [--device cpu]
    python -m vosesam_tpu_torch.checkpoint_day --synthetic --device cpu

Phases, each `python -m vosesam_tpu_torch.run_parity` in a process of its
own:

  A. the official encode, all five BASELINE configs, through the chunked
     and batched paths (`--chunk K --batch`: the same masks as the
     sequential path); with `--reference_csv` the report gains dJ&F against
     the reference's own runner.
  B. the letterbox gear (`--encode letterbox:448x896` by default) on the
     J&F-bearing configs 1, 3, 4 and 5, on phase A's inputs.
  C. the verdict: the letterbox gear is promoted when every J&F-bearing
     config's |J&F letterbox - J&F official| <= --jf_gate (0.2, the BASELINE
     parity target) and none has J&F in one phase only, else kept opt-in;
     printed and written to checkpoint_day_report.json (`letterbox_verdict`:
     "promote" | "keep").
  D. notes: what the verdict changes.

`--synthetic` runs the pipeline on toy official-schema checkpoints and a
synthetic tree (phase A writes them, phase B reads the same files).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# configs that give J&F (2 is fps only: its clip has no ground truth; 5
# gives J&F only where ground truth is present)
JF_CONFIGS = ("1_davis2016_bear_xmem_only", "3_davis2017_val_samhq",
              "4_longdataset_consolidation", "5_lvos_val")


def compute_verdict(official: list, letterbox: list, jf_gate: float) -> dict:
    """The promotion decision: per-config deltas of the J&F-bearing configs,
    the incomplete ones (J&F in exactly one phase: never promote) and the
    excluded ones (J&F in neither: dataset or ground truth absent), and the
    verdict. Promote only on a complete comparison: at least one delta, no
    incomplete config, every delta within the gate."""
    off = {r["config"]: r for r in official}
    lb = {r["config"]: r for r in letterbox}
    deltas = {}
    incomplete = []
    for cfg in JF_CONFIGS:
        jo = off.get(cfg, {}).get("JF_mean")
        jl = lb.get(cfg, {}).get("JF_mean")
        if jo is not None and jl is not None:
            deltas[cfg] = round(jl - jo, 4)
        elif jo is not None or jl is not None:
            incomplete.append(cfg)
    excluded = [c for c in JF_CONFIGS if c not in deltas and c not in incomplete]
    verdict = ("promote"
               if deltas and not incomplete and all(abs(d) <= jf_gate for d in deltas.values())
               else "keep")
    return {"deltas": deltas, "incomplete": incomplete, "excluded": excluded,
            "verdict": verdict}


def run_phase(out: str, extra: List[str], device: str) -> list:
    """One `run_parity` process; its report rows."""
    cmd = [sys.executable, "-m", "vosesam_tpu_torch.run_parity", "--out", out,
           "--device", device, *extra]
    print("$ " + " ".join(cmd), flush=True)
    # the package is importable from any working directory
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    proc = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=path))
    if proc.returncode != 0:
        raise SystemExit(f"phase failed (rc={proc.returncode}): {cmd}")
    with open(os.path.join(out, "parity_report.json")) as f:
        return json.load(f)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoints", default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="toy official-schema checkpoints and synthetic trees, end to end")
    ap.add_argument("--reference_csv", default=None)
    ap.add_argument("--max_videos", type=int, default=None)
    ap.add_argument("--out", default=os.path.join("result", "checkpoint_day"))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--chunk", type=int, default=8, help="the chunked path's K")
    ap.add_argument("--letterbox", default="448x896",
                    help="the letterbox gear's HxW (448x896: 28x56 tokens at 480p)")
    ap.add_argument("--jf_gate", type=float, default=0.2,
                    help="promote the letterbox gear iff every J&F delta is within this "
                         "gate (the BASELINE parity target)")
    args = ap.parse_args(argv)
    if not args.synthetic and (not args.checkpoints or not args.data):
        ap.error("--checkpoints and --data are required (or --synthetic)")
    os.makedirs(args.out, exist_ok=True)

    common = ["--chunk", str(args.chunk), "--batch"]
    if args.max_videos is not None:
        common += ["--max_videos", str(args.max_videos)]

    # ---- phase A: the official encode, all five configs
    a_out = os.path.join(args.out, "official")
    a_extra = list(common)
    if args.checkpoints:
        a_extra += ["--checkpoints", args.checkpoints]
    if args.data:
        a_extra += ["--data", args.data]
    if args.synthetic:
        a_extra += ["--synthetic"]
    if args.reference_csv:
        a_extra += ["--reference_csv", args.reference_csv]
    official = run_phase(a_out, a_extra, args.device)

    # phase B reads phase A's inputs (in synthetic mode phase A wrote them)
    ck = args.checkpoints or os.path.join(a_out, "synthetic", "checkpoints")
    data = args.data or os.path.join(a_out, "synthetic", "data")

    # ---- phase B: the letterbox gear on the J&F-bearing configs
    b_out = os.path.join(args.out, "letterbox")
    b_extra = list(common) + ["--checkpoints", ck, "--data", data,
                              "--encode", f"letterbox:{args.letterbox}",
                              "--configs", "1", "3", "4", "5"]
    if args.synthetic:
        b_extra += ["--synthetic"]
    letterbox = run_phase(b_out, b_extra, args.device)

    # ---- phase C: the verdict
    v = compute_verdict(official, letterbox, args.jf_gate)
    deltas, incomplete, excluded, verdict = (v["deltas"], v["incomplete"], v["excluded"],
                                             v["verdict"])
    report = {
        "official": official,
        "letterbox": letterbox,
        "letterbox_geometry": args.letterbox,
        "letterbox_jf_delta": deltas,
        "letterbox_incomplete": incomplete,
        "letterbox_excluded": excluded,
        "jf_gate": args.jf_gate,
        "letterbox_verdict": verdict,
        # ---- phase D
        "notes": [
            "verdict 'promote': set SAMConfig.encode_letterbox_hw="
            f"({args.letterbox.replace('x', ', ')}) as the default gear (its speed on "
            "the card is the bench's letterbox_fps row against the headline fps); "
            "'keep': leave the gear opt-in.",
        ],
    }
    path = os.path.join(args.out, "checkpoint_day_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)

    print("\n===== CHECKPOINT-DAY VERDICT =====")
    for cfg, d in deltas.items():
        print(f"  {cfg:36s} dJ&F(letterbox-official) = {d:+.4f}")
    if not deltas:
        print("  (no J&F-bearing config produced numbers in both phases)")
    for cfg in incomplete:
        print(f"  {cfg:36s} INCOMPLETE: J&F in only one phase; verdict forced to 'keep'")
    for cfg in excluded:
        print(f"  {cfg:36s} excluded: no J&F in either phase (dataset/GT absent)")
    print(f"  letterbox gear: **{verdict.upper()}**  (gate ±{args.jf_gate})")
    for n in report["notes"]:
        print(f"  note: {n}")
    print(f"written: {path}")
    return report


if __name__ == "__main__":
    main()
