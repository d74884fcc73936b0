"""LVOS evaluation entry point (port of the root `run_lvos_test.py`; reference:
run_lvos_test.ipynb).

No in-run metrics — palette-PNG masks are saved for the external LVOS
evaluator (runner.py:226-284 semantics).

  python -m vosesam_tpu_torch.run_lvos_test --root /path/to/LVOS [--config both_neg_C]
      [--device cpu] [--batch [--mesh DPxMP] [--chunk K]]

`--batch` / `--mesh`: whole videos spread over the process group, as in
`run_davis_test` (BASELINE config 5, "LVOS batched across a slice"); with
`--batch`, `--chunk` makes each video run the chunked tracker.
"""

from __future__ import annotations

import argparse
import uuid

from vosesam_tpu_torch.eval.datasets import LongVideoDataset
from vosesam_tpu_torch.eval.runner import run_model_on_longvos_set
from vosesam_tpu_torch.parallel.mesh import owned_group
from vosesam_tpu_torch.run_davis_test import (CONFIGS, add_model_flags, log, make_batched,
                                               make_model)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="LVOS root")
    ap.add_argument("--split_file", default="test.txt")
    ap.add_argument("--config", default="both_neg_C")
    ap.add_argument("--max_videos", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None,
                    help="chunked path with this chunk size (the same masks)")
    add_model_flags(ap)
    args = ap.parse_args(argv)

    dataset = LongVideoDataset(args.root, args.split_file)
    with owned_group():
        model = make_model(args, CONFIGS[args.config])
        runname = f"lvos_{args.config}_{uuid.uuid4().hex[:6]}"
        log(f"=== {runname} ===")
        run_model_on_longvos_set(runname, model, dataset, max_videos=args.max_videos,
                                 chunk=args.chunk, batched=make_batched(args, model))
        log(f"masks saved under ./result/{runname}/masks/")


if __name__ == "__main__":
    main()
