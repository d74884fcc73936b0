"""LongDataset evaluation entry point (port of the root `run_longdataset_test.py`;
reference: run_longdataset_test.ipynb).

Sparse-GT evaluation: metrics only at annotated frame ids; exercises the
long-term memory consolidation + vanishing-mask recovery on 1-3k frame
videos (blueboy / dressage / rat).

  python -m vosesam_tpu_torch.run_longdataset_test --root /path/to/LongDataset \\
      [--configs baseline both_neg_C] [--device cpu] [--batch [--mesh DPxMP]]

`--batch` / `--mesh`: whole videos spread over the process group, as in
`run_davis_test`.
"""

from __future__ import annotations

import argparse
import uuid

from vosesam_tpu_torch.eval.datasets import LongVideoDataset
from vosesam_tpu_torch.eval.runner import format_table, run_model_on_longdata_set
from vosesam_tpu_torch.parallel.mesh import owned_group
from vosesam_tpu_torch.run_davis_test import (CONFIGS, add_model_flags, log, make_batched,
                                               make_model)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="LongDataset root")
    ap.add_argument("--split_file", default="val.txt")
    ap.add_argument("--configs", nargs="*", default=["baseline", "both_neg_C"])
    ap.add_argument("--max_videos", type=int, default=None)
    ap.add_argument("--save_masks", action="store_true")
    ap.add_argument("--chunk", type=int, default=None,
                    help="chunked path with this chunk size (the same masks)")
    add_model_flags(ap)
    args = ap.parse_args(argv)

    dataset = LongVideoDataset(args.root, args.split_file)
    with owned_group():
        for name in args.configs:
            model = make_model(args, CONFIGS[name])
            runname = f"long_{name}_{uuid.uuid4().hex[:6]}"
            log(f"=== {runname} ===")
            rows = run_model_on_longdata_set(runname, model, dataset,
                                             save_masks=args.save_masks,
                                             max_videos=args.max_videos, chunk=args.chunk,
                                             batched=make_batched(args, model))
            log(format_table(rows, ["video", "J_mean", "F_mean", "JF_mean", "fps"]))


if __name__ == "__main__":
    main()
