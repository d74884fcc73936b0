"""OVIS evaluation entry point (port of the root `run_ovis_test.py`; reference:
videoPipeline.ipynb cells 2-3 + 13).

Runs the experiment matrix through the full pipeline against an OVIS-style
annotations JSON (COCO-VIS RLE), writing metric CSVs under
./result/<runname>/ and appending to ./result/all_tests.csv.

  python -m vosesam_tpu_torch.run_ovis_test --images_root /path/to/OVIS/train_images \\
      --annotations /path/to/annotations_valid.json [--configs baseline both_neg_C]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import uuid

from vosesam_tpu_torch.eval.ovis import OvisDataset, run_model_on_ovis_set
from vosesam_tpu_torch.eval.runner import format_table
from vosesam_tpu_torch.run_davis_test import CONFIGS, TABLE, add_model_flags, make_model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images_root", required=True)
    ap.add_argument("--annotations", required=True)
    ap.add_argument("--configs", nargs="*", default=["baseline", "both_neg_C"])
    ap.add_argument("--max_videos", type=int, default=None)
    ap.add_argument("--save_masks", action="store_true")
    ap.add_argument("--chunk", type=int, default=None,
                    help="chunked path with this chunk size (the same masks)")
    add_model_flags(ap, batch=False)
    args = ap.parse_args(argv)

    dataset = OvisDataset(args.images_root, args.annotations)
    for name in args.configs:
        model = make_model(args, CONFIGS[name])
        runname = f"ovis_{name}_{uuid.uuid4().hex[:6]}"
        print(f"=== {runname} ===")
        rows = run_model_on_ovis_set(runname, model, dataset, save_masks=args.save_masks,
                                     max_videos=args.max_videos, chunk=args.chunk)
        print(format_table(rows, TABLE))


if __name__ == "__main__":
    main()
