"""DAVIS evaluation entry point (port of the root `run_davis_test.py`; reference:
run_davis_test.ipynb).

Runs the experiment matrix — dataset x refinement mode x point algorithm x
optimized flag — through the full pipeline, writing metric CSVs under
./result/<runname>/ and appending to the global ./result/all_tests.csv
ledger, on the card unless `--device cpu` is given.

Usage:
  python -m vosesam_tpu_torch.run_davis_test --davis_root /path/to/DAVIS --year 2017 \\
      --xmem_checkpoint XMem-s012.pth --sam_checkpoint sam_vit_h_4b8939.pth \\
      [--hq] [--configs baseline both_neg_C ...] [--max_videos N] [--device cpu]

Without checkpoints the models take seeded random weights (a smoke run, not
an evaluation). `--batch` / `--mesh` (lockstep batches over a device mesh)
are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import uuid

from vosesam_tpu_torch.config import FrameworkConfig, RefinementConfig, SAMConfig
from vosesam_tpu_torch.eval.datasets import DavisDataset
from vosesam_tpu_torch.eval.runner import format_table, run_model_on_davis_set
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

# The experiment matrix (reference testList.py:3-16 / notebook cell 3).
CONFIGS = {
    "baseline": RefinementConfig(use_refinement=False),
    "bbox": RefinementConfig(mode="bbox"),
    "point_C": RefinementConfig(mode="point", point_algorithm="C"),
    "both_C": RefinementConfig(mode="both", point_algorithm="C"),
    "both_neg_C": RefinementConfig(mode="both_neg", point_algorithm="C"),
    "both_neg_CP": RefinementConfig(mode="both_neg", point_algorithm="CP"),
    "both_neg_CPS": RefinementConfig(mode="both_neg", point_algorithm="CPS"),
    "both_neg_C_raw": RefinementConfig(mode="both_neg", point_algorithm="C",
                                       optimized=False),
    "mask_bbox_pos_neg": RefinementConfig(mode="mask_bbox_pos_neg"),
}
TABLE = ["video", "J_mean", "F_mean", "JF_mean", "AP", "fps"]
MESH_NOT_PORTED = ("--batch / --mesh (lockstep batches over a device mesh) are not ported "
                   "yet (ROADMAP A13, multi-device)")


def add_model_flags(ap: argparse.ArgumentParser, batch: bool = True) -> None:
    """The checkpoint, SAM and device flags every entry point takes, and
    `--batch` / `--mesh` where the root script has them."""
    ap.add_argument("--xmem_checkpoint", default=None)
    ap.add_argument("--sam_checkpoint", default=None)
    ap.add_argument("--sam_model_type", default="vit_h")
    ap.add_argument("--hq", action="store_true", help="SAM-HQ decoder")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    if batch:
        ap.add_argument("--batch", action="store_true",
                        help="lockstep batches over a device mesh (not ported: raises)")
        ap.add_argument("--mesh", default=None, metavar="DPxMP",
                        help="data x model mesh shape for --batch (not ported: raises)")


def make_model(args: argparse.Namespace, refinement: RefinementConfig) -> TrackingAnything:
    if getattr(args, "batch", False) or getattr(args, "mesh", None):
        raise NotImplementedError(MESH_NOT_PORTED)
    cfg = FrameworkConfig(sam=SAMConfig(model_type=args.sam_model_type, hq=args.hq),
                          refinement=refinement)
    return TrackingAnything(sam_checkpoint=args.sam_checkpoint,
                            xmem_checkpoint=args.xmem_checkpoint, cfg=cfg, device=args.device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--davis_root", required=True)
    ap.add_argument("--year", default="2017", choices=["2016", "2017"])
    ap.add_argument("--split", default="val")
    ap.add_argument("--configs", nargs="*", default=["baseline", "both_neg_C"])
    ap.add_argument("--max_videos", type=int, default=None)
    ap.add_argument("--save_masks", action="store_true")
    ap.add_argument("--chunk", type=int, default=None,
                    help="route propagation through the chunked path (the same masks) "
                         "with this chunk size")
    add_model_flags(ap)
    args = ap.parse_args(argv)

    dataset = DavisDataset(args.davis_root, f"{args.year}/{args.split}.txt",
                           single_object=args.year == "2016")
    for name in args.configs:
        model = make_model(args, CONFIGS[name])
        runname = f"davis{args.year}_{name}_{uuid.uuid4().hex[:6]}"
        print(f"=== {runname} ===")
        rows = run_model_on_davis_set(runname, model, dataset, save_masks=args.save_masks,
                                      max_videos=args.max_videos, chunk=args.chunk)
        print(format_table(rows, TABLE))


if __name__ == "__main__":
    main()
