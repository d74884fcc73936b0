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
an evaluation). `--batch` spreads whole videos over the ranks of the
data axis of the process group
(`parallel/evaluation.py:BatchedGenerator`; the sequential path's masks and
metrics, fps the group's aggregate rate); `--mesh DPxMP` lays the ranks out
as JAX lays devices out (the model axis replicated). One process is a group
of one (NCCL on the card, gloo with `--device cpu`); on a box with n cards
start n processes with `torchrun --nproc_per_node n -m
vosesam_tpu_torch.run_davis_test ... --batch`. Only rank 0 writes files.
"""

from __future__ import annotations

import argparse
import dataclasses
import uuid

from vosesam_tpu_torch.config import FrameworkConfig, RefinementConfig, SAMConfig
from vosesam_tpu_torch.eval.datasets import DavisDataset
from vosesam_tpu_torch.eval.runner import format_table, run_model_on_davis_set
from vosesam_tpu_torch.parallel.mesh import is_writer, owned_group
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
                        help="spread whole videos over the ranks of the data axis "
                             "(BatchedGenerator; metrics equal to the "
                             "sequential path's, fps = group aggregate)")
        ap.add_argument("--mesh", default=None, metavar="DPxMP",
                        help="data x model layout of the ranks for --batch, e.g. 4x2 "
                             "(default: every rank on the data axis)")


def make_model(args: argparse.Namespace, refinement: RefinementConfig) -> TrackingAnything:
    cfg = FrameworkConfig(sam=SAMConfig(model_type=args.sam_model_type, hq=args.hq),
                          refinement=refinement)
    if getattr(args, "mesh", None):
        dp, mp = (int(v) for v in args.mesh.split("x"))
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, data_parallel=dp, model_parallel=mp))
    return TrackingAnything(sam_checkpoint=args.sam_checkpoint,
                            xmem_checkpoint=args.xmem_checkpoint, cfg=cfg, device=args.device)


def make_batched(args: argparse.Namespace, model: TrackingAnything):
    """With `--batch`, the BatchedGenerator over the process group (opened
    as a group of one where none is open: `parallel.mesh.ensure_distributed`),
    chunked lanes with `--chunk`; else None."""
    if not getattr(args, "batch", False):
        return None
    from vosesam_tpu_torch.parallel import mesh as meshlib
    from vosesam_tpu_torch.parallel.evaluation import BatchedGenerator

    meshlib.ensure_distributed(model.device)
    return BatchedGenerator(model.xmem_net, model.sam, model.cfg,
                            mesh=meshlib.make_mesh(model.cfg.parallel),
                            chunk=getattr(args, "chunk", None) or 1, device=model.device)


def log(msg: str) -> None:
    """Print on rank 0 only (every rank computes the same rows)."""
    if is_writer():
        print(msg)


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
    with owned_group():
        for name in args.configs:
            model = make_model(args, CONFIGS[name])
            batched = make_batched(args, model)
            runname = f"davis{args.year}_{name}_{uuid.uuid4().hex[:6]}"
            log(f"=== {runname} ===")
            rows = run_model_on_davis_set(runname, model, dataset, save_masks=args.save_masks,
                                          max_videos=args.max_videos, chunk=args.chunk,
                                          batched=batched)
            log(format_table(rows, TABLE))


if __name__ == "__main__":
    main()
