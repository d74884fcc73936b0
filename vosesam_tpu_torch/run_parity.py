"""One-command J&F parity runner for the five BASELINE configs (port of the
root `run_parity.py`):

    python -m vosesam_tpu_torch.run_parity --checkpoints DIR --data DIR \\
        [--reference_csv ref.csv] [--max_videos N] [--out result/parity] \\
        [--configs 1 3] [--chunk K] [--batch] [--encode official|rect|letterbox:HxW] \\
        [--device cpu]
    python -m vosesam_tpu_torch.run_parity --synthetic --device cpu

Expected layout (any subset; a config whose inputs are missing is a SKIP
row, never an error):

  checkpoints/
    XMem-s012.pth                      (tracker/model/network.py:184)
    sam_vit_h_4b8939.pth               (tools/base_segmenter.py:25)
    sam_hq_vit_h.pth                   (the SAM-HQ variant)
  data/
    DAVIS/                             (JPEGImages/480p, Annotations/480p,
                                        ImageSets/2016|2017)
    LongDataset/                       (sparse ground truth)
    LVOS/                              (valid_set layout)
    test_sample/test-sample*.mp4       (the reference's demo clips; .gif too)

The five configs (BASELINE.json):
  1. DAVIS-2016 `bear` 480p, XMem-only propagation
  2. the test_sample clip, XMem -> SAM ViT-H point-prompt loop (fps only:
     the clip has no ground truth), seeded by `first_frame_click` at the
     frame's centre
  3. DAVIS-2017 val multi-object, SAM-HQ ViT-H
  4. LongDataset, long-term consolidation
  5. LVOS val (masks saved; no J&F, as the root runner)

`--chunk K` routes configs 1-4 through the chunked path (the same masks),
`--batch` the dataset configs through `parallel/evaluation.py:
BatchedGenerator` over the process group (a group of one where none is
open; fps the group's aggregate rate). With `--reference_csv` (rows
`config,J_mean,F_mean,JF_mean` from the reference's runner on the same
data) the report gains dJ&F columns and flags |dJ&F| > 0.2, the BASELINE
target. Runs on the card unless `--device cpu`.

`--synthetic` writes what was not supplied under `--out/synthetic`:
official-schema `.pth` files from seeded modules at toy widths (XMem key 8,
value 16, hidden 4; a vit_h 64 wide, 2 blocks, image 128, window 7; both SAM
files from the same seed, as the root runner writes them) and a 32x48 data
tree (`eval/synthetic.py`) with the test_sample clip made from DAVIS
`bear`'s frames; the configs then run at a toy `MemoryConfig` in fp32.
Reading or writing the clip needs imageio: without it config 2 is a SKIP
row that says so. The report lists the launches of each CUDA kernel
wrapper over the run (`kernel_launches.json` beside `parity_report.json`;
the plain versions' calls on the CPU under "plain").
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vosesam_tpu_torch.config import (
    FrameworkConfig,
    MemoryConfig,
    RefinementConfig,
    SAMConfig,
    XMemConfig,
)

CONFIGS = ("1_davis2016_bear_xmem_only", "2_test_sample_full_loop", "3_davis2017_val_samhq",
           "4_longdataset_consolidation", "5_lvos_val")
JF_GATE = 0.2
SYN_HW = (32, 48)
SYN_VIT = (("vit_h", 64, 2, 2, (1,)),)          # a tiny vit_h: 64 wide, 2 blocks
SYN_SAM = dict(image_size=128, window_size=7, vit_dims=SYN_VIT)
SYN_XMEM = XMemConfig(key_dim=8, value_dim=16, hidden_dim=4, max_objects=2)
SYN_MEMORY = MemoryConfig(max_mid_term_frames=3, min_mid_term_frames=2,
                          max_long_term_elements=64, num_prototypes=8, top_k=8, mem_every=2)
SYN_FRAMES = dict(davis_frames=4, long_frames=6, long_every=3, lvos_frames=4, ovis_frames=2)
CLIP = "test-sample2.mp4"
CHECKPOINT_FILES = ("XMem-s012.pth", "sam_vit_h_4b8939.pth", "sam_hq_vit_h.pth")


def _exists(*parts) -> Optional[str]:
    p = os.path.join(*[x for x in parts if x])
    return p if os.path.exists(p) else None


def imageio_missing() -> Optional[str]:
    """Why a video cannot be read or written here, or None."""
    from vosesam_tpu_torch.eval.video_io import _imageio

    try:
        _imageio()
    except ImportError as e:
        return str(e)
    return None


# ------------------------------------------------------------- --synthetic

def write_checkpoints(ck: str, sam_cfg: SAMConfig, samhq_cfg: SAMConfig,
                      xmem_cfg: XMemConfig = SYN_XMEM, device="cpu") -> None:
    """XMem-s012.pth, sam_vit_h_4b8939.pth and sam_hq_vit_h.pth under `ck`,
    in the official schemas (the port's modules use the official names):
    the state dicts of seeded random modules (XMem seed 0, both SAMs seed
    1), fp32, made on `device`."""
    from vosesam_tpu_torch.models.sam.predictor import sam_init
    from vosesam_tpu_torch.models.xmem.network import xmem_init

    os.makedirs(ck, exist_ok=True)
    dev = torch.device(device)
    torch.save({k: v.cpu() for k, v in xmem_init(xmem_cfg, seed=0, device=dev).state_dict()
                .items()}, os.path.join(ck, CHECKPOINT_FILES[0]))
    for fname, cfg in zip(CHECKPOINT_FILES[1:], (sam_cfg, samhq_cfg)):
        sam = sam_init(cfg, seed=1, device=dev)
        torch.save({k: v.cpu() for k, v in sam.state_dict().items()}, os.path.join(ck, fname))
        del sam


def write_data(data: str, h: int = SYN_HW[0], w: int = SYN_HW[1],
               frames: Optional[Dict[str, int]] = None) -> Optional[str]:
    """The synthetic DAVIS / LongDataset / LVOS tree (`eval/synthetic.py`,
    seed 0; `frames`: `write_tree`'s frame counts) and the test_sample clip
    (DAVIS bear's frames). Returns why the clip could not be written
    (imageio missing), else None."""
    from vosesam_tpu_torch.eval.datasets import DavisDataset
    from vosesam_tpu_torch.eval.synthetic import write_tree
    from vosesam_tpu_torch.eval.video_io import write_video

    write_tree(data, h, w, seed=0, **(frames or SYN_FRAMES))
    missing = imageio_missing()
    if missing is None:
        ds = DavisDataset(os.path.join(data, "DAVIS"), "2016/val.txt")
        info = ds.video_info("bear")
        sdir = os.path.join(data, "test_sample")
        os.makedirs(sdir, exist_ok=True)
        write_video(os.path.join(sdir, CLIP), ds.load_frames("bear", info["frames"]), fps=10)
    return missing


# ----------------------------------------------------------------- report

def report_row(rows: List[dict], config: str, metric_rows: Optional[List[dict]] = None,
               fps: Optional[float] = None, note: str = "") -> dict:
    """A report row: the runner's rows' means (the root's DataFrame means)."""
    row = {"config": config, "J_mean": None, "F_mean": None, "JF_mean": None,
           "fps": fps, "note": note}
    def mean(k):                    # pandas' Series.mean: NaN skipped
        vals = [float(r[k]) for r in metric_rows if not np.isnan(r[k])]
        return float(np.mean(vals)) if vals else float("nan")

    if metric_rows:
        for k in ("J_mean", "F_mean", "JF_mean"):
            row[k] = mean(k)
        if fps is None:
            row["fps"] = mean("fps")
    rows.append(row)
    return row


def read_reference(path: Optional[str]) -> Dict[str, dict]:
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        return {r["config"]: r for r in csv.DictReader(f)}


def format_report(rows: List[dict], ref: Dict[str, dict]) -> List[str]:
    """The root runner's report table; with reference rows, dJ&F and OK /
    FAIL against the gate (and each row gains "dJF")."""
    hdr = f"{'config':36s} {'J':>7s} {'F':>7s} {'J&F':>7s} {'fps':>7s}"
    if ref:
        hdr += f" {'dJ&F':>7s} {'ok?':>4s}"
    lines = [hdr]

    def cell(v):
        return v if v is not None else "—"

    for row in rows:
        jf = row["JF_mean"]
        line = (f"{row['config']:36s} {cell(row['J_mean']):>7} {cell(row['F_mean']):>7} "
                f"{cell(jf):>7} {cell(row['fps']):>7}")
        if ref and row["config"] in ref and jf is not None:
            d = jf - float(ref[row["config"]]["JF_mean"])
            line += f" {d:+7.3f} {'OK' if abs(d) <= JF_GATE else 'FAIL':>4s}"
            row["dJF"] = d
        if row["note"]:
            line += f"   [{row['note']}]"
        lines.append(line)
    return lines


def _launch_counts() -> Dict[str, int]:
    """Launches of every CUDA kernel wrapper, and the plain versions' calls."""
    from vosesam_tpu_torch.ops.kernels import deform_align as da
    from vosesam_tpu_torch.ops.kernels import flash_attention as fa
    from vosesam_tpu_torch.ops.kernels import memory_read as mr
    from vosesam_tpu_torch.ops.kernels import window_attention as wa

    out: Dict[str, int] = {}
    for mod in (mr, fa, wa, da):
        for k, v in mod.COUNTS.items():
            out[k] = out.get(k, 0) + v
    return out


# -------------------------------------------------------------------- main

def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoints", default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="write toy official-schema checkpoints and a synthetic data "
                         "tree (under --out) for what is not supplied, and run the five "
                         "configs at toy scale")
    ap.add_argument("--reference_csv", default=None)
    ap.add_argument("--max_videos", type=int, default=None)
    ap.add_argument("--out", default=os.path.join("result", "parity"))
    ap.add_argument("--configs", nargs="*", type=int, default=[1, 2, 3, 4, 5],
                    help="subset of the five BASELINE config numbers")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--chunk", type=int, default=None,
                    help="route configs 1-4 through the chunked path (the same masks) "
                         "with this chunk size")
    ap.add_argument("--batch", action="store_true",
                    help="run the dataset configs (1, 3, 4, 5) through the "
                         "BatchedGenerator over the process group (metrics equal to "
                         "the sequential path's, fps the group's aggregate rate)")
    ap.add_argument("--encode", default="official",
                    help="SAM encode geometry for every config: 'official' (1024 "
                         "square), 'rect' (encode_rect) or 'letterbox:HxW', e.g. "
                         "letterbox:448x896")
    args = ap.parse_args(argv)
    if not args.synthetic and (not args.checkpoints or not args.data):
        ap.error("--checkpoints and --data are required (or use --synthetic)")
    enc_kw = {}
    if args.encode == "rect":
        enc_kw = {"encode_rect": True}
    elif args.encode.startswith("letterbox:"):
        enc_kw = {"encode_letterbox_hw": tuple(
            int(v) for v in args.encode.split(":")[1].split("x"))}
    elif args.encode != "official":
        ap.error(f"unknown --encode {args.encode!r}")

    from vosesam_tpu_torch.device import resolve_device
    from vosesam_tpu_torch.eval.datasets import DavisDataset, LongVideoDataset
    from vosesam_tpu_torch.eval.runner import (
        run_model_on_davis_set,
        run_model_on_longdata_set,
        run_model_on_longvos_set,
    )
    from vosesam_tpu_torch.parallel import mesh as meshlib
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    before = _launch_counts()

    def mk_sam(**kw) -> SAMConfig:
        return SAMConfig(**kw, **(SYN_SAM if args.synthetic else {}), **enc_kw)

    def mk_cfg(**kw) -> FrameworkConfig:
        cfg = FrameworkConfig(**kw)
        if args.synthetic:          # toy memory, fp32
            cfg = dataclasses.replace(cfg, memory=SYN_MEMORY, dtype="float32")
        return cfg

    clip_missing = imageio_missing()
    if args.synthetic:
        if not args.checkpoints:
            args.checkpoints = os.path.join(args.out, "synthetic", "checkpoints")
            write_checkpoints(args.checkpoints, mk_sam(model_type="vit_h"),
                              mk_sam(model_type="vit_h", hq=True))
        if not args.data:
            args.data = os.path.join(args.out, "synthetic", "data")
            write_data(args.data)
    if clip_missing:
        print(f"test_sample clip: {clip_missing}")

    ck = args.checkpoints
    xmem_ck, sam_ck, samhq_ck = (_exists(ck, f) for f in CHECKPOINT_FILES)
    davis = _exists(args.data, "DAVIS")
    longd = _exists(args.data, "LongDataset")
    lvos = _exists(args.data, "LVOS")
    sample = None
    sdir = _exists(args.data, "test_sample")
    if sdir:
        # .mp4 first; .gif too (write_video's fallback where ffmpeg is missing)
        clips = sorted((f for f in os.listdir(sdir) if f.endswith((".mp4", ".gif"))),
                       key=lambda f: (not f.endswith(".mp4"), f))
        sample = os.path.join(sdir, clips[0]) if clips else None
    print(f"checkpoints: xmem={xmem_ck} sam={sam_ck} sam_hq={samhq_ck}")
    print(f"data: davis={davis} long={longd} lvos={lvos} sample={sample}")

    def model(sam_checkpoint=None, **cfg_kw):
        return TrackingAnything(xmem_checkpoint=xmem_ck, sam_checkpoint=sam_checkpoint,
                                cfg=mk_cfg(**cfg_kw), device=dev)

    def batched(m):
        if not args.batch:
            return None
        from vosesam_tpu_torch.parallel.evaluation import BatchedGenerator

        meshlib.ensure_distributed(dev)
        return BatchedGenerator(m.xmem_net, m.sam, m.cfg, mesh=meshlib.make_mesh(m.cfg.parallel),
                                chunk=args.chunk or 1, device=dev)

    rows: List[dict] = []
    with meshlib.owned_group():
        # ---- 1. DAVIS-2016 bear, XMem-only
        if 1 in args.configs:
            if xmem_ck and davis:
                ds = DavisDataset(davis, "2016/val.txt", single_object=True)
                ds.videos = [v for v in ds.videos if v == "bear"] or ds.videos[:1]
                m = model(refinement=RefinementConfig(use_refinement=False))
                out = run_model_on_davis_set("parity1_bear_xmem", m, ds, max_videos=1,
                                             chunk=args.chunk, batched=batched(m))
                report_row(rows, CONFIGS[0], out)
            else:
                report_row(rows, CONFIGS[0], note="SKIP: needs XMem-s012.pth + DAVIS")

        # ---- 2. test_sample clip, the full refinement loop
        if 2 in args.configs:
            if xmem_ck and sam_ck and clip_missing:      # no clip can be read here
                report_row(rows, CONFIGS[1],
                           note="SKIP: needs imageio to read the test_sample clip")
            elif xmem_ck and sam_ck and sample:
                from vosesam_tpu_torch.eval.palette import save_palette_mask
                from vosesam_tpu_torch.eval.video_io import read_video_frames

                m = model(sam_checkpoint=sam_ck, sam=mk_sam(model_type="vit_h"),
                          refinement=RefinementConfig(mode="both_neg", point_algorithm="C"))
                frames = read_video_frames(sample)
                # seed with a click at the frame's centre, as the demo seeds a
                # video with a first-frame click
                h, w = frames[0].shape[:2]
                mask, _lg, _p = m.samcontroler.first_frame_click(
                    frames[0], np.asarray([[w // 2, h // 2]]), np.asarray([1]), multimask=True)
                t0 = time.time()
                if args.chunk:
                    masks, _scores = m.generator_chunked(frames, mask.astype(np.uint8),
                                                         chunk=args.chunk)
                else:
                    masks, *_ = m.generator(frames, mask.astype(np.uint8))
                fps = len(frames) / (time.time() - t0)
                outd = os.path.join(args.out, "sample_masks")
                os.makedirs(outd, exist_ok=True)
                for i, mk in enumerate(masks[:20]):
                    save_palette_mask(mk, os.path.join(outd, f"{i:05d}.png"))
                report_row(rows, CONFIGS[1], fps=round(fps, 2), note="no GT in clip; masks saved")
            else:
                report_row(rows, CONFIGS[1], note="SKIP: needs XMem + SAM ckpt + test_sample mp4")

        # ---- 3. DAVIS-2017 val, SAM-HQ ViT-H
        if 3 in args.configs:
            if xmem_ck and samhq_ck and davis:
                ds = DavisDataset(davis, "2017/val.txt", single_object=False)
                m = model(sam_checkpoint=samhq_ck, sam=mk_sam(model_type="vit_h", hq=True),
                          refinement=RefinementConfig(mode="both_neg", point_algorithm="C",
                                                      optimized=True))
                out = run_model_on_davis_set("parity3_d17_hq", m, ds, max_videos=args.max_videos,
                                             chunk=args.chunk, batched=batched(m))
                report_row(rows, CONFIGS[2], out)
            else:
                report_row(rows, CONFIGS[2], note="SKIP: needs XMem + sam_hq ckpt + DAVIS")

        # ---- 4. LongDataset
        if 4 in args.configs:
            if xmem_ck and samhq_ck and longd:
                m = model(sam_checkpoint=samhq_ck, sam=mk_sam(model_type="vit_h", hq=True),
                          refinement=RefinementConfig(mode="both_neg"))
                out = run_model_on_longdata_set("parity4_long", m, LongVideoDataset(longd),
                                                max_videos=args.max_videos, chunk=args.chunk,
                                                batched=batched(m))
                report_row(rows, CONFIGS[3], out)
            else:
                report_row(rows, CONFIGS[3], note="SKIP: needs XMem + sam_hq ckpt + LongDataset")

        # ---- 5. LVOS
        if 5 in args.configs:
            if xmem_ck and samhq_ck and lvos:
                m = model(sam_checkpoint=samhq_ck, sam=mk_sam(model_type="vit_h", hq=True),
                          refinement=RefinementConfig(mode="both_neg"))
                run_model_on_longvos_set("parity5_lvos", m, LongVideoDataset(lvos),
                                         max_videos=args.max_videos, batched=batched(m),
                                         chunk=args.chunk)
                report_row(rows, CONFIGS[4], note="masks saved; J&F where GT present"
                           + ("; batched over mesh" if args.batch else ""))
            else:
                report_row(rows, CONFIGS[4], note="SKIP: needs XMem + sam_hq ckpt + LVOS")

    ref = read_reference(args.reference_csv)
    lines = format_report(rows, ref)
    print("\n===== PARITY REPORT =====")
    print("\n".join(lines))
    after = _launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    path = os.path.join(args.out, "parity_report.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=2)
    with open(os.path.join(args.out, "kernel_launches.json"), "w") as f:
        json.dump(launches, f, indent=1)
    print(f"kernel launches: {json.dumps(launches)}")
    print(f"\nwritten: {path}")
    return rows


if __name__ == "__main__":
    main()
