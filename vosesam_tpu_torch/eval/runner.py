"""Per-dataset evaluation runners (port of `vosesam_tpu/eval/runner.py`).

Reference: tools/runner.py — run_model_on_davis_set (:13-124),
run_model_on_longdata_set (:127-223, metrics only at annotated frame ids),
run_model_on_longVOS_set (:226-284, masks/videos saved for external eval).
Common protocol per video: clear tracker memory, run the generator, compute
J&F + AP, append CSV rows (whole_metrics.csv / per_object_metrics.csv /
global all_tests.csv ledger :11,104-122), optionally dump palette PNGs and
an mp4.

The JAX runners write their CSVs through pandas; here the standard
library's `csv` module writes the same files (`write_csv`: the same header
and row order, the same values, a float column's integers as floats and NaN
as an empty field, as pandas writes them), and the runners return the rows
of the JAX DataFrame as a list of dicts. `batched=` takes a
`parallel.evaluation.BatchedGenerator`: whole videos then spread
over the ranks of its mesh, grouped by resolution, with the sequential
path's masks; fps becomes the group's aggregate rate. Every rank computes
the same rows; only rank 0 writes files (CSVs, masks, videos, the ledger).
"""

from __future__ import annotations

import csv
import math
import numbers
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from vosesam_tpu_torch.eval import metrics as M
from vosesam_tpu_torch.eval.datasets import DavisDataset, LongVideoDataset
from vosesam_tpu_torch.eval.palette import save_palette_mask
from vosesam_tpu_torch.parallel.mesh import is_writer

ALL_TESTS_CSV = "./result/all_tests.csv"
# per-video keys that are not columns of whole_metrics.csv / the returned rows
TRACE_KEYS = ("per_object", "J_trace", "F_trace", "masks", "scores")


# ------------------------------------------------------------------ CSV

def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _is_number(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, (bool, np.bool_))


def _column_cells(values: Sequence) -> List[str]:
    """One column's cells as pandas' to_csv writes them: a column of numbers
    with a float or a gap among them is a float column (repr of each value,
    NaN and gaps empty); other cells are written one by one."""
    present = [v for v in values if not _missing(v)]
    as_float = bool(present) and all(_is_number(v) for v in present) and (
        len(present) < len(values) or any(not isinstance(v, numbers.Integral) for v in present))
    cells = []
    for v in values:
        if _missing(v) or (as_float and math.isnan(float(v))):
            cells.append("")
        elif as_float:
            cells.append(repr(float(v)))
        elif isinstance(v, (bool, np.bool_)):
            cells.append(str(bool(v)))
        elif isinstance(v, numbers.Integral):
            cells.append(str(int(v)))
        elif isinstance(v, numbers.Real):
            cells.append(repr(float(v)))
        else:
            cells.append(str(v))
    return cells


def write_csv(path: str, rows: Sequence[Dict], append: bool = False,
              columns: Sequence[str] = ()) -> None:
    """`pandas.DataFrame(rows).to_csv(path, index=False)`, or with `append`
    `to_csv(path, mode="a", header=<file is new>, index=False)`, without
    pandas: `columns` first, then the rows' keys in order of first
    appearance; a row's missing keys are empty."""
    columns = list(columns)
    for row in rows:
        columns.extend(k for k in row if k not in columns)
    header = not (append and os.path.exists(path))
    with open(path, "a" if append else "w", newline="") as f:
        if not columns:
            f.write("\n")
            return
        w = csv.writer(f, lineterminator="\n")
        if header:
            w.writerow(columns)
        cells = [_column_cells([row.get(c) for row in rows]) for c in columns]
        w.writerows(zip(*cells))


def format_table(rows: Sequence[Dict], columns: Sequence[str]) -> str:
    """The per-video table the entry points print (pandas' `to_string(index=
    False)` layout: right-aligned columns, floats to 6 decimals)."""
    def cell(v):
        if isinstance(v, float) or isinstance(v, np.floating):
            return "NaN" if math.isnan(v) else f"{float(v):.6f}"
        return str(v)

    grid = [list(columns)] + [[cell(r.get(c)) for c in columns] for r in rows]
    widths = [max(len(line[i]) for line in grid) for i in range(len(columns))]
    return "\n".join(" ".join(v.rjust(wd) for v, wd in zip(line, widths)) for line in grid)


# --------------------------------------------------------------- runners

def _result_dir(runname: str) -> str:
    d = os.path.join("./result", runname)
    if is_writer():
        os.makedirs(d, exist_ok=True)
    return d


def _append_global_ledger(row: Dict) -> None:
    if not is_writer():
        return
    os.makedirs(os.path.dirname(ALL_TESTS_CSV), exist_ok=True)
    write_csv(ALL_TESTS_CSV, [row], append=True)


def _eval_one_video(
    model, frames: List[np.ndarray], template_mask: np.ndarray,
    gt_masks: List[Optional[np.ndarray]],
    chunk: Optional[int] = None,
) -> Dict:
    """`chunk`: route propagation through generator_chunked (the same masks
    as the per-frame generator, `tests/test_torch_refinement.py`). None =
    per-frame generator (the reference's track_anything.py:56-81 analogue)."""
    model.xmem.clear_memory()
    t0 = time.time()
    if chunk:
        masks, scores = model.generator_chunked(frames, template_mask, chunk=chunk)
    else:
        masks, logits, painted, scores = model.generator(frames, template_mask)
    dt = time.time() - t0
    # Scores are ordered by the tracker's *remapped* contiguous slots
    # (utils/mask_mapper.py); GT palettes may be non-contiguous (e.g. {0,3,7}).
    # Capture the original-label -> slot map before clear_memory wipes it.
    remappings: Dict[int, int] = dict(
        getattr(getattr(model.xmem, "mapper", None), "remappings", None) or {})
    model.xmem.clear_memory()

    def _score_map(frame_scores) -> Dict[int, float]:
        if remappings:
            return {
                orig: (frame_scores[slot - 1] if slot - 1 < len(frame_scores) else 0.0)
                for orig, slot in remappings.items()
            }
        # No mapper (mock models in tests): assume contiguous labels.
        return {l + 1: s for l, s in enumerate(frame_scores)}

    return _metrics_from_masks(
        masks, gt_masks, [_score_map(s) for s in scores],
        fps=len(frames) / dt if dt > 0 else 0.0, scores=scores)


def _metrics_from_masks(
    masks: List[np.ndarray], gt_masks: List[Optional[np.ndarray]],
    label_scores: List[Dict[int, float]], fps: float, scores=None,
) -> Dict:
    """J&F/AP for one video from the generator's masks. `label_scores`:
    per-frame {original-palette-label: confidence} maps for AP."""
    video_metrics = M.compute_all_video_metrics(masks, gt_masks)
    ap_rows: List[dict] = []
    for i, gt in enumerate(gt_masks):
        if gt is None or i == 0:
            continue
        ap_rows.extend(M.true_positives(masks[i], gt, label_scores[i]))
    video_metrics.update(M.calculate_video_AP(ap_rows))
    video_metrics["fps"] = fps
    video_metrics["masks"] = masks
    video_metrics["scores"] = scores if scores is not None else label_scores
    return video_metrics


def _batched_group_metrics(batched, group_frames, group_templates, group_gts) -> List[Dict]:
    """One same-resolution group of videos through a BatchedGenerator, and
    its metrics per video. fps is the group's aggregate rate (frames over
    the group's wall time), given to every video of the group."""
    t0 = time.time()
    results = batched.run(group_frames, group_templates)
    dt = time.time() - t0
    fps = sum(len(f) for f in group_frames) / dt if dt > 0 else 0.0
    return [_metrics_from_masks(res["masks"], gts, res["label_scores"], fps=fps,
                                scores=res["scores"])
            for res, gts in zip(results, group_gts)]


def _infos(dataset, max_videos: Optional[int]) -> List[Dict]:
    return [info for vi, info in enumerate(dataset.iter_videos())
            if max_videos is None or vi < max_videos]


def _groups_by_resolution(dataset, infos) -> Dict[tuple, List[tuple]]:
    """(position, info) of the videos, grouped by their frames' (H, W)."""
    groups: Dict[tuple, List[tuple]] = {}
    for pos, info in enumerate(infos):
        first = dataset.load_frame(info["name"], info["frames"][0])
        groups.setdefault(first.shape[:2], []).append((pos, info))
    return groups


def _run_batched_with_gt(batched, dataset, max_videos, gts_of, template_of) -> List[Dict]:
    """A metric-bearing dataset through a BatchedGenerator: one run per
    resolution, metrics per video, rows in the dataset's order. `gts_of`
    maps an info to its per-frame ground truth (None where unannotated);
    `template_of(info, gts)` picks the seeding template."""
    infos = _infos(dataset, max_videos)
    per_video: List[Optional[Dict]] = [None] * len(infos)
    for group in _groups_by_resolution(dataset, infos).values():
        frames = [dataset.load_frames(i["name"], i["frames"]) for _, i in group]
        gts = [gts_of(i) for _, i in group]
        templates = [template_of(i, g) for (_, i), g in zip(group, gts)]
        for (pos, info), vm in zip(group, _batched_group_metrics(batched, frames, templates,
                                                                 gts)):
            vm["video"] = info["name"]
            per_video[pos] = vm
    return per_video


def _rows(per_video: List[Dict]) -> List[Dict]:
    """The per-video rows without the traces: whole_metrics.csv's rows, and
    what the runners return."""
    return [{k: v for k, v in vm.items() if k not in TRACE_KEYS} for vm in per_video]


def _write_video_csvs(run_dir: str, per_video: List[Dict]) -> None:
    if not is_writer():
        return
    write_csv(os.path.join(run_dir, "whole_metrics.csv"), _rows(per_video))
    rows = []
    for vm in per_video:
        for label, ms in vm["per_object"].items():
            rows.append({"video": vm["video"], "object": label, **ms})
    write_csv(os.path.join(run_dir, "per_object_metrics.csv"), rows)


def _aggregate(runname: str, dataset: str, per_video: List[Dict]) -> Dict:
    return {
        "run": runname,
        "dataset": dataset,
        "JF_mean": float(np.mean([v["JF_mean"] for v in per_video])),
        "J_mean": float(np.mean([v["J_mean"] for v in per_video])),
        "F_mean": float(np.mean([v["F_mean"] for v in per_video])),
        "AP": float(np.mean([v["AP"] for v in per_video])),
        "fps": float(np.mean([v["fps"] for v in per_video])),
    }


def run_model_on_davis_set(
    runname: str,
    model,
    dataset: DavisDataset,
    compute_metrics: bool = True,
    save_masks: bool = False,
    compute_video: bool = False,
    max_videos: Optional[int] = None,
    chunk: Optional[int] = None,
    batched=None,
) -> List[Dict]:
    """runner.py:13-124. `chunk`: see _eval_one_video. `batched`: a
    BatchedGenerator (whole videos spread over its mesh, grouped by
    resolution; the sequential path's masks and metrics, fps the group's
    aggregate rate)."""
    run_dir = _result_dir(runname)
    if batched is not None:
        per_video = _run_batched_with_gt(
            batched, dataset, max_videos,
            gts_of=lambda info: [dataset.load_mask(info["name"], f) for f in info["frames"]],
            template_of=lambda info, gts: gts[0])
    else:
        per_video = []
        for info in _infos(dataset, max_videos):
            video = info["name"]
            frames = dataset.load_frames(video, info["frames"])
            gts = [dataset.load_mask(video, f) for f in info["frames"]]
            vm = _eval_one_video(model, frames, gts[0], gts, chunk=chunk)
            vm["video"] = video
            per_video.append(vm)
    for vm, info in zip(per_video if is_writer() else [], dataset.iter_videos()):
        video = info["name"]
        if save_masks:
            mask_dir = os.path.join(run_dir, "masks", video)
            os.makedirs(mask_dir, exist_ok=True)
            for f, m in zip(info["frames"], vm["masks"]):
                save_palette_mask(m, os.path.join(mask_dir, f.replace(".jpg", ".png")))
        if compute_video:
            from vosesam_tpu_torch.eval.video_io import write_video

            write_video(os.path.join(run_dir, f"{video}.mp4"), list(vm["masks"]), fps=10)
        write_csv(os.path.join(run_dir, f"{video}_scores.csv"),
                  [{"scores": s} for s in vm["scores"]], columns=("scores",))

    _write_video_csvs(run_dir, per_video)
    _append_global_ledger(_aggregate(runname, "DAVIS", per_video))
    return _rows(per_video)


def run_model_on_longdata_set(
    runname: str,
    model,
    dataset: LongVideoDataset,
    save_masks: bool = False,
    max_videos: Optional[int] = None,
    chunk: Optional[int] = None,
    batched=None,
) -> List[Dict]:
    """runner.py:127-223 — metrics only at annotated frame ids.
    `chunk`: see _eval_one_video; `batched`: see run_model_on_davis_set."""
    run_dir = _result_dir(runname)

    def _gts_of(info) -> List[Optional[np.ndarray]]:
        gts: List[Optional[np.ndarray]] = [None] * len(info["frames"])
        for i in info["test_ids"]:
            gts[i] = dataset.load_mask(info["name"], info["frames"][i])
        return gts

    infos = _infos(dataset, max_videos)
    if batched is not None:
        per_video = _run_batched_with_gt(batched, dataset, max_videos, gts_of=_gts_of,
                                         template_of=lambda info, gts: gts[info["test_ids"][0]])
    else:
        per_video = []
        for info in infos:
            video = info["name"]
            frames = dataset.load_frames(video, info["frames"])
            gts = _gts_of(info)
            template = gts[info["test_ids"][0]]
            vm = _eval_one_video(model, frames, template, gts, chunk=chunk)
            vm["video"] = video
            per_video.append(vm)
    if save_masks and is_writer():
        for vm, info in zip(per_video, infos):
            mask_dir = os.path.join(run_dir, "masks", info["name"])
            os.makedirs(mask_dir, exist_ok=True)
            for i in info["test_ids"]:
                save_palette_mask(
                    vm["masks"][i],
                    os.path.join(mask_dir, os.path.splitext(info["frames"][i])[0] + ".png"))
    _write_video_csvs(run_dir, per_video)
    _append_global_ledger(_aggregate(runname, "LongDataset", per_video))
    return _rows(per_video)


def run_model_on_longvos_set(
    runname: str,
    model,
    dataset: LongVideoDataset,
    max_videos: Optional[int] = None,
    batched=None,
    chunk: Optional[int] = None,
) -> None:
    """runner.py:226-284 — no metrics; masks saved for external evaluation.
    `chunk`: route propagation through generator_chunked (see
    _eval_one_video). `batched`: a BatchedGenerator; whole videos then
    spread over its mesh, one run per resolution (pass `chunk=` to the
    generator for chunked propagation; this function's `chunk` is then
    unused), the saved masks those of the sequential path."""
    run_dir = _result_dir(runname)
    infos = _infos(dataset, max_videos)

    def _save(info, masks) -> None:
        if not is_writer():
            return
        mask_dir = os.path.join(run_dir, "masks", info["name"])
        os.makedirs(mask_dir, exist_ok=True)
        for f, m in zip(info["frames"], masks):
            save_palette_mask(m, os.path.join(mask_dir, os.path.splitext(f)[0] + ".png"))

    if batched is not None:
        for group in _groups_by_resolution(dataset, infos).values():
            frames = [dataset.load_frames(i["name"], i["frames"]) for _, i in group]
            templates = [dataset.load_mask(i["name"], i["frames"][i["test_ids"][0]])
                         for _, i in group]
            for (_, info), res in zip(group, batched.run(frames, templates)):
                _save(info, res["masks"])
        return
    for info in infos:
        video = info["name"]
        frames = dataset.load_frames(video, info["frames"])
        template = dataset.load_mask(video, info["frames"][info["test_ids"][0]])
        model.xmem.clear_memory()
        if chunk:
            masks, _scores = model.generator_chunked(frames, template, chunk=chunk)
        else:
            masks, *_ = model.generator(frames, template)
        model.xmem.clear_memory()
        _save(info, masks)
