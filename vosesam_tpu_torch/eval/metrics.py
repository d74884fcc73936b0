"""Evaluation metrics: J (region IoU), F (boundary), DAVIS statistics, AP
(port of `vosesam_tpu/eval/metrics.py`, the same numpy code).

Reference: tools/metrics.py + dataset/errorfunctions.py —
  - J: per-frame / per-object IoU with background excluded and labels taken
    from the GT frame (metrics.py:82-115);
  - F: DAVIS boundary measure — 1-px boundary maps (seg2bmap,
    errorfunctions.py:86-144), disk dilation with bound_th=0.008*diag,
    precision/recall of matched boundary pixels (errorfunctions.py:6-61);
  - db_statistics: mean / recall(>0.5) / decay(first-quartile minus
    last-quartile) (metrics.py:178-204);
  - detection-style AP: per-frame per-object TPs at IoU 0.5:0.05:0.95 with
    COCO size buckets 32²/96², confidence-sorted interpolated PR AUC
    (metrics.py:252-345).

Host-side NumPy like the reference (metrics run once per frame off the hot
path); the heavy boundary dilation uses a vectorized box-disk convolution
instead of cv2.disk structuring elements."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ----------------------------------------------------------------------- J

def calculate_iou(pred: np.ndarray, gt: np.ndarray) -> Dict[int, float]:
    """Per-object IoU for every non-background label present in GT
    (metrics.py:82-115). Returns {label: iou}."""
    out: Dict[int, float] = {}
    for label in np.unique(gt):
        if label == 0:
            continue
        p = pred == label
        g = gt == label
        union = np.logical_or(p, g).sum()
        inter = np.logical_and(p, g).sum()
        out[int(label)] = float(inter / union) if union > 0 else 1.0
    return out


def frame_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    """Overall foreground IoU of one frame."""
    p = pred > 0
    g = gt > 0
    union = np.logical_or(p, g).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(p, g).sum() / union)


# ----------------------------------------------------------------------- F

def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-px boundary map, bit-exact to the DAVIS/Martin kernel
    (errorfunctions.py:104-131): each pixel is compared against its E, S
    and SE neighbors (both sides of an edge become boundary); the last row
    keeps only the E comparison, the last column only the S comparison,
    and the bottom-right corner is always 0."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]

    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _disk_footprint(radius: float) -> np.ndarray:
    """skimage.morphology.disk, exact formula: grid offsets arange(-r, r+1)
    (half-integer offsets when r is non-integer), kept where x^2+y^2 <= r^2."""
    L = np.arange(-radius, radius + 1)
    X, Y = np.meshgrid(L, L)
    return (X * X + Y * Y) <= radius * radius


def _disk_dilate(mask: np.ndarray, radius: float) -> np.ndarray:
    """Binary dilation with the skimage disk structuring element
    (errorfunctions.py:30-31 uses skimage binary_dilation + disk)."""
    mask = mask.astype(bool)
    if radius < 1:
        return mask
    from scipy import ndimage

    return ndimage.binary_dilation(mask, structure=_disk_footprint(radius))


def db_eval_boundary(
    fg_mask: np.ndarray, gt_mask: np.ndarray, bound_th: float = 0.008
) -> float:
    """DAVIS boundary F-measure, exact to errorfunctions.py:6-61 including
    the bound_pix rule (bound_th taken verbatim when >= 1, else
    ceil(bound_th * diag)) and the one-empty-side precision/recall cases."""
    bound_pix = (
        bound_th if bound_th >= 1
        else float(np.ceil(bound_th * np.linalg.norm(fg_mask.shape)))
    )
    fg_b = seg2bmap(fg_mask)
    gt_b = seg2bmap(gt_mask)
    fg_dil = _disk_dilate(fg_b, bound_pix)
    gt_dil = _disk_dilate(gt_b, bound_pix)

    n_fg = fg_b.sum()
    n_gt = gt_b.sum()
    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = float((fg_b & gt_dil).sum() / n_fg)
        recall = float((gt_b & fg_dil).sum() / n_gt)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def compute_f_measure(pred: np.ndarray, gt: np.ndarray) -> Dict[int, float]:
    """Per-object boundary F (compute_real_f_measure, metrics.py:118-150)."""
    out: Dict[int, float] = {}
    for label in np.unique(gt):
        if label == 0:
            continue
        out[int(label)] = db_eval_boundary(pred == label, gt == label)
    return out


# ------------------------------------------------------------ statistics

def db_statistics(per_frame_values: np.ndarray) -> Tuple[float, float, float]:
    """(mean, recall, decay) over a metric trace (metrics.py:178-204):
    recall = fraction of frames above 0.5; decay = mean of first quartile
    minus mean of last quartile (first/last frames excluded)."""
    v = np.asarray(per_frame_values, np.float64)
    m = float(np.nanmean(v)) if v.size else 0.0
    recall = float(np.nanmean(v > 0.5)) if v.size else 0.0
    if v.size >= 4:
        ids = (np.round(np.linspace(1, len(v), 5) + 1e-10) - 1).astype(int)
        bins = [v[ids[i]: ids[i + 1] + 1] for i in range(4)]
        decay = float(np.nanmean(bins[0]) - np.nanmean(bins[3]))
    else:
        decay = 0.0
    return m, recall, decay


# ---------------------------------------------------------------------- AP

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
AREA_SMALL = 32 ** 2
AREA_MEDIUM = 96 ** 2


def true_positives(
    pred: np.ndarray, gt: np.ndarray, scores: Dict[int, float]
) -> List[dict]:
    """Per-object TP table for one frame at the COCO IoU thresholds with
    size buckets (metrics.py:264-318). Returns rows of
    {label, score, area_bucket, tp@t...}."""
    ious = calculate_iou(pred, gt)
    rows = []
    for label, iou in ious.items():
        area = int((gt == label).sum())
        bucket = (
            "small" if area < AREA_SMALL
            else "medium" if area < AREA_MEDIUM else "large"
        )
        row = {
            "label": label,
            "score": float(scores.get(label, 0.0)),
            "area": bucket,
        }
        for t in IOU_THRESHOLDS:
            row[f"tp_{t:.2f}"] = bool(iou >= t)
        rows.append(row)
    return rows


def compute_auc_interpolated(precision: np.ndarray, recall: np.ndarray) -> float:
    """Interpolated PR AUC (metrics.py:252-260): precision envelope
    integrated over recall."""
    if len(recall) == 0:
        return 0.0
    mrec = np.concatenate([[0.0], recall, [recall[-1]]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def compute_ap_for_rows(rows: List[dict], key: str) -> float:
    """Confidence-sorted AP for one TP column (compute_AP_for_df,
    metrics.py:321-335)."""
    if not rows:
        return 0.0
    order = sorted(rows, key=lambda r: -r["score"])
    tps = np.array([r[key] for r in order], np.float64)
    cum_tp = np.cumsum(tps)
    n = len(order)
    precision = cum_tp / np.arange(1, n + 1)
    total_pos = tps.sum()
    if total_pos == 0:
        return 0.0
    recall = cum_tp / total_pos
    return compute_auc_interpolated(precision, recall)


def calculate_video_AP(rows: List[dict]) -> Dict[str, float]:
    """AP, AP50, AP75, AP_small/medium/large over one video's TP table
    (metrics.py:338-345)."""
    aps = [compute_ap_for_rows(rows, f"tp_{t:.2f}") for t in IOU_THRESHOLDS]
    out = {
        "AP": float(np.mean(aps)) if aps else 0.0,
        "AP50": compute_ap_for_rows(rows, "tp_0.50"),
        "AP75": compute_ap_for_rows(rows, "tp_0.75"),
    }
    for bucket in ("small", "medium", "large"):
        sub = [r for r in rows if r["area"] == bucket]
        sub_aps = [compute_ap_for_rows(sub, f"tp_{t:.2f}") for t in IOU_THRESHOLDS]
        out[f"AP_{bucket}"] = float(np.mean(sub_aps)) if sub else float("nan")
    return out


# ------------------------------------------------------------ per-video

def compute_all_video_metrics(
    pred_masks: Sequence[np.ndarray],
    gt_masks: Sequence[Optional[np.ndarray]],
    skip_first: bool = True,
) -> Dict[str, object]:
    """Per-video J&F trace + aggregates (metrics.py:212-243). Frames with
    gt None are skipped (LongDataset sparse GT). Returns per-frame traces
    and db_statistics for J and F, overall and per-object."""
    j_trace, f_trace = [], []
    per_object: Dict[int, Dict[str, List[float]]] = {}
    start = 1 if skip_first else 0
    for i in range(start, len(pred_masks)):
        gt = gt_masks[i]
        if gt is None:
            continue
        pred = pred_masks[i]
        ious = calculate_iou(pred, gt)
        fs = compute_f_measure(pred, gt)
        if ious:
            j_trace.append(float(np.mean(list(ious.values()))))
            f_trace.append(float(np.mean(list(fs.values()))))
        for label in ious:
            rec = per_object.setdefault(label, {"J": [], "F": []})
            rec["J"].append(ious[label])
            rec["F"].append(fs[label])

    jm, jr, jd = db_statistics(np.array(j_trace))
    fm, fr, fd = db_statistics(np.array(f_trace))
    return {
        "J_mean": jm, "J_recall": jr, "J_decay": jd,
        "F_mean": fm, "F_recall": fr, "F_decay": fd,
        "JF_mean": (jm + fm) / 2,
        "J_trace": j_trace, "F_trace": f_trace,
        "per_object": {
            k: {
                "J_mean": float(np.mean(v["J"])),
                "F_mean": float(np.mean(v["F"])),
            }
            for k, v in per_object.items()
        },
    }
