"""The port's benchmark (counterpart of the root `bench.py`, the JAX one):
DAVIS-480p frames per second on one card, XMem + SAM-HQ refinement.

    python -m vosesam_tpu_torch.bench        # on the card; raises without one

Prints ONE JSON line on stdout, the root bench's `_emit` keys
  {"metric": ..., "value": fps, "unit": "fps", ...extras}
and everything before it on stderr. The workload is the root bench's: 64
measured frames (rounded up to whole chunks) of `moving_frames` at
480x854, two objects seeded on frame 0, a warm-up of max(chunk, 1)
frames, the median of `BENCH_REPS` continued runs of the same rollout
(so it crosses the long-term consolidation boundary: checked at the end,
`lt_count > 0`, from 64 frames on), random weights from fixed seeds (no
checkpoint is needed). Extras:
  fps_median, fps_runs, lt_count;
  stage_ms_per_frame: encode, xmem and encode + refine, each timed
    standalone by `StageTimer` over the last chunk (non-additive: in the
    loop they overlap), with the loop's total beside them;
  encode_tflops: `encode_flops` (analytic, at the encode's token grid)
    over the encode's ms per frame; mfu_vs_peak: that over the card's bf16
    dense peak (`PEAK_BF16_TFLOPS`; an unknown card leaves it out and says
    so on stderr);
  interactive_ms: `set_image`, click-to-mask and single-frame track
    latency at K 1 (p50 / p95);
  inpaint_ms_per_window, inpaint_ms_per_output_frame: one E2FGVI-HQ window
    (T 15, 11 local, 240x432, fp32) through kernel B6;
  peak_memory_bytes (`device_memory_stats`), device (the card's name and
    power limit as nvidia-smi prints them).

The sensitivity rows (`run(sensitivity=True)`, which `main` passes), after
the rows above and their `peak_memory_bytes`:
  letterbox_fps, letterbox_fps_runs: the headline loop again on the same
    frames with the letterbox gear, `encode_letterbox_hw=(448, 896)` (28x56
    tokens against rect's 36x64). The root bench's `letterbox_vs_baseline`
    is left out: it divides by a 20 fps target set for another chip, as
    `vs_baseline` is;
  read_ms_at_occupancy: kernel B1's wrapper (`fused_memory_read_shared`,
    usage on) at the root bench's production shape (O 2, Q 1620, M 17 200,
    Ck 64, Cv 512, top-k 30, bf16), ms per call over 20 back-to-back calls
    at live_end = 1, 0.5 and 0.25 x M; read_device_ms_at_occupancy: on the
    card, per live_end the kernels' own device time and `get_similarity`'s
    (which the wrapper computes over all M), by torch.profiler;
  fps_by_objects: fps at O 1, 2, 4 and 8 objects (`multi_object_frames`),
    the headline's loop at max_objects = live_objects = O;
  soak: one long rollout at the production `MemoryConfig` (`soak`): fps
    windows, the analytic consolidation / eviction schedule held against
    the probed arena (a mismatch raises), a fresh-state control, the soak's
    own peak device bytes.

Env knobs (the root bench's, with its defaults): BENCH_SAM vit_h, BENCH_HQ 1,
BENCH_FRAMES 64, BENCH_REFINE 1, BENCH_CHUNK 8, BENCH_WIN_IMPL
xla_fused_bias, BENCH_FLASH 1, BENCH_RECT 1, BENCH_STAGES 1, BENCH_MAXOBJ 2,
BENCH_LIVE 2, BENCH_REPS 3, BENCH_FIXED_HW and BENCH_LETTERBOX_HW (HxW,
unset; the distorting and the letterbox encode), BENCH_EXTRAS 1,
BENCH_INPAINT 1, BENCH_INTERACTIVE 1, BENCH_OBJECTS 1, BENCH_SOAK 1,
BENCH_SOAK_FRAMES 1536. The stage table runs with refinement on and chunk >
1; the extras (interactive, inpaint, letterbox, corridor, objects) where
the root bench runs them: BENCH_EXTRAS 1, refinement on, chunk > 1, neither
fixed nor letterbox encode; the soak under the same condition with
BENCH_SOAK 1 in place of BENCH_EXTRAS.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vosesam_tpu_torch.config import (
    FrameworkConfig,
    InpainterConfig,
    MemoryConfig,
    RefinementConfig,
    SAMConfig,
    XMemConfig,
)
from vosesam_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from vosesam_tpu_torch.utils.profiling import StageTimer, device_memory_stats, sync

DEFAULTS = dict(BENCH_SAM="vit_h", BENCH_HQ="1", BENCH_FRAMES="64", BENCH_REFINE="1",
                BENCH_CHUNK="8", BENCH_WIN_IMPL="xla_fused_bias", BENCH_FLASH="1",
                BENCH_RECT="1", BENCH_STAGES="1", BENCH_MAXOBJ="2", BENCH_LIVE="2",
                BENCH_REPS="3", BENCH_INPAINT="1", BENCH_INTERACTIVE="1",
                BENCH_FIXED_HW="", BENCH_LETTERBOX_HW="", BENCH_EXTRAS="1",
                BENCH_OBJECTS="1", BENCH_SOAK="1", BENCH_SOAK_FRAMES="1536")
LETTERBOX_HW = (448, 896)    # the letterbox row's gear: 28x56 tokens at 480x854

# bf16 dense tensor-core peak by card name (TFLOP/s). H100 SXM5: NVIDIA's
# H100 datasheet, 1,979 TFLOP/s with sparsity, half of it dense.
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def moving_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """n synthetic 480p frames with two objects translating over textured
    noise — refinement sees real moving prompts, memory sees novel keys."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 255, (h, w, 3), np.uint8)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        y0 = 100 + 2 * i
        x0 = (150 + 5 * i) % (w - 360)
        f[y0:y0 + 220, x0:x0 + 350] = (220, 60, 60)
        y1 = (50 + 3 * i) % (h - 110)
        f[y1:y1 + 100, 600:750] = (60, 200, 220)
        out[i] = f
    return out


def seed_mask(h: int, w: int, max_objects: int) -> np.ndarray:
    """The two objects of `moving_frames` on frame 0, (max_objects, H, W)."""
    m = np.zeros((max_objects, h, w), np.float32)
    m[0, 100:320, 150:500] = 1.0
    m[1, 50:150, 600:750] = 1.0
    return m


# the object colours of `multi_object_frames`, one per object
_OBJ_COLORS = (
    (220, 60, 60), (60, 200, 220), (60, 220, 90), (230, 200, 50),
    (200, 60, 220), (240, 140, 40), (80, 90, 230), (160, 230, 160),
)


def tri(t: int, amp: int) -> int:
    """Triangle wave in [0, amp]: bounded periodic motion (linear motion
    walks objects off the frame past ~190 frames)."""
    m = t % (2 * amp)
    return amp - abs(amp - m)


def _anchor(k: int) -> Tuple[int, int]:
    return 30 + (k // 4) * 240, 20 + (k % 4) * 210


def multi_object_frames(n: int, h: int, w: int, o: int, seed: int = 0) -> np.ndarray:
    """n frames with `o` 120x160 rectangles on distinct periodic
    trajectories (grid-anchored, per-object velocities): the uniform object
    family of the object-count rows (DAVIS-17 and LVOS run up to ~8
    objects)."""
    if not 1 <= o <= 8:
        raise ValueError(f"multi_object_frames: 1 <= o <= 8, got {o}")
    r = np.random.default_rng(seed)
    base = r.integers(0, 255, (h, w, 3), np.uint8)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        for k in range(o):
            yb, xb = _anchor(k)
            y0 = yb + tri((2 + k % 3) * i, 60)
            x0 = xb + tri((3 + k % 2) * i, 40)
            f[y0:y0 + 120, x0:x0 + 160] = _OBJ_COLORS[k]
        out[i] = f
    return out


def multi_object_seed_mask(h: int, w: int, o: int, max_objects: int) -> np.ndarray:
    """Frame-0 masks of `multi_object_frames`' o objects, (max_objects, H, W)."""
    m = np.zeros((max_objects, h, w), np.float32)
    for k in range(o):
        yb, xb = _anchor(k)
        m[k, yb:yb + 120, xb:xb + 160] = 1.0
    return m


def soak_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """n frames with two objects on periodic (triangle-wave) trajectories
    that stay in the frame for any length of rollout (`moving_frames`
    walks object 0 off the bottom edge past ~190 frames)."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 255, (h, w, 3), np.uint8)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        y0 = 40 + tri(2 * i, 180)
        x0 = 10 + tri(5 * i, 470)
        f[y0:y0 + 220, x0:x0 + 350] = (220, 60, 60)
        y1 = 30 + tri(3 * i, 340)
        x1 = 560 + tri(2 * i, 140)
        f[y1:y1 + 100, x1:x1 + 150] = (60, 200, 220)
        out[i] = f
    return out


def soak_seed_mask(h: int, w: int, max_objects: int) -> np.ndarray:
    """The two objects of `soak_frames` on frame 0, (max_objects, H, W)."""
    m = np.zeros((max_objects, h, w), np.float32)
    m[0, 40:260, 10:360] = 1.0
    m[1, 30:130, 560:710] = 1.0
    return m


def knobs(env: Optional[Mapping[str, str]] = None) -> Dict[str, str]:
    env = os.environ if env is None else env
    return {k: env.get(k, v) for k, v in DEFAULTS.items()}


def _hw(value: str) -> Optional[Tuple[int, int]]:
    """"HxW" -> (H, W); "" -> None."""
    if not value:
        return None
    h, w = value.split("x")
    return int(h), int(w)


def make_cfg(k: Mapping[str, str]) -> FrameworkConfig:
    """The root bench's FrameworkConfig, bf16."""
    return FrameworkConfig(
        xmem=XMemConfig(max_objects=int(k["BENCH_MAXOBJ"])),
        memory=MemoryConfig(live_objects=int(k["BENCH_LIVE"]) or None),
        sam=SAMConfig(model_type=k["BENCH_SAM"], hq=k["BENCH_HQ"] == "1",
                      use_flash_attention=k["BENCH_FLASH"] == "1",
                      windowed_attention_impl=k["BENCH_WIN_IMPL"],
                      encode_rect=k["BENCH_RECT"] == "1",
                      encode_fixed_hw=_hw(k["BENCH_FIXED_HW"]),
                      encode_letterbox_hw=_hw(k["BENCH_LETTERBOX_HW"])),
        refinement=RefinementConfig(use_refinement=k["BENCH_REFINE"] == "1",
                                    mode="both_neg", optimized=True),
        dtype="bfloat16")


def encode_flops(scfg: SAMConfig, grid_hw: Tuple[int, int]) -> float:
    """FLOPs (2 per multiply-add) of one frame's `vit_encode` at a (gh, gw)
    token grid, counted from the algorithm: the patch embed; per block the
    qkv and proj products over its attention's tokens (a windowed block's
    padded windows), the MLP's over the grid's tokens, the rel-pos factors
    q·R_h and q·R_w, QK^T (with the h + w bias lanes the "xla_fused_bias"
    path adds to its contraction, on frames of more than one window) and
    PV; the neck's 1x1 and 3x3 convolutions. Norms, softmax, GELU and adds
    are not counted."""
    dim, depth, heads, global_idx = scfg.encoder_dims()
    hd = dim // heads
    gh, gw = grid_hw
    ws, p = scfg.window_size, scfg.patch_size
    n_glob = gh * gw
    n_win = math.ceil(gh / ws) * math.ceil(gw / ws)
    flops = 2 * n_glob * dim * 3 * p * p
    for i in range(depth):
        if i in global_idx:
            t, n, bh, bw, lanes = n_glob, n_glob, gh, gw, 0
        else:
            fused = scfg.windowed_attention_impl == "xla_fused_bias" and n_win > 1
            t, n, bh, bw = n_win * ws * ws, ws * ws, ws, ws
            lanes = bh + bw if fused else 0
        flops += 2 * t * dim * (3 * dim + dim) + 2 * n_glob * dim * 8 * dim
        flops += 2 * t * heads * hd * (bh + bw)
        flops += 2 * t * heads * n * (hd + lanes) + 2 * t * heads * n * hd
    flops += 2 * n_glob * dim * 256 + 2 * n_glob * 256 * 256 * 9
    return float(flops)


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={device.index or 0}"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _models(cfg: FrameworkConfig, refine: bool, dev: torch.device):
    from vosesam_tpu_torch.models.sam.predictor import sam_init
    from vosesam_tpu_torch.models.xmem.network import xmem_init

    net = xmem_init(cfg.xmem, seed=0, device=dev).eval()
    sam = sam_init(cfg.sam, seed=1, device=dev, dtype=torch_dtype(cfg.dtype)) if refine else None
    return net, sam


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _seeded(net, cfg: FrameworkConfig, frame: np.ndarray, seed: np.ndarray,
            dev: torch.device, n_live: Optional[int] = None):
    """A new tracker state with `seed`'s first `n_live` objects annotated on
    `frame` (default: as many as it has objects with any pixel)."""
    from vosesam_tpu_torch.inference import core, tracker

    o = cfg.xmem.max_objects
    state = core.init_tracker_state(cfg, frame.shape[:2], device=dev)
    if n_live is None:
        n_live = int((seed.reshape(o, -1) > 0).any(1).sum())
    valid = torch.arange(o, device=dev) < n_live
    state, *_ = tracker.track_first_frame(net, state, _upload(frame, dev), _upload(seed, dev),
                                          valid, cfg, paint=False)
    return state


def _finite_sum(acc: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """A running sum on the device: a NaN in any chunk's scores survives to
    the final check (an invalid object's -inf does not count)."""
    s = scores.float()
    return acc + torch.where(torch.isneginf(s), torch.zeros_like(s), s).sum()


def measure(cfg: FrameworkConfig, frames: np.ndarray, seed: np.ndarray, chunk: int,
            n_frames: int, stages: bool, reps: int, dev: torch.device,
            n_live: Optional[int] = None):
    """Run the measured tracking loop `reps` times, each continuing the same
    rollout; returns (fps per rep, lt_count, stage_info). `frames` holds
    1 + max(chunk, 1) + n_frames frames: the annotated one, the warm-up,
    the measured ones; `seed` and `n_live` seed the objects (`_seeded`).
    The stage table runs after the loop, on its state."""
    from vosesam_tpu_torch.inference import core, tracker
    from vosesam_tpu_torch.inference.chunked import track_chunk
    from vosesam_tpu_torch.inference.refinement import (
        masks_from_prob,
        refine_masks,
        xmem_object_scores,
    )
    from vosesam_tpu_torch.models.sam import predictor

    refine = cfg.refinement.use_refinement
    net, sam = _models(cfg, refine, dev)
    warm_n = max(chunk, 1)
    o = cfg.xmem.max_objects
    state = _seeded(net, cfg, frames[0], seed, dev, n_live)
    up = lambda a: _upload(a, dev)       # noqa: E731
    fin = torch.zeros((), device=dev)
    if chunk > 1:
        batches = [up(frames[1 + warm_n + i:1 + warm_n + i + chunk])
                   for i in range(0, n_frames, chunk)]
        state, idx, _, _ = track_chunk(net, sam, state, up(frames[1:1 + chunk]), cfg)
        sync(idx)
        fps_runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for fb in batches:
                state, idx, scores, _ = track_chunk(net, sam, state, fb, cfg)
                fin = _finite_sum(fin, scores)
            sync(idx)
            fps_runs.append(n_frames / (time.perf_counter() - t0))
    else:
        singles = [up(frames[1 + warm_n + i]) for i in range(n_frames)]
        state, idx, *_ = tracker.track_frame(net, sam, state, up(frames[1]), cfg, paint=False)
        sync(idx)
        fps_runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for f in singles:
                state, idx, _, scores, _, _ = tracker.track_frame(net, sam, state, f, cfg,
                                                                  paint=False)
                fin = _finite_sum(fin, scores)
            sync(idx)
            fps_runs.append(n_frames / (time.perf_counter() - t0))
    if not bool(torch.isfinite(fin)):
        raise RuntimeError("non-finite scores mid-run")
    lt_count = int(state.memory.long.key_valid.sum())
    if n_frames >= 64 and lt_count == 0:
        raise RuntimeError(f"LT consolidation never fired in {n_frames} frames: the bench is "
                           f"not measuring the long-form steady state")

    stage_info = {}
    if stages and refine and chunk > 1:
        fb = batches[-1]
        timer = StageTimer()
        for _ in range(3):
            with timer.stage("encode"):
                emb = predictor.encode_image(sam, fb, cfg.sam)
                timer.record(emb.embedding)
        norefine = FrameworkConfig(xmem=cfg.xmem, memory=cfg.memory, sam=cfg.sam,
                                   refinement=RefinementConfig(use_refinement=False),
                                   dtype=cfg.dtype)
        for _ in range(3):
            with timer.stage("xmem"):
                state, idx2, _, _ = track_chunk(net, None, state, fb, norefine)
                timer.record(idx2)
        # encode + refine alone, on the XMem outputs of one more chunk
        outs = []
        for f in fb:
            state, prob, lg = core.step(net, state, f, cfg)
            m, _ = masks_from_prob(prob, o)
            outs.append((m, lg[1:], xmem_object_scores(prob[1:]), state.memory.obj_valid))
        masks, logits, scores, valids = (torch.stack(t) for t in zip(*outs))
        for _ in range(3):
            with timer.stage("encode_refine"):
                emb = predictor.encode_image(sam, fb, cfg.sam)
                res = refine_masks(sam, emb, masks, logits, scores, valids, cfg)
                timer.record(res.indexed)
        ms = {k: v / chunk for k, v in timer.summary().items()}
        total = 1e3 / float(np.median(fps_runs))
        stage_info["stage_ms_per_frame"] = dict(ms, total=total)
        grid = tuple(emb.embedding.shape[1:3])
        tflops = encode_flops(cfg.sam, grid) / (ms["encode"] * 1e-3) / 1e12
        stage_info["encode_grid"] = list(grid)
        stage_info["encode_tflops"] = tflops
        log(f"# stage ms/frame @K={chunk} (standalone, non-additive): "
            f"encode={ms['encode']:.1f} xmem={ms['xmem']:.1f} "
            f"encode+refine={ms['encode_refine']:.1f} total={total:.1f}  lt_count={lt_count}")
    return fps_runs, lt_count, stage_info


def interactive_bench(cfg: FrameworkConfig, frames: np.ndarray, seed: np.ndarray,
                      dev: torch.device, n: int = 30) -> Dict[str, float]:
    """Steady-state K 1 interactive latency (the root bench's
    `_interactive_bench`): `set_image` of the template frame; one positive
    click with the embedding cached, the mask and painted frame downloaded
    (what the UI consumes); single-frame tracking with refinement, the
    indexed mask downloaded each frame. p50 / p95 over `n` iterations;
    `frames` holds n + 4 frames."""
    from vosesam_tpu_torch.inference import tracker
    from vosesam_tpu_torch.pipeline.interact import SamController

    h, w = frames.shape[1:3]
    net, sam = _models(cfg, True, dev)
    sc = SamController(sam, cfg.sam, device=dev)
    sc.set_image(frames[0])                                  # warm-up
    set_ms = []
    for i in range(n):
        t0 = time.perf_counter()
        sc.set_image(frames[i % 3])
        sync(sc.emb.embedding)
        set_ms.append((time.perf_counter() - t0) * 1e3)
    sc.set_image(frames[0])
    scale = np.array([w / 854.0, h / 480.0], np.float32)     # the root bench's clicks at 480x854
    lbl = np.array([1], np.int32)
    sc.first_frame_click(frames[0], np.array([[300.0, 200.0]], np.float32) * scale, lbl)
    click_ms = []
    for i in range(n):
        p = np.array([[150.0 + 5 * i, 150.0 + 3 * i]], np.float32) * scale
        t0 = time.perf_counter()
        sc.first_frame_click(frames[0], p, lbl)
        click_ms.append((time.perf_counter() - t0) * 1e3)

    state = _seeded(net, cfg, frames[0], seed, dev)
    for f in frames[1:4]:
        state, idx, *_ = tracker.track_frame(net, sam, state, _upload(f, dev), cfg, paint=False)
    idx.cpu()
    track_ms = []
    for f in frames[4:4 + n]:
        t0 = time.perf_counter()
        state, idx, *_ = tracker.track_frame(net, sam, state, _upload(f, dev), cfg, paint=False)
        idx.cpu()
        track_ms.append((time.perf_counter() - t0) * 1e3)

    def pct(xs, q):
        return float(np.percentile(xs, q))

    return {"set_image_ms_p50": pct(set_ms, 50), "set_image_ms_p95": pct(set_ms, 95),
            "click_to_mask_ms_p50": pct(click_ms, 50), "click_to_mask_ms_p95": pct(click_ms, 95),
            "track_frame_ms_p50": pct(track_ms, 50), "track_frame_ms_p95": pct(track_ms, 95)}


def inpaint_bench(dev: torch.device, cfg: InpainterConfig = InpainterConfig(),
                  t: int = 15, nl: int = 11, h: int = 240, w: int = 432,
                  reps: int = 3) -> Dict[str, float]:
    """One E2FGVI-HQ generator window at the app's inpaint setting (the root
    bench's `_inpaint_bench`: T 15, 11 local frames, 240x432, fp32): the
    median of `reps` calls. Per output frame divides by the
    `neighbor_stride` frames a window advances, not by T."""
    from vosesam_tpu_torch.models.e2fgvi import generator as G

    net = G.generator_init(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.rand((t, h, w, 3), generator=gen, device=dev) * 2.0 - 1.0
    with torch.no_grad():
        out = G.generator_forward(net, frames, nl, cfg)[0]
        sync(out)
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = G.generator_forward(net, frames, nl, cfg)[0]
            sync(out)
            runs.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("inpaint bench: non-finite output")
    ms = float(np.median(runs))
    return {"inpaint_ms_per_window": ms,
            "inpaint_ms_per_output_frame": ms / cfg.neighbor_stride}


def fps_by_objects(base_cfg: FrameworkConfig, h: int, w: int, chunk: int,
                   n_frames: int = 64, reps: int = 3,
                   device: DeviceLike = None) -> Dict[str, float]:
    """fps at O in {1, 2, 4, 8} moving objects (the root bench's
    `_fps_by_objects`): for each O the headline's measured loop (`measure`,
    the median of `reps` continued runs, `n_frames` rounded up to whole
    chunks) on `multi_object_frames`, with the object axis and the
    live-object hint sized to O, as the tracker sizes them per video."""
    dev = resolve_device(device)
    if chunk > 1:
        n_frames = -(-n_frames // chunk) * chunk
    out = {}
    for o in (1, 2, 4, 8):
        cfg = dataclasses.replace(
            base_cfg, xmem=dataclasses.replace(base_cfg.xmem, max_objects=o),
            memory=dataclasses.replace(base_cfg.memory, live_objects=o))
        frames = multi_object_frames(1 + max(chunk, 1) + n_frames, h, w, o)
        fps_runs, _, _ = measure(cfg, frames, multi_object_seed_mask(h, w, o, o), chunk,
                                 n_frames, False, reps, dev, n_live=o)
        out[str(o)] = float(np.median(fps_runs))
    return out


def read_occupancy_corridor(device: DeviceLike = None, o: int = 2, q: int = 1620,
                            m: int = 17200, ck: int = 64, cv: int = 512, top_k: int = 30,
                            calls: int = 20):
    """Kernel B1's wrapper (`fused_memory_read_shared`, usage on) at
    live_end = 1, 0.5 and 0.25 x M on seeded inputs (the root bench's
    `_read_occupancy_corridor`; its shapes are the production 480p read at
    O 2). Returns ({"live_<frac>": ms per call, the mean of `calls`
    back-to-back calls}, {"live_<frac>": {"kernel": ..., "get_similarity":
    ...}} device ms by torch.profiler, or None off the card). The wrapper
    computes `get_similarity`'s (Q, M) matrix over all M slots; the kernels
    read the slots below live_end."""
    from vosesam_tpu_torch.ops.kernels import memory_read as mr
    from vosesam_tpu_torch.ops.memory_attention import get_similarity

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    bf16 = torch.bfloat16
    mk = randn(m, ck).to(bf16)
    ms = 1.0 + torch.nn.functional.softplus(randn(m))
    mv = randn(o, m, cv).to(bf16)
    qk = randn(q, ck).to(bf16)
    qe = torch.sigmoid(randn(q, ck)).to(bf16)
    kv = torch.ones((m,), dtype=torch.bool, device=dev)
    wall, device_ms = {}, {}
    for frac in (1.0, 0.5, 0.25):
        le = int(m * frac)
        key = f"live_{frac:g}"

        def call(le=le):
            return mr.fused_memory_read_shared(mk, ms, qk, qe, mv, kv, top_k,
                                               return_usage=True, live_end=le)

        out, usage = call()
        if not bool(torch.isfinite(out).all() & torch.isfinite(usage).all()):
            raise RuntimeError(f"read corridor: non-finite read at {key}")
        t0 = time.perf_counter()
        for _ in range(calls):
            out, usage = call()
        sync(usage)
        wall[key] = (time.perf_counter() - t0) / calls * 1e3
        if dev.type == "cuda":
            from vosesam_tpu_torch.ops.kernels.ab import device_ms as profiled_ms

            sim, valid_u8 = mr.kernel_inputs(mk, ms, qk, qe, kv[None])
            device_ms[key] = {
                "kernel": profiled_ms(lambda le=le: mr._launch(
                    sim, valid_u8, mv, min(top_k, m), le, True, float(o), True)),
                "get_similarity": profiled_ms(lambda: get_similarity(mk, ms, qk, qe))}
    return wall, (device_ms or None)


def soak(cfg: FrameworkConfig, h: int, w: int, chunk: int, n_frames: int,
         objects: int = 2, device: DeviceLike = None) -> dict:
    """A long rollout at `cfg`'s memory config (the root bench's `_soak`; the
    production `MemoryConfig` keeps 1000 long-term elements, 128
    prototypes, top-k 30, a memory frame every 5), through the chunked
    driver: `soak_frames` (2 objects) or `multi_object_frames`.

    The memory schedule is deterministic (a memory frame every `mem_every`
    frames, `inference/core.py:step`), so the consolidation count is
    analytic: 1 + (adds - max_adds) * hw // (work capacity - min work) once
    the working memory first fills (`memory/manager.py:add_memory`); the
    eviction-overwrite cycles, consolidations that overwrite live long-term
    slots, are that less floor(long-term capacity / prototypes). Raises if
    the probed `work.count` differs from the analytic count, if the
    long-term memory does not saturate where it must, or if its keys never
    change between saturated probes while evictions are due.

    fps windows, chunk-aligned, at frames 56 ("frame_64"), 448
    ("frame_512") and the tail: each the median of 3 consecutive 64-frame
    runs (at least one chunk) of the continuing rollout, its frames staged
    on the device before the clock starts; a window that does not fit is
    left out. Probes every 16 chunks and after each window: the frame
    index, `work.count`, the valid long-term slots, the sum of |long-term
    keys|, after a window the mask area. The fresh-state control replays
    the frame_64 window from a new state at the end of the run (drift of
    the card over the run against dependence on the state). The soak's own
    peak device bytes (the peak is reset at its start; None off the card)."""
    from vosesam_tpu_torch.inference.chunked import track_chunk

    dev = resolve_device(device)
    t_start = time.time()
    n_frames = -(-n_frames // chunk) * chunk
    o = cfg.xmem.max_objects
    if objects == 2:
        frames = soak_frames(1 + n_frames, h, w)
        seed = soak_seed_mask(h, w, o)
    else:
        frames = multi_object_frames(1 + n_frames, h, w, objects)
        seed = multi_object_seed_mask(h, w, objects, o)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    net, sam = _models(cfg, cfg.refinement.use_refinement, dev)
    state = _seeded(net, cfg, frames[0], seed, dev, n_live=objects)

    # the analytic memory schedule (held against the probes below)
    mem = cfg.memory
    hw_tok = (-(-h // 16)) * (-(-w // 16))
    cw, mw = mem.work_capacity(hw_tok), mem.min_work_elements(hw_tok)
    lt_cap = mem.max_long_term_elements
    p = min(mem.num_prototypes, cw - mw)
    adds = n_frames // mem.mem_every + 1                 # frames 0, 5, 10, ...
    max_adds = cw // hw_tok                              # the first fill
    consols = 0 if adds < max_adds else 1 + (adds - max_adds) * hw_tok // (cw - mw)
    evictions = max(0, consols - lt_cap // p)

    def probe(state, idx=None):
        d = {"ti": state.curr_ti, "work_count": int(state.memory.work.count),
             "lt_valid": int(state.memory.long.key_valid.sum()),
             "lt_keys_absum": float(state.memory.long.keys.float().abs().sum())}
        if idx is not None:
            d["mask_area"] = float((idx > 0).float().mean())
        return d

    def batch(c):
        return _upload(frames[1 + c * chunk:1 + (c + 1) * chunk], dev)

    fin = torch.zeros((), device=dev)
    reps, rep_c = 3, max(1, 64 // chunk)
    n_chunks = n_frames // chunk
    win_defs = []
    for label, start_f in (("frame_64", 56), ("frame_512", 448),
                           ("frame_tail", n_frames - reps * rep_c * chunk)):
        s_c, l_c = start_f // chunk, reps * rep_c
        if 0 <= s_c and s_c + l_c <= n_chunks and all(
                s_c + l_c <= ws or ws + wl <= s_c for ws, wl, _ in win_defs):
            win_defs.append((s_c, l_c, label))
    win_start = {s: (l, label) for s, l, label in win_defs}

    fps_windows, fps_window_runs, probes = {}, {}, []
    idx = None
    j = 0
    while j < n_chunks:
        if j in win_start:
            l_c, label = win_start[j]
            staged = [batch(j + c) for c in range(l_c)]
            sync(staged)
            runs = []
            for r in range(reps):
                t0 = time.perf_counter()
                for fb in staged[r * rep_c:(r + 1) * rep_c]:
                    state, idx, scores, _ = track_chunk(net, sam, state, fb, cfg)
                    fin = _finite_sum(fin, scores)
                sync(idx)
                runs.append(rep_c * chunk / (time.perf_counter() - t0))
            fps_windows[label] = float(np.median(runs))
            fps_window_runs[label] = runs
            j += l_c
            probes.append({"window": label, **probe(state, idx)})
        else:
            state, idx, scores, _ = track_chunk(net, sam, state, batch(j), cfg)
            fin = _finite_sum(fin, scores)
            j += 1
            if j % 16 == 0:
                probes.append(probe(state))
    if not bool(torch.isfinite(fin)):
        raise RuntimeError("soak: non-finite scores mid-run")
    final = probe(state, idx)
    probes.append(final)

    expect_count = adds * hw_tok - consols * (cw - mw)
    if final["work_count"] != expect_count:
        raise RuntimeError(
            f"soak: arena accounting broke: work.count {final['work_count']} != analytic "
            f"{expect_count} (adds {adds}, consolidations {consols})")
    if consols >= lt_cap // p + 1 and final["lt_valid"] != lt_cap:
        raise RuntimeError(f"soak: long-term memory never saturated: {final['lt_valid']} "
                           f"!= {lt_cap}")
    # eviction-overwrite must show: the long-term keys change between
    # saturated probes at different frames
    sat = [pr for pr in probes if pr["lt_valid"] == lt_cap]
    overwrites_seen = sum(1 for a, b in zip(sat, sat[1:])
                          if a["ti"] != b["ti"] and a["lt_keys_absum"] != b["lt_keys_absum"])
    if evictions > 0 and overwrites_seen == 0:
        raise RuntimeError(f"soak: long-term eviction-overwrite never observed despite "
                           f"{evictions} analytic eviction cycles")

    fps_fresh = None
    if "frame_64" in fps_windows:
        warm_c = 56 // chunk                 # warm up to the frame_64 window
        st2 = _seeded(net, cfg, frames[0], seed, dev, n_live=objects)
        for c in range(warm_c):
            st2, idx2, _, _ = track_chunk(net, sam, st2, batch(c), cfg)
        staged = [batch(warm_c + c) for c in range(rep_c)]
        sync(staged)
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            for fb in staged:
                st2, idx2, _, _ = track_chunk(net, sam, st2, fb, cfg)
            sync(idx2)
            runs.append(rep_c * chunk / (time.perf_counter() - t0))
        fps_fresh = float(np.median(runs))

    stats = device_memory_stats() if dev.type == "cuda" else None
    return {"frames": n_frames, "fps_windows": fps_windows,
            "fps_window_runs": fps_window_runs, "fps_fresh_control": fps_fresh,
            "lt_valid_final": final["lt_valid"], "consolidations": consols,
            "lt_eviction_cycles": evictions, "lt_overwrites_observed": overwrites_seen,
            "mask_area_final": final.get("mask_area"), "wall_s": time.time() - t_start,
            "peak_device_bytes": None if stats is None else stats["peak_bytes_in_use"]}


def run(env: Optional[Mapping[str, str]] = None, device: DeviceLike = None,
        cfg: Optional[FrameworkConfig] = None,
        frames_fn: Optional[Callable[[int], np.ndarray]] = None,
        seed: Optional[np.ndarray] = None, inpaint: Optional[dict] = None,
        interactive_n: int = 30, sensitivity: bool = False,
        objects_frames: int = 64) -> dict:
    """The bench's JSON line as a dict. Defaults are the root bench's
    workload; `cfg`, `frames_fn(n)` (n frames, (n, H, W, 3) uint8), `seed`
    ((max_objects, H, W)) and `inpaint` (`inpaint_bench`'s keywords)
    replace parts of it (the CPU tests run it small). `sensitivity` adds
    the letterbox row, the read corridor, the object-count rows
    (`objects_frames` measured frames a rep) and the soak, each under its
    knob, as `main` runs them."""
    dev = resolve_device(device)
    k = knobs(env)
    cfg = make_cfg(k) if cfg is None else cfg
    refine = cfg.refinement.use_refinement
    n_frames, chunk = int(k["BENCH_FRAMES"]), int(k["BENCH_CHUNK"])
    reps, stages = int(k["BENCH_REPS"]), k["BENCH_STAGES"] == "1"
    if chunk > 1:
        n_frames = -(-n_frames // chunk) * chunk
    frames_fn = frames_fn or (lambda n: moving_frames(n, 480, 854))
    frames = frames_fn(1 + max(chunk, 1) + n_frames)
    h, w = frames.shape[1:3]
    seed = seed_mask(h, w, cfg.xmem.max_objects) if seed is None else seed
    name = card(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        fps_runs, lt_count, stage_info = measure(cfg, frames, seed, chunk, n_frames, stages,
                                                 reps, dev)
    fps = float(np.median(fps_runs))
    extras = {"fps_median": fps, "fps_runs": fps_runs, "lt_count": lt_count}
    extras.update(stage_info)
    if "encode_tflops" in stage_info:
        peak = PEAK_BF16_TFLOPS.get(name.split(",")[0].strip())
        if peak is None:
            log(f"# no bf16 peak known for {name!r}: mfu_vs_peak left out")
        else:
            extras["mfu_vs_peak"] = stage_info["encode_tflops"] / peak
    # where the root bench runs its extras and its soak
    default_gear = (refine and chunk > 1 and cfg.sam.encode_fixed_hw is None
                    and cfg.sam.encode_letterbox_hw is None)
    with_extras = default_gear and k["BENCH_EXTRAS"] == "1"
    if with_extras:
        if k["BENCH_INTERACTIVE"] == "1":
            with torch.no_grad():
                extras["interactive_ms"] = interactive_bench(
                    cfg, frames_fn(interactive_n + 4), seed, dev, n=interactive_n)
        if k["BENCH_INPAINT"] == "1":
            extras.update(inpaint_bench(dev, **(inpaint or {})))
    stats = device_memory_stats() if dev.type == "cuda" else None
    extras["peak_memory_bytes"] = None if stats is None else stats["peak_bytes_in_use"]
    if sensitivity and with_extras:
        lb_cfg = dataclasses.replace(cfg, sam=dataclasses.replace(
            cfg.sam, encode_letterbox_hw=LETTERBOX_HW))
        with torch.no_grad():
            lb_runs, _, _ = measure(lb_cfg, frames, seed, chunk, n_frames, False, reps, dev)
        extras["letterbox_fps"] = float(np.median(lb_runs))
        extras["letterbox_fps_runs"] = lb_runs
        with torch.no_grad():
            (extras["read_ms_at_occupancy"],
             extras["read_device_ms_at_occupancy"]) = read_occupancy_corridor(dev)
        if k["BENCH_OBJECTS"] == "1":
            with torch.no_grad():
                extras["fps_by_objects"] = fps_by_objects(cfg, h, w, chunk, objects_frames,
                                                          reps, dev)
    if sensitivity and default_gear and k["BENCH_SOAK"] == "1":
        with torch.no_grad():
            extras["soak"] = soak(cfg, h, w, chunk, int(k["BENCH_SOAK_FRAMES"]), device=dev)
    extras["device"] = name
    label = (f"XMem+SAM{'-HQ' if cfg.sam.hq else ''} {cfg.sam.model_type}" if refine
             else "XMem-only")
    return {"metric": f"DAVIS {h}x{w} frames/sec/card ({label} refinement loop, "
                      f"{n_frames}-frame steady state)",
            "value": fps, "unit": "fps", **extras}


def main() -> int:
    print(json.dumps(run(sensitivity=True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
