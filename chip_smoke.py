#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vosesam_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --out build/chip_smoke.json   # also keep the results
    python3 chip_smoke.py --profile  # then profile steady frames as well

Phases (each one that fails exits non-zero):
  1. setup: print the card's name and power limit, build every CUDA kernel
     from the sources in the checkout (one nvcc per source, started
     together), turn TF32 off for the fp32 phases;
  2. kernel vs plain: the fused memory read in both modes (B1 shared
     validity, B2 per-object validity) at the DAVIS-480p production shapes
     (Q 1620, M 17 200, Ck 64, Cv 512, O 2, k 30, bf16 keys/values) and at
     the edge cases, held against the plain PyTorch version; two calls on
     the same inputs give bit-equal usage and readout; the kernels' device
     time on `get_similarity`'s matrix beside their byte bound, the plain
     chain on the same matrix, `get_similarity`'s own device time, and the
     whole wrapper's; each kernel's registers, shared memory and blocks per
     SM;
  2b. kernel vs plain for B3 (global attention with factorised rel-pos
     bias): vit_h's 16 heads, D 80, on the square (64x64), rect (36x64) and
     fixed (28x56) grids, B 1 and 8, bf16 and fp32, on the strided q / k / v
     views the encoder passes (equal to contiguous copies; bf16 views staged
     by TMA), plus edge cases (N not a multiple of 64, odd grid widths, D 64
     / 37 / 128 / 16, gh != gw, 3 heads, strided and contiguous, bf16 views
     TMA cannot describe, bad inputs raise); timings of the kernel (device
     time by torch.profiler, and CUDA events around one call and around 10
     back-to-back calls), the plain version and
     `scaled_dot_product_attention` with the materialised bias (a yardstick
     the port never calls), beside the bound; each instance's registers,
     shared memory and blocks per SM, and the grid's waves;
  2c. kernel vs plain for B4 / B5 (whole-window attention with factorised
     rel-pos bias, one kernel under both names): vit_h's 16 heads, 14x14
     windows, D 80, at the rect grid's 15 windows per frame and the square
     grid's 25, B 1 and 8, bf16 and fp32, on the strided q / k / v views the
     encoder passes, plus edge cases (5x9 and 7x7 windows, D 64 / 37 / 128,
     3 heads, one window, bad shapes raise; T 196, 45, 49, 64, 65 and 256
     cover a ragged last 64-key chunk and none); timings of the kernel, the
     plain version, B3's kernel at BH = W * heads and N 196 (the same
     function) and `scaled_dot_product_attention` with the dense bias, as
     device time from torch.profiler (one call is shorter than the host
     takes to launch it); each instance's registers, shared memory and
     blocks per SM;
  2d. kernel vs plain for B6 (modulated deformable 3x3 bilinear sampling):
     the inpainter's (1, 60, 108, 256) field with 16 deform groups and
     offsets of the model's form, `radius=None`, `radius=16` (every corner
     fits: equal to None) and a firing `radius=6`; the contracted
     convolution; B 2; Cin 32 / 64 / 8; integer and far-out-of-field
     offsets; bad inputs raise; torch.profiler device times beside the bound
     (no single PyTorch call computes the function);
  2g. (after 2d) B6's backward kernel against `deform_patches_backward_plain`
     at the trainer's (1, 60, 108, 256) field, 16 groups, offsets of the
     model's form, radius None / 16 (equal) / firing 6, flows of 9 and 20
     pixels, B 2, Cin 32 / 64 / 128 / 8, integer and far-out-of-field
     offsets: grad_offset and grad_mask bit-equal over two calls and within
     5e-5 of plain, grad_x (fp32 atomics) within 1e-4 per element and 1e-5
     of its norm; through the autograd Function; device times beside the
     bound (and in the log the previous design's, a PERF.md figure),
     occupancy;
  2e. kernel vs plain for B7 (the bin-scan probe) at the probe's shapes and
     small odd ones, then the probe's own run, counted from 0: the card's
     multiply-add rate in the scan and the scan's projected time per
     alignment call beside B6's;
  2f. each forward-only kernel entry point (B1, B2, B3, B4, B5, B7) raises
     under grad mode for an input that requires grad, B6 returns a result
     with a grad_fn, and all run under no_grad;
  3. XMem end to end: `TrackingAnything` (XMem-s012 widths, default
     MemoryConfig, bf16, no refinement) tracks a 64-frame 480x854 clip with
     two objects seeded on frame 0 and a third added on frame 40;
  4. XMem kernel vs plain end to end: 16 frames in fp32 twice, once through
     the kernels and once with `MemoryConfig(fused_read=False)`;
  4b. C24: the share of query rows whose top-k slots, as the memory-read
     kernels admit them from `get_similarity`'s matrix, differ from
     `topk_softmax` on the same matrix, at phase 2's shapes and over every
     read of phase 3's rollout: fails above 0.1%;
  5. the main path: XMem + SAM-HQ vit_h refinement (`both_neg`, point
     algorithm C, the 0.94 gate, rect encode, 2 objects, bf16): `generator`
     over 12 frames, `generator_chunked(chunk=8, paint=True)` over 25, and
     `generator` over 3 frames with the official square encode; B3 launches
     4 per refined frame / per chunk, no plain call; one frame's
     `encode_image` + `refine_masks` under `set_sync_debug_mode("error")`;
     then the same two rect runs with the window kernel selected
     (`windowed_attention_impl="pallas"` per frame, `"pallas_mh"` chunked):
     28 window launches + 4 B3 launches per refined frame / per chunk, no
     plain call, masks compared with the default-impl runs by agreement;
  6. refinement kernel vs plain end to end: the phase-5 config in fp32 over
     8 frames, through the kernels (`windowed_attention_impl="pallas"`) and
     through the plain versions (`SAMConfig(use_flash_attention=False,
     windowed_attention_impl="xla")`, `MemoryConfig(fused_read=False)`),
     then the same pair with the score gate off, so that SAM's masks are kept;
  7. the interactive entry points: `TrackingAnything` with SAM-HQ vit_h at
     the official square encode and the window kernel: `first_frame_click`
     with one positive click, then a positive-after-negative history (two
     passes), then `generate_masks(points_per_side=16)`; one encode per
     `set_image` (28 window + 4 B3 launches, no plain call); in fp32 the
     clicked mask against the same click through the plain versions.
  8. the inpaint path: `TrackingAnything(e2fgvi_checkpoint=...)` tracks a
     24-frame clip XMem-only, then `baseinpainter.inpaint(frames, masks,
     ratio=0.5)` (E2FGVI-HQ at full width, fp32, 240x426 flip-padded to
     240x432, the default `InpainterConfig`): 5 static windows, B6 launches
     = windows x 2 x (num_local - 1), no plain call, uint8 frames equal to
     the resized input outside the dilated mask, with cuDNN's TF32
     convolutions as a process that sets nothing runs them; the same clip
     with `window_batch=2` and with TF32 off; one window's
     `generator_forward` through the kernel and through the plain sampling
     (TF32 off); `inpaint` over 64 frames in two subsets at `num_blocks=2`.
  9. the evaluation harness: a synthetic tree at
     480x854 with PNG frames in a temporary directory, the entry points'
     models (XMem-s012 widths, SAM-HQ vit_h, square encode, bf16): DAVIS
     (2 videos of 16 frames) with `baseline` and `both_neg_C` per frame and
     `both_neg_C` chunk 8, LongDataset (24 frames, ground truth every 8th,
     `baseline`), LVOS (12 frames, masks saved) and OVIS (8 frames, RLE
     ground truth), `both_neg_C`; every CSV with the JAX columns and finite
     J / F / AP, saved palette PNGs equal to the generator's masks, chunked
     masks >= 99.9% equal to per-frame masks, B1 and B3 launched and no
     plain call; ms per frame per run on the host clock.
  10. serving: one model at the main path's full width (SAM-HQ vit_h, the
     phase-8 inpainter) behind `serve(model, port=0)`: /health, /segment
     (480x854 PNG, two clicks), /track over 12 frames with chunk 8 and 0,
     /inpaint of 10 frames at ratio 0.5, two concurrent /track requests
     (exactly one 503 with Retry-After), an unknown route (404); every
     response bit-equal to the same facade call; B1, B3 and B6 launched,
     no plain call; then one `AppSession` flow (template, two clicks,
     add_mask, track, inpaint): the frames change inside the dilated masks
     only; ms per request.
  11. the XMem trainer: the full-width recipe (XMem-s012, B 4, T 8, crop
     384, grad_accum 2, remat, fp32) on a synthetic 480x854 tree through
     `ClipSampler` for 5 steps with finite losses, ms per step and peak
     memory; two more steps with a `StageTimer` (data, forward, loss,
     backward, optimizer, ms per step); at toy dims with TF32 off, one step
     on the card against the same step on the CPU and grad_accum 2 against
     the full batch; a card checkpoint reloads.
  12. the E2FGVI GAN trainer: `InpainterConfig()` (E2FGVI-HQ, 8 focal
     blocks), T 8 (5 local + 3 non-local) at 240x432 from
     `InpaintClipSampler` on a synthetic 480x854 tree, remat, fp32 (TF32
     convolutions), offset heads randomised as in phase 8, 5 steps: finite
     losses, both networks move, u / v unit vectors, per step 16 B6 forward
     launches (the forward and remat's recompute) and 8 backward launches,
     no plain call; ms per step and peak memory; at toy dims with TF32
     off, one step's gradients on the card against the CPU's.
  13. multi-device at world size 1: an NCCL group, rank 0 of 1, through a
     file:// rendezvous in a temporary directory; (a) `BatchedGenerator`
     over two 480x854 videos of 12 and 9 frames with phase 9's `both_neg_C`
     model: masks >= 99.9% equal to the sequential tracker's per video
     (bit-equal expected), chunk 8 >= 99.9% equal to per frame, B1 and B3
     launched, no plain call; (b) the DAVIS runner with `batched=` on phase
     9's tree: masks >= 99.9% equal to phase 9's sequential run, J / F / AP
     columns equal where the masks are; (c) `TrackingAnything(inpaint_mesh=
     ...)` on phase 8's 24-frame clip at 240x432: within 1 grey level of the
     unsharded static path, the bit-equal share printed, B6 counted; (d)
     `sharded_memory_read_local` at phase 2's shapes: readout and usage
     within 1e-4 of the single read; (e) one DP XMem toy step: the batch's
     shard and the gradients' all-reduce bit-equal to their inputs, the
     step bit-equal to the non-DP step, both under
     torch.use_deterministic_algorithms (without it two steps on the card
     differ, logged); (f) the SAM encoder's tensor parallelism (SAM-HQ
     vit_h, rect 36x64 tokens, the window kernel): at model size 1 in this
     group the encode is bit-equal to the unsharded one; at model size 2,
     two ranks of a gloo group on this card (`run_ranks(...,
     backend="gloo")`): each encode 4 B3 and 28 B4 launches at 8 heads and
     no plain call, bf16 within TP_BF16_ATOL on TP_BF16_SHARE of the
     embedding, fp32 within TP_FP32_TOL, the decoder's masks >= 99.9%
     equal in fp32 and >= 99% in bf16 (phase 5's bf16 bound, C16), the
     wall ms of a model-2 encode beside the unsharded one; (g)
     the group destroyed, its time logged.
  14. the bench: `python -m vosesam_tpu_torch.bench` in this process
     (`bench.run` with the sensitivity rows, as its `main` runs it) at
     full width (vit_h SAM-HQ, rect, chunk 8, bf16, 480x854) and cut
     depth: BENCH_FRAMES=16 (3 reps, the default: the long-term memory
     fills in the second), 16 measured frames a rep in the object-count
     rows (O 1, 2, 4, 8), a soak of 448 frames at the production
     `MemoryConfig` (17 consolidations, 10 eviction cycles; its frame_64
     and tail windows, the fresh-state control); every other knob at its
     default and every row on (the stage table, `interactive_ms`, the
     inpaint window, the letterbox row, the read corridor of B1 at
     live_end 1 / 0.5 / 0.25 x M), TF32 convolutions as the bench runs
     alone: the line parses with every key, fps > 0, `lt_count` > 0,
     `mfu_vs_peak` in (0, 1], the letterbox row and four object rows > 0,
     the corridor finite with the kernel's and `get_similarity`'s device
     time, the soak's schedule and checks (it raises on a broken arena),
     B1, B3 and B6 launched and no plain call; kept in `--out`.
  15. the parity runner at full width, in a temporary directory:
     official-schema checkpoints from seeded modules (XMem-s012 widths,
     SAM vit_h, SAM-HQ vit_h) and a 480x854 synthetic tree (DAVIS 8
     frames a video, LongDataset 16, LVOS 8: depth cut, the loads of the
     checkpoints take most of the phase; the test_sample clip where
     imageio can write it, else config 2 is a SKIP row that says so);
     `python -m vosesam_tpu_torch.run_parity` in this process, sequential
     and `--chunk 8` (equal J, F and J&F), then `python -m
     vosesam_tpu_torch.checkpoint_day` in its own process (a verdict;
     phase A's J&F equal to the sequential rows'); B1 and B3 launched, no
     plain call; seconds of each run.
Kernel launch counts are set to 0 right before each main-path run (phases
3, 5, 7, 8, 9, 10, each step of 12, 13's runs, 14 and 15's runs; the
checkpoint-day processes record their own) and read right after;
the `kernels` line sums them (B7, a probe on no product path, counts its
own run in phase 2e; B6's backward counts phase 12's steps).
The last two lines are the `kernels` JSON line and the result line
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

BF16_TOL = 5e-3    # readout, bf16 keys/values (the JAX kernel tests' value)
BF16_FLOP_PER_S = 989e12
FP32_TOL = 1e-4    # readout, fp32 inputs
USAGE_REL = 1e-4   # usage, relative to the largest usage (fixed-order sums)


# registers, shared memory and resident blocks per SM of the redesigned
# kernels' instances, as the card reports them (kept in the --out record)
OCCUPANCY = {}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- the clip

def moving_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """n synthetic 480p frames with two objects translating over textured
    noise (the JAX package's bench.py:89 generator), plus a third moving
    rectangle that is annotated mid-video."""
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
        f[360:450, 40 + 4 * i:160 + 4 * i] = (60, 220, 90)
        out[i] = f
    return out


def seed_mask(h: int, w: int) -> np.ndarray:
    m = np.zeros((h, w), np.uint8)
    m[100:320, 150:500] = 1
    m[50:150, 600:750] = 2
    return m


def add_mask(h: int, w: int, i: int) -> np.ndarray:
    m = np.zeros((h, w), np.uint8)
    m[360:450, 40 + 4 * i:160 + 4 * i] = 3
    return m


# ------------------------------------------------------------------ helpers

def time_ms(torch, fn, reps: int = 25, warmup: int = 3, batch: int = 1) -> float:
    """Median CUDA-event time of one call, after warm-up. With `batch` > 1
    each event pair spans that many back-to-back calls and the time is per
    call: the host issues a call while the device runs the one before, so
    that reads the longer of the two, where a pair around one call reads
    their sum."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def device_ms(torch, fn, calls: int = 20, warmup: int = 3) -> float:
    """Device time of one call by torch.profiler over `calls` back-to-back
    calls (`ops/kernels/ab.py`'s reading, which survives the profiler's
    lost kernel records). For a call shorter than the host takes to launch
    it (the window kernel: tens of microseconds), where a CUDA-event pair
    around one call times the host."""
    from vosesam_tpu_torch.ops.kernels.ab import device_ms as profiled_ms

    return profiled_ms(fn, calls, warmup)


def softmax0(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=0, keepdims=True))
    return e / e.sum(axis=0, keepdims=True)


# ------------------------------------------------------------------- phases

def phase_setup(torch):
    from vosesam_tpu_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(card)
    t0 = time.time()
    logs = _build.build_all()
    log(f"[setup] built {sorted(_build.SOURCES)} in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[setup] {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def _read_case(torch, gen, o, m, q, ck, cv, dtype):
    dev = "cuda"
    return dict(
        mk=torch.randn((m, ck), generator=gen, device=dev).to(dtype),
        ms=1.0 + torch.randn((m,), generator=gen, device=dev) ** 2,
        qk=torch.randn((q, ck), generator=gen, device=dev).to(dtype),
        qe=torch.sigmoid(torch.randn((q, ck), generator=gen, device=dev)).to(dtype),
        mv=torch.randn((o, m, cv), generator=gen, device=dev).to(dtype),
    )


def _compare_read(torch, name, out, use, ref_out, ref_use, tol):
    """Kernel vs plain: readout at atol = rtol = tol, usage at USAGE_REL of
    the largest usage. Returns the two max abs errors."""
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite readout")
    err = (out - ref_out).abs().max().item() if out.numel() else 0.0
    check(torch.allclose(out, ref_out, atol=tol, rtol=tol),
          f"{name}: readout differs from plain (max abs err {err})")
    uerr = 0.0
    if use is not None and use.numel():
        uerr = (use - ref_use).abs().max().item()
        scale = max(1.0, ref_use.abs().max().item())
        check(uerr <= USAGE_REL * scale,
              f"{name}: usage differs from plain ({uerr} > {USAGE_REL} * {scale})")
    return err, uerr


def phase_kernels(torch):
    """Both modes at the production shapes, the edge cases at small shapes."""
    from vosesam_tpu_torch.ops.kernels import memory_read as mr
    from vosesam_tpu_torch.ops.memory_attention import get_similarity

    gen = torch.Generator(device="cuda").manual_seed(0)
    o, q, ck, cv, k = 2, 1620, 64, 512, 30
    nl, hw, frames = 1000, 1620, 10
    m = nl + frames * hw                                  # 17 200
    live_end = nl + 9 * hw                                # work arena 9/10 full
    case = _read_case(torch, gen, o, m, q, ck, cv, torch.bfloat16)
    slot = torch.arange(m, device="cuda")
    # B1: LT slots [800, 1000) still empty, work slots valid up to live_end
    shared_valid = (slot < live_end) & ~((slot >= 800) & (slot < nl))
    # B2: object 1 was added mid-video: LT and the last three work chunks
    per_obj_valid = torch.stack([slot < live_end,
                                 (slot < 800) | ((slot >= live_end - 3 * hw) & (slot < live_end))])

    results = []
    runs = {
        "fused_memory_read_shared": (
            lambda: mr.fused_memory_read_shared(**case, valid=shared_valid, top_k=k,
                                                return_usage=True, live_end=live_end),
            lambda: mr.fused_memory_read_shared_plain(**case, valid=shared_valid, top_k=k,
                                                      return_usage=True, live_end=live_end),
            shared_valid[None], live_end, "vosesam_tpu/ops/pallas/memory_read.py:262"),
        "fused_memory_read": (
            lambda: mr.fused_memory_read(**case, valid=per_obj_valid, top_k=k,
                                         return_usage=True),
            lambda: mr.fused_memory_read_plain(**case, valid=per_obj_valid, top_k=k,
                                               return_usage=True),
            per_obj_valid, m, "vosesam_tpu/ops/pallas/memory_read.py:382"),
    }
    for name, (kern, plain, valid_rows, live, replaces) in runs.items():
        # the kernel scans up to `live`; the bound counts only the columns
        # that hold a valid slot in some row
        need = int(valid_rows[:, :live].any(0).nonzero().max()) + 1
        out, use = kern()
        torch.cuda.synchronize()
        ref_out, ref_use = plain()
        err, uerr = _compare_read(torch, name, out, use, ref_out, ref_use, BF16_TOL)
        # determinism: the same inputs give bit-equal usage (and readout)
        out2, use2 = kern()
        check(torch.equal(use, use2) and torch.equal(out, out2),
              f"{name}: two calls on the same inputs differ")
        shared = name == "fused_memory_read_shared"
        scale = float(o) if shared else 1.0
        # the kernels on get_similarity's matrix (the JAX kernel's input),
        # and the plain chain on the same matrix: topk_softmax + readout
        sim, valid_u8 = mr.kernel_inputs(case["mk"], case["ms"], case["qk"], case["qe"],
                                          valid_rows)
        rows = valid_rows & (torch.arange(m, device="cuda") < live)
        kernel_fn = lambda: mr._launch(sim, valid_u8, case["mv"], k, live, shared,  # noqa: E731
                                       scale, True)
        plain_fn = lambda: _plain_on_sim(torch, sim, rows, case["mv"], k, shared)  # noqa: E731
        k_out, k_use = kernel_fn()
        p_out, p_use = plain_fn()
        _compare_read(torch, f"{name} on the matrix", k_out, k_use, p_out, p_use * scale,
                      BF16_TOL)
        device = device_ms(torch, kernel_fn, calls=10)
        plain_device = device_ms(torch, plain_fn, calls=5)
        sim_device = device_ms(torch, lambda: get_similarity(
            case["mk"], case["ms"], case["qk"], case["qe"]), calls=10)
        wrapper_device = device_ms(torch, kern, calls=10)
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain)
        # bound of the kernels: each input read once and each output
        # written once, over the slots this run's data needs: the matrix's
        # columns < need, their validity, the value rows of the slots some
        # row admits, the readout and the usage; operations: the readout of
        # the admitted slots (2 Cv per admitted (row, object, slot))
        adm = _admitted_sets(torch, sim, rows, k)
        n_admitted = int(adm.sum().item()) * (o if shared else 1)
        value_rows = int(adm.any(1).sum().item()) * (o if shared else 1)
        bytes_moved = (q * need * 4 + valid_rows.shape[0] * need + value_rows * cv * 2
                       + o * q * cv * 4 + m * 4)
        del adm, sim, valid_u8
        flops = 2 * n_admitted * cv
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        results.append(dict(
            name=name, route="cuda", source="vosesam_tpu_torch/csrc/memory_read.cu",
            replaces=replaces, max_abs_err=err, ms=device, plain_ms=plain_device,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes > t_ops else "operations",
            library_ms=None, get_similarity_ms=sim_device, wrapper_device_ms=wrapper_device,
            wrapper_event_ms=ms, plain_wrapper_event_ms=plain_ms, usage_max_abs_err=uerr,
            usage_bit_equal_across_calls=True, bound_slots=need,
            admitted_per_row=n_admitted / (o if shared else 1) / (q * valid_rows.shape[0]),
            value_rows_read=value_rows))
        log(f"[kernels] {name}: err {err:.3g} usage err {uerr:.3g} (two calls bit-equal) | "
            f"kernels on the matrix {device:.4f} ms device vs the plain chain on it "
            f"{plain_device:.4f}, bound {max(t_bytes, t_ops):.4f} ms ({results[-1]['bound_by']}); "
            f"get_similarity {sim_device:.4f} ms device; the wrapper {wrapper_device:.4f} ms "
            f"device, {ms:.3f} ms one call by events vs the plain wrapper {plain_ms:.3f}")
    OCCUPANCY["memory_read"] = {
        **{f"{kern} (bf16 values)": mr.occupancy(kern) for kern in mr.KERNELS},
        **{f"{kern} (fp32 values)": mr.occupancy(kern, torch.float32)
           for kern in ("select", "apply", "select_2", "apply_2", "finish")}}
    for inst, occ in OCCUPANCY["memory_read"].items():
        log(f"[kernels] occupancy {inst}: {json.dumps(occ)}")

    _edge_cases(torch, mr, gen)
    return results


def _admitted_sets(torch, sim, valid_rows, k: int):
    """(R, Q, M) bool: the slots `topk_softmax` admits for each validity row:
    valid and at least the k-th largest valid similarity of the query
    (duplicates counted)."""
    from vosesam_tpu_torch.ops.memory_attention import NEG_INF

    out = []
    for vr in valid_rows:
        masked = torch.where(vr[None], sim, torch.full((), NEG_INF, device=sim.device))
        kth = torch.topk(masked, min(k, sim.shape[-1]), dim=-1).values[:, -1:]
        out.append((masked >= kth) & vr[None])
    return torch.stack(out)


def _plain_on_sim(torch, sim, valid_rows, mv, k: int, shared: bool):
    """The plain chain on a given similarity: `topk_softmax` against each
    validity row, then the readout (every object against the one row in
    shared mode, object r against row r otherwise). Returns (out, usage)."""
    from vosesam_tpu_torch.ops.memory_attention import readout, topk_softmax

    if shared:
        aff, use = topk_softmax(sim, valid_rows[0], k, return_usage=True)
        return torch.stack([readout(aff, v) for v in mv]), use
    outs, usage = [], 0
    for r, vr in enumerate(valid_rows):
        aff, use = topk_softmax(sim, vr, k, return_usage=True)
        outs.append(readout(aff, mv[r]))
        usage = usage + use
    return torch.stack(outs), usage


def _edge_cases(torch, mr, gen):
    o, m, q, ck, cv = 3, 1100, 200, 64, 96
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        case = _read_case(torch, gen, o, m, q, ck, cv, dtype)
        slot = torch.arange(m, device="cuda")
        rnd = torch.rand((o, m), generator=gen, device="cuda") > 0.3
        few = torch.zeros(m, dtype=torch.bool, device="cuda")
        few[torch.tensor([3, 50, 700, 1099], device="cuda")] = True
        shared_cases = {
            "random": (rnd[0], None),
            "empty": (torch.zeros(m, dtype=torch.bool, device="cuda"), None),
            "live_end_0": (torch.zeros(m, dtype=torch.bool, device="cuda"), 0),
            "live_end_mid": (rnd[0] & (slot < 700), 700),
            "fewer_than_k": (few, None),
        }
        for label, (valid, live) in shared_cases.items():
            for drop in (False, True):        # ms=None and qe=None
                c = dict(case, ms=None, qe=None) if drop else case
                out, use = mr.fused_memory_read_shared(**c, valid=valid, top_k=16,
                                                       return_usage=True, live_end=live)
                torch.cuda.synchronize()
                ref = mr.fused_memory_read_shared_plain(**c, valid=valid, top_k=16,
                                                        return_usage=True, live_end=live)
                _compare_read(torch, f"B1 {label} {dtype} drop={drop}", out, use, *ref, tol)
                if label in ("empty", "live_end_0"):
                    check(not out.any() and not use.any(), f"B1 {label}: nonzero output")
        per_obj = rnd.clone()
        per_obj[1] = few
        per_obj[2] = False
        for drop in (False, True):
            c = dict(case, ms=None, qe=None) if drop else case
            out, use = mr.fused_memory_read(**c, valid=per_obj, top_k=16, return_usage=True)
            torch.cuda.synchronize()
            ref = mr.fused_memory_read_plain(**c, valid=per_obj, top_k=16, return_usage=True)
            _compare_read(torch, f"B2 {dtype} drop={drop}", out, use, *ref, tol)
            check(not out[2].any(), "B2: object without memory read out nonzero")
    for fn, valid in ((mr.fused_memory_read_shared, torch.ones(m, dtype=torch.bool, device="cuda")),
                      (mr.fused_memory_read, torch.ones((o, m), dtype=torch.bool, device="cuda"))):
        try:
            fn(**case, valid=valid, top_k=33)
        except ValueError:
            pass
        else:
            raise SmokeFailure(f"{fn.__name__}: top_k > 32 did not raise")
    log("[kernels] edge cases: empty, live_end 0 / mid, fewer than k valid, "
        "ms/qe None, fp32 + bf16, top_k > 32 raises: ok")


def _make_tracker(dtype: str, fused_read: bool = True):
    from vosesam_tpu_torch.config import FrameworkConfig, MemoryConfig, RefinementConfig
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

    cfg = FrameworkConfig(refinement=RefinementConfig(use_refinement=False),
                          memory=MemoryConfig(fused_read=fused_read), dtype=dtype)
    return TrackingAnything(cfg=cfg, device="cuda", seed=0)


def _drive(ta, frames, add_at: int, on_frame=None):
    h, w = frames.shape[1:3]
    outs = []
    for i, f in enumerate(frames):
        if i == 0:
            ann = seed_mask(h, w)
        elif i == add_at:
            ann = add_mask(h, w, i)
        else:
            ann = None
        t0 = time.perf_counter()
        outs.append(ta.xmem.track(f, ann))
        dt = time.perf_counter() - t0
        if on_frame is not None:
            on_frame(i, dt)
    return outs


def phase_end_to_end(torch, n_frames: int = 64, add_at: int = 40):
    from vosesam_tpu_torch.ops.kernels import memory_read as mr

    h, w = 480, 854
    frames = moving_frames(n_frames, h, w)
    ta = _make_tracker("bfloat16")
    torch.cuda.reset_peak_memory_stats()
    times = {}
    at_add = {}

    def on_frame(i, dt):
        times[i] = dt
        st = ta.xmem.state
        if i == add_at:
            at_add["b2"] = mr.COUNTS["fused_memory_read"]
            at_add["work"] = st.memory.work.count
        if i == 45:
            at_add["lt_valid_after_45"] = int(st.memory.long.key_valid.sum())

    mr.reset_counts()
    outs = _drive(ta, frames, add_at, on_frame)
    counts = dict(mr.COUNTS)
    log(f"[e2e] launches {counts}")
    for i, (mask, logits, painted, scores) in enumerate(outs):
        n_obj = 2 if i < add_at else 3
        check(mask.shape == (h, w) and mask.dtype == np.uint8, f"frame {i}: mask shape")
        check(logits.shape == (1 + n_obj, h, w), f"frame {i}: logits {logits.shape}")
        check(painted.shape == (h, w, 3), f"frame {i}: painted shape")
        check(bool(np.isfinite(logits).all()), f"frame {i}: non-finite logits")
        p = softmax0(logits.astype(np.float64))
        check(np.allclose(p.sum(0), 1.0, atol=1e-5), f"frame {i}: probabilities do not sum to 1")
    check(set(np.unique(outs[0][0]).tolist()) == {0, 1, 2}, "frame 0: seeded labels missing")
    check(3 in np.unique(outs[add_at][0]), "add frame: label 3 missing")
    check(counts["fused_memory_read_shared"] > 0, "B1 never launched on the main path")
    check(counts["fused_memory_read"] > 0, "B2 never launched on the main path")
    check(counts["plain"] == 0, "a plain read ran on the main path")
    b2_after = counts["fused_memory_read"] - at_add["b2"]
    check(b2_after == n_frames - add_at - 1 and at_add["work"] > 0,
          f"B2 after the add: {b2_after} launches, work count {at_add['work']}")
    check(at_add["lt_valid_after_45"] > 0, "no LT slot valid after frame 45")
    steady = [times[i] * 1e3 for i in range(10, add_at)]
    after = [times[i] * 1e3 for i in range(add_at + 1, n_frames) if i % 5]
    summary = dict(
        frames=n_frames, launches=counts,
        steady_ms_per_frame_b1=statistics.median(steady),
        steady_ms_per_frame_b2=statistics.median(after),
        mean_ms_per_frame=1e3 * sum(times.values()) / len(times),
        lt_valid_after_45=at_add.get("lt_valid_after_45"),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
    )
    log(f"[e2e] {json.dumps(summary)}")
    return counts, summary


def phase_kernel_vs_plain_rollout(torch, n_frames: int = 16, add_at: int = 8):
    """fp32, TF32 off: the same clip through the kernels and through the
    plain chain (`MemoryConfig(fused_read=False)`: `read_memory_multiobject`
    on the arena), which differ only in the readout's summation order.

    Frame 1 reads the memory frame 0 wrote, identical in both runs, so it
    tests one read: probabilities within 1e-2 everywhere. Later frames read
    memories that already differ by rounding, and under random weights the
    decoder's logits at 480p reach |z| ~ 1e3..1e4, so a pixel whose z sits
    near 0 can move by any amount; there the bounds are on shares: on every
    frame, probabilities within 1e-4 on >= 99.9% of the pixels and indexed
    masks >= 99.9% equal."""
    from vosesam_tpu_torch.ops.kernels import memory_read as mr

    h, w = 480, 854
    frames = moving_frames(n_frames, h, w)
    runs = {}
    for plain in (False, True):
        ta = _make_tracker("float32", fused_read=not plain)
        mr.reset_counts()
        runs[plain] = _drive(ta, frames, add_at)
        kernel_launches = mr.COUNTS["fused_memory_read_shared"] + mr.COUNTS["fused_memory_read"]
        if plain:
            check(kernel_launches == 0 and mr.COUNTS["plain"] == n_frames,
                  f"plain-chain run: {mr.COUNTS}")
        else:
            check(kernel_launches == n_frames and mr.COUNTS["plain"] == 0,
                  f"kernel run: {mr.COUNTS}")
        del ta
        torch.cuda.empty_cache()
    per_frame = []
    for i, (a, b) in enumerate(zip(runs[False], runs[True])):
        pa, pb = softmax0(a[1].astype(np.float64)), softmax0(b[1].astype(np.float64))
        d = np.abs(pa - pb)
        share = float((d <= 1e-4).mean())
        agree = float((a[0] == b[0]).mean())
        per_frame.append(dict(max_dprob=float(d.max()), share_1e4=share, mask_agree=agree))
        check(share >= 0.999, f"frame {i}: only {share} of probabilities within 1e-4")
        check(agree >= 0.999, f"frame {i}: mask agreement {agree}")
        if i == 1:
            check(d.max() <= 1e-2, f"frame 1: one read from equal memories moved "
                                   f"a probability by {d.max()}")
    summary = dict(frames=n_frames, frame1_max_dprob=per_frame[1]["max_dprob"],
                   worst_share_1e4=min(f["share_1e4"] for f in per_frame),
                   worst_mask_agree=min(f["mask_agree"] for f in per_frame),
                   max_dprob=max(f["max_dprob"] for f in per_frame))
    log(f"[rollout fp32] kernel vs plain: {json.dumps(summary)}")
    return dict(summary, per_frame=per_frame)


# ------------------- C24: the kernels select from get_similarity's matrix

C24_LIMIT = 1e-3   # share of query rows whose admitted slots may differ (ROADMAP C24)


def _kernel_admitted(torch, mr, call, r: int, q: int, m: int):
    """Run one fused read and return the slots its kernels admitted, (r, q,
    m) bool, and the (r, q) rows whose set is incomplete. The apply kernel
    leaves each (validity row, split, query, warp)'s last admitted entries
    in its scratch (`ecount` / `eslot`), and flags the lists that overflowed
    into a readout partial (`rflag`): those rows are not counted. The
    scratch is read through the wrapper's `_workspace`, wrapped for this
    call only."""
    seen = {}
    make = mr._workspace

    def keep(dev, parts):
        seen.update(make(dev, parts))
        return seen

    mr._workspace = keep
    try:
        call()
    finally:
        mr._workspace = make
    torch.cuda.synchronize()
    ecount, eslot, rflag = seen["ecount"], seen["eslot"], seen["rflag"]
    entries = torch.arange(eslot.shape[-1], device="cuda") < ecount[..., None]
    ri, _, qi, _, _ = entries.nonzero(as_tuple=True)
    adm = torch.zeros((r, q, m), dtype=torch.bool, device="cuda")
    adm[ri, qi, eslot[entries].long()] = True
    overflow = rflag.bool().any(dim=3).any(dim=1)
    return adm, overflow


def _c24_read(torch, mr, shared: bool, mk, ms, qk, qe, mv, valid, k, live_end=None):
    """One read's counts of query rows: (compared, differing kernel vs
    plain, whose kernel set is incomplete)."""
    from vosesam_tpu_torch.ops.memory_attention import get_similarity

    m = mk.shape[0]
    q = qk.shape[0]
    if shared:
        valid_rows = valid[None]
        if live_end is not None:
            valid_rows = valid_rows & (torch.arange(m, device="cuda") < live_end)
        call = lambda: mr.fused_memory_read_shared(  # noqa: E731
            mk, ms, qk, qe, mv, valid, k, return_usage=True, live_end=live_end)
    else:
        valid_rows = valid
        call = lambda: mr.fused_memory_read(  # noqa: E731
            mk, ms, qk, qe, mv, valid, k, return_usage=True)
    adm, overflow = _kernel_admitted(torch, mr, call, valid_rows.shape[0], q, m)
    plain = _admitted_sets(torch, get_similarity(mk, ms, qk, qe), valid_rows, k)
    differ = (adm != plain).any(-1) & ~overflow
    return int((~overflow).sum()), int(differ.sum()), int(overflow.sum())


def phase_c24(torch, n_frames: int = 64, add_at: int = 40):
    """C24: the memory-read kernels stream `get_similarity`'s matrix, the
    one `topk_softmax` reads, so they admit the same top-k slots. The
    share of query rows whose admitted slots differ, at phase 2's shapes
    (B1 and B2) and over every read of phase 3's bf16 rollout, must stay
    within C24_LIMIT (ROADMAP C24); by construction it is 0 (only the
    tie collapse of C5 could break that, and continuous inputs make ties
    measure-zero)."""
    from vosesam_tpu_torch.ops.kernels import memory_read as mr

    gen = torch.Generator(device="cuda").manual_seed(0)
    o, q, ck, cv, k = 2, 1620, 64, 512, 30
    nl, hw = 1000, 1620
    m = nl + 10 * hw
    live_end = nl + 9 * hw
    case = _read_case(torch, gen, o, m, q, ck, cv, torch.bfloat16)
    slot = torch.arange(m, device="cuda")
    shared_valid = (slot < live_end) & ~((slot >= 800) & (slot < nl))
    per_obj_valid = torch.stack([slot < live_end,
                                 (slot < 800) | ((slot >= live_end - 3 * hw) & (slot < live_end))])
    args = [case[n] for n in ("mk", "ms", "qk", "qe", "mv")]
    res = {"B1 at phase 2's shape": _c24_read(torch, mr, True, *args, shared_valid, k, live_end),
           "B2 at phase 2's shape": _c24_read(torch, mr, False, *args, per_obj_valid, k)}

    rollout = [0, 0, 0]
    reads = {"shared": 0, "per_object": 0}
    shared_fn, per_obj_fn = mr.fused_memory_read_shared, mr.fused_memory_read

    def tally(r):
        for i, v in enumerate(r):
            rollout[i] += v

    def shared_spy(mk, ms, qk, qe, mv, valid, top_k, return_usage=False, live_end=None):
        mr.fused_memory_read_shared = shared_fn
        try:
            tally(_c24_read(torch, mr, True, mk, ms, qk, qe, mv, valid, top_k, live_end))
            reads["shared"] += 1
            return shared_fn(mk, ms, qk, qe, mv, valid, top_k, return_usage, live_end)
        finally:
            mr.fused_memory_read_shared = shared_spy

    def per_obj_spy(mk, ms, qk, qe, mv, valid, top_k, return_usage=False):
        mr.fused_memory_read = per_obj_fn
        try:
            tally(_c24_read(torch, mr, False, mk, ms, qk, qe, mv, valid, top_k))
            reads["per_object"] += 1
            return per_obj_fn(mk, ms, qk, qe, mv, valid, top_k, return_usage)
        finally:
            mr.fused_memory_read = per_obj_spy

    ta = _make_tracker("bfloat16")
    mr.fused_memory_read_shared, mr.fused_memory_read = shared_spy, per_obj_spy
    try:
        _drive(ta, moving_frames(n_frames, 480, 854), add_at)
    finally:
        mr.fused_memory_read_shared, mr.fused_memory_read = shared_fn, per_obj_fn
    del ta
    torch.cuda.empty_cache()
    check(reads["shared"] > 0 and reads["per_object"] > 0, f"C24: reads {reads}")
    res[f"phase 3's rollout ({n_frames} frames, {reads})"] = tuple(rollout)
    out = {}
    for name, (rows, differ, overflow) in res.items():
        share = differ / max(rows, 1)
        out[name] = dict(rows_compared=rows, rows_differing=differ, share=share,
                         rows_incomplete=overflow, limit=C24_LIMIT)
        log(f"[C24] {name}: {differ} of {rows} query rows admit other slots than "
            f"topk_softmax on get_similarity ({share:.3%}, limit {C24_LIMIT:.1%}; {overflow} "
            f"rows with an overflowed list not compared)")
    for name, r in out.items():
        check(r["rows_compared"] > 0 and r["rows_incomplete"] <= r["rows_compared"] // 100,
              f"C24: {name}: {r['rows_compared']} rows compared, {r['rows_incomplete']} not")
        check(r["share"] <= C24_LIMIT, f"C24: {name}: {r['rows_differing']} of "
                                       f"{r['rows_compared']} rows ({r['share']:.3%}) admit other "
                                       f"slots than topk_softmax, above {C24_LIMIT:.1%}")
    return out


# ------------------------------------------------------------- B3 (flash)

BF16_ATTN_TOL = 2e-2   # B3 output, bf16 q/k/v (bf16 probabilities in the AV product)
FP32_ATTN_TOL = 2e-3   # B3 output, fp32 (the JAX kernel test's value)
# Special-function results (exp2, log2, rcp, rsqrt, sin, cos) per SM per
# clock on compute capability 9.0: the CUDA C++ Programming Guide's table of
# arithmetic-instruction throughput. Only for the exp-floor estimate below,
# which is logged and kept in the --out record, never in the kernels line.
SFU_RESULTS_PER_SM_CLOCK = 16


def _exp_rate(torch):
    """Estimated exps per second: one MUFU.EX2 per `expf`, at this card's SM
    count and the maximum SM clock nvidia-smi reports for it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        mhz = float(smi.stdout.split()[0])
    except (IndexError, ValueError):
        return None, sms, None           # no clock reported: no estimate
    return sms * SFU_RESULTS_PER_SM_CLOCK * mhz * 1e6, sms, mhz


def _attn_case(torch, gen, b, heads, gh, gw, d, dtype, strided: bool = True):
    """q, k, v (B, heads, N, D) and the fp32 bias factors (B, heads, N, gh)
    and (B, heads, N, gw). `strided`: q, k, v are the views the encoder
    passes, slices of one (B, N, 3, heads, D) projection; else contiguous."""
    n = gh * gw

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    if strided:
        q, k, v = (x.transpose(1, 2) for x in rnd(b, n, 3, heads, d).to(dtype).unbind(2))
    else:
        q, k, v = (rnd(b, heads, n, d).to(dtype) for _ in range(3))
    return q, k, v, rnd(b, heads, n, gh), rnd(b, heads, n, gw)


def _attn_bound(bh, gh, gw, d, itemsize, flop_rate):
    n = gh * gw
    flops = 4 * bh * n * n * d
    bytes_moved = 4 * bh * n * d * itemsize + bh * n * (gh + gw) * 4
    t_ops = flops / flop_rate * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_flash_kernel(torch):
    """B3 against its plain version at the main path's shapes and the edge
    cases; CUDA-event times of kernel, plain and the SDPA yardstick."""
    import torch.nn.functional as F

    from vosesam_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    heads, d = 16, 80
    exp_rate, sms, mhz = _exp_rate(torch)
    log(f"[B3] exp-floor estimate: {sms} SMs x {SFU_RESULTS_PER_SM_CLOCK} per clock x "
        f"{mhz} MHz = {exp_rate} exps/s")
    cases = []
    for label, (gh, gw) in (("square", (64, 64)), ("rect", (36, 64)), ("fixed", (28, 56))):
        for b in (1, 8):
            for dtype, tol in ((torch.bfloat16, BF16_ATTN_TOL), (torch.float32, FP32_ATTN_TOL)):
                if label == "square" and b == 8 and dtype == torch.float32:
                    continue       # the plain fp32 scores would need 34 GB
                args = _attn_case(torch, gen, b, heads, gh, gw, d, dtype)
                out = fa.flash_attention_relpos(*args, (gh, gw))
                torch.cuda.synchronize()
                ref = fa.flash_attention_relpos_plain(*args, (gh, gw))
                err = (out.float() - ref.float()).abs().max().item()
                check(bool(torch.isfinite(out).all()), f"B3 {label} B{b}: non-finite output")
                check(err <= tol, f"B3 {label} B{b} {dtype}: max abs err {err} > {tol}")
                check(out.transpose(1, 2).reshape(b, gh * gw, heads * d).is_contiguous(),
                      f"B3 {label} B{b}: the output is not (B, N, heads * D) memory")
                # the encoder's strided views against contiguous copies: equal
                dense = fa.flash_attention_relpos(*(x.contiguous() for x in args), (gh, gw))
                check(torch.equal(dense, out),
                      f"B3 {label} B{b} {dtype}: strided and contiguous inputs differ")
                del dense
                row = dict(grid=label, gh=gh, gw=gw, batch=b, heads=heads, d=d,
                           dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol,
                           strided_equals_contiguous=True)
                if dtype == torch.bfloat16:
                    # the encoder's views reach shared memory by TMA
                    check(fa.uses_tma(*args[:3]), f"B3 {label} B{b}: the views do not take TMA")
                    q, k, v, bh_, bw_ = args
                    n = gh * gw
                    mask = (bh_[..., :, None] + bw_[..., None, :]).reshape(b, heads, n, n).to(dtype)
                    # device time by the profiler (a call is about as short as
                    # the host's issue of it); beside it the CUDA-event time of
                    # one call (device and host issue) and per call of 10
                    # back-to-back calls (the longer of the two)
                    kern = lambda: fa.flash_attention_relpos(*args, (gh, gw))  # noqa: E731
                    row["ms"] = device_ms(torch, kern)
                    row["event_ms"] = time_ms(torch, kern)
                    row["batched_ms"] = time_ms(torch, kern, batch=10)
                    row["plain_ms"] = time_ms(
                        torch, lambda: fa.flash_attention_relpos_plain(*args, (gh, gw)), reps=5)
                    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)  # noqa
                    row["library_ms"] = device_ms(torch, sdpa)
                    row["library_event_ms"] = time_ms(torch, sdpa)
                    del mask, kern, sdpa
                    row["bound_ms"], row["bound_by"] = _attn_bound(
                        b * heads, gh, gw, d, 2, BF16_FLOP_PER_S)
                    row["exp_floor_estimate_ms"] = (
                        b * heads * (gh * gw) ** 2 / exp_rate * 1e3 if exp_rate else None)
                    log(f"[B3] {label} B{b} bf16: err {err:.3g} | kernel {row['ms']:.4f} ms "
                        f"device (CUDA events: one call {row['event_ms']:.4f}, 10 back to back "
                        f"{row['batched_ms']:.4f}), plain {row['plain_ms']:.3f}, sdpa "
                        f"{row['library_ms']:.4f} device ({row['library_event_ms']:.4f} one "
                        f"call), bound "
                        f"{row['bound_ms']:.3f} ({row['bound_by']}), exp-floor estimate "
                        f"{row['exp_floor_estimate_ms']}")
                else:
                    row["ms"] = time_ms(torch, lambda: fa.flash_attention_relpos(*args, (gh, gw)),
                                        reps=5)
                    row["bound_ms"], row["bound_by"] = _attn_bound(
                        b * heads, gh, gw, d, 4, FP32_FLOP_PER_S)
                    log(f"[B3] {label} B{b} fp32: err {err:.3g} | kernel {row['ms']:.3f} ms, "
                        f"bound {row['bound_ms']:.3f}")
                cases.append(row)
                del args, out, ref
    # N 130 / 63 / 25 / 720 / 7 are not multiples of the 64-key tile (130,
    # 63, 25 and 7 have odd grid widths: key pairs straddle grid rows), 256
    # has no ragged tile
    for b, hd_, gh, gw, dd in ((1, 3, 10, 13, 64), (2, 3, 7, 9, 80), (1, 2, 5, 5, 37),
                               (1, 4, 16, 16, 128), (2, 8, 20, 36, 64), (1, 2, 1, 7, 16)):
        for dtype, tol in ((torch.bfloat16, BF16_ATTN_TOL), (torch.float32, FP32_ATTN_TOL)):
            for strided in (True, False):
                args = _attn_case(torch, gen, b, hd_, gh, gw, dd, dtype, strided)
                out = fa.flash_attention_relpos(*args, (gh, gw))
                torch.cuda.synchronize()
                err = (out.float() - fa.flash_attention_relpos_plain(*args, (gh, gw)).float()
                       ).abs().max().item()
                check(err <= tol, f"B3 edge B{b} h{hd_} {gh}x{gw} d{dd} {dtype} "
                                  f"strided={strided}: err {err}")
    # bf16 views TMA cannot describe take the kernel's plain loads: a head
    # axis of stride 0, and a base that is not 16-byte aligned (D 80)
    q, k, v, bh_, bw_ = _attn_case(torch, gen, 2, 1, 6, 11, 80, torch.bfloat16, False)
    wide = torch.randn(2, 3, 66, 88, generator=gen, device="cuda").to(torch.bfloat16)
    for what, qkv in (("stride-0 heads", [x.expand(2, 3, 66, 80) for x in (q, k, v)]),
                      ("unaligned", [wide[..., 1:81], wide[..., 3:83], wide[..., 5:85]])):
        args = (*qkv, *(x.expand(2, 3, 66, -1).contiguous() for x in (bh_, bw_)))
        check(not fa.uses_tma(*qkv), f"B3 {what}: TMA was planned for views it cannot take")
        err = (fa.flash_attention_relpos(*args, (6, 11)).float()
               - fa.flash_attention_relpos_plain(*args, (6, 11)).float()).abs().max().item()
        check(err <= BF16_ATTN_TOL, f"B3 {what} views: err {err}")
    q, k, v, bh_, bw_ = _attn_case(torch, gen, 1, 2, 4, 4, 16, torch.bfloat16, False)
    bad = {"k shape": (q, k[..., :10].contiguous(), v, bh_, bw_, (4, 4)),
           "grid": (q, k, v, bh_, bw_, (4, 5)),
           "bias dtype": (q, k, v, bh_.to(torch.bfloat16), bw_, (4, 4)),
           "q last axis": (torch.zeros_like(q).repeat(1, 1, 1, 2)[..., ::2], k, v, bh_, bw_,
                           (4, 4)),
           "q rank": (q[0], k[0], v[0], bh_[0], bw_[0], (4, 4))}
    for what, a in bad.items():
        try:
            fa.flash_attention_relpos(*a)
        except (ValueError, TypeError):
            pass
        else:
            raise SmokeFailure(f"B3: bad {what} did not raise")
    log("[B3] edge cases: N 130 / 63 / 25 / 256 / 720 / 7 (odd grid widths too), D 64 / 37 / "
        "128 / 16, gh != gw, 3 heads, strided and contiguous, stride-0 and unaligned bf16 views "
        "(plain loads), fp32 + bf16, bad inputs raise: ok")
    OCCUPANCY["flash_attention"] = {
        f"{dt} {label} D {dd}": fa.occupancy(getattr(torch, dt), g, dd)
        for label, g in (("rect", (36, 64)), ("square", (64, 64)))
        for dt in ("bfloat16", "float32") for dd in (64, 80, 128)}
    for inst, occ in OCCUPANCY["flash_attention"].items():
        log(f"[B3] occupancy {inst}: {json.dumps(occ)}")
    # the grid: blocks of 128 query rows, and waves over the card's SMs at
    # the occupancy the card reports for the instance
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in cases:
        if c["dtype"] == "bfloat16":
            per_sm = fa.occupancy(torch.bfloat16, (c["gh"], c["gw"]), d)["blocks_per_sm"]
            c["blocks"] = c["batch"] * heads * -(-(c["gh"] * c["gw"]) // 128)
            c["waves"] = c["blocks"] / (sms * per_sm)
            log(f"[B3] {c['grid']} B{c['batch']}: {c['blocks']} blocks, {per_sm} per SM, "
                f"{c['waves']:.2f} waves on {sms} SMs")
    per_frame = next(c for c in cases if c["grid"] == "rect" and c["batch"] == 1
                and c["dtype"] == "bfloat16")
    kernel = dict(name="flash_attention_relpos", route="cuda",
                  source="vosesam_tpu_torch/csrc/flash_attention.cu",
                  replaces="vosesam_tpu/ops/pallas/flash_attention.py:307",
                  max_abs_err=max(c["max_abs_err"] for c in cases if c["dtype"] == "bfloat16"),
                  ms=per_frame["ms"], plain_ms=per_frame["plain_ms"],
                  bound_ms=per_frame["bound_ms"], bound_by=per_frame["bound_by"],
                  library_ms=per_frame["library_ms"], event_ms=per_frame["event_ms"],
                  batched_ms=per_frame["batched_ms"], timed_by="torch.profiler device time",
                  blocks=per_frame["blocks"], waves=per_frame["waves"],
                  shape="rect 36x64, B 1, 16 heads, D 80, bf16, strided q/k/v")
    return kernel, cases


# ------------------------------------------------------ B4 / B5 (window)

def _window_case(torch, gen, w, heads, wh, ww, d, dtype, strided: bool = True):
    """q, k, v (W, heads, T, D) and the fp32 bias factors. `strided`: q, k, v
    are the views the encoder passes, slices of one (W, T, 3, heads, D)
    projection; else contiguous tensors."""
    t = wh * ww

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    if strided:
        q, k, v = (x.transpose(1, 2) for x in rnd(w, t, 3, heads, d).to(dtype).unbind(2))
    else:
        q, k, v = (rnd(w, heads, t, d).to(dtype) for _ in range(3))
    return q, k, v, rnd(w, heads, t, wh), rnd(w, heads, t, ww)


def _window_bound(w, heads, wh, ww, d, itemsize, flop_rate):
    t = wh * ww
    flops = 4 * w * heads * t * t * d
    bytes_moved = 4 * w * heads * t * d * itemsize + w * heads * t * (wh + ww) * 4
    t_ops = flops / flop_rate * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_window_kernel(torch):
    """B4 / B5 against their plain version at the main path's shapes and the
    edge cases; device times (torch.profiler) of the kernel, the plain
    version, B3's kernel on the same function and the SDPA yardstick."""
    import torch.nn.functional as F

    from vosesam_tpu_torch.ops.kernels import flash_attention as fa
    from vosesam_tpu_torch.ops.kernels import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(2)
    heads, wh, ww, d = 16, 14, 14, 80
    t = wh * ww
    cases = []
    for label, per_frame in (("rect", 15), ("square", 25)):
        for b in (1, 8):
            w = per_frame * b
            for dtype, tol in ((torch.bfloat16, BF16_ATTN_TOL), (torch.float32, FP32_ATTN_TOL)):
                args = _window_case(torch, gen, w, heads, wh, ww, d, dtype)
                out = wa.window_attention_relpos(*args, (wh, ww))
                out_mh = wa.window_attention_relpos_mh(*args, (wh, ww))
                torch.cuda.synchronize()
                ref = wa.window_attention_relpos_plain(*args, (wh, ww))
                err = (out.float() - ref.float()).abs().max().item()
                name = f"B4/B5 {label} B{b} {str(dtype).split('.')[-1]}"
                check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
                check(err <= tol, f"{name}: max abs err {err} > {tol}")
                check(torch.equal(out, out_mh), f"{name}: the two names disagree")
                check(out.transpose(1, 2).reshape(w, t, heads * d).is_contiguous(),
                      f"{name}: the output is not (W, T, heads * D) memory")
                bf16 = dtype == torch.bfloat16
                row = dict(grid=label, windows=w, batch=b, heads=heads, window=(wh, ww), d=d,
                           dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol)
                # device time by the profiler; beside it the CUDA-event time
                # of one call, which at these sizes is the host's launch time
                row["ms"] = device_ms(torch, lambda: wa.window_attention_relpos(*args, (wh, ww)),
                                      calls=20 if bf16 else 5)
                row["event_ms"] = time_ms(
                    torch, lambda: wa.window_attention_relpos(*args, (wh, ww)),
                    reps=25 if bf16 else 5)
                row["bound_ms"], row["bound_by"] = _window_bound(
                    w, heads, wh, ww, d, 2 if bf16 else 4,
                    BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)
                if bf16:
                    row["ms_mh"] = device_ms(
                        torch, lambda: wa.window_attention_relpos_mh(*args, (wh, ww)))
                    row["plain_ms"] = device_ms(
                        torch, lambda: wa.window_attention_relpos_plain(*args, (wh, ww)), calls=5)
                    # yardsticks on contiguous copies: B3's kernel computes the
                    # same function at BH = W * heads, N = 196; SDPA takes the
                    # dense bias as its mask
                    q, k, v, bh_, bw_ = (x.contiguous() for x in args)
                    row["ms_contiguous"] = device_ms(
                        torch, lambda: wa.window_attention_relpos(q, k, v, bh_, bw_, (wh, ww)))
                    b3 = fa.flash_attention_relpos(*args, (wh, ww))
                    torch.cuda.synchronize()
                    b3_err = (b3.float() - out.float()).abs().max().item()
                    check(b3_err <= tol, f"{name}: B3 at N 196 differs from B4 by {b3_err}")
                    row["b3_vs_b4_max_abs_err"] = b3_err
                    row["b3_at_n196_ms"] = device_ms(
                        torch, lambda: fa.flash_attention_relpos(*args, (wh, ww)))
                    mask = (bh_[..., :, None] + bw_[..., None, :]).reshape(w, heads, t, t).to(dtype)
                    row["library_ms"] = device_ms(
                        torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
                    del mask, b3
                    log(f"[B4/B5] {label} B{b} bf16 (W {w}): err {err:.3g} | kernel "
                        f"{row['ms']:.4f} ms device (as _mh {row['ms_mh']:.4f}, contiguous "
                        f"inputs {row['ms_contiguous']:.4f}; one call by CUDA events "
                        f"{row['event_ms']:.3f}), plain {row['plain_ms']:.3f}, B3 at N 196 "
                        f"{row['b3_at_n196_ms']:.4f}, sdpa {row['library_ms']:.4f}, bound "
                        f"{row['bound_ms']:.4f} ({row['bound_by']})")
                else:
                    log(f"[B4/B5] {label} B{b} fp32 (W {w}): err {err:.3g} | kernel "
                        f"{row['ms']:.3f} ms device, bound {row['bound_ms']:.4f}")
                cases.append(row)
                del args, out, out_mh, ref
    # the key chunks are 64 wide: T 196 (above) ends in a 4-key chunk; 5x9
    # and 7x7 are one ragged chunk; 8x8 and 16x16 have no ragged chunk; 5x13
    # ends in one key
    for w, hd_, ewh, eww, dd in ((3, 2, 5, 9, 64), (3, 4, 5, 9, 80), (2, 3, 7, 7, 37),
                                 (1, 3, 14, 14, 128), (2, 2, 16, 16, 64), (1, 1, 1, 1, 8),
                                 (2, 2, 8, 14, 72), (2, 3, 8, 8, 80), (2, 3, 5, 13, 80)):
        for dtype, tol in ((torch.bfloat16, BF16_ATTN_TOL), (torch.float32, FP32_ATTN_TOL)):
            for strided in (True, False):
                args = _window_case(torch, gen, w, hd_, ewh, eww, dd, dtype, strided)
                out = wa.window_attention_relpos_mh(*args, (ewh, eww))
                torch.cuda.synchronize()
                err = (out.float() - wa.window_attention_relpos_plain(*args, (ewh, eww)).float()
                       ).abs().max().item()
                check(err <= tol, f"B4/B5 edge W{w} h{hd_} {ewh}x{eww} d{dd} {dtype} "
                                  f"strided={strided}: err {err}")
    q, k, v, bh_, bw_ = _window_case(torch, gen, 2, 2, 4, 4, 16, torch.bfloat16, False)
    bad = {"k shape": (q, k[..., :10].contiguous(), v, bh_, bw_, (4, 4)),
           "window": (q, k, v, bh_, bw_, (4, 5)),
           "bias dtype": (q, k, v, bh_.to(torch.bfloat16), bw_, (4, 4)),
           "q last axis": (torch.zeros_like(q).repeat(1, 1, 1, 2)[..., ::2], k, v, bh_, bw_,
                           (4, 4)),
           "bias layout": (q, k, v, bh_.transpose(2, 3).contiguous().transpose(2, 3), bw_,
                           (4, 4))}
    for what, a in bad.items():
        try:
            wa.window_attention_relpos(*a)
        except (ValueError, TypeError):
            pass
        else:
            raise SmokeFailure(f"B4/B5: bad {what} did not raise")
    log("[B4/B5] edge cases: 5x9 / 7x7 / 16x16 / 8x14 / 8x8 / 5x13 / 1x1 windows, D 64 / 80 / "
        "37 / 128 / 72 / 8, 3 heads, one window, strided and contiguous, fp32 + bf16, bad inputs "
        "raise: ok")
    OCCUPANCY["window_attention"] = {
        f"{dt} D {dd}": wa.occupancy(getattr(torch, dt), (wh, ww), dd)
        for dt in ("bfloat16", "float32") for dd in (16, 32, 48, 64, 80, 96, 112, 128)}
    for inst, occ in OCCUPANCY["window_attention"].items():
        log(f"[B4/B5] occupancy 14x14 {inst}: {json.dumps(occ)}")
    per_frame = next(c for c in cases if c["grid"] == "rect" and c["batch"] == 1
                     and c["dtype"] == "bfloat16")
    worst = max(c["max_abs_err"] for c in cases if c["dtype"] == "bfloat16")
    common = dict(route="cuda", source="vosesam_tpu_torch/csrc/window_attention.cu",
                  max_abs_err=worst, plain_ms=per_frame["plain_ms"],
                  bound_ms=per_frame["bound_ms"], bound_by=per_frame["bound_by"],
                  library_ms=per_frame["library_ms"],
                  b3_at_n196_ms=per_frame["b3_at_n196_ms"],
                  event_ms=per_frame["event_ms"], timed_by="torch.profiler device time",
                  shape="rect: 15 windows of 14x14, 16 heads, D 80, bf16, strided q/k/v")
    kernels = [
        dict(name="window_attention_relpos",
             replaces="vosesam_tpu/ops/pallas/flash_attention.py:161", ms=per_frame["ms"],
             **common),
        dict(name="window_attention_relpos_mh",
             replaces="vosesam_tpu/ops/pallas/flash_attention.py:258", ms=per_frame["ms_mh"],
             **common)]
    return kernels, cases


# ------------------------------------------------ B6 (deformable sampling)

DEFORM_TOL = 2e-6        # patches, kernel vs plain (the JAX kernel test's value)
DEFORM_CONV_TOL = 2e-5   # the contracted convolution (the JAX tests' value)


def _deform_case(torch, gen, b, h, w, cin, g, flow_px, resid: float = 10.0):
    """Features, offsets of the model's form and modulation: a `resid`*tanh
    residual per (group, tap) plus one flow per pixel for each half of the
    groups, bounded by `flow_px` pixels, in mmcv's (G, 9, (y, x)) layout."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = rnd(b, h, w, cin)
    residual = resid * torch.tanh(rnd(b, h, w, g, 9, 2))
    flow = flow_px * torch.tanh(rnd(b, h, w, 2, 1, 1, 2)).expand(b, h, w, 2, g // 2, 9, 2)
    offset = (residual + flow.reshape(b, h, w, g, 9, 2)).reshape(b, h, w, 2 * g * 9)
    mask = torch.sigmoid(rnd(b, h, w, g * 9))
    return x, offset.contiguous(), mask


def _deform_bound(b, h, w, cin, g):
    """Each input read once, the patches written once; ~12 fp32 operations
    per output value (four corners times two weights, three adds, the
    modulation)."""
    bytes_moved = 4 * b * h * w * (cin + 3 * g * 9 + 9 * cin)
    flops = 12 * b * h * w * 9 * cin
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_deform_kernel(torch):
    """B6 against its plain version at the inpainter's shape (60x108x256,
    16 groups) with radius None, 16 (every corner fits: equal to None) and a
    firing 6, at B 2 and Cin 32 / 64, on integer and far-out-of-field
    offsets; the contracted convolution; bad inputs raise; device times."""
    from vosesam_tpu_torch.models.e2fgvi import modules as M
    from vosesam_tpu_torch.ops.kernels import deform_align as da

    gen = torch.Generator(device="cuda").manual_seed(4)
    h, w, cin, g = 60, 108, 256, 16
    cases = []

    def compare(name, x, off, msk, radius, tol=DEFORM_TOL):
        out = da.deform_patches_bounded(x, off, msk, radius)
        torch.cuda.synchronize()
        ref = da.deform_patches_plain(x, off, msk, radius)
        check(tuple(out.shape) == (*x.shape[:3], 9, x.shape[-1]) and out.dtype == torch.float32,
              f"B6 {name}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"B6 {name}: non-finite output")
        err = (out - ref).abs().max().item() if out.numel() else 0.0
        check(err <= tol, f"B6 {name}: max abs err {err} > {tol}")
        cases.append(dict(case=name, shape=list(x.shape), groups=msk.shape[-1] // 9,
                          radius=radius, max_abs_err=err, tol=tol))
        return out

    # the model's form: 10 tanh residual + flows of a few pixels
    x, off, msk = _deform_case(torch, gen, 1, h, w, cin, g, flow_px=4.0)
    out_none = compare("production radius None", x, off, msk, None)
    out_16 = compare("production radius 16", x, off, msk, 16)
    check(torch.equal(out_none, out_16),
          "B6: radius 16 differs from the unbounded function although every corner fits")
    # flows large enough that the drop rule fires
    xl, offl, mskl = _deform_case(torch, gen, 1, h, w, cin, g, flow_px=9.0)
    out_l = compare("large flows radius None", xl, offl, mskl, None)
    out_6 = compare("large flows radius 6", xl, offl, mskl, 6)
    dropped = float((out_l != out_6).float().mean())
    check(dropped > 0.01, f"B6: the drop rule of radius 6 fired on only {dropped} of the values")
    # the contracted convolution through the model's function
    weight = 0.05 * torch.randn((128, cin, 3, 3), generator=gen, device="cuda")
    bias = torch.randn((128,), generator=gen, device="cuda")
    wmat = weight.permute(2, 3, 1, 0).reshape(9 * cin, 128)
    conv_err = {}
    for radius, fn in ((None, M.modulated_deform_conv),
                       (6, lambda *a: M.modulated_deform_conv_bounded(*a, radius=6))):
        got = fn(xl, offl, mskl, weight, bias, g)
        want = torch.matmul(da.deform_patches_plain(xl, offl, mskl, radius).reshape(1, h, w, -1),
                            wmat) + bias
        conv_err[str(radius)] = (got - want).abs().max().item()
        check(tuple(got.shape) == (1, h, w, 128) and conv_err[str(radius)] <= DEFORM_CONV_TOL,
              f"B6 conv radius {radius}: max abs err {conv_err[str(radius)]} > {DEFORM_CONV_TOL}")
    # batch 2, narrow groups (scalar instance at cg 2, vector instance at cg 4), odd field
    compare("B 2", *_deform_case(torch, gen, 2, h, w, cin, g, 4.0), None)
    compare("B 2 radius 6", *_deform_case(torch, gen, 2, h, w, cin, g, 9.0), 6)
    compare("Cin 32 (cg 2)", *_deform_case(torch, gen, 1, 23, 37, 32, 16, 4.0), None)
    compare("Cin 64 (cg 4) radius 3", *_deform_case(torch, gen, 2, 23, 37, 64, 16, 4.0), 3)
    compare("G 2, Cin 8", *_deform_case(torch, gen, 1, 9, 11, 8, 2, 2.0), None)
    # integer offsets: every sample sits on a pixel, so floor() must pick the
    # same cell in kernel and plain, and the result is the shifted field
    xi, offi, mski = _deform_case(torch, gen, 1, h, w, cin, g, 0.0)
    offi = torch.round(offi / 2.0)
    out_i = compare("integer offsets", xi, offi, mski, None, tol=0.0)
    compare("integer offsets radius 3", xi, offi, mski, 3, tol=0.0)
    yy = torch.arange(h, device="cuda")[:, None, None, None]
    xx = torch.arange(w, device="cuda")[None, :, None, None]
    tap = torch.arange(9, device="cuda")
    o = offi.reshape(h, w, g, 9, 2).long()
    sy, sx = yy + o[..., 0] + tap // 3 - 1, xx + o[..., 1] + tap % 3 - 1
    inb = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    picked = xi[0].reshape(h, w, g, cin // g)[sy.clamp(0, h - 1), sx.clamp(0, w - 1),
                                              torch.arange(g, device="cuda")[:, None]]
    want_i = (picked * (inb.float() * mski.reshape(h, w, g, 9))[..., None]
              ).permute(0, 1, 3, 2, 4).reshape(1, h, w, 9, cin)
    check(torch.equal(out_i, want_i), "B6: integer offsets do not pick the shifted pixels")
    # far outside the field on every side: zeros
    for far in (-1000.0, 1000.0):
        out_f = compare(f"offsets {far}", x, off + far, msk, None, tol=0.0)
        check(not out_f.any(), f"B6: offsets {far} outside the field read non-zero")
    check(da.deform_patches_bounded(x[:0], off[:0], msk[:0]).shape == (0, h, w, 9, cin),
          "B6: empty batch")
    bad = {"x dtype": (x.half(), off, msk), "offset dtype": (x, off.double(), msk),
           "offset shape": (x, off[..., :-2], msk), "mask shape": (x, off, msk[..., :-1]),
           "groups": (x[..., :250], off, msk), "x rank": (x[0], off, msk),
           "devices": (x, off.cpu(), msk), "radius": (x, off, msk, -1)}
    # 2^31 patch values: broadcast views, so nothing that large is allocated
    huge = (x[:, :1, :1].expand(1, 1024, 1024, cin), off[:, :1, :1].expand(1, 1024, 1024, -1),
            msk[:, :1, :1].expand(1, 1024, 1024, -1))
    bad["32-bit indexing"] = huge
    for what, a in bad.items():
        try:
            da.deform_patches_bounded(*a)
        except (ValueError, TypeError):
            pass
        else:
            raise SmokeFailure(f"B6: bad {what} did not raise")
    log("[B6] radius None / 16 (equal) / firing 6, conv, B 2, Cin 32 / 64 / 8, integer and "
        f"far offsets, empty batch, bad inputs and 2^31 patch values raise: ok (drop rule "
        f"changed {dropped:.3f} of the values; conv err {conv_err})")
    OCCUPANCY["deform_align"] = {f"Cin {c}, G {gg}, vec {vv}": da.occupancy(c, gg, vv)
                                 for c, gg, vv in ((256, 16, 4), (256, 16, 1), (32, 16, 1))}
    for inst, occ in OCCUPANCY["deform_align"].items():
        log(f"[B6] occupancy {inst}: {json.dumps(occ)}")

    ms = device_ms(torch, lambda: da.deform_patches_bounded(x, off, msk))
    ms_r16 = device_ms(torch, lambda: da.deform_patches_bounded(x, off, msk, 16))
    event_ms = time_ms(torch, lambda: da.deform_patches_bounded(x, off, msk))
    plain_ms = device_ms(torch, lambda: da.deform_patches_plain(x, off, msk), calls=5)
    conv_ms = device_ms(torch, lambda: M.modulated_deform_conv(x, off, msk, weight, bias, g))
    bound_ms, bound_by = _deform_bound(1, h, w, cin, g)
    worst = max(c["max_abs_err"] for c in cases)
    log(f"[B6] 60x108x256, G 16: err {worst:.3g} | kernel {ms:.4f} ms device (radius 16 "
        f"{ms_r16:.4f}; one call by CUDA events {event_ms:.3f}), plain {plain_ms:.3f}, with the "
        f"matmul {conv_ms:.4f}, bound {bound_ms:.4f} ({bound_by}); no library call computes it")
    blocks = -(-h * w // da.pixels_per_block(cin, 4))
    kernel = dict(name="deform_patches_bounded", route="cuda",
                  source="vosesam_tpu_torch/csrc/deform_align.cu",
                  replaces="vosesam_tpu/ops/pallas/deform_align.py:210",
                  max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=None, ms_radius_16=ms_r16, event_ms=event_ms,
                  blocks=blocks, pixels_per_block=da.pixels_per_block(cin, 4),
                  conv_ms=conv_ms, conv_max_abs_err=conv_err, drop_rule_share=dropped,
                  timed_by="torch.profiler device time",
                  shape="x (1, 60, 108, 256) fp32, 16 groups, radius None")
    da.reset_counts()
    return kernel, cases


# -------------------------------------- B6-bwd (the sampling's gradient)

# grad_offset / grad_mask, kernel vs plain: sums of cg products of O(1) in
# another order (the kernel walks the channels one by one, torch reduces
# them its own way), at most cg * 2^-24 * sum |terms| ~ 1e-5 at cg 16;
# 5x that
DEFORM_BWD_TOL = 5e-5
# grad_x, kernel vs plain: fp32 atomics add each pixel's ~36 contributions
# in an order that changes from call to call (and differs from the plain
# scatter's): per element, and over the norm of the plain gradient
DEFORM_BWD_X_TOL = 1e-4
DEFORM_BWD_X_REL = 1e-5


def _deform_bwd_bound(b, h, w, cin, g):
    """Each input read once (the patches' gradient, x, offsets, mask), the
    three gradients written once; ~40 fp32 operations per patch value (the
    blend recomputed, eight weight-gradient products and sums, the mask's,
    four corner gradients)."""
    bytes_moved = 4 * b * h * w * (9 * cin + cin + 3 * g * 9 + cin + 3 * g * 9)
    flops = 40 * b * h * w * 9 * cin
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# B6-bwd's device time at the production case in its previous design (a
# thread per sample walking the group's channels), a figure from PERF.md
# section 6's B6-bwd row (NVIDIA H100 80GB HBM3, 700 W): printed in the log
# beside this run's time, never in the kernels line (`ops.kernels.ab
# --against` measures the two designs in one run)
B6_BWD_PARENT_MS = 0.2551


def phase_deform_backward(torch):
    """B6's backward kernel against `deform_patches_backward_plain` (TF32
    off, as phase 1 set it) at the trainer's shape (1, 60, 108, 256), 16
    groups, offsets of the model's form, radius None / 16 (equal to None) /
    firing 6, flows of 9 and 20 pixels, B 2, Cin 32 / 64 / 8, integer and
    far-out-of-field offsets: grad_offset and grad_mask bit-equal over two
    calls and within DEFORM_BWD_TOL of plain, grad_x within DEFORM_BWD_X_TOL
    per element and DEFORM_BWD_X_REL of its norm; through the autograd
    Function; device times beside the bound (and, in the log, the previous
    design's time from PERF.md), and the occupancy."""
    from vosesam_tpu_torch.ops.kernels import deform_align as da

    gen = torch.Generator(device="cuda").manual_seed(13)
    h, w, cin, g = 60, 108, 256, 16
    cases = []

    def compare(name, x, off, msk, radius, gp=None):
        if gp is None:
            gp = torch.randn((*x.shape[:3], 9, x.shape[-1]), generator=gen, device="cuda")
        got = da._backward_kernel(gp, x, off, msk, radius)
        again = da._backward_kernel(gp, x, off, msk, radius)
        torch.cuda.synchronize()
        want = da.deform_patches_backward_plain(gp, x, off, msk, radius)
        for what, a, ref in zip(("grad_x", "grad_offset", "grad_mask"), got, want):
            check(a.shape == ref.shape and bool(torch.isfinite(a).all()),
                  f"B6-bwd {name}: {what} {tuple(a.shape)}, finite "
                  f"{bool(torch.isfinite(a).all())}")
        check(torch.equal(got[1], again[1]) and torch.equal(got[2], again[2]),
              f"B6-bwd {name}: grad_offset / grad_mask differ between two calls")
        err = {k: (a - ref).abs().max().item() if a.numel() else 0.0
               for k, a, ref in zip(("grad_x", "grad_offset", "grad_mask"), got, want)}
        norm = float(want[0].norm())
        x_rel = float((got[0] - want[0]).norm()) / max(norm, 1e-30)
        check(err["grad_offset"] <= DEFORM_BWD_TOL and err["grad_mask"] <= DEFORM_BWD_TOL,
              f"B6-bwd {name}: {err} > {DEFORM_BWD_TOL}")
        check(err["grad_x"] <= DEFORM_BWD_X_TOL and x_rel <= DEFORM_BWD_X_REL,
              f"B6-bwd {name}: grad_x err {err['grad_x']} (tol {DEFORM_BWD_X_TOL}), "
              f"{x_rel} of the norm (tol {DEFORM_BWD_X_REL})")
        cases.append(dict(case=name, shape=list(x.shape), groups=msk.shape[-1] // 9,
                          radius=radius, max_abs_err=err, grad_x_err_over_norm=x_rel,
                          grad_x_bitequal_over_two_calls=torch.equal(got[0], again[0])))
        return got

    x, off, msk = _deform_case(torch, gen, 1, h, w, cin, g, flow_px=4.0)
    gp = torch.randn((1, h, w, 9, cin), generator=gen, device="cuda")
    got_none = compare("production radius None", x, off, msk, None, gp)
    got_16 = compare("production radius 16", x, off, msk, 16, gp)
    check(torch.equal(got_none[1], got_16[1]) and torch.equal(got_none[2], got_16[2]),
          "B6-bwd: radius 16 differs from the unbounded gradient although every corner fits")
    xl, offl, mskl = _deform_case(torch, gen, 1, h, w, cin, g, flow_px=9.0)
    compare("large flows radius None", xl, offl, mskl, None)
    compare("large flows radius 6", xl, offl, mskl, 6)
    compare("flow 20", *_deform_case(torch, gen, 1, h, w, cin, g, 20.0), None)
    compare("B 2", *_deform_case(torch, gen, 2, h, w, cin, g, 4.0), None)
    compare("B 2 radius 6", *_deform_case(torch, gen, 2, h, w, cin, g, 9.0), 6)
    compare("Cin 32 (cg 2)", *_deform_case(torch, gen, 1, 23, 37, 32, 16, 4.0), None)
    compare("Cin 64 (cg 4) radius 3", *_deform_case(torch, gen, 2, 23, 37, 64, 16, 4.0), 3)
    compare("Cin 128 (cg 32), G 4", *_deform_case(torch, gen, 1, 23, 37, 128, 4, 4.0), None)
    compare("G 2, Cin 8", *_deform_case(torch, gen, 1, 9, 11, 8, 2, 2.0), None)
    xi, offi, mski = _deform_case(torch, gen, 1, h, w, cin, g, 0.0)
    offi = torch.round(offi / 2.0)
    compare("integer offsets", xi, offi, mski, None)
    compare("integer offsets radius 3", xi, offi, mski, 3)
    for far in (-1000.0, 1000.0):
        gx, _, gm = compare(f"offsets {far}", x, off + far, msk, None)
        check(not gx.any() and not gm.any(), f"B6-bwd: offsets {far} outside the field: "
                                             f"non-zero grad_x or grad_mask")
    # through autograd: the Function's backward is the kernel
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, off, msk)]
    da.reset_counts()
    out = da.deform_patches_bounded(*leaves)
    check(out.grad_fn is not None, "B6: no grad_fn under grad mode")
    gp = torch.randn(out.shape, generator=gen, device="cuda")
    out.backward(gp)
    counts = dict(da.COUNTS)
    check(counts["deform_patches_bounded"] == 1 and counts["deform_patches_backward"] == 1
          and counts["plain"] == 0 and counts["plain_backward"] == 0,
          f"B6 autograd: counts {counts}")
    want = da.deform_patches_backward_plain(gp, x, off, msk)
    for what, leaf, ref, tol in zip(("grad_x", "grad_offset", "grad_mask"), leaves, want,
                                    (DEFORM_BWD_X_TOL, DEFORM_BWD_TOL, DEFORM_BWD_TOL)):
        e = (leaf.grad - ref).abs().max().item()
        check(e <= tol, f"B6 autograd: {what} differs from the plain backward by {e}")
    worst = {k: max(c["max_abs_err"][k] for c in cases)
             for k in ("grad_x", "grad_offset", "grad_mask")}
    log(f"[B6-bwd] radius None / 16 (equal) / firing 6, flows 9 and 20, B 2, Cin 32 / 64 / "
        f"128 / 8, integer and far offsets, through autograd: ok; worst errors {worst}, "
        f"grad_x over its norm {max(c['grad_x_err_over_norm'] for c in cases):.3g}; grad_x "
        f"bit-equal over two calls in {sum(c['grad_x_bitequal_over_two_calls'] for c in cases)} "
        f"of {len(cases)} cases")
    OCCUPANCY["deform_align_backward"] = {
        "lanes cg 16": da.backward_occupancy(4, 16), "scalar cg 2": da.backward_occupancy(1, 2)}
    for inst, occ in OCCUPANCY["deform_align_backward"].items():
        log(f"[B6-bwd] occupancy {inst}: {json.dumps(occ)}")

    ms = device_ms(torch, lambda: da._backward_kernel(gp, x, off, msk, None))
    event_ms = time_ms(torch, lambda: da._backward_kernel(gp, x, off, msk, None))
    times = {"production": ms}
    for label, (xx, oo, mm) in (("large flows", (xl, offl, mskl)),):
        times[label] = device_ms(torch, lambda: da._backward_kernel(gp, xx, oo, mm, None))
    plain_ms = device_ms(torch, lambda: da.deform_patches_backward_plain(gp, x, off, msk),
                         calls=5)
    bound_ms, bound_by = _deform_bwd_bound(1, h, w, cin, g)
    log(f"[B6-bwd] 60x108x256, G 16: kernel {ms:.4f} ms device (grad_x's zero fill included; "
        f"one call by CUDA events {event_ms:.3f}; large flows {times['large flows']:.4f}), "
        f"plain {plain_ms:.3f}, bound {bound_ms:.4f} ({bound_by}), {bound_ms / ms:.1%} of it; "
        f"the previous design {B6_BWD_PARENT_MS} (a PERF.md figure, not this run's), "
        f"{B6_BWD_PARENT_MS / ms:.2f}x; no library call computes it")
    kernel = dict(name="deform_patches_backward", route="cuda",
                  source="vosesam_tpu_torch/csrc/deform_align.cu",
                  replaces="vosesam_tpu/ops/pallas/deform_align.py:210 (no TPU kernel: "
                           "JAX differentiates the gather form)",
                  max_abs_err=max(worst.values()), max_abs_err_by_output=worst, ms=ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                  event_ms=event_ms, timed_by="torch.profiler device time",
                  large_flows_ms=times["large flows"],
                  tolerances=dict(grad_offset_mask=DEFORM_BWD_TOL, grad_x=DEFORM_BWD_X_TOL,
                                  grad_x_over_norm=DEFORM_BWD_X_REL),
                  shape="x (1, 60, 108, 256) fp32, 16 groups, radius None")
    da.reset_counts()
    return kernel, cases


# ----------------------------------------------------- B7 (bin-scan probe)

BINSCAN_TOL = 1e-5   # fused multiply-adds against rounded products, <= 18 terms of O(1)


def phase_binscan_probe(torch):
    """B7 against its plain version at the probe's shapes (4 tiles of 512
    rows, 16 groups of 16 channels, 9 taps, 128 bins) and at small odd ones;
    then the probe itself (`binscan_probe.main`), counted from 0: the card's
    multiply-add rate in the scan and the scan's projected time for one
    alignment call beside the gather kernel's."""
    from vosesam_tpu_torch.ops.kernels import binscan_probe as bp

    gen = torch.Generator(device="cuda").manual_seed(5)
    x, y0, wy = bp.probe_inputs(gen)
    out = bp.binscan_probe(x, y0, wy, bp.BINS)
    torch.cuda.synchronize()
    ref = bp.binscan_probe_plain(x, y0, wy, bp.BINS)
    err = (out - ref).abs().max().item()
    check(tuple(out.shape) == (bp.N_TILES, bp.P_TILE, bp.GROUPS * bp.CG)
          and bool(torch.isfinite(out).all()), f"B7: output {tuple(out.shape)}")
    check(err <= BINSCAN_TOL, f"B7: max abs err {err} > {BINSCAN_TOL}")
    check(bool(out.any()), "B7: the scan selected nothing")
    # the kernel stages 32 shifts a window for blocks of 256 / G rows: 100
    # rows and 70 bins end in a 4-row block and a 6-shift window
    for p, bins, tiles, g, cg, taps in ((37, 11, 3, 4, 8, 5), (64, 1, 1, 16, 16, 9),
                                        (8, 40, 2, 3, 1, 2), (16, 0, 1, 2, 4, 9),
                                        (100, 70, 2, 16, 16, 9), (50, 33, 1, 8, 2, 3)):
        xs, ys, ws = bp.probe_inputs(gen, p, bins, tiles, g, cg, taps, pad=max(bins, 1))
        got = bp.binscan_probe(xs, ys, ws, bins, groups=g)
        torch.cuda.synchronize()
        e = (got - bp.binscan_probe_plain(xs, ys, ws, bins, groups=g)).abs().max().item()
        check(e <= BINSCAN_TOL, f"B7 edge P{p} bins{bins} G{g} cg{cg} taps{taps}: err {e}")
    bad = {"y0 dtype": (x, y0.long(), wy, bp.BINS), "x dtype": (x.half(), y0, wy, bp.BINS),
           "rows": (x[:, :bp.P_TILE + 10], y0, wy, bp.BINS), "wy shape": (x, y0, wy[:, :-1], bp.BINS),
           "channels per group": (x[..., :48].contiguous(), y0, wy, bp.BINS)}
    for what, a in bad.items():
        try:
            bp.binscan_probe(*a)
        except (ValueError, TypeError):
            pass
        else:
            raise SmokeFailure(f"B7: bad {what} did not raise")
    plain_ms = time_ms(torch, lambda: bp.binscan_probe_plain(x, y0, wy, bp.BINS), reps=3, warmup=1)
    device = device_ms(torch, lambda: bp.binscan_probe(x, y0, wy, bp.BINS))
    OCCUPANCY["binscan_probe"] = bp.occupancy()
    log(f"[B7] occupancy: {json.dumps(OCCUPANCY['binscan_probe'])}")
    # the probe's own entry point, its launches counted from 0
    bp.reset_counts()
    probe = bp.run_probe()
    launches = bp.COUNTS["binscan_probe"]
    check(launches > 0 and bp.COUNTS["plain"] == 0, f"B7: the probe's counts {bp.COUNTS}")
    for line in bp.report(probe):
        log(f"[B7] {line}")
    # bound: the dense scan's multiply-adds (2 operations each) at the fp32
    # rate; each input read once, the accumulators written once
    fma = bp.N_TILES * bp.P_TILE * bp.BINS * bp.GROUPS * bp.CG * bp.N_TAPS
    bytes_moved = 4 * (x.numel() + y0.numel() + wy.numel() + out.numel())
    t_ops = 2 * fma / FP32_FLOP_PER_S * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    log(f"[B7] err {err:.3g} | kernel {device:.4f} ms device ({bound / device:.1%} of the "
        f"bound; the probe's own reading {probe['ms']:.4f}, CUDA events over back-to-back "
        f"calls {probe['event_ms']:.4f}), plain {plain_ms:.1f} ms, bound {bound:.4f} ms; edge "
        f"shapes and bad inputs: ok")
    kernel = dict(name="binscan_probe", route="cuda",
                  source="vosesam_tpu_torch/csrc/binscan_probe.cu",
                  replaces="scripts/exp_vpu_binscan.py:36",
                  launches=launches, max_abs_err=err, ms=device, probe_ms=probe["ms"],
                  event_ms=probe["event_ms"], plain_ms=plain_ms, bound_ms=bound,
                  share_of_bound=bound / device,
                  bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None,
                  gfma_per_s=probe["gfma_per_s"], projected_align_ms=probe["projected_align_ms"],
                  gather_align_ms=probe["gather_align_ms"], on_main_path=False,
                  shape="x (4, 640, 256), fields (4, 512, 144), 128 bins, fp32")
    return kernel, probe


# ------------------------------------- C23: no gradient through a kernel

def phase_grad_refusal(torch):
    """B1-B5 and B7 compute forward passes only: on the card each must raise
    under grad mode for an input that requires grad (and run under
    torch.no_grad()), rather than return a result without a gradient. B6
    has a backward kernel: under grad mode it returns a result with a
    grad_fn."""
    from vosesam_tpu_torch.ops.kernels import binscan_probe as bp
    from vosesam_tpu_torch.ops.kernels import deform_align as da
    from vosesam_tpu_torch.ops.kernels import flash_attention as fa
    from vosesam_tpu_torch.ops.kernels import memory_read as mr
    from vosesam_tpu_torch.ops.kernels import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(6)
    read = _read_case(torch, gen, 2, 300, 40, 64, 32, torch.float32)
    valid = torch.ones(300, dtype=torch.bool, device="cuda")
    attn = _attn_case(torch, gen, 1, 2, 4, 4, 16, torch.float32, False)
    win = _window_case(torch, gen, 2, 2, 4, 4, 16, torch.float32, False)
    deform = _deform_case(torch, gen, 1, 5, 6, 32, 16, 1.0)
    probe = bp.probe_inputs(gen, 16, 4, 1, 2, 4, 9, pad=4)
    calls = {
        "fused_memory_read_shared": (lambda a: mr.fused_memory_read_shared(
            **a, valid=valid, top_k=8), read, "mk"),
        "fused_memory_read": (lambda a: mr.fused_memory_read(
            **a, valid=valid.expand(2, -1), top_k=8), read, "mv"),
        "flash_attention_relpos": (lambda a: fa.flash_attention_relpos(*a, (4, 4)), attn, 0),
        "window_attention_relpos": (lambda a: wa.window_attention_relpos(*a, (4, 4)), win, 2),
        "window_attention_relpos_mh": (lambda a: wa.window_attention_relpos_mh(*a, (4, 4)),
                                       win, 3),
        "deform_patches_bounded": (lambda a: da.deform_patches_bounded(*a), deform, 1),
        "binscan_probe": (lambda a: bp.binscan_probe(*a, 4, groups=2), probe, 0),
    }
    for name, (fn, args, which) in calls.items():
        leaf = args[which].detach().clone().requires_grad_(True)
        if isinstance(args, dict):
            with_grad = dict(args, **{which: leaf})
        else:
            with_grad = tuple(leaf if i == which else x for i, x in enumerate(args))
        if name == "deform_patches_bounded":
            out = fn(with_grad)
            check(out.grad_fn is not None and out.requires_grad,
                  "deform_patches_bounded: no grad_fn under grad mode")
        else:
            try:
                fn(with_grad)
            except RuntimeError as e:
                check("no backward" in str(e), f"{name}: raised {e!r}")
            else:
                raise SmokeFailure(f"{name}: returned a result without a gradient under "
                                   f"grad mode")
        with torch.no_grad():
            fn(with_grad)
    torch.cuda.synchronize()
    for mod in (bp, da, fa, mr, wa):
        mod.reset_counts()
    log(f"[C23] each of {len(calls) - 1} forward-only kernel entry points raises under grad "
        f"mode for an input that requires grad, B6 returns a result with a grad_fn, and all "
        f"{len(calls)} run under torch.no_grad(): ok")
    return sorted(calls)


# ------------------------------------------------- the main path (SAM-HQ)

def _main_cfg(dtype: str, rect: bool = True, kernels: bool = True, gate: bool = True,
              window_impl: str = "xla_fused_bias"):
    from vosesam_tpu_torch.config import (
        FrameworkConfig,
        MemoryConfig,
        RefinementConfig,
        SAMConfig,
        XMemConfig,
    )

    return FrameworkConfig(
        sam=SAMConfig(model_type="vit_h", hq=True, encode_rect=rect,
                      use_flash_attention=kernels, windowed_attention_impl=window_impl),
        refinement=RefinementConfig(mode="both_neg", point_algorithm="C", optimized=gate),
        xmem=XMemConfig(max_objects=2), memory=MemoryConfig(fused_read=kernels), dtype=dtype)


def _reset_all():
    from vosesam_tpu_torch.ops.kernels import flash_attention as fa
    from vosesam_tpu_torch.ops.kernels import memory_read as mr
    from vosesam_tpu_torch.ops.kernels import window_attention as wa

    fa.reset_counts()
    mr.reset_counts()
    wa.reset_counts()


def _read_all():
    from vosesam_tpu_torch.ops.kernels import flash_attention as fa
    from vosesam_tpu_torch.ops.kernels import memory_read as mr
    from vosesam_tpu_torch.ops.kernels import window_attention as wa

    return {"flash_attention_relpos": fa.COUNTS["flash_attention_relpos"],
            "window_attention_relpos": wa.COUNTS["window_attention_relpos"],
            "window_attention_relpos_mh": wa.COUNTS["window_attention_relpos_mh"],
            "fused_memory_read_shared": mr.COUNTS["fused_memory_read_shared"],
            "fused_memory_read": mr.COUNTS["fused_memory_read"],
            "plain": fa.COUNTS["plain"] + mr.COUNTS["plain"] + wa.COUNTS["plain"]}


WINDOWED_BLOCKS = 28   # vit_h: 32 blocks, 4 of them global
GLOBAL_BLOCKS = 4


def _check_outputs(masks, h, w, name):
    for i, m in enumerate(masks):
        check(m.shape == (h, w) and m.dtype == np.uint8, f"{name} frame {i}: mask {m.shape}")
        check(set(np.unique(m).tolist()) <= {0, 1, 2}, f"{name} frame {i}: labels "
                                                         f"{np.unique(m)}")
    check(set(np.unique(masks[0]).tolist()) == {0, 1, 2}, f"{name}: frame 0 labels")


def phase_main_path(torch, n_frames: int = 12, n_chunked: int = 25, n_square: int = 3):
    from vosesam_tpu_torch.inference import core
    from vosesam_tpu_torch.inference.refinement import masks_from_prob, refine_masks, \
        xmem_object_scores
    from vosesam_tpu_torch.models.sam import predictor
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

    h, w = 480, 854
    frames = list(moving_frames(max(n_frames, n_chunked), h, w, seed=3))
    seed = seed_mask(h, w)
    t0 = time.time()
    ta = TrackingAnything(cfg=_main_cfg("bfloat16"), device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    # warm-up (first-call costs of cuDNN, cuBLAS and the allocator), not counted
    ta.generator(frames[:3], seed)
    ta.xmem.clear_memory()
    ta.generator_chunked(frames[:9], seed, chunk=8)
    ta.xmem.clear_memory()
    runs = {}

    def run(name, ta, fn, n_refined, n_encodes, window_kernel=None):
        """Drive one main-path run from zeroed counts; `n_encodes` SAM
        encodes must each launch B3 once per global block and, with
        `window_kernel` named, that kernel once per windowed block."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_all()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _read_all()
        kept = ta.xmem.sam_kept
        check(kept is not None and tuple(kept.shape) == (2,), f"{name}: no refinement record")
        kept = kept.cpu().numpy()
        check(bool((kept <= n_refined).all()), f"{name}: kept counts {kept} > {n_refined} frames")
        check(counts["flash_attention_relpos"] == GLOBAL_BLOCKS * n_encodes,
              f"{name}: {counts['flash_attention_relpos']} B3 launches, expected "
              f"{GLOBAL_BLOCKS * n_encodes}")
        for wk in ("window_attention_relpos", "window_attention_relpos_mh"):
            want = WINDOWED_BLOCKS * n_encodes if wk == window_kernel else 0
            check(counts[wk] == want, f"{name}: {counts[wk]} {wk} launches, expected {want}")
        check(counts["plain"] == 0, f"{name}: {counts['plain']} plain calls on the main path")
        check(counts["fused_memory_read_shared"] > 0, f"{name}: B1 never launched")
        runs[name] = dict(frames=len(out[0]), launches=counts, wall_s=wall,
                          ms_per_frame=wall * 1e3 / len(out[0]),
                          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                          sam_kept_share=float(kept.sum()) / (2 * n_refined))
        log(f"[main] {name}: {json.dumps(runs[name])}")
        ta.xmem.clear_memory()
        return out

    masks, logits, painted, scores = run(
        "per_frame_rect", ta, lambda: ta.generator(frames[:n_frames], seed), n_frames - 1,
        n_frames - 1)
    _check_outputs(masks, h, w, "per-frame")
    check(all(lg.shape == (3, h, w) and np.isfinite(lg).all() for lg in logits),
          "per-frame: logits shape / finiteness")
    check(all(p.shape == (h, w, 3) for p in painted), "per-frame: painted shape")
    n_chunks = (n_chunked - 1) // 8
    cm, cp, cs = run("chunked_rect", ta, lambda: ta.generator_chunked(
        frames[:n_chunked], seed, chunk=8, paint=True), n_chunked - 1, n_chunks)
    check(len(cm) == len(cp) == n_chunked, "chunked: frame count")
    _check_outputs(cm, h, w, "chunked")
    agree = float(np.mean([(a == b).mean() for a, b in zip(cm[:n_frames], masks)]))
    runs["chunked_rect"]["mask_agreement_with_per_frame"] = agree
    log(f"[main] chunked vs per-frame masks over the first {n_frames} frames: {agree:.5f}")

    # sync check: one frame's encode + refinement issues no host sync
    ta.xmem.track(frames[0], seed)
    cfg = ta.xmem._track_cfg()
    st = ta.xmem.state
    ft = torch.from_numpy(frames[1]).to("cuda")
    st, prob, lg = core.step(ta.xmem_net, st, ft, cfg)
    m, _ = masks_from_prob(prob, 2)
    sc = xmem_object_scores(prob[1:])
    ov = st.memory.obj_valid
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        emb = predictor.encode_image(ta.sam, ft[None], cfg.sam)
        res = refine_masks(ta.sam, emb, m[None], lg[None, 1:], sc[None], ov[None], cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(res.indexed.shape == (1, h, w), "sync check: indexed shape")
    log("[main] encode_image + refine_masks under set_sync_debug_mode('error'): no sync")
    ta.xmem.clear_memory()
    del ta
    torch.cuda.empty_cache()

    # the same two runs through the window kernel, under each of its names
    def agreement(name, got, want):
        share = float(np.mean([(a == b).mean() for a, b in zip(got, want)]))
        runs[name]["mask_agreement_with_default_impl"] = share
        log(f"[main] {name} vs the default windowed impl: {share:.5f} of mask pixels equal")
        check(share >= 0.99, f"{name}: masks agree with the default impl on only {share}")

    pk = TrackingAnything(cfg=_main_cfg("bfloat16", window_impl="pallas"), device="cuda", seed=0)
    pk.generator(frames[:3], seed)
    pk.xmem.clear_memory()
    pm, _, _, _ = run("per_frame_rect_pallas", pk, lambda: pk.generator(frames[:n_frames], seed),
                      n_frames - 1, n_frames - 1, "window_attention_relpos")
    _check_outputs(pm, h, w, "per-frame pallas")
    agreement("per_frame_rect_pallas", pm, masks)
    del pk
    torch.cuda.empty_cache()
    mh = TrackingAnything(cfg=_main_cfg("bfloat16", window_impl="pallas_mh"), device="cuda",
                          seed=0)
    mh.generator_chunked(frames[:9], seed, chunk=8)
    mh.xmem.clear_memory()
    mm, mp, _ = run("chunked_rect_pallas_mh", mh, lambda: mh.generator_chunked(
        frames[:n_chunked], seed, chunk=8, paint=True), n_chunked - 1, n_chunks,
        "window_attention_relpos_mh")
    check(len(mm) == len(mp) == n_chunked, "chunked pallas_mh: frame count")
    _check_outputs(mm, h, w, "chunked pallas_mh")
    agreement("chunked_rect_pallas_mh", mm, cm)
    del mh
    torch.cuda.empty_cache()

    sq = TrackingAnything(cfg=_main_cfg("bfloat16", rect=False), device="cuda", seed=0)
    sq.generator(frames[:2], seed)
    sq.xmem.clear_memory()
    sm, _, _, _ = run("per_frame_square", sq, lambda: sq.generator(frames[:n_square], seed),
                      n_square - 1, n_square - 1)
    _check_outputs(sm, h, w, "square")
    del sq
    torch.cuda.empty_cache()
    return runs, init_s


# ------------------------------------------------ the evaluation harness (A9)

WHOLE_COLUMNS = ["J_mean", "J_recall", "J_decay", "F_mean", "F_recall", "F_decay", "JF_mean",
                 "AP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large", "fps", "video"]
PER_OBJECT_COLUMNS = ["video", "object", "J_mean", "F_mean"]
LEDGER_COLUMNS = ["run", "dataset", "JF_mean", "J_mean", "F_mean", "AP", "fps"]


def _read_csv(path):
    import csv

    check(os.path.exists(path), f"eval: {path} was not written")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def _check_run_csvs(run_dir, videos):
    """Check a run's CSVs; returns {video: the generator's ms per frame}
    (the runner's fps column: the generator alone, on the host clock)."""
    header, whole = _read_csv(os.path.join(run_dir, "whole_metrics.csv"))
    check(header == WHOLE_COLUMNS, f"eval: {run_dir} whole_metrics columns {header}")
    check([r["video"] for r in whole] == videos, f"eval: {run_dir} videos {whole}")
    for r in whole:
        for k in ("J_mean", "F_mean", "JF_mean", "AP"):
            check(np.isfinite(float(r[k])), f"eval: {run_dir} {r['video']} {k} = {r[k]!r}")
    header, rows = _read_csv(os.path.join(run_dir, "per_object_metrics.csv"))
    check(header == PER_OBJECT_COLUMNS and rows, f"eval: {run_dir} per-object {header}")
    for r in rows:
        check(np.isfinite(float(r["J_mean"])) and np.isfinite(float(r["F_mean"])),
              f"eval: {run_dir} per-object row {r}")
    return {r["video"]: 1e3 / float(r["fps"]) for r in whole}


def _keep_masks(ta, store):
    """Wrap the facade's generators so that each video's masks are kept as
    the harness received them."""
    gen, gen_chunked = ta.generator, ta.generator_chunked

    def generator(frames, template):
        out = gen(frames, template)
        store.append(out[0])
        return out

    def generator_chunked(frames, template, chunk=4):
        out = gen_chunked(frames, template, chunk=chunk)
        store.append(out[0])
        return out

    ta.generator, ta.generator_chunked = generator, generator_chunked


def _check_saved(run_dir, video, names, masks):
    from vosesam_tpu_torch.eval.palette import load_palette_mask

    for name, m in zip(names, masks):
        path = os.path.join(run_dir, "masks", video, os.path.splitext(name)[0] + ".png")
        check(os.path.exists(path), f"eval: {path} was not saved")
        check(np.array_equal(load_palette_mask(path), m),
              f"eval: {path} does not decode to the generator's mask")


def phase_eval(torch, n_frames: int = 16, long_frames: int = 24, long_every: int = 8,
               lvos_frames: int = 12, ovis_frames: int = 8, hw=(480, 854)):
    """The evaluation harness end to end on the card, in a temporary
    directory: a synthetic tree at 480 x 854 with PNG frames
    (`eval/synthetic.py`); the entry points' models (XMem-s012 widths,
    SAM-HQ vit_h at full width, the official square encode, bf16, seeded
    random weights); `run_model_on_davis_set` on 2 videos of `n_frames`
    (one object; two objects on frame 0) with `baseline` and `both_neg_C`
    per frame and `both_neg_C` with chunk 8; `run_model_on_longdata_set`
    (`baseline`, annotations every `long_every` frames);
    `run_model_on_longvos_set` and `run_model_on_ovis_set` (`both_neg_C`).
    Kernel counts are set to 0 before each run and read after it. Each run
    logs its wall ms per frame (reading frames, tracking, metrics, files)
    and the runner's own ms per frame of the generator alone, per video,
    on the host clock."""
    import tempfile

    from vosesam_tpu_torch.eval import codec, synthetic
    from vosesam_tpu_torch.eval.datasets import DavisDataset, LongVideoDataset
    from vosesam_tpu_torch.eval.ovis import OvisDataset, run_model_on_ovis_set
    from vosesam_tpu_torch.eval.runner import (
        run_model_on_davis_set,
        run_model_on_longdata_set,
        run_model_on_longvos_set,
    )
    from vosesam_tpu_torch.run_davis_test import CONFIGS, make_model

    h, w = hw
    here = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory(prefix="vosesam_eval_") as tmp:
        os.chdir(tmp)
        try:
            t0 = time.time()
            written = synthetic.write_tree("data", h, w, seed=7, davis_frames=n_frames,
                                           long_frames=long_frames, long_every=long_every,
                                           lvos_frames=lvos_frames, ovis_frames=ovis_frames)
            out["tree_s"] = time.time() - t0
            args = argparse.Namespace(sam_model_type="vit_h", hq=True, xmem_checkpoint=None,
                                      sam_checkpoint=None, device="cuda")
            t0 = time.time()
            models = {name: make_model(args, CONFIGS[name]) for name in ("baseline", "both_neg_C")}
            torch.cuda.synchronize()
            out["init_s"] = time.time() - t0
            davis = DavisDataset("data/DAVIS", "2017/val.txt")
            videos = list(davis.videos)
            check(videos == ["bear", "bike-packing"], f"eval: DAVIS videos {videos}")
            frames0 = davis.load_frames("bear", sorted(os.listdir(
                "data/DAVIS/JPEGImages/480p/bear"))[:3])
            check(frames0[0].shape == (h, w, 3), f"eval: frame {frames0[0].shape}")
            for ta in models.values():                  # first-call costs, not counted
                ta.generator(frames0, written["DAVIS/bear"][0])
                ta.xmem.clear_memory()
            models["both_neg_C"].generator_chunked(frames0, written["DAVIS/bear"][0], chunk=8)
            models["both_neg_C"].xmem.clear_memory()
            kept = {}
            for name, ta in models.items():
                kept[name] = []
                _keep_masks(ta, kept[name])
            runs = {}
            totals = {}

            def run(label, fn, n_frames_run):
                torch.cuda.synchronize()
                _reset_all()
                t = time.perf_counter()
                result = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                counts = _read_all()
                check(counts["plain"] == 0, f"eval {label}: {counts['plain']} plain calls")
                check(counts["fused_memory_read_shared"] > 0, f"eval {label}: B1 never launched")
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
                runs[label] = dict(frames=n_frames_run, wall_s=wall,
                                   ms_per_frame=wall * 1e3 / n_frames_run, launches=counts)
                log(f"[eval] {label}: {json.dumps(runs[label])}")
                return result

            def generator_ms(label, per_video):
                """The runner's own timing: the generator alone per video
                (ms_per_frame above adds frame reading, metrics, files)."""
                runs[label]["generator_ms_per_frame"] = per_video
                log(f"[eval] {label}: generator ms per frame {json.dumps(per_video)}")

            davis_frames = 2 * n_frames
            for label, name, chunk in (("davis_baseline", "baseline", None),
                                       ("davis_both_neg_C", "both_neg_C", None),
                                       ("davis_both_neg_C_chunk8", "both_neg_C", 8)):
                rows = run(label, lambda: run_model_on_davis_set(
                    label, models[name], davis, save_masks=True, chunk=chunk), davis_frames)
                if label == "davis_both_neg_C":      # phase 13 runs it batched
                    out["reference"] = dict(rows=rows, masks=kept[name][-2:], videos=videos)
                generator_ms(label, _check_run_csvs(os.path.join("result", label), videos))
                got = kept[name][-2:]
                for video, masks in zip(videos, got):
                    check(len(masks) == n_frames, f"eval {label} {video}: {len(masks)} masks")
                    _check_saved(os.path.join("result", label), video,
                                 sorted(os.listdir(f"data/DAVIS/JPEGImages/480p/{video}")), masks)
            check(runs["davis_both_neg_C"]["launches"]["flash_attention_relpos"] > 0
                  and runs["davis_both_neg_C_chunk8"]["launches"]["flash_attention_relpos"] > 0,
                  "eval: B3 never launched in the refined DAVIS runs")
            seq, chk = kept["both_neg_C"][0:2], kept["both_neg_C"][2:4]
            agree = min(float((a == b).mean()) for sv, cv in zip(seq, chk)
                        for a, b in zip(sv, cv))
            check(agree >= 0.999, f"eval: chunk 8 masks agree with per-frame masks on {agree}")
            out["chunked_vs_sequential_min_agreement"] = agree

            longd = LongVideoDataset("data/LongDataset")
            run("longdataset_baseline", lambda: run_model_on_longdata_set(
                "longdataset_baseline", models["baseline"], longd, save_masks=True), long_frames)
            generator_ms("longdataset_baseline",
                         _check_run_csvs("result/longdataset_baseline", ["clip"]))
            info = longd.video_info("clip")
            check(info["test_ids"] == list(range(0, long_frames, long_every)),
                  f"eval: LongDataset test ids {info['test_ids']}")
            _check_saved("result/longdataset_baseline", "clip",
                         [info["frames"][i] for i in info["test_ids"]],
                         [kept["baseline"][-1][i] for i in info["test_ids"]])

            lvos = LongVideoDataset("data/LVOS", "test.txt")
            run("lvos_both_neg_C", lambda: run_model_on_longvos_set(
                "lvos_both_neg_C", models["both_neg_C"], lvos), lvos_frames)
            _check_saved("result/lvos_both_neg_C", "clip", lvos.video_info("clip")["frames"],
                         kept["both_neg_C"][-1])

            ovis = OvisDataset("data/OVIS/train_images", "data/OVIS/annotations.json")
            run("ovis_both_neg_C", lambda: run_model_on_ovis_set(
                "ovis_both_neg_C", models["both_neg_C"], ovis, save_masks=True), ovis_frames)
            generator_ms("ovis_both_neg_C", _check_run_csvs("result/ovis_both_neg_C", ["ovis-clip"]))
            _check_saved("result/ovis_both_neg_C", "ovis-clip",
                         [os.path.basename(f) for f in ovis.videos[0]["file_names"]],
                         kept["both_neg_C"][-1])

            header, rows = _read_csv("result/all_tests.csv")
            check(header == LEDGER_COLUMNS, f"eval: all_tests.csv columns {header}")
            check([r["run"] for r in rows] == ["davis_baseline", "davis_both_neg_C",
                                               "davis_both_neg_C_chunk8",
                                               "longdataset_baseline", "ovis_both_neg_C"],
                  f"eval: all_tests.csv runs {[r['run'] for r in rows]}")
            for r in rows:
                check(all(np.isfinite(float(r[k])) for k in ("JF_mean", "J_mean", "F_mean", "AP")),
                      f"eval: all_tests.csv row {r}")
            out["ledger"] = rows

            # JPEG frames, where this installation can encode them (no check
            # depends on it)
            if codec.jpeg_encoder_available():
                synthetic.write_tree("jpg", h, w, seed=8, fmt="jpg", davis_frames=4,
                                     long_frames=2, long_every=1, lvos_frames=1, ovis_frames=1)
                jd = DavisDataset("jpg/DAVIS", "2016/val.txt", single_object=True)
                t = time.perf_counter()
                rows = run_model_on_davis_set("davis_jpeg", models["baseline"], jd)
                out["jpeg_video"] = dict(rows=rows, wall_s=time.perf_counter() - t,
                                         native_loader=codec._NATIVE.lib() is not None)
                log(f"[eval] one JPEG video: {json.dumps(out['jpeg_video'], default=str)}")
            else:
                out["jpeg_video"] = "not run: no JPEG encoder (Pillow) here"
                log(f"[eval] {out['jpeg_video']}")
        finally:
            os.chdir(here)
    del models
    torch.cuda.empty_cache()
    check(totals["fused_memory_read_shared"] > 0 and totals["flash_attention_relpos"] > 0,
          f"eval: launches {totals}")
    out.update(runs=runs, launches=totals)
    return out


# --------------------------------------------------- the inpaint path (B6)

def _inpaint_windows(drv, t: int):
    """(generator calls, alignment launches) `Inpainter.inpaint` makes over a
    t-frame video: every call aligns 2 * (num_local - 1) times."""
    from vosesam_tpu_torch.pipeline.inpaint import subset_splits

    n = drv.cfg.num_subset_frames
    subsets = ([t] if t <= n else
               [len(pre) + (b - a) + len(post) for a, b, pre, post in subset_splits(t, drv.cfg)])
    calls = launches = 0
    for ts in subsets:
        for group in drv._windows(ts):
            calls += 1
            launches += 2 * (group[0][1] - 1)
    return calls, launches


def _randomise_offset_heads(torch, net, seed: int) -> None:
    """`generator_init` zeroes the last offset convolution as the reference's
    training starts it, which makes every group and tap sample at the flow
    alone with a constant modulation. A trained checkpoint has residual
    offsets per (group, tap): draw small ones, so that the sampling kernel
    sees the model's access pattern."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for align in net.feat_prop_module.deform_align.values():
            last = align.conv_offset[6]
            last.weight.copy_(0.02 * torch.randn(last.weight.shape, generator=gen, device="cuda"))
            last.bias.copy_(0.1 * torch.randn(last.bias.shape, generator=gen, device="cuda"))


def phase_inpaint(torch, n_frames: int = 24, n_long: int = 64):
    """The inpaint path in fp32 at full width: `TrackingAnything` tracks a
    480x854 clip XMem-only, then `baseinpainter.inpaint(frames, masks,
    ratio=0.5)` removes the tracked objects at 240x426 (flip-padded to
    240x432) with the default `InpainterConfig`: static windows, reference
    frames and the overlap blend all run. Counts are set to 0 right before
    each counted run."""
    from vosesam_tpu_torch.config import FrameworkConfig, InpainterConfig, RefinementConfig
    from vosesam_tpu_torch.models.e2fgvi import generator as G
    from vosesam_tpu_torch.models.e2fgvi import modules as M
    from vosesam_tpu_torch.ops import morphology as morph
    from vosesam_tpu_torch.ops.image import resize_bilinear, resize_nearest
    from vosesam_tpu_torch.ops.kernels import deform_align as da
    from vosesam_tpu_torch.pipeline.inpaint import Inpainter, subset_splits
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

    h, w = 480, 854
    oh, ow = 240, 426
    frames = list(moving_frames(n_long, h, w, seed=7))
    cfg = FrameworkConfig(refinement=RefinementConfig(use_refinement=False), dtype="bfloat16")
    t0 = time.time()
    ta = TrackingAnything(cfg=cfg, device="cuda", seed=0, e2fgvi_checkpoint="random-weights")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    drv = ta.baseinpainter
    check(isinstance(drv, Inpainter) and drv.cfg == InpainterConfig()
          and next(drv.net.parameters()).is_cuda, "facade: no inpainter on the card")
    _randomise_offset_heads(torch, drv.net, seed=11)
    clip = frames[:n_frames]
    masks = ta.generator(clip, seed_mask(h, w))[0]
    ta.xmem.clear_memory()
    check(all(set(np.unique(m).tolist()) <= {0, 1, 2} for m in masks) and masks[0].any(),
          "inpaint: tracked masks")

    def expected(fr, mk, radius):
        """The resized input and the resized dilated mask, by the pipeline's own
        functions on the card."""
        f = torch.from_numpy(np.stack(fr)).to("cuda").float()
        f = resize_bilinear(f, (oh, ow)).clamp(0, 255).to(torch.uint8).cpu().numpy()
        d = morph.dilate(torch.from_numpy(np.stack([m > 0 for m in mk])).to("cuda"), radius)
        d = resize_nearest(d.float(), (oh, ow), axes=(-2, -1)).cpu().numpy() > 0
        return f, d

    def run(name, drv, fr, mk):
        calls, want = _inpaint_windows(drv, len(fr))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        da.reset_counts()
        t = time.perf_counter()
        out = drv.inpaint(fr, mk, ratio=0.5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(da.COUNTS)
        check(counts["deform_patches_bounded"] == want and counts["plain"] == 0,
              f"{name}: B6 counts {counts}, expected {want} launches and no plain call")
        check(len(out) == len(fr) and all(o.shape == (oh, ow, 3) and o.dtype == np.uint8
                                          for o in out), f"{name}: output frames")
        res, dil = expected(fr, mk, drv.cfg.dilate_radius)
        got = np.stack(out)
        check(bool((got[~dil] == res[~dil]).all()),
              f"{name}: pixels outside the dilated mask differ from the resized input")
        changed = float((got[dil] != res[dil]).mean())
        check(dil.any() and not dil.all() and changed > 0.5,
              f"{name}: masked share {dil.mean()}, of which changed {changed}")
        summary = dict(frames=len(fr), generator_calls=calls, launches=counts, wall_s=wall,
                       ms_per_window_call=wall * 1e3 / calls, ms_per_frame=wall * 1e3 / len(fr),
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       masked_share=float(dil.mean()), filled_share_changed=changed,
                       tf32_convolutions=bool(torch.backends.cudnn.allow_tf32))
        log(f"[inpaint] {name}: {json.dumps(summary)}")
        return got, dil, summary

    # The inpainter runs at the process's precision settings. A process that
    # sets nothing has PyTorch's default, fp32 convolutions through cuDNN in
    # TF32, so the counted runs use that; phase 1 turned it off for the
    # kernel comparisons, and the clip runs once more that way.
    import dataclasses

    runs = {}
    torch.backends.cudnn.allow_tf32 = True
    try:
        drv.inpaint(clip[:13], masks[:13], ratio=0.5)       # warm-up, not counted
        got, dil, runs["clip_24"] = run("clip_24", drv, clip, masks)
        check(runs["clip_24"]["generator_calls"] == 5
              and runs["clip_24"]["launches"]["deform_patches_bounded"] == 100,
              f"clip_24: {runs['clip_24']}")
        # two windows per generator call: B6 at batch 2 on the path
        drv2 = Inpainter(cfg=dataclasses.replace(drv.cfg, window_batch=2), net=drv.net,
                         device="cuda")
        got2, _, runs["clip_24_window_batch_2"] = run("clip_24_window_batch_2", drv2, clip, masks)
        check(runs["clip_24_window_batch_2"]["generator_calls"] == 3, "window_batch 2: calls")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    got_fp32, _, runs["clip_24_tf32_off"] = run("clip_24_tf32_off", drv, clip, masks)
    for name, other in (("clip_24_tf32_off", got_fp32), ("clip_24_window_batch_2", got2)):
        d = np.abs(other.astype(np.int32) - got.astype(np.int32))[dil]
        runs[name]["inside_share_within_2_of_clip_24"] = float((d <= 2).mean())
    log("[inpaint] inside the mask, share of values within 2 grey levels of clip_24: TF32 off "
        f"{runs['clip_24_tf32_off']['inside_share_within_2_of_clip_24']}, window_batch 2 "
        f"{runs['clip_24_window_batch_2']['inside_share_within_2_of_clip_24']}")

    # one window through the kernel and through the plain sampling (TF32 off)
    frames_f, masks_f, padded, _, _ = drv._preprocess(clip, masks, 0.5, drv.cfg.dilate_radius)
    check(tuple(padded.shape) == (n_frames, 240, 432, 3), f"flip-pad: {tuple(padded.shape)}")
    plan = drv._windows(n_frames)[2][0]
    idx = torch.as_tensor(plan[0], device="cuda")
    valid = torch.arange(len(plan[0]), device="cuda") < plan[2]
    window = padded.index_select(0, idx)
    da.reset_counts()
    # inference: no graph (generator_forward is differentiable since the trainer)
    with torch.no_grad():
        out_k, (ff, fb) = G.generator_forward(drv.net, window, plan[1], drv.cfg,
                                              frame_valid=valid)
        window_ms = time_ms(torch, lambda: G.generator_forward(
            drv.net, window, plan[1], drv.cfg, frame_valid=valid), reps=3, warmup=0)
    kernel_counts = dict(da.COUNTS)
    kernel_sampler = M.deform_patches_bounded
    M.deform_patches_bounded = da.deform_patches_plain
    try:
        da.reset_counts()
        with torch.no_grad():
            out_p, _ = G.generator_forward(drv.net, window, plan[1], drv.cfg, frame_valid=valid)
            plain_window_ms = time_ms(torch, lambda: G.generator_forward(
                drv.net, window, plan[1], drv.cfg, frame_valid=valid), reps=2, warmup=0)
        plain_counts = dict(da.COUNTS)
    finally:
        M.deform_patches_bounded = kernel_sampler
    check(kernel_counts["plain"] == 0 and kernel_counts["deform_patches_bounded"] == 4 * 20
          and plain_counts["deform_patches_bounded"] == 0 and plain_counts["plain"] == 3 * 20,
          f"one window: counts {kernel_counts} / {plain_counts}")
    check(tuple(out_k.shape) == (len(plan[0]), 240, 432, 3) and bool(torch.isfinite(out_k).all())
          and bool(torch.isfinite(ff).all()) and bool(torch.isfinite(fb).all())
          and float(out_k.abs().max()) <= 1.0, "one window: output shape / finiteness / range")
    d = (out_k - out_p).abs()
    err, share = d.max().item(), float((d <= WINDOW_TOL).float().mean())
    check(share >= 0.999, f"one window, kernel vs plain: only {share} of the values within "
                          f"{WINDOW_TOL} (max {err})")
    window_summary = dict(frames=len(plan[0]), num_local=plan[1], n_valid=plan[2],
                          kernel_ms=window_ms, plain_ms=plain_window_ms,
                          kernel_vs_plain_max_abs_err=err, share_within_tol=share, tol=WINDOW_TOL,
                          flow_abs_max=float(torch.maximum(ff.abs().max(), fb.abs().max())))
    log(f"[inpaint] one window (TF32 off), kernel vs plain sampling: {json.dumps(window_summary)}")
    del ta, drv, drv2, window, padded, frames_f, masks_f, out_k, out_p
    torch.cuda.empty_cache()

    # a longer video at reduced depth: the subset split with its context frames
    small = Inpainter(cfg=InpainterConfig(num_blocks=2, num_subset_frames=30), device="cuda",
                      seed=2)
    _randomise_offset_heads(torch, small.net, seed=12)
    long_masks = []
    for i in range(n_long):
        m = np.zeros((h, w), np.uint8)
        m[360:450, 40 + 4 * i:160 + 4 * i] = 1
        long_masks.append(m)
    torch.backends.cudnn.allow_tf32 = True
    try:
        _, _, runs["long_64_two_subsets"] = run("long_64_two_subsets", small, frames, long_masks)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    check(len(subset_splits(n_long, small.cfg)) == 2, "long run: expected two subsets")
    del small
    torch.cuda.empty_cache()
    launches = sum(r["launches"]["deform_patches_bounded"] for r in runs.values())
    return dict(runs=runs, one_window=window_summary, init_s=init_s, b6_launches=launches)


WINDOW_TOL = 1e-3   # tanh output of one window, kernel against plain sampling


def _track_with_decisions(ta, frames, seed):
    """`Tracker.track` over the clip (what `generator` does), reading the
    device count of kept SAM masks after each refined frame: returns the
    masks and the (refined frames, objects) keep/revert decisions."""
    masks, keep = [], []
    prev = 0
    for i, f in enumerate(frames):
        masks.append(ta.xmem.track(f, seed if i == 0 else None)[0])
        if i:
            kept = ta.xmem.sam_kept.cpu().numpy()
            keep.append(kept - prev > 0)
            prev = kept
    return masks, np.stack(keep)


def phase_main_kernel_vs_plain(torch, n_frames: int = 8):
    """fp32, TF32 off: the main path through the kernels (B1/B2, B3 and, with
    `windowed_attention_impl="pallas"`, B4) and through the plain versions
    (the "xla" windowed path); frame 1's SAM embedding within 2e-3; on every frame
    >= 99.9% of refined mask pixels equal and the same keep/revert
    decisions. Random-weight SAM never passes the 0.94 gate, so the pair
    runs again with the gate off, where every prompted object keeps SAM's
    mask and the masks compared are SAM's own."""
    from vosesam_tpu_torch.models.sam import predictor
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

    h, w = 480, 854
    frames = list(moving_frames(n_frames, h, w, seed=3))
    seed = seed_mask(h, w)
    refined = n_frames - 1
    summary = dict(frames=n_frames)
    for gate in (True, False):
        out = {}
        emb = {}
        for plain in (False, True):
            ta = TrackingAnything(
                cfg=_main_cfg("float32", kernels=not plain, gate=gate,
                              window_impl="xla" if plain else "pallas"),
                device="cuda", seed=0)
            _reset_all()
            masks, keep = _track_with_decisions(ta, frames, seed)
            counts = _read_all()
            if plain:
                # B3's plain version per global block and the plain read per
                # frame; the "xla" windowed path is plain torch in the encoder
                check(all(counts[k] == 0 for k in counts if k != "plain")
                      and counts["plain"] == GLOBAL_BLOCKS * refined + n_frames,
                      f"plain run: {counts}")
            else:
                check(counts["flash_attention_relpos"] == GLOBAL_BLOCKS * refined
                      and counts["window_attention_relpos"] == WINDOWED_BLOCKS * refined
                      and counts["plain"] == 0, f"kernel run: {counts}")
            out[plain] = (masks, keep)
            if gate:
                emb[plain] = predictor.encode_image(
                    ta.sam, torch.from_numpy(frames[1]).to("cuda")[None], ta.cfg.sam).embedding
            del ta
            torch.cuda.empty_cache()
        name = "gate" if gate else "no_gate"
        if gate:
            emb_err = (emb[False] - emb[True]).abs().max().item()
            check(emb_err <= FP32_ATTN_TOL, f"frame 1 SAM embedding differs by {emb_err}")
            summary["frame1_embedding_max_abs_err"] = emb_err
        agree = [float((a == b).mean()) for a, b in zip(out[False][0], out[True][0])]
        check(min(agree) >= 0.999, f"{name}: refined masks agree only {min(agree)}")
        same_keep = bool((out[False][1] == out[True][1]).all())
        check(same_keep, f"{name}: keep/revert decisions differ between kernel and plain runs")
        kept = float(out[False][1].mean())
        if not gate:
            check(kept > 0, "no_gate: SAM's mask was kept on no (frame, object) pair")
        summary[name] = dict(worst_mask_agreement=min(agree), same_keep_decisions=same_keep,
                             sam_kept_share=kept)
    log(f"[main fp32] kernel vs plain: {json.dumps(summary)}")
    return summary


def phase_interactive(torch, n_clicks: int = 5):
    """The interactive entry points at full width: SAM-HQ vit_h, the official
    square encode (64x64 tokens, 25 windows), the window kernel selected.
    Counts are set to 0 before `set_image`, the clicks and the automatic
    masks and read after: one encode per `set_image` and one per
    `generate_masks`, none per click."""
    from vosesam_tpu_torch.models.sam import automatic
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

    h, w = 480, 854
    image = moving_frames(1, h, w, seed=5)[0]
    one = (np.array([[320.0, 200.0]]), np.array([1]))
    two = (np.array([[320.0, 200.0], [700.0, 400.0], [330.0, 210.0]]), np.array([1, 0, 1]))

    def timed(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return out, statistics.median(times)

    def check_click(name, out):
        mask, logit, painted = out
        check(mask.shape == (h, w) and mask.dtype == np.bool_, f"{name}: mask {mask.shape}")
        check(logit.shape == (256, 256) and logit.dtype == np.float32
              and bool(np.isfinite(logit).all()), f"{name}: logit {logit.shape} {logit.dtype}")
        check(painted.shape == (h, w, 3) and painted.dtype == np.uint8, f"{name}: painted")

    ta = TrackingAnything(cfg=_main_cfg("bfloat16", rect=False, window_impl="pallas"),
                          device="cuda", seed=0)
    ctl = ta.samcontroler
    ctl.set_image(image)            # warm-up, not counted
    ta.first_frame_click(image, *two)
    _reset_all()
    _, set_image_ms = timed(lambda: ctl.set_image(image), 3)
    counts = _read_all()
    per_encode = {"flash_attention_relpos": GLOBAL_BLOCKS,
                  "window_attention_relpos": WINDOWED_BLOCKS}
    check(all(counts[k] == 3 * per_encode.get(k, 0) for k in counts),
          f"set_image x3: launches {counts}")
    check(tuple(ctl.emb.embedding.shape) == (1, 64, 64, 256), "set_image: embedding shape")
    out1, click_ms = timed(lambda: ta.first_frame_click(image, *one), n_clicks)
    check_click("one-pass click", out1)
    out2, click2_ms = timed(lambda: ta.first_frame_click(image, *two), n_clicks)
    check_click("two-pass click", out2)
    check(_read_all() == counts, f"a click encoded again: {_read_all()}")
    # automatic masks: the paper's thresholds, then thresholds that
    # random-weight masks can pass, so that the NMS has work
    t0 = time.perf_counter()
    auto = automatic.generate_masks(ta.sam, image, ta.cfg.sam, points_per_side=16)
    auto_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loose = automatic.generate_masks(ta.sam, image, ta.cfg.sam, points_per_side=16,
                                     pred_iou_thresh=-1e3, stability_thresh=0.0)
    loose_s = time.perf_counter() - t0
    for name, am in (("automatic", auto), ("automatic, loose thresholds", loose)):
        n = len(am.masks)
        check(am.masks.shape == (n, h, w) and am.masks.dtype == np.bool_
              and am.scores.shape == (n,) and am.points.shape == (n, 2), f"{name}: shapes")
    check(len(loose.masks) > 0 and bool(loose.masks.reshape(len(loose.masks), -1).any(1).all()),
          "automatic, loose thresholds: no mask survived")
    counts = _read_all()
    check(all(counts[k] == 5 * per_encode.get(k, 0) for k in counts),
          f"interactive path: launches {counts}")
    del ta, ctl
    torch.cuda.empty_cache()

    # fp32, TF32 off: the same clicks through the kernels and the plain versions
    masks = {}
    for plain in (False, True):
        fa32 = TrackingAnything(
            cfg=_main_cfg("float32", rect=False, kernels=not plain,
                          window_impl="xla" if plain else "pallas"), device="cuda", seed=0)
        masks[plain] = [fa32.first_frame_click(image, *c)[0] for c in (one, two)]
        del fa32
        torch.cuda.empty_cache()
    agree = [float((a == b).mean()) for a, b in zip(masks[False], masks[True])]
    check(min(agree) >= 0.999, f"fp32 clicked masks, kernels vs plain: agreement {agree}")
    summary = dict(launches=counts, set_image_ms=set_image_ms, click_ms=click_ms,
                   two_pass_click_ms=click2_ms, automatic_s=auto_s, automatic_masks=len(auto.masks),
                   automatic_loose_s=loose_s, automatic_loose_masks=len(loose.masks),
                   clicked_mask_share=[float(out1[0].mean()), float(out2[0].mean())],
                   fp32_click_agreement_kernels_vs_plain=agree)
    log(f"[interactive] {json.dumps(summary)}")
    return summary


# ------------------------------------------- serving: server and app (A10)

def _http(base, route, payload=None, timeout=600):
    """(status, JSON body, headers) of one request; HTTP errors included."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"{base}{route}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _serve_counts_reset():
    from vosesam_tpu_torch.ops.kernels import deform_align as da

    _reset_all()
    da.reset_counts()


def _serve_counts():
    from vosesam_tpu_torch.ops.kernels import deform_align as da

    counts = _read_all()
    counts["deform_patches_bounded"] = da.COUNTS["deform_patches_bounded"]
    counts["plain"] += da.COUNTS["plain"]
    return counts


def phase_serve(torch, card: str, n_frames: int = 12, n_inpaint: int = 10):
    """Serving on the card: one model at the main path's full width
    (XMem-s012, SAM-HQ vit_h, `both_neg` / C / the 0.94 gate, rect encode,
    bf16) with the E2FGVI-HQ inpainter of phase 8 (random weights, offset
    heads randomised) behind `serve(model, port=0)`: /health, /segment on a
    480x854 PNG with two clicks, /track over `n_frames` frames with chunk 8
    and chunk 0, /inpaint of `n_inpaint` frames at ratio 0.5 with the
    tracked masks, two concurrent /track requests (exactly one 503 with
    Retry-After), an unknown route (404). Kernel counts are set to 0 right
    before the requests and read right after them. Every response decodes
    to masks / frames bit-equal to the same facade call made directly on
    the same model afterwards. Then one `AppSession` flow on the same
    frames, counted the same way: template, two clicks, `add_mask`,
    `track` (chunk 8, painted), `inpaint(last_masks)`; the inpainted frames
    must differ from the input inside the dilated masks (the out-of-memory
    guard did not fire) and B6 must launch. The inpainter runs at
    PyTorch's default precision (TF32 convolutions), as in phase 8."""
    import base64
    import threading

    from vosesam_tpu_torch.app import AppSession
    from vosesam_tpu_torch.eval import codec
    from vosesam_tpu_torch.eval.palette import pascal_colormap
    from vosesam_tpu_torch.ops import morphology as morph
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything
    from vosesam_tpu_torch.serve.server import serve

    h, w = 480, 854
    frames = list(moving_frames(n_frames, h, w, seed=5))
    tmpl = seed_mask(h, w)
    points = [[300.0, 200.0], [680.0, 100.0]]
    labels = [1, 0]
    png = lambda f: base64.b64encode(codec.encode_png_rgb(f)).decode()  # noqa: E731
    pmask = lambda m: base64.b64encode(codec.encode_png_palette(  # noqa: E731
        m, pascal_colormap())).decode()
    unmask = lambda b: codec.decode_indices(base64.b64decode(b))  # noqa: E731
    unframe = lambda b: codec.decode_rgb(base64.b64decode(b))  # noqa: E731

    t0 = time.time()
    ta = TrackingAnything(cfg=_main_cfg("bfloat16"), device="cuda", seed=0,
                          e2fgvi_checkpoint="random-weights")
    _randomise_offset_heads(torch, ta.baseinpainter.net, seed=13)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    httpd = serve(ta, port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = dict(card=card, init_s=init_s, ms={})
    try:
        # first-call costs, not counted: one short track and one click
        ta.generator_chunked(frames[:9], tmpl, chunk=8)
        ta.xmem.clear_memory()
        ta.first_frame_click(frames[0], np.asarray(points, np.float32), np.asarray(labels))
        ta.baseinpainter.inpaint(frames[:6], [tmpl] * 6, ratio=0.5)
        torch.cuda.synchronize()

        def timed(name, route, payload=None):
            t = time.perf_counter()
            res = _http(base, route, payload)
            out["ms"][name] = (time.perf_counter() - t) * 1e3
            while httpd.RequestHandlerClass.lock.locked():   # released after the reply
                time.sleep(0.001)
            return res

        seg = dict(image=png(frames[0]), points=points, labels=labels)
        track = dict(frames=[png(f) for f in frames], template_mask=pmask(tmpl))
        _serve_counts_reset()
        health = timed("health", "/health")
        segment = timed("segment", "/segment", seg)
        tracked8 = timed("track_chunk_8", "/track", dict(track, chunk=8))
        tracked0 = timed("track_chunk_0", "/track", dict(track, chunk=0))
        check(tracked8[0] == 200 and tracked0[0] == 200, f"serve: /track {tracked8[:2]}")
        masks8 = [unmask(m) for m in tracked8[1]["masks"]]
        inp = dict(frames=[png(f) for f in frames[:n_inpaint]],
                   masks=[pmask(m) for m in masks8[:n_inpaint]], ratio=0.5)
        inpainted = timed("inpaint", "/inpaint", inp)
        # two concurrent /track requests: the first is held inside the
        # model until the second has been answered
        orig = ta.generator_chunked
        entered, release = threading.Event(), threading.Event()

        def held(*a, **k):
            entered.set()
            release.wait(600)
            return orig(*a, **k)

        first = {}
        short = dict(frames=track["frames"][:3], template_mask=track["template_mask"])
        ta.generator_chunked = held
        th = threading.Thread(target=lambda: first.update(res=_http(base, "/track", short)))
        try:
            th.start()
            check(entered.wait(600), "serve: the first /track never reached the model")
            t = time.perf_counter()
            busy = _http(base, "/track", short)
            out["ms"]["busy_503"] = (time.perf_counter() - t) * 1e3
        finally:
            release.set()
            th.join(600)
            del ta.generator_chunked
        while httpd.RequestHandlerClass.lock.locked():
            time.sleep(0.001)
        unknown = timed("unknown_404", "/nope", {})
        torch.cuda.synchronize()
        counts = _serve_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"[serve] {card}; ms per request: {json.dumps(out['ms'])}")
    log(f"[serve] launches over the requests: {json.dumps(counts)}")
    check(health[0] == 200 and health[1]["status"] == "ok" and health[1]["backend"] == "cuda"
          and health[1]["device"] == torch.cuda.get_device_name(0), f"serve: /health {health[1]}")
    check(segment[0] == 200 and segment[1]["shape"] == [h, w], f"serve: /segment {segment[:2]}")
    check(inpainted[0] == 200 and len(inpainted[1]["frames"]) == n_inpaint,
          f"serve: /inpaint {inpainted[0]}")
    check(not th.is_alive() and first["res"][0] == 200, "serve: the held /track did not finish")
    check(busy[0] == 503 and busy[1]["error"].startswith("busy")
          and busy[2].get("Retry-After") == "1", f"serve: concurrent /track got {busy[:2]}")
    check(unknown[0] == 404, f"serve: unknown route got {unknown[0]}")
    for k in ("fused_memory_read_shared", "flash_attention_relpos", "deform_patches_bounded"):
        check(counts[k] > 0, f"serve: {k} never launched over the requests")
    check(counts["plain"] == 0, f"serve: {counts['plain']} plain calls")

    # the same calls made directly on the same model: bit-equal
    ta.samcontroler.reset_image()
    want, _, _ = ta.first_frame_click(frames[0], np.asarray(points, np.float32),
                                      np.asarray(labels, np.int32))
    check(np.array_equal(unmask(segment[1]["mask"]), want.astype(np.uint8)),
          "serve: /segment differs from first_frame_click")
    ta.xmem.clear_memory()
    want8, scores8 = ta.generator_chunked(frames, tmpl, chunk=8)
    ta.xmem.clear_memory()
    want0, _, _, scores0 = ta.generator(frames, tmpl)
    ta.xmem.clear_memory()
    for name, res, want, scores in (("chunk 8", tracked8, want8, scores8),
                                    ("chunk 0", tracked0, want0, scores0)):
        got = [unmask(m) for m in res[1]["masks"]]
        check(len(got) == n_frames and all(np.array_equal(a, b) for a, b in zip(got, want)),
              f"serve: /track {name} masks differ from the facade's")
        check(res[1]["scores"] == [list(map(float, s)) for s in scores],
              f"serve: /track {name} scores differ from the facade's")
    want_inp = ta.baseinpainter.inpaint(frames[:n_inpaint], masks8[:n_inpaint], ratio=0.5)
    got_inp = [unframe(f) for f in inpainted[1]["frames"]]
    check(all(np.array_equal(a, b) for a, b in zip(got_inp, want_inp)),
          "serve: /inpaint frames differ from baseinpainter.inpaint's")
    log("[serve] /segment, /track (chunk 8, 0) and /inpaint bit-equal to the facade's calls")

    # one AppSession flow on the same frames
    session = AppSession(ta)
    session.frames = list(frames)
    _serve_counts_reset()
    t = time.perf_counter()
    session.select_template(0)
    for (x, y), lbl in zip(points, labels):
        session.click(x, y, bool(lbl))
    check(session.add_mask() == 1, "app: add_mask")
    masks, painted, _ = session.track()
    check(len(masks) == n_frames and painted[0].shape == (h, w, 3), "app: track output")
    inpainted_app = session.inpaint(session.last_masks)
    torch.cuda.synchronize()
    app_ms = (time.perf_counter() - t) * 1e3
    app_counts = _serve_counts()
    dil = morph.dilate(torch.from_numpy(np.stack([m > 0 for m in masks])).to("cuda"),
                       ta.baseinpainter.cfg.dilate_radius).cpu().numpy()
    got = np.stack(inpainted_app)
    changed = float((got[dil] != np.stack(frames)[dil]).mean()) if dil.any() else 0.0
    check(got.shape == (n_frames, h, w, 3) and dil.any() and changed > 0.5,
          f"app: inpainted frames inside the dilated masks changed on {changed} of the values")
    check(bool((got[~dil] == np.stack(frames)[~dil]).all()),
          "app: inpainted frames differ outside the dilated masks")
    check(app_counts["deform_patches_bounded"] > 0 and app_counts["plain"] == 0,
          f"app: counts {app_counts}")
    torch.backends.cudnn.allow_tf32 = allow_tf32
    out.update(launches=counts, app=dict(ms=app_ms, launches=app_counts,
                                         masked_share=float(dil.mean()),
                                         inside_changed=changed))
    log(f"[serve] AppSession flow (template, 2 clicks, add_mask, track chunk 8, inpaint at "
        f"480x854): {app_ms:.1f} ms, inside the masks {changed:.4f} of the values changed; "
        f"launches {json.dumps(app_counts)}")
    del ta, session
    torch.cuda.empty_cache()
    return out


# --------------------------------------------- the XMem trainer (A12)

TRAIN_LOSS_REL = 1e-4     # card vs CPU: the batch loss
# card vs CPU: max |g_card - g_cpu| over the global norm. cuDNN's fp32
# convolution algorithms (TF32 off: FFT / Winograd, C20) are not the CPU's
# direct ones; measured 2.4e-4 on an H100 (PERF.md §6)
TRAIN_GRAD_REL = 1e-3
TRAIN_PARAM_ATOL = 1e-5   # card vs CPU: parameters after one step (lr 1e-5) ...
TRAIN_PARAM_SHARE = 0.999  # ... on this share of the elements


def _toy_step(torch, dev, frames, gt, ov, grad_accum=1, mesh=None):
    """One trainer step at toy dims from the same seeded weights on `dev`
    (data parallel over `mesh` where given): (gradients on the CPU, the
    loss, the trained state)."""
    from vosesam_tpu_torch.config import FrameworkConfig, XMemConfig
    from vosesam_tpu_torch.models.xmem.network import xmem_init
    from vosesam_tpu_torch.training import trainer as T

    cfg = FrameworkConfig(xmem=XMemConfig(key_dim=8, value_dim=16, hidden_dim=4,
                                          max_objects=2), dtype="float32")
    tcfg = T.TrainConfig(grad_accum=grad_accum)
    state = T.init_train_state(xmem_init(cfg.xmem, seed=3, device=dev), tcfg)
    batch = [torch.from_numpy(x).to(dev) for x in (frames, gt, ov)]
    if mesh is not None:
        from vosesam_tpu_torch.parallel.mesh import shard_batch

        batch = shard_batch(batch, mesh)
    grads, loss, aux = T.batch_gradients(state, *batch, cfg, tcfg)
    if mesh is not None:
        grads, loss, aux = T.all_reduce_mean(grads, loss, aux, mesh)
    T.apply_adamw(state, grads, tcfg)
    return {k: v.cpu() for k, v in grads.items()}, float(loss), state



def _compare_steps(torch, name, a, b):
    (ga, la, sa), (gb, lb, sb) = a, b
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in gb.values())))
    errs = {k: float((ga[k] - gb[k]).abs().max()) for k in gb}
    worst = max(errs, key=errs.get)
    gerr = errs[worst] / norm
    pa, pb = sa.net.state_dict(), sb.net.state_dict()
    keys = [k for k in pb if not k.endswith("num_batches_tracked")]
    diffs = torch.cat([(pa[k].cpu() - pb[k].cpu()).abs().flatten() for k in keys])
    share = float((diffs <= TRAIN_PARAM_ATOL).double().mean())
    res = dict(loss=(la, lb), loss_rel=abs(la - lb) / abs(lb), grad_err_over_norm=gerr,
               grad_norm=norm, worst_leaf=worst,
               worst_leaf_err_over_its_max=errs[worst] / max(float(gb[worst].abs().max()), 1e-30),
               param_share_within_atol=share, param_max_abs_diff=float(diffs.max()))
    log(f"[train] {name}: {json.dumps(res)}")
    check(res["loss_rel"] <= TRAIN_LOSS_REL, f"train: {name}: loss {la} vs {lb}")
    check(gerr <= TRAIN_GRAD_REL, f"train: {name}: gradients differ by {gerr} of the norm")
    check(share >= TRAIN_PARAM_SHARE, f"train: {name}: parameters within {TRAIN_PARAM_ATOL} "
                                      f"on only {share} of the elements")
    return res


def _step_diff(torch, a, b):
    """How far two toy steps lie apart: the largest gradient difference over
    the global norm, and the largest parameter difference after the update."""
    (ga, _, sa), (gb, _, sb) = a, b
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in gb.values())))
    pa, pb = sa.net.state_dict(), sb.net.state_dict()
    return dict(grad_err_over_norm=max(float((ga[k] - gb[k]).abs().max()) for k in gb) / norm,
                param_max_abs_diff=max(float((pa[k] - pb[k]).abs().max()) for k in pb
                                       if not k.endswith("num_batches_tracked")))


def phase_train(torch, card: str, n_steps: int = 5, n_timed: int = 2):
    """The XMem trainer on the card. The full-width recipe on a synthetic
    480x854 DAVIS tree through `ClipSampler`: XMem-s012 dims, 3 object
    slots, B 4, T 8, crop 384, `grad_accum` 2, remat on, fp32 (PyTorch's
    default precision: TF32 convolutions), `n_steps` steps with finite
    losses; ms per step (steps after the first) and peak memory; then
    `n_timed` more steps with a `StageTimer` (data, forward, loss,
    backward, optimizer: ms per step). Then, at toy dims with TF32 off for
    matmuls and cuDNN and deterministic cuDNN
    algorithms (ROADMAP C20): one step on the card against the same step on
    the CPU, and `grad_accum` 2 against the full batch on the card, each
    within the TRAIN_* tolerances; a checkpoint saved on the card reloads
    through `load_xmem_checkpoint` and `load_checkpoint`."""
    import tempfile

    from vosesam_tpu_torch.config import FrameworkConfig, XMemConfig
    from vosesam_tpu_torch.eval import synthetic
    from vosesam_tpu_torch.eval.datasets import DavisDataset
    from vosesam_tpu_torch.models.xmem.network import XMem, xmem_init
    from vosesam_tpu_torch.training import trainer as T
    from vosesam_tpu_torch.training.data import ClipSampler, ClipSamplerConfig
    from vosesam_tpu_torch.utils.checkpoint import load_xmem_checkpoint
    from vosesam_tpu_torch.utils.profiling import StageTimer

    out = dict(card=card)
    cfg = FrameworkConfig(xmem=XMemConfig(max_objects=3), dtype="float32")
    tcfg = T.TrainConfig(grad_accum=2, remat=True)
    allow_tf32 = torch.backends.cudnn.allow_tf32
    with tempfile.TemporaryDirectory(prefix="vosesam_train_") as tmp:
        t0 = time.time()
        synthetic.write_tree(tmp, 480, 854, seed=9, davis_frames=16, long_frames=2,
                             lvos_frames=1, ovis_frames=2)
        out["tree_s"] = time.time() - t0
        sampler = ClipSampler(DavisDataset(os.path.join(tmp, "DAVIS"), "2017/val.txt"),
                              ClipSamplerConfig(seq_length=8, crop=384), 3, seed=0)
        state = T.init_train_state(xmem_init(cfg.xmem, seed=0, device="cuda"), tcfg)
        torch.backends.cudnn.allow_tf32 = True
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, losses = [], []
            for _ in range(n_steps):
                frames, gt, valid = sampler.sample_batch(4)
                t = time.perf_counter()
                batch = (torch.from_numpy(frames).float().cuda(), torch.from_numpy(gt).cuda(),
                         torch.from_numpy(valid).cuda())
                state, aux = T.train_step(state, *batch, cfg, tcfg)
                losses.append(float(aux["loss"]))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            torch.backends.cudnn.allow_tf32 = allow_tf32
        check(all(np.isfinite(losses)), f"train: losses {losses}")
        check(frames.shape == (4, 8, 384, 384, 3), f"train: batch {frames.shape}")
        out.update(steps=n_steps, losses=losses, ms_per_step=statistics.median(times[1:]),
                   step_ms=times, peak_mem_gib=peak)
        log(f"[train] {card}; full-width recipe (XMem-s012, B 4, T 8, 384x384, grad_accum 2, "
            f"remat, fp32): {statistics.median(times[1:]):.1f} ms per step (steps 2-{n_steps}, "
            f"median; {[round(x, 1) for x in times]}), peak {peak:.2f} GiB, losses {losses}")

        # where a step's time goes: `n_timed` more steps with a StageTimer
        # (each stage syncs at its end, so host and device no longer overlap)
        timer, timed = StageTimer(), []
        torch.backends.cudnn.allow_tf32 = True
        try:
            for _ in range(n_timed):
                t = time.perf_counter()
                with timer.stage("data"):
                    frames, gt, valid = sampler.sample_batch(4)
                    batch = (torch.from_numpy(frames).float().cuda(),
                             torch.from_numpy(gt).cuda(), torch.from_numpy(valid).cuda())
                    timer.record(batch)
                state, aux = T.train_step(state, *batch, cfg, tcfg, timer=timer)
                check(np.isfinite(float(aux["loss"])), f"train: timed step loss {aux['loss']}")
                timed.append((time.perf_counter() - t) * 1e3)
        finally:
            torch.backends.cudnn.allow_tf32 = allow_tf32
        stages = {k: v * 1e3 / n_timed for k, v in timer.totals.items()}
        out.update(stage_ms_per_step=stages, timed_step_ms=timed, stage_counts_per_step={
            k: v / n_timed for k, v in timer.counts.items()})
        log(f"[train] stage ms per step over {n_timed} timed steps (data; forward and loss "
            f"per frame; backward per clip, with remat's recompute; optimizer; each synced at "
            f"its end): {json.dumps({k: round(v, 1) for k, v in stages.items()})}, summed "
            f"{sum(stages.values()):.1f} ms; the timed steps {[round(x, 1) for x in timed]} ms")

        # a checkpoint saved on the card reloads
        path = os.path.join(tmp, "xmem_train.pth")
        T.save_checkpoint(state, path)
        sd, ck_cfg = load_xmem_checkpoint(path, cfg.xmem)
        net = XMem(ck_cfg)
        net.load_state_dict(sd, strict=True)
        trained = {k: v.cpu() for k, v in state.net.state_dict().items()}
        check(all(torch.equal(net.state_dict()[k], v) for k, v in trained.items()),
              "train: the reloaded network differs")
        fresh = T.init_train_state(xmem_init(cfg.xmem, seed=1, device="cuda"), tcfg)
        T.load_checkpoint(path, fresh)
        check(fresh.it == n_steps + n_timed and fresh.count == n_steps + n_timed
              and all(torch.equal(fresh.mu[k], state.mu[k]) for k in state.mu),
              "train: load_checkpoint did not restore the optimizer")
        del state, fresh, net
        torch.cuda.empty_cache()

    # toy dims: card vs CPU, grad_accum 2 vs the full batch
    rng = np.random.default_rng(0)
    frames = (0.01 * rng.normal(size=(2, 3, 64, 64, 3))).astype(np.float32)
    gt = np.zeros((2, 3, 64, 64), np.int32)
    gt[:, :, 16:40, 16:40] = 1
    gt[1, :, 40:60, 4:24] = 2
    ov = np.array([[True, False], [True, True]])
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cpu = _toy_step(torch, "cpu", frames, gt, ov)
        card_step = _toy_step(torch, "cuda", frames, gt, ov)
        out["card_vs_cpu"] = _compare_steps(torch, "one step, card vs CPU", card_step, cpu)
        acc = _toy_step(torch, "cuda", frames, gt, ov, grad_accum=2)
        out["grad_accum_2_vs_full"] = _compare_steps(torch, "grad_accum 2 vs the full batch "
                                                     "on the card", acc, card_step)
    finally:
        torch.backends.cudnn.deterministic = det
    log("[train] a card checkpoint reloads (load_xmem_checkpoint, load_checkpoint)")
    return out


# ------------------------------------------ the E2FGVI GAN trainer (A12)

# card vs CPU at toy dims, the losses: fp32 convolutions (cuDNN's with TF32
# off against the CPU's) summed in another order
INPAINT_TRAIN_LOSS_REL = 1e-4
# card vs CPU, the gradients per leaf: ||g_card - g_cpu|| over ||g_cpu||.
# The CPU test against JAX measured fp32 rounding at up to 2e-3 of the
# encoder's last leaves in either framework (tests/test_torch_inpaint_
# training.py); here also cuDNN's algorithms and B6's atomics
INPAINT_TRAIN_GRAD_REL = 5e-3
INPAINT_TRAIN_GRAD_REL_MOST = 1e-4   # ... on >= 90% of the leaves


def _converge_sn(torch, disc) -> None:
    """Spectral norm's u and v after 200 power iterations, as a trained
    discriminator keeps them: a fresh random pair underestimates sigma, and
    the hinge logits then reach 1e8, where the generator's gradient is the
    adversarial term's rounding."""
    from vosesam_tpu_torch.models.e2fgvi import discriminator as D

    for layer in disc.conv:
        if isinstance(layer, D.SNConv3d):
            _, layer.weight_u, layer.weight_v = D.spectral_normalize(
                layer.weight_orig.detach(), layer.weight_u, layer.weight_v, update=True,
                n_power_iterations=200)


def _inpaint_toy_step(torch, dev, seed: int = 21):
    """One GAN step's gradients and losses at toy dims (T 3, 48x48, 2 local
    frames, one focal block) from the same seeded weights on `dev`."""
    from vosesam_tpu_torch.config import InpainterConfig
    from vosesam_tpu_torch.models.e2fgvi import discriminator as D
    from vosesam_tpu_torch.models.e2fgvi import generator as G
    from vosesam_tpu_torch.training import inpaint_trainer as IT

    cfg = InpainterConfig(num_blocks=1)
    gen = G.generator_init(cfg, seed=seed, device="cpu")
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for align in gen.feat_prop_module.deform_align.values():
            last = align.conv_offset[6]
            last.weight.copy_(torch.from_numpy(
                (0.02 * r.standard_normal(last.weight.shape)).astype(np.float32)))
            last.bias.copy_(torch.from_numpy(
                (0.1 * r.standard_normal(last.bias.shape)).astype(np.float32)))
    disc = D.discriminator_init(seed=seed, device="cpu")
    _converge_sn(torch, disc)
    state = IT.init_train_state(gen.to(dev), disc.to(dev))
    frames = r.uniform(-1, 1, (3, 48, 48, 3)).astype(np.float32)
    masks = np.zeros((3, 48, 48, 1), np.float32)
    masks[:, 12:30, 10:36] = 1.0
    batch = [torch.from_numpy(a).to(dev) for a in (frames, masks)]
    gg, dg, metrics = IT.step_gradients(state, *batch, 2, cfg, IT.InpaintTrainConfig())
    grads = {f"gen.{k}": v.cpu() for k, v in gg.items()}
    grads.update({f"disc.{k}": v.cpu() for k, v in dg.items()})
    return grads, {k: float(v) for k, v in metrics.items()}


def phase_inpaint_train(torch, card: str, n_steps: int = 5):
    """The E2FGVI GAN trainer on the card at full width: `InpainterConfig()`
    (E2FGVI-HQ, 8 focal blocks), T 8 (5 local + 3 non-local) at 240x432,
    remat on, fp32 at PyTorch's default precision (TF32 convolutions), clips
    from `InpaintClipSampler` on a synthetic 480x854 tree, the offset heads
    randomised as in phase 8; `n_steps` steps with finite losses, both
    networks moved, u and v unit vectors; per step, counted from 0, B6
    forward launches 4 x (num_local - 1) (the forward and remat's
    recompute) and 2 x (num_local - 1) backward launches, no plain call; ms
    per step on the host clock (ending in a synchronise) and peak memory.
    Then, at toy dims with TF32 off and deterministic cuDNN, one step's
    gradients on the card (the kernels) against the same step on the CPU
    (the plain versions)."""
    import tempfile

    from vosesam_tpu_torch.config import InpainterConfig
    from vosesam_tpu_torch.eval import synthetic
    from vosesam_tpu_torch.eval.datasets import DavisDataset
    from vosesam_tpu_torch.models.e2fgvi import discriminator as D
    from vosesam_tpu_torch.models.e2fgvi import generator as G
    from vosesam_tpu_torch.ops.kernels import deform_align as da
    from vosesam_tpu_torch.training import inpaint_trainer as IT
    from vosesam_tpu_torch.training.inpaint_data import InpaintClipSampler

    out = dict(card=card)
    cfg = InpainterConfig()
    tcfg = IT.InpaintTrainConfig()
    num_local = 5
    gen = G.generator_init(cfg, seed=0, device="cuda")
    _randomise_offset_heads(torch, gen, seed=14)
    disc = D.discriminator_init(seed=1, device="cuda")
    state = IT.init_train_state(gen, disc, tcfg)
    watch = {"gen.encoder.layers.0.weight": gen.encoder.layers[0].weight,
             "gen.feat_prop_module.deform_align.forward_.weight":
                 gen.feat_prop_module.deform_align["forward_"].weight,
             "gen.feat_prop_module.deform_align.forward_.conv_offset.6.weight":
                 gen.feat_prop_module.deform_align["forward_"].conv_offset[6].weight,
             "disc.conv.0.weight_orig": disc.conv[0].weight_orig,
             "disc.conv.10.weight": disc.conv[10].weight}
    before = {k: v.detach().clone() for k, v in watch.items()}
    allow_tf32 = torch.backends.cudnn.allow_tf32
    with tempfile.TemporaryDirectory(prefix="vosesam_inpaint_train_") as tmp:
        synthetic.write_tree(tmp, 480, 854, seed=10, davis_frames=16, long_frames=2,
                             lvos_frames=1, ovis_frames=2)
        sampler = InpaintClipSampler(DavisDataset(os.path.join(tmp, "DAVIS"), "2017/val.txt"),
                                     num_local=num_local, num_nonlocal=3, size=(240, 432),
                                     seed=0)
        torch.backends.cudnn.allow_tf32 = True
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, metrics, counts = [], [], []
            for _ in range(n_steps):
                frames, masks, nl = sampler.sample()
                da.reset_counts()
                t = time.perf_counter()
                batch = [torch.from_numpy(a).cuda() for a in (frames, masks)]
                state, m = IT.train_step(state, *batch, nl, cfg, tcfg)
                metrics.append({k: float(v) for k, v in m.items()})
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                counts.append(dict(da.COUNTS))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            torch.backends.cudnn.allow_tf32 = allow_tf32
    check(frames.shape == (8, 240, 432, 3) and masks.shape == (8, 240, 432, 1),
          f"inpaint train: clip {frames.shape} {masks.shape}")
    check(all(np.isfinite(v) for m in metrics for v in m.values()),
          f"inpaint train: non-finite metrics {metrics}")
    want = {"deform_patches_bounded": 4 * (num_local - 1),
            "deform_patches_backward": 2 * (num_local - 1), "plain": 0, "plain_backward": 0}
    check(all(c == want for c in counts), f"inpaint train: B6 counts per step {counts}, "
                                          f"expected {want}")
    moved = {k: float((watch[k].detach() - before[k]).abs().max()) for k in watch}
    check(all(v > 0 for v in moved.values()), f"inpaint train: weights did not move {moved}")
    norms = [float(layer.weight_u.norm()) for layer in disc.conv if isinstance(layer, D.SNConv3d)]
    norms += [float(layer.weight_v.norm()) for layer in disc.conv
              if isinstance(layer, D.SNConv3d)]
    check(all(abs(n - 1.0) <= 1e-4 for n in norms), f"inpaint train: u / v norms {norms}")
    check(state.it == n_steps and state.gen_opt.count == n_steps, "inpaint train: step count")
    ms = statistics.median(times[1:])
    out.update(steps=n_steps, step_ms=times, ms_per_step=ms, peak_mem_gib=peak,
               metrics=metrics, launches_per_step=counts[-1], moved=moved,
               launches={k: sum(c[k] for c in counts) for k in want})
    log(f"[inpaint train] {card}; E2FGVI-HQ GAN (8 blocks, T 8 = 5 + 3, 240x432, remat, fp32, "
        f"TF32 convolutions): {ms:.1f} ms per step (steps 2-{n_steps}, median; "
        f"{[round(x, 1) for x in times]}), peak {peak:.2f} GiB; B6 per step {counts[-1]}; "
        f"last losses {json.dumps(metrics[-1])}")
    del state, gen, disc, watch, before
    torch.cuda.empty_cache()

    # toy dims: one step's gradients, card (the kernels) vs CPU (plain)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        g_cpu, m_cpu = _inpaint_toy_step(torch, "cpu")
        da.reset_counts()
        g_card, m_card = _inpaint_toy_step(torch, "cuda")
        toy_counts = dict(da.COUNTS)
    finally:
        torch.backends.cudnn.deterministic = det
    check(toy_counts["deform_patches_backward"] == 2 and toy_counts["plain_backward"] == 0,
          f"inpaint train toy: counts {toy_counts}")
    loss_rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6) for k in m_cpu}
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g_cpu.values())))
    rel = {k: float((g_card[k] - g).norm()) / max(float(g.norm()), 1e-6 * total)
           for k, g in g_cpu.items()}
    worst = max(rel, key=rel.get)
    most = float(np.mean([r <= INPAINT_TRAIN_GRAD_REL_MOST for r in rel.values()]))
    res = dict(losses_card=m_card, losses_cpu=m_cpu, worst_loss_rel=max(loss_rel.values()),
               worst_leaf=worst, worst_leaf_rel=rel[worst], share_within_most=most,
               median_leaf_rel=float(np.median(list(rel.values()))), grad_norm=total)
    log(f"[inpaint train] one step at toy dims, card vs CPU: {json.dumps(res)}")
    check(max(loss_rel.values()) <= INPAINT_TRAIN_LOSS_REL,
          f"inpaint train toy: losses {m_card} vs {m_cpu}")
    check(rel[worst] <= INPAINT_TRAIN_GRAD_REL,
          f"inpaint train toy: {worst} differs by {rel[worst]} of its norm")
    check(most >= 0.9, f"inpaint train toy: only {most} of the leaves within "
                       f"{INPAINT_TRAIN_GRAD_REL_MOST}")
    out["card_vs_cpu"] = res
    return out


# ------------------------------------ multi-device at world size 1 (A13)

MULTI_AGREEMENT = 0.999   # masks of two runs of the same code, where cuDNN may
                          # pick another algorithm between them
SHARDED_READ_TOL = 1e-4   # the sharded read against the single read (JAX's test's)


# The SAM encoder's tensor parallelism (phase 13 (f)): SAM-HQ vit_h at the
# rect encode (36x64 tokens) with the window kernel, against the unsharded
# encode of the same weights on the same card
TP_FP32_TOL = 2e-4       # max |diff| of the fp32 embedding (JAX's own TP test's)
TP_BF16_ATOL = 0.1       # bf16 embedding: |diff| within this ...
TP_BF16_SHARE = 0.999    # ... on this share of the elements (by share, as C8; PERF.md)
# SAM-HQ masks decoded from the TP embedding against the unsharded one's:
# in fp32; in bf16 at phase 5's bound for two bf16 encodes of one function
# (C16), since random-weight SAM's logits sit near 0 over large areas and
# bf16 rounding alone flips some (the unsharded bf16 masks against the fp32
# ones are logged beside it)
TP_MASK_AGREEMENT = 0.999
TP_BF16_MASK_AGREEMENT = 0.99


def _tp_encode_stats(torch, predictor, sam, tp, frame, scfg):
    """The TP encode against the unsharded one on `frame`: embedding and
    early-feature differences, and the agreement of every mask token the
    decoder computes from each for three click packs; and the unsharded
    masks."""
    got = predictor.encode_image(tp, frame, scfg)
    want = predictor.encode_image(sam, frame, scfg)
    d = (got.embedding.float() - want.embedding.float()).abs()
    di = (got.interm.float() - want.interm.float()).abs()
    dev = frame.device
    coords = torch.tensor([[[300.0, 200.0], [0, 0]], [[680.0, 90.0], [0, 0]],
                           [[300.0, 200.0], [680.0, 90.0]]], device=dev)
    labels = torch.tensor([[1, -1], [1, -1], [1, 0]], device=dev)
    mg = predictor.predict(tp, got, coords, labels, None, scfg).masks
    mw = predictor.predict(sam, want, coords, labels, None, scfg).masks
    return dict(max_abs_diff=float(d.max()), interm_max_abs_diff=float(di.max()),
                share_within_bf16_atol=float((d <= TP_BF16_ATOL).double().mean()),
                embedding_abs_max=float(want.embedding.float().abs().max()),
                mask_agreement=float((mg == mw).double().mean()),
                mask_tokens=int(mg.shape[1])), mw


def _tp_rank(reps: int):
    """One rank of the model-2 TP encode, spawned by `run_ranks(...,
    backend="gloo")`: two ranks share the card. Per dtype (bf16, then fp32;
    TF32 off): SAM-HQ vit_h from seed 1 (the facade's), one 480x854 frame,
    the TP encode with kernel counts from 0 around one encode; the wall ms
    of `reps` encodes (the ranks in step, by barriers); on rank 0 the
    unsharded encode's ms and `_tp_encode_stats`."""
    import torch
    import torch.distributed as dist

    from vosesam_tpu_torch.config import ParallelConfig
    from vosesam_tpu_torch.models.sam import predictor
    from vosesam_tpu_torch.parallel import mesh as meshlib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    pcfg = ParallelConfig(model_parallel=2)
    mesh = meshlib.make_mesh(pcfg)
    frame = torch.from_numpy(moving_frames(1, 480, 854, seed=5)).cuda()
    out = dict(rank=rank, shape=mesh.shape, backend=dist.get_backend(),
               model_group=dist.get_process_group_ranks(mesh.model_group))
    masks = {}
    for dtype in ("bfloat16", "float32"):
        scfg = _main_cfg(dtype, window_impl="pallas").sam
        sam = predictor.sam_init(scfg, seed=1, device="cuda", dtype=getattr(torch, dtype))
        tp = meshlib.shard_sam_params_tp(sam, mesh, pcfg)
        enc = lambda s: predictor.encode_image(s, frame, scfg)       # noqa: E731
        enc(tp)                                                      # warm-up
        torch.cuda.synchronize()
        _reset_all()
        emb = enc(tp)
        torch.cuda.synchronize()
        res = dict(counts=_read_all(), heads=tp.image_encoder.blocks[0].attn.heads,
                   finite=bool(torch.isfinite(emb.embedding.float()).all()))
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            emb = enc(tp)
        torch.cuda.synchronize()
        dist.barrier()
        res["tp_encode_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        if rank == 0:
            enc(sam)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                enc(sam)
            torch.cuda.synchronize()
            res["unsharded_encode_ms"] = (time.perf_counter() - t0) * 1e3 / reps
            stats, masks[dtype] = _tp_encode_stats(torch, predictor, sam, tp, frame, scfg)
            res.update(stats)
        else:
            enc(tp)              # rank 0's stats run one more TP encode
        dist.barrier()
        out[dtype] = res
        del sam, tp, emb
        torch.cuda.empty_cache()
    if rank == 0:
        out["unsharded_bf16_vs_fp32_mask_agreement"] = float(
            (masks["bfloat16"] == masks["float32"]).double().mean())
    return out


def _mask_agreement(a, b) -> float:
    """The share of equal pixels over two lists of masks of equal shapes."""
    same = sum(int((x == y).sum()) for x, y in zip(a, b))
    return same / sum(x.size for x in a)


def _jfap(rows):
    return [{k: r[k] for k in ("video", "J_mean", "F_mean", "JF_mean", "AP", "AP50", "AP75")}
            for r in rows]


def phase_multi_device(torch, card: str, reference: dict):
    """Multi-device at world size 1: an NCCL process group, rank 0 of 1,
    opened through a `file://` rendezvous in a temporary directory, and
    through it (a) `BatchedGenerator` over two 480x854 videos of 12 and 9
    frames with phase 9's `both_neg_C` model (XMem-s012 widths, SAM-HQ vit_h
    at the square encode, bf16): masks against the sequential tracker per
    video, chunk 8 against per frame, B1 and B3 launched and no plain call;
    (b) the DAVIS runner with `batched=` on phase 9's tree: its masks and J
    / F / AP columns against phase 9's sequential run (`reference`: its
    rows, masks and videos); (c) `TrackingAnything(
    inpaint_mesh=...)` on phase 8's 24-frame clip at 240x432 against the
    unsharded static path; (d) `sharded_memory_read_local` at phase 2's
    shapes against the single read; (e) one DP XMem toy step bit-equal to
    the non-DP step under deterministic algorithms (the shard and the
    all-reduce of one rank are identities); (f) the SAM encoder's tensor
    parallelism at model size 1 and 2 (`_tp_step`); (g) the group
    destroyed. Kernel counts are set to 0 before each run and read after."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from vosesam_tpu_torch.config import FrameworkConfig, ParallelConfig, RefinementConfig
    from vosesam_tpu_torch.eval import synthetic
    from vosesam_tpu_torch.eval.datasets import DavisDataset
    from vosesam_tpu_torch.eval.runner import run_model_on_davis_set
    from vosesam_tpu_torch.ops.kernels import deform_align as da
    from vosesam_tpu_torch.ops.memory_attention import read_memory_multiobject
    from vosesam_tpu_torch.parallel import mesh as meshlib
    from vosesam_tpu_torch.parallel.evaluation import BatchedGenerator
    from vosesam_tpu_torch.parallel.memory_shard import sharded_memory_read_local
    from vosesam_tpu_torch.pipeline.inpaint import Inpainter
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything
    from vosesam_tpu_torch.run_davis_test import CONFIGS, make_model
    from vosesam_tpu_torch.training import trainer as T

    h, w = 480, 854
    t_phase = time.time()
    out = dict(card=card)
    launches = {}

    def counted(label, fn):
        torch.cuda.synchronize()
        _reset_all()
        da.reset_counts()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        counts = dict(_read_all(), deform_patches_bounded=da.COUNTS["deform_patches_bounded"])
        counts["plain"] += da.COUNTS["plain"]
        check(counts["plain"] == 0, f"multi-device {label}: {counts['plain']} plain calls")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        out.setdefault("runs", {})[label] = dict(wall_s=time.perf_counter() - t, launches=counts)
        return result, counts

    tmp = tempfile.mkdtemp(prefix="vosesam_pg_")
    here = os.getcwd()
    t0 = time.time()
    rank, world = meshlib.init_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0,
                                           device="cuda")
    out["init_s"] = time.time() - t0
    try:
        check((rank, world) == (0, 1) and dist.get_backend() == "nccl",
              f"multi-device: group rank {rank} of {world}, backend {dist.get_backend()}")
        mesh = meshlib.make_mesh(ParallelConfig())
        check(mesh.shape == (1, 1) and mesh.data_group is not None, f"mesh {mesh.shape}")
        log(f"[multi] NCCL group of 1 through a file:// rendezvous in {out['init_s']:.2f} s")

        # (a) BatchedGenerator against the sequential tracker, chunk 8 against per frame
        args = argparse.Namespace(sam_model_type="vit_h", hq=True, xmem_checkpoint=None,
                                  sam_checkpoint=None, device="cuda")
        ta = make_model(args, CONFIGS["both_neg_C"])
        videos = [list(moving_frames(12, h, w, seed=21)), list(moving_frames(9, h, w, seed=22))]
        templates = [seed_mask(h, w), seed_mask(h, w)]
        seq = []
        for v, tm in zip(videos, templates):
            ta.xmem.clear_memory()
            seq.append(ta.generator(v, tm)[0])
        ta.xmem.clear_memory()
        gen = BatchedGenerator(ta.xmem_net, ta.sam, ta.cfg, mesh=mesh, device="cuda")
        got, counts = counted("batched", lambda: gen.run(videos, templates))
        check(counts["fused_memory_read_shared"] > 0 and counts["flash_attention_relpos"] > 0,
              f"multi-device batched: launches {counts}")
        gen8 = BatchedGenerator(ta.xmem_net, ta.sam, ta.cfg, mesh=mesh, chunk=8, device="cuda")
        got8, counts8 = counted("batched_chunk8", lambda: gen8.run(videos, templates))
        check(counts8["fused_memory_read_shared"] > 0 and counts8["flash_attention_relpos"] > 0,
              f"multi-device batched chunk 8: launches {counts8}")
        a_seq = [_mask_agreement(g["masks"], s_) for g, s_ in zip(got, seq)]
        a_chunk = [_mask_agreement(g["masks"], p["masks"]) for g, p in zip(got8, got)]
        check([len(g["masks"]) for g in got] == [12, 9] and [len(g["masks"]) for g in got8]
              == [12, 9], "multi-device: lanes' frame counts")
        check(min(a_seq) >= MULTI_AGREEMENT and min(a_chunk) >= MULTI_AGREEMENT,
              f"multi-device: batched vs sequential {a_seq}, chunk 8 vs per frame {a_chunk}")
        out["a"] = dict(batched_vs_sequential_equal_share=a_seq,
                        bitequal=[a == 1.0 for a in a_seq],
                        chunk8_vs_per_frame_equal_share=a_chunk)
        log(f"[multi] (a) BatchedGenerator, 2 videos of 12 and 9 frames at 480x854: equal "
            f"pixels vs the sequential tracker {a_seq}, chunk 8 vs per frame {a_chunk}; "
            f"launches {json.dumps(counts)} / {json.dumps(counts8)}")

        # (b) the DAVIS runner with batched= on phase 9's tree
        with tempfile.TemporaryDirectory(prefix="vosesam_eval_") as etmp:
            os.chdir(etmp)
            try:
                synthetic.write_tree("data", h, w, seed=7, davis_frames=16, long_frames=24,
                                     long_every=8, lvos_frames=12, ovis_frames=8)
                davis = DavisDataset("data/DAVIS", "2017/val.txt")
                kept = []
                run_lanes = gen.run

                def keep(v, tm):
                    res = run_lanes(v, tm)
                    kept.extend(r["masks"] for r in res)
                    return res

                gen.run = keep
                rows, counts = counted("davis_batched", lambda: run_model_on_davis_set(
                    "davis_both_neg_C_batched", ta, davis, batched=gen))
                gen.run = run_lanes
            finally:
                os.chdir(here)
        agree = [_mask_agreement(k, r) for k, r in zip(kept, reference["masks"])]
        same_columns = _jfap(rows) == _jfap(reference["rows"])
        check([r["video"] for r in rows] == reference["videos"],
              f"multi-device runner: videos {[r['video'] for r in rows]}")
        check(min(agree) >= MULTI_AGREEMENT and (same_columns or min(agree) < 1.0),
              f"multi-device runner: equal pixels {agree}, J / F / AP equal {same_columns}: "
              f"{_jfap(rows)} vs {_jfap(reference['rows'])}")
        out["b"] = dict(equal_pixels=agree, jfap_equal=same_columns, rows=_jfap(rows))
        log(f"[multi] (b) DAVIS runner batched= on phase 9's tree: equal pixels vs phase 9's "
            f"sequential run {agree}, J / F / AP columns equal: {same_columns}")
        del ta, gen, gen8
        torch.cuda.empty_cache()

        # (c) Inpainter(mesh=...) through the facade against the unsharded path
        cfg = FrameworkConfig(refinement=RefinementConfig(use_refinement=False),
                              dtype="bfloat16")
        ta2 = TrackingAnything(cfg=cfg, device="cuda", seed=0,
                               e2fgvi_checkpoint="random-weights", inpaint_mesh=mesh)
        drv = ta2.baseinpainter
        check(drv.mesh is mesh, "multi-device: the facade's inpainter has no mesh")
        _randomise_offset_heads(torch, drv.net, seed=11)
        clip = list(moving_frames(24, h, w, seed=7))
        masks = ta2.generator(clip, seed_mask(h, w))[0]
        flat = Inpainter(cfg=drv.cfg, net=drv.net, device="cuda")
        allow_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True          # phase 8's counted setting
        try:
            sharded, counts = counted("inpaint_mesh", lambda: drv.inpaint(clip, masks,
                                                                          ratio=0.5))
            want = flat.inpaint(clip, masks, ratio=0.5)
        finally:
            torch.backends.cudnn.allow_tf32 = allow_tf32
        calls, expect = _inpaint_windows(drv, len(clip))
        check(counts["deform_patches_bounded"] == expect,
              f"multi-device inpaint: B6 {counts['deform_patches_bounded']}, expected {expect}")
        d = np.abs(np.stack(sharded).astype(np.int32) - np.stack(want).astype(np.int32))
        check(int(d.max()) <= 1, f"multi-device inpaint: {int(d.max())} grey levels from the "
                                 f"unsharded path")
        out["c"] = dict(max_grey_levels=int(d.max()), bitequal_share=float((d == 0).mean()),
                        windows=calls, b6_launches=counts["deform_patches_bounded"])
        log(f"[multi] (c) Inpainter(mesh=...) on the 24-frame clip at 240x432: "
            f"{json.dumps(out['c'])}")
        del ta2, drv, flat
        torch.cuda.empty_cache()

        # (d) the sharded read at phase 2's shapes against the single read
        gen_t = torch.Generator(device="cuda").manual_seed(31)
        o, q, ck, cv, k = 2, 1620, 64, 512, 30
        m = 1000 + 10 * q
        mk = torch.randn((m, ck), generator=gen_t, device="cuda").to(torch.bfloat16)
        ms = 1.0 + torch.randn((m,), generator=gen_t, device="cuda") ** 2
        qk = torch.randn((q, ck), generator=gen_t, device="cuda").to(torch.bfloat16)
        qe = torch.sigmoid(torch.randn((q, ck), generator=gen_t, device="cuda")).to(
            torch.bfloat16)
        mv = torch.randn((o, m, cv), generator=gen_t, device="cuda").to(torch.bfloat16)
        kv = torch.arange(m, device="cuda") < 1000 + 9 * q
        vv = torch.stack([kv, kv & (torch.arange(m, device="cuda") % 3 != 0)])
        got_r, got_u = sharded_memory_read_local(mk, ms, qk, qe, mv, vv, k)
        want_r, want_u = read_memory_multiobject(mk, ms, mv, qk, qe, kv, vv, k,
                                                 return_usage=True)
        err_r = float((got_r - want_r).abs().max())
        err_u = float((got_u - want_u).abs().max())
        check(err_r <= SHARDED_READ_TOL and err_u <= SHARDED_READ_TOL,
              f"multi-device sharded read: readout {err_r}, usage {err_u}")
        out["d"] = dict(readout_max_abs_err=err_r, usage_max_abs_err=err_u, tol=SHARDED_READ_TOL)
        log(f"[multi] (d) sharded_memory_read_local at Q 1620, M 17 200, O 2 over NCCL: "
            f"{json.dumps(out['d'])}")

        # (e) one DP toy step against the non-DP step, bit for bit. At world
        # size 1 the batch's shard and the all-reduce are identities, so the
        # DP step is the non-DP step's computation. By default two steps on
        # the card differ (an op with nondeterministic CUDA atomics, such as
        # `torch.gather`'s backward in the bootstrapped cross-entropy, has a
        # deterministic alternative): the compared steps run under
        # torch.use_deterministic_algorithms
        rng = np.random.default_rng(0)
        frames = (0.01 * rng.normal(size=(2, 3, 64, 64, 3))).astype(np.float32)
        gt = np.zeros((2, 3, 64, 64), np.int32)
        gt[:, :, 16:40, 16:40] = 1
        gt[1, :, 40:60, 4:24] = 2
        ov = np.array([[True, False], [True, True]])
        batch = [torch.from_numpy(x).cuda() for x in (frames, gt, ov)]
        shard_identity = all(torch.equal(a, b)
                             for a, b in zip(meshlib.shard_batch(batch, mesh), batch))
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            default = _toy_step(torch, "cuda", frames, gt, ov)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                single = _toy_step(torch, "cuda", frames, gt, ov)
                dp = _toy_step(torch, "cuda", frames, gt, ov, mesh=mesh)
            finally:
                torch.use_deterministic_algorithms(False)
        finally:
            torch.backends.cudnn.deterministic = det
        grads = {k: v.cuda() for k, v in single[0].items()}
        loss, aux = torch.tensor(single[1], device="cuda"), {"ce": grads[next(iter(grads))].sum()}
        rg, rl, ra = T.all_reduce_mean(grads, loss, aux, mesh)
        reduce_identity = (all(torch.equal(rg[k], grads[k]) for k in grads)
                           and torch.equal(rl, loss) and torch.equal(ra["ce"], aux["ce"]))
        dp_diff = _step_diff(torch, dp, single)
        out["e"] = dict(shard_identity=shard_identity, all_reduce_identity=reduce_identity,
                        dp_vs_non_dp=dp_diff, loss_equal=dp[1] == single[1],
                        default_mode_vs_deterministic=_step_diff(torch, default, single))
        log(f"[multi] (e) one DP toy step over NCCL against the non-DP step, deterministic "
            f"algorithms: {json.dumps(out['e'])}")
        check(shard_identity and reduce_identity,
              f"multi-device: at world size 1 the shard ({shard_identity}) or the all-reduce "
              f"({reduce_identity}) changed its input")
        check(dp[1] == single[1] and not any(dp_diff.values()),
              f"multi-device DP step: loss {dp[1]} vs {single[1]}, {dp_diff} from the non-DP "
              f"step")

        # (f) the SAM encoder's tensor parallelism: at model size 1 in this
        # NCCL group, then at model size 2 in two gloo ranks on this card
        out["f"] = _tp_step(torch, mesh, counted, launches)
    finally:
        os.chdir(here)
        t0 = time.time()
        meshlib.destroy()
        out["destroy_s"] = time.time() - t0
        shutil.rmtree(tmp, ignore_errors=True)
    check(not dist.is_initialized(), "multi-device: the group outlived its phase")
    out.update(launches=launches, seconds=time.time() - t_phase)
    log(f"[multi] (g) group destroyed in {out['destroy_s']:.3f} s; phase 13 took "
        f"{out['seconds']:.1f} s; launches {json.dumps(launches)}")
    return out


# ------------------------------------------------------ the bench (A14)

BENCH_KEYS = ("metric", "value", "unit", "fps_median", "fps_runs", "lt_count",
              "stage_ms_per_frame", "encode_grid", "encode_tflops", "mfu_vs_peak",
              "interactive_ms", "inpaint_ms_per_window", "inpaint_ms_per_output_frame",
              "peak_memory_bytes", "letterbox_fps", "letterbox_fps_runs",
              "read_ms_at_occupancy", "read_device_ms_at_occupancy", "fps_by_objects",
              "soak", "device")
OCCUPANCY_KEYS = {"live_1", "live_0.5", "live_0.25"}
CORRIDOR_CALLS = 20      # the bench's corridor: ms over 20 back-to-back calls, plus a first


def phase_bench(torch, card: str, frames: int = 16, objects_frames: int = 16,
                soak_frames: int = 448):
    """`python -m vosesam_tpu_torch.bench` in this process (`bench.run`,
    with the sensitivity rows its `main` runs) at BENCH_FRAMES=`frames`,
    BENCH_SOAK_FRAMES=`soak_frames` and `objects_frames` measured frames a
    rep in the object-count rows, every other knob at its default (3 reps
    of the continued rollout: at 16 frames a rep the long-term memory fills
    during the second), at full width (vit_h SAM-HQ, rect, chunk 8, bf16,
    480x854) and PyTorch's default precision (TF32 convolutions) as the
    bench runs alone. The JSON line parses with every key; fps > 0, the
    stage table and the extras present, `lt_count` > 0, `mfu_vs_peak` in
    (0, 1]; the letterbox row > 0; four object-count rows > 0; the three
    corridor entries finite and > 0, with the kernel's and
    `get_similarity`'s device time beside them; the soak (which raises if
    its arena accounting, saturation or eviction-overwrite checks fail)
    with its analytic schedule, long-term memory saturated at 1000,
    eviction cycles and overwrites > 0, its windows and the fresh-state
    control. Kernel counts from 0 around the run."""
    from vosesam_tpu_torch import bench
    from vosesam_tpu_torch.ops.kernels import deform_align as da

    env = dict(bench.DEFAULTS, BENCH_FRAMES=str(frames), BENCH_SOAK_FRAMES=str(soak_frames))
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        torch.cuda.synchronize()
        _reset_all()
        da.reset_counts()
        t0 = time.time()
        line = bench.run(env, device="cuda", sensitivity=True, objects_frames=objects_frames)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    counts = dict(_read_all(), deform_patches_bounded=da.COUNTS["deform_patches_bounded"])
    counts["plain"] += da.COUNTS["plain"]
    text = json.dumps(line)
    parsed = json.loads(text)
    missing = [k for k in BENCH_KEYS if k not in parsed]
    check(not missing, f"bench: keys missing {missing}")
    check(parsed["unit"] == "fps" and parsed["value"] > 0, f"bench: {parsed['value']} fps")
    check(set(parsed["stage_ms_per_frame"]) == {"encode", "xmem", "encode_refine", "total"}
          and all(v > 0 for v in parsed["stage_ms_per_frame"].values()),
          f"bench: stages {parsed['stage_ms_per_frame']}")
    check(parsed["lt_count"] > 0, f"bench: long-term memory unused (lt_count "
                                  f"{parsed['lt_count']})")
    check(0.0 < parsed["mfu_vs_peak"] <= 1.0, f"bench: mfu_vs_peak {parsed['mfu_vs_peak']}")
    check(parsed["device"] == card, f"bench: device {parsed['device']!r} vs {card!r}")
    check(parsed["letterbox_fps"] > 0 and len(parsed["letterbox_fps_runs"]) == 3,
          f"bench: letterbox {parsed['letterbox_fps_runs']}")
    objs = parsed["fps_by_objects"]
    check(set(objs) == {"1", "2", "4", "8"} and all(v > 0 for v in objs.values()),
          f"bench: fps_by_objects {objs}")
    wall, dev_ms = parsed["read_ms_at_occupancy"], parsed["read_device_ms_at_occupancy"]
    check(set(wall) == OCCUPANCY_KEYS and set(dev_ms) == OCCUPANCY_KEYS
          and all(math.isfinite(v) and v > 0 for v in wall.values())
          and all(math.isfinite(v) and v > 0 for d in dev_ms.values() for v in d.values()),
          f"bench: read corridor {wall} {dev_ms}")
    soak = parsed["soak"]
    hw_tok = 30 * 54                              # 480x854 -> 30 x 54 tokens
    adds = soak_frames // 5 + 1                   # a memory frame every 5
    consols = 1 + (adds - 10) * hw_tok // (5 * hw_tok)   # fills at 10, keeps 5
    check(soak["frames"] == soak_frames and soak["consolidations"] == consols
          and soak["lt_eviction_cycles"] == consols - 1000 // 128 > 0
          and soak["lt_valid_final"] == 1000 and soak["lt_overwrites_observed"] > 0,
          f"bench: soak schedule {soak}")
    check(set(soak["fps_windows"]) == {"frame_64", "frame_tail"}
          and all(v > 0 for v in soak["fps_windows"].values())
          and soak["fps_fresh_control"] > 0 and soak["peak_device_bytes"] > 0,
          f"bench: soak windows {soak}")
    check(counts["plain"] == 0 and counts["fused_memory_read_shared"] > 3 * (CORRIDOR_CALLS + 1)
          and counts["flash_attention_relpos"] > 0 and counts["deform_patches_bounded"] > 0,
          f"bench: launches {counts}")
    log(f"[bench] {card}; python -m vosesam_tpu_torch.bench at BENCH_FRAMES={frames}, "
        f"{objects_frames} frames a rep in fps_by_objects, BENCH_SOAK_FRAMES={soak_frames} "
        f"(~{consols} consolidations, {consols - 1000 // 128} eviction cycles) in "
        f"{seconds:.1f} s: {text}")
    log(f"[bench] launches {json.dumps(counts)}; of B1's, {3 * (CORRIDOR_CALLS + 1)} the "
        f"read corridor's wrapper calls")
    return dict(line=parsed, seconds=seconds, launches=counts)


# ------------------------------------------- the parity runner (A16)

def phase_parity(torch, card: str, n_frames: int = 8, long_frames: int = 16,
                 lvos_frames: int = 8):
    """The J&F parity runner and the checkpoint-day pipeline at full width,
    in a temporary directory: official-schema checkpoints from seeded
    modules on the card (XMem-s012's widths, SAM vit_h and SAM-HQ vit_h,
    fp32) and a 480x854 synthetic tree (`eval/synthetic.py`: DAVIS
    `n_frames` a video, LongDataset `long_frames` with ground truth every
    8th, LVOS `lvos_frames`; the test_sample clip where imageio can write
    it, else config 2 is a SKIP row that says so). Then `python -m
    vosesam_tpu_torch.run_parity` in this process sequentially and with
    `--chunk 8` (the official square encode, bf16), each with kernel counts
    from 0: configs 1, 3 and 4 give J&F in [0, 1], config 5 saves masks,
    the chunked rows' J, F and J&F equal the sequential rows', B1 and B3
    launched and no plain call; then `python -m
    vosesam_tpu_torch.checkpoint_day` once in a process of its own (phase
    A with `--chunk 8 --batch`, a group of one; phase B at letterbox
    448x896): a verdict, phase A's J&F equal to the sequential rows', the
    launches its `run_parity` processes record. Seconds of each run."""
    import shutil
    import tempfile

    from vosesam_tpu_torch import checkpoint_day as cd
    from vosesam_tpu_torch import run_parity as rp
    from vosesam_tpu_torch.config import SAMConfig, XMemConfig

    here = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="vosesam_parity_")
    out = {"seconds": {}}
    try:
        os.chdir(tmp)
        t0 = time.time()
        rp.write_checkpoints("ck", SAMConfig(model_type="vit_h"),
                             SAMConfig(model_type="vit_h", hq=True), xmem_cfg=XMemConfig(),
                             device="cuda")
        torch.cuda.empty_cache()
        out["seconds"]["checkpoints"] = time.time() - t0
        t0 = time.time()
        clip_missing = rp.write_data("data", 480, 854, frames=dict(
            davis_frames=n_frames, long_frames=long_frames, long_every=8,
            lvos_frames=lvos_frames, ovis_frames=1))
        out["seconds"]["data"] = time.time() - t0
        log(f"[parity] checkpoints {out['seconds']['checkpoints']:.1f} s, 480x854 tree "
            f"{out['seconds']['data']:.1f} s; config 2 "
            + (f"is a SKIP row: {clip_missing}" if clip_missing else "runs on the clip"))
        rows, launches = {}, {}
        for name, extra in (("sequential", []), ("chunk_8", ["--chunk", "8"])):
            torch.cuda.synchronize()
            _reset_all()
            t0 = time.time()
            rows[name] = rp.main(["--checkpoints", "ck", "--data", "data", "--out", name,
                                  "--device", "cuda", *extra])
            torch.cuda.synchronize()
            out["seconds"][name] = time.time() - t0
            launches[name] = _read_all()
            got = rows[name]
            check([r["config"] for r in got] == list(rp.CONFIGS), f"parity {name}: {got}")
            for r in (got[0], got[2], got[3]):
                check(all(0.0 <= r[k] <= 1.0 for k in ("J_mean", "F_mean", "JF_mean"))
                      and r["fps"] > 0, f"parity {name}: {r}")
            check(got[4]["note"].startswith("masks saved"), f"parity {name}: {got[4]}")
            check(os.path.exists("result/parity5_lvos/masks/clip/00000.png"),
                  f"parity {name}: LVOS masks not saved")
            if clip_missing:
                check(got[1]["note"] == "SKIP: needs imageio to read the test_sample clip",
                      f"parity {name}: {got[1]}")
            else:
                check(got[1]["fps"] > 0, f"parity {name}: {got[1]}")
            n = launches[name]
            check(n["plain"] == 0 and n["fused_memory_read_shared"] > 0
                  and n["flash_attention_relpos"] > 0, f"parity {name}: launches {n}")
            log(f"[parity] run_parity {name}: {out['seconds'][name]:.1f} s; launches "
                f"{json.dumps(n)}; rows {json.dumps(got)}")
        metrics = ("J_mean", "F_mean", "JF_mean")
        for a, b in zip(rows["sequential"], rows["chunk_8"]):
            check({k: a[k] for k in metrics} == {k: b[k] for k in metrics},
                  f"parity: chunk 8 {b} against sequential {a}")
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", "vosesam_tpu_torch.checkpoint_day",
                               "--checkpoints", "ck", "--data", "data", "--out", "cd"],
                              capture_output=True, text=True, timeout=900,
                              env=dict(os.environ, PYTHONPATH=os.path.dirname(
                                  os.path.realpath(__file__))))
        out["seconds"]["checkpoint_day"] = time.time() - t0
        check(proc.returncode == 0, f"checkpoint_day: rc {proc.returncode}\n"
                                    f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open("cd/checkpoint_day_report.json") as f:
            report = json.load(f)
        v = cd.compute_verdict(report["official"], report["letterbox"], 0.2)
        check(report["letterbox_verdict"] in ("promote", "keep")
              and report["letterbox_verdict"] == v["verdict"] and v["deltas"],
              f"checkpoint_day: {report['letterbox_verdict']} {v}")
        for a, b in zip(rows["sequential"], report["official"]):
            check({k: a[k] for k in metrics} == {k: b[k] for k in metrics},
                  f"checkpoint_day: phase A {b} against sequential {a}")
        for phase in ("official", "letterbox"):
            with open(f"cd/{phase}/kernel_launches.json") as f:
                n = json.load(f)
            check(n["plain"] == 0 and n["fused_memory_read_shared"] > 0
                  and n["flash_attention_relpos"] > 0, f"checkpoint_day {phase}: {n}")
            launches[f"checkpoint_day_{phase}"] = n
        log(f"[parity] checkpoint_day (phases A and B, two run_parity processes): "
            f"{out['seconds']['checkpoint_day']:.1f} s; verdict {report['letterbox_verdict']}, "
            f"deltas {json.dumps(report['letterbox_jf_delta'])}; launches "
            f"{json.dumps({k: launches[k] for k in launches if k.startswith('checkpoint')})}")
    finally:
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["rows"] = rows
    log(f"[parity] {card}; phase 15 seconds {json.dumps(out['seconds'])}")
    return out


def _tp_step(torch, mesh, counted, launches, reps: int = 5):
    """Phase 13 (f). Model size 1: `shard_sam_params_tp` over phase 13's
    (1 x 1) mesh returns the SAM it was given, so the encode is bit-equal
    to the unsharded one (B3 and B4 launched, no plain call). Model size 2:
    `_tp_rank` in two ranks of a gloo group on this card (NCCL refuses two
    ranks on one device): per rank and encode 4 B3 and 28 B4 launches at 8
    heads, no plain call; bf16 within TP_BF16_ATOL on TP_BF16_SHARE of the
    embedding, fp32 within TP_FP32_TOL; the decoder's masks from each
    embedding agree on TP_MASK_AGREEMENT of the pixels in fp32 and on
    TP_BF16_MASK_AGREEMENT in bf16. The wall ms of a
    model-2 encode beside the unsharded one: two ranks on one card show no
    scaling."""
    from vosesam_tpu_torch.config import ParallelConfig
    from vosesam_tpu_torch.models.sam import predictor
    from vosesam_tpu_torch.parallel import mesh as meshlib

    scfg = _main_cfg("bfloat16", window_impl="pallas").sam
    sam = predictor.sam_init(scfg, seed=1, device="cuda", dtype=torch.bfloat16)
    frame = torch.from_numpy(moving_frames(1, 480, 854, seed=5)).cuda()
    one = meshlib.shard_sam_params_tp(sam, mesh, ParallelConfig())
    want = predictor.encode_image(sam, frame, scfg)
    got, counts = counted("tp_model1", lambda: predictor.encode_image(one, frame, scfg))
    bitequal = (one is sam and torch.equal(got.embedding, want.embedding)
                and torch.equal(got.interm, want.interm))
    check(bitequal and counts["flash_attention_relpos"] == GLOBAL_BLOCKS
          and counts["window_attention_relpos"] == WINDOWED_BLOCKS,
          f"TP at model size 1: bit-equal {bitequal}, launches {counts}")
    res = dict(model1=dict(bitequal=bitequal, launches=counts))
    log(f"[multi] (f) TP at model size 1 (phase 13's NCCL group): the encode is bit-equal "
        f"to the unsharded one; launches {json.dumps(counts)}")
    del sam, one, got, want
    torch.cuda.empty_cache()

    t0 = time.time()
    ranks = meshlib.run_ranks(_tp_rank, 2, reps, device="cuda", backend="gloo", timeout_s=900)
    res["model2_s"] = time.time() - t0
    for r in ranks:
        check(r["backend"] == "gloo" and r["shape"] == (1, 2) and r["model_group"] == [0, 1],
              f"TP ranks: {r['backend']} {r['shape']} {r['model_group']}")
        for dtype in ("bfloat16", "float32"):
            c = r[dtype]["counts"]
            check(r[dtype]["finite"] and r[dtype]["heads"] == 8, f"TP rank {r['rank']} {dtype}: "
                  f"finite {r[dtype]['finite']}, heads {r[dtype]['heads']}")
            check(c["flash_attention_relpos"] == GLOBAL_BLOCKS
                  and c["window_attention_relpos"] == WINDOWED_BLOCKS and c["plain"] == 0,
                  f"TP rank {r['rank']} {dtype}: launches per encode {c}")
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
    bf, fp = ranks[0]["bfloat16"], ranks[0]["float32"]
    res["model2"] = [{k: r[k] for k in ("bfloat16", "float32")} for r in ranks]
    log(f"[multi] (f) TP at model size 2, two gloo ranks on the card: bf16 "
        f"{json.dumps({k: v for k, v in bf.items() if k != 'counts'})}; fp32 "
        f"{json.dumps({k: v for k, v in fp.items() if k != 'counts'})}; launches per rank "
        f"and encode {json.dumps(bf['counts'])}; {res['model2_s']:.1f} s; a model-2 encode "
        f"{bf['tp_encode_ms']:.1f} ms (rank 0) against the unsharded "
        f"{bf['unsharded_encode_ms']:.1f} ms: two ranks on one card show no scaling; the "
        f"unsharded bf16 masks against the fp32 ones: "
        f"{ranks[0]['unsharded_bf16_vs_fp32_mask_agreement']}")
    res["unsharded_bf16_vs_fp32_mask_agreement"] = ranks[0]["unsharded_bf16_vs_fp32_mask_agreement"]
    check(fp["max_abs_diff"] <= TP_FP32_TOL and fp["interm_max_abs_diff"] <= TP_FP32_TOL,
          f"TP fp32: max |diff| {fp['max_abs_diff']} / {fp['interm_max_abs_diff']} above "
          f"{TP_FP32_TOL}")
    check(bf["share_within_bf16_atol"] >= TP_BF16_SHARE,
          f"TP bf16: {bf['share_within_bf16_atol']} of the embedding within {TP_BF16_ATOL}")
    check(fp["mask_agreement"] >= TP_MASK_AGREEMENT
          and bf["mask_agreement"] >= TP_BF16_MASK_AGREEMENT,
          f"TP masks: agreement fp32 {fp['mask_agreement']}, bf16 {bf['mask_agreement']}")
    return res


def _profile_frames(torch, step, n_prof: int):
    """torch.profiler over `n_prof` calls of step(i): device time by kernel
    and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_prof):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:25]
    rows = [dict(name=e.key[:90], ms_per_frame=e.self_device_time_total / 1e3 / n_prof,
                 calls_per_frame=e.count / n_prof) for e in top]
    # device kernels of interest by a part of their name: the port's own
    # attention kernels, the fp32 FFMA GEMMs (the rel-pos factors), B6 and
    # B6-bwd (`deform_bwd_lanes_kernel`, `deform_bwd_sample_kernel`)
    by_name = {}
    for part in ("window_relpos", "flash_relpos", "ffma", "deform_patches", "deform_bwd"):
        hits = [e for e in events if part in e.key]
        by_name[part] = dict(
            ms_per_frame=sum(e.self_device_time_total for e in hits) / 1e3 / n_prof,
            calls_per_frame=sum(e.count for e in hits) / n_prof)
    return dict(frames=n_prof, wall_ms_per_frame=wall_ms / n_prof,
                device_busy_ms_per_frame=busy_ms / n_prof,
                device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                device_kernel_launches_per_frame=sum(e.count for e in events) / n_prof,
                by_name=by_name, top=rows)


def phase_profile(torch, n_warm: int = 12, n_prof: int = 8):
    """Not part of the default run. torch.profiler over steady frames of
    (a) the XMem-only step (bf16, shared-validity read) and (b) the main
    path (phase 5's config, per-frame `Tracker.track` with refinement) with
    the default windowed impl and again with the window kernel; then one
    inpaint window (TF32 on and off) and phase 12's GAN training step."""
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

    h, w = 480, 854
    frames = moving_frames(n_warm + n_prof, h, w)
    out = {}
    ta = _make_tracker("bfloat16")
    _drive(ta, frames[:n_warm], add_at=-1)
    out["xmem"] = _profile_frames(torch, lambda i: ta.xmem.track(frames[n_warm + i]), n_prof)
    del ta
    torch.cuda.empty_cache()
    for name, impl in (("main_path", "xla_fused_bias"), ("main_path_pallas", "pallas")):
        ta = TrackingAnything(cfg=_main_cfg("bfloat16", window_impl=impl), device="cuda",
                              seed=0)
        ta.generator(frames[:n_warm], seed_mask(h, w))
        out[name] = _profile_frames(torch, lambda i: ta.xmem.track(frames[n_warm + i]), n_prof)
        del ta
        torch.cuda.empty_cache()
    # one inpaint window (the default InpainterConfig, fp32) per profiled
    # step, with cuDNN's TF32 convolutions (PyTorch's default) and without:
    # "per frame" below reads "per window"
    from vosesam_tpu_torch.pipeline.inpaint import Inpainter

    drv = Inpainter(device="cuda", seed=2)
    _randomise_offset_heads(torch, drv.net, seed=11)
    clip = list(moving_frames(24, h, w, seed=7))
    masks = [(add_mask(h, w, i) > 0).astype(np.uint8) for i in range(24)]
    padded = drv._preprocess(clip, masks, 0.5, drv.cfg.dilate_radius)[2]
    groups = drv._windows(24)
    for name, tf32 in (("inpaint_window", True), ("inpaint_window_tf32_off", False)):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            drv._predict(padded, groups[2])
            out[name] = _profile_frames(
                torch, lambda i: drv._predict(padded, groups[1 + i % 3]), 3)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    del drv, padded
    torch.cuda.empty_cache()
    # one GAN training step of phase 12's recipe (full width, T 8 = 5 + 3,
    # TF32 convolutions) per profiled step: "per frame" below reads "per step"
    from vosesam_tpu_torch.config import InpainterConfig
    from vosesam_tpu_torch.models.e2fgvi import discriminator as D
    from vosesam_tpu_torch.models.e2fgvi import generator as G
    from vosesam_tpu_torch.training import inpaint_trainer as IT

    gen = G.generator_init(device="cuda")
    _randomise_offset_heads(torch, gen, seed=14)
    state = IT.init_train_state(gen, D.discriminator_init(seed=1, device="cuda"))
    r = np.random.default_rng(15)
    fr = torch.from_numpy(r.uniform(-1, 1, (8, 240, 432, 3)).astype(np.float32)).cuda()
    mk = torch.zeros((8, 240, 432, 1), device="cuda")
    mk[:, 60:180, 100:300] = 1.0
    gen_cfg, tcfg = InpainterConfig(), IT.InpaintTrainConfig()
    torch.backends.cudnn.allow_tf32 = True
    try:
        IT.train_step(state, fr, mk, 5, gen_cfg, tcfg)
        out["inpaint_train_step"] = _profile_frames(
            torch, lambda i: IT.train_step(state, fr, mk, 5, gen_cfg, tcfg), 2)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    del state, gen, fr, mk
    torch.cuda.empty_cache()
    for name, summary in out.items():
        log(f"[profile {name}] {json.dumps(summary)}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile steady frames (device time by kernel)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    # the port must be the checkout's own, beside this script
    here = os.path.dirname(os.path.realpath(__file__))
    try:
        import vosesam_tpu_torch
    except ImportError as e:
        print(f"FAIL: the port is not importable here: {e}", file=sys.stderr)
        return 1
    if os.path.dirname(os.path.dirname(os.path.realpath(vosesam_tpu_torch.__file__))) != here:
        print(f"FAIL: vosesam_tpu_torch comes from {vosesam_tpu_torch.__file__}, "
              f"not from the checkout at {here}", file=sys.stderr)
        return 1

    record = {}
    try:
        t_start = time.time()
        record["card"] = phase_setup(torch)
        kernels = phase_kernels(torch)
        b3, record["b3_cases"] = phase_flash_kernel(torch)
        kernels.append(b3)
        torch.cuda.empty_cache()     # phase 2b's large plain-version buffers
        window, record["window_cases"] = phase_window_kernel(torch)
        kernels.extend(window)
        torch.cuda.empty_cache()
        b6, record["deform_cases"] = phase_deform_kernel(torch)
        b6_bwd, record["deform_backward_cases"] = phase_deform_backward(torch)
        b7, record["binscan_probe"] = phase_binscan_probe(torch)
        record["grad_refusal"] = phase_grad_refusal(torch)
        torch.cuda.empty_cache()
        counts, record["e2e"] = phase_end_to_end(torch)
        record["rollout_fp32"] = phase_kernel_vs_plain_rollout(torch)
        record["c24"] = phase_c24(torch)
        record["main_path"], record["sam_init_s"] = phase_main_path(torch)
        record["main_fp32"] = phase_main_kernel_vs_plain(torch)
        record["interactive"] = phase_interactive(torch)
        record["inpaint"] = phase_inpaint(torch)
        torch.cuda.empty_cache()
        record["eval"] = phase_eval(torch)
        torch.cuda.empty_cache()
        record["serve"] = phase_serve(torch, record["card"])
        record["train"] = phase_train(torch, record["card"])
        torch.cuda.empty_cache()
        record["inpaint_train"] = phase_inpaint_train(torch, record["card"])
        torch.cuda.empty_cache()
        record["multi_device"] = phase_multi_device(torch, record["card"],
                                                    record["eval"].pop("reference"))
        torch.cuda.empty_cache()
        t0 = time.time()
        record["bench"] = phase_bench(torch, record["card"])
        torch.cuda.empty_cache()
        t1 = time.time()
        record["parity"] = phase_parity(torch, record["card"])
        log(f"phase 14 took {t1 - t0:.1f} s, phase 15 {time.time() - t1:.1f} s")
        serving = (record["serve"]["launches"], record["serve"]["app"]["launches"],
                   record["bench"]["launches"], *record["parity"]["launches"].values())
        multi = record["multi_device"]["launches"]
        # launches: the sum over the main-path runs (phase 3, each of phase
        # 5's runs, phase 7, phase 9's runs, phase 10's requests and its app
        # session, phase 13's runs, phase 14's bench, phase 15's parity
        # runs), each counted from 0 right before the run
        for kr in kernels:
            kr["launches"] = counts.get(kr["name"], 0) + sum(
                r["launches"][kr["name"]] for r in record["main_path"].values()
            ) + record["interactive"]["launches"][kr["name"]] + record["eval"]["launches"].get(
                kr["name"], 0) + sum(c.get(kr["name"], 0) for c in serving) + multi.get(
                kr["name"], 0)
            check(kr["launches"] > 0, f"{kr['name']} never launched on the main path")
        # B6: the sum over phase 8's inpaint runs, phase 10's requests and
        # app session, phase 12's training steps, phase 13's inpaint and phase
        # 14's bench, each counted from 0; its backward: phase 12's
        trained = record["inpaint_train"]["launches"]
        b6["launches"] = record["inpaint"]["b6_launches"] + sum(
            c.get("deform_patches_bounded", 0) for c in serving) \
            + trained["deform_patches_bounded"] + multi["deform_patches_bounded"]
        check(b6["launches"] > 0, "deform_patches_bounded never launched on the inpaint path")
        b6_bwd["launches"] = trained["deform_patches_backward"]
        check(b6_bwd["launches"] > 0, "deform_patches_backward never launched in training")
        # B7 is a probe on no product path: its launches are those of its own
        # entry point's run in phase 2e, counted from 0 there
        check(b7["launches"] > 0, "binscan_probe never launched in its probe run")
        kernels.extend([b6, b6_bwd, b7])
        record["seconds"] = time.time() - t_start
        if args.profile:
            record["profile"] = phase_profile(torch)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    record["kernels"] = kernels
    record["occupancy"] = OCCUPANCY
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    log(record["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
