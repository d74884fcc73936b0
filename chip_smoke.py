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
     the same inputs give bit-equal usage and readout; CUDA-event timings
     (median of 25 after warm-up) and device time beside the bound (and the
     bound at the tensor-core rate of the similarity the kernels compute);
     each kernel instance's registers, shared memory and blocks per SM;
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
  2e. kernel vs plain for B7 (the bin-scan probe) at the probe's shapes and
     small odd ones, then the probe's own run, counted from 0: the card's
     multiply-add rate in the scan and the scan's projected time per
     alignment call beside B6's;
  2f. each kernel entry point (B1, B2, B3, B4, B5, B6, B7) raises under
     grad mode for an input that requires grad, and runs under no_grad;
  3. XMem end to end: `TrackingAnything` (XMem-s012 widths, default
     MemoryConfig, bf16, no refinement) tracks a 64-frame 480x854 clip with
     two objects seeded on frame 0 and a third added on frame 40;
  4. XMem kernel vs plain end to end: 16 frames in fp32 twice, once through
     the kernels and once with `MemoryConfig(fused_read=False)`;
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
Kernel launch counts are set to 0 right before each main-path run (phases
3, 5, 7 and 8) and read right after; the `kernels` line sums them (B7, a
probe on no product path, counts its own run in phase 2e).
The last two lines are the `kernels` JSON line and the result line
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
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
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain)
        # the launches alone, without the wrapper's checks: with the
        # similarity fused there is nothing else to take out
        shared = name == "fused_memory_read_shared"
        check(mr._tensor_cores(case["mk"], case["qk"], case["qe"]),
              f"{name}: bf16 keys did not take the tensor cores")
        kernel_only_ms = time_ms(torch, lambda: mr._launch(
            case["mk"], case["ms"], case["qk"], case["qe"], valid_rows, case["mv"], k, live,
            shared, float(o) if shared else 1.0, True))
        device = device_ms(torch, kern, calls=10)
        # bound: each input read once and each output written once, over
        # the slots this run's data needs (< need), and the operations it
        # does: the fp32 similarity (4 Q need Ck) plus the readout of the
        # admitted slots (2 Cv per admitted (row, object, slot))
        sim = get_similarity(case["mk"], case["ms"], case["qk"], case["qe"])
        aff_admitted = _admitted(torch, sim, valid_rows, need, k)
        del sim
        n_admitted = aff_admitted * (o if shared else 1)
        bytes_moved = (need * ck * 2 + need * 4 + 2 * q * ck * 2
                       + o * need * cv * 2 + valid_rows.shape[0] * need
                       + o * q * cv * 4 + m * 4)
        flops = 4 * q * need * ck + 2 * n_admitted * cv
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        # the same work as this design does it: the four split products
        # (2 Q need 4 Ck) at the bf16 tensor-core rate, the readout in fp32
        t_tc = (2 * q * need * 4 * ck / BF16_FLOP_PER_S
                + 2 * n_admitted * cv / FP32_FLOP_PER_S) * 1e3
        results.append(dict(
            name=name, route="cuda", source="vosesam_tpu_torch/csrc/memory_read.cu",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes > t_ops else "operations",
            library_ms=None, kernel_only_ms=kernel_only_ms, device_ms=device,
            bound_tensor_core_ms=max(t_bytes, t_tc), usage_max_abs_err=uerr,
            usage_bit_equal_across_calls=True,
            bound_slots=need, admitted_per_row=aff_admitted / (q * valid_rows.shape[0])))
        log(f"[kernels] {name}: err {err:.3g} usage err {uerr:.3g} (two calls bit-equal) | "
            f"{ms:.3f} ms (kernels alone {kernel_only_ms:.3f}, device {device:.3f}) vs plain "
            f"{plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.3f} ms ({results[-1]['bound_by']}),"
            f" at the tensor-core rate {max(t_bytes, t_tc):.4f} ms")
    OCCUPANCY["memory_read"] = {
        **{f"{kern} (bf16 keys, tensor cores; bf16 values)": mr.occupancy(kern)
           for kern in ("select", "apply", "select_2", "apply_2")},
        **{f"{kern} (fp32 keys and values)": mr.occupancy(kern, False, ck, torch.float32)
           for kern in ("select", "apply")},
        "finish": mr.occupancy("finish"), "usage": mr.occupancy("usage")}
    for inst, occ in OCCUPANCY["memory_read"].items():
        log(f"[kernels] occupancy {inst}: {json.dumps(occ)}")

    _edge_cases(torch, mr, gen)
    return results


def _admitted(torch, sim, valid_rows, live: int, k: int) -> int:
    """Admitted (query, slot) pairs summed over the validity rows: valid and
    at least the k-th largest valid similarity of the query."""
    from vosesam_tpu_torch.ops.memory_attention import NEG_INF

    s = sim[:, :live]
    total = 0
    for vr in valid_rows:
        v = vr[:live][None]
        masked = torch.where(v, s, torch.full((), NEG_INF, device=s.device))
        th = torch.topk(masked, min(k, live), dim=-1).values[:, -1:]
        total += int(((masked >= th) & v).sum().item())
    return total


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
    for p, bins, tiles, g, cg, taps in ((37, 11, 3, 4, 8, 5), (64, 1, 1, 16, 16, 9),
                                        (8, 40, 2, 3, 1, 2), (16, 0, 1, 2, 4, 9)):
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
    log(f"[B7] err {err:.3g} | kernel {probe['ms']:.4f} ms (device {device:.4f}), plain "
        f"{plain_ms:.1f} ms, bound "
        f"{max(t_ops, t_bytes):.4f} ms; edge shapes and bad inputs: ok")
    kernel = dict(name="binscan_probe", route="cuda",
                  source="vosesam_tpu_torch/csrc/binscan_probe.cu",
                  replaces="scripts/exp_vpu_binscan.py:36",
                  launches=launches, max_abs_err=err, ms=probe["ms"], device_ms=device,
                  plain_ms=plain_ms,
                  bound_ms=max(t_ops, t_bytes),
                  bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None,
                  gfma_per_s=probe["gfma_per_s"], projected_align_ms=probe["projected_align_ms"],
                  gather_align_ms=probe["gather_align_ms"], on_main_path=False,
                  shape="x (4, 640, 256), fields (4, 512, 144), 128 bins, fp32")
    return kernel, probe


# ------------------------------------- C23: no gradient through a kernel

def phase_grad_refusal(torch):
    """Each kernel wrapper computes a forward pass only: on the card it must
    raise under grad mode for an input that requires grad (and run under
    torch.no_grad()), rather than return a result without a gradient."""
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
        try:
            fn(with_grad)
        except RuntimeError as e:
            check("no backward" in str(e), f"{name}: raised {e!r}")
        else:
            raise SmokeFailure(f"{name}: returned a result without a gradient under grad mode")
        with torch.no_grad():
            fn(with_grad)
    torch.cuda.synchronize()
    for mod in (bp, da, fa, mr, wa):
        mod.reset_counts()
    log(f"[C23] each of {len(calls)} kernel entry points raises under grad mode for an input "
        f"that requires grad, and runs under torch.no_grad(): ok")
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
    out_k, (ff, fb) = G.generator_forward(drv.net, window, plan[1], drv.cfg, frame_valid=valid)
    window_ms = time_ms(torch, lambda: G.generator_forward(drv.net, window, plan[1], drv.cfg,
                                                           frame_valid=valid), reps=3, warmup=0)
    kernel_counts = dict(da.COUNTS)
    kernel_sampler = M.deform_patches_bounded
    M.deform_patches_bounded = da.deform_patches_plain
    try:
        da.reset_counts()
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
    # attention kernels and the fp32 FFMA GEMMs (the rel-pos factors)
    by_name = {}
    for part in ("window_relpos", "flash_relpos", "ffma", "deform_patches"):
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
    the default windowed impl and again with the window kernel."""
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
        b7, record["binscan_probe"] = phase_binscan_probe(torch)
        record["grad_refusal"] = phase_grad_refusal(torch)
        torch.cuda.empty_cache()
        counts, record["e2e"] = phase_end_to_end(torch)
        record["rollout_fp32"] = phase_kernel_vs_plain_rollout(torch)
        record["main_path"], record["sam_init_s"] = phase_main_path(torch)
        record["main_fp32"] = phase_main_kernel_vs_plain(torch)
        record["interactive"] = phase_interactive(torch)
        record["inpaint"] = phase_inpaint(torch)
        # launches: the sum over the main-path runs (phase 3, each of phase
        # 5's runs and phase 7), each counted from 0 right before the run
        for kr in kernels:
            kr["launches"] = counts.get(kr["name"], 0) + sum(
                r["launches"][kr["name"]] for r in record["main_path"].values()
            ) + record["interactive"]["launches"][kr["name"]]
            check(kr["launches"] > 0, f"{kr['name']} never launched on the main path")
        # B6: the sum over phase 8's inpaint runs, each counted from 0
        b6["launches"] = record["inpaint"]["b6_launches"]
        check(b6["launches"] > 0, "deform_patches_bounded never launched on the inpaint path")
        # B7 is a probe on no product path: its launches are those of its own
        # entry point's run in phase 2e, counted from 0 there
        check(b7["launches"] > 0, "binscan_probe never launched in its probe run")
        kernels.extend([b6, b7])
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
