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
     the edge cases, held against the plain PyTorch version; CUDA-event
     timings (median of 25 after warm-up) beside the bound;
  2b. kernel vs plain for B3 (global attention with factorised rel-pos
     bias): vit_h's 16 heads, D 80, on the square (64x64), rect (36x64) and
     fixed (28x56) grids, B 1 and 8, bf16 and fp32, plus edge cases (N not a
     multiple of 64, D 64, gh != gw, 3 heads); timings of the kernel, the
     plain version and `scaled_dot_product_attention` with the materialised
     bias (a yardstick the port never calls), beside the bound;
  2c. kernel vs plain for B4 / B5 (whole-window attention with factorised
     rel-pos bias, one kernel under both names): vit_h's 16 heads, 14x14
     windows, D 80, at the rect grid's 15 windows per frame and the square
     grid's 25, B 1 and 8, bf16 and fp32, on the strided q / k / v views the
     encoder passes, plus edge cases (5x9 and 7x7 windows, D 64 / 37 / 128,
     3 heads, one window, bad shapes raise); timings of the kernel, the
     plain version, B3's kernel at BH = W * heads and N 196 (the same
     function) and `scaled_dot_product_attention` with the dense bias, as
     device time from torch.profiler (one call is shorter than the host
     takes to launch it);
  3. XMem end to end: `TrackingAnything` (XMem-s012 widths, default
     MemoryConfig, bf16, no refinement) tracks a 64-frame 480x854 clip with
     two objects seeded on frame 0 and a third added on frame 40;
  4. XMem kernel vs plain end to end: 16 frames in fp32 twice, once through
     the kernels and once with `MemoryConfig(fused_read=False)`;
  5. the main path: XMem + SAM-HQ vit_h refinement (`both_neg`, point
     algorithm C, the 0.94 gate, rect encode, 2 objects, bf16): `generator`
     over 16 frames, `generator_chunked(chunk=8, paint=True)` over 33, and
     `generator` over 4 frames with the official square encode; B3 launches
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
Kernel launch counts are set to 0 right before each main-path run (phases
3, 5 and 7) and read right after; the `kernels` line sums them.
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
FP32_TOL = 1e-4    # readout, fp32 inputs
USAGE_REL = 1e-4   # usage, relative to the largest usage (fixed-order sums)


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

def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, calls: int = 20, warmup: int = 3) -> float:
    """Device time of one call: torch.profiler's sum over the CUDA kernels
    of `calls` back-to-back calls, divided by the calls. For a call shorter
    than the host takes to launch it (the window kernel: tens of
    microseconds), where a CUDA-event pair around one call times the host."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in events)
    check(total_us > 0, "torch.profiler reported no device time")
    return total_us / 1e3 / calls


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
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain)
        # the kernels alone, on a precomputed similarity
        sim = get_similarity(case["mk"], case["ms"], case["qk"], case["qe"])
        shared = name == "fused_memory_read_shared"
        kernel_only_ms = time_ms(torch, lambda: mr._launch(
            sim, valid_rows, case["mv"], k, live, shared, float(o) if shared else 1.0, True))
        # bound: each input read once and each output written once, over
        # the slots this run's data needs (< need), and the operations it
        # does: the fp32 similarity (4 Q need Ck) plus the readout of the
        # admitted slots (2 Cv per admitted (row, object, slot))
        aff_admitted = _admitted(torch, sim, valid_rows, need, k)
        n_admitted = aff_admitted * (o if shared else 1)
        bytes_moved = (need * ck * 2 + need * 4 + 2 * q * ck * 2
                       + o * need * cv * 2 + valid_rows.shape[0] * need
                       + o * q * cv * 4 + m * 4)
        flops = 4 * q * need * ck + 2 * n_admitted * cv
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        results.append(dict(
            name=name, route="cuda", source="vosesam_tpu_torch/csrc/memory_read.cu",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes > t_ops else "operations",
            library_ms=None, kernel_only_ms=kernel_only_ms, usage_max_abs_err=uerr,
            bound_slots=need, admitted_per_row=aff_admitted / (q * valid_rows.shape[0])))
        log(f"[kernels] {name}: err {err:.3g} usage err {uerr:.3g} | {ms:.3f} ms "
            f"(kernels alone {kernel_only_ms:.3f}) vs plain {plain_ms:.3f} ms, bound "
            f"{max(t_bytes, t_ops):.3f} ms ({results[-1]['bound_by']})")

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
BF16_FLOP_PER_S = 989e12
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


def _attn_case(torch, gen, bh, gh, gw, d, dtype):
    n = gh * gw

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    return (rnd(bh, n, d).to(dtype), rnd(bh, n, d).to(dtype), rnd(bh, n, d).to(dtype),
            rnd(bh, n, gh), rnd(bh, n, gw))


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
                args = _attn_case(torch, gen, b * heads, gh, gw, d, dtype)
                out = fa.flash_attention_relpos(*args, (gh, gw))
                torch.cuda.synchronize()
                ref = fa.flash_attention_relpos_plain(*args, (gh, gw))
                err = (out.float() - ref.float()).abs().max().item()
                check(bool(torch.isfinite(out).all()), f"B3 {label} B{b}: non-finite output")
                check(err <= tol, f"B3 {label} B{b} {dtype}: max abs err {err} > {tol}")
                row = dict(grid=label, gh=gh, gw=gw, batch=b, heads=heads, d=d,
                           dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol)
                if dtype == torch.bfloat16:
                    q, k, v, bh_, bw_ = args
                    n = gh * gw
                    mask = (bh_[..., :, None] + bw_[..., None, :]).reshape(-1, n, n).to(dtype)
                    row["ms"] = time_ms(torch, lambda: fa.flash_attention_relpos(*args, (gh, gw)))
                    row["plain_ms"] = time_ms(
                        torch, lambda: fa.flash_attention_relpos_plain(*args, (gh, gw)), reps=5)
                    row["library_ms"] = time_ms(
                        torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
                    del mask
                    row["bound_ms"], row["bound_by"] = _attn_bound(
                        b * heads, gh, gw, d, 2, BF16_FLOP_PER_S)
                    row["exp_floor_estimate_ms"] = (
                        b * heads * (gh * gw) ** 2 / exp_rate * 1e3 if exp_rate else None)
                    log(f"[B3] {label} B{b} bf16: err {err:.3g} | kernel {row['ms']:.3f} ms, "
                        f"plain {row['plain_ms']:.3f}, sdpa {row['library_ms']:.3f}, bound "
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
    for bh, gh, gw, dd in ((3, 10, 13, 64), (3, 7, 9, 80), (2, 5, 5, 37), (4, 16, 16, 128),
                           (16, 20, 36, 64)):
        for dtype, tol in ((torch.bfloat16, BF16_ATTN_TOL), (torch.float32, FP32_ATTN_TOL)):
            args = _attn_case(torch, gen, bh, gh, gw, dd, dtype)
            out = fa.flash_attention_relpos(*args, (gh, gw))
            torch.cuda.synchronize()
            err = (out.float() - fa.flash_attention_relpos_plain(*args, (gh, gw)).float()
                   ).abs().max().item()
            check(err <= tol, f"B3 edge {bh}x{gh}x{gw} d{dd} {dtype}: err {err}")
    q, *rest = _attn_case(torch, gen, 2, 4, 4, 16, torch.bfloat16)
    try:
        fa.flash_attention_relpos(q[..., :10].contiguous(), *rest, (4, 4))
    except ValueError:
        pass
    else:
        raise SmokeFailure("B3: mismatched q/k shapes did not raise")
    log("[B3] edge cases: N 130 / 63 / 25 / 720 (not multiples of 64), D 64 / 37 / 128, "
        "gh != gw, 3 heads, fp32 + bf16, bad shapes raise: ok")
    per_frame = next(c for c in cases if c["grid"] == "rect" and c["batch"] == 1
                and c["dtype"] == "bfloat16")
    kernel = dict(name="flash_attention_relpos", route="cuda",
                  source="vosesam_tpu_torch/csrc/flash_attention.cu",
                  replaces="vosesam_tpu/ops/pallas/flash_attention.py:307",
                  max_abs_err=max(c["max_abs_err"] for c in cases if c["dtype"] == "bfloat16"),
                  ms=per_frame["ms"], plain_ms=per_frame["plain_ms"],
                  bound_ms=per_frame["bound_ms"], bound_by=per_frame["bound_by"],
                  library_ms=per_frame["library_ms"],
                  shape="rect 36x64, B 1, 16 heads, D 80, bf16")
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
                    flat = [x.reshape(w * heads, t, -1) for x in (q, k, v, bh_, bw_)]
                    b3 = fa.flash_attention_relpos(*flat, (wh, ww)).reshape(w, heads, t, d)
                    torch.cuda.synchronize()
                    b3_err = (b3.float() - out.float()).abs().max().item()
                    check(b3_err <= tol, f"{name}: B3 at N 196 differs from B4 by {b3_err}")
                    row["b3_vs_b4_max_abs_err"] = b3_err
                    row["b3_at_n196_ms"] = device_ms(
                        torch, lambda: fa.flash_attention_relpos(*flat, (wh, ww)))
                    mask = (bh_[..., :, None] + bw_[..., None, :]).reshape(w, heads, t, t).to(dtype)
                    row["library_ms"] = device_ms(
                        torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
                    del mask, flat, b3
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
    for w, hd_, ewh, eww, dd in ((3, 2, 5, 9, 64), (3, 4, 5, 9, 80), (2, 3, 7, 7, 37),
                                 (1, 3, 14, 14, 128), (2, 2, 16, 16, 64), (1, 1, 1, 1, 8),
                                 (2, 2, 8, 14, 72)):
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
    log("[B4/B5] edge cases: 5x9 / 7x7 / 16x16 / 8x14 / 1x1 windows, D 64 / 80 / 37 / 128 / "
        "72 / 8, 3 heads, one window, strided and contiguous, fp32 + bf16, bad inputs raise: ok")
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


def phase_main_path(torch, n_frames: int = 16, n_chunked: int = 33, n_square: int = 4):
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
    for part in ("window_relpos", "flash_relpos", "ffma"):
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
        counts, record["e2e"] = phase_end_to_end(torch)
        record["rollout_fp32"] = phase_kernel_vs_plain_rollout(torch)
        record["main_path"], record["sam_init_s"] = phase_main_path(torch)
        record["main_fp32"] = phase_main_kernel_vs_plain(torch)
        record["interactive"] = phase_interactive(torch)
        # launches: the sum over the main-path runs (phase 3, each of phase
        # 5's runs and phase 7), each counted from 0 right before the run
        for kr in kernels:
            kr["launches"] = counts.get(kr["name"], 0) + sum(
                r["launches"][kr["name"]] for r in record["main_path"].values()
            ) + record["interactive"]["launches"][kr["name"]]
            check(kr["launches"] > 0, f"{kr['name']} never launched on the main path")
        record["seconds"] = time.time() - t_start
        if args.profile:
            record["profile"] = phase_profile(torch)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    record["kernels"] = kernels
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
