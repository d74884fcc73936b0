"""Time the kernels of this checkout against those of another one (a parent
commit unpacked with `git archive`), on one card in one call, on the same
inputs and with the same yardsticks:

    python -m vosesam_tpu_torch.ops.kernels.ab --against DIR [--out FILE]

Each side runs in a process of its own that imports the package and builds
the kernels of its own tree, in the order against, this, this, against, so
that a drift of the card over the call shows as a difference between the
two runs of one side. Every process makes the same inputs from the same
seeds.

Cases: B1 and B2 at DAVIS 480p (chip_smoke.py's phase 2 inputs: Q 1620,
M 17 200, Ck 64, Cv 512, O 2, k 30, bf16) as the wrapper runs them, and
`get_similarity` on the same inputs alone (the matrix a tree whose kernels
stream it computes first; one whose kernels fuse the similarity does not
call it); B3 on vit_h's grids (16 heads, D 80, bf16: rect 36x64 at B 1 and 8,
square 64x64, fixed 28x56) as the kernel alone, on the strided q / k / v
views of the fused projection where the tree's wrapper takes them and on
contiguous (B * heads, N, D) copies where it takes only those (made before
the timing); the global block's attention as the encoder runs it
(`image_encoder._attention` at rect, vit_h widths, bf16, random weights
from a seed: projections, bias factors, B3 and whatever copies the tree
makes around it); B6 at the inpainter's shape (x (1, 60, 108, 256) fp32,
16 groups, offsets of the model's form, radius None and 16); B6's backward
through `_backward_kernel` at the trainer's shape (the production case of
chip_smoke.py's phase 2g: flows of up to 4 pixels and a 10 tanh residual;
large flows, 9 pixels; B 2); B7 at the probe's shape (x (4, 640, 256),
fields (4, 512, 144), 128 bins, fp32). `--cases` names the groups to run
(default: all).

Yardsticks, per call:
  device_ms   torch.profiler's device time, summed over the CUDA kernels of
              20 back-to-back calls
  event_ms    median CUDA-event time around one call: the host's issue of
              the call and the device's run of it
  batched_ms  median CUDA-event time per call of 10 back-to-back calls: the
              longer of the host's issue and the device's run
  host_ms     median host time to issue one call (15 runs of 20 calls, no
              synchronisation between the calls of a run)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

THIS_ROOT = Path(__file__).resolve().parents[3]
ORDER = ("against", "this", "this", "against")
B3_GRIDS = (("rect", 36, 64, 1), ("rect B 8", 36, 64, 8), ("square", 64, 64, 1),
            ("fixed", 28, 56, 1))
HEADS, HEAD_DIM = 16, 80
PROFILE_ATTEMPTS = 3


# ------------------------------------------------------------ yardsticks
# Defined here and imported by chip_smoke.py and phases.py, not the other
# way round: a measuring process imports nothing of the package but the
# other checkout's, which may predate any shared helper.

def device_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Device time of one call by torch.profiler over `calls` back-to-back
    calls. The profiler drops kernel records now and then (the first
    records of a session) and never adds one, so each kernel counts its
    mean time per record times its launches per call: its records over the
    calls rounded up, where it kept at least half as many records as calls
    (else its share). A session that kept no record is taken again, up to
    PROFILE_ATTEMPTS sessions."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a session that kept no kernel record at all is taken again
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for e in prof.key_averages():
            if e.device_type.name == "CUDA" and e.count:
                per_call = -(-e.count // calls) if 2 * e.count >= calls else e.count / calls
                total_us += e.self_device_time_total / e.count * per_call
        if total_us > 0:
            return total_us / 1e3
    raise RuntimeError(f"torch.profiler reported no device time in {PROFILE_ATTEMPTS} sessions")


def event_ms(fn, reps: int = 25, warmup: int = 3, batch: int = 1) -> float:
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


def host_ms(fn, calls: int = 20, reps: int = 15, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def yardsticks(fn) -> dict:
    return dict(device_ms=device_ms(fn), event_ms=event_ms(fn),
                batched_ms=event_ms(fn, batch=10), host_ms=host_ms(fn))


# ------------------------------------------------------------------ cases

def _b3_call(fa, q, k, v, bh, bw, grid):
    """The kernel on the strided (B, heads, N, D) views where the wrapper
    takes them, else on contiguous (B * heads, N, D) copies."""
    try:
        fa.flash_attention_relpos(q, k, v, bh, bw, grid)
    except ValueError:
        flat = [x.reshape(-1, *x.shape[2:]).contiguous() for x in (q, k, v, bh, bw)]
        return (lambda: fa.flash_attention_relpos(*flat, grid)), "contiguous (B * heads, N, D)"
    return (lambda: fa.flash_attention_relpos(q, k, v, bh, bw, grid)), "strided (B, heads, N, D)"


def memory_read_cases(gen) -> dict:
    from vosesam_tpu_torch.ops.kernels import memory_read as mr
    from vosesam_tpu_torch.ops.memory_attention import get_similarity

    o, q, ck, cv, k = 2, 1620, 64, 512, 30
    nl, hw = 1000, 1620
    m = nl + 10 * hw
    live_end = nl + 9 * hw
    mk = torch.randn((m, ck), generator=gen, device="cuda").to(torch.bfloat16)
    ms = 1.0 + torch.randn((m,), generator=gen, device="cuda") ** 2
    qk = torch.randn((q, ck), generator=gen, device="cuda").to(torch.bfloat16)
    qe = torch.sigmoid(torch.randn((q, ck), generator=gen, device="cuda")).to(torch.bfloat16)
    mv = torch.randn((o, m, cv), generator=gen, device="cuda").to(torch.bfloat16)
    slot = torch.arange(m, device="cuda")
    shared = (slot < live_end) & ~((slot >= 800) & (slot < nl))
    per_obj = torch.stack([slot < live_end,
                           (slot < 800) | ((slot >= live_end - 3 * hw) & (slot < live_end))])
    return {
        "B1 (wrapper)": yardsticks(lambda: mr.fused_memory_read_shared(
            mk, ms, qk, qe, mv, shared, k, return_usage=True, live_end=live_end)),
        "B2 (wrapper)": yardsticks(lambda: mr.fused_memory_read(
            mk, ms, qk, qe, mv, per_obj, k, return_usage=True)),
        "get_similarity": yardsticks(lambda: get_similarity(mk, ms, qk, qe)),
    }


def b3_cases(gen) -> dict:
    from vosesam_tpu_torch.ops.kernels import flash_attention as fa

    out = {}
    for label, gh, gw, b in B3_GRIDS:
        n = gh * gw
        qkv = torch.randn(b, n, 3, HEADS, HEAD_DIM, generator=gen, device="cuda")
        q, k, v = (x.transpose(1, 2) for x in qkv.to(torch.bfloat16).unbind(2))
        bh = torch.randn(b, HEADS, n, gh, generator=gen, device="cuda")
        bw = torch.randn(b, HEADS, n, gw, generator=gen, device="cuda")
        fn, layout = _b3_call(fa, q, k, v, bh, bw, (gh, gw))
        out[f"B3 {label}"] = dict(yardsticks(fn), inputs=layout)
    return out


def encoder_case(gen) -> dict:
    from vosesam_tpu_torch.config import SAMConfig
    from vosesam_tpu_torch.models.sam import image_encoder as ie

    dim, tokens, (gh, gw) = HEADS * HEAD_DIM, 64, (36, 64)
    attn = ie._Attention(dim, HEADS, 2 * tokens - 1, HEAD_DIM)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=gen, device="cuda").cpu())
    attn = attn.to("cuda", torch.bfloat16)
    x = torch.randn(1, gh, gw, dim, generator=gen, device="cuda").to(torch.bfloat16)
    cfg = SAMConfig(model_type="vit_h", hq=True, encode_rect=True, use_flash_attention=True)

    def fn():
        with torch.no_grad():
            return ie._attention(x, attn, (gh, gw), True, cfg)

    return {"encoder global attention, rect": yardsticks(fn)}


def b6_cases(gen) -> dict:
    """chip_smoke.py's phase 2d inputs: a 10 tanh residual per (group, tap)
    plus one flow of up to 4 pixels per pixel for each half of the groups."""
    from vosesam_tpu_torch.ops.kernels import deform_align as da

    b, h, w, cin, g = 1, 60, 108, 256, 16
    x = torch.randn(b, h, w, cin, generator=gen, device="cuda")
    resid = 10.0 * torch.tanh(torch.randn(b, h, w, g, 9, 2, generator=gen, device="cuda"))
    flow = 4.0 * torch.tanh(torch.randn(b, h, w, 2, 1, 1, 2, generator=gen, device="cuda"))
    off = (resid + flow.expand(b, h, w, 2, g // 2, 9, 2).reshape(b, h, w, g, 9, 2)
           ).reshape(b, h, w, 2 * g * 9).contiguous()
    msk = torch.sigmoid(torch.randn(b, h, w, g * 9, generator=gen, device="cuda"))
    return {f"B6 radius {r}": yardsticks(lambda r=r: da.deform_patches_bounded(x, off, msk, r))
            for r in (None, 16)}


def b6_backward_cases(gen) -> dict:
    """B6's gradient at the trainer's shape, phase 2g's offsets: the
    production case (flow 4), large flows (flow 9) and B 2, each through
    the tree's `_backward_kernel` (grad_x's zero fill included)."""
    from vosesam_tpu_torch.ops.kernels import deform_align as da

    h, w, cin, g = 60, 108, 256, 16
    out = {}
    for label, b, flow in (("production", 1, 4.0), ("large flows", 1, 9.0), ("B 2", 2, 4.0)):
        x = torch.randn(b, h, w, cin, generator=gen, device="cuda")
        resid = 10.0 * torch.tanh(torch.randn(b, h, w, g, 9, 2, generator=gen, device="cuda"))
        fl = flow * torch.tanh(torch.randn(b, h, w, 2, 1, 1, 2, generator=gen, device="cuda"))
        off = (resid + fl.expand(b, h, w, 2, g // 2, 9, 2).reshape(b, h, w, g, 9, 2)
               ).reshape(b, h, w, 2 * g * 9).contiguous()
        msk = torch.sigmoid(torch.randn(b, h, w, g * 9, generator=gen, device="cuda"))
        gp = torch.randn(b, h, w, 9, cin, generator=gen, device="cuda")
        out[f"B6-bwd {label}"] = yardsticks(
            lambda gp=gp, x=x, off=off, msk=msk: da._backward_kernel(gp, x, off, msk, None))
    return out


def b7_cases(gen) -> dict:
    """The bin-scan probe's own inputs (`binscan_probe.probe_inputs`)."""
    from vosesam_tpu_torch.ops.kernels import binscan_probe as bp

    x, y0, wy = bp.probe_inputs(gen)
    return {"B7 probe": yardsticks(lambda: bp.binscan_probe(x, y0, wy, bp.BINS))}


CASES = {"memory_read": (memory_read_cases, 1), "b3": (b3_cases, 2), "encoder": (encoder_case, 3),
         "b6": (b6_cases, 4), "b7": (b7_cases, 5), "b6_backward": (b6_backward_cases, 6)}


def measure(root: str, cases=tuple(CASES)) -> dict:
    """One side's run: this process imports the package of `root`."""
    sys.path[0] = root
    import vosesam_tpu_torch

    got = Path(vosesam_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in got.parents:
        raise RuntimeError(f"imported {got}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name in cases:
        fn, seed = CASES[name]
        out.update(fn(torch.Generator(device="cuda").manual_seed(seed)))
    return out


# ---------------------------------------------------------------- driver

def summary(runs: dict) -> list:
    """Per case and yardstick: each side's mean over its two runs, and the
    against / this ratio."""
    lines = []
    for case in runs["this"][0]:
        for key in ("device_ms", "event_ms", "batched_ms", "host_ms"):
            a = [r[case][key] for r in runs["against"]]
            t = [r[case][key] for r in runs["this"]]
            ratio = statistics.mean(a) / statistics.mean(t)
            lines.append(f"{case:32s} {key:10s} against {a[0]:.4f} / {a[1]:.4f}   "
                         f"this {t[0]:.4f} / {t[1]:.4f}   ratio {ratio:.2f}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="root of the other checkout")
    ap.add_argument("--out", help="write every reading here as JSON")
    ap.add_argument("--cases", nargs="+", choices=sorted(CASES), default=list(CASES),
                    help="the case groups to run (default: all)")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the kernels are timed on the card")
        return 1
    if args.measure:
        print(json.dumps(measure(args.measure, args.cases)))
        return 0
    if not args.against or not (Path(args.against) / "vosesam_tpu_torch").is_dir():
        print("--against must name the root of a checkout that holds vosesam_tpu_torch/")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip()
    print(card)
    roots = {"against": str(Path(args.against).resolve()), "this": str(THIS_ROOT)}
    runs = {"against": [], "this": []}
    for side in ORDER:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure",
                              roots[side], "--cases", *args.cases], cwd=roots[side],
                             capture_output=True, text=True,
                             env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
        if res.returncode != 0:
            print(f"{side} ({roots[side]}) failed:\n{res.stdout}\n{res.stderr}")
            return 1
        runs[side].append(json.loads(res.stdout.strip().splitlines()[-1]))
    for line in summary(runs):
        print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, order=ORDER, roots=roots,
                                                  runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
