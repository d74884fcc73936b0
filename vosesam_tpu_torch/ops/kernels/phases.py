"""Where the time of the memory-read and window-attention kernels goes, block
by block, on the card:

    python -m vosesam_tpu_torch.ops.kernels.phases

Builds `csrc/memory_read.cu` and `csrc/window_attention.cu` once more with
`-DVOSESAM_PROFILE` (thread 0 of every block stamps the global timer at the
ends of its phases), runs them at the shapes of `chip_smoke.py`'s phases 2
and 2c, and prints the median over blocks of each phase in ns, the span from
the first block's start to the last block's end, and the call's device time
(torch.profiler) beside it. The product builds carry no stamps.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
from typing import Dict

import torch

from vosesam_tpu_torch.ops.kernels import _build


def _profile_build(name: str) -> ctypes.CDLL:
    out = _build.library_path(name).with_name(f"{name}-profile.so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DVOSESAM_PROFILE", "-o", str(out),
           str(_build.CSRC_DIR / _build.SOURCES[name])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"profile build of {name} failed:\n{res.stderr}")
    return ctypes.CDLL(str(out))


def _stamps(fn, n_blocks: int, width: int):
    buf = (ctypes.c_ulonglong * (n_blocks * width))()
    rc = fn(buf, n_blocks)
    if rc != 0:
        raise RuntimeError(f"reading the stamps failed: CUDA error {rc}")
    return [list(buf[i * width:(i + 1) * width]) for i in range(n_blocks)]


def _med(rows, f) -> float:
    return float(statistics.median(f(x) for x in rows))


def _device_ms(fn, calls: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / calls


def memory_read_phases(gen: torch.Generator) -> Dict[str, dict]:
    """B1 and B2 at DAVIS 480p (Q 1620, M 17 200, Ck 64, Cv 512, O 2, k 30,
    bf16), the validity of chip_smoke.py's phase 2."""
    from vosesam_tpu_torch.ops.kernels import memory_read as mr

    lib = _profile_build("memory_read")
    saved = _build._LIBS.get("memory_read")
    _build._LIBS["memory_read"] = lib
    dev = "cuda"
    o, q, ck, cv, k = 2, 1620, 64, 512, 30
    nl, hw = 1000, 1620
    m = nl + 10 * hw
    live_end = nl + 9 * hw
    case = dict(mk=torch.randn((m, ck), generator=gen, device=dev).to(torch.bfloat16),
                ms=1.0 + torch.randn((m,), generator=gen, device=dev) ** 2,
                qk=torch.randn((q, ck), generator=gen, device=dev).to(torch.bfloat16),
                qe=torch.sigmoid(torch.randn((q, ck), generator=gen, device=dev)
                                 ).to(torch.bfloat16),
                mv=torch.randn((o, m, cv), generator=gen, device=dev).to(torch.bfloat16))
    slot = torch.arange(m, device=dev)
    shared = (slot < live_end) & ~((slot >= 800) & (slot < nl))
    per_obj = torch.stack([slot < live_end,
                           (slot < 800) | ((slot >= live_end - 3 * hw) & (slot < live_end))])
    runs = {"fused_memory_read_shared": (lambda: mr.fused_memory_read_shared(
                **case, valid=shared, top_k=k, return_usage=True, live_end=live_end), live_end, 1),
            "fused_memory_read": (lambda: mr.fused_memory_read(
                **case, valid=per_obj, top_k=k, return_usage=True), m, 2)}
    out = {}
    try:
        for name, (fn, live, r) in runs.items():
            groups = mr._row_groups(r, r == 1)
            slots = mr._slots(0, True, ck, True, groups < r)
            splits = mr.splits_for(q, groups, live, slots)
            device = _device_ms(fn)
            fn()
            torch.cuda.synchronize()
            n = -(-q // mr.ROWS_PER_BLOCK) * splits * groups
            rows = _stamps(lib.vosesam_memory_read_profile, n, 16)
            out[name] = dict(
                blocks=n, splits=splits, device_ms=device,
                select=dict(span_ns=max(x[9] for x in rows) - min(x[8] for x in rows),
                            block_ns=_med(rows, lambda x: x[9] - x[8]),
                            chunk_wait_ns=_med(rows, lambda x: x[12]),
                            tiles_ns=_med(rows, lambda x: x[13]),
                            chunks=_med(rows, lambda x: x[14])),
                apply=dict(span_ns=max(x[3] for x in rows) - min(x[0] for x in rows),
                           block_ns=_med(rows, lambda x: x[3] - x[0]),
                           threshold_ns=_med(rows, lambda x: x[1] - x[0]),
                           pass_ns=_med(rows, lambda x: x[2] - x[1]),
                           entries_ns=_med(rows, lambda x: x[3] - x[2]),
                           chunk_wait_ns=_med(rows, lambda x: x[4]),
                           tiles_ns=_med(rows, lambda x: x[5]), chunks=_med(rows, lambda x: x[6])))
    finally:
        if saved is not None:
            _build._LIBS["memory_read"] = saved
        else:
            _build._LIBS.pop("memory_read", None)
    return out


def window_phases(gen: torch.Generator) -> Dict[str, dict]:
    """B4 at the rect grid, B 1 and 8: 15 windows of 14 x 14 per frame, 16
    heads, D 80, bf16, the encoder's strided q / k / v views."""
    from vosesam_tpu_torch.ops.kernels import window_attention as wa

    lib = _profile_build("window_attention")
    saved = _build._LIBS.get("window_attention")
    _build._LIBS["window_attention"] = lib
    heads, t, d = 16, 196, 80
    out = {}
    try:
        for b in (1, 8):
            w = 15 * b
            q, k, v = (x.transpose(1, 2) for x in torch.randn(
                (w, t, 3, heads, d), generator=gen, device="cuda").to(torch.bfloat16).unbind(2))
            bh = torch.randn((w, heads, t, 14), generator=gen, device="cuda")
            bw = torch.randn((w, heads, t, 14), generator=gen, device="cuda")
            fn = lambda: wa.window_attention_relpos(q, k, v, bh, bw, (14, 14))  # noqa: E731
            device = _device_ms(fn)
            fn()
            torch.cuda.synchronize()
            n = w * heads * 2
            rows = _stamps(lib.vosesam_window_attention_profile, n, 8)
            out[f"rect_b{b}"] = dict(
                blocks=n, device_ms=device,
                span_ns=max(x[5] for x in rows) - min(x[0] for x in rows),
                block_ns=_med(rows, lambda x: x[5] - x[0]),
                prologue_and_chunk0_wait_ns=_med(rows, lambda x: x[1] - x[0]),
                **{f"chunk{j}_ns": _med(rows, lambda x, j=j: x[2 + j] - x[1 + j])
                   for j in range(4)})
    finally:
        if saved is not None:
            _build._LIBS["window_attention"] = saved
        else:
            _build._LIBS.pop("window_attention", None)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the phases are measured on the card")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    print(json.dumps({"memory_read": memory_read_phases(gen),
                      "window_attention": window_phases(gen)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
