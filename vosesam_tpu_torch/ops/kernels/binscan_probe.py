"""Throughput probe of the deformable alignment's bin scan (B7).

For each of `bins` row shifts s and each tap k,

    acc[t, p, c] += w(t, p, g(c), k, s) * x[t, p + s, c],
    w = (1 - wy) where y0 == s, wy where y0 == s - 1, else 0,

over `n_tiles` tiles of P rows, each with its own source block of P + pad
rows; fields are tap-major (lane k * G + g) and channels cg-major
(g(c) = c % G), as in the TPU probe. Replaces the Pallas TPU kernel
`scripts/exp_vpu_binscan.py:36 make_kernel`: the inner operation of sampling
by scanning displacement bins with dense shifted multiply-adds instead of
gathering. On the TPU the probe asked whether the scan could beat the
gather; `main()` asks the same of this card: it prints the multiply-add rate
the hand-written kernel `csrc/binscan_probe.cu` reaches, the scan's
projected time for one alignment call at a window of 34 x 34 bins, and the
measured time of the gather kernel (B6, `deform_patches_bounded`) for the
same call, all by device time.

    python -m vosesam_tpu_torch.ops.kernels.binscan_probe [P] [BINS]

`binscan_probe_plain` is the same function in plain PyTorch; the wrapper
takes it only for tensors on the CPU. `occupancy` reports what the card
gives the kernel's instance at a shape (registers, shared memory, blocks
per SM, rows per block, shifts per staged window). The kernel fuses each multiply-add and
the plain version rounds the product first: they agree within 1e-5 on
unit-variance inputs (at most two non-zero weights per tap).
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict

import torch

from vosesam_tpu_torch.ops.kernels._autograd import refuse_grad

# Launches of the kernel, and plain calls.
COUNTS: Dict[str, int] = {"binscan_probe": 0, "plain": 0}

MAX_TAPS = 9
MAX_GROUPS = 256      # a block holds a whole row: one thread per group
GROUP_CHANNELS = (1, 2, 4, 8, 16)

# the TPU probe's shapes
P_TILE, N_TILES, GROUPS, CG, N_TAPS, BINS, PAD_ROWS = 512, 4, 16, 16, 9, 128, 128
ALIGN_HW = 60 * 108        # pixels of one alignment call at 240 x 432
ALIGN_WINDOW = 34          # bins per side of the window the TPU campaign sized


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def binscan_probe_plain(x: torch.Tensor, y0: torch.Tensor, wy: torch.Tensor,
                        bins: int, groups: int = GROUPS) -> torch.Tensor:
    """The same scan, one elementwise multiply-add per (shift, tap)."""
    COUNTS["plain"] += 1
    n_tiles, p, kg = y0.shape
    cin = x.shape[-1]
    g = groups
    taps = kg // g
    cg = cin // g
    acc = torch.zeros((n_tiles, p, cin), dtype=x.dtype, device=x.device)
    for s in range(bins):
        xs = x[:, s:s + p]
        for k in range(taps):
            y0k = y0[..., k * g:(k + 1) * g]
            wyk = wy[..., k * g:(k + 1) * g]
            w = (torch.where(y0k == s, 1.0 - wyk, torch.zeros_like(wyk))
                 + torch.where(y0k == s - 1, wyk, torch.zeros_like(wyk)))
            acc = acc + w.repeat(1, 1, cg) * xs        # tile-repeat: channel c <- group c % G
    return acc


def _lib() -> ctypes.CDLL:
    from vosesam_tpu_torch.ops.kernels import _build

    lib = _build.load("binscan_probe")
    fn = lib.vosesam_binscan_probe
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, y0, wy, bins, groups, fn: str = "binscan_probe") -> None:
    if x.dtype != torch.float32 or wy.dtype != torch.float32:
        raise TypeError(f"{fn}: x and wy must be float32, got {x.dtype}, {wy.dtype}")
    if y0.dtype != torch.int32:
        raise TypeError(f"{fn}: y0 must be int32, got {y0.dtype}")
    if x.ndim != 3 or y0.ndim != 3:
        raise ValueError(f"{fn}: x must be (tiles, P + pad, Cin) and y0 (tiles, P, taps * G), "
                         f"got {tuple(x.shape)}, {tuple(y0.shape)}")
    if tuple(wy.shape) != tuple(y0.shape) or y0.shape[0] != x.shape[0]:
        raise ValueError(f"{fn}: y0 {tuple(y0.shape)}, wy {tuple(wy.shape)} and x "
                         f"{tuple(x.shape)} disagree")
    if bins < 0 or x.shape[1] < y0.shape[1] + bins - 1:
        raise ValueError(f"{fn}: {x.shape[1]} source rows are too few for P = {y0.shape[1]} "
                         f"and {bins} bins")
    if y0.device != x.device or wy.device != x.device:
        raise ValueError(f"{fn}: inputs are on different devices")
    cin, kg = x.shape[-1], y0.shape[-1]
    if groups < 1 or cin % groups or kg % groups or not 1 <= kg // groups <= MAX_TAPS:
        raise ValueError(f"{fn}: {groups} groups do not fit Cin = {cin} and {kg} field lanes "
                         f"(at most {MAX_TAPS} taps)")
    if groups > MAX_GROUPS:
        raise ValueError(f"{fn}: {groups} groups, at most {MAX_GROUPS}")
    if cin // groups not in GROUP_CHANNELS:
        raise ValueError(f"{fn}: {cin // groups} channels per group not in {GROUP_CHANNELS}")


OCCUPANCY_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                  "blocks_per_sm", "threads_per_block", "local_bytes", "rows_per_block",
                  "shifts_per_window")


def occupancy(p_tile: int = P_TILE, groups: int = GROUPS, cg: int = CG,
              bins: int = BINS) -> Dict[str, int]:
    """Registers, shared memory and resident blocks per SM of the instance a
    launch at (P, G, cg, bins) selects, as the card reports them, with the
    rows per block and shifts per staged window it plans."""
    fn = _lib().vosesam_binscan_occupancy
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
    info = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    rc = fn(p_tile, groups, cg, bins, info)
    if rc != 0:
        raise RuntimeError(f"binscan_probe occupancy query failed: CUDA error {rc}")
    return dict(zip(OCCUPANCY_KEYS, info))


def binscan_probe(
    x: torch.Tensor,     # (tiles, P + pad, Cin) fp32 source rows
    y0: torch.Tensor,    # (tiles, P, taps * G) int32 bin of the upper corner
    wy: torch.Tensor,    # (tiles, P, taps * G) fp32 fractional weight
    bins: int,
    groups: int = GROUPS,
) -> torch.Tensor:
    """(tiles, P, Cin) fp32 accumulators of the scan (B7)."""
    _check(x, y0, wy, bins, groups)
    if x.device.type == "cpu":
        return binscan_probe_plain(x, y0, wy, bins, groups)
    if x.device.type != "cuda":
        raise ValueError(f"binscan_probe: no kernel for device {x.device}")
    refuse_grad("binscan_probe", x, wy)
    x, y0, wy = x.contiguous(), y0.contiguous(), wy.contiguous()
    n_tiles, p, kg = y0.shape
    cin = x.shape[-1]
    g = groups
    out = torch.empty((n_tiles, p, cin), dtype=torch.float32, device=x.device)
    rc = _lib().vosesam_binscan_probe(
        x.data_ptr(), y0.data_ptr(), wy.data_ptr(), out.data_ptr(),
        n_tiles, p, x.shape[1], g, cin // g, kg // g, int(bins),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"binscan_probe kernel launch failed: CUDA error {rc}")
    COUNTS["binscan_probe"] += 1
    return out


def probe_inputs(gen: torch.Generator, p_tile: int = P_TILE, bins: int = BINS,
                 n_tiles: int = N_TILES, g: int = GROUPS, cg: int = CG,
                 taps: int = N_TAPS, pad: int = PAD_ROWS):
    """The TPU probe's inputs, drawn on the generator's device."""
    dev = gen.device
    x = torch.randn((n_tiles, p_tile + pad, g * cg), generator=gen, device=dev)
    y0 = torch.randint(0, max(bins, 1), (n_tiles, p_tile, g * taps), generator=gen,
                       device=dev, dtype=torch.int32)
    wy = torch.rand((n_tiles, p_tile, g * taps), generator=gen, device=dev)
    return x, y0, wy


def _event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_probe(p_tile: int = P_TILE, bins: int = BINS, seed: int = 0) -> Dict[str, float]:
    """Time the scan kernel at the probe's shapes and the gather kernel at
    one alignment call's, by device time (torch.profiler; CUDA events over
    back-to-back calls read the host's issue of this short a call beside
    it); needs the card. Returns the numbers `main` prints."""
    from vosesam_tpu_torch.ops.kernels.ab import device_ms
    from vosesam_tpu_torch.ops.kernels.deform_align import deform_patches_bounded

    if not torch.cuda.is_available():
        raise RuntimeError("the bin-scan probe measures the card: CUDA is not available")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, y0, wy = probe_inputs(gen, p_tile, bins)
    ms = device_ms(lambda: binscan_probe(x, y0, wy, bins))
    event_ms = _event_ms(lambda: binscan_probe(x, y0, wy, bins))
    fma = N_TILES * p_tile * bins * GROUPS * CG * N_TAPS
    sel = N_TILES * p_tile * bins * GROUPS * N_TAPS * 4
    # one alignment call: ALIGN_WINDOW^2 bins over ALIGN_HW pixels
    scale = (ALIGN_HW / (N_TILES * p_tile)) * (ALIGN_WINDOW ** 2 / max(bins, 1))
    feat = torch.randn((1, 60, 108, GROUPS * CG), generator=gen, device="cuda")
    off = 4.0 * torch.randn((1, 60, 108, 2 * GROUPS * N_TAPS), generator=gen, device="cuda")
    msk = torch.rand((1, 60, 108, GROUPS * N_TAPS), generator=gen, device="cuda")
    gather_ms = device_ms(lambda: deform_patches_bounded(feat, off, msk))
    return dict(p_tile=p_tile, bins=bins, ms=ms, event_ms=event_ms, gfma_per_s=fma / ms / 1e6,
                gsel_per_s=sel / ms / 1e6, projected_align_ms=ms * scale,
                gather_align_ms=gather_ms)


def report(r: Dict[str, float]) -> list:
    """The lines `main` prints for one `run_probe` result."""
    return [
        f"bin-scan tile: P={r['p_tile']} bins={r['bins']} G*K sel + (P,{GROUPS * CG}) fma",
        f"  {r['ms']:.4f} ms/iter by device time (CUDA events over back-to-back calls "
        f"{r['event_ms']:.4f}) -> {r['gfma_per_s']:.1f} G fma/s "
        f"(+{r['gsel_per_s']:.1f} G sel-ops/s)",
        f"  projected align-call bin-scan time at w={ALIGN_WINDOW}: "
        f"{r['projected_align_ms']:.3f} ms (vs {r['gather_align_ms']:.4f} ms for the "
        f"gather kernel on the same card)",
    ]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p_tile = int(argv[0]) if len(argv) > 0 else P_TILE
    bins = int(argv[1]) if len(argv) > 1 else BINS
    r = run_probe(p_tile, bins)
    print(torch.cuda.get_device_name(0))
    for line in report(r):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
