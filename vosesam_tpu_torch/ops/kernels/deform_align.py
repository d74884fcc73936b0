"""Modulated deformable 3x3 bilinear sampling (B6): the patches of E2FGVI's
second-order deformable alignment,

    patches[b, y, x, k, c] = mask[b, y, x, g(c), k] * bilinear(x[b, :, :, c],
                               y + (off_y[g(c), k] + dy_k), x + (off_x[g(c), k] + dx_k))

over the 9 taps k of a 3x3 kernel and G deform groups of Cin / G channels
(g(c) = c // (Cin / G)), reading zeros outside the field. Offsets are in
mmcv's layout: (G, 9, 2) per pixel with (y, x) pairs, the flow already added.

Replaces the Pallas TPU kernel `vosesam_tpu/ops/pallas/deform_align.py:210
deform_patches_bounded`, which scans the displacement bins of a bounded
window because a TPU cannot gather. For CUDA tensors the wrapper launches
the hand-written gather kernel `csrc/deform_align.cu` (its header says what
bounds it on the H100 and what the design does about it). `radius=None` is
the unbounded function, equal to the gather form
`vosesam_tpu/models/e2fgvi/modules.py:161 modulated_deform_conv` samples
with; `radius=r` adds the TPU kernel's drop rule: a corner whose integer
displacement from the output pixel lies outside [-r, r], rows and columns
each on their own, contributes nothing. The TPU kernel's cg-major channel
permutation, its padding of W to 8 and its halves are layout devices of that
machine: here channels stay in their natural order and G and Cin are free.

`deform_patches_plain` is the same function in plain PyTorch (four gathers);
the wrapper takes it only for tensors on the CPU. The kernel rounds every
step in the plain version's order, so on finite inputs the two agree to the
last bit; the stated tolerance (2e-6, the JAX kernel test's) covers a
compiler that would fuse differently.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

# Launches of the kernel, and plain calls.
COUNTS: Dict[str, int] = {"deform_patches_bounded": 0, "plain": 0}

TAPS = 9


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _axis(pos: torch.Tensor, off: torch.Tensor, tap: torch.Tensor, extent: int,
          radius: Optional[int]):
    """One axis of every sample: clamped indices of the two corners, their
    weights (0 where the radius rule drops the corner) and in-field flags."""
    a = pos + (off + tap)                     # (off + tap) first, then the grid
    f0 = torch.floor(a)
    f1 = f0 + 1.0
    frac = a - f0
    w0, w1 = 1.0 - frac, frac
    if radius is not None:
        d0 = f0 - pos
        d1 = d0 + 1.0
        w0 = w0 * ((d0 >= -radius) & (d0 <= radius)).to(a.dtype)
        w1 = w1 * ((d1 >= -radius) & (d1 <= radius)).to(a.dtype)
    in0 = (f0 >= 0) & (f0 < extent)
    in1 = (f1 >= 0) & (f1 < extent)
    i0 = f0.clamp(0, extent - 1).long()
    i1 = f1.clamp(0, extent - 1).long()
    return (i0, i1), (w0, w1), (in0, in1)


def deform_patches_plain(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                         radius: Optional[int] = None) -> torch.Tensor:
    """The same function with four gathers of the whole patch tensor."""
    COUNTS["plain"] += 1
    b, h, w, cin = x.shape
    g = mask.shape[-1] // TAPS
    cg = cin // g
    dev = x.device
    off = offset.reshape(b, h, w, g, TAPS, 2)
    m = mask.reshape(b, h, w, g, TAPS)
    tap = torch.arange(TAPS, device=dev)
    dy = (tap // 3 - 1).to(x.dtype)
    dx = (tap % 3 - 1).to(x.dtype)
    yy = torch.arange(h, device=dev, dtype=x.dtype)[:, None, None, None]
    xx = torch.arange(w, device=dev, dtype=x.dtype)[None, :, None, None]
    (y0, y1), (wy0, wy1), (iny0, iny1) = _axis(yy, off[..., 0], dy, h, radius)
    (x0, x1), (wx0, wx1), (inx0, inx1) = _axis(xx, off[..., 1], dx, w, radius)

    src = x.reshape(b, h * w, g, cg).permute(0, 2, 1, 3)            # (B, G, HW, cg)

    def gather(yi, xi, inb):
        idx = (yi * w + xi).permute(0, 3, 1, 2, 4).reshape(b, g, h * w * TAPS, 1)
        v = torch.gather(src, 2, idx.expand(-1, -1, -1, cg))
        v = v.reshape(b, g, h, w, TAPS, cg).permute(0, 2, 3, 1, 4, 5)   # (B, H, W, G, K, cg)
        return v * inb[..., None].to(v.dtype)

    def u(t):
        return t[..., None]

    out = ((gather(y0, x0, iny0 & inx0) * u(wx0)) * u(wy0)
           + (gather(y0, x1, iny0 & inx1) * u(wx1)) * u(wy0)
           + (gather(y1, x0, iny1 & inx0) * u(wx0)) * u(wy1)
           + (gather(y1, x1, iny1 & inx1) * u(wx1)) * u(wy1)) * u(m)
    # (B, H, W, G, K, cg) -> (B, H, W, K, G * cg)
    return out.permute(0, 1, 2, 4, 3, 5).reshape(b, h, w, TAPS, cin)


def _lib() -> ctypes.CDLL:
    from vosesam_tpu_torch.ops.kernels import _build

    lib = _build.load("deform_align")
    fn = lib.vosesam_deform_patches
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, offset, mask, radius, fn: str = "deform_patches_bounded") -> int:
    """Raise on what the function does not take; returns the group count."""
    if x.dtype != torch.float32:
        raise TypeError(f"{fn}: x must be float32, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"{fn}: x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    if mask.ndim != 4 or mask.shape[-1] % TAPS != 0 or mask.shape[-1] == 0:
        raise ValueError(f"{fn}: mask must be (B, H, W, G * 9), got {tuple(mask.shape)}")
    g = mask.shape[-1] // TAPS
    if cin % g != 0:
        raise ValueError(f"{fn}: Cin = {cin} is no multiple of the {g} deform groups")
    for name, t, last in (("offset", offset, 2 * g * TAPS), ("mask", mask, g * TAPS)):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != (b, h, w, last):
            raise ValueError(f"{fn}: {name} must be {(b, h, w, last)}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on {x.device}")
    if radius is not None and (int(radius) != radius or radius < 0):
        raise ValueError(f"{fn}: radius must be None or a non-negative integer, got {radius!r}")
    return g


def deform_patches_bounded(
    x: torch.Tensor,        # (B, H, W, Cin) fp32 features, channel-last
    offset: torch.Tensor,   # (B, H, W, 2 * G * 9) fp32, (y, x) pairs per (group, tap)
    mask: torch.Tensor,     # (B, H, W, G * 9) fp32 modulation
    radius: Optional[int] = None,
) -> torch.Tensor:
    """(B, H, W, 9, Cin) fp32 patches in the natural channel order (B6)."""
    g = _check(x, offset, mask, radius)
    if x.device.type == "cpu":
        return deform_patches_plain(x, offset, mask, radius)
    if x.device.type != "cuda":
        raise ValueError(f"deform_patches_bounded: no kernel for device {x.device}")
    x, offset, mask = x.contiguous(), offset.contiguous(), mask.contiguous()
    b, h, w, cin = x.shape
    out = torch.empty((b, h, w, TAPS, cin), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    vec = 4 if (cin // g) % 4 == 0 and aligned else 1
    rc = _lib().vosesam_deform_patches(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, h, w, cin, g, -1 if radius is None else int(radius), vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deform_patches_bounded kernel launch failed: CUDA error {rc}")
    COUNTS["deform_patches_bounded"] += 1
    return out
