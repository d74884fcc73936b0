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
bounds it on the H100 and what the design does about it: a block per
`pixels_per_block` pixels computes each sample's geometry once, then
writes the patches in output order). `occupancy` reports what the card
makes of an instance. `radius=None` is
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

Gradients: `deform_patches_bounded` is the autograd Function
`DeformPatches`. On the card its backward launches the hand-written kernel
`vosesam_deform_patches_backward` (same source; its header gives the
formula and the design); on the CPU the Function runs the plain forward and
`deform_patches_backward_plain`, the backward written out in plain PyTorch
with the kernel's formula. The kernel's design: cg / 4 lanes per
(pixel, tap, group) sample, each lane one 4-channel chunk, so the lanes of
a corner add its cg contiguous floats to grad_x in one warp instruction of
16-byte vector atomics; the lanes' partial sums of grad_offset and
grad_mask meet in a fixed-order butterfly (the same bits in every call).
grad_x is accumulated with fp32 atomics whose order changes from call to
call, so it matches the plain backward to rounding only. A window of grad_x
in shared memory per tile of output pixels, flushed once, was measured
instead and dropped: fp32 adds to shared memory are compare-and-swap loops
on sm_90, so it was slower than the lanes (PERF.md).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

# Launches of the forward and backward kernels, and plain calls of each.
COUNTS: Dict[str, int] = {"deform_patches_bounded": 0, "deform_patches_backward": 0,
                          "plain": 0, "plain_backward": 0}

TAPS = 9
INT32_MAX = 2 ** 31 - 1     # the kernel indexes in 32 bits


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _axis(pos: torch.Tensor, off: torch.Tensor, tap: torch.Tensor, extent: int,
          radius: Optional[int]):
    """One axis of every sample: clamped indices of the two corners, their
    weights (0 where the radius rule drops the corner), in-field flags, and
    the radius rule's 0 / 1 factors (1 without a radius)."""
    a = pos + (off + tap)                     # (off + tap) first, then the grid
    f0 = torch.floor(a)
    f1 = f0 + 1.0
    frac = a - f0
    w0, w1 = 1.0 - frac, frac
    k0 = k1 = torch.ones((), dtype=a.dtype, device=a.device)
    if radius is not None:
        d0 = f0 - pos
        d1 = d0 + 1.0
        k0 = ((d0 >= -radius) & (d0 <= radius)).to(a.dtype)
        k1 = ((d1 >= -radius) & (d1 <= radius)).to(a.dtype)
        w0, w1 = w0 * k0, w1 * k1
    in0 = (f0 >= 0) & (f0 < extent)
    in1 = (f1 >= 0) & (f1 < extent)
    i0 = f0.clamp(0, extent - 1).long()
    i1 = f1.clamp(0, extent - 1).long()
    return (i0, i1), (w0, w1), (in0, in1), (k0, k1)


def _samples(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
             radius: Optional[int]):
    """Every sample's geometry and corner values, as both plain versions use
    them: (modulation (B, H, W, G, K), weights (wx0, wx1, wy0, wy1), the
    radius factors (rx, ry), and per corner 00 / 01 / 10 / 11 its flat
    gather index (B, G, H W K, 1), in-field flag and value (B, H, W, G, K,
    cg), zero outside the field)."""
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
    (y0, y1), (wy0, wy1), (iny0, iny1), ry = _axis(yy, off[..., 0], dy, h, radius)
    (x0, x1), (wx0, wx1), (inx0, inx1), rx = _axis(xx, off[..., 1], dx, w, radius)

    src = x.reshape(b, h * w, g, cg).permute(0, 2, 1, 3)            # (B, G, HW, cg)
    corners = []
    for yi, xi, inb in ((y0, x0, iny0 & inx0), (y0, x1, iny0 & inx1),
                        (y1, x0, iny1 & inx0), (y1, x1, iny1 & inx1)):
        idx = (yi * w + xi).permute(0, 3, 1, 2, 4).reshape(b, g, h * w * TAPS, 1)
        v = torch.gather(src, 2, idx.expand(-1, -1, -1, cg))
        v = v.reshape(b, g, h, w, TAPS, cg).permute(0, 2, 3, 1, 4, 5)   # (B, H, W, G, K, cg)
        corners.append((idx, inb, v * inb[..., None].to(v.dtype)))
    return m, (wx0, wx1, wy0, wy1), (rx, ry), corners


def _u(t: torch.Tensor) -> torch.Tensor:
    return t[..., None]


def deform_patches_plain(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                         radius: Optional[int] = None) -> torch.Tensor:
    """The same function with four gathers of the whole patch tensor."""
    COUNTS["plain"] += 1
    b, h, w, cin = x.shape
    m, (wx0, wx1, wy0, wy1), _, corners = _samples(x, offset, mask, radius)
    (_, _, v00), (_, _, v01), (_, _, v10), (_, _, v11) = corners
    out = ((v00 * _u(wx0)) * _u(wy0)
           + (v01 * _u(wx1)) * _u(wy0)
           + (v10 * _u(wx0)) * _u(wy1)
           + (v11 * _u(wx1)) * _u(wy1)) * _u(m)
    # (B, H, W, G, K, cg) -> (B, H, W, K, G * cg)
    return out.permute(0, 1, 2, 4, 3, 5).reshape(b, h, w, TAPS, cin)


def deform_patches_backward_plain(grad: torch.Tensor, x: torch.Tensor, offset: torch.Tensor,
                                  mask: torch.Tensor, radius: Optional[int] = None):
    """(grad_x, grad_offset, grad_mask) of `deform_patches_plain` for the
    patches' gradient `grad` (B, H, W, 9, Cin), written out with the backward
    kernel's formula: per channel ds = grad * m; each in-field corner gets
    (ds * wy) * wx; grad_mask sums grad times the four-corner value over the
    group's channels; each axis's offset gets -(d w0 * r0) + d w1 * r1, the
    weights' gradients summed over the channels (frac's derivative is 1,
    floor's 0), r the radius rule's 0 / 1 factors."""
    COUNTS["plain_backward"] += 1
    b, h, w, cin = x.shape
    g = mask.shape[-1] // TAPS
    cg = cin // g
    m, (wx0, wx1, wy0, wy1), (rx, ry), corners = _samples(x, offset, mask, radius)
    (_, _, v00), (_, _, v01), (_, _, v10), (_, _, v11) = corners

    gp = grad.reshape(b, h, w, TAPS, g, cg).permute(0, 1, 2, 4, 3, 5)    # (B, H, W, G, K, cg)
    ds = gp * _u(m)
    ta, tc = ds * _u(wy0), ds * _u(wy1)
    dwx0 = (ta * v00).sum(-1) + (tc * v10).sum(-1)
    dwx1 = (ta * v01).sum(-1) + (tc * v11).sum(-1)
    dwy0 = (ds * (v00 * _u(wx0))).sum(-1) + (ds * (v01 * _u(wx1))).sum(-1)
    dwy1 = (ds * (v10 * _u(wx0))).sum(-1) + (ds * (v11 * _u(wx1))).sum(-1)
    val = (((v00 * _u(wx0)) * _u(wy0) + (v01 * _u(wx1)) * _u(wy0))
           + (v10 * _u(wx0)) * _u(wy1)) + (v11 * _u(wx1)) * _u(wy1)
    grad_mask = (gp * val).sum(-1).reshape(b, h, w, g * TAPS)
    goy = -(dwy0 * ry[0]) + dwy1 * ry[1]
    gox = -(dwx0 * rx[0]) + dwx1 * rx[1]
    grad_offset = torch.stack([goy, gox], dim=-1).reshape(b, h, w, 2 * g * TAPS)

    grad_src = torch.zeros((b, g, h * w, cg), dtype=x.dtype, device=x.device)
    for (idx, inb, _), t, wx in zip(corners, (ta, ta, tc, tc), (wx0, wx1, wx0, wx1)):
        contrib = (t * _u(wx)) * inb[..., None].to(x.dtype)             # (B, H, W, G, K, cg)
        contrib = contrib.permute(0, 3, 1, 2, 4, 5).reshape(b, g, h * w * TAPS, cg)
        grad_src.scatter_add_(2, idx.expand(-1, -1, -1, cg), contrib)
    grad_x = grad_src.permute(0, 2, 1, 3).reshape(b, h, w, cin)
    return grad_x, grad_offset, grad_mask


def _lib() -> ctypes.CDLL:
    from vosesam_tpu_torch.ops.kernels import _build

    lib = _build.load("deform_align")
    fn = lib.vosesam_deform_patches
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        bwd = lib.vosesam_deform_patches_backward
        bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        bwd.restype = ctypes.c_int
    return lib


def pixels_per_block(cin: int, vec: int) -> int:
    """Pixels of one 256-thread block: about four and a half output vectors a
    thread (2 pixels at Cin 256 with 16-byte vectors: 3240 blocks at the
    model's shape, faster on the H100 than 4 or more pixels a block)."""
    return max(1, 1152 // (TAPS * cin // vec))


OCCUPANCY_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                  "blocks_per_sm", "threads_per_block", "local_bytes")


def occupancy(cin: int, groups: int, vec: int = 4) -> Dict[str, int]:
    """Registers, shared memory and resident blocks per SM of the instance a
    launch at (Cin, G) with `vec`-float accesses selects, as the card reports
    them, and the pixels per block."""
    fn = _lib().vosesam_deform_occupancy
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
    info = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    pixels = pixels_per_block(cin, vec)
    rc = fn(vec, pixels, groups, info)
    if rc != 0:
        raise RuntimeError(f"deform_align occupancy query failed: CUDA error {rc}")
    return dict(zip(OCCUPANCY_KEYS, info), pixels_per_block=pixels)


def backward_occupancy(vec: int = 4, cg: int = 16) -> Dict[str, int]:
    """The same report for the backward instance a launch at (vec, cg)
    selects (the lanes kernel, or the scalar one)."""
    fn = _lib().vosesam_deform_backward_occupancy
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
    info = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    rc = fn(vec, cg, info)
    if rc != 0:
        raise RuntimeError(f"deform_align backward occupancy query failed: CUDA error {rc}")
    return dict(zip(OCCUPANCY_KEYS, info))


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


def _check_indexing(x, offset, fn: str = "deform_patches_bounded") -> None:
    """Raise where the kernel's 32-bit index arithmetic would overflow: the
    patches (B, H, W, 9, Cin) and the offsets must each hold fewer than 2^31
    values."""
    b, h, w, cin = x.shape
    n_out = b * h * w * TAPS * cin
    if n_out > INT32_MAX or offset.numel() > INT32_MAX:
        raise ValueError(f"{fn}: {n_out} patch values or {offset.numel()} offsets exceed the "
                         f"kernel's 32-bit indexing ({INT32_MAX})")


def _vec(cg: int, *tensors) -> int:
    """4 (16-byte accesses) where the group's channels come in fours and
    every tensor is 16-byte aligned, else 1."""
    return 4 if cg % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _forward_kernel(x, offset, mask, radius: Optional[int]) -> torch.Tensor:
    g = mask.shape[-1] // TAPS
    x, offset, mask = x.contiguous(), offset.contiguous(), mask.contiguous()
    if offset.data_ptr() % 8:              # the kernel reads (y, x) pairs as float2
        offset = offset.clone()
    b, h, w, cin = x.shape
    out = torch.empty((b, h, w, TAPS, cin), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    vec = _vec(cin // g, x, out)
    rc = _lib().vosesam_deform_patches(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, h, w, cin, g, -1 if radius is None else int(radius), vec,
        pixels_per_block(cin, vec), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deform_patches_bounded kernel launch failed: CUDA error {rc}")
    COUNTS["deform_patches_bounded"] += 1
    return out


def _backward_kernel(grad, x, offset, mask, radius: Optional[int]):
    """(grad_x, grad_offset, grad_mask) by the backward kernel."""
    g = mask.shape[-1] // TAPS
    grad, x = grad.contiguous(), x.contiguous()
    offset, mask = offset.contiguous(), mask.contiguous()
    if offset.data_ptr() % 8:
        offset = offset.clone()
    b, h, w, cin = x.shape
    grad_x = torch.zeros_like(x)
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    if grad.numel() == 0:
        return grad_x, grad_offset, grad_mask
    vec = _vec(cin // g, x, grad, grad_x)
    rc = _lib().vosesam_deform_patches_backward(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), grad.data_ptr(), grad_x.data_ptr(),
        grad_offset.data_ptr(), grad_mask.data_ptr(), b, h, w, cin, g,
        -1 if radius is None else int(radius), vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deform_patches_bounded backward kernel launch failed: CUDA error {rc}")
    COUNTS["deform_patches_backward"] += 1
    return grad_x, grad_offset, grad_mask


class DeformPatches(torch.autograd.Function):
    """B6 with its gradient: the forward kernel and the backward kernel on
    the card, `deform_patches_plain` and `deform_patches_backward_plain` on
    the CPU. `radius` gets no gradient."""

    @staticmethod
    def forward(ctx, x, offset, mask, radius):
        ctx.radius = radius
        ctx.save_for_backward(x, offset, mask)
        if x.device.type == "cpu":
            return deform_patches_plain(x, offset, mask, radius)
        return _forward_kernel(x, offset, mask, radius)

    @staticmethod
    def backward(ctx, grad):
        x, offset, mask = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = deform_patches_backward_plain(grad, x, offset, mask, ctx.radius)
        else:
            grads = _backward_kernel(grad, x, offset, mask, ctx.radius)
        return (*(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad)), None)


def deform_patches_bounded(
    x: torch.Tensor,        # (B, H, W, Cin) fp32 features, channel-last
    offset: torch.Tensor,   # (B, H, W, 2 * G * 9) fp32, (y, x) pairs per (group, tap)
    mask: torch.Tensor,     # (B, H, W, G * 9) fp32 modulation
    radius: Optional[int] = None,
) -> torch.Tensor:
    """(B, H, W, 9, Cin) fp32 patches in the natural channel order (B6),
    differentiable in x, offset and mask (`DeformPatches`)."""
    _check(x, offset, mask, radius)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deform_patches_bounded: no kernel for device {x.device}")
    if x.device.type == "cuda":
        _check_indexing(x, offset)
    return DeformPatches.apply(x, offset, mask, radius)
