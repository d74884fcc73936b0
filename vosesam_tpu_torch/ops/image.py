"""Image pre/post ops (port of `vosesam_tpu/ops/image.py`).

Reference: ImageNet normalization (tracker/util/range_transform.py:5-10),
pad_divide_by / unpad (tracker/util/tensor_util.py:17-47), SAM's
ResizeLongestSide and the mask-prompt resizer (tracker/base_tracker.py:
214-229). Layouts follow the JAX package: images are (..., H, W, C)
channel-last.

Resizes are the JAX package's `jax.image.resize` exactly: "linear" builds
its separable weights with JAX's formula (triangle kernel widened by the
downsampling factor, so a downsample antialiases; half-pixel centres; each
output normalised by its weight sum), built once per (in, out) size on the
host and applied as two matmuls; "nearest" samples input
floor((i + 0.5) * in / out), computed in fp32 as JAX does (torch's
"nearest-exact" rule, not "nearest").
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def im_normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8/float (..., H, W, 3) RGB -> ImageNet-normalized fp32,
    channel-last. Divides by 255 only for uint8 input (ToTensor semantics)."""
    x = img.float()
    if img.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    return (x - mean) / std


def pad_amounts(h: int, w: int, d: int = 16) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) pads making H, W multiples of d; the odd
    pixel lands right/bottom (tensor_util.py:17-31)."""
    new_h = -(-h // d) * d
    new_w = -(-w // d) * d
    lh = (new_h - h) // 2
    uh = new_h - h - lh
    lw = (new_w - w) // 2
    uw = new_w - w - lw
    return lw, uw, lh, uh


def pad_divide_by(x: torch.Tensor, d: int = 16, axes: Tuple[int, int] = (-3, -2)):
    """Zero-pad the two spatial `axes` (default (..., H, W, C)) to multiples
    of d. Returns (padded, (lw, uw, lh, uh))."""
    ah, aw = axes[0] % x.ndim, axes[1] % x.ndim
    lw, uw, lh, uh = pad_amounts(x.shape[ah], x.shape[aw], d)
    # F.pad lists pads from the last axis backwards.
    pads = [0, 0] * x.ndim
    pads[2 * (x.ndim - 1 - ah): 2 * (x.ndim - 1 - ah) + 2] = [lh, uh]
    pads[2 * (x.ndim - 1 - aw): 2 * (x.ndim - 1 - aw) + 2] = [lw, uw]
    return F.pad(x, pads), (lw, uw, lh, uh)


def unpad(x: torch.Tensor, pad: Tuple[int, int, int, int],
          axes: Tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """Invert pad_divide_by (tensor_util.py:34-47)."""
    lw, uw, lh, uh = pad
    ah, aw = axes[0] % x.ndim, axes[1] % x.ndim
    sl = [slice(None)] * x.ndim
    sl[ah] = slice(lh, x.shape[ah] - uh if uh > 0 else None)
    sl[aw] = slice(lw, x.shape[aw] - uw if uw > 0 else None)
    return x[tuple(sl)]


# --------------------------------------------------------------- resizes

@functools.lru_cache(maxsize=None)
def linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) fp32 weights of jax.image.resize(method="linear",
    antialias=True) along one axis (jax/_src/image/scale.py
    compute_weight_mat, computed in fp32 like JAX)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)            # (in, out)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0)).T.astype(f32))


@functools.lru_cache(maxsize=None)
def nearest_resize_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index per output of jax.image.resize(method="nearest")."""
    off = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in) \
        / np.float32(n_out)
    return np.floor(off.astype(np.float32)).astype(np.int64)


_DEVICE_CONSTS: Dict[tuple, torch.Tensor] = {}


def device_const(key: tuple, make, device: torch.device) -> torch.Tensor:
    """A constant built on the host once and kept on `device`, so that hot
    paths copy nothing from the host after their first call."""
    k = key + (str(device),)
    t = _DEVICE_CONSTS.get(k)
    if t is None:
        t = torch.as_tensor(make(), device=device)
        _DEVICE_CONSTS[k] = t
    return t


def _resize_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    w = device_const(("linear", n_in, n_out),
                     lambda: linear_resize_weights(n_in, n_out), x.device)
    xt = x.movedim(axis, -1)
    y = torch.matmul(xt, w.T.to(xt.dtype))
    return y.movedim(-1, axis)


def resize_bilinear(x: torch.Tensor, out_hw: Sequence[int],
                    axes: Tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """jax.image.resize(method="linear") over two spatial axes: half-pixel
    centres, antialiased when downsampling. Computes in fp32 (or the input's
    float dtype) and returns that dtype."""
    if not x.is_floating_point():
        x = x.float()
    ah, aw = axes[0] % x.ndim, axes[1] % x.ndim
    y = _resize_axis(x, ah, int(out_hw[0]))
    return _resize_axis(y, aw, int(out_hw[1]))


@functools.lru_cache(maxsize=None)
def align_corners_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) fp32 weights of a linear resize with `align_corners=True`
    along one axis: output i samples input i * (n_in - 1) / (n_out - 1), two
    non-zeros per row (positions in float64, weights rounded to fp32, as the
    JAX package builds them)."""
    src = np.zeros((1,), np.float64) if n_out == 1 else np.linspace(0.0, n_in - 1.0, n_out)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    t = src - i0
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), i0] += (1.0 - t)
    m[np.arange(n_out), i1] += t
    return m


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) with `align_corners=True` semantics
    (corner pixels map onto corners), as two dense contractions: E2FGVI's
    1/4 downscale of the frames, the x2 flow upsamples of SPyNet and the
    decoder's x2 upsamples."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    my = device_const(("align_corners", h, oh), lambda: align_corners_weights(h, oh), x.device)
    mx = device_const(("align_corners", w, ow), lambda: align_corners_weights(w, ow), x.device)
    rows = torch.einsum("oh,...hwc->...owc", my.to(x.dtype), x)
    return torch.einsum("pw,...owc->...opc", mx.to(x.dtype), rows)


def resize_nearest(x: torch.Tensor, out_hw: Sequence[int],
                   axes: Tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """jax.image.resize(method="nearest"): input floor((i + 0.5) * in / out)."""
    for axis, n_out in zip(axes, out_hw):
        axis = axis % x.ndim
        n_in = x.shape[axis]
        if n_in != int(n_out):
            idx = device_const(("nearest", n_in, int(n_out)),
                               lambda: nearest_resize_index(n_in, int(n_out)), x.device)
            x = x.index_select(axis, idx)
    return x


def resize_mask_prompt(logit: torch.Tensor, out_size) -> torch.Tensor:
    """(..., H, W) logit maps -> SAM mask prompts: the long side scaled to the
    prompt's, bottom/right filled with each map's minimum (base_tracker.py:
    214-229). `out_size` is an int (square) or (out_h, out_w)."""
    h, w = logit.shape[-2:]
    out_h, out_w = (out_size, out_size) if isinstance(out_size, int) else out_size
    scale = min(out_h / h, out_w / w)
    nh = max(1, min(out_h, int(round(h * scale))))
    nw = max(1, min(out_w, int(round(w * scale))))
    resized = resize_bilinear(logit, (nh, nw), axes=(-2, -1)).to(logit.dtype)
    fill = logit.amin(dim=(-2, -1), keepdim=True)
    out = fill.expand(*logit.shape[:-2], out_h, out_w).clone()
    out[..., :nh, :nw] = resized
    return out


def sam_input_resize(img: torch.Tensor, target: int = 1024, rect: bool = False,
                     patch: int = 16) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Longest-side resize of (..., H, W, C) images to SAM's input with
    bottom/right zero padding: to the (target, target) square, or with
    `rect` only to the next patch multiple per side (SAMConfig.encode_rect).
    Returns (padded, (nh, nw) pre-pad size)."""
    h, w = img.shape[-3], img.shape[-2]
    scale = target / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_bilinear(img, (nh, nw), axes=(-3, -2))
    if rect:
        ph, pw = -(-nh // patch) * patch, -(-nw // patch) * patch
    else:
        ph = pw = target
    out = F.pad(resized, (0, 0, 0, pw - nw, 0, ph - nh))
    return out, (nh, nw)
