"""Optical-flow visualization: the Middlebury color wheel (port of
`vosesam_tpu/viz/flow.py`, numpy only).

Reference: inpainter/model/modules/flow_comp.py:230-345 vendors the standard
Baker et al. (ICCV 2007) flow colorization. Hue from the 55-entry
RY / YG / GC / CB / BM / MR wheel indexed by atan2(-v, -u), saturation from
the flow's magnitude over the frame's largest, radii beyond 1 dimmed 0.75x.
Host-side debug tooling, never on the device path.
"""

from __future__ import annotations

import numpy as np

# (count, saturated channel, ramped channel, ramp direction) per wheel arc:
# RY, YG, GC, CB, BM, MR; odd arcs ramp the channel down (wrap-around).
_SEGMENTS = (
    (15, 0, 1, +1), (6, 1, 0, -1), (4, 1, 2, +1),
    (11, 2, 1, -1), (13, 2, 0, +1), (6, 0, 2, -1),
)


def make_colorwheel() -> np.ndarray:
    """(55, 3) float wheel, row i = RGB at hue bucket i."""
    ncols = sum(s[0] for s in _SEGMENTS)
    wheel = np.zeros((ncols, 3))
    col = 0
    for n, sat_ch, ramp_ch, direction in _SEGMENTS:
        ramp = np.floor(255 * np.arange(n) / n)
        wheel[col:col + n, sat_ch] = 255
        wheel[col:col + n, ramp_ch] = ramp if direction > 0 else 255 - ramp
        col += n
    return wheel


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """(H, W) normalized u, v -> (H, W, 3) uint8 colorized flow."""
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = np.where(k0 + 1 == ncols, 0, k0 + 1)
    f = (fk - k0)[..., None]
    col = (1 - f) * wheel[k0] / 255.0 + f * wheel[k1] / 255.0
    in_range = (rad <= 1)[..., None]
    col = np.where(in_range, 1 - rad[..., None] * (1 - col), col * 0.75)
    img = np.floor(255 * col).astype(np.uint8)
    return img[..., ::-1] if convert_to_bgr else img


def flow_to_image(flow_uv: np.ndarray, clip_flow: float | None = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """(H, W, 2) raw flow -> (H, W, 3) uint8 visualization, normalized by the
    frame's largest radius (flow_comp.py:323-345)."""
    if flow_uv.ndim != 3 or flow_uv.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow_uv.shape}")
    flow_uv = np.asarray(flow_uv, np.float32)
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    rad_max = float(np.sqrt(u * u + v * v).max()) if flow_uv.size else 0.0
    scale = 1.0 / (rad_max + 1e-5)
    return flow_uv_to_colors(u * scale, v * scale, convert_to_bgr)
