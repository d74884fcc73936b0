"""Kernel B6's work: the modulated deformable 3x3 sampling of E2FGVI's
second-order alignment (`models/e2fgvi/modules.py:deform_patches_bounded`).
It is bound by memory: x, the offsets and the modulation mask read once,
the (B, H, W, 9, Cin) patches written once, all float32. Its arithmetic (a
few operations per sample) is left out: at these shapes it would take the
card a small fraction of the bytes' time."""

from __future__ import annotations


def deform_bytes(b: int, h: int, w: int, cin: int, groups: int, itemsize: int = 4) -> float:
    """Bytes one call moves at least."""
    pixels = b * h * w
    taps = 9
    return float(itemsize * pixels * (cin + 2 * groups * taps + groups * taps + taps * cin))


def deform_bound_s(b: int, h: int, w: int, cin: int, groups: int, hbm_bytes_per_s: float,
                   itemsize: int = 4) -> float:
    """The least time the card could take for one call."""
    return deform_bytes(b, h, w, cin, groups, itemsize) / hbm_bytes_per_s
