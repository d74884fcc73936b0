"""Host-side video IO (port of `vosesam_tpu/eval/video_io.py`;
tools/masks_handler.py:34-49, app.py:335-356).

Uses imageio's ffmpeg writer (the reference uses torchvision write_video /
libx264), imported when a video is read or written: where imageio is not
installed both functions raise an ImportError that says so. The runners
reach them only with `compute_video=True`."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _imageio():
    try:
        import imageio
        import imageio.v3  # noqa: F401
    except ImportError as e:
        raise ImportError(f"reading or writing video needs imageio, which is not "
                          f"installed ({e})") from e
    return imageio


def read_video_frames(path: str) -> List[np.ndarray]:
    iio = _imageio().v3
    # [..., :3]: GIF/PNG-backed clips may decode RGBA; the pipeline is RGB.
    return [np.asarray(f)[..., :3] for f in iio.imiter(path)]


def write_video(path: str, frames: Sequence[np.ndarray], fps: int = 10) -> None:
    imageio = _imageio()
    frames = [np.repeat(f[..., None], 3, -1) if f.ndim == 2 else f for f in frames]
    frames = [f.astype(np.uint8) for f in frames]
    try:
        imageio.mimwrite(path, frames, fps=fps, codec="libx264")
    except Exception:
        # ffmpeg plugin unavailable: fall back to GIF next to the target
        imageio.mimwrite(path + ".gif", frames, fps=fps)
