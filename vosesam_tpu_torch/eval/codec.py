"""Image files for the evaluation harness, on what an installation has.

The JAX harness reads and writes every image through Pillow. The port's
harness must also run where Pillow is missing (the card's machine has
numpy, torch and the standard library), so it keeps its own codecs:

  PNG   a reader and a writer on `zlib` and `struct`: 8-bit palette masks
        (colour type 3, also at 1, 2 and 4 bits as Pillow writes small
        palettes), greyscale, RGB and their alpha forms, 8 or 16 bits, not
        interlaced. Enough for DAVIS / LVOS annotations and lossless frames.
  JPEG  decoding only, through the repo's native libjpeg loader
        (`native/loader.cpp`, built with `make -C native` on first use,
        bound here with ctypes); where it cannot be built or loaded,
        through Pillow if Pillow is importable (with a warning); else an
        ImportError that names what is missing. Encoding goes through
        Pillow only (`jpeg_encoder_available`).

Any other file is read by its content: a PNG signature goes to the PNG
reader, anything else to the JPEG path (Pillow reads any format by content,
and so did the JAX harness). The same codecs work in memory, on bytes
(`encode_png_palette`, `encode_png_rgb`, `decode_png`, `decode_rgb`,
`decode_indices`), for the server's base64 payloads.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import tempfile
import threading
import warnings
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_NATIVE_LIB = os.path.join(_NATIVE_DIR, "libvosloader.so")

# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# ------------------------------------------------------------------- PNG

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _encode(pixels: np.ndarray, colour_type: int, extra: bytes = b"") -> bytes:
    h, w = pixels.shape[:2]
    rows = pixels.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)   # filter 0 a row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def encode_png_palette(index: np.ndarray, palette: np.ndarray) -> bytes:
    """(H, W) uint8 indices and an (N, 3) uint8 palette -> the bytes of an
    8-bit palette PNG."""
    index = np.ascontiguousarray(index, np.uint8)
    if index.ndim != 2:
        raise ValueError(f"palette PNG: indices must be (H, W), got {index.shape}")
    plte = np.ascontiguousarray(palette, np.uint8).reshape(-1, 3)[:256]
    return _encode(index, 3, _chunk(b"PLTE", plte.tobytes()))


def encode_png_rgb(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"RGB PNG: pixels must be (H, W, 3), got {rgb.shape}")
    return _encode(rgb, 2)


def write_png_palette(path: str, index: np.ndarray, palette: np.ndarray) -> None:
    """(H, W) uint8 indices and an (N, 3) uint8 palette -> an 8-bit palette PNG."""
    data = encode_png_palette(index, palette)
    with open(path, "wb") as f:
        f.write(data)


def write_png_rgb(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG."""
    data = encode_png_rgb(rgb)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (none, sub, up, average, Paeth)."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size < h * (stride + 1):
        raise ValueError("PNG: image data is truncated")
    rows = buf[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft == 1 and stride % bpp == 0:   # running sums along each sample
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ft in (1, 3, 4):
            cur = line.copy()
            for x in range(stride):          # each byte needs the decoded one bpp before it
                a = cur[x - bpp] if x >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + prev[x]) >> 1
                else:
                    b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown row filter {ft}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """-> (pixels, palette, colour type) of a PNG file (`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "PNG data") -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """The bytes of a PNG -> (pixels, palette, colour type). Pixels are (H, W)
    for greyscale and palette images (palette indices), (H, W, C) otherwise,
    uint8 (16-bit samples keep their high byte, as Pillow's 8-bit modes
    do). `path` names the source in errors."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is not supported")
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG files are not supported")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    stride = (w * bits + 7) // 8
    raw = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, bits // 8))
    if depth < 8:                            # packed indices / grey levels, high bits first
        per = 8 // depth
        shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
        vals = (raw[:, :, None] >> shifts) & ((1 << depth) - 1)
        px = vals.reshape(h, -1)[:, :w].astype(np.uint8)
        if ctype == 0:                       # grey levels scaled to 8 bits
            px = (px.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        return px, palette, ctype
    if depth == 16:
        raw = raw.reshape(h, -1, 2)[:, :, 0]
    px = raw.reshape(h, w, ch) if ch > 1 else raw.reshape(h, w)
    return np.ascontiguousarray(px), palette, ctype


def png_rgb(path: str) -> np.ndarray:
    """A PNG as (H, W, 3) uint8 RGB (Pillow's convert("RGB"): a palette is
    looked up, grey is repeated, alpha is dropped)."""
    return _rgb(*read_png(path), path)


def _rgb(px: np.ndarray, palette: Optional[np.ndarray], ctype: int, path: str) -> np.ndarray:
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette
        return full[px]
    if ctype in (0, 4):
        grey = px if ctype == 0 else px[..., 0]
        return np.repeat(grey[..., None], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def png_indices(path: str) -> np.ndarray:
    """A palette or greyscale PNG as (H, W) uint8 indices (Pillow's
    convert("P") on "P" and "L" images)."""
    px, _, ctype = read_png(path)
    return _indices(px, ctype, path)


def _indices(px: np.ndarray, ctype: int, path: str) -> np.ndarray:
    if ctype == 3 or ctype == 0:
        return px
    if ctype == 4:
        return np.ascontiguousarray(px[..., 0])
    raise ValueError(f"{path}: an RGB PNG has no palette indices (Pillow would quantise it)")


# ------------------------------------------------------------------- JPEG

class _Native:
    """The repo's native JPEG loader (`native/loader.cpp`), built on first
    use with `make -C native`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._error: Optional[str] = None

    def lib(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._lib is None and self._error is None:
                self._lib, self._error = self._load()
            return self._lib

    @property
    def error(self) -> Optional[str]:
        return self._error

    @staticmethod
    def _load():
        if not os.path.exists(_NATIVE_LIB):
            try:
                res = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                                     text=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired) as e:
                return None, f"make -C native failed: {e}"
            if res.returncode != 0:
                return None, f"make -C native failed: {res.stderr.strip()[-300:]}"
        try:
            lib = ctypes.CDLL(_NATIVE_LIB)
        except OSError as e:
            return None, f"{_NATIVE_LIB} does not load: {e}"
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.loader_release.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        return lib, None

    def decode(self, paths: Sequence[str], threads: int = 4, depth: int = 8) -> List[np.ndarray]:
        lib = self.lib()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        handle = lib.loader_create(arr, len(paths), threads, depth)
        frames = []
        try:
            data = ctypes.POINTER(ctypes.c_ubyte)()
            w, h, idx = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            while True:
                rc = lib.loader_next(handle, ctypes.byref(data), ctypes.byref(w),
                                     ctypes.byref(h), ctypes.byref(idx))
                if rc == 1:
                    break
                if rc < 0:
                    raise IOError(f"failed to decode {paths[idx.value]}")
                buf = np.ctypeslib.as_array(data, shape=(w.value * h.value * 3,))
                frames.append(buf.reshape(h.value, w.value, 3).copy())
                lib.loader_release(data)
        finally:
            lib.loader_destroy(handle)
        return frames


_NATIVE = _Native()
_warned = False


def _pillow():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decode_jpegs(paths: Sequence[str]) -> List[np.ndarray]:
    """JPEG files -> (H, W, 3) uint8 RGB frames, in order: the native
    loader, else Pillow, else an ImportError naming what is missing."""
    global _warned
    paths = list(paths)
    if not paths:
        return []
    if _NATIVE.lib() is not None:
        return _NATIVE.decode(paths)
    image = _pillow()
    if image is None:
        raise ImportError(
            "JPEG decoding needs the native loader (native/loader.cpp: g++ and libjpeg "
            f"headers; {_NATIVE.error}) or Pillow, and neither is available")
    if not _warned:
        warnings.warn(f"decoding JPEG frames through Pillow: {_NATIVE.error}")
        _warned = True
    return [np.array(image.open(p).convert("RGB")) for p in paths]


def jpeg_encoder_available() -> bool:
    return _pillow() is not None


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """(H, W, 3) uint8 -> JPEG, through Pillow (the only encoder here)."""
    image = _pillow()
    if image is None:
        raise ImportError("writing JPEG files needs Pillow, which is not installed")
    image.fromarray(np.ascontiguousarray(rgb, np.uint8)).save(path, quality=quality)


# ------------------------------------------------------------- by content

def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG_SIGNATURE


def read_rgb(path: str) -> np.ndarray:
    """Any frame file -> (H, W, 3) uint8 RGB: PNG by its signature, the rest
    through the JPEG path."""
    if is_png(path):
        return png_rgb(path)
    return decode_jpegs([path])[0]


def decode_rgb(data: bytes) -> np.ndarray:
    """The bytes of an image file -> (H, W, 3) uint8 RGB, as `read_rgb` reads
    the file: PNG by its signature, the rest through the JPEG path (whose
    native loader reads files: the bytes go through a temporary file)."""
    if data[:8] == PNG_SIGNATURE:
        return _rgb(*decode_png(data), "PNG data")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "image.jpg")
        with open(path, "wb") as f:
            f.write(data)
        return decode_jpegs([path])[0]


def decode_indices(data: bytes) -> np.ndarray:
    """The bytes of a palette or greyscale PNG -> (H, W) uint8 indices
    (`png_indices`)."""
    px, _, ctype = decode_png(data)
    return _indices(px, ctype, "PNG data")
