"""COCO RLE mask decoding and encoding (port of `vosesam_tpu/eval/rle.py`;
pure Python, no pycocotools).

Reference: OVIS support lives in videoPipeline.ipynb cells 2-3 via
pycocotools COCO-RLE decode (SURVEY.md §2.7). Supports both the uncompressed
{"counts": [ints], "size": [h, w]} form and the compressed LEB128-style
string encoding used by COCO/OVIS annotation files."""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def _decode_compressed_counts(s: Union[str, bytes]) -> List[int]:
    """cocoapi's rleFrString: 6-bit packed varint with sign-extended deltas."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def decode_rle(rle: Dict) -> np.ndarray:
    """{"size": [h, w], "counts": str|list} -> (h, w) uint8 mask.

    COCO RLE is column-major: counts alternate runs of 0s and 1s down the
    columns."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_compressed_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos: pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T  # column-major


def encode_rle(mask: np.ndarray) -> Dict:
    """(h, w) binary mask -> uncompressed COCO RLE dict."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # column-major
    # run lengths, starting with a 0-run (possibly empty)
    changes = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], changes, [len(flat)]])
    runs = np.diff(bounds).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return {"size": [h, w], "counts": runs}
