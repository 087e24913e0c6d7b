"""COCO run-length-encoded mask codec, pure numpy (the port's copy of
``cpt_tpu/utils/rle.py``).

Replaces the reference's ``pycocotools.mask`` usage (mask decode for
RefCOCO/VCR segmentation pastes, ``data/datasets/refcocodataset.py:293`` /
``vcrdataset.py``; encode for COCO-format mask output,
``mask_head/inference.py:64-86``). Implements the documented COCO RLE
format: column-major (Fortran) alternating runs starting with zeros, the
"counts" string using 5-bit LEB128-style chunks with difference coding for
runs beyond the second.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

Rle = Dict[str, object]


def _counts_to_string(cnts: Sequence[int]) -> str:
    s = []
    for i, x in enumerate(cnts):
        x = int(x)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def _string_to_counts(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))      # sign extension
            k += 1
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def decode(rle: Rle) -> np.ndarray:
    """{"size": [h, w], "counts": str|bytes|list} → uint8 mask [h, w]."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _string_to_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T          # column-major


def encode(mask: np.ndarray, compress: bool = True) -> Rle:
    """uint8/bool mask [h, w] → RLE dict (compressed counts string by
    default, list with ``compress=False``)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)   # column-major
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    cnts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        cnts = [0] + cnts                  # runs must start with zeros
    if not flat.size:
        cnts = [0]
    return {"size": [h, w],
            "counts": _counts_to_string(cnts) if compress else cnts}


def area(rle: Rle) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _string_to_counts(counts)
    return int(sum(counts[1::2]))


def to_bbox(rle: Rle) -> np.ndarray:
    """→ [x, y, w, h] (xywh, like ``maskUtils.toBbox``)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if ys.size == 0:
        return np.zeros(4, np.float32)
    return np.asarray([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                       ys.max() - ys.min() + 1], np.float32)


def merge(rles: Sequence[Rle], intersect: bool = False) -> Rle:
    masks = [decode(r) for r in rles]
    out = masks[0]
    for m in masks[1:]:
        out = (out & m) if intersect else (out | m)
    return encode(out.astype(np.uint8))
