"""Captions drawn without Pillow: ``ImageDraw.Draw(im).text(xy, text,
fill=fill)`` with Pillow's default font, pixel for pixel.

Pillow 12.1's default font is Aileron Regular at size 10, drawn by
FreeType with BASIC layout and antialiasing. Its glyphs are data here
(``text_glyphs.npz``, written from Pillow by
``tests/data/font/make_glyphs.py``; its ``source`` entry names the font):
each glyph's coverage mask, its offset from the pen and its integer
advance, and the font's code point → glyph map (a code point the font does
not map draws ``.notdef``). A line is laid out as Pillow lays it: glyphs
at a pen that advances by their integer advances, no kerning (the font
has no kern table), overlapping coverage combined as ``t + s - t·s/255``
(rounded), the line's mask then blended into the image as Pillow's
``draw_bitmap`` does, clipped at the image's edges. A ``"\\n"`` starts a
new line ``line_spacing`` pixels lower (Pillow's multi-line rule at its
default spacing 4).
"""
from __future__ import annotations

import functools
import operator
from pathlib import Path

import numpy as np

GLYPHS = Path(__file__).resolve().parent / "text_glyphs.npz"

# The named fault that the caption checks show changes a digest.
FAULTS = {"caption_max": 1}      # overlapping coverage combined by max


@functools.lru_cache(maxsize=None)
def glyph_table() -> dict:
    """The arrays of ``text_glyphs.npz``, each glyph's mask cut out."""
    with np.load(GLYPHS, allow_pickle=False) as z:
        t = {k: z[k] for k in z.files}
    t["masks"] = [t["coverage"][s:s + h * w].reshape(h, w)
                  for s, (h, w) in zip(t["start"], t["shape"])]
    t["index"] = dict(zip(t["codepoints"].tolist(), t["glyph_of"].tolist()))
    return t


def line_mask(line: str, fault: int = 0) -> tuple:
    """(coverage [h, w] uint8, (dx, dy)) of one line drawn at the origin:
    the mask Pillow's ``getmask2`` gives and its offset."""
    t = glyph_table()
    pen, placed = 0, []
    for ch in line:
        g = t["index"].get(ord(ch), 0)
        (dx, dy), mask = t["offset"][g], t["masks"][g]
        if mask.size:
            placed.append((pen + int(dx), int(dy), mask))
        pen += int(t["advance"][g])
    if not placed:
        return np.zeros((0, 0), np.uint8), (0, 0)
    # Pillow's box: the glyphs' extent, widened to the pen's run [0, pen]
    x0 = min([0] + [x for x, _, _ in placed])
    y0 = min(y for _, y, _ in placed)
    x1 = max([pen] + [x + m.shape[1] for x, _, m in placed])
    y1 = max(y + m.shape[0] for _, y, m in placed)
    out = np.zeros((y1 - y0, x1 - x0), np.int32)
    for x, y, m in placed:
        region = out[y - y0:y - y0 + m.shape[0], x - x0:x - x0 + m.shape[1]]
        s = m.astype(np.int32)
        if fault & FAULTS["caption_max"]:
            region[:] = np.maximum(region, s)
        else:
            region[:] = region + s - (region * s + 127) // 255
    return out.astype(np.uint8), (x0, y0)


def _blend(img: np.ndarray, x: int, y: int, mask: np.ndarray,
           ink: np.ndarray) -> None:
    """Pillow's ``draw_bitmap`` of ``mask`` at (x, y) in ``ink``, in place,
    clipped at the image's edges."""
    h, w = img.shape[:2]
    mx0, my0 = max(0, -x), max(0, -y)
    mx1 = min(mask.shape[1], w - x)
    my1 = min(mask.shape[0], h - y)
    if mx1 <= mx0 or my1 <= my0:
        return
    a = mask[my0:my1, mx0:mx1, None].astype(np.int32)
    region = img[y + my0:y + my1, x + mx0:x + mx1]
    tmp = ink * a + region.astype(np.int32) * (255 - a) + 128
    region[:] = ((tmp + (tmp >> 8)) >> 8).astype(np.uint8)


def draw_text(img: np.ndarray, xy, text: str, fill) -> np.ndarray:
    """``np.asarray(ImageDraw.Draw(Image.fromarray(img)).text(xy, text,
    fill=fill))`` with Pillow's default font: a copy of the uint8
    ``[H, W, 3]`` array with ``text`` drawn at the integer point ``xy``
    (the top left of its first line, Pillow's "la" anchor) in the RGB
    ``fill``."""
    return _draw_text(img, xy, text, fill, 0)


def _draw_text(img: np.ndarray, xy, text: str, fill, fault: int
               ) -> np.ndarray:
    """:func:`draw_text` with ``fault`` (bits of FAULTS) set."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"draw_text takes a uint8 [H, W, 3] array, got "
                         f"{img.dtype} {img.shape}")
    x, y = (operator.index(v) for v in xy)
    ink = np.asarray(tuple(fill)[:3], np.int32)
    if ink.shape != (3,):
        raise ValueError(f"draw_text takes an RGB fill, got {fill!r}")
    out = img.copy()
    spacing = int(glyph_table()["line_spacing"])
    for i, line in enumerate(text.split("\n")):
        mask, (dx, dy) = line_mask(line, fault)
        _blend(out, x + dx, y + i * spacing + dy, mask, ink)
    return out
