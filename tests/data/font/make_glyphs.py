#!/usr/bin/env python3
"""Write the glyph table of ``cpt_tpu_torch/utils/text.py``
(``cpt_tpu_torch/utils/text_glyphs.npz``) from Pillow's default font.

    python3 tests/data/font/make_glyphs.py

The font is the one ``ImageDraw.text`` draws with when given none:
Pillow 12.1.0's ``ImageFont.load_default()``, Aileron Regular
(dotcolon.net/fonts/aileron) at size 10, BASIC layout, antialiased. For
each glyph its code points come from the font's Unicode cmap (platform 3,
encoding 1, format 4), and its coverage mask, offset and advance from
Pillow itself: ``getmask2(ch, "L", anchor="la")`` and ``getlength(ch)``
(integral: the font has no kern table, so BASIC layout adds no kerning).
Glyph 0 is ``.notdef``, which every unmapped code point draws. The line
spacing of multi-line text is Pillow's: ``getbbox("A")[3]`` + 4.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import PIL
from PIL import Image, ImageFont

OUT = (Path(__file__).resolve().parents[3] / "cpt_tpu_torch" / "utils"
       / "text_glyphs.npz")
SPACING = 4                      # ImageDraw.text's default line spacing


def unicode_cmap(ttf: bytes) -> dict:
    """code point → glyph id from the (3, 1) format-4 subtable."""
    count = struct.unpack_from(">H", ttf, 4)[0]
    tables = {}
    for i in range(count):
        tag, _, off, length = struct.unpack_from(">4sIII", ttf, 12 + 16 * i)
        tables[tag] = (off, length)
    assert b"kern" not in tables
    base = tables[b"cmap"][0]
    for i in range(struct.unpack_from(">H", ttf, base + 2)[0]):
        pid, eid, off = struct.unpack_from(">HHI", ttf, base + 4 + 8 * i)
        if (pid, eid) == (3, 1):
            sub = base + off
            break
    else:
        raise ValueError("the font has no (3, 1) cmap")
    assert struct.unpack_from(">H", ttf, sub)[0] == 4
    segs = struct.unpack_from(">H", ttf, sub + 6)[0] // 2
    ends = struct.unpack_from(f">{segs}H", ttf, sub + 14)
    starts = struct.unpack_from(f">{segs}H", ttf, sub + 16 + 2 * segs)
    deltas = struct.unpack_from(f">{segs}h", ttf, sub + 16 + 4 * segs)
    ro_at = sub + 16 + 6 * segs
    range_offsets = struct.unpack_from(f">{segs}H", ttf, ro_at)
    cmap = {}
    for k in range(segs):
        for c in range(starts[k], ends[k] + 1):
            if c == 0xFFFF:
                continue
            if range_offsets[k] == 0:
                g = (c + deltas[k]) & 0xFFFF
            else:
                at = ro_at + 2 * k + range_offsets[k] + 2 * (c - starts[k])
                g = struct.unpack_from(">H", ttf, at)[0]
                g = (g + deltas[k]) & 0xFFFF if g else 0
            if g:
                cmap[c] = g
    return cmap


def glyph(font, ch: str) -> tuple:
    """(coverage [h, w] uint8, (dx, dy), advance) of one character."""
    core, offset = font.getmask2(ch, "L", anchor="la", start=(0, 0))
    w, h = core.size
    mask = (np.asarray(Image.Image()._new(core)) if w and h
            else np.zeros((h, w), np.uint8))
    advance = font.getlength(ch)
    assert advance == int(advance), (ch, advance)
    return mask, offset, int(advance)


def table() -> dict:
    """The arrays of ``text_glyphs.npz``."""
    font = ImageFont.load_default()
    assert isinstance(font, ImageFont.FreeTypeFont) and font.size == 10
    assert font.layout_engine == ImageFont.Layout.BASIC
    cmap = unicode_cmap(font.font_bytes)
    gids = sorted(set(cmap.values()))
    first = {}
    for c, g in sorted(cmap.items()):
        first.setdefault(g, c)
    unmapped = next(c for c in range(0xE000, 0xF900) if c not in cmap)
    chars = [chr(unmapped)] + [chr(first[g]) for g in gids]
    index = {g: i + 1 for i, g in enumerate(gids)}
    masks, offsets, advances = zip(*(glyph(font, ch) for ch in chars))
    starts = np.cumsum([0] + [m.size for m in masks])
    codepoints = np.array(sorted(cmap), np.int32)
    return {
        "source": np.array(
            f"Pillow {PIL.__version__} ImageFont.load_default(): "
            f"{' '.join(font.getname())} (Aileron, dotcolon.net/fonts/aileron) "
            f"at size {font.size}, BASIC layout, mode L; written by "
            f"tests/data/font/make_glyphs.py"),
        "codepoints": codepoints,
        "glyph_of": np.array([index[cmap[c]] for c in codepoints], np.int32),
        "shape": np.array([m.shape for m in masks], np.int32),
        "offset": np.array(offsets, np.int32),
        "advance": np.array(advances, np.int32),
        "start": starts[:-1].astype(np.int64),
        "coverage": np.concatenate([m.ravel() for m in masks]).astype(np.uint8),
        "line_spacing": np.array(font.getbbox("A", "L")[3] + SPACING, np.int32),
    }


def main() -> None:
    arrays = table()
    np.savez_compressed(OUT, **arrays)
    print(f"{OUT}: {len(arrays['shape'])} glyphs, "
          f"{len(arrays['codepoints'])} code points, {OUT.stat().st_size} bytes")


if __name__ == "__main__":
    main()
