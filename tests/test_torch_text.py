"""The port's captions (``cpt_tpu_torch/utils/text``) against Pillow 12.1.0's
``ImageDraw.text`` with its default font: seeded strings (printable ASCII,
characters the font does not map, ``"\\n"``), inks and positions (past
every edge) drawn equal pixel for pixel; each line's mask and offset equal
to ``getmask2``'s; the committed glyph table equal to a fresh run of its
generator (``tests/data/font/make_glyphs.py``); the named fault."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import PIL
import pytest
from PIL import Image, ImageDraw, ImageFont

from cpt_tpu_torch.utils import text
from test_torch_watchdog import guards

guard_module, guard_case = guards(120)

REPO = Path(__file__).resolve().parent.parent
# printable ASCII, characters past the font's map (drawn as .notdef), a
# tab and line breaks
POOL = [chr(c) for c in range(32, 127)] + list("éü–€中ß\t\n\n")


def pillow_text(img: np.ndarray, xy, s: str, fill) -> np.ndarray:
    pil = Image.fromarray(img)
    ImageDraw.Draw(pil).text(xy, s, fill=fill)
    return np.asarray(pil)


def seeded_cases(chunk: int, n: int = 30):
    """(image, xy, string, fill): sizes 1-80 × 1-160, points from well left
    of / above the image to past its right / bottom edge, strings of 0-24
    characters."""
    rng = np.random.RandomState(100 + chunk)
    for _ in range(n):
        h, w = int(rng.randint(1, 80)), int(rng.randint(1, 160))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        xy = (int(rng.randint(-40, w + 5)), int(rng.randint(-25, h + 5)))
        s = "".join(rng.choice(POOL, int(rng.randint(0, 25))))
        fill = tuple(int(v) for v in rng.randint(0, 256, 3))
        yield img, xy, s, fill


def test_pillow_is_the_version_the_table_follows():
    assert PIL.__version__ == "12.1.0"
    assert "Pillow 12.1.0" in str(text.glyph_table()["source"])


@pytest.mark.parametrize("chunk", range(8))
def test_draw_text_is_pillows(chunk):
    """``draw_text`` equals ``ImageDraw.text`` on 30 seeded cases a chunk
    (240 in all), and leaves its input as it was."""
    for img, xy, s, fill in seeded_cases(chunk):
        before = img.copy()
        got = text.draw_text(img, xy, s, fill)
        np.testing.assert_array_equal(got, pillow_text(img, xy, s, fill),
                                      err_msg=f"{s!r} at {xy}")
        np.testing.assert_array_equal(img, before)


@pytest.mark.parametrize("chunk", range(2))
def test_line_mask_is_getmask2s(chunk):
    """Each line's coverage and offset equal Pillow's ``getmask2`` (anchor
    "la") of the default font."""
    font = ImageFont.load_default()
    rng = np.random.RandomState(200 + chunk)
    pool = [c for c in POOL if c != "\n"]
    for _ in range(60):
        s = "".join(rng.choice(pool, int(rng.randint(1, 20))))
        core, offset = font.getmask2(s, "L", anchor="la", start=(0, 0))
        mask, off = text.line_mask(s)
        want = (np.asarray(Image.Image()._new(core)) if core.size[0] * core.size[1]
                else np.zeros((0, 0), np.uint8))
        if mask.size or want.size:
            assert tuple(off) == tuple(offset), s
            np.testing.assert_array_equal(mask, want, err_msg=repr(s))


def test_every_pair_of_ascii_characters():
    """All 95 × 95 printable ASCII pairs: equal to Pillow; with the named
    fault (overlaps combined by max) some pairs differ."""
    img = np.full((20, 30, 3), 40, np.uint8)
    missed, faulted = [], 0
    for a in range(32, 127):
        for b in range(32, 127):
            s = chr(a) + chr(b)
            want = pillow_text(img, (3, 2), s, (250, 200, 10))
            if not np.array_equal(text.draw_text(img, (3, 2), s, (250, 200, 10)),
                                  want):
                missed.append(s)
            faulted += not np.array_equal(text._draw_text(
                img, (3, 2), s, (250, 200, 10), text.FAULTS["caption_max"]),
                want)
    assert missed == []
    assert faulted > 100


def test_multiline_spacing_is_pillows():
    """``"\\n"`` starts a line ``getbbox("A")[3]`` + 4 pixels lower, empty
    lines included."""
    font = ImageFont.load_default()
    assert int(text.glyph_table()["line_spacing"]) == font.getbbox("A")[3] + 4
    img = np.zeros((60, 50, 3), np.uint8)
    for s in ("a\nb", "\n\nx", "gy\n\nAj\n", "\n"):
        np.testing.assert_array_equal(text.draw_text(img, (1, 0), s, (9, 250, 99)),
                                      pillow_text(img, (1, 0), s, (9, 250, 99)))


def test_the_glyph_table_is_the_generators_output():
    """The committed ``text_glyphs.npz`` holds what a fresh run of
    ``make_glyphs.py`` computes from Pillow, array for array."""
    spec = importlib.util.spec_from_file_location(
        "make_glyphs", REPO / "tests" / "data" / "font" / "make_glyphs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.table()
    with np.load(text.GLYPHS, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    assert text.GLYPHS.stat().st_size < 64 << 10


@pytest.mark.parametrize("bad", [
    (np.zeros((4, 4), np.uint8), (0, 0), (1, 2, 3)),
    (np.zeros((4, 4, 3), np.float32), (0, 0), (1, 2, 3)),
    (np.zeros((4, 4, 3), np.uint8), (0.5, 0), (1, 2, 3)),
    (np.zeros((4, 4, 3), np.uint8), (0, 0), (7,))])
def test_draw_text_refuses_what_it_cannot_draw_as_pillow(bad):
    """A grey or float array, a fractional point (Pillow draws it at a
    sub-pixel start) or a fill that is not RGB raise."""
    img, xy, fill = bad
    with pytest.raises((ValueError, TypeError)):
        text.draw_text(img, xy, "ab", fill)
