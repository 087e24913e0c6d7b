"""The port's image codec (``cpt_tpu_torch/utils/image_codec``, host C++
in ``csrc/image_codec.cpp``; its WEBP decoders and its TIFF reader have
files of their own, ``test_torch_webp.py`` and ``test_torch_tiff.py``)
against Pillow 12.1.0 (libjpeg-turbo 3.1.3),
the version its rules were recovered against: decoded pixels equal on the
committed fixtures and on seeded JPEG (CMYK and YCCK among them), PNG (16
bits among them), GIF and BMP cases, encoded JPEG and BMP bytes equal, PNG
round trips; the named errors; ``chip_smoke``'s CODEC_DIGESTS and
CODEC_FAULTS; and the call sites routed through the codec against the JAX
package's Pillow calls on the same files. The seeded GIF, BMP, YCCK and
16-bit PNG files come from the fixture script's writers
(``tests/data/codec/make_fixtures.py``)."""
from __future__ import annotations

import base64
import functools
import hashlib
import importlib.util
import io
import json
import struct
import tempfile
import threading
import warnings
import zlib
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import PIL
import pytest
from PIL import Image, features

import chip_smoke as cs
import test_torch_serve as ts
from cpt_tpu.data import coco_json as jcoco
from cpt_tpu.data import vg_tsv as jvg_tsv
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu.tools import demo as jdemo
from cpt_tpu.tools import extract_features as jextract
from cpt_tpu.tools import img_info as jimg_info
from cpt_tpu.tools import serve as jserve
from cpt_tpu.tools import validate_checkpoints as jvalidate
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.data import coco_json, vg_tsv
from cpt_tpu_torch.kernels import build
from cpt_tpu_torch.tools import extract_features, img_info, validate_checkpoints
from cpt_tpu_torch.utils import image_codec as ic
from cpt_tpu_torch.utils import text
from test_torch_watchdog import guards

guard_module, guard_case = guards(180)


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", cs.CODEC_DIR / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mf = _fixture_script()

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def test_pillow_is_the_version_the_codec_follows():
    """The codec reproduces Pillow 12.1.0 on libjpeg-turbo 3.1.3; another
    Pillow may decode or encode otherwise, and this file says so first."""
    assert PIL.__version__ == "12.1.0"
    assert features.version("libjpeg_turbo") == "3.1.3"


def pillow_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def pillow_decode(data: bytes, mode: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


def seeded_image(rng, h: int, w: int, channels: int) -> np.ndarray:
    """Noise, or a photo-like image, as the case's draw says."""
    if rng.rand() < 0.3:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    else:
        img = cs.codec_photo(int(rng.randint(1 << 30)), h, w)
    return img if channels == 3 else np.ascontiguousarray(img[:, :, 1])


def jpeg_cases(chunk: int, n: int = 24):
    """Seeded (array, save options) pairs: sizes 1-300 (odd ones included),
    quality 1-100, subsampling 0 / 1 / 2, progressive, optimize, restart
    markers, grayscale and Adobe RGB."""
    rng = np.random.RandomState(1000 + chunk)
    for i in range(n):
        big = i % 6 == 0
        h, w = rng.randint(1, 301 if big else 70, 2)
        channels = 1 if rng.rand() < 0.2 else 3
        kw = {"quality": int(rng.randint(1, 101))}
        kind = i % 6
        if channels == 3 and kind != 5:
            kw["subsampling"] = int(rng.randint(0, 3))
        if kind == 1:
            kw["progressive"] = True
        elif kind == 2:
            kw["optimize"] = True
        elif kind == 3:
            kw["restart_marker_blocks"] = int(rng.randint(1, 6))
        elif kind == 5 and channels == 3:
            kw["keep_rgb"] = True
        yield seeded_image(rng, int(h), int(w), channels), kw


@pytest.mark.parametrize("chunk", range(8))
def test_jpeg_decode_is_pillows(chunk):
    """``decode`` equals ``Image.open(f).convert(mode)`` pixel for pixel in
    RGB and L, on 24 seeded files a chunk (one in six up to 300 pixels a
    side)."""
    for img, kw in jpeg_cases(chunk):
        data = pillow_jpeg(img, **kw)
        for mode in ("RGB", "L"):
            want = pillow_decode(data, mode)
            got = ic.decode(data, mode)
            assert got.shape == want.shape, (img.shape, kw, mode)
            np.testing.assert_array_equal(got, want, err_msg=f"{img.shape} {kw} {mode}")


@pytest.mark.parametrize("chunk", range(4))
def test_jpeg_encode_is_pillows(chunk):
    """``encode_jpeg(arr, q)`` gives ``Image.fromarray(arr).save(f, "JPEG",
    quality=q)``'s bytes, RGB and L, quality 1-100, sizes 1-300."""
    rng = np.random.RandomState(2000 + chunk)
    for i in range(20):
        h, w = rng.randint(1, 301 if i % 5 == 0 else 60, 2)
        img = seeded_image(rng, int(h), int(w), 1 if i % 3 == 0 else 3)
        q = int(rng.randint(1, 101))
        assert ic.encode_jpeg(img, q) == pillow_jpeg(img, quality=q), (img.shape, q)
    img = seeded_image(rng, 40, 50, 3)
    assert ic.encode_jpeg(img) == pillow_jpeg(img)          # Pillow's default


def png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))


def paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def filtered_rows(rows: np.ndarray, bpp: int, rng) -> bytes:
    """PNG rows, each under a random one of the five filters."""
    out, prev = bytearray(), np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        f = int(rng.randint(0, 5))
        out.append(f)
        for i, x in enumerate(row):
            a = int(row[i - bpp]) if i >= bpp else 0
            c = int(prev[i - bpp]) if i >= bpp else 0
            b = int(prev[i])
            pred = (0, a, b, (a + b) // 2, paeth(a, b, c))[f]
            out.append((int(x) - pred) & 255)
        prev = row
    return bytes(out)


def packed(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, n] samples of ``depth`` bits → [h, ceil(n·depth/8)] bytes."""
    if depth == 8:
        return samples.astype(np.uint8)
    if depth == 16:
        return samples.astype(">u2").view(np.uint8)
    h, n = samples.shape
    per = 8 // depth
    s = np.concatenate([samples, np.zeros((h, (-n) % per), samples.dtype)], 1)
    shifts = np.arange(per - 1, -1, -1) * depth
    return (s.reshape(h, -1, per).astype(np.uint16) << shifts).sum(2).astype(
        np.uint8)


def make_png(samples: np.ndarray, color: int, depth: int, interlace: int,
             rng, palette=None) -> bytes:
    """A PNG of [h, w, channels] samples built here with zlib (Adam7 when
    ``interlace``), each row under a random filter."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = b""
    samples = np.ascontiguousarray(samples)
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += filtered_rows(packed(sub.reshape(sub.shape[0], -1), depth),
                                 bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += png_chunk(b"PLTE", palette.tobytes())
    return out + png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b"")


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (6, 8), (0, 16), (2, 16), (4, 16), (6, 16)]


@pytest.mark.parametrize("color,depth", PNG_KINDS)
@pytest.mark.parametrize("interlace", [0, 1])
def test_png_decode_is_pillows(color, depth, interlace):
    """Every colour type and bit depth the codec reads, plain and Adam7
    (bytes built here with zlib, rows under random filters; palettes
    shorter than the bit depth allows, so that some indices fall past
    them; 16-bit samples, grey ones also under 256; 1×1 images):
    ``decode`` equals Pillow's ``convert("RGB")`` and ``convert("L")``,
    and ``image_size`` Pillow's size."""
    rng = np.random.RandomState(3000 + 10 * color + depth + 100 * interlace)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for i in range(4):
        h, w = (int(v) for v in rng.randint(1, 40, 2)) if i else (1, 1)
        samples = rng.randint(0, 2 ** depth, (h, w, channels))
        if depth == 16 and i % 2:        # grey 16-bit values under 256 too
            samples >>= int(rng.randint(0, 9))
        palette = (rng.randint(0, 256, (int(rng.randint(1, 2 ** depth + 1)), 3))
                   .astype(np.uint8) if color == 3 else None)
        data = make_png(samples, color, depth, interlace, rng, palette)
        for mode in ("RGB", "L"):
            np.testing.assert_array_equal(ic.decode(data, mode),
                                          pillow_decode(data, mode))
        assert ic.image_size(data) == (w, h)


@pytest.mark.parametrize("mode,bits", [("L", None), ("LA", None),
                                       ("RGB", None), ("RGBA", None),
                                       ("1", None), ("P", 1), ("P", 2),
                                       ("P", 4), ("P", 8)])
def test_png_written_by_pillow(mode, bits):
    """PNGs as Pillow writes them (its adaptive filters and zlib)."""
    rgba = np.random.RandomState(41).randint(0, 256, (37, 53, 4)).astype(np.uint8)
    im = Image.fromarray(rgba, "RGBA").convert(mode)
    if mode == "P":
        im = Image.fromarray(cs.codec_photo(42, 37, 53)).quantize(2 ** bits)
    buf = io.BytesIO()
    im.save(buf, format="PNG", **({"bits": bits} if bits else {}))
    for out in ("RGB", "L"):
        np.testing.assert_array_equal(ic.decode(buf.getvalue(), out),
                                      pillow_decode(buf.getvalue(), out))


@pytest.mark.parametrize("shape", [(1, 1), (17, 23), (17, 23, 3), (5, 9, 3),
                                   (64, 1, 3)])
def test_png_round_trip(shape):
    """``encode_png`` is lossless: Pillow and ``decode`` read it back equal."""
    arr = np.random.RandomState(43).randint(0, 256, shape).astype(np.uint8)
    data = ic.encode_png(arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), arr)
    np.testing.assert_array_equal(
        ic.decode(data, "L" if arr.ndim == 2 else "RGB"), arr)


# --- CMYK / YCCK JPEG, GIF, BMP ---------------------------------------------------

def cmyk_cases(chunk: int, n: int = 10):
    """Seeded CMYK JPEGs as Pillow writes them (subsampling 0-2,
    progressive, quality 1-100) and YCCK ones from the fixture script's
    encoder (sampling 1x1, Y and K 2x2, all 2x2), sizes 1-120 (odd ones
    and 1×1 included)."""
    rng = np.random.RandomState(5000 + chunk)
    for i in range(n):
        h, w = ((1, 1) if i == 0 else
                tuple(int(v) for v in rng.randint(1, 121 if i % 4 == 1 else 40, 2)))
        img = seeded_image(rng, h, w, 3)
        if i % 2:
            buf = io.BytesIO()
            kw = {"quality": int(rng.randint(1, 101)),
                  "subsampling": int(rng.randint(0, 3))}
            if rng.rand() < 0.4:
                kw["progressive"] = True
            Image.fromarray(img).convert("CMYK").save(buf, format="JPEG", **kw)
            yield buf.getvalue()
        else:
            k = seeded_image(rng, h, w, 1)
            sampling = [(1, 1, 1, 1), (2, 1, 1, 2), (2, 1, 1, 1)][i // 2 % 3]
            yield mf.ycck_jpeg(mf.ycck_planes(img, k),
                               int(rng.randint(5, 101)), sampling)


@pytest.mark.parametrize("chunk", range(4))
def test_cmyk_and_ycck_jpeg_decode_is_pillows(chunk):
    """4-component JPEGs: ``decode`` equals Pillow's ``convert("RGB")`` and
    ``convert("L")`` (its "CMYK;I" unpacking, then cmyk2rgb), and
    ``image_size`` its size."""
    for data in cmyk_cases(chunk):
        for mode in ("RGB", "L"):
            np.testing.assert_array_equal(ic.decode(data, mode),
                                          pillow_decode(data, mode))
        assert ic.image_size(data) == Image.open(io.BytesIO(data)).size


def gif_cases(chunk: int, n: int = 12):
    """Seeded GIFs: Pillow's writer (P and L, interlaced or not) and the
    fixture script's (global and / or local palettes of 2-256 entries,
    some shorter than the code size reaches; grey-identity palettes, read
    as mode L; no palette; LZW code sizes 2-8, a clear every few codes or
    a full table left without one; interlace; a transparent index; a
    frame off the screen's origin, or past its edge; more frames after
    the first), sizes 1-200 and 1×1."""
    rng = np.random.RandomState(6000 + chunk)
    for i in range(n):
        h, w = ((1, 1) if i == 0 else
                tuple(int(v) for v in rng.randint(1, 201 if i % 5 == 1 else 45, 2)))
        if i % 3 == 2:
            img = seeded_image(rng, h, w, 3)
            im = Image.fromarray(img)
            im = (im.convert("L") if rng.rand() < 0.5
                  else im.quantize(int(rng.randint(2, 257))))
            buf = io.BytesIO()
            im.save(buf, format="GIF", interlace=int(rng.randint(0, 2)),
                    optimize=bool(rng.rand() < 0.5))
            yield buf.getvalue()
            continue
        min_bits = int(rng.randint(2, 9))
        frame = rng.randint(0, 1 << min_bits, (h, w)).astype(np.uint8)
        if rng.rand() < 0.5:                      # long runs: the table fills
            frame = np.repeat(frame[:, :-(-w // 8)], 8, 1)[:, :w].copy()

        def palette():
            size = 1 << int(rng.randint(1, 9))
            if rng.rand() < 0.15:
                return np.repeat(np.arange(size, dtype=np.uint8)[:, None], 3, 1)
            return rng.randint(0, 256, (size, 3)).astype(np.uint8)

        kw = {"min_bits": min_bits, "interlace": bool(rng.rand() < 0.5),
              "global_pal": palette() if rng.rand() < 0.7 else None,
              "local_pal": palette() if rng.rand() < 0.4 else None,
              "transparency": (int(rng.randint(0, 1 << min_bits))
                               if rng.rand() < 0.4 else None),
              "frames_after": int(rng.randint(0, 2)),
              "clear_when_full": bool(rng.rand() < 0.5),
              "clear_every": int(rng.choice([0, 0, 7, 300]))}
        if rng.rand() < 0.4:
            kw["offset"] = tuple(int(v) for v in rng.randint(0, 6, 2))
            kw["screen"] = tuple(int(v) for v in rng.randint(1, 60, 2))
        yield mf.gif_file(frame, **kw)


@pytest.mark.parametrize("chunk", range(6))
def test_gif_decode_is_pillows(chunk):
    """GIF's first frame: ``decode`` equals Pillow's ``convert("RGB")`` and
    ``convert("L")``, and ``image_size`` its (grown) size."""
    for data in gif_cases(chunk):
        for mode in ("RGB", "L"):
            np.testing.assert_array_equal(ic.decode(data, mode),
                                          pillow_decode(data, mode))
        assert ic.image_size(data) == Image.open(io.BytesIO(data)).size


BMP_KINDS = {
    # name: bmp_file keywords (pixels drawn per kind)
    "1": {"bits": 1}, "4": {"bits": 4}, "8": {"bits": 8},
    "4_core": {"bits": 4, "header": 12}, "8_v5": {"bits": 8, "header": 124},
    "16_555": {"bits": 16}, "24": {"bits": 24}, "32": {"bits": 32},
    "24_top_down": {"bits": 24, "top_down": True},
    "8_top_down_v4": {"bits": 8, "top_down": True, "header": 108},
    "565_info": {"bits": 16, "compression": 3, "masks": (0xF800, 0x7E0, 0x1F)},
    "555_v4": {"bits": 16, "compression": 3, "header": 108,
               "masks": (0x7C00, 0x3E0, 0x1F)},
    "565_v5": {"bits": 16, "compression": 3, "header": 124,
               "masks": (0xF800, 0x7E0, 0x1F)},
    "32_xbgr": {"bits": 32, "compression": 3, "masks": (0xFF000000, 0xFF0000, 0xFF00)},
    "32_rgba_v5": {"bits": 32, "compression": 3, "header": 124,
                   "masks": (0xFF, 0xFF00, 0xFF0000, 0xFF000000)},
    "32_bgar_v5": {"bits": 32, "compression": 3, "header": 124,
                   "masks": (0xFF000000, 0xFF00, 0xFF, 0xFF0000)},
    "rle8": {"bits": 8, "compression": 1},
    "rle4": {"bits": 4, "compression": 2},
    "rle8_top_down": {"bits": 8, "compression": 1, "top_down": True},
}


@pytest.mark.parametrize("kind", sorted(BMP_KINDS))
def test_bmp_decode_is_pillows(kind):
    """Every BMP kind the codec reads (headers, depths, bit fields, RLE,
    either row order), at widths that pad the rows to 4 bytes in every way
    and 1×1, with palettes shorter than the depth allows (so that some
    indices fall past them) and grey ones (read as mode L, or 1):
    ``decode`` equals Pillow's ``convert("RGB")`` and ``convert("L")``, and
    ``image_size`` its size."""
    kw = dict(BMP_KINDS[kind])
    bits = kw.pop("bits")
    rng = np.random.RandomState(7000 + sorted(BMP_KINDS).index(kind))
    for i in range(8):
        h, w = (1, 1) if i == 0 else (int(rng.randint(1, 30)), 1 + i + 4 * int(rng.randint(0, 8)))
        palette = None
        if bits <= 8:
            top = 1 << bits
            if i == 1 and bits != 4:              # grey: mode L, or 1
                palette = np.repeat((np.arange(top) * (255 // (top - 1)))[:, None],
                                    3, 1)
            else:
                palette = rng.randint(0, 256, (int(rng.randint(2, top + 1)), 3))
            px = rng.randint(0, top, (h, w)).astype(np.uint8)
            if kw.get("compression") in (1, 2) and rng.rand() < 0.6:
                px = np.repeat(px[:, :-(-w // 5)], 5, 1)[:, :w].copy()
        else:
            px = seeded_image(rng, h, w, 3)
        if kw.get("compression") in (1, 2) and i == 1:
            continue                              # Pillow refuses RLE in mode 1
        data = mf.bmp_file(px, bits, palette, **kw)
        for mode in ("RGB", "L"):
            np.testing.assert_array_equal(ic.decode(data, mode),
                                          pillow_decode(data, mode))
        assert ic.image_size(data) == (w, h)


def rle_bmp(body: bytes, w: int, h: int, rle4: bool) -> bytes:
    """A BMP of hand-made RLE data (palette of 16 or 256 seeded entries)."""
    n = 16 if rle4 else 256
    pal = np.random.RandomState(71).randint(0, 256, (n, 3)).astype(np.uint8)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 4 if rle4 else 8,
                       2 if rle4 else 1, len(body), 0, 0, n, 0)
    pal = np.concatenate([pal[:, ::-1], np.zeros((n, 1), np.uint8)], 1).tobytes()
    offset = 14 + 40 + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + info + pal + body)


RLE_QUIRKS = {
    # Pillow's BmpRleDecoder: a delta reads two bytes, then its offsets
    "delta": (b"\x03\x07\x00\x02\x09\x09\x02\x01\x04\x05\x00\x00" * 4
              + b"\x00\x01", 9, 6, False),
    # an encoded run past the row is cut at its end
    "long_run": (b"\x20\x11\x02\x22\x00\x00\x05\x33\x00\x00" * 3 + b"\x00\x01",
                 7, 5, False),
    # an absolute run past the row is not; odd runs align to the file
    "absolute": (b"\x00\x05\x01\x02\x03\x04\x05\x00\x00\x03\x07\x08\x09\x00"
                 b"\x02\x06" * 6 + b"\x00\x01", 6, 6, False),
    # an RLE4 absolute run of odd count reads count // 2 bytes
    "rle4_odd_absolute": (b"\x00\x05\x12\x34\x56\x00\x04\x78\x00\x00" * 4
                          + b"\x00\x01", 8, 4, True),
    # the image full without an end of line or of bitmap; what follows is
    # not read
    "full_without_end": (b"\x08\x05\x00\x00" * 3 + b"\x08\x07\xff\x01",
                         8, 4, False),
}


@pytest.mark.parametrize("case", sorted(RLE_QUIRKS))
def test_bmp_rle_follows_pillows_decoder(case):
    """Hand-made RLE streams that take the odd paths of Pillow's
    BmpRleDecoder: ``decode`` gives its pixels."""
    data = rle_bmp(*RLE_QUIRKS[case])
    for mode in ("RGB", "L"):
        np.testing.assert_array_equal(ic.decode(data, mode),
                                      pillow_decode(data, mode))


@pytest.mark.parametrize("shape", [(1, 1), (1, 1, 3), (5, 1), (7, 2, 3),
                                   (9, 3), (4, 5, 3), (13, 17), (20, 31, 3)])
def test_bmp_encode_is_pillows(shape, tmp_path):
    """``encode_bmp`` (and ``write_image(".bmp")``) give the bytes of
    Pillow's ``save(format="BMP")`` for L and RGB, every row padding; the
    codec reads them back."""
    arr = np.random.RandomState(72).randint(0, 256, shape).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="BMP")
    assert ic.encode_bmp(arr) == buf.getvalue()
    ic.write_image(tmp_path / "x.bmp", arr)
    assert (tmp_path / "x.bmp").read_bytes() == buf.getvalue()
    np.testing.assert_array_equal(
        ic.decode(buf.getvalue(), "L" if arr.ndim == 2 else "RGB"), arr)


@pytest.mark.parametrize("name", ["cmyk", "sixteen_bit_png", "gif"])
def test_formerly_refused_kinds_decode_is_pillows(name):
    """The kinds the codec once refused (a CMYK JPEG, a 16-bit PNG, a
    GIF) decode as Pillow reads them."""
    data = {"cmyk": cmyk_jpeg, "sixteen_bit_png": sixteen_bit_png,
            "gif": small_gif}[name]()
    for mode in ("RGB", "L"):
        np.testing.assert_array_equal(ic.decode(data, mode),
                                      pillow_decode(data, mode))


def cmyk_jpeg() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(cs.codec_photo(44, 24, 32)).convert("CMYK").save(
        buf, format="JPEG")
    return buf.getvalue()


def hierarchical_header() -> bytes:
    data = bytearray(pillow_jpeg(cs.codec_photo(45, 24, 32)))
    i = data.find(b"\xff\xc0")
    data[i + 1] = 0xC5                       # SOF0 → SOF5, hierarchical
    return bytes(data)


def twelve_bit_header() -> bytes:
    data = bytearray(pillow_jpeg(cs.codec_photo(45, 24, 32)))
    i = data.find(b"\xff\xc0")
    data[i + 4] = 12                         # a 12-bit frame
    return bytes(data)


def arithmetic_lossless() -> bytes:
    """A lossless file relabelled SOF11, arithmetic lossless: libjpeg-turbo
    implements no arithmetic lossless decoding (nor encoding)."""
    data = bytearray(mf.libjpeg_write(cs.codec_photo(45, 24, 32), lossless=(1, 0)))
    i = data.find(b"\xff\xc3")
    data[i + 1] = 0xCB
    return bytes(data)


def sixteen_bit_png() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999).save(
        buf, format="PNG")
    return buf.getvalue()


def small_gif() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(cs.codec_photo(54, 24, 32)).quantize(32).save(
        buf, format="GIF")
    return buf.getvalue()


def mcu_too_large() -> bytes:
    """A YCCK file whose four components are all sampled 2x2: 16 blocks an
    MCU, past libjpeg's 10."""
    img = cs.codec_photo(57, 24, 32)
    return mf.ycck_jpeg(mf.ycck_planes(img, img[..., 0]), 75, (2, 2, 2, 2))


def tiff_header() -> bytes:
    """A TIFF header whose first directory holds no entry (a broken TIFF
    file to Pillow and the codec alike)."""
    return b"II*\x00" + struct.pack("<I", 8) + bytes(32)


ERROR_CASES = {
    "truncated_jpeg_half": (lambda: (lambda d: d[:len(d) // 2])(
        pillow_jpeg(cs.codec_photo(46, 64, 80))), "truncated"),
    "truncated_jpeg_no_eoi": (lambda: pillow_jpeg(
        cs.codec_photo(47, 64, 80), progressive=True)[:-2], "truncated"),
    "truncated_png": (lambda: ic.encode_png(cs.codec_photo(48, 30, 30))[:-30],
                      "truncated"),
    "truncated_gif": (lambda: small_gif()[:len(small_gif()) // 2],
                      "truncated"),
    "truncated_bmp": (lambda: ic.encode_bmp(cs.codec_photo(56, 20, 30))[:-200],
                      "truncated"),
    "hierarchical": (hierarchical_header, "hierarchical"),
    "twelve_bit": (twelve_bit_header, "12-bit"),
    "lossless_arithmetic": (arithmetic_lossless, "arithmetic-coded lossless"),
    "mcu_too_large": (mcu_too_large, "too large"),
    # a WEBP whose VP8 chunk is empty (size 0): broken, as Pillow finds it
    "webp": (lambda: b"RIFF" + struct.pack("<I", 30) + b"WEBPVP8 " + bytes(22),
             "WEBP"),
    "tiff": (tiff_header, "TIFF"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_unsupported_and_truncated_files_raise(case):
    """A truncated file (JPEG, PNG, GIF, BMP), a hierarchical, 12-bit or
    arithmetic-coded lossless JPEG, an MCU past 10 blocks, a broken WEBP and
    a TIFF whose first directory holds no entry raise ``ImageCodecError``
    naming the problem; no partial image comes back. Pillow raises on each
    of them too. (The arithmetic and lossless frames relabelled from a
    baseline file are in test_torch_jpeg.py, which holds them to Pillow.)"""
    make, word = ERROR_CASES[case]
    data = make()
    with pytest.raises(ic.ImageCodecError, match=word):
        ic.decode(data)
    with pytest.raises(OSError):
        pillow_decode(data, "RGB")


def strip_dht(data: bytes) -> bytes:
    """A JPEG with its DHT segments removed (a motion-JPEG frame's form)."""
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        if data[i + 1] != 0xC4:
            out += data[i:i + 2 + n]
        i += 2 + n
    return bytes(out + data[i:])


@pytest.mark.parametrize("kind", ["rgb", "gray", "restart"])
def test_jpeg_without_huffman_tables_takes_the_standard_ones(kind):
    """A scan whose Huffman tables 0 and 1 are undefined decodes with the
    standard tables, as libjpeg-turbo's jpeg_std_huff_table gives Pillow
    (the tables Pillow's baseline writer uses unless it optimizes them)."""
    img = cs.codec_photo(58, 40, 56)
    data = strip_dht(pillow_jpeg(img[..., 0] if kind == "gray" else img,
                                 **({"restart_marker_blocks": 2}
                                    if kind == "restart" else {})))
    assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
    for mode in ("RGB", "L"):
        np.testing.assert_array_equal(ic.decode(data, mode),
                                      pillow_decode(data, mode))


def bomb_jpeg() -> bytes:
    """A small JPEG whose frame header declares 65535 × 65535 with 4 × 4
    luma sampling: some hundred bytes that would ask for ~26 GB of
    coefficients."""
    data = bytearray(pillow_jpeg(cs.codec_photo(49, 16, 16)))
    i = data.find(b"\xff\xc0")
    data[i + 5:i + 9] = struct.pack(">HH", 65535, 65535)
    data[i + 11] = 0x44
    return bytes(data)


def bomb_png() -> bytes:
    """A PNG whose IHDR declares 65535 × 65535 (checksums right)."""
    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))

    return (ic.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 65535, 65535, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(64)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("make", [bomb_jpeg, bomb_png])
def test_decompression_bombs_raise(make):
    """A declared size over twice Pillow's MAX_IMAGE_PIXELS raises before
    anything is allocated for it, in ``decode`` and ``image_size``, as
    Pillow's ``Image.open`` raises ``DecompressionBombError``."""
    data = make()
    assert len(data) < 1024
    assert ic.MAX_IMAGE_PIXELS == Image.MAX_IMAGE_PIXELS
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    for fn in (ic.decode, ic.image_size):
        with pytest.raises(ic.ImageCodecError, match="decompression bomb"):
            fn(data)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails, or none at all, raises ``KernelError``; the
    codec never falls back to Pillow or Python."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    for cxx in ("false", str(tmp_path / "no-such-compiler")):
        monkeypatch.setenv("CXX", cxx)
        lib = build.Library(build.build_host, {})
        with pytest.raises(build.KernelError):
            lib.get()
    assert not list(tmp_path.glob("*.so"))


# --- chip_smoke.py's digests and faults ----------------------------------------

def test_fixtures_are_the_scripts_output():
    """The committed fixtures are ``tests/data/codec/make_fixtures.py``'s
    output, byte for byte, and stay under 1 MB."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_fixtures", cs.CODEC_DIR / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    files = mod.fixtures()
    assert sorted(files) == [p.name for p in cs.codec_fixture_files()]
    for name, data in files.items():
        assert (cs.CODEC_DIR / name).read_bytes() == data, name
    assert sum(len(d) for d in files.values()) < 1 << 20


def digest(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


@functools.lru_cache(maxsize=None)
def pillow_digests() -> dict:
    """CODEC_DIGESTS' keys as Pillow and the JAX package's tools give them."""
    out = {}
    for path in cs.codec_fixture_files():
        for mode in ("RGB", "L"):
            out[f"{path.name}:{mode}"] = digest(pillow_decode(path.read_bytes(),
                                                              mode))
    for name, (arr, q) in cs.codec_encode_inputs().items():
        out[f"encode:{name}"] = digest(pillow_jpeg(arr, quality=q))
    for name, arr in cs.codec_tiff_encode_inputs().items():
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="TIFF")
        out[f"encode_tiff:{name}"] = digest(buf.getvalue())
    for name in cs.RESIZED_REQUESTS:
        out[f"upload:{name}"] = digest(pillow_decode(pillow_jpeg(
            cs.resized_request(name)[0], quality=95), "RGB"))
    with tempfile.TemporaryDirectory() as root:
        jvalidate.make_synthetic_fixture(root, cs.VALIDATE_FIXTURE["n_images"],
                                         cs.VALIDATE_FIXTURE["canvas"])
        out["validate:fixture"] = digest(b"".join(
            p.read_bytes() for p in sorted(Path(root, "images").glob("*.jpg"))))
        jimg_info.create_all_color_imgs(f"{root}/colors", cs.COLOR_STEP)
        out["img_info:colors"] = digest(b"".join(
            p.read_bytes() for p in sorted(Path(root, "colors").glob("*.jpg"))))
    img, boxes, labels, scores, names = cs.caption_case()
    out["caption:overlay"] = digest(jdemo.overlay_detections(
        img.copy(), boxes, labels, scores, names))
    for seed, name in enumerate(cs.JPEG_DAMAGE_SOURCES):
        data = (cs.CODEC_DIR / name).read_bytes()
        out[f"damaged:{name}"] = cs.damage_digest(
            pillow_or_none(d) for d in cs.jpeg_damaged(data, seed))
    return out


def pillow_or_none(data: bytes):
    """Pillow's RGB decode, or None where it raises (a damaged file)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return pillow_decode(data, "RGB")
        except Exception:      # noqa: BLE001 - any raise is a refusal
            return None


def test_codec_digests_are_pillows():
    """Each of CODEC_DIGESTS is Pillow's (pixels, JPEG bytes, or the JAX
    demo's caption drawing), and the codec and ``utils/text`` reproduce the
    decodes, encodes and captions here."""
    assert pillow_digests() == cs.CODEC_DIGESTS
    got, _ = cs.codec_digests()
    assert got == {k: v for k, v in cs.CODEC_DIGESTS.items() if k in got}
    assert len(got) == len(cs.CODEC_DIGESTS) - 4
    for name in cs.RESIZED_REQUESTS:         # phase 8's uploads
        _, decoded = cs.jpeg_upload(cs.resized_request(name)[0])
        assert digest(decoded) == cs.CODEC_DIGESTS[f"upload:{name}"]


@pytest.mark.parametrize("fault", cs.CODEC_FAULTS)
def test_named_faults_change_a_digest(fault):
    """Each of CODEC_FAULTS (the codec's and the captions') changes at
    least one digest."""
    assert set(cs.CODEC_FAULTS) == set(ic.FAULTS) | set(text.FAULTS)
    changed, _ = cs.codec_digests(fault)
    assert [k for k in changed if changed[k] != cs.CODEC_DIGESTS[k]]


def test_check_codec_digests_passes_here():
    r = cs.check_codec_digests()
    assert all(r["matched"].values()) and all(r["faults"].values())


def test_phase21_dry_run():
    """``chip_smoke.run_image_files`` at the tiny size on the CPU: every
    reading is taken (the digests, the tools, ``demo --detect`` on the YCCK
    fixture with its PNG equal to ``overlay_detections`` of its
    detections) and only the kernel-launch checks fail (no card)."""
    import ast

    with pytest.raises(AssertionError) as e:
        cs.run_image_files(cs.kernel_counters(), "cpu", tiny=True)
    failures = ast.literal_eval(e.value.args[0][len("phase 21: "):])
    assert failures and all("launches" in f for f in failures), failures
    demo_failure = [f for f in failures if f.startswith("demo --detect")]
    assert len(demo_failure) == 1
    reading = ast.literal_eval(demo_failure[0][len("demo --detect: "):])
    assert (reading["decode_equal"] and reading["out_equal"]
            and reading["detections"] > 0)


# --- the routed call sites against the JAX package's ---------------------------

@pytest.mark.parametrize("name", [p.name for p in cs.codec_fixture_files()])
def test_fixture_decode_is_pillows(name):
    """Every committed fixture: ``decode`` equals Pillow's ``convert("RGB")``
    and ``convert("L")``, ``read_image`` the same from the path, and
    ``image_size`` Pillow's size."""
    path = cs.CODEC_DIR / name
    data = path.read_bytes()
    for mode in ("RGB", "L"):
        want = pillow_decode(data, mode)
        np.testing.assert_array_equal(ic.decode(data, mode), want)
        np.testing.assert_array_equal(ic.read_image(path, mode), want)
    assert ic.image_size(path) == Image.open(path).size


@pytest.mark.parametrize("name", ["baseline_420_q95_480x640.jpg",
                                  "progressive_q75.jpg", "p4.png",
                                  "adam7_rgb.png", "ycck_q75.jpg",
                                  "cmyk_progressive_q75.jpg", "rgba64_adam7.png",
                                  "i16.png", "short_palette.gif", "l.gif",
                                  "rle4.bmp", "top_down.bmp"])
def test_load_image_matches_jax(name):
    """``extract_features.load_image`` (with the 600/1000 resize rule and
    without) equals the JAX tool's on the same file."""
    path = str(cs.CODEC_DIR / name)
    for rule in ((None, None), (600, 1000)):
        got, hw = extract_features.load_image(path, 640, 1024, *rule)
        want, jhw = jextract.load_image(path, 640, 1024, *rule)
        assert tuple(hw) == tuple(jhw)
        np.testing.assert_array_equal(got, want)


def test_vg_tsv_decode_matches_jax():
    """``vg_tsv.img_from_base64`` equals the JAX reader's on base64 JPEG,
    PNG, GIF and BMP bytes."""
    for name in ("baseline_422_q75.jpg", "gray_q75.jpg", "rgba.png", "p1.png",
                 "cmyk_q75.jpg", "la16.png", "p_interlaced.gif", "rgba.bmp"):
        b64 = base64.b64encode((cs.CODEC_DIR / name).read_bytes()).decode()
        np.testing.assert_array_equal(vg_tsv.img_from_base64(b64),
                                      jvg_tsv.img_from_base64(b64))


def tree_bytes(root: str) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def test_write_detection_tsv_matches_jax(tmp_path):
    """``write_detection_tsv`` writes the JAX writer's files byte for byte
    (its images JPEG at quality 95, Pillow's bytes)."""
    rng = np.random.RandomState(49)
    images = {"a": cs.codec_photo(50, 61, 77), "b": rng.randint(
        0, 256, (40, 33, 3)).astype(np.uint8), "c": cs.codec_photo(51, 20, 30)[:, :, 0]}
    labels = {k: {"objects": [{"rect": [1.0, 2.0, 10.0, 12.0], "class": "cat"}]}
              for k in images}
    labelmap = {"label_to_idx": {"cat": 1}}
    vg_tsv.write_detection_tsv(str(tmp_path / "port"), "t", images, labels,
                               labelmap)
    jvg_tsv.write_detection_tsv(str(tmp_path / "jax"), "t", images, labels,
                                labelmap)
    port, jax_ = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "jax")
    assert port.keys() == jax_.keys() and len(port) >= 5
    for k in port:
        want = jax_[k].replace(str(tmp_path / "jax").encode(),
                               str(tmp_path / "port").encode())
        assert port[k] == want, k


def test_coco_to_tsv_matches_jax(tmp_path):
    """``convert_dataset coco``'s converter over a directory of JPEGs writes
    the JAX converter's files byte for byte."""
    ann, img_dir = cs.coco_fixture(str(tmp_path / "coco"))
    coco_json.coco_to_tsv(ann, img_dir, str(tmp_path / "port"))
    jcoco.coco_to_tsv(ann, img_dir, str(tmp_path / "jax"))
    port, jax_ = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "jax")
    assert port.keys() == jax_.keys() and len(port) >= 5
    for k in port:
        want = jax_[k].replace(str(tmp_path / "jax").encode(),
                               str(tmp_path / "port").encode())
        assert port[k] == want, k


def test_img_info_matches_jax(tmp_path):
    """``img_info``'s size scan over .jpg, .jpeg and .png files and its
    colour probes equal the JAX tool's (sizes; the probes' bytes)."""
    d = tmp_path / "images"
    d.mkdir()
    for name, (h, w) in cs.INFO_SIZES.items():
        Image.fromarray(cs.codec_photo(52, h, w)).save(d / name)
    got = img_info.create_img_info(str(d), str(tmp_path / "port.json"))
    want = jimg_info.create_img_info(str(d), str(tmp_path / "jax.json"))
    assert got == want == {n: {"width": w, "height": h}
                           for n, (h, w) in cs.INFO_SIZES.items()}
    img_info.create_all_color_imgs(str(tmp_path / "port"), 128, size=24)
    jimg_info.create_all_color_imgs(str(tmp_path / "jax"), 128, size=24)
    port, jax_ = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "jax")
    assert port.keys() == jax_.keys() and len(port) == 9
    for k in port:
        if k.endswith(".jpg"):
            assert port[k] == jax_[k], k


def test_validate_checkpoints_fixture_matches_jax(tmp_path):
    """``validate_checkpoints``' synthetic fixture (its jpgs at quality 92)
    equals the JAX tool's byte for byte."""
    validate_checkpoints.make_synthetic_fixture(str(tmp_path / "port"), 5,
                                                (96, 128))
    jvalidate.make_synthetic_fixture(str(tmp_path / "jax"), 5, (96, 128))
    assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")


@functools.lru_cache(maxsize=None)
def _jax_server():
    """The JAX service at the port's tiny size, with the port's seed-0
    reference-layout weights, behind its own HTTP handler."""
    svc = jserve.CPTService(jserve.build_args().parse_args(ts.TINY))
    svc.extractor.params = {"params": convert_detector_state_dict(
        random_vinvl_state_dict(svc.dcfg, seed=0), svc.dcfg)}
    svc.oparams = {"params": jconv.params_for_task(jconv.convert_bert_state_dict(
        jconv.random_oscar_state_dict(svc.cfg, seed=0), svc.cfg), "rec_mlm_cpt")}
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), jserve.make_handler(svc))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.mark.parametrize("kind", ["jpeg", "png"])
def test_serve_handler_matches_jax(kind):
    """An uploaded JPEG (4:2:0, quality 90) or PNG through the port's HTTP
    handler and ``CPTService`` picks the JAX service's box, every score
    within the serve tests' SCORE_ATOL, and equals the port's direct call
    on Pillow's decode of the upload."""
    img = cs.codec_photo(53, 64, 64)
    data = (pillow_jpeg(img, quality=90) if kind == "jpeg"
            else ic.encode_png(img))
    body = json.dumps({"image_b64": base64.b64encode(data).decode(),
                       "caption": "the small thing", "dets": ts.DETS}).encode()
    code, got = ts._request(ts._server(), "/predict", body)
    jcode, want = ts._request(_jax_server(), "/predict", body)
    assert code == jcode == 200, (got, want)
    assert got["pred_box"] == want["pred_box"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=ts.SCORE_ATOL)
    direct = ts._server().svc.predict(pillow_decode(data, "RGB"),
                                      "the small thing", ts.DETS)
    assert got["pred_box"] == direct[0] and got["scores"] == direct[1]
