"""Pillow's other raster formats in the port's image codec
(``cpt_tpu_torch/utils/raster_formats.py`` behind ``utils/image_codec``,
run-length and text decoders in ``csrc/raster.cpp``) against Pillow 12.1.0:
netpbm (PPM, PGM, PBM, PFM), DIB, TGA, PSD, ICO, CUR, SGI, PCX, DCX, QOI,
SUN, IM, MSP, XBM and XPM read bit-equal in RGB and L on seeded files
(1x1, odd widths, widths off a byte for the bit formats, every kind of
compression and depth the readers take) and ``image_size`` equal to
``Image.open(f).size``; cut and byte-flipped copies of each committed
fixture failing where Pillow fails and otherwise giving its pixels; a
seeded corpus of headers for the formats Image.open tries on every file
(TGA, IM) and their neighbours identified as Pillow identifies them, the
only departures allowed being refusals that name a format the codec does
not read; the writers' bytes equal to Pillow's; and ``cpt_predict``'s and
the server's read path on a ``.tga`` and a ``.ppm`` file beside the JAX
tools' Pillow calls. The files Pillow cannot write come from the fixture
script's writers (``tests/data/codec/make_fixtures.py``)."""
from __future__ import annotations

import base64
import dataclasses
import functools
import io
import json
import struct
import warnings

import numpy as np
import PIL
import pytest
import torch
from PIL import Image

import chip_smoke as cs
import test_torch_image_codec as tic
import test_torch_serve as ts
from cpt_tpu.config import bert as jbert_cfg
from cpt_tpu.models.detector import config as jdet_cfg
from cpt_tpu.models.detector import convert as jdconv
from cpt_tpu.tools import cpt_predict as jcpt_predict
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.models.detector import config as det_cfg
from cpt_tpu_torch.tools import cpt_predict
from cpt_tpu_torch.utils import image_codec as ic
from cpt_tpu_torch.utils import raster_formats as rf
from test_torch_watchdog import guards

guard_module, guard_case = guards(300)

mf = tic.mf

# Image.open's order (Image.preinit's plugins first), given to Pillow
# explicitly so that a process that ran Image.init() first agrees
ORDER = ["BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP", "BUFR", "CUR", "PCX",
         "DCX", "DDS", "EPS", "FITS", "FLI", "FTEX", "GBR", "GRIB", "HDF5", "JPEG2000",
         "ICNS", "ICO", "IM", "IMT", "IPTC", "MCIDAS", "MPEG", "TIFF", "MSP", "PCD",
         "PIXAR", "PSD", "QOI", "SGI", "SPIDER", "SUN", "TGA", "WEBP", "WMF", "XBM", "XPM",
         "XVTHUMB"]
READ = {"BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "CUR", "PCX", "DCX", "ICO", "IM", "TIFF",
        "MSP", "PSD", "QOI", "SGI", "SUN", "TGA", "WEBP", "XBM", "XPM"}


def test_pillow_is_the_version_the_readers_follow():
    """The readers reproduce Pillow 12.1.0's plugins and decoders."""
    assert PIL.__version__ == "12.1.0"
    assert [n for n, *_ in ic._formats()] == ORDER
    assert {n for n, _, _, r in ic._formats() if r is not None} | {"JPEG"} == READ


def pillow_open(data: bytes):
    return Image.open(io.BytesIO(data), formats=ORDER)


def outcome(fn):
    """The array ``fn`` gives, or None where it raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn()
    except (OSError, ValueError, SyntaxError, IndexError, TypeError, KeyError,
            EOFError, struct.error, ZeroDivisionError, Image.DecompressionBombError):
        return None


def pillow_pixels(data: bytes, mode: str):
    return outcome(lambda: np.asarray(pillow_open(data).convert(mode)))


def port_pixels(data: bytes, mode: str):
    try:
        return ic.decode(data, mode)
    except ic.ImageCodecError:
        return None


def assert_same(data: bytes, label: str = "", size: bool = True) -> bool:
    """Pixels in RGB and L (or both raising) and, for a file Pillow opens,
    the format and the size: the codec's equal Pillow's. True when Pillow
    decoded it."""
    decoded = False
    for mode in ("RGB", "L"):
        want, got = pillow_pixels(data, mode), port_pixels(data, mode)
        assert (want is None) == (got is None), (label, mode, want is None)
        if want is not None:
            assert got.shape == want.shape and got.dtype == want.dtype, (label, mode)
            np.testing.assert_array_equal(got, want, err_msg=f"{label} {mode}")
            decoded = True
    if decoded and size:
        im = pillow_open(data)
        assert ic._identify(data)[0] == im.format, label
        assert ic.image_size(data) == im.size, label
    return decoded


# ------------------------------------------------------------ seeded files

def seeded(rng, h: int, w: int, channels: int = 3) -> np.ndarray:
    return tic.seeded_image(rng, h, w, 3 if channels == 3 else 1)


SHAPES = [(1, 1), (5, 7), (9, 13), (8, 16), (3, 33), (17, 10)]


def netpbm_cases(rng, h, w):
    img, grey = seeded(rng, h, w), seeded(rng, h, w, 1)
    bits = rng.rand(h, w) < 0.5
    max10 = rng.randint(0, 11, (h, w))
    out = {"p1": mf.ppm_plain(bits), "p2_max10": mf.ppm_plain(max10, 10),
           "p2_max255": mf.ppm_plain(grey, comments=False),
           "p2_max1000": mf.ppm_plain(rng.randint(0, 1001, (h, w)), 1000),
           "p3_max7": mf.ppm_plain(rng.randint(0, 8, (h, w, 3)), 7),
           "p3_max65535": mf.ppm_plain(rng.randint(0, 65536, (h, w, 3)), 65535),
           "p4": mf.pillow_save(Image.fromarray(bits), "PPM"),
           "p5": mf.pillow_save(grey, "PPM"),
           "p5_max1": b"P5 %d %d 1\n" % (w, h) + rng.randint(0, 2, h * w).astype(
               np.uint8).tobytes(),
           "p5_max300": b"P5\n%d %d\n300\n" % (w, h) + rng.randint(0, 301, h * w).astype(
               ">u2").tobytes(),
           "p5_16bit": mf.pillow_save(grey.astype(np.int32) * 199, "PPM", "I"),
           "p6": mf.pillow_save(img, "PPM"),
           "p6_max100": b"P6 #c\n%d %d\n100 " % (w, h) + (img // 3).tobytes(),
           "p6_max2000": b"P6\n%d %d\n2000\n" % (w, h) + rng.randint(
               0, 2001, h * w * 3).astype(">u2").tobytes(),
           "pf_le": mf.pillow_save(Image.fromarray(grey.astype(np.float32) * 1.1 - 9), "PPM"),
           "pf_be": mf.pfm(rng.uniform(-20, 300, (h, w)).astype(np.float32), 3.0),
           "py_rgba": b"PyRGBA\n%d %d\n255\n" % (w, h) + np.concatenate(
               [img, grey[..., None]], 2).tobytes(),
           "p0_cmyk": b"P0CMYK\n%d %d\n255\n" % (w, h) + rng.randint(
               0, 256, h * w * 4).astype(np.uint8).tobytes(),
           "pyp": b"PyP\n%d %d\n255\n" % (w, h) + grey.tobytes()}
    return out


def dib_cases(rng, h, w):
    img = seeded(rng, h, w)
    pal = rng.randint(0, 256, (16, 3))
    return {"dib24": mf.pillow_save(img, "DIB"),
            "dib8_l": mf.pillow_save(img[..., 0], "DIB"),
            "dib4": mf.dib_bytes(rng.randint(0, 16, (h, w)).astype(np.uint8), 4, pal),
            "dib1": mf.pillow_save(Image.fromarray(rng.rand(h, w) < 0.5), "DIB"),
            "dib32": mf.dib_bytes(img, 32)}


def tga_cases(rng, h, w):
    img, grey = seeded(rng, h, w), seeded(rng, h, w, 1)
    idx = rng.randint(0, 12, (h, w)).astype(np.uint8)
    out = {}
    for origin in (0, 0x10, 0x20, 0x30):
        tag = f"o{origin:x}"
        out[f"rgb_{tag}"] = mf.tga_file(img[..., ::-1], 2, 24, origin=origin)
        out[f"rgb_rle_{tag}"] = mf.tga_file(img[..., ::-1] // 64 * 64, 2, 24, origin=origin,
                                            rle=True)
    out["l_rle"] = mf.tga_file(grey // 32 * 32, 3, 8, rle=True, id_field=b"x" * 7)
    out["la"] = mf.tga_file(np.stack([grey, grey[::-1]], -1), 3, 16)
    out["bilevel"] = mf.tga_file(rng.rand(h, w) < 0.5, 3, 1)
    out["bgra32"] = mf.tga_file(rng.randint(0, 256, (h, w, 4)).astype(np.uint8), 2, 32,
                                origin=0x20)
    out["bgr16_rle"] = mf.tga_file(rng.randint(0, 4, (h, w, 2)).astype(np.uint8), 2, 16,
                                   rle=True)
    out["cmap24_rle"] = mf.tga_file(idx, 1, 8, rng.randint(0, 256, (12, 3)), rle=True)
    out["cmap16_start"] = mf.tga_file(idx, 1, 8, rng.randint(0, 256, (9, 2)), map_depth=16,
                                      map_start=3)
    out["cmap32"] = mf.tga_file(idx, 1, 8, rng.randint(0, 256, (12, 4)), map_depth=32)
    out["grey_with_cmap"] = mf.tga_file(idx, 3, 8, rng.randint(0, 256, (12, 3)))
    out["rgb_with_cmap"] = mf.tga_file(img, 2, 24, rng.randint(0, 256, (4, 3)))
    out["pillow_p_rle"] = mf.pillow_save(Image.fromarray(img).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=9), "TGA", rle=True)
    out["pillow_la_rle"] = mf.pillow_save(Image.fromarray(np.stack([grey, grey], -1), "LA"),
                                          "TGA", rle=True)
    return out


def psd_cases(rng, h, w):
    img = seeded(rng, h, w)
    planes = [img[..., i] // 16 * 16 for i in range(3)]
    bits = rng.rand(h, w + 5) < 0.5
    return {"rgb_raw": mf.psd_file(planes, 8, 3, 0),
            "rgb_rle": mf.psd_file(planes, 8, 3, 1, resources=mf.psd_resource(
                1005, b"ab", bytes(5))),
            "rgba_rle": mf.psd_file(planes + [planes[0]], 8, 3, 1),
            "rgb5_rle": mf.psd_file(planes + [planes[0]] * 2, 8, 3, 1),
            "l_raw": mf.psd_file(planes[:1], 8, 1, 0, layers=bytes(12)),
            "p_rle": mf.psd_file([rng.randint(0, 256, (h, w)).astype(np.uint8)], 8, 2, 1,
                                 palette=rng.randint(0, 256, (256, 3))),
            "p_no_palette": mf.psd_file(planes[:1], 8, 2, 0),
            "cmyk_raw": mf.psd_file(planes + [planes[1]], 8, 4, 0),
            "bitmap_rle": mf.psd_file([np.packbits(bits[:, :8 * ((w + 7) // 8)], axis=1)],
                                      1, 0, 1),
            "duotone": mf.psd_file(planes[:1], 8, 8, 1)}


def ico_cases(rng, h, w):
    img = seeded(rng, h, w)
    im = Image.fromarray(img)
    sizes = sorted({(w, h), (max(1, w // 2), max(1, h // 2))})
    return {"png": mf.pillow_save(im, "ICO", sizes=sizes),
            "bmp": mf.pillow_save(im, "ICO", sizes=sizes, bitmap_format="bmp"),
            "bmp_p": mf.pillow_save(im.convert("P", palette=Image.Palette.ADAPTIVE, colors=5),
                                    "ICO", sizes=[(w, h)], bitmap_format="bmp"),
            "bmp_rgba": mf.pillow_save(Image.fromarray(np.concatenate(
                [img, img[..., :1]], 2)), "ICO", sizes=[(w, h)], bitmap_format="bmp"),
            "cur": mf.cur_file([seeded(rng, h, w), seeded(rng, h + 2, w + 3),
                                seeded(rng, h + 1, w + 9)])}


def sgi_cases(rng, h, w):
    img, grey = seeded(rng, h, w), seeded(rng, h, w, 1)
    rgba = np.concatenate([img, grey[..., None]], 2)
    return {"l": mf.pillow_save(grey, "SGI"), "rgb": mf.pillow_save(img, "SGI"),
            "rgba16": mf.pillow_save(Image.fromarray(rgba), "SGI", bpc=2),
            "l_rle": mf.sgi_rle_file(grey // 32 * 32), "rgb_rle": mf.sgi_rle_file(img),
            "rgba_rle16": mf.sgi_rle_file(rgba // 64 * 64, 2)}


def pcx_cases(rng, h, w):
    img, grey = seeded(rng, h, w), seeded(rng, h, w, 1)
    idx = rng.randint(0, 16, (h, w)).astype(np.uint8)
    pal = rng.randint(0, 256, (16, 3))
    return {"rgb": mf.pillow_save(img, "PCX"), "l": mf.pillow_save(grey, "PCX"),
            "p": mf.pillow_save(Image.fromarray(img).convert(
                "P", palette=Image.Palette.ADAPTIVE, colors=30), "PCX"),
            "bilevel": mf.pillow_save(Image.fromarray(rng.rand(h, w) < 0.5), "PCX"),
            "planes4": mf.pcx_planes(idx, 4, pal), "planes2": mf.pcx_planes(idx % 4, 2, pal),
            "dcx": mf.dcx_file([mf.pillow_save(grey, "PCX"), mf.pillow_save(img, "PCX")])}


def qoi_cases(rng, h, w):
    img = seeded(rng, h, w)
    return {"rgb": mf.pillow_save(img // 8 * 8, "QOI"),
            "rgba": mf.pillow_save(np.concatenate([img, img[..., :1] // 128 * 255], 2),
                                   "QOI", "RGBA")}


def sun_cases(rng, h, w):
    img = seeded(rng, h, w)
    idx = rng.randint(0, 16, (h, w)).astype(np.uint8)
    pal = rng.randint(0, 256, (16, 3))
    return {"bgr": mf.sun_file(img, 24), "rgb": mf.sun_file(img, 24, 3),
            "bgrx_rle": mf.sun_file(np.concatenate([img // 32 * 32, img[..., :1]], 2), 32, 2),
            "l8_rle": mf.sun_file(idx * 16, 8, 2), "p8": mf.sun_file(idx, 8, 1, pal),
            "l4": mf.sun_file(idx, 4), "p4_rle": mf.sun_file(idx, 4, 2, pal),
            "bilevel": mf.sun_file(rng.rand(h, w) < 0.5, 1),
            "bilevel_rle": mf.sun_file(rng.rand(h, w) < 0.1, 1, 2),
            "rgb_palette": mf.sun_file(img, 24, 1, pal)}


def im_cases(rng, h, w):
    img, grey = seeded(rng, h, w), seeded(rng, h, w, 1)
    pal = rng.randint(0, 256, (256, 3))
    out = {}
    for mode, im in (("1", Image.fromarray(rng.rand(h, w) < 0.5)), ("L", Image.fromarray(grey)),
                     ("RGB", Image.fromarray(img)),
                     ("RGBA", Image.fromarray(np.concatenate([img, grey[..., None]], 2))),
                     ("LA", Image.fromarray(np.stack([grey, grey[::-1]], -1), "LA")),
                     ("P", mf._with_palette(Image.fromarray(grey), pal)),
                     ("I", Image.fromarray(grey.astype(np.int32) * 5 - 300)),
                     ("I;16", Image.fromarray(grey.astype(np.uint16) * 2)),
                     ("F", Image.fromarray(grey.astype(np.float32) * 1.3 - 20)),
                     ("CMYK", Image.fromarray(img).convert("CMYK"))):
        out[mode] = mf.pillow_save(im, "IM")
    return out


def test_kinds_not_read_are_named():
    """IM's YCC images (and its RLB, RYB3 and bit-field "L*n" kinds) and
    PSD's Lab images are refused by name: Pillow reads them, the codec
    does not yet (ROADMAP)."""
    img = seeded(np.random.RandomState(5), 4, 6)
    im = mf.pillow_save(Image.fromarray(img).convert("YCbCr"), "IM")
    psd = mf.psd_file([img[..., i] for i in range(3)], 8, 9, 0)
    for data, kind in ((im, "IM images of type 'YCbCr'"), (psd, "PSD images of type 'LAB'")):
        assert pillow_pixels(data, "RGB") is not None
        with pytest.raises(ic.ImageCodecError, match=kind):
            ic.decode(data)


def misc_cases(rng, h, w):
    bits = rng.rand(h, w) < 0.5
    idx = rng.randint(0, 70, (h, w))
    pal = rng.randint(0, 256, (300, 3))
    big = rng.randint(0, 300, (h, w))
    return {"msp1": mf.pillow_save(Image.fromarray(bits), "MSP"), "msp2": mf.msp2_file(bits),
            "xbm": mf.pillow_save(Image.fromarray(bits), "XBM"),
            "xbm_hotspot": mf.pillow_save(Image.fromarray(bits), "XBM", hotspot=(1, 0)),
            "xpm1": mf.xpm_file(idx % 60, pal[:60]),
            "xpm2_none": mf.xpm_file(idx, pal[:70], chars=2, transparent=True),
            "xpm_rgb": mf.xpm_file(big, pal, chars=2)}


CASE_SETS = {"netpbm": netpbm_cases, "dib": dib_cases, "tga": tga_cases, "psd": psd_cases,
             "ico": ico_cases, "sgi": sgi_cases, "pcx": pcx_cases, "qoi": qoi_cases,
             "sun": sun_cases, "im": im_cases, "misc": misc_cases}


@pytest.mark.parametrize("kind", sorted(CASE_SETS))
def test_seeded_files_decode_as_pillow(kind):
    """Each kind of file at each of SHAPES: the codec's RGB and L pixels,
    format and size equal Pillow's (or both refuse it)."""
    rng = np.random.RandomState(sorted(CASE_SETS).index(kind) + 900)
    decoded = 0
    for h, w in SHAPES:
        for name, data in CASE_SETS[kind](rng, h, w).items():
            decoded += assert_same(data, f"{kind}:{name} {w}x{h}")
    assert decoded >= len(SHAPES)


# --------------------------------------------------------- damaged copies

def raster_fixtures() -> list:
    return sorted(n for n in mf.raster_fixtures())


def damaged(data: bytes, seed: int):
    """Every 16th truncation point, then bytes spread over the file each
    flipped by xor 1, 0x80, 0xff and a drawn value."""
    rng = np.random.RandomState(seed)
    for n in range(0, len(data), max(1, len(data) // 16)):
        yield data[:n]
    for i in range(0, len(data), max(1, len(data) // 40)):
        for x in (1, 0x80, 0xFF, int(rng.randint(1, 256))):
            b = bytearray(data)
            b[i] ^= x
            yield bytes(b)


# the icons with PNG payloads take the PNG reader's damaged-data rule (it
# refuses a PNG whose last IDAT is cut or whose IDAT checksum is wrong,
# which Pillow decodes when the image data is whole): their damaged copies
# are left out here, and listed in PERF.md
DAMAGE_EXEMPT = ("png.ico",)


@pytest.mark.parametrize("name", [n for n in raster_fixtures() if n not in DAMAGE_EXEMPT])
def test_damaged_fixture_copies_are_pillows(name):
    """Cut and flipped copies of each fixture: the codec raises where
    Pillow raises and otherwise gives its pixels."""
    data = (cs.CODEC_DIR / name).read_bytes()
    for i, d in enumerate(damaged(data, raster_fixtures().index(name))):
        assert_same(d, f"{name} copy {i}", size=False)


# ------------------------------------------------------- the header corpus

def corpus(seed: int, n: int):
    """Headers with random fields for the formats Image.open tries on every
    file (TGA, IM) and their neighbours in its order (IMT, IPTC, PCD,
    SPIDER, SUN, SGI, PSD, QOI, MSP, PCX, DCX, ICO, CUR, XBM, XPM), each a
    few bytes of pixels behind."""
    rng = np.random.RandomState(seed)
    pick = lambda *xs: xs[rng.randint(len(xs))]     # noqa: E731
    for i in range(n):
        kind = i % 12
        tail = rng.randint(0, 256, rng.randint(0, 64)).astype(np.uint8).tobytes()
        if kind in (0, 1, 2):           # Targa
            head = struct.pack("<BBBHHBHHHHBB", pick(0, 0, 3, 28, 32, 10), pick(0, 1, 1, 2),
                               pick(1, 2, 3, 9, 10, 11, 0, 4, 32), rng.randint(0, 4),
                               pick(0, 2, 16, 300), pick(0, 15, 16, 24, 32),
                               rng.randint(0, 3), 0, pick(0, 1, 3, 7, 640),
                               pick(0, 1, 2, 5), pick(1, 8, 15, 16, 24, 32, 7),
                               rng.randint(0, 256))
            yield head + tail
        elif kind in (3, 4):            # IM
            lines = [pick(b"Image type: RGB image", b"Image type: L 16 image",
                          b"Image type: P image", b"Image type:", b"Image type: B4 image",
                          b"Name: x", b"image type: RGB image", b"Image type: F image"),
                     pick(b"Image size (x*y): 3*2", b"Image size (x*y): 0*2",
                          b"Image size (x*y): 3", b"Image size (x*y): 2.5*2",
                          b"Image size (x*y): 1*2*3", b"Image size (x*y): a*b", b"Comment: c"),
                     pick(b"Lut: 1", b"", b"Scale (x,y): 1,1", b"File size (no of images): 2")]
            sep = pick(b"\r\n", b"\n", b"\n\r")
            end = pick(b"\x1a", b"\0" * 3 + b"\x1a", b"", b"\0")
            yield sep.join(l for l in lines if l) + sep + end + tail
        elif kind == 5:                 # IMT and IPTC
            yield pick(b"width %d\nheight %d\npixel n8\n\x0c" % (rng.randint(0, 3),
                                                                  rng.randint(0, 3)),
                       b"* c\nwidth x\n", bytes([0x1C, pick(1, 2, 3, 10), 60,
                                                 pick(0, 2, 130, 140), 2]) + tail) + tail
        elif kind == 6:                 # SUN and SGI
            yield pick(struct.pack(">8I", 0x59A66A95, rng.randint(0, 4), rng.randint(0, 4),
                                   pick(1, 4, 8, 24, 32, 3), 0, pick(0, 1, 2, 3, 6),
                                   pick(0, 1, 2), pick(0, 3, 768, 1100)),
                       struct.pack(">hBBHHHH", 474, pick(0, 1, 2), pick(1, 2, 3),
                                   pick(1, 2, 3), rng.randint(0, 4), rng.randint(0, 4),
                                   pick(1, 3, 4, 2))) + tail
        elif kind == 7:                 # PSD and QOI
            yield pick(b"8BPS" + struct.pack(">H6xHIIHH", pick(1, 2), pick(1, 3, 4),
                                             rng.randint(0, 3), rng.randint(0, 3),
                                             pick(1, 8, 16), pick(0, 1, 2, 3, 4, 9, 5)),
                       b"qoif" + struct.pack(">IIBB", rng.randint(0, 3), rng.randint(0, 3),
                                             pick(3, 4, 5), 0)) + tail
        elif kind == 8:                 # MSP, PCX and DCX
            yield pick(b"DanM" + struct.pack("<14H", *rng.randint(0, 4, 14)),
                       b"LinS" + bytes(28),
                       struct.pack("<BBBBHHHH", 10, pick(0, 2, 5, 4), 1, pick(1, 8, 2),
                                   0, 0, rng.randint(0, 3), rng.randint(0, 3)) + bytes(56)
                       + bytes([0, pick(1, 2, 3, 4)]),
                       struct.pack("<II", 0x3ADE68B1, pick(0, 12, 9999))) + tail
        elif kind == 9:                 # ICO and CUR
            yield pick(b"\0\0\1\0", b"\0\0\2\0") + struct.pack(
                "<HBBBBHHII", pick(0, 1, 2), rng.randint(0, 3), rng.randint(0, 3), 0, 0,
                1, pick(0, 1, 32), rng.randint(0, 100), pick(0, 22, 40, 9999)) + tail
        elif kind == 10:                # XBM and XPM
            yield pick(b"#define im_width %d\n#define im_height %d\nstatic char im_bits[] = {"
                       % (rng.randint(0, 3), rng.randint(0, 3)),
                       b'/* XPM */\n"%d %d 1 1",\n". c #ffffff",\n' % (rng.randint(0, 3),
                                                                       rng.randint(0, 3)),
                       b'/* XPM */\n"2 2 1 1",\n". c white",\n') + tail
        else:                           # PCD, SPIDER and random bytes
            yield pick(bytes(2048) + b"PCD_IPI" + bytes(1532),
                       struct.pack(">27f", *([1.0, 2.0, 0, 0, 1.0] + [0.0] * 6 + [2.0, 1.0]
                                             + [0.0] * 8 + [16.0, 16.0] + [0.0] * 4)),
                       rng.randint(0, 256, 40).astype(np.uint8).tobytes())


def pillow_format(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pillow_open(data).format
    except Exception:      # noqa: BLE001  (any refusal)
        return None


def port_format(data: bytes):
    try:
        return ic._identify(data)[0]
    except ic.ImageCodecError as e:
        return str(e)


CORPUS_SIZE = 2400


@functools.lru_cache(maxsize=None)
def corpus_departures() -> tuple:
    """(files, departures: [(Pillow's format or None, the codec's refusal)])."""
    departures, n = [], 0
    for data in corpus(4242, CORPUS_SIZE):
        n += 1
        want, got = pillow_format(data), port_format(data)
        named = got.endswith(f" images are not supported ({ic._READS})")
        if got in READ:
            assert got == want, (data[:40], want, got)
        elif want in READ:
            raise AssertionError((data[:40], want, got))
        elif want is not None:         # Pillow took a format the codec does not read
            assert got == f"{want} images are not supported ({ic._READS})", (data[:40], got)
        elif named:                    # both refuse, the codec naming a format
            departures.append(got.split(" images")[0])
    return n, departures


def test_header_corpus_is_identified_as_pillow():
    """On the seeded header corpus the codec's choice of format is Pillow's;
    the only departures are refusals naming a format the codec does not
    read where Pillow goes on to refuse the file (counted in PERF.md)."""
    n, departures = corpus_departures()
    assert n == CORPUS_SIZE
    assert set(departures) <= set(ORDER) - READ, departures
    assert not departures, departures      # none on this corpus (PERF.md)


UNREAD = {"JPEG2000": b"\xff\x4f\xff\x51" + bytes(40), "DDS": b"DDS " + bytes(124),
          "EPS": b"%!PS-Adobe-3.0 EPSF-3.0\n", "FITS": b"SIMPLE  =" + bytes(80),
          "ICNS": b"icns" + bytes(12), "BLP": b"BLP2" + bytes(140),
          "AVIF": b"\0\0\0\x1cftypavif" + bytes(20), "FTEX": b"FTEX" + bytes(40),
          "PCD": bytes(2048) + b"PCD_IPI" + bytes(1532), "MPEG": b"\0\0\1\xb3" + bytes(12),
          "XVTHUMB": b"P7 332\n" + bytes(20)}


@pytest.mark.parametrize("fmt", sorted(UNREAD))
def test_unread_formats_are_named(fmt):
    """A file of a format Pillow takes (or tries) but the codec does not
    read raises ImageCodecError naming it, not "cannot identify"."""
    with pytest.raises(ic.ImageCodecError, match=f"^{fmt} images are not supported"):
        ic.decode(UNREAD[fmt])


# ----------------------------------------------------------------- writers

WRITE_EXTENSIONS = (".ppm", ".pgm", ".pbm", ".pnm", ".pfm", ".dib", ".tga", ".icb", ".vda",
                    ".vst", ".sgi", ".rgb", ".rgba", ".bw", ".pcx", ".qoi")


@pytest.mark.parametrize("ext", WRITE_EXTENSIONS)
def test_writers_bytes_are_pillows(ext, tmp_path):
    """``write_image`` by extension writes Pillow's ``save`` bytes for RGB
    and L arrays, to a file of the same name (SGI's header holds it; QOI:
    Pillow refuses L, and so does the codec), and reads them back as
    Pillow does (a 1-pixel-wide RGB PCX is one Pillow's own reader and
    writer do not round-trip)."""
    rng = np.random.RandomState(len(ext) * 31 + sum(ext.encode()))
    (tmp_path / "pillow").mkdir()
    (tmp_path / "port").mkdir()
    for h, w in SHAPES:
        for channels in (3, 1):
            arr = seeded(rng, h, w, channels)
            name = f"image_{h}x{w}_{channels}{ext}"
            want, got = tmp_path / "pillow" / name, tmp_path / "port" / name
            try:
                Image.fromarray(arr).save(want)
            except (OSError, ValueError):
                with pytest.raises(ic.ImageCodecError):
                    ic.write_image(got, arr)
                continue
            ic.write_image(got, arr)
            assert got.read_bytes() == want.read_bytes(), (ext, h, w, channels)
            assert_same(got.read_bytes(), f"{name} read back")


@pytest.mark.parametrize("ext", [".msp", ".xbm"])
def test_bilevel_writers_refuse_as_pillow(ext, tmp_path):
    """MSP and XBM write only mode 1 images: Pillow refuses an RGB or L
    array, and so does the codec."""
    for arr in (seeded(np.random.RandomState(3), 4, 5), seeded(np.random.RandomState(3),
                                                                4, 5, 1)):
        with pytest.raises(OSError):
            Image.fromarray(arr).save(tmp_path / f"x{ext}")
        with pytest.raises(ic.ImageCodecError, match="cannot write mode"):
            ic.write_image(tmp_path / f"y{ext}", arr)


# -------------------------------------------------------------- call sites

@functools.lru_cache(maxsize=None)
def _checkpoints(root: str) -> tuple:
    from pathlib import Path
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    jcfg = jdet_cfg.tiny_detector_config()
    det = root / "det.pth"
    torch.save({"model": {"module." + k: torch.from_numpy(np.asarray(v)) for k, v in
                          jdconv.random_vinvl_state_dict(jcfg, seed=9990).items()}}, det)
    bcfg = cpt_predict.bert_config(32, 2, cpt_predict.region_feature_dim(
        det_cfg.tiny_detector_config()))
    jbcfg = jbert_cfg.BertConfig(**dataclasses.asdict(bcfg))
    oscar = root / "pytorch_model.bin"
    torch.save({"module." + k: torch.from_numpy(v) for k, v in
                jconv.random_oscar_state_dict(jbcfg, seed=9991).items()}, oscar)
    return str(det), str(oscar)


@pytest.mark.parametrize("image,out", [("rgb_rle_top.tga", ".ppm"), ("p6_max4095.ppm", ".tga"),
                                       ("rgb_rle.psd", ".qoi")])
def test_cpt_predict_matches_jax(image, out, tmp_path):
    """``cpt_predict.main --image <file> --out y<ext>`` at the tiny config
    picks the JAX tool's box and writes the JAX tool's file byte for
    byte."""
    det, oscar = _checkpoints(str(tmp_path / "ckpt"))
    dets = json.dumps([[1, 1, 12, 10], [5, 4, 20, 15], [2, 6, 15, 14]])
    flags = ["--image", str(cs.CODEC_DIR / image), "--caption", "the thing on the left",
             "--dets", dets, "--tiny", "--dtype", "float32", "--hidden_size", "32",
             "--num_hidden_layers", "2", "--checkpoint", det, "--oscar_checkpoint", oscar]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jcpt_predict.main(flags + ["--out", str(tmp_path / f"jax{out}"),
                                          "--workdir", str(tmp_path / "jwd")])
    got = cpt_predict.main(flags + ["--device", "cpu", "--out", str(tmp_path / f"port{out}"),
                                    "--workdir", str(tmp_path / "pwd")])
    assert [float(v) for v in got] == [float(v) for v in want]
    assert (tmp_path / f"port{out}").read_bytes() == (tmp_path / f"jax{out}").read_bytes()


@pytest.mark.parametrize("name", ["rgb.tga", "p6.ppm"])
def test_serve_handler_matches_jax(name):
    """A ``.tga`` and a ``.ppm`` upload through the port's HTTP handler and
    ``CPTService`` pick the JAX service's box, every score within the serve
    tests' SCORE_ATOL, and equal the port's direct call on Pillow's decode
    of the upload."""
    data = (cs.CODEC_DIR / name).read_bytes()
    body = json.dumps({"image_b64": base64.b64encode(data).decode(),
                       "caption": "the small thing", "dets": ts.DETS}).encode()
    code, got = ts._request(ts._server(), "/predict", body)
    jcode, want = ts._request(tic._jax_server(), "/predict", body)
    assert code == jcode == 200, (got, want)
    assert got["pred_box"] == want["pred_box"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=ts.SCORE_ATOL)
    direct = ts._server().svc.predict(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")),
                                      "the small thing", ts.DETS)
    assert got["pred_box"] == direct[0] and got["scores"] == direct[1]


# ------------------------------------------------------------ named faults

@pytest.mark.parametrize("fault", sorted(rf.READER_FAULTS))
def test_named_faults_change_the_pixels(fault):
    """Each of the readers' named faults changes the pixels of a fixture of
    its format (chip_smoke's CODEC_FAULTS hold the digests to it)."""
    suffix = cs.CODEC_FAULT_FILES[fault]
    changed = 0
    for path in cs.codec_fixture_files():
        if path.suffix != suffix:
            continue
        data = path.read_bytes()
        clean = ic._decode(data, "RGB", 0)
        try:
            faulted = ic._decode(data, "RGB", ic.FAULTS[fault])
        except ic.ImageCodecError:
            changed += 1
            continue
        changed += faulted.shape != clean.shape or bool((faulted != clean).any())
    assert changed, fault
