"""TIFF in the port's image codec (``cpt_tpu_torch/utils/image_codec``: the
container, Pillow's raw reader and libtiff's directory and strip rules in
Python; LZW, PackBits, the predictor, FillOrder 2 and YCbCr in host C++,
``csrc/tiff.cpp``; JPEG strips through ``csrc/image_codec.cpp``) against
Pillow 12.1.0 on libtiff 4.7.1, the versions its rules were taken from:
the committed fixtures and seeded files written by Pillow (in a subprocess:
its libtiff writer aborts the process on some kinds) and by libtiff's own
writer through ``ctypes`` (tiles, planes, byte orders, subsampled YCbCr,
palettes, 16-bit and associated-alpha RGB) decoded bit for bit in RGB and
L, damaged files raising where Pillow raises (else decoding equal), the
decompression-bomb refusal, the kinds left out, ``encode_tiff``'s bytes,
the named faults; and the JAX package's own image sites (``load_image``,
``img_from_base64``, ``coco_to_tsv``, the server's handler,
``cpt_predict.main``) beside the port's on ``.tif`` files."""
from __future__ import annotations

import base64
import dataclasses
import importlib.util
import io
import json
import shutil
import struct
import warnings

import numpy as np
import PIL
import pytest
import torch
from PIL import Image, features

import chip_smoke as cs
import test_torch_image_codec as tic
import test_torch_serve as ts
from cpt_tpu.config import bert as jbert_cfg
from cpt_tpu.data import coco_json as jcoco
from cpt_tpu.data import vg_tsv as jvg_tsv
from cpt_tpu.models.detector import config as jdet_cfg
from cpt_tpu.models.detector import convert as jdconv
from cpt_tpu.tools import cpt_predict as jcpt_predict
from cpt_tpu.tools import extract_features as jextract
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.data import coco_json, vg_tsv
from cpt_tpu_torch.models.detector import config as det_cfg
from cpt_tpu_torch.tools import cpt_predict, extract_features
from cpt_tpu_torch.utils import image_codec as ic
from test_torch_watchdog import guards

guard_module, guard_case = guards(240)


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", cs.CODEC_DIR / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mf = _fixture_script()
TIFF_FIXTURES = [p.name for p in cs.codec_fixture_files() if p.suffix == ".tif"]
TIFF_FAULTS = [f for f in cs.CODEC_FAULTS if cs.CODEC_FAULT_FILES[f] == ".tif"]


def test_libtiff_is_the_version_the_reader_follows():
    """The reader reproduces Pillow 12.1.0 on libtiff 4.7.1; another version
    may read (or fail) otherwise, and this file says so first."""
    assert PIL.__version__ == "12.1.0"
    assert features.version("libtiff") == "4.7.1"


def pillow_image(data: bytes, mode: str):
    """Pillow's ``convert(mode)`` as an array, or the exception it raises
    (any: Pillow lets KeyError and ValueError out of a damaged TIFF)."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert(mode))
    except Exception as e:         # noqa: BLE001 - any raise is a refusal
        return e


def assert_decodes_as_pillow(data: bytes, readable: bool = True) -> bool:
    """RGB, L and the size, each Pillow's; where Pillow cannot read the file
    (``readable`` False allows it: a raw RGBa file in planes has no unpacker
    there), ``decode`` raises too. Returns whether Pillow read it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for mode in ("RGB", "L"):
            want = pillow_image(data, mode)
            if isinstance(want, Exception):
                assert not readable, want
                with pytest.raises(ic.ImageCodecError):
                    ic.decode(data, mode)
                return False
            np.testing.assert_array_equal(ic.decode(data, mode), want)
        assert ic.image_size(data) == Image.open(io.BytesIO(data)).size
    return True


@pytest.mark.parametrize("name", TIFF_FIXTURES)
def test_fixture_decodes_as_pillow(name):
    """Every committed TIFF fixture: RGB, L (also from the path) and the
    size as Pillow gives them."""
    path = cs.CODEC_DIR / name
    assert_decodes_as_pillow(path.read_bytes())
    np.testing.assert_array_equal(ic.read_image(path, "L"),
                                  pillow_image(path.read_bytes(), "L"))


# --- seeded files ----------------------------------------------------------------

PILLOW_KINDS = {
    # mode to convert to: the compressions Pillow writes it with safely
    "RGB": ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "jpeg"),
    "L": ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "jpeg"),
    "RGBA": ("raw", "tiff_lzw", "tiff_adobe_deflate", "jpeg"),
    "LA": ("raw", "packbits", "tiff_lzw", "jpeg"),
    "CMYK": ("raw", "tiff_lzw", "tiff_adobe_deflate", "jpeg"),
    "1": ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"),
    "P": ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"),
    "I;16": ("raw", "tiff_lzw", "tiff_adobe_deflate"),
    "YCbCr": ("packbits", "tiff_lzw", "tiff_adobe_deflate", "jpeg"),
}


def seeded_rgb(rng, h: int, w: int) -> np.ndarray:
    if rng.rand() < 0.25:
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return cs.codec_photo(int(rng.randint(1 << 30)), h, w)


def pillow_cases(mode: str):
    """Seeded files Pillow writes in ``mode``: sizes 1-70, each of the mode's
    compressions, the predictor and BigTIFF drawn, JPEG quality 5-100."""
    rng = np.random.RandomState(sorted(PILLOW_KINDS).index(mode))
    jobs = []
    for i, comp in enumerate(PILLOW_KINDS[mode] * 2):
        h, w = (1, 1) if i == 0 else (int(v) for v in rng.randint(1, 71, 2))
        img = seeded_rgb(rng, h, w)
        if mode == "I;16":
            arr, conv = (img[..., 0].astype(np.uint16) * int(rng.randint(1, 258))), None
        elif mode in ("RGBA", "LA"):
            arr, conv = np.dstack([img, seeded_rgb(rng, h, w)[..., 0]]), mode
        else:
            arr, conv = img, mode
        kw = {} if comp == "raw" else {"compression": comp}
        if comp in ("tiff_lzw", "tiff_adobe_deflate") and rng.rand() < 0.5 \
                and mode not in ("1", "I;16"):
            kw["tiffinfo"] = {317: 2}
        if comp == "jpeg":
            kw["quality"] = int(rng.randint(5, 101))
        if rng.rand() < 0.3:
            kw["big_tiff"] = True
        if mode == "P":
            kw["colors"] = int(rng.choice([2, 16, 100, 256]))
        jobs.append((arr, conv, kw))
    return mf.pillow_tiff(jobs)


@pytest.mark.parametrize("mode", sorted(PILLOW_KINDS))
def test_pillow_written_files_decode_as_pillow(mode):
    for data in pillow_cases(mode):
        assert_decodes_as_pillow(data)


def libtiff_cases(chunk: int, n: int = 8):
    """Seeded files from libtiff's writer: strips of drawn heights or tiles
    of drawn multiples of 16, contiguous or in planes, either byte order,
    classic or BigTIFF, each compression with the predictor drawn; RGB,
    RGBA (unassociated or associated alpha), grey, 16-bit RGB and grey;
    YCbCr JPEG at 1x1, 2x1 and 2x2 and packed YCbCr at every subsampling
    the put routines take (LZW or Deflate, ReferenceBlackWhite drawn);
    palettes at 1, 2, 4 and 8 bits; FillOrder 2."""
    rng = np.random.RandomState(9800 + chunk)
    for i in range(n):
        h, w = (int(v) for v in rng.randint(1, 75, 2))
        img = seeded_rgb(rng, h, w)
        layout = {}
        if rng.rand() < 0.3:
            layout["tile"] = tuple(16 * int(v) for v in rng.randint(1, 4, 2))
        else:
            layout["rows"] = int(rng.randint(1, h + 1))
        order = ">" if rng.rand() < 0.4 else "<"
        big = bool(rng.rand() < 0.3)
        kind = (chunk * n + i) % 8
        comp = int(rng.choice([1, 5, 8, 32773]))
        pred = 2 if comp in (5, 8) and rng.rand() < 0.5 else None
        if kind == 0:
            arr, kw = img, {"planar": int(rng.randint(1, 3))}
        elif kind == 1:
            alpha = seeded_rgb(rng, h, w)[..., 1]
            assoc = int(rng.randint(0, 3))
            if assoc == 1:
                img = (img.astype(np.uint32) * alpha[..., None] // 255).astype(np.uint8)
            arr, kw = np.dstack([img, alpha]), {"extra": (assoc,),
                                                "planar": int(rng.randint(1, 3))}
        elif kind == 2:
            arr, kw = img[..., 0], {"photometric": int(rng.randint(0, 2))}
        elif kind == 3:
            wide = img.astype(np.uint16) * 257 + rng.randint(0, 257, img.shape).astype(np.uint16)
            arr, kw = (wide if rng.rand() < 0.6 else wide[..., 0]), {}
        elif kind == 4:
            ss = [(1, 1), (2, 1), (2, 2)][int(rng.randint(3))]
            yield mf.libtiff_write(img, 7, 6, subsampling=ss, order=order,
                                   bigtiff=big, quality=int(rng.randint(5, 101)),
                                   **({"tile": layout["tile"]} if "tile" in layout
                                      else {"rows": 16 * int(rng.randint(1, 4))}))
            continue
        elif kind == 5:
            ss = mf_ycbcr_sampling(rng)
            rows = ss[1] * int(rng.randint(1, 6))
            refbw = ((int(rng.randint(0, 30)), int(rng.randint(200, 256)), 128,
                      int(rng.randint(200, 256)), 128, int(rng.randint(200, 256)))
                     if rng.rand() < 0.5 else None)
            yield mf.libtiff_write(img, int(rng.choice([5, 8])), 6, subsampling=ss,
                                   rows=rows, order=order, bigtiff=big,
                                   packed=mf.ycbcr_packed(img, ss[0], ss[1], rows),
                                   refbw=refbw)
            continue
        elif kind == 6:
            bits = int(rng.choice([1, 2, 4, 8]))
            idx = (img[..., 0] >> (8 - bits)).astype(np.uint8)
            yield mf.libtiff_write(idx, comp, 3, colormap=mf.colormap(rng, bits),
                                   bits=bits if bits < 8 else None, order=order,
                                   bigtiff=big, **layout)
            continue
        else:
            arr, kw = img, {"fill_order": 2}
        yield mf.libtiff_write(arr, comp, predictor=pred, order=order,
                               bigtiff=big, **kw, **layout)


def mf_ycbcr_sampling(rng) -> tuple:
    return [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)][int(rng.randint(7))]


@pytest.mark.parametrize("chunk", range(6))
def test_libtiff_written_files_decode_as_pillow(chunk):
    read = [assert_decodes_as_pillow(data, readable=False)
            for data in libtiff_cases(chunk)]
    assert sum(read) >= len(read) - 2


LAYOUTS = {
    "ycbcr_lzw_tiles_22": lambda img: mf.libtiff_write(
        img, 5, 6, subsampling=(2, 2), tile=(16, 32),
        packed=mf.ycbcr_packed_tiles(img, 2, 2, (16, 32))),
    "ycbcr_deflate_tiles_42": lambda img: mf.libtiff_write(
        img, 8, 6, subsampling=(4, 2), tile=(32, 16), order=">",
        packed=mf.ycbcr_packed_tiles(img, 4, 2, (32, 16))),
    "rgb16_planar_mm": lambda img: mf.libtiff_write(
        img.astype(np.uint16) * 257 + 1, 8, planar=2, order=">", rows=7),
    "rgb16_lzw_mm": lambda img: mf.libtiff_write(
        img.astype(np.uint16) * 255, 5, order=">", rows=9),
    "rgba16_planar": lambda img: mf.libtiff_write(
        np.dstack([img, img[..., :1]]).astype(np.uint16) * 250, 32773, planar=2,
        extra=(2,), tile=(16, 16)),
    "grey16_tiles_mm": lambda img: mf.libtiff_write(
        img[..., 1].astype(np.uint16) * 3, 8, order=">", predictor=2, tile=(16, 48)),
    "rgbx16": lambda img: mf.libtiff_write(
        np.dstack([img, img[..., :1]]).astype(np.uint16) * 251, 5, extra=(0,),
        sampleformat=1),
    "palette_extra": lambda img: mf.libtiff_write(
        np.dstack([img[..., 0], img[..., 1]]), 1, 3, extra=(0,),
        colormap=mf.colormap(np.random.RandomState(2), 8)),
    "palette_alpha": lambda img: mf.libtiff_write(
        np.dstack([img[..., 0], img[..., 1]]), 32773, 3, extra=(2,),
        colormap=mf.colormap(np.random.RandomState(3), 8)),
    "ycbcr_coefficients": lambda img: mf.libtiff_write(
        img, 5, 6, subsampling=(2, 2), rows=8, packed=mf.ycbcr_packed(img, 2, 2, 8),
        coeffs=(0.2125, 0.7154, 0.0721)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layouts_decode_as_pillow(layout):
    """Tiled packed YCbCr (TIFFRGBAImage a row of tiles at a time, the right
    tiles cropped), 16-bit samples in planes (Pillow's "R;16N" plane
    unpackers; "A" at 8 bits) and in either byte order, an unspecified
    extra sample on 16-bit RGB and on a palette, a palette with alpha, a
    SampleFormat tag, BT.709 YCbCrCoefficients."""
    for h, w in ((37, 45), (16, 32), (5, 70)):
        img = cs.codec_photo(9995 + h + w, h, w)
        assert_decodes_as_pillow(LAYOUTS[layout](img), readable=False)


@pytest.mark.parametrize("orientation", range(2, 9))
def test_orientation_is_pillows(orientation):
    """An Orientation tag: Pillow's exif_transpose after the load (the size
    swapped for 5-8), on raw strips, LZW tiles and a packed YCbCr file, which
    TIFFRGBAImage also turns to top-left a strip at a time first."""
    img = cs.codec_photo(9990 + orientation, 21, 34)
    for data in (mf.libtiff_write(img, 1, rows=5, orientation=orientation),
                 mf.libtiff_write(img, 5, tile=(16, 16), orientation=orientation),
                 mf.libtiff_write(img, 5, 6, subsampling=(2, 2), rows=6,
                                  packed=mf.ycbcr_packed(img, 2, 2, 6),
                                  orientation=orientation)):
        assert assert_decodes_as_pillow(data)


@pytest.mark.parametrize("compression,predictor", [(1, 1), (5, 1), (5, 2), (8, 2),
                                                   (32773, 1)])
def test_plain_writer_files_decode_as_pillow(compression, predictor):
    """The fixture script's Pillow-free writer (``tiff_file``, the timing
    inputs' on the card's host): grey and RGB in strips."""
    rng = np.random.RandomState(9900 + compression + predictor)
    for rows in (1, 7, None):
        img = seeded_rgb(rng, 23, 31)
        for arr in (img, img[..., 2]):
            assert_decodes_as_pillow(mf.tiff_file(arr, compression, predictor, rows))


# --- damaged files ------------------------------------------------------------------

DAMAGE_SOURCES = {
    "raw": lambda img: mf.libtiff_write(img, 1, rows=8),
    "lzw_predictor": lambda img: mf.libtiff_write(img, 5, predictor=2, rows=8),
    "packbits": lambda img: mf.libtiff_write(img, 32773, rows=8),
    "deflate": lambda img: mf.libtiff_write(img, 8, rows=12),
    "tiles": lambda img: mf.libtiff_write(img, 5, tile=(16, 16)),
    "bigtiff": lambda img: mf.libtiff_write(img, 5, bigtiff=True, rows=12),
    "mm_predictor": lambda img: mf.libtiff_write(img, 8, order=">", predictor=2,
                                                 rows=12),
    "ycbcr_lzw_22": lambda img: mf.libtiff_write(
        img, 5, 6, subsampling=(2, 2), rows=8, packed=mf.ycbcr_packed(img, 2, 2, 8)),
    "ycbcr_deflate_42": lambda img: mf.libtiff_write(
        img, 8, 6, subsampling=(4, 2), rows=6, packed=mf.ycbcr_packed(img, 4, 2, 6)),
    "ycbcr_lzw_tiles": lambda img: mf.libtiff_write(
        img, 5, 6, subsampling=(2, 1), tile=(16, 16),
        packed=mf.ycbcr_packed_tiles(img, 2, 1, (16, 16))),
    "palette4": lambda img: mf.libtiff_write(
        (img[..., 0] // 16).astype(np.uint8), 5, 3,
        colormap=mf.colormap(np.random.RandomState(1), 4), bits=4),
    "pillow_lzw": lambda img: mf.pillow_tiff([(img, None, {"compression": "tiff_lzw"})])[0],
    "pillow_raw": lambda img: mf.pillow_tiff([(img, None, {})])[0],
    "ycbcr_jpeg_22": lambda img: mf.libtiff_write(img, 7, 6, subsampling=(2, 2),
                                                  rows=16),
}


def jpeg_data_ranges(data: bytes) -> list:
    """[start, end) of the JPEG strips and the JPEGTables of a JPEG TIFF."""
    f = ic._TiffFile(data)
    lt = ic._LibtiffDir(f)
    spans = [(o, o + n) for o, n in zip(lt.offsets, lt.bytecounts)]
    at = data.find(lt.jpegtables)
    return spans + [(at, at + len(lt.jpegtables))]


def damaged(data: bytes, rng, skip=()):
    """Every 20th truncation point, and byte flips (xor 1, 0x80, 0xff and a
    drawn value) at every 3rd byte outside ``skip``'s ranges."""
    for n in range(0, len(data), max(1, len(data) // 20)):
        yield data[:n]
    for i in range(0, len(data), 3):
        flips = (1, 0x80, 0xFF, int(rng.randint(1, 256)))
        if any(a <= i < b for a, b in skip):
            continue
        for x in flips:
            b = bytearray(data)
            b[i] ^= x
            yield bytes(b)


def left_out(e: Exception) -> bool:
    """A refusal of a kind the codec leaves out (TIFF of ... is not
    supported), which Pillow may read."""
    return str(e).startswith("TIFF of ") and str(e).endswith("is not supported")


@pytest.mark.parametrize("kind", sorted(DAMAGE_SOURCES))
def test_damaged_files_fail_where_pillow_fails(kind):
    """Truncated and byte-flipped files (a bad offset, count, type or tag,
    a short strip, a corrupt LZW, PackBits or Deflate stream, a damaged
    YCbCr strip that TIFFRGBAImage reads as far as it decodes):
    ``image_size`` raises ``ImageCodecError`` exactly where ``Image.open``
    raises, ``decode`` exactly where Pillow's load raises (or refuses a
    kind it leaves out), and every file both read decodes equal. In the
    JPEG TIFF only the container's bytes are flipped: corrupt Huffman
    tables inside JPEG data decode differently from libjpeg-turbo in the
    JPEG decoder itself, as the same data does in a .jpg file (ROADMAP)."""
    src = DAMAGE_SOURCES[kind](cs.codec_photo(9950, 24, 30))
    skip = jpeg_data_ranges(src) if kind.endswith("jpeg_22") else ()
    rng = np.random.RandomState(sorted(DAMAGE_SOURCES).index(kind))
    read = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for data in damaged(src, rng, skip):
            try:
                im = Image.open(io.BytesIO(data))
            except Exception:      # noqa: BLE001 - any raise is a refusal
                with pytest.raises(ic.ImageCodecError):
                    ic.image_size(data)
                continue
            try:
                size = ic.image_size(data)
            except ic.ImageCodecError as e:
                assert left_out(e), e
                continue
            assert size == im.size
            want = pillow_image(data, "RGB")
            if isinstance(want, Exception):
                with pytest.raises(ic.ImageCodecError):
                    ic.decode(data)
                continue
            try:
                got = ic.decode(data)
            except ic.ImageCodecError as e:
                assert left_out(e), e
                continue
            np.testing.assert_array_equal(got, want)
            read += 1
    assert read > 100


# --- the kinds left out, bombs, the writer, faults --------------------------------

def ifd_file(entries: list, order: str = "<", data: bytes = b"") -> bytes:
    """A classic TIFF of one IFD of (tag, type, count, value) entries (values
    inline), then ``data`` at offset 8 + the IFD's size."""
    body = struct.pack(order + "H", len(entries))
    for tag, typ, count, value in sorted(entries):
        fmt = {3: "H", 4: "L"}[typ]
        body += struct.pack(order + "HHL", tag, typ, count) + struct.pack(
            order + fmt, value).ljust(4, b"\0")
    body += struct.pack(order + "L", 0)
    return (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(order + "L", 8) + body + data


def grey_file(w: int, h: int, extra: list = (), data=None, compression: int = 1) -> bytes:
    at = 8 + 2 + 12 * (9 + len(extra)) + 4
    data = bytes(w * h) if data is None else data
    return ifd_file([(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8),
                     (259, 3, 1, compression), (262, 3, 1, 1), (273, 4, 1, at),
                     (277, 3, 1, 1), (278, 4, 1, h), (279, 4, 1, len(data))]
                    + list(extra), data=data)


LEFT_OUT = {
    "float": lambda: mf.pillow_tiff([(np.arange(12, dtype=np.float32).reshape(3, 4),
                                      None, {})])[0],
    "signed16": lambda: ifd_file(
        [(256, 4, 1, 4), (257, 4, 1, 3), (258, 3, 1, 16), (259, 3, 1, 1),
         (262, 3, 1, 1), (273, 4, 1, 122), (278, 4, 1, 3), (279, 4, 1, 24),
         (339, 3, 1, 2)], data=bytes(24)),
    "ccitt_group3": lambda: grey_file(8, 2, data=bytes(16), compression=3),
    "old_jpeg": lambda: grey_file(8, 2, data=bytes(16), compression=6),
    "old_style_lzw": lambda: grey_file(4, 3, data=b"\x00\x01" + bytes(10),
                                       compression=5),
    "cielab": lambda: mf.libtiff_write(cs.codec_photo(9960, 8, 8), 1, 8),
}


@pytest.mark.parametrize("case", sorted(LEFT_OUT))
def test_left_out_kinds_raise_naming_them(case):
    """Floating-point and signed samples, CCITT and old-style JPEG
    compression, old-style LZW codes and CIELab raise ``ImageCodecError``
    naming the kind (``TIFF of ... is not supported``), nothing decoded."""
    data = LEFT_OUT[case]()
    with pytest.raises(ic.ImageCodecError) as e:
        ic.decode(data)
    assert left_out(e.value), e.value


def bomb_classic() -> bytes:
    """A grey file of 64 data bytes whose directory declares 65535 x 65535."""
    return grey_file(65535, 65535, data=bytes(64))


def bomb_bigtiff() -> bytes:
    """A BigTIFF whose directory declares 100000 x 100000 (LONG8 values)."""
    entries = [(256, 16, 1, 100000), (257, 16, 1, 100000), (258, 3, 1, 8),
               (259, 3, 1, 1), (262, 3, 1, 1), (273, 16, 1, 0), (278, 16, 1, 1),
               (279, 16, 1, 100000)]
    body = struct.pack("<Q", len(entries))
    for tag, typ, count, value in entries:
        body += struct.pack("<HHQ", tag, typ, count) + struct.pack(
            "<Q" if typ == 16 else "<H", value).ljust(8, b"\0")
    return b"II+\0" + struct.pack("<HHQ", 8, 0, 16) + body + struct.pack("<Q", 0)


@pytest.mark.parametrize("make", [bomb_classic, bomb_bigtiff])
def test_tiff_decompression_bombs_raise(make):
    """A size over twice Pillow's MAX_IMAGE_PIXELS raises before any pixel
    is allocated, in ``decode`` and ``image_size``, as Pillow's
    ``Image.open`` raises ``DecompressionBombError``."""
    data = make()
    assert len(data) < 4096
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    for fn in (ic.decode, ic.image_size):
        with pytest.raises(ic.ImageCodecError, match="decompression bomb"):
            fn(data)


@pytest.mark.parametrize("shape", [(1, 1), (1, 1, 3), (37, 45), (48, 64, 3),
                                   (241, 321), (300, 7, 3)])
def test_encode_tiff_is_pillows(shape, tmp_path):
    """``encode_tiff`` and ``write_image`` to .tif / .tiff / format "TIFF"
    write the bytes of Pillow's ``save(format="TIFF")``."""
    arr = cs.codec_photo(9970 + len(shape), *shape[:2])
    arr = arr if len(shape) == 3 else arr[..., 0]
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="TIFF")
    assert ic.encode_tiff(arr) == buf.getvalue()
    for name in ("a.tif", "b.tiff"):
        ic.write_image(tmp_path / name, arr)
        assert (tmp_path / name).read_bytes() == buf.getvalue()
    out = io.BytesIO()
    ic.write_image(out, arr, format="TIFF")
    assert out.getvalue() == buf.getvalue()
    np.testing.assert_array_equal(ic.decode(buf.getvalue(), "RGB" if arr.ndim == 3
                                            else "L"), arr)


@pytest.mark.parametrize("fault", TIFF_FAULTS)
def test_named_faults_change_a_tiff_decode(fault):
    """Each of the TIFF reader's named faults changes some fixture's pixels
    (a refusal counts as a change)."""
    changed = []
    for name in TIFF_FIXTURES:
        data = (cs.CODEC_DIR / name).read_bytes()
        try:
            got = ic._decode(data, "RGB", ic.FAULTS[fault])
        except ic.ImageCodecError:
            changed.append(name)
            continue
        if not np.array_equal(got, ic.decode(data)):
            changed.append(name)
    assert changed


# --- the JAX package's image sites on .tif files ---------------------------------

PARITY_FILES = ["ycbcr_jpeg_22.tif", "rgb_lzw_pred.tif", "tiles_lzw_pred.tif",
                "palette4_lzw.tif", "mm_rgb16_lzw_pred.tif", "cmyk_lzw.tif"]


@pytest.mark.parametrize("name", PARITY_FILES)
def test_load_image_matches_jax_on_tiff(name):
    """``extract_features.load_image`` (with the 600/1000 resize rule and
    without) equals the JAX tool's on the same TIFF file."""
    path = str(cs.CODEC_DIR / name)
    for rule in ((None, None), (600, 1000)):
        got, hw = extract_features.load_image(path, 640, 1024, *rule)
        want, jhw = jextract.load_image(path, 640, 1024, *rule)
        assert tuple(hw) == tuple(jhw)
        np.testing.assert_array_equal(got, want)


def test_vg_tsv_decode_matches_jax_on_tiff():
    """``vg_tsv.img_from_base64`` equals the JAX reader's on base64 TIFF
    bytes."""
    for name in PARITY_FILES:
        b64 = base64.b64encode((cs.CODEC_DIR / name).read_bytes()).decode()
        np.testing.assert_array_equal(vg_tsv.img_from_base64(b64),
                                      jvg_tsv.img_from_base64(b64))


def test_coco_to_tsv_matches_jax_on_tiff(tmp_path):
    """``convert_dataset coco``'s converter over a directory of TIFF files
    writes the JAX converter's files byte for byte."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    images, anns = [], []
    for i, name in enumerate(PARITY_FILES[:4]):
        shutil.copy(cs.CODEC_DIR / name, img_dir / f"{i + 1:012d}.tif")
        w, h = ic.image_size(img_dir / f"{i + 1:012d}.tif")
        images.append({"id": i + 1, "file_name": f"{i + 1:012d}.tif",
                       "height": h, "width": w})
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1 + i % 2,
                     "bbox": [1.0, 2.0, w / 3, h / 4], "area": w * h / 12,
                     "iscrowd": 0})
    ann = tmp_path / "instances.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": [{"id": 1, "name": "cat"},
                                              {"id": 2, "name": "dog"}]}))
    coco_json.coco_to_tsv(str(ann), str(img_dir), str(tmp_path / "port"))
    jcoco.coco_to_tsv(str(ann), str(img_dir), str(tmp_path / "jax"))
    port, jax_ = tic.tree_bytes(tmp_path / "port"), tic.tree_bytes(tmp_path / "jax")
    assert port.keys() == jax_.keys() and len(port) >= 5
    for k in port:
        want = jax_[k].replace(str(tmp_path / "jax").encode(),
                               str(tmp_path / "port").encode())
        assert port[k] == want, k


def test_serve_handler_matches_jax_on_tiff():
    """A YCbCr JPEG TIFF upload through the port's HTTP handler and
    ``CPTService`` picks the JAX service's box, every score within the
    serve tests' SCORE_ATOL, and equals the port's direct call on Pillow's
    decode of the upload."""
    data = (cs.CODEC_DIR / "ycbcr_jpeg_22.tif").read_bytes()
    body = json.dumps({"image_b64": base64.b64encode(data).decode(),
                       "caption": "the small thing", "dets": ts.DETS}).encode()
    code, got = ts._request(ts._server(), "/predict", body)
    jcode, want = ts._request(tic._jax_server(), "/predict", body)
    assert code == jcode == 200, (got, want)
    assert got["pred_box"] == want["pred_box"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=ts.SCORE_ATOL)
    direct = ts._server().svc.predict(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")),
        "the small thing", ts.DETS)
    assert got["pred_box"] == direct[0] and got["scores"] == direct[1]


def test_cpt_predict_matches_jax_on_tiff(tmp_path):
    """``cpt_predict.main --image x.tif --out y.tif`` at the tiny config
    picks the JAX tool's box from one detector and one Oscar checkpoint,
    and writes the JAX tool's TIFF byte for byte."""
    jcfg = jdet_cfg.tiny_detector_config()
    det = tmp_path / "det.pth"
    torch.save({"model": {"module." + k: torch.from_numpy(np.asarray(v)) for k, v in
                          jdconv.random_vinvl_state_dict(jcfg, seed=9980).items()}},
               det)
    bcfg = cpt_predict.bert_config(32, 2, cpt_predict.region_feature_dim(
        det_cfg.tiny_detector_config()))
    jbcfg = jbert_cfg.BertConfig(**dataclasses.asdict(bcfg))
    oscar = tmp_path / "pytorch_model.bin"
    torch.save({"module." + k: torch.from_numpy(v) for k, v in
                jconv.random_oscar_state_dict(jbcfg, seed=9981).items()}, oscar)
    image = str(cs.CODEC_DIR / "tiles_lzw_pred.tif")
    dets = json.dumps([[2, 2, 20, 16], [10, 8, 40, 30], [3, 12, 30, 35]])
    flags = ["--image", image, "--caption", "the thing on the left", "--dets",
             dets, "--tiny", "--dtype", "float32", "--hidden_size", "32",
             "--num_hidden_layers", "2", "--checkpoint", str(det),
             "--oscar_checkpoint", str(oscar)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jcpt_predict.main(flags + ["--out", str(tmp_path / "jax.tif"),
                                          "--workdir", str(tmp_path / "jwd")])
    got = cpt_predict.main(flags + ["--device", "cpu", "--out",
                                    str(tmp_path / "port.tif"), "--workdir",
                                    str(tmp_path / "pwd")])
    assert [float(v) for v in got] == [float(v) for v in want]
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()
