#!/usr/bin/env python3
"""Write the image codec's fixture files (this directory) with Pillow, and
print the SHA-256 digest of each one's decoded pixels as Pillow gives them
(``chip_smoke.CODEC_DIGESTS`` holds them; ``tests/test_torch_image_codec.py``
checks them against Pillow).

    python3 tests/data/codec/make_fixtures.py

JPEG: baseline 4:4:4, 4:2:2 and 4:2:0; quality 10, 75 and 95; optimized
Huffman tables; progressive; restart markers; grayscale; an odd size
(481x641); an Adobe RGB file (``keep_rgb=True``); CMYK, baseline and
progressive (Pillow's writer: Adobe transform 0, inverted samples); YCCK
(Adobe transform 2, Y and K at 2x2; written here by :func:`ycck_jpeg`, a
small baseline encoder with the standard Huffman tables, as Pillow writes
no YCCK); and :func:`jpeg_fixtures`' kinds Pillow's writer has not:
arithmetic-coded and lossless files from libjpeg-turbo's own compressor
through ``ctypes`` (:func:`libjpeg_write`, the library Pillow bundles) and
from :func:`lossless_jpeg` (a subsampled lossless file, which that
compressor does not write), progressive files with scans dropped
(:func:`drop_scans`), and the 24x30 sources of the damaged JPEG corpora. PNG: L, LA, RGB, RGBA, P at 1, 2, 4 and 8 bits and I;16
(Pillow's writer); one Adam7-interlaced RGB file whose rows all take the
Paeth filter, 48-bit RGB, 64-bit RGBA (one interlaced) and 16-bit LA
(built here with zlib: Pillow writes none of them). GIF: P and L, plain
and interlaced (Pillow's writer), and one written here by :func:`gif_file`
with a local palette shorter than its LZW code size reaches, a
transparent index and a frame smaller than the screen. BMP: 1, L, P, RGB
and RGBA (Pillow's writer: BITMAPINFOHEADER, bottom-up) and, written here
by :func:`bmp_file`, RLE8, RLE4, BITFIELDS 565 and 555 (V4 and V5
headers), a top-down 24-bit file and a BITMAPCOREHEADER 4-bit one. WEBP:
lossy at quality 10, 75 and 95, methods 0 and 6, with alpha, odd-sized
(481x641) and 1x1; lossless RGB, RGBA and a 4-colour image (colour
indexing, four pixels a byte); a 2-frame animation (Pillow's writer); and,
from libwebp's own encoder through ``ctypes`` (:func:`libwebp_encode`,
the library Pillow bundles), what Pillow's ``save`` cannot set: the simple
loop filter, 4 and 8 token partitions, one segment, sharpness 7, raw and
filtered alpha planes; and an animation whose first frame lies off the
canvas origin (:func:`webp_animation`). Four 480x640 WEBP files (lossy
quality 75 and 95, lossy with alpha, lossless) are the timing inputs of
``image_codec_timing.py``.

The writers are also the CPU tests' source of seeded GIF, BMP, YCCK,
16-bit PNG and WEBP files (``tests/test_torch_image_codec.py`` and
``tests/test_torch_webp.py`` import them).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import io
import os
import re
import struct
import zlib
from pathlib import Path

import numpy as np

try:
    from PIL import Image
except ImportError:    # a host without Pillow: the plain TIFF writer still runs
    Image = None

HERE = Path(__file__).resolve().parent
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def photo(seed: int, h: int, w: int, noise: float = 6.0) -> np.ndarray:
    """A photo-like RGB image: gradients, a few flat discs, mild noise
    (``noise``: its standard deviation)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                    128 + 100 * np.sin(x / 17.0) * np.cos(y / 23.0)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 60)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def adam7_png(img: np.ndarray) -> bytes:
    """An interlaced RGB PNG, every row of every pass Paeth-filtered."""
    h, w, _ = img.shape
    raw = bytearray()
    for x0, y0, dx, dy in ADAM7:
        sub = img[y0::dy, x0::dx].astype(np.int64)
        if sub.size == 0:
            continue
        rows = sub.reshape(sub.shape[0], -1)
        prev = np.zeros(rows.shape[1], np.int64)
        for row in rows:
            raw.append(4)
            for i, v in enumerate(row):
                a = row[i - 3] if i >= 3 else 0
                c = prev[i - 3] if i >= 3 else 0
                raw.append((int(v) - paeth(int(a), int(prev[i]), int(c))) & 255)
            prev = row

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(bytes(raw), 9))
            + chunk(b"IEND", b""))


def png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))


def png16(samples: np.ndarray, color: int, interlace: int = 0) -> bytes:
    """A 16-bit PNG of uint16 [h, w, channels] samples (colour type 0, 2,
    4 or 6), every row under the Up filter (Adam7 when ``interlace``)."""
    h, w, ch = samples.shape
    raw = bytearray()
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = sub.astype(">u2").reshape(sub.shape[0], -1).view(np.uint8)
        prev = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            raw.append(2)
            raw += (row - prev).astype(np.uint8).tobytes()
            prev = row
    return (b"\x89PNG\r\n\x1a\n"
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, color, 0, 0,
                                             interlace))
            + png_chunk(b"IDAT", zlib.compress(bytes(raw), 9))
            + png_chunk(b"IEND", b""))


# ------------------------------------------------------------------ YCCK JPEG

ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
                   28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
                   44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47,
                   55, 62, 63])
LUMA_Q = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
          14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
          18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
          49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
CHROMA_Q = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
            24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32
# the standard Huffman tables (ITU T.81 K.3): bits[1..16], values
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def huffman_codes(spec) -> dict:
    """symbol → (code, length) of a (bits, values) table."""
    bits, vals = spec
    codes, code, k = {}, 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            codes[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def dct_matrix() -> np.ndarray:
    c = np.zeros((8, 8))
    for u in range(8):
        for x in range(8):
            c[u, x] = (np.sqrt(0.5) if u == 0 else 1.0) * np.cos(
                (2 * x + 1) * u * np.pi / 16) / 2
    return c


def ycck_jpeg(planes: list, quality: int = 75, sampling=(2, 1, 1, 2)) -> bytes:
    """A baseline 4-component JPEG of four uint8 sample planes (Y, Cb, Cr, K
    at full size; component i kept at ``sampling[i]`` x ``sampling[i]`` of
    the largest factor by averaging), with an Adobe APP14 marker of
    transform 2 (YCCK), tables scaled from the standard ones at
    ``quality`` (libjpeg's rule) and the standard Huffman tables."""
    h, w = planes[0].shape
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qts = [np.clip((np.array(t) * scale + 50) // 100, 1, 255)
           for t in (LUMA_Q, CHROMA_Q)]
    hmax = max(sampling)
    mcu = 8 * hmax
    mx, my = -(-w // mcu), -(-h // mcu)
    comps = []
    for i, (plane, f) in enumerate(zip(planes, sampling)):
        full = np.pad(plane.astype(np.float64),
                      ((0, my * mcu - h), (0, mx * mcu - w)), mode="edge")
        d = hmax // f
        comps.append(full.reshape(full.shape[0] // d, d, full.shape[1] // d,
                                  d).mean((1, 3)))
    tq = (0, 1, 1, 0)
    c = dct_matrix()
    out = bytearray(b"\xff\xd8")

    def seg(marker: int, body: bytes) -> None:
        out.extend(struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body)

    seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 2))
    for t, q in enumerate(qts):
        seg(0xDB, bytes([t]) + bytes(q[ZIGZAG].astype(np.uint8)))
    seg(0xC0, struct.pack(">BHHB", 8, h, w, 4) + b"".join(
        bytes([i + 1, f * 16 + f, tq[i]]) for i, f in enumerate(sampling)))
    tables = [(0x00, DC_LUMA), (0x10, AC_LUMA), (0x01, DC_CHROMA),
              (0x11, AC_CHROMA)]
    for index, (bits, vals) in tables:
        seg(0xC4, bytes([index]) + bytes(bits) + bytes(vals))
    seg(0xDA, bytes([4]) + b"".join(bytes([i + 1, 0x00 if tq[i] == 0 else 0x11])
                                    for i in range(4)) + bytes([0, 63, 0]))
    codes = [(huffman_codes(DC_LUMA), huffman_codes(AC_LUMA)),
             (huffman_codes(DC_CHROMA), huffman_codes(AC_CHROMA))]
    acc, nacc, data = 0, 0, bytearray()

    def put(code: int, length: int) -> None:
        nonlocal acc, nacc
        acc, nacc = (acc << length) | code, nacc + length
        while nacc >= 8:
            byte = (acc >> (nacc - 8)) & 255
            data.append(byte)
            if byte == 0xFF:
                data.append(0)
            nacc -= 8

    def magnitude(v) -> tuple:
        v = int(v)
        size = abs(v).bit_length()
        return size, (v if v >= 0 else v + (1 << size) - 1)

    pred = [0] * 4
    for by in range(my):
        for bx in range(mx):
            for i, f in enumerate(sampling):
                dc_codes, ac_codes = codes[tq[i]]
                for yy in range(f):
                    for xx in range(f):
                        y0, x0 = (by * f + yy) * 8, (bx * f + xx) * 8
                        blk = comps[i][y0:y0 + 8, x0:x0 + 8] - 128
                        coef = [int(v) for v in np.round(
                            (c @ blk @ c.T).ravel()[ZIGZAG] / qts[tq[i]][ZIGZAG])]
                        size, bits = magnitude(coef[0] - pred[i])
                        pred[i] = coef[0]
                        put(*dc_codes[size])
                        if size:
                            put(bits, size)
                        run = 0
                        for v in coef[1:]:
                            if v == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac_codes[0xF0])
                                run -= 16
                            size, bits = magnitude(v)
                            put(*ac_codes[run * 16 + size])
                            put(bits, size)
                            run = 0
                        if run:
                            put(*ac_codes[0x00])
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)
    out += data + b"\xff\xd9"
    return bytes(out)


def ycck_planes(img: np.ndarray, k: np.ndarray) -> list:
    """JFIF's YCbCr of an RGB array, rounded, with a K plane: the planes
    of a YCCK file."""
    r, g, b = (img[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return [np.clip(np.round(p), 0, 255).astype(np.uint8) for p in (y, cb, cr)
            ] + [k]


# -------------------------------------- arithmetic, lossless, smoothed JPEG

# jpeg_compress_struct of libjpeg's v6.2 ABI (the one Pillow's bundled
# libjpeg-turbo 3.1.3 exports), x86-64: its size and the offsets of the
# fields set here; jpeg_component_info's size, and its sampling factors'
# offsets (8, 12).
_CINFO_SIZE, _JERR_SIZE, _COMP_SIZE = 520, 168, 96
_CINFO = {"image_width": 48, "image_height": 52, "input_components": 56,
          "in_color_space": 60, "comp_info": 88, "arith_dc_L": 192,
          "arith_dc_U": 208, "arith_ac_K": 224, "num_scans": 240,
          "scan_info": 248, "arith_code": 260, "restart_interval": 280,
          "restart_in_rows": 284}


class _ScanInfo(ctypes.Structure):
    _fields_ = [("comps_in_scan", ctypes.c_int), ("component_index", ctypes.c_int * 4),
                ("Ss", ctypes.c_int), ("Se", ctypes.c_int), ("Ah", ctypes.c_int),
                ("Al", ctypes.c_int)]


def libjpeg():
    """Pillow's bundled libjpeg-turbo through ``ctypes`` (its compressor:
    Pillow's ``save`` writes neither arithmetic nor lossless JPEG)."""
    import PIL
    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libjpeg-*.so*"))[0])
    lib.jpeg_std_error.restype = _P
    for name, args in (("jpeg_std_error", [_P]),
                       ("jpeg_CreateCompress", [_P, _I, ctypes.c_size_t]),
                       ("jpeg_mem_dest", [_P, _P, _P]), ("jpeg_set_defaults", [_P]),
                       ("jpeg_set_quality", [_P, _I, _I]),
                       ("jpeg_simple_progression", [_P]),
                       ("jpeg_enable_lossless", [_P, _I, _I]),
                       ("jpeg_start_compress", [_P, _I]),
                       ("jpeg_write_scanlines", [_P, _P, ctypes.c_uint]),
                       ("jpeg_finish_compress", [_P]), ("jpeg_destroy_compress", [_P])):
        getattr(lib, name).argtypes = args
    return lib


def libjpeg_write(img: np.ndarray, quality: int = 75, arith=False,
                  progressive=False, lossless=None, restart_interval=0,
                  restart_rows=0, sampling=None, dac=None, scans=None) -> bytes:
    """A JPEG of an L, RGB or CMYK array from libjpeg-turbo's compressor:
    jpeg_set_defaults (an RGB array YCbCr, or RGB when lossless), then
    ``lossless`` = (predictor, point transform) (jpeg_enable_lossless)
    or quality ``quality``, ``sampling`` ((h, v) a component), arithmetic
    coding with ``dac`` ((L, U, K) for tables 0, 1, ...), progressive
    (jpeg_simple_progression), a restart interval in MCUs or MCU rows,
    ``scans`` a scan script ((component indices, Ss, Se, Ah, Al) a scan)."""
    lib = libjpeg()
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else img.shape[2]
    cinfo = ctypes.create_string_buffer(_CINFO_SIZE)
    err = ctypes.create_string_buffer(_JERR_SIZE)
    base = ctypes.addressof(cinfo)

    def put(field, value, ctype=ctypes.c_int, index=0):
        at = base + _CINFO[field] + index * ctypes.sizeof(ctype)
        ctype.from_address(at).value = value

    _P.from_address(base).value = lib.jpeg_std_error(err)
    lib.jpeg_CreateCompress(cinfo, 62, _CINFO_SIZE)
    outbuf, outsize = _P(), ctypes.c_ulong()
    lib.jpeg_mem_dest(cinfo, ctypes.byref(outbuf), ctypes.byref(outsize))
    put("image_width", w, ctypes.c_uint)
    put("image_height", h, ctypes.c_uint)
    put("input_components", nc)
    put("in_color_space", {1: 1, 3: 2, 4: 4}[nc])   # JCS_GRAYSCALE, _RGB, _CMYK
    lib.jpeg_set_defaults(cinfo)
    if lossless:
        lib.jpeg_enable_lossless(cinfo, *lossless)
    else:
        lib.jpeg_set_quality(cinfo, quality, 1)
    if sampling:
        comps = _P.from_address(base + _CINFO["comp_info"]).value
        for i, (hs, vs) in enumerate(sampling):
            ctypes.c_int.from_address(comps + i * _COMP_SIZE + 8).value = hs
            ctypes.c_int.from_address(comps + i * _COMP_SIZE + 12).value = vs
    if arith:
        put("arith_code", 1)
    for t, (lo, up, k) in enumerate(dac or ()):
        put("arith_dc_L", lo, ctypes.c_uint8, t)
        put("arith_dc_U", up, ctypes.c_uint8, t)
        put("arith_ac_K", k, ctypes.c_uint8, t)
    if progressive:
        lib.jpeg_simple_progression(cinfo)
    script = (_ScanInfo * len(scans or ()))()
    for info, (comps, ss, se, ah, al) in zip(script, scans or ()):
        info.comps_in_scan = len(comps)
        info.component_index[:len(comps)] = comps
        info.Ss, info.Se, info.Ah, info.Al = ss, se, ah, al
    if scans:
        put("num_scans", len(scans))
        _P.from_address(base + _CINFO["scan_info"]).value = ctypes.addressof(script)
    put("restart_interval", restart_interval, ctypes.c_uint)
    put("restart_in_rows", restart_rows)
    lib.jpeg_start_compress(cinfo, 1)
    rows = (_P * h)(*[img.ctypes.data + y * w * nc for y in range(h)])
    lib.jpeg_write_scanlines(cinfo, rows, h)
    lib.jpeg_finish_compress(cinfo)
    try:
        return ctypes.string_at(outbuf, outsize.value)
    finally:
        lib.jpeg_destroy_compress(cinfo)
        ctypes.CDLL(None).free(outbuf)


def jpeg_segments(data: bytes) -> list:
    """[(offset, marker)] of a JPEG's marker segments up to EOI (the
    entropy-coded data between them skipped)."""
    out, i = [], 2
    while i < len(data) - 1:
        m = data[i + 1]
        if data[i] != 0xFF or m in (0, 0xFF) or 0xD0 <= m <= 0xD7:
            i += 1
            continue
        out.append((i, m))
        if m == 0xD9:
            break
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return out


def lossless_jpeg(planes: list, size: tuple, sampling: list, psv: int = 1,
                  pt: int = 0, restart_rows: int = 0, app: bytes = b"") -> bytes:
    """A lossless (SOF3, Huffman) JPEG of uint8 component ``planes``, each
    at its own size as ``sampling`` ((h, v) a component) gives it for an
    image of ``size`` (height, width), in one interleaved scan: predictor
    ``psv``, point transform ``pt``, a restart every ``restart_rows`` MCU
    rows, the standard luminance DC table, the marker segments ``app``
    after SOI. libjpeg-turbo's compressor subsamples no lossless component;
    this writer does."""
    h_img, w_img = size
    mh, mv = max(f[0] for f in sampling), max(f[1] for f in sampling)
    mcux, mcuy = -(-w_img // mh), -(-h_img // mv)
    diffs = []
    for plane, (hs, vs) in zip(planes, sampling):
        x = plane.astype(np.int64) >> pt
        ch, cw = x.shape
        assert (ch, cw) == (-(-h_img * vs // mv), -(-w_img * hs // mh))
        d = np.zeros((mcuy * vs, mcux * hs), np.int64)
        for y in range(ch):
            first = y % vs == 0 and (y // vs) % max(restart_rows, 1) == 0 and (
                y == 0 or restart_rows)
            for i in range(cw):
                if first:
                    pred = (1 << (7 - pt)) if i == 0 else x[y, i - 1]
                elif i == 0:
                    pred = x[y - 1, 0]
                else:
                    ra, rb, rc = x[y, i - 1], x[y - 1, i], x[y - 1, i - 1]
                    pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                            rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]
                d[y, i] = x[y, i] - pred
        diffs.append(d)
    out = bytearray(b"\xff\xd8" + app)

    def seg(marker: int, body: bytes) -> None:
        out.extend(struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body)

    seg(0xC3, struct.pack(">BHHB", 8, h_img, w_img, len(planes)) + b"".join(
        bytes([i + 1, hs * 16 + vs, 0]) for i, (hs, vs) in enumerate(sampling)))
    seg(0xC4, bytes([0]) + bytes(DC_LUMA[0]) + bytes(DC_LUMA[1]))
    if restart_rows:
        seg(0xDD, struct.pack(">H", restart_rows * mcux))
    seg(0xDA, bytes([len(planes)]) + b"".join(bytes([i + 1, 0])
                                             for i in range(len(planes)))
        + bytes([psv, 0, pt]))
    codes = huffman_codes(DC_LUMA)
    acc, nacc = 0, 0

    def put(code: int, length: int) -> None:
        nonlocal acc, nacc
        acc, nacc = (acc << length) | code, nacc + length
        while nacc >= 8:
            byte = (acc >> (nacc - 8)) & 255
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nacc -= 8

    for my in range(mcuy):
        if restart_rows and my and my % restart_rows == 0:
            if nacc:
                put((1 << (8 - nacc)) - 1, 8 - nacc)
            out.extend(bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8]))
        for mx in range(mcux):
            for d, (hs, vs) in zip(diffs, sampling):
                for yy in range(vs):
                    for xx in range(hs):
                        v = int(d[my * vs + yy, mx * hs + xx])
                        n = abs(v).bit_length()
                        put(*codes[n])
                        if n:
                            put(v if v >= 0 else v + (1 << n) - 1, n)
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)
    out += b"\xff\xd9"
    return bytes(out)


def without_segments(data: bytes, marker: int) -> bytes:
    """The JPEG with its ``marker`` segments taken out."""
    out, last = bytearray(), 0
    for at, m in jpeg_segments(data):
        if m == marker:
            out += data[last:at]
            last = at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]
    return bytes(out + data[last:])


def drop_scans(data: bytes, k: int) -> bytes:
    """A progressive JPEG without its last ``k`` scans (and the table
    segments right before them), then EOI: coefficients left unrefined,
    which libjpeg's block smoothing estimates."""
    segs = jpeg_segments(data)
    starts, table_start = [], None
    for at, m in segs:
        if m in (0xC4, 0xCC):
            table_start = at if table_start is None else table_start
        elif m == 0xDA:
            starts.append(at if table_start is None else table_start)
            table_start = None
        else:
            table_start = None
    return data[:starts[-k]] + b"\xff\xd9"


def pillow_jpeg(img: np.ndarray, mode=None, **kw) -> bytes:
    """Pillow's ``save(format="JPEG", **kw)`` of ``img`` (converted to
    ``mode`` first when given)."""
    im = Image.fromarray(img)
    buf = io.BytesIO()
    (im.convert(mode) if mode else im).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def jpeg_fixtures() -> dict:
    """The JPEG kinds Pillow reads through libjpeg-turbo beyond its own
    writer's: arithmetic-coded (sequential 4:2:0, 4:4:4, grey and CMYK,
    progressive, restart markers, DAC conditioning other than the default
    and none at all), lossless (predictors 1, 4 and 7, grey and RGB, a point
    transform, restart markers, 4:2:0, component ids 1-3 without a marker)
    and progressive files left unrefined (1, 2, 4 and 6 scans dropped).
    The 24x30 ones and damage_*.jpg are the damaged corpora's sources
    (chip_smoke.JPEG_DAMAGE_SOURCES); the 480x640 ones the card's
    timing and ``cpt_predict --image`` inputs."""
    out = {}
    src = photo(9950, 24, 30)
    for name, kw in (("baseline_420", {}), ("baseline_444", {"subsampling": 0}),
                     ("restart", {"restart_marker_blocks": 1}),
                     ("optimize", {"optimize": True}),
                     ("progressive", {"progressive": True})):
        out[f"damage_{name}.jpg"] = pillow_jpeg(src, quality=75, **kw)
    out["damage_gray.jpg"] = pillow_jpeg(src[..., 1], quality=75)
    out["damage_cmyk.jpg"] = pillow_jpeg(src, "CMYK", quality=75)
    out["arith_420_q75.jpg"] = libjpeg_write(src, arith=True)
    out["arith_444_q75.jpg"] = libjpeg_write(src, arith=True, sampling=((1, 1),) * 3)
    out["arith_gray_q75.jpg"] = libjpeg_write(src[..., 1], arith=True)
    # libjpeg writes a DAC for every scan, default values too
    out["arith_no_dac_q75.jpg"] = without_segments(libjpeg_write(src, arith=True), 0xCC)
    out["arith_dac_q75.jpg"] = libjpeg_write(src, arith=True,
                                             dac=((2, 5, 20), (1, 3, 7)))
    out["arith_restart_q75.jpg"] = libjpeg_write(src, arith=True, restart_interval=2)
    out["arith_progressive_q75.jpg"] = libjpeg_write(src, arith=True, progressive=True)
    cmyk = np.asarray(Image.fromarray(src).convert("CMYK"))
    out["arith_cmyk_q75.jpg"] = libjpeg_write(cmyk, arith=True)
    for p in (1, 4, 7):
        out[f"lossless_gray_p{p}.jpg"] = libjpeg_write(
            src[..., 1], lossless=(p, 0), restart_rows=2 if p == 7 else 0)
        out[f"lossless_rgb_p{p}.jpg"] = libjpeg_write(
            src, lossless=(p, 2 if p == 7 else 0))
    half = src.reshape(12, 2, 15, 2, 3).mean((1, 3)).round().astype(np.uint8)
    adobe_rgb = b"\xff\xee\x00\x0eAdobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    out["lossless_420.jpg"] = lossless_jpeg(
        [src[..., 0], half[..., 1], half[..., 2]], (24, 30),
        [(2, 2), (1, 1), (1, 1)], psv=4, restart_rows=3, app=adobe_rgb)
    # libjpeg's RGB without its Adobe marker, the component ids 1, 2, 3:
    # RGB all the same for a lossless file
    ids = bytearray(without_segments(libjpeg_write(src, lossless=(6, 1)), 0xEE))
    sof = ids.index(b"\xff\xc3")
    ids[sof + 10:sof + 19:3] = b"\x01\x02\x03"
    sos = ids.index(b"\xff\xda")
    ids[sos + 5:sos + 11:2] = b"\x01\x02\x03"
    out["lossless_ids123.jpg"] = bytes(ids)
    prog = pillow_jpeg(photo(9951, 48, 64), quality=75, progressive=True)
    for k in (1, 2, 4, 6):
        out[f"smooth_drop{k}.jpg"] = drop_scans(prog, k)
    big = libjpeg_write(photo(9952, 480, 640), quality=50, arith=True, progressive=True)
    out["arith_progressive_q50_480x640.jpg"] = big
    out["smooth_480x640.jpg"] = drop_scans(big, 2)
    out["lossless_gray_480x640.jpg"] = libjpeg_write(
        photo(9953, 480, 640, noise=0.0)[..., 1], lossless=(4, 5))
    return out


# ------------------------------------------------------------------------ GIF

def lzw_encode(indices: np.ndarray, min_bits: int, clear_when_full=True,
               clear_every: int = 0) -> bytes:
    """GIF's LZW of a flat index array, codes packed LSB first: a clear code
    first, a clear when the table fills (or, with ``clear_when_full``
    false, a table left full: the deferred clear), and a clear every
    ``clear_every`` codes when set; the end code last."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    acc = nacc = 0
    out = bytearray()

    def emit(code: int, bits: int) -> None:
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += bits
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def reset():
        return {}, clear + 2, min_bits + 1

    table, nxt, bits = reset()
    emit(clear, bits)
    flat = [int(v) for v in np.asarray(indices).ravel()]
    w, emitted = flat[0], 0
    for k in flat[1:]:
        if (w, k) in table:
            w = table[(w, k)]
            continue
        emit(w, bits)
        emitted += 1
        if nxt < 4096:
            table[(w, k)] = nxt
            nxt += 1
            if nxt > (1 << bits) and bits < 12:
                bits += 1
        if (nxt == 4096 and clear_when_full) or (
                clear_every and emitted % clear_every == 0):
            emit(clear, bits)
            table, nxt, bits = reset()
        w = k
    emit(w, bits)
    if nxt < 4096:      # the decoder adds an entry for the last code too
        nxt += 1
        if nxt > (1 << bits) and bits < 12:
            bits += 1
    emit(end, bits)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\x00"


def interlaced_rows(h: int) -> list:
    return (list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4))
            + list(range(1, h, 2)))


def gif_file(frame: np.ndarray, screen=None, offset=(0, 0), global_pal=None,
             local_pal=None, interlace=False, transparency=None,
             min_bits=None, frames_after=0, **lzw) -> bytes:
    """A GIF89a of one uint8 index frame [h, w] at ``offset`` on a ``screen``
    (w, h; the frame's size by default), with a global and / or local colour
    table ([n, 3] uint8, n a power of two from 2 to 256), a graphic control
    extension naming ``transparency``, an LZW code size ``min_bits`` (from
    the indices by default) and ``frames_after`` more copies of the frame."""
    h, w = frame.shape
    sw, sh = screen or (w, h)

    def table_bits(pal) -> int:
        return max(1, int(len(pal) - 1).bit_length()) - 1

    flags = 0
    if global_pal is not None:
        flags = 0x80 | 0x70 | table_bits(global_pal)
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, 0, 0))
    if global_pal is not None:
        out += np.asarray(global_pal, np.uint8).tobytes()
    if min_bits is None:
        min_bits = max(2, int(frame.max()).bit_length())
    rows = interlaced_rows(h) if interlace else list(range(h))
    body = sub_blocks(lzw_encode(frame[rows], min_bits, **lzw))
    for i in range(1 + frames_after):
        if transparency is not None:
            out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 10, transparency) + b"\x00"
        lflags = 0x40 if interlace else 0
        if local_pal is not None:
            lflags |= 0x80 | table_bits(local_pal)
        out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, lflags)
        if local_pal is not None:
            out += np.asarray(local_pal, np.uint8).tobytes()
        out += bytes([min_bits]) + body
    return bytes(out + b";")


# ------------------------------------------------------------------------ BMP

def rle_encode(rows: np.ndarray, rle4: bool) -> bytes:
    """BI_RLE8 / BI_RLE4 of bottom-up index rows: encoded runs of equal
    indices (pairs of alternating nibbles for RLE4), absolute runs of three
    or more differing ones (an even count for RLE4), word aligned, an
    end-of-line after each row and an end-of-bitmap."""
    out = bytearray()
    for row in rows:
        row = [int(v) for v in row]
        i, n = 0, len(row)
        while i < n:
            j = i + 1
            while j < n and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 3 or n - i < 3:
                count = j - i
                out += bytes([count, row[i] * 17 if rle4 else row[i]])
                i = j
                continue
            j = i
            while j < n and j - i < 254 and not (
                    j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            count = j - i
            if rle4:
                count -= count % 2
            if count < 3:
                out += bytes([1, row[i] * 17 if rle4 else row[i]])
                i += 1
                continue
            run = row[i:i + count]
            out += bytes([0, count])
            if rle4:
                out += bytes(run[k] * 16 + run[k + 1] for k in range(0, count, 2))
            else:
                out += bytes(run)
            if len(out) % 2:
                out.append(0)
            i += count
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_file(pixels: np.ndarray, bits: int, palette=None, compression: int = 0,
             header: int = 40, top_down: bool = False, masks=None) -> bytes:
    """A BMP of uint8 indices [h, w] (``bits`` 1, 4, 8, with a ``palette``
    [n, 3] of RGB entries) or RGB [h, w, 3] (16 as 555 or under ``masks``,
    24, 32 as BGRX or under ``masks`` (r, g, b[, a])): ``header`` 12 (core;
    3-byte palette entries), 40, 108 (V4) or 124 (V5); compression 0 (RGB),
    1 (RLE8), 2 (RLE4) or 3 (BITFIELDS; the masks after a 40-byte header,
    inside a V4 / V5 one); ``top_down`` stores a negative height."""
    h, w = pixels.shape[:2]
    rows = pixels if top_down else pixels[::-1]
    if bits <= 8:
        if compression in (1, 2):
            data = rle_encode(rows, compression == 2)
        else:
            per = 8 // bits
            idx = np.zeros((h, -(-w // per) * per), np.uint8)
            idx[:, :w] = rows
            packed = np.zeros((h, idx.shape[1] // per), np.uint8)
            for k in range(per):
                packed |= idx[:, k::per] << (8 - bits * (k + 1))
            data = packed
    else:
        px = rows.astype(np.uint32)
        r, g, b = px[..., 0], px[..., 1], px[..., 2]
        if bits == 16:
            rm, gm, bm = masks[:3] if masks else (0x7C00, 0x3E0, 0x1F)

            def field(v, m):
                width = bin(m).count("1")
                shift = (m & -m).bit_length() - 1
                return ((v * ((1 << width) - 1) + 127) // 255) << shift

            data = (field(r, rm) | field(g, gm) | field(b, bm)).astype("<u2")
        elif bits == 24:
            data = rows[..., ::-1]
        else:
            rm, gm, bm, am = (tuple(masks) + (0,))[:4] if masks else (
                0xFF0000, 0xFF00, 0xFF, 0)
            a = (r ^ g) & 255

            def place(v, m):
                return (v << ((m & -m).bit_length() - 1)) if m else 0

            data = (place(r, rm) | place(g, gm) | place(b, bm)
                    | place(a, am)).astype("<u4")
        data = np.asarray(data)
    if compression not in (1, 2):
        row = data.reshape(h, -1).view(np.uint8)
        stride = -(-row.shape[1] // 4) * 4
        padded = np.zeros((h, stride), np.uint8)
        padded[:, :row.shape[1]] = row
        data = padded.tobytes()
    else:
        data = bytes(data)
    pal = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            pal = np.concatenate([pal, np.zeros((len(pal), 1), np.uint8)], 1)
        pal = pal.tobytes()
    extra = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1,
                           bits, compression, len(data), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        mask_words = b""
        if compression == 3:
            mask_words = struct.pack("<" + "I" * len(masks), *masks)
        if header == 40:
            extra = mask_words[:12]
        else:
            info += (mask_words + bytes(16))[:16] + b"BGRs"
            info += bytes(header - len(info))
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
            + info + extra + pal + data)


# --- WEBP ---------------------------------------------------------------

def webp(img: np.ndarray, **kw) -> bytes:
    """Pillow's ``save(format="WEBP", **kw)`` of an RGB or RGBA array."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kw)
    return buf.getvalue()


_CONFIG_FIELDS = (
    "lossless", "quality", "method", "image_hint", "target_size",
    "target_PSNR", "segments", "sns_strength", "filter_strength",
    "filter_sharpness", "filter_type", "autofilter", "alpha_compression",
    "alpha_filtering", "alpha_quality", "pass_", "show_compressed",
    "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size",
    "thread_level", "low_memory", "near_lossless", "exact",
    "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")


class _WebPConfig(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR")
                 else ctypes.c_int) for n in _CONFIG_FIELDS] + [
        ("spare", ctypes.c_uint32 * 16)]


_P, _I, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32


class _WebPPicture(ctypes.Structure):
    _fields_ = [("use_argb", _I), ("colorspace", _I), ("width", _I),
                ("height", _I), ("y", _P), ("u", _P), ("v", _P),
                ("y_stride", _I), ("uv_stride", _I), ("a", _P),
                ("a_stride", _I), ("pad1", _U32 * 2), ("argb", _P),
                ("argb_stride", _I), ("pad2", _U32 * 3), ("writer", _P),
                ("custom_ptr", _P), ("extra_info_type", _I),
                ("extra_info", _P), ("stats", _P), ("error_code", _I),
                ("progress_hook", _P), ("user_data", _P), ("pad3", _U32 * 3),
                ("pad4", _P), ("pad5", _P), ("pad6", _U32 * 8),
                ("memory_", _P), ("memory_argb_", _P), ("pad7", _P * 2),
                ("spare", _U32 * 32)]


class _WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", _P), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", _U32 * 8)]


_ABI = 0x0209   # the encoder ABI's major version (2) is what libwebp checks


def libwebp():
    """Pillow's bundled libwebp through ``ctypes`` (libsharpyuv, which it
    needs, loaded first into the global namespace)."""
    import PIL
    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    ctypes.CDLL(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))[0],
                mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])
    lib.WebPConfigInitInternal.argtypes = [_P, _I, ctypes.c_float, _I]
    for name in ("WebPValidateConfig", "WebPEncode"):
        getattr(lib, name).argtypes = [_P] * (2 if name == "WebPEncode" else 1)
    lib.WebPPictureInitInternal.argtypes = [_P, _I]
    lib.WebPPictureImportRGBA.argtypes = [_P, _P, _I]
    lib.WebPPictureImportRGB.argtypes = [_P, _P, _I]
    lib.WebPMemoryWriterInit.argtypes = [_P]
    lib.WebPMemoryWriterClear.argtypes = [_P]
    lib.WebPPictureFree.argtypes = [_P]
    return lib


def libwebp_encode(img: np.ndarray, **fields) -> bytes:
    """A WEBP file of an RGB or RGBA array from libwebp's WebPEncode, its
    WebPConfig the default preset at quality 75 with ``fields`` set (e.g.
    ``filter_type=0``, ``partitions=3``, ``segments=1``,
    ``filter_sharpness=7``, ``alpha_compression=0``)."""
    lib = libwebp()
    config = _WebPConfig()
    assert lib.WebPConfigInitInternal(ctypes.byref(config), 0,
                                      float(fields.get("quality", 75.0)), _ABI)
    for k, v in fields.items():
        setattr(config, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(config)), fields
    pic = _WebPPicture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI)
    h, w, c = img.shape
    pic.width, pic.height, pic.use_argb = w, h, int(config.lossless)
    px = np.ascontiguousarray(img, np.uint8)
    importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert importer(ctypes.byref(pic), px.ctypes.data, w * c)
    writer = _WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, _P).value
    pic.custom_ptr = ctypes.addressof(writer)
    try:
        assert lib.WebPEncode(ctypes.byref(config), ctypes.byref(pic)), \
            pic.error_code
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def riff_chunks(data: bytes) -> list:
    """[(fourcc, payload)] of a WEBP file's top-level chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        kind, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((kind, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def webp_chunk(kind: bytes, payload: bytes) -> bytes:
    return (kind + struct.pack("<I", len(payload)) + payload
            + b"\x00" * (len(payload) & 1))


def riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def vp8x(flags: int, width: int, height: int) -> bytes:
    """A VP8X chunk (ALPHA 0x10, ANIMATION 0x02) for a width x height
    canvas."""
    return webp_chunk(b"VP8X", bytes([flags, 0, 0, 0])
                      + (width - 1).to_bytes(3, "little")
                      + (height - 1).to_bytes(3, "little"))


def alpha_filter(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's alpha prediction filters (1 horizontal, 2 vertical, 3
    gradient; 0 none), the encoder's side: residuals mod 256."""
    a = alpha.astype(np.int64)
    out = a.copy()
    if method == 0:
        return alpha.copy()
    out[0, 1:] = a[0, 1:] - a[0, :-1]
    if method == 1:
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        out[1:, 1:] = a[1:, 1:] - a[1:, :-1]
    elif method == 2:
        out[1:] = a[1:] - a[:-1]
    else:
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        grad = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
        out[1:, 1:] = a[1:, 1:] - grad
    return (out % 256).astype(np.uint8)


def raw_alpha_webp(rgb: np.ndarray, alpha: np.ndarray, method: int,
                   quality: int = 75) -> bytes:
    """A lossy WEBP whose ALPH chunk is stored raw under one of the alpha
    filters (libwebp's encoder chooses its own filter)."""
    vp8 = [c for c in riff_chunks(webp(rgb, quality=quality)) if c[0] == b"VP8 "]
    h, w = alpha.shape
    alph = bytes([method << 2]) + alpha_filter(alpha, method).tobytes()
    return riff(vp8x(0x10, w, h) + webp_chunk(b"ALPH", alph)
                + webp_chunk(*vp8[0]))


def webp_animation(canvas, frames, loop: int = 0) -> bytes:
    """An animated WEBP: ``frames`` of (x, y, WEBP file) placed at even
    offsets on a ``canvas`` (width, height) of transparent black; each
    frame keeps its file's ALPH and VP8 / VP8L chunks."""
    body = vp8x(0x12, *canvas) + webp_chunk(
        b"ANIM", struct.pack("<IH", 0, loop))
    for x, y, data in frames:
        chunks = [c for c in riff_chunks(data) if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]
        kinds = {k: p for k, p in chunks}
        if b"VP8 " in kinds:
            bits = kinds[b"VP8 "]
            w, h = (bits[6] | bits[7] << 8) & 0x3FFF, (bits[8] | bits[9] << 8) & 0x3FFF
        else:
            v = int.from_bytes(kinds[b"VP8L"][1:5], "little")
            w, h = (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1
        payload = b"".join(x.to_bytes(3, "little") for x in
                           (x // 2, y // 2, w - 1, h - 1, 100)) + b"\x00"
        payload += b"".join(webp_chunk(k, p) for k, p in chunks)
        body += webp_chunk(b"ANMF", payload)
    return riff(body)


# libwebp 1.6.0's encoder ignores WebPConfig.partitions (its frames always
# hold one token partition), so frames of 2, 4 or 8 partitions are made here:
# every boolean decision of a frame is read back with its probability and
# coded again, each macroblock row's tokens into partition (row mod n).
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
_BMODE_TREE = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)


def vp8_tables() -> tuple:
    """(CoeffsProba0, CoeffsUpdateProba, BModesProba) as the port's decoder
    (``cpt_tpu_torch/csrc/webp_vp8.cpp``) holds them."""
    src = (HERE.parents[2] / "cpt_tpu_torch" / "csrc" / "webp_vp8.cpp").read_text()

    def table(name, shape):
        body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        return np.array(re.findall(r"\d+", body), int).reshape(shape)

    return (table("kCoeffsProba0", (4, 8, 3, 11)),
            table("kCoeffsUpdateProba", (4, 8, 3, 11)),
            table("kBModesProba", (10, 10, 9)))


class _BoolTrace:
    """RFC 6386's boolean decoder, keeping each (probability, bit)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value, self.range, self.count = (data[0] << 8) | data[1], 255, 0
        self.trace = []

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            bit, self.range, self.value = 1, self.range - split, self.value - (split << 8)
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value, self.range, self.count = self.value << 1, self.range << 1, self.count + 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
        self.trace.append((prob, bit))
        return bit

    def lit(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.lit(n)
        return -v if self.lit(1) else v


def bool_encode(trace) -> bytes:
    """RFC 6386's boolean encoder over (probability, bit) pairs, flushed."""
    out, bottom, rng, count = bytearray(), 0, 255, 24

    def carry():
        i = len(out) - 1
        while i >= 0 and out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    for prob, bit in trace:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom, rng = bottom + split, rng - split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                carry()
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if not count:
                out.append(bottom >> 24)
                bottom &= (1 << 24) - 1
                count = 8
    c, v = count, bottom
    if v & (1 << (32 - c)):
        carry()
    v = (v << (c & 7)) & 0xFFFFFFFF
    for _ in range(c >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append((v >> 24) & 0xFF)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def _vp8_coeffs(d, proba, t: int, ctx: int, n: int) -> int:
    p = proba[t][_BANDS[n]][ctx]
    while n < 16:
        if not d.bit(p[0]):
            return n
        while not d.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = proba[t][_BANDS[n]][0]
        if not d.bit(p[2]):
            nxt = 1
        else:
            nxt = 2
            if not d.bit(p[3]):
                if d.bit(p[4]):
                    d.bit(p[5])
            elif not d.bit(p[6]):
                if not d.bit(p[7]):
                    d.bit(159)
                else:
                    d.bit(165)
                    d.bit(145)
            else:
                b1 = d.bit(p[8])
                for prob in _CATS[2 * b1 + d.bit(p[9 + b1])]:
                    d.bit(prob)
        d.bit(128)                                   # the sign
        n += 1
        p = proba[t][_BANDS[n]][nxt]
    return 16


def repartition(vp8: bytes, log2_parts: int) -> bytes:
    """A VP8 key frame (a "VP8 " chunk's payload) coded again into
    ``1 << log2_parts`` token partitions; its pixels do not change."""
    proba0, update, bmodes = vp8_tables()
    tag = vp8[0] | vp8[1] << 8 | vp8[2] << 16
    first = tag >> 5
    d = _BoolTrace(vp8[10:10 + first])
    d.lit(2)                                         # colour space, clamping
    update_map = use_segment = d.lit(1)
    if use_segment:
        update_map = d.lit(1)
        if d.lit(1):
            d.lit(1)
            for n in (7, 7, 7, 7, 6, 6, 6, 6):
                if d.lit(1):
                    d.signed(n)
        seg_p = [d.lit(8) if update_map and d.lit(1) else 255 for _ in range(3)] \
            if update_map else [255] * 3
    d.lit(10)                                        # filter type, level, sharpness
    if d.lit(1) and d.lit(1):
        for _ in range(8):
            if d.lit(1):
                d.signed(6)
    at = len(d.trace)
    parts = 1 << d.lit(2)
    d.lit(7)
    for _ in range(5):
        if d.lit(1):
            d.signed(4)
    d.lit(1)
    proba = proba0.copy()
    for idx in np.ndindex(4, 8, 3, 11):
        if d.bit(int(update[idx])):
            proba[idx] = d.lit(8)
    use_skip = d.lit(1)
    skip_p = d.lit(8) if use_skip else 0
    w, h = (vp8[6] | vp8[7] << 8) & 0x3FFF, (vp8[8] | vp8[9] << 8) & 0x3FFF
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    assert parts == 1, "the frame has token partitions already"
    tokens = _BoolTrace(vp8[10 + first:])
    top_modes, top_nz = np.zeros((mb_w, 4), int), np.zeros((mb_w, 9), int)
    rows = []
    for _ in range(mb_h):
        left_modes, left_nz = [0] * 4, np.zeros(9, int)
        start = len(tokens.trace)
        for x in range(mb_w):
            if update_map:
                if d.bit(seg_p[0]):
                    d.bit(seg_p[2])
                else:
                    d.bit(seg_p[1])
            skip = d.bit(skip_p) if use_skip else 0
            i4x4 = not d.bit(145)
            if not i4x4:
                mode = (1 if d.bit(128) else 3) if d.bit(156) else (2 if d.bit(163) else 0)
                top_modes[x] = mode
                left_modes = [mode] * 4
            else:
                for y in range(4):
                    mode = left_modes[y]
                    for i in range(4):
                        prob = bmodes[top_modes[x][i]][mode]
                        j = _BMODE_TREE[d.bit(int(prob[0]))]
                        while j > 0:
                            j = _BMODE_TREE[2 * j + d.bit(int(prob[j]))]
                        mode = top_modes[x][i] = -j
                    left_modes[y] = mode
            if d.bit(142) and d.bit(114):
                d.bit(183)
            top, left = top_nz[x], left_nz
            if skip:
                top[:8] = left[:8] = 0
                if not i4x4:
                    top[8] = left[8] = 0
                continue
            first_coeff, t = 0, 3
            if not i4x4:
                nz = _vp8_coeffs(tokens, proba, 1, top[8] + left[8], 0)
                top[8] = left[8] = int(nz > 0)
                first_coeff, t = 1, 0
            for y in range(4):
                for i in range(4):
                    nz = _vp8_coeffs(tokens, proba, t, top[i] + left[y], first_coeff)
                    top[i] = left[y] = int(nz > first_coeff)
            for ch in (4, 6):
                for y in range(2):
                    for i in range(2):
                        nz = _vp8_coeffs(tokens, proba, 2, top[ch + i] + left[ch + y], 0)
                        top[ch + i] = left[ch + y] = int(nz > 0)
        rows.append(tokens.trace[start:])
    head = list(d.trace)
    head[at:at + 2] = [(128, (log2_parts >> 1) & 1), (128, log2_parts & 1)]
    part0 = bool_encode(head)
    n = 1 << log2_parts
    coded = [bool_encode([pb for r in rows[k::n] for pb in r]) for k in range(n)]
    tag = (tag & 0x1F) | len(part0) << 5
    return (tag.to_bytes(3, "little") + vp8[3:10] + part0
            + b"".join(len(c).to_bytes(3, "little") for c in coded[:-1])
            + b"".join(coded))


def webp_partitions(data: bytes, log2_parts: int) -> bytes:
    """A WEBP file with its VP8 chunk re-coded by :func:`repartition`."""
    return riff(b"".join(webp_chunk(k, repartition(p, log2_parts)
                                    if k == b"VP8 " else p)
                         for k, p in riff_chunks(data)))


def webp_fixtures() -> dict:
    """{file name: bytes} of the WEBP fixtures."""
    out = {}
    small = photo(90, 96, 128)
    disc = np.hypot(*np.mgrid[-48:48, -64:64]) < 40
    alpha = np.where(disc, 255, photo(91, 96, 128)[..., 0] // 2).astype(np.uint8)
    rgba = np.dstack([small, alpha])
    out["lossy_q10.webp"] = webp(small, quality=10)
    out["lossy_q75.webp"] = webp(small, quality=75)
    out["lossy_q95_m6.webp"] = webp(small, quality=95, method=6)
    out["lossy_q75_m0.webp"] = webp(small, quality=75, method=0)
    out["lossy_alpha_q75.webp"] = webp(rgba, quality=75)
    out["lossless_rgb.webp"] = webp(photo(92, 64, 80), lossless=True)
    out["lossless_rgba.webp"] = webp(rgba, lossless=True)
    out["odd_481x641_q80.webp"] = webp(photo(93, 481, 641), quality=80)
    out["one_pixel.webp"] = webp(photo(94, 1, 1), quality=75)
    colours = np.random.RandomState(95).randint(0, 256, (4, 3)).astype(np.uint8)
    blobs = np.kron(np.random.RandomState(96).randint(0, 4, (12, 15)),
                    np.ones((5, 5), int))[:57, :71]
    out["palette4_lossless.webp"] = webp(colours[blobs], lossless=True)
    frames = [Image.fromarray(photo(97 + i, 48, 64)) for i in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:],
                   duration=100, quality=75)
    out["anim_2frames.webp"] = buf.getvalue()
    out["simple_filter.webp"] = libwebp_encode(small, filter_type=0,
                                               filter_strength=80)
    out["partitions4.webp"] = webp_partitions(webp(small, quality=75), 2)
    out["partitions8.webp"] = webp_partitions(webp(photo(99, 160, 96),
                                                   quality=75), 3)
    out["one_segment.webp"] = libwebp_encode(small, segments=1)
    out["sharpness7.webp"] = libwebp_encode(small, filter_sharpness=7,
                                            filter_strength=100)
    out["alpha_raw.webp"] = libwebp_encode(rgba, alpha_compression=0)
    out["alpha_filtered.webp"] = libwebp_encode(rgba, alpha_filtering=2,
                                                alpha_quality=90)
    out["anim_offset.webp"] = webp_animation(
        (90, 70), [(6, 4, webp(rgba[:40, :56], quality=60)),
                   (0, 0, webp(small[:70, :90], quality=60))])
    big = photo(100, 480, 640)
    ring = np.hypot(*np.mgrid[-240:240, -320:320])
    out["photo_480x640_q75.webp"] = webp(big, quality=75)
    out["photo_480x640_q95.webp"] = webp(big, quality=95)
    out["alpha_480x640_q75.webp"] = webp(np.dstack(
        [big, np.clip(400 - ring, 0, 255).astype(np.uint8)]), quality=75)
    out["lossless_480x640.webp"] = webp(photo(101, 480, 640, noise=0),
                                        lossless=True)
    return out


# ------------------------------------------------------------------ TIFF

_PILLOW_TIFF = r"""
import io, pickle, sys
from PIL import Image
out = []
for arr, mode, kw in pickle.load(sys.stdin.buffer):
    im = Image.fromarray(arr)
    if mode == "P":
        im = im.quantize(kw.pop("colors", 64))
    elif mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="TIFF", **kw)
    out.append(buf.getvalue())
pickle.dump(out, sys.stdout.buffer)
"""


def pillow_tiff(jobs: list) -> list:
    """Pillow's ``save(format="TIFF", **kw)`` of each (array, mode to convert
    to or None, kw) in a subprocess: Pillow's libtiff writer aborts the
    process on some kinds (JPEG of P, 1, I;16 or F; group4 of 8-bit data),
    so a batch holds the kinds it writes."""
    import pickle
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-c", _PILLOW_TIFF],
                       input=pickle.dumps(jobs), capture_output=True,
                       timeout=300, check=True)
    return pickle.loads(r.stdout)


def libtiff():
    """Pillow's bundled libtiff through ``ctypes``."""
    import PIL
    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libtiff-*.so*"))[0])
    lib.TIFFOpen.restype = _P
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [_P]
    for name in ("TIFFWriteEncodedStrip", "TIFFWriteEncodedTile"):
        getattr(lib, name).argtypes = [_P, ctypes.c_uint32, _P, ctypes.c_ssize_t]
        getattr(lib, name).restype = ctypes.c_ssize_t
    return lib


def libtiff_write(arr: np.ndarray, compression: int = 1, photometric=None,
                  planar: int = 1, tile=None, rows=None, predictor=None,
                  order: str = "<", bigtiff: bool = False, extra=(),
                  colormap=None, subsampling=None, quality: int = 75,
                  fill_order=None, refbw=None, packed=None, bits=None,
                  orientation=None, coeffs=None, sampleformat=None) -> bytes:
    """A TIFF file from libtiff's own writer (TIFFWriteEncodedStrip / Tile):
    ``arr`` [h, w, samples] (uint8 or uint16) in strips of ``rows`` or tiles
    of ``tile`` = (height, width), contiguous or in planes (``planar`` 2);
    YCbCr JPEG from RGB input (JPEGCOLORMODE_RGB) with ``subsampling``;
    ``packed``: already packed YCbCr strips or tiles (a list of bytes) for
    a file that is not JPEG; ``bits`` 1, 2 or 4: one sample a pixel packed MSB
    first, rows padded to a byte; ``orientation``, ``coeffs``
    (YCbCrCoefficients) and ``sampleformat``: those tags."""
    import tempfile
    lib = libtiff()
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, spp = arr.shape
    if photometric is None:
        photometric = 1 if spp - len(extra) == 1 else 2
    U, I = ctypes.c_uint, ctypes.c_int
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "f.tif").encode()
        mode = b"w" + (b"b" if order == ">" else b"l") + (b"8" if bigtiff else b"")
        t = lib.TIFFOpen(path, mode)
        assert t

        def put(tag, *v):
            assert lib.TIFFSetField(ctypes.c_void_p(t), U(tag), *v), tag

        put(256, U(w))
        put(257, U(h))
        put(258, I(bits or arr.dtype.itemsize * 8))
        put(277, I(spp))
        put(259, I(compression))
        put(262, I(photometric))
        put(284, I(planar))
        if extra:
            put(338, I(len(extra)), (ctypes.c_uint16 * len(extra))(*extra))
        if colormap is not None:
            put(320, *[(ctypes.c_uint16 * len(c))(*c) for c in colormap])
        if predictor:
            put(317, I(predictor))
        if fill_order:
            put(266, I(fill_order))
        if orientation:
            put(274, I(orientation))
        if subsampling:
            put(530, I(subsampling[0]), I(subsampling[1]))
        if refbw is not None:
            put(532, (ctypes.c_float * 6)(*refbw))
        if coeffs is not None:
            put(529, (ctypes.c_float * 3)(*coeffs))
        if sampleformat:
            put(339, I(sampleformat))
        if compression == 7:
            put(65537, I(quality))
            if photometric == 6:
                put(65538, I(1))                  # JPEGCOLORMODE_RGB
        if tile:
            put(322, U(tile[1]))
            put(323, U(tile[0]))
        else:
            put(278, U(rows or h))
        n = 0
        if bits:
            rows_ = rows or h
            v = np.unpackbits(arr[..., 0][..., None], axis=2)[..., 8 - bits:]
            packed = [np.packbits(v[y:y + rows_].reshape(len(v[y:y + rows_]), -1),
                                  axis=1).tobytes() for y in range(0, h, rows_)]
        if packed is not None:
            write = lib.TIFFWriteEncodedTile if tile else lib.TIFFWriteEncodedStrip
            for strip in packed:
                buf = np.frombuffer(strip, np.uint8)
                assert write(t, n, buf.ctypes.data, buf.size) >= 0
                n += 1
        planes = [arr] if planar == 1 else [arr[:, :, i:i + 1] for i in range(spp)]
        for p in ([] if packed is not None else planes):
            p = p.astype(p.dtype.newbyteorder("="))
            if tile:
                th, tw = tile
                for y in range(0, h, th):
                    for x in range(0, w, tw):
                        buf = np.zeros((th, tw, p.shape[2]), p.dtype)
                        blk = p[y:y + th, x:x + tw]
                        buf[:blk.shape[0], :blk.shape[1]] = blk
                        assert lib.TIFFWriteEncodedTile(t, n, buf.ctypes.data,
                                                        buf.nbytes) >= 0
                        n += 1
            else:
                for y in range(0, h, rows or h):
                    buf = np.ascontiguousarray(p[y:y + (rows or h)])
                    assert lib.TIFFWriteEncodedStrip(t, n, buf.ctypes.data,
                                                     buf.nbytes) >= 0
                    n += 1
        lib.TIFFClose(t)
        with open(path, "rb") as f:
            return f.read()


def ycbcr_packed(img: np.ndarray, hs: int, vs: int, rows: int) -> list:
    """Strips of packed YCbCr (TIFF's subsampled layout: each hs x vs block's
    Y samples in raster order, then its Cb and Cr, the block means) of an RGB
    image, ``rows`` rows a strip (a multiple of vs), the edge blocks padded
    by replication."""
    x = img.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    cb = 128 + (x[..., 2] - y) / 1.772
    cr = 128 + (x[..., 0] - y) / 1.402
    h, w = y.shape
    ph, pw = -h % vs, -w % hs
    planes = [np.pad(p, ((0, ph), (0, pw)), mode="edge") for p in (y, cb, cr)]
    strips = []
    for top in range(0, h, rows):
        out = []
        for by in range(top, min(top + rows, h), vs):
            for bx in range(0, w, hs):
                blk = [p[by:by + vs, bx:bx + hs] for p in planes]
                out += list(blk[0].ravel()) + [blk[1].mean(), blk[2].mean()]
        strips.append(np.clip(np.round(out), 0, 255).astype(np.uint8).tobytes())
    return strips


def ycbcr_packed_tiles(img: np.ndarray, hs: int, vs: int, tile: tuple) -> list:
    """:func:`ycbcr_packed` for tiles of ``tile`` = (height, width), the
    image padded by replication to whole tiles."""
    th, tw = tile
    h, w = img.shape[:2]
    full = np.pad(img, ((0, -h % th), (0, -w % tw), (0, 0)), mode="edge")
    return [ycbcr_packed(full[y:y + th, x:x + tw], hs, vs, th)[0]
            for y in range(0, h, th) for x in range(0, w, tw)]


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW (libtiff's encoder: MSB-first codes from 9 bits, one code
    early, a clear code at the start and when the table reaches 4094)."""
    codes, nbits, free, table = [(256, 9)], 9, 258, {}
    if data:
        ent = data[0]
        for c in data[1:]:
            nxt = table.get((ent, c))
            if nxt is not None:
                ent = nxt
                continue
            codes.append((ent, nbits))
            ent = c
            table[(codes[-1][0], c)] = free
            free += 1
            if free == 4094:
                codes.append((256, nbits))
                table, free, nbits = {}, 258, 9
            elif free > (1 << nbits) - 1:
                nbits += 1
        codes.append((ent, nbits))
        free += 1
        if free == 4094:
            codes.append((256, nbits))
            nbits = 9
        elif free > (1 << nbits) - 1:
            nbits += 1
    codes.append((257, nbits))
    acc, n = 0, 0
    for code, bits in codes:
        acc = (acc << bits) | code
        n += bits
    acc <<= -n % 8
    return acc.to_bytes((n + 7) // 8, "big")


def packbits(row: bytes) -> bytes:
    """PackBits of one row: runs of 3 or more repeated, the rest literal."""
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j < len(row) and j - i < 128 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), row[i]])
            i = j
            continue
        j = i
        while j < len(row) and j - i < 128 and not (
                j + 2 < len(row) and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def tiff_file(arr: np.ndarray, compression: int = 1, predictor: int = 1,
              rows=None) -> bytes:
    """A little-endian TIFF of a uint8 [h, w] or [h, w, 3] array in strips of
    ``rows`` rows, raw (1), LZW (5), Deflate (8, zlib level 6) or PackBits
    (32773), LZW and Deflate optionally under the horizontal predictor;
    written here without Pillow (the timing inputs of
    ``image_codec_timing.py`` on a host that has none)."""
    px = np.ascontiguousarray(arr, np.uint8)
    h, w = px.shape[:2]
    spp = 1 if px.ndim == 2 else px.shape[2]
    rows = rows or h
    strips = []
    for top in range(0, h, rows):
        block = px[top:top + rows].reshape(-1, w * spp).astype(np.int16)
        if predictor == 2:
            diff = block.copy()
            diff[:, spp:] = block[:, spp:] - block[:, :-spp]
            block = diff % 256
        raw = block.astype(np.uint8)
        if compression == 5:
            strips.append(tiff_lzw(raw.tobytes()))
        elif compression == 8:
            strips.append(zlib.compress(raw.tobytes(), 6))
        elif compression == 32773:
            strips.append(b"".join(packbits(r.tobytes()) for r in raw))
        else:
            strips.append(raw.tobytes())
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp),
            (259, 3, [compression]), (262, 3, [1 if spp == 1 else 2]),
            (273, 4, [0] * len(strips)), (277, 3, [spp]), (278, 4, [rows]),
            (279, 4, [len(s) for s in strips]), (284, 3, [1])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    end = 8 + 2 + 12 * len(tags) + 4
    aux = {t: len(v) * (2 if typ == 3 else 4) for t, typ, v in tags}
    data_at = end + sum(n + n % 2 for n in aux.values() if n > 4)
    offsets = np.cumsum([data_at] + [len(s) for s in strips[:-1]]).tolist()
    tags[5] = (273, 4, offsets)
    ifd, extra = struct.pack("<H", len(tags)), b""
    for tag, typ, vals in tags:
        body = struct.pack(f"<{len(vals)}{'H' if typ == 3 else 'L'}", *vals)
        if len(body) <= 4:
            ifd += struct.pack("<HHL", tag, typ, len(vals)) + body.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHLL", tag, typ, len(vals), end + len(extra))
            extra += body + b"\0" * (len(body) % 2)
    return b"II*\0" + struct.pack("<L", 8) + ifd + struct.pack("<L", 0) + extra + b"".join(strips)


def colormap(rng, bits: int) -> list:
    """A ColorMap of 2**bits entries a channel, 16-bit values that are not
    multiples of 257 (so the reduction to 8 bits shows)."""
    n = 1 << bits
    return [[int(v) for v in rng.randint(0, 65536, n)] for _ in range(3)]


def tiff_fixtures() -> dict:
    """{file name: bytes} of the TIFF fixtures."""
    out = {}
    img = photo(110, 40, 52)
    rgba = np.dstack([img, photo(111, 40, 52)[..., 0]])
    odd = photo(112, 37, 45)
    jobs = {
        "rgb_raw.tif": (img, None, {}),
        "l_raw.tif": (img, "L", {}),
        "bilevel_raw.tif": (img, "1", {}),
        "p_raw.tif": (img, "P", {}),
        "rgba_raw.tif": (rgba, None, {}),
        "la_raw.tif": (rgba, "LA", {}),
        "cmyk_raw.tif": (img, "CMYK", {}),
        "i16_raw.tif": ((img[..., 1].astype(np.uint16) * 181), None, {}),
        "mm_i16_raw.tif": ((img[..., 2].astype(np.uint16) * 131), "I;16B", {}),
        "bigtiff_raw.tif": (odd, None, {"big_tiff": True}),
        "rgb_packbits.tif": (img, None, {"compression": "packbits"}),
        "bilevel_packbits.tif": (img, "1", {"compression": "packbits"}),
        "rgb_lzw.tif": (img, None, {"compression": "tiff_lzw"}),
        "rgb_lzw_pred.tif": (img, None, {"compression": "tiff_lzw",
                                         "tiffinfo": {317: 2}}),
        "l_deflate_pred.tif": (img, "L", {"compression": "tiff_adobe_deflate",
                                          "tiffinfo": {317: 2}}),
        "rgb_deflate.tif": (img, None, {"compression": "tiff_adobe_deflate"}),
        "rgba_lzw.tif": (rgba, None, {"compression": "tiff_lzw"}),
        "la_deflate.tif": (rgba, "LA", {"compression": "tiff_adobe_deflate"}),
        "cmyk_lzw.tif": (img, "CMYK", {"compression": "tiff_lzw"}),
        "p_lzw.tif": (img, "P", {"compression": "tiff_lzw"}),
        "i16_lzw.tif": ((img[..., 0].astype(np.uint16) * 257), None,
                        {"compression": "tiff_lzw"}),
        "bigtiff_lzw.tif": (odd, None, {"compression": "tiff_lzw",
                                        "big_tiff": True}),
        "ycbcr_lzw.tif": (img, "YCbCr", {"compression": "tiff_lzw"}),
        "ycbcr_jpeg_11.tif": (img, "YCbCr", {"compression": "jpeg"}),
        "rgb_jpeg.tif": (img, None, {"compression": "jpeg"}),
        "l_jpeg.tif": (img, "L", {"compression": "jpeg"}),
    }
    out.update(zip(jobs, pillow_tiff(list(jobs.values()))))
    # what Pillow's writer cannot write: libtiff's own
    rng = np.random.RandomState(113)
    rgb16 = odd.astype(np.uint16) * 257 + rng.randint(0, 257, odd.shape).astype(np.uint16)
    idx4 = (photo(114, 37, 45)[..., 0] // 16).astype(np.uint8)
    out["ycbcr_jpeg_22.tif"] = libtiff_write(odd, 7, 6, subsampling=(2, 2), rows=16)
    out["ycbcr_jpeg_21.tif"] = libtiff_write(odd, 7, 6, subsampling=(2, 1), rows=8)
    out["ycbcr_jpeg_22_tiles.tif"] = libtiff_write(odd, 7, 6, subsampling=(2, 2),
                                                   tile=(16, 32))
    out["ycbcr_lzw_22.tif"] = libtiff_write(
        odd, 5, 6, subsampling=(2, 2), rows=8,
        packed=ycbcr_packed(odd, 2, 2, 8), refbw=(16, 235, 128, 240, 128, 240))
    out["ycbcr_deflate_42.tif"] = libtiff_write(
        odd, 8, 6, subsampling=(4, 2), rows=10, packed=ycbcr_packed(odd, 4, 2, 10))
    out["tiles_lzw_pred.tif"] = libtiff_write(odd, 5, tile=(16, 16), predictor=2)
    out["tiles_deflate_l.tif"] = libtiff_write(odd[..., 1], 8, tile=(32, 16))
    out["tiles_packbits.tif"] = libtiff_write(odd, 32773, tile=(16, 32))
    out["tiles_raw.tif"] = libtiff_write(odd, 1, tile=(16, 16))
    out["planar_lzw.tif"] = libtiff_write(odd, 5, planar=2, rows=8, predictor=2)
    out["planar_deflate_rgba.tif"] = libtiff_write(
        np.dstack([odd, idx4 * 16]), 8, planar=2, rows=12, extra=(2,))
    out["planar_raw.tif"] = libtiff_write(odd, 1, planar=2, rows=10)
    out["mm_lzw_pred.tif"] = libtiff_write(odd, 5, order=">", predictor=2, rows=9)
    out["mm_rgb16_lzw_pred.tif"] = libtiff_write(rgb16, 5, order=">", predictor=2,
                                                 rows=12)
    out["rgb16_deflate.tif"] = libtiff_write(rgb16, 8, rows=20)
    out["rgba_assoc_lzw.tif"] = libtiff_write(
        np.dstack([odd // 2, np.full(odd.shape[:2], 128, np.uint8)]), 5, extra=(1,))
    out["rgba_assoc_planar.tif"] = libtiff_write(
        np.dstack([odd // 3, (idx4 * 17)[..., None]]), 5, planar=2, extra=(1,))
    out["palette4_lzw.tif"] = libtiff_write(idx4, 5, 3, colormap=colormap(rng, 4),
                                            bits=4)
    out["grey2_packbits.tif"] = libtiff_write(idx4 // 4, 32773, 1, bits=2, rows=9)
    out["palette8_raw.tif"] = libtiff_write(odd[..., 0], 1, 3, colormap=colormap(rng, 8),
                                            rows=7)
    out["fill2_lzw.tif"] = libtiff_write(odd, 5, fill_order=2, rows=16)
    out["whiteiszero_raw.tif"] = libtiff_write(odd[..., 2], 1, 0)
    out["ycbcr_jpeg_22_480x640.tif"] = libtiff_write(photo(115, 480, 640), 7, 6,
                                                     subsampling=(2, 2), rows=16)
    return out


# ------------------------------------------------- Pillow's other raster formats

def pillow_save(arr_or_im, fmt: str, mode=None, **kw) -> bytes:
    """Pillow's ``save(format=fmt, **kw)`` of an array (in ``mode``) or an
    image."""
    im = arr_or_im if hasattr(arr_or_im, "save") else Image.fromarray(arr_or_im, mode)
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def ppm_plain(arr: np.ndarray, maxval: int = 255, comments: bool = True) -> bytes:
    """A plain (ASCII) netpbm file: P1 for a bool array (True black), P2 for
    [h, w], P3 for [h, w, 3] samples up to ``maxval``; comments in the
    header and among the samples, rows of varied length."""
    h, w = arr.shape[:2]
    if arr.dtype == bool:
        head = b"P1\n"
    else:
        head = b"P2\n" if arr.ndim == 2 else b"P3\n"
    if comments:
        head += b"# written by make_fixtures\n"
    head += b"%d %d\n" % (w, h)
    if arr.dtype != bool:
        head += b"%d\n" % maxval
    lines = []
    for y in range(h):
        vals = arr[y].astype(np.int64).reshape(-1)
        if arr.dtype == bool:
            lines.append("".join("1" if v else "0" for v in vals).encode())
        else:
            lines.append(b" ".join(b"%d" % v for v in vals))
        if comments and y % 3 == 1:
            lines.append(b"# a comment among the samples")
    return head + b"\n".join(lines) + b"\n"


def pfm(arr: np.ndarray, scale: float = 1.0) -> bytes:
    """A grey PFM ("Pf"): the scale's sign gives the byte order (negative:
    little-endian), rows bottom-up."""
    h, w = arr.shape
    order = "<f4" if scale < 0 else ">f4"
    return (b"Pf\n%d %d\n%s\n" % (w, h, repr(float(scale)).encode())
            + arr[::-1].astype(order).tobytes())


def tga_file(pixels: np.ndarray, kind: int, depth: int, palette=None, map_depth: int = 24,
             map_start: int = 0, origin: int = 0, id_field: bytes = b"",
             rle: bool = False) -> bytes:
    """A Targa file: ``pixels`` are the stored samples ([h, w] indices or
    grey, or [h, w, bytes] for 16-, 24- and 32-bit pixels, top row first);
    ``origin`` is the flags' 0x30 bits; RLE packets within rows."""
    h, w = pixels.shape[:2]
    cmap = palette is not None
    entries = 0 if palette is None else len(palette)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), int(cmap), kind | (8 if rle else 0),
                       map_start, entries, map_depth if cmap else 0, 0, 0, w, h, depth,
                       origin)
    body = head + id_field
    if cmap:
        body += np.asarray(palette, np.uint8).tobytes()
    rows = pixels if origin & 0x20 else pixels[::-1]
    if origin & 0x10:
        rows = rows[:, ::-1]
    k = max(1, depth // 8)
    if depth == 1:
        data = np.packbits(rows.astype(bool), axis=1).tobytes()
    elif not rle:
        data = np.ascontiguousarray(rows).tobytes()
    else:
        out = bytearray()
        for row in rows.reshape(h, w, k):
            x = 0
            while x < w:
                n = 1
                while x + n < w and n < 128 and (row[x + n] == row[x]).all():
                    n += 1
                if n >= 2:
                    out += bytes([0x80 | (n - 1)]) + row[x].tobytes()
                else:
                    n = 1
                    while (x + n < w and n < 128
                           and not (row[x + n] == row[x + n - 1]).all()):
                        n += 1
                    out += bytes([n - 1]) + row[x:x + n].tobytes()
                x += n
        data = bytes(out)
    return body + data


def psd_file(channels: list, bits: int, mode: int, compression: int, palette=None,
             resources: bytes = b"", layers: bytes = b"") -> bytes:
    """A Photoshop file: ``channels`` are [h, w] planes (1-bit: rows of
    packed bits), ``mode`` PSD's colour mode (0 bitmap, 1 grey, 2 indexed,
    3 RGB, 4 CMYK), the composite image raw (0) or PackBits (1) by row."""
    h, w = channels[0].shape
    w *= 8 if bits == 1 else 1
    head = (b"8BPS" + struct.pack(">H6xHIIHH", 1, len(channels), h, w, bits, mode))
    cmd = b"" if palette is None else np.asarray(palette, np.uint8).T.tobytes()
    body = head + struct.pack(">I", len(cmd)) + cmd
    body += struct.pack(">I", len(resources)) + resources
    body += struct.pack(">I", len(layers)) + layers
    body += struct.pack(">H", compression)
    if compression == 0:
        body += b"".join(np.ascontiguousarray(c).tobytes() for c in channels)
    else:
        rows = [packbits(r.tobytes()) for c in channels for r in c]
        body += b"".join(struct.pack(">H", len(r)) for r in rows) + b"".join(rows)
    return body


def psd_resource(ident: int, name: bytes, data: bytes) -> bytes:
    """An image resource block (8BIM, its id, a padded Pascal name, data)."""
    pname = bytes([len(name)]) + name
    pname += b"\0" * (len(pname) & 1)
    return b"8BIM" + struct.pack(">H", ident) + pname + struct.pack(">I", len(data)) + data \
        + b"\0" * (len(data) & 1)


def dib_bytes(pixels: np.ndarray, bits: int, palette=None) -> bytes:
    """A BITMAPINFOHEADER bitmap (no file header) of ``pixels`` ([h, w]
    indices or [h, w, 3] RGB), bottom-up."""
    return bmp_file(pixels, bits, palette)[14:]


def cur_file(images: list, hotspot=(1, 2), magic: bytes = b"\0\0\2\0") -> bytes:
    """A Windows cursor (an icon, with ``magic`` b"\0\0\1\0" and ``hotspot``
    the planes and bits: (1, 24)) of 24-bit bitmaps (each [h, w, 3] with its
    AND mask), in the order given."""
    n = len(images)
    entries, blobs, at = b"", b"", 6 + 16 * n
    for img in images:
        h, w = img.shape[:2]
        mask = np.zeros((h, ((w + 31) // 32) * 4), np.uint8)
        dib = dib_bytes(img, 24)
        blob = dib[:8] + struct.pack("<i", 2 * h) + dib[12:] + mask.tobytes()
        entries += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, *hotspot, len(blob),
                               at + len(blobs))
        blobs += blob
    return magic + struct.pack("<H", n) + entries + blobs


def dcx_file(pages: list) -> bytes:
    """A DCX of PCX pages."""
    at = 4 + 4 * (len(pages) + 1)
    offsets = []
    for p in pages:
        offsets.append(at)
        at += len(p)
    return (struct.pack("<I", 0x3ADE68B1) + b"".join(struct.pack("<I", o) for o in offsets)
            + b"\0\0\0\0" + b"".join(pages))


def pcx_planes(indices: np.ndarray, planes: int, palette: np.ndarray) -> bytes:
    """A PCX of 1-bit planes (2 or 4), a 16-colour header palette, rows of
    planes padded to even lengths, PCX RLE."""
    h, w = indices.shape
    stride = (w + 7) // 8
    stride += stride % 2
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 1, 0, 0, w - 1, h - 1, 72, 72)
            + np.asarray(palette, np.uint8)[:16].tobytes().ljust(48, b"\0") + b"\0"
            + struct.pack("<BHHHH", planes, stride, 1, w, h) + b"\0" * 54)
    out = bytearray()
    for row in indices:
        line = b"".join(np.packbits(((row >> i) & 1).astype(np.uint8)).tobytes().ljust(
            stride, b"\0") for i in range(planes))
        for b in line:
            out += bytes([0xC1, b]) if b >= 0xC0 else bytes([b])
    return head + bytes(out)


def msp2_file(bits: np.ndarray) -> bytes:
    """A Windows Paint version 2 ("LinS") file of a bool array (True white):
    per row, runs of equal bytes (0, count, value) and literal bytes."""
    h, w = bits.shape
    rows = np.packbits(bits, axis=1)
    data, lens = b"", []
    for i, row in enumerate(rows):
        if i % 7 == 3 and bits[i].all():
            lens.append(0)
            continue
        out, x = bytearray(), 0
        while x < len(row):
            n = 1
            while x + n < len(row) and row[x + n] == row[x] and n < 255:
                n += 1
            if n >= 3:
                out += bytes([0, n, row[x]])
            else:
                out += bytes([n]) + row[x:x + n].tobytes()
            x += n
        lens.append(len(out))
        data += bytes(out)
    header = [0x694C, 0x536E, w, h, 1, 1, 1, 1, w, h, 0, 0, 0, 0, 0, 0]
    check = 0
    for v in header:
        check ^= v
    header[12] = check
    return (struct.pack("<16H", *header) + struct.pack(f"<{h}H", *lens) + data)


def sgi_rle_file(arr: np.ndarray, bpc: int = 1) -> bytes:
    """An RLE SGI file ([h, w] or [h, w, c] samples; 2 bytes a sample at
    ``bpc`` 2, the high byte the sample, the low byte 0x5A): rows bottom-up,
    the offset and length tables channel by channel, runs and literals of
    at most 127 and a zero terminator a row."""
    a = arr if arr.ndim == 3 else arr[:, :, None]
    h, w, z = a.shape
    head = struct.pack(">hBBHHHHll4s79ss", 474, 1, bpc, 3 if z > 1 else 2, w, h, z, 0, 255,
                       b"", b"rle", b"") + struct.pack(">l404s", 0, b"")
    starts, lens, blobs = [], [], b""
    at = 512 + 8 * h * z

    def sample(v):
        return bytes([v]) if bpc == 1 else bytes([v, 0x5A])

    def packet(n):           # a packet's count: the low byte of a 16-bit one
        return bytes([n]) if bpc == 1 else bytes([0, n])
    for c in range(z):
        for y in range(h - 1, -1, -1):
            row = a[y, :, c]
            out, x = bytearray(), 0
            while x < w:
                n = 1
                while x + n < w and row[x + n] == row[x] and n < 127:
                    n += 1
                if n >= 3:
                    out += packet(n) + sample(row[x])
                else:
                    n = 1
                    while x + n < w and n < 127 and not (
                            x + n + 2 < w and row[x + n] == row[x + n + 1] == row[x + n + 2]):
                        n += 1
                    out += packet(0x80 | n) + b"".join(sample(v) for v in row[x:x + n])
                x += n
            out += packet(0)
            starts.append(at + len(blobs))
            lens.append(len(out))
            blobs += bytes(out)
    return (head + struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I", *lens)
            + blobs)


def sun_file(pixels: np.ndarray, depth: int, kind: int = 1, palette=None) -> bytes:
    """A Sun raster file: ``pixels`` the stored samples ([h, w] or [h, w, 3]
    / [h, w, 4] in the file's byte order; 1-bit as 0 / 1), rows padded to
    16 bits when raw; ``kind`` 2 RLE-encodes the unpadded rows (as Pillow
    reads them): runs of 3 or more (or any 0x80 byte) as 0x80, n - 1, v."""
    h, w = pixels.shape[:2]
    if depth == 1:
        rows = np.packbits(pixels.astype(bool), axis=1)
    elif depth == 4:
        p = np.zeros((h, w + w % 2), np.uint8)
        p[:, :w] = pixels
        rows = (p[:, 0::2] << 4 | p[:, 1::2]).astype(np.uint8)
    else:
        rows = pixels.reshape(h, -1).astype(np.uint8)
    stride = ((w * depth + 15) // 16) * 2
    pal = b"" if palette is None else np.asarray(palette, np.uint8).T.tobytes()
    if kind == 2:
        flat = rows.reshape(-1).tobytes()
        out, i = bytearray(), 0
        while i < len(flat):
            n = 1
            while i + n < len(flat) and flat[i + n] == flat[i] and n < 256:
                n += 1
            if n >= 3 or flat[i] == 0x80:
                if n == 1:
                    out += b"\x80\x00"
                else:
                    out += bytes([0x80, n - 1, flat[i]])
            else:
                out += bytes([flat[i]])
                n = 1
            i += n
        data = bytes(out)
    else:
        padded = np.zeros((h, stride), np.uint8)
        padded[:, :rows.shape[1]] = rows
        data = padded.tobytes()
    return (struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind, 1 if pal else 0,
                        len(pal)) + pal + data)


def xpm_file(indices: np.ndarray, palette: np.ndarray, chars: int = 1,
             transparent: bool = False) -> bytes:
    """An X11 pixmap of ``indices`` into ``palette`` (``c #rrggbb`` entries,
    ``chars`` characters a pixel; one more entry ``c None`` when
    ``transparent``, unused)."""
    alphabet = b".#abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+@"
    n = len(palette) + int(transparent)
    keys = [bytes(alphabet[(i // len(alphabet) ** j) % len(alphabet)] for j in range(chars))
            for i in range(n)]
    h, w = indices.shape
    lines = [b"/* XPM */", b"static char *image[] = {",
             b'"%d %d %d %d",' % (w, h, n, chars)]
    for k, rgb in zip(keys, palette):
        lines.append(b'"%s c #%02x%02x%02x",' % ((k,) + tuple(int(v) for v in rgb)))
    if transparent:
        lines.append(b'"%s c None",' % keys[-1])
    lines.append(b"/* pixels */")
    for row in indices:
        lines.append(b'"' + b"".join(keys[i] for i in row) + b'",')
    return b"\n".join(lines) + b"\n};\n"


def tga_rle_runs(indices: np.ndarray, palette: np.ndarray, run: int = 16) -> bytes:
    """A colour-mapped RLE Targa (type 9, 24-bit map, bottom-up) of
    ``indices`` whose rows are runs of ``run`` equal pixels: one run packet
    each (phase 8's 240x320 upload, small enough to commit)."""
    h, w = indices.shape
    runs = indices[::-1, ::run]
    packets = np.stack([np.full(runs.shape, 0x80 | (run - 1), np.uint8), runs], -1)
    head = struct.pack("<BBBHHBHHHHBB", 0, 1, 9, 0, len(palette), 24, 0, 0, w, h, 8, 0)
    return head + np.asarray(palette, np.uint8)[:, ::-1].tobytes() + packets.tobytes()


def raster_fixtures() -> dict:
    """The fixtures of Pillow's other raster formats (netpbm, DIB, TGA,
    PSD, ICO, CUR, SGI, PCX, DCX, QOI, SUN, IM, MSP, XBM, XPM)."""
    out = {}
    rng = np.random.RandomState(90)
    rgb = photo(91, 16, 21)
    grey = photo(92, 17, 23)[:, :, 1]
    bits = photo(93, 19, 29)[:, :, 0] > 128
    pal = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    idx = (photo(94, 15, 18)[:, :, 2] // 16).astype(np.uint8)
    pal256 = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    # netpbm
    out["p1_plain.pbm"] = ppm_plain(bits)
    out["p2_plain_max10.pgm"] = ppm_plain(np.arange(grey.size).reshape(grey.shape) % 11,
                                          maxval=10)
    out["p3_plain.ppm"] = ppm_plain(rgb[:9, :11])
    out["p4.pbm"] = pillow_save(Image.fromarray(bits), "PPM")
    out["p5.pgm"] = pillow_save(grey, "PPM")
    out["p5_16bit.pgm"] = pillow_save((grey.astype(np.int32) * 257 // 2), "PPM", "I")
    out["p5_max1000.pgm"] = (b"P5\n%d %d\n1000\n" % grey.shape[::-1]
                             + (grey.astype(">u2") * 3).tobytes())
    out["p6.ppm"] = pillow_save(rgb, "PPM")
    out["p6_max4095.ppm"] = (b"P6\n# 12-bit samples\n%d %d\n4095\n" % rgb.shape[1::-1]
                             + (rgb.astype(">u2") * 16 + 7).tobytes())
    out["pf_le.pfm"] = pillow_save(Image.fromarray(grey.astype(np.float32) * 0.9 - 10), "PPM")
    out["pf_be.pfm"] = pfm(grey.astype(np.float32) * 1.3 + 0.5, scale=2.5)
    # DIB
    out["rgb.dib"] = pillow_save(rgb, "DIB")
    out["p4.dib"] = dib_bytes(idx, 4, pal)
    # Targa
    out["rgb.tga"] = pillow_save(rgb, "TGA")
    out["rgb_rle_top.tga"] = pillow_save(rgb, "TGA", rle=True, orientation=1)
    out["l_rle.tga"] = pillow_save(grey, "TGA", rle=True)
    out["p_rle.tga"] = tga_file(idx, 1, 8, palette=pal[:, ::-1], rle=True,
                                id_field=b"make_fixtures")
    out["cmap16.tga"] = tga_file(idx, 1, 8, rng.randint(0, 256, (16, 2)), map_depth=16,
                                 map_start=2, origin=0x20)
    out["cmap24_mirrored.tga"] = tga_file(idx, 1, 8, rng.randint(0, 256, (16, 3)),
                                          map_depth=24, origin=0x10)
    out["rgb16.tga"] = tga_file(rng.randint(0, 256, (13, 17, 2)).astype(np.uint8), 2, 16)
    out["rgba32_rle.tga"] = tga_file(np.repeat(rgb[:, :, None, :1], 4, 2).reshape(
        rgb.shape[0], rgb.shape[1], 4) // 32 * 32, 2, 32, rle=True, origin=0x30)
    out["bilevel.tga"] = tga_file(bits, 3, 1)
    photo240 = photo(98, 240, 320)
    blocks = (photo240[::16, ::16] // 64).astype(np.int64)
    codes = blocks[..., 0] * 16 + blocks[..., 1] * 4 + blocks[..., 2]
    levels = np.array([32, 96, 160, 224], np.uint8)
    pal64 = np.stack([levels[np.arange(64) // 16], levels[np.arange(64) // 4 % 4],
                      levels[np.arange(64) % 4]], -1)
    out["cmap_rle_240x320.tga"] = tga_rle_runs(
        np.kron(codes, np.ones((16, 16), np.int64)).astype(np.uint8), pal64)
    # PSD
    res = psd_resource(1005, b"", bytes(16)) + psd_resource(1039, b"icc", b"\1\2\3")
    planes = [rgb[:, :, i] for i in range(3)]
    out["rgb_raw.psd"] = psd_file(planes, 8, 3, 0, resources=res)
    out["rgb_rle.psd"] = psd_file([p // 8 * 8 for p in planes], 8, 3, 1,
                                  layers=struct.pack(">I", 0) + bytes(8))
    out["rgba_rle.psd"] = psd_file([p // 16 * 16 for p in planes] + [grey[:16, :21]], 8, 3, 1)
    out["l_rle.psd"] = psd_file([grey // 4 * 4], 8, 1, 1)
    out["p_raw.psd"] = psd_file([idx], 8, 2, 0, palette=np.concatenate([pal, pal256[16:]]))
    out["cmyk_rle.psd"] = psd_file([p // 16 * 16 for p in planes] + [grey[:16, :21] // 32],
                                   8, 4, 1)
    out["bitmap.psd"] = psd_file([np.packbits(bits[:, :24], axis=1)], 1, 0, 1)
    # ICO and CUR
    big = photo(95, 24, 24)
    ico = Image.fromarray(big)
    out["png.ico"] = pillow_save(ico, "ICO", sizes=[(16, 16), (24, 24)])
    out["bmp.ico"] = pillow_save(ico, "ICO", sizes=[(16, 16), (24, 24)], bitmap_format="bmp")
    out["p.ico"] = pillow_save(Image.fromarray(big).convert("P", palette=Image.Palette.ADAPTIVE,
                                                            colors=16), "ICO",
                               sizes=[(24, 24)], bitmap_format="bmp")
    out["two.cur"] = cur_file([photo(96, 9, 8), photo(97, 15, 13)])
    # SGI
    out["rgb.sgi"] = pillow_save(rgb, "SGI")
    out["l16.sgi"] = pillow_save(grey, "SGI", bpc=2)
    out["rgba_rle.sgi"] = sgi_rle_file(np.concatenate([rgb // 16 * 16, grey[:16, :21, None]],
                                                      2))
    out["l_rle16.sgi"] = sgi_rle_file(grey // 8 * 8, bpc=2)
    # PCX and DCX
    out["rgb.pcx"] = pillow_save(rgb, "PCX")
    out["l_odd.pcx"] = pillow_save(grey, "PCX")
    out["p.pcx"] = pillow_save(Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                                            colors=40), "PCX")
    out["bilevel.pcx"] = pillow_save(Image.fromarray(bits), "PCX")
    out["p4_planes.pcx"] = pcx_planes(idx, 4, pal)
    out["two_pages.dcx"] = dcx_file([pillow_save(rgb[:, :20], "PCX"),
                                     pillow_save(grey[:, :17], "PCX")])
    # QOI
    out["rgb.qoi"] = pillow_save(rgb // 4 * 4, "QOI")
    out["rgba.qoi"] = pillow_save(np.concatenate([rgb, grey[:16, :21, None] // 64 * 64], 2),
                                  "QOI", "RGBA")
    # Sun raster
    out["bgr.ras"] = sun_file(rgb[:, :, ::-1], 24)
    out["rgbx_rle.ras"] = sun_file(np.concatenate([rgb // 32 * 32, rgb[:, :, :1]], 2), 32, 3)
    out["p8_rle.ras"] = sun_file(idx, 8, 2, palette=pal)
    out["bilevel.ras"] = sun_file(bits, 1)
    out["grey4.ras"] = sun_file(idx, 4)
    # IM
    out["rgb.im"] = pillow_save(rgb, "IM")
    out["l.im"] = pillow_save(grey, "IM")
    out["p.im"] = pillow_save(_with_palette(Image.fromarray(idx, "L"), pal), "IM")
    out["f.im"] = pillow_save(Image.fromarray(grey.astype(np.float32) * 1.5 - 30), "IM")
    out["i16.im"] = pillow_save(Image.fromarray(grey.astype(np.uint16) * 3), "IM")
    # MSP, XBM, XPM
    out["v1.msp"] = pillow_save(Image.fromarray(bits), "MSP")
    rows = bits.copy()
    rows[3] = True
    out["v2.msp"] = msp2_file(rows)
    out["odd.xbm"] = pillow_save(Image.fromarray(bits), "XBM")
    out["one_char.xpm"] = xpm_file(idx, pal, transparent=True)
    out["two_chars.xpm"] = xpm_file(idx * 5 % 70, pal256[:70], chars=2)
    return out


def _with_palette(im, palette):
    im = im.convert("P")
    im.putpalette(np.asarray(palette, np.uint8).tobytes())
    return im


def fixtures() -> dict:
    """{file name: bytes}."""
    out = {}

    def jpeg(name, img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", **kw)
        out[name] = buf.getvalue()

    def png(name, im, **kw):
        buf = io.BytesIO()
        im.save(buf, format="PNG", **kw)
        out[name] = buf.getvalue()

    small = photo(1, 96, 128)
    jpeg("baseline_444_q75.jpg", small, quality=75, subsampling=0)
    jpeg("baseline_422_q75.jpg", small, quality=75, subsampling=1)
    jpeg("baseline_420_q10.jpg", small, quality=10)
    jpeg("baseline_420_q75.jpg", small, quality=75)
    jpeg("baseline_420_q95_480x640.jpg", photo(2, 480, 640), quality=95)
    jpeg("optimize_q75.jpg", small, quality=75, optimize=True)
    jpeg("progressive_q75.jpg", photo(3, 120, 160), quality=75,
         progressive=True)
    jpeg("restart_q75.jpg", small, quality=75, restart_marker_blocks=3)
    jpeg("gray_q75.jpg", photo(4, 90, 130)[:, :, 1], quality=75)
    jpeg("odd_481x641_q90.jpg", photo(5, 481, 641), quality=90)
    jpeg("adobe_rgb_q75.jpg", small, quality=75, keep_rgb=True)
    rgba = np.concatenate([photo(6, 48, 72), photo(7, 48, 72)[:, :, :1]], 2)
    base = Image.fromarray(rgba, "RGBA")
    png("l.png", base.convert("L"))
    png("la.png", base.convert("LA"))
    png("rgb.png", base.convert("RGB"))
    png("rgba.png", base)
    for bits in (1, 2, 4, 8):
        pal = base.convert("RGB").quantize(colors=2 ** bits)
        png(f"p{bits}.png", pal, bits=bits)
    out["adam7_rgb.png"] = adam7_png(photo(8, 37, 45))

    # CMYK / YCCK JPEG, 16-bit PNG
    cmyk = Image.fromarray(photo(60, 72, 96)).convert("CMYK")
    for name, kw in (("cmyk_q75.jpg", {}), ("cmyk_progressive_q75.jpg",
                                          {"progressive": True})):
        buf = io.BytesIO()
        cmyk.save(buf, format="JPEG", quality=75, **kw)
        out[name] = buf.getvalue()
    ycck = photo(61, 120, 160)
    out["ycck_q75.jpg"] = ycck_jpeg(ycck_planes(ycck, photo(62, 120, 160)[..., 2]))
    wide = (photo(63, 30, 41).astype(np.uint16) * 257
            + np.random.RandomState(64).randint(0, 257, (30, 41, 3)).astype(np.uint16))
    grey16 = Image.fromarray((wide[..., 0] // 64).astype(np.uint16))
    png("i16.png", grey16)
    out["rgb48.png"] = png16(wide, 2)
    out["rgba64_adam7.png"] = png16(np.concatenate([wide, wide[..., :1]], 2), 6,
                                    interlace=1)
    out["la16.png"] = png16(wide[..., :2], 4)

    # GIF
    def gif(name, im, **kw):
        buf = io.BytesIO()
        im.save(buf, format="GIF", **kw)
        out[name] = buf.getvalue()

    gif_src = Image.fromarray(photo(65, 50, 70))
    gif("p.gif", gif_src.quantize(64), interlace=0)
    gif("p_interlaced.gif", gif_src.quantize(64))
    gif("l.gif", gif_src.convert("L"), interlace=0, optimize=False)
    gif("l_interlaced.gif", gif_src.convert("L"), optimize=False)
    idx = np.random.RandomState(66).randint(0, 24, (21, 30)).astype(np.uint8)
    pal = np.random.RandomState(67).randint(0, 256, (16, 3)).astype(np.uint8)
    out["short_palette.gif"] = gif_file(
        idx, screen=(40, 28), offset=(5, 3), global_pal=pal[:4],
        local_pal=pal, transparency=7, min_bits=5, interlace=True)

    # BMP
    def bmp(name, im):
        buf = io.BytesIO()
        im.save(buf, format="BMP")
        out[name] = buf.getvalue()

    bmp_src = Image.fromarray(photo(68, 37, 51))
    bmp("1.bmp", bmp_src.convert("1"))
    bmp("l.bmp", bmp_src.convert("L"))
    bmp("p.bmp", bmp_src.quantize(100))
    bmp("rgb.bmp", bmp_src)
    bmp("rgba.bmp", Image.fromarray(np.concatenate(
        [photo(68, 37, 51), photo(69, 37, 51)[..., :1]], 2)))
    rng = np.random.RandomState(70)
    blocky = np.kron(rng.randint(0, 16, (9, 13)), np.ones((4, 4), int))[:35, :49]
    blocky[::5, ::7] = rng.randint(0, 16, blocky[::5, ::7].shape)
    pal16 = rng.randint(0, 256, (16, 3))
    pal256 = rng.randint(0, 256, (256, 3))
    out["rle8.bmp"] = bmp_file((blocky * 13 % 256).astype(np.uint8), 8, pal256,
                               compression=1)
    out["rle4.bmp"] = bmp_file(blocky.astype(np.uint8), 4, pal16, compression=2)
    rgb = photo(71, 23, 29)
    out["bitfields565.bmp"] = bmp_file(rgb, 16, compression=3, header=124,
                                       masks=(0xF800, 0x7E0, 0x1F))
    out["bitfields555.bmp"] = bmp_file(rgb, 16, compression=3, header=108,
                                       masks=(0x7C00, 0x3E0, 0x1F))
    out["top_down.bmp"] = bmp_file(photo(72, 19, 27), 24, top_down=True)
    out["core4.bmp"] = bmp_file(blocky[:17, :23].astype(np.uint8), 4, pal16,
                                header=12)
    out.update(webp_fixtures())
    out.update(tiff_fixtures())
    out.update(jpeg_fixtures())
    out.update(raster_fixtures())
    return out


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def main() -> dict:
    digests = {}
    files = fixtures()
    for name, data in files.items():
        (HERE / name).write_bytes(data)
        for mode in ("RGB", "L"):
            im = Image.open(io.BytesIO(data)).convert(mode)
            digests[f"{name}:{mode}"] = digest(np.asarray(im))
    total = sum(len(d) for d in files.values())
    print(f"# {len(digests) // 2} files, {total} bytes")
    for k, v in digests.items():
        print(f'    "{k}": "{v}",')
    return digests


if __name__ == "__main__":
    main()
