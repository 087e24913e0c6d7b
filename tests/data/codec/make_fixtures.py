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
no YCCK). PNG: L, LA, RGB, RGBA, P at 1, 2, 4 and 8 bits and I;16
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
