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
headers), a top-down 24-bit file and a BITMAPCOREHEADER 4-bit one.

The writers are also the CPU tests' source of seeded GIF, BMP, YCCK and
16-bit PNG files (``tests/test_torch_image_codec.py`` imports them).
"""
from __future__ import annotations

import hashlib
import io
import struct
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def photo(seed: int, h: int, w: int) -> np.ndarray:
    """A photo-like RGB image: gradients, a few flat discs, mild noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                    128 + 100 * np.sin(x / 17.0) * np.cos(y / 23.0)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 60)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
    img += rng.normal(0, 6, img.shape)
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
