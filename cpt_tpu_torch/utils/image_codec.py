"""Reading and writing image files without Pillow (the port's counterpart
of the ``Image.open(...).convert(...)`` and ``Image.save`` calls the JAX
package makes): JPEG, PNG, GIF, BMP, WEBP and TIFF here, Pillow's other
raster formats (netpbm, DIB, TGA, PSD, ICO, CUR, SGI, PCX, DCX, QOI, Sun
raster, IM, MSP, XBM, XPM) in :mod:`cpt_tpu_torch.utils.raster_formats`.
A file is identified as ``Image.open`` identifies it: Pillow 12.1's 43
formats in its order (:func:`_formats`), each format's prefix test and,
for the formats tried on every file, the header checks of its ``_open``;
a format this codec does not read raises, naming it.

``decode`` gives Pillow 12.1's pixels bit for bit, converted to ``"RGB"``
or ``"L"`` by Pillow's rules: for a JPEG the pixels of libjpeg-turbo
3.1.3's default decompression on x86-64 (Huffman, arithmetic and lossless
coding; the islow IDCT in its SIMD arithmetic; block smoothing of
progressive files left unrefined; fancy upsampling, its fixed-point YCbCr
and YCCK conversions; a CMYK or YCCK file inverted as Pillow unpacks it,
then through its cmyk2rgb; damaged data decoding, or failing, as there),
for a PNG those of Pillow's reader (16-bit
samples: a grey one clipped at 255, colour ones cut to their high byte),
for a GIF its first frame as ``Image.open`` gives it (mode ``P`` or ``L``,
a short palette padded with black, the transparent index left as it is),
for a BMP those of Pillow's BmpImagePlugin (core, info, V4 and V5 headers;
1, 4, 8, 16, 24 and 32 bits; RLE8, RLE4 and the bit fields it takes), for
a WEBP its first frame as libwebp 1.6.0's animation decoder gives it to
Pillow (lossy VP8 with its loop filter, fancy upsampling and fixed-point
YUV conversion; lossless VP8L; an ALPH alpha plane; an ANMF frame on a
transparent black canvas), for a TIFF its first image as TiffImagePlugin
opens it: classic and BigTIFF, either byte order; Pillow's own reader for
uncompressed strips and tiles, libtiff 4.7.1 as Pillow drives it for LZW,
PackBits, Deflate and JPEG (with the horizontal predictor, FillOrder 2,
tiles, separate planes, YCbCr through TIFFRGBAImage or libjpeg-turbo);
1-bit, 2-, 4- and 8-bit grey and palette, 16-bit grey, LA, RGB and RGBA
(associated alpha too) at 8 and 16 bits, CMYK and YCbCr.
``encode_jpeg`` writes the bytes of Pillow's ``save(format="JPEG",
quality=q)`` with default options, ``encode_bmp`` those of
``save(format="BMP")`` and ``encode_tiff`` those of ``save(format="TIFF")``
(``write_image`` those of the PPM, DIB, TGA, SGI, PCX and QOI writers too);
``encode_png`` writes a lossless PNG (its bytes differ from Pillow's, whose
zlib differs from Python's).

The JPEG codec, the PNG row filters, GIF's LZW, BMP's RLE
(``cpt_tpu_torch/csrc/image_codec.cpp``), the WEBP decoders
(``csrc/webp_vp8.cpp``, ``csrc/webp_vp8l.cpp``) and TIFF's LZW, PackBits,
predictor and YCbCr conversion (``csrc/tiff.cpp``) are host C++, built by
``kernels/build.py`` with the host C++ compiler at first use and called
through ``ctypes``; zlib, the RIFF container, the TIFF directories and
the walk over a JPEG's markers that Pillow's ``Image.open`` makes are
Python's. A failed build raises ``KernelError``; a file this module cannot
read (JPEG that Pillow refuses too: hierarchical, precisions other than 8,
arithmetic lossless, MCUs past 10 blocks, arithmetic-coded data past the
65536 bytes Pillow feeds libjpeg at once; TIFF of floating-point, signed
or 12- and 32-bit samples, CIELab, CCITT, old-style JPEG or LZW and other
compressions, other formats, truncated or damaged data) raises
:class:`ImageCodecError` naming its kind, and so does a file whose header
declares more than twice ``MAX_IMAGE_PIXELS`` (Pillow's decompression-bomb
limit), before anything is allocated for it. Nothing falls back to Pillow
or returns a partial image.
"""
from __future__ import annotations

import ctypes
import functools
import os
import struct
import sys
import zlib
from fractions import Fraction
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from cpt_tpu_torch.kernels import build

# The named faults of csrc/image_codec.cpp (bits of its ``fault``
# argument); the codec's checks show each one changes a digest.
FAULTS = {
    "replicate_upsample": 1,     # box replication instead of fancy upsampling
    "float_idct": 2,             # a float IDCT instead of islow
    "refine_no_correction": 4,   # progressive AC refinement drops correction bits
    "float_ycc": 8,              # YCbCr -> RGB in float arithmetic
    "quality_off_by_one": 16,    # quality scaling of q + 1 (encoder)
    "paeth_ties": 32,            # PNG Paeth ties taken by the later predictor
    "cmyk_not_inverted": 64,     # Adobe CMYK samples taken as stored
    "ycck_as_cmyk": 128,         # YCCK samples taken as CMYK
    "gif_late_growth": 256,      # GIF LZW code size grown one code late
    # the Python readers' own
    "sixteen_bit_shift": 512,    # 16-bit grey scaled by >> 8, not clipped
    "bmp_top_down": 1024,        # bottom-up BMP rows read top-down
    # the WEBP decoders' (csrc/webp_vp8.cpp, csrc/webp_vp8l.cpp)
    "webp_no_loop_filter": 2048,           # the VP8 loop filter skipped
    "webp_box_upsample": 4096,             # chroma replicated
    "webp_single_round_upsample": 8192,    # libjpeg's rounding (bias 8 / 7)
    "webp_float_yuv": 16384,               # YUV -> RGB in float arithmetic
    "vp8_top_right": 32768,                # 4x4 top-right from the current MB
    "vp8l_select_swapped": 65536,          # Select takes the other neighbour
    # the TIFF reader's (csrc/tiff.cpp and the Python container)
    "tiff_lzw_late_growth": 131072,        # LZW code width grown one code late
    "tiff_no_predictor": 262144,           # horizontal predictor 2 ignored
    "tiff_jpeg_replicate": 524288,         # JPEG-in-TIFF chroma replicated
    "tiff_colormap_low_byte": 1048576,     # ColorMap entries cut to the low byte
    "tiff_edge_tile_stride": 2097152,      # edge tiles read at their cropped width
    # the JPEG decoder's damaged-data, arithmetic, lossless and smoothing paths
    "c_idct": 4194304,                     # islow in jidctint.c's C arithmetic
    "arith_default_conditioning": 8388608,   # DAC conditioning ignored
    "lossless_left_predictor": 16777216,   # every sample predicted from the left
    "no_block_smoothing": 33554432,        # unrefined progressive blocks not smoothed
    # the readers of Pillow's other raster formats (utils/raster_formats)
    "psd_packbits_short_run": 1 << 32,    # PackBits runs one byte short
    "sgi_rle_table_swapped": 1 << 33,     # the RLE offset table read channel by channel
    "qoi_hash_prime": 1 << 34,            # the index hash's green prime 6, not 5
    "sun_run_exact": 1 << 35,             # a Sun RLE run of n, not n + 1
    "xbm_msb_first": 1 << 36,             # XBM's bits taken MSB first
    "netpbm_truncated_scaling": 1 << 37,  # maxval scaling truncated, not rounded
    "tga_origin_ignored": 1 << 38,        # Targa's origin bits ignored
    "pcx_planes_interleaved": 1 << 39,    # PCX's colour planes read as RGB triples
    "ico_first_entry": 1 << 40,           # ICO's first entry, not Pillow's pick
    "cur_first_entry": 1 << 41,           # CUR's first entry, not its largest
    "dcx_second_page": 1 << 42,           # DCX's second page, not its first
    "im_top_down": 1 << 43,               # IM's rows read top-down
    "msp_blank_rows_black": 1 << 44,      # an empty MSP row black, not white
    "xpm_keys_sorted": 1 << 45,           # XPM palette indices in sorted key order
    "dib_palette_ignored": 1 << 46,       # DIB pixels read right after its header
}

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_QUALITY = 75            # libjpeg's default, which Pillow keeps
PNG_LEVEL = 6                # Pillow's default compress_level
# Pillow's Image.MAX_IMAGE_PIXELS: Image.open refuses a file declaring more
# than twice this many pixels (DecompressionBombError)
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_IP = ctypes.POINTER(ctypes.c_int)
_ERR_LEN = 256


class ImageCodecError(OSError):
    """An image file this codec cannot read or write."""


SIGNATURES = {
    # data, n, width, height, ncomp, out, fault, err, errlen
    "cpt_jpeg_decode": ([_P, _L, _I, _I, _I, _P, _I, _P, _I], _I),
    # pixels, width, height, ncomp, quality, fault, out, cap, err, errlen
    "cpt_jpeg_encode": ([_P, _I, _I, _I, _I, _I, _P, _L, _P, _I], _L),
    # filtered, rows, rowbytes, bpp, fault, out, err, errlen
    "cpt_png_unfilter": ([_P, _L, _L, _I, _I, _P, _P, _I], _I),
    # pixels, rows, rowbytes, bpp, out, err, errlen
    "cpt_png_filter": ([_P, _L, _L, _I, _P, _P, _I], _I),
    # data, n, min_bits, out, npix, fault, err, errlen
    "cpt_gif_lzw": ([_P, _L, _I, _P, _L, _I, _P, _I], _L),
    # data, n, start, rle4, xsize, ysize, out, cap, err, errlen
    "cpt_bmp_rle": ([_P, _L, _L, _I, _L, _L, _P, _L, _P, _I], _L),
    # data, n, width, height, fault, out, err, errlen
    "cpt_webp_lossy": ([_P, _L, _I, _I, _I, _P, _P, _I], _I),
    # data, n, alpha, width, height, fault, out, err, errlen
    "cpt_webp_lossless": ([_P, _L, _I, _I, _I, _I, _P, _P, _I], _I),
    # tables, ntables, data, n, info, err, errlen
    "cpt_jpeg_frame_tiff": ([_P, _L, _P, _L, _IP, _P, _I], _I),
    # tables, ntables, data, n, to_rgb, out, fault, err, errlen
    "cpt_jpeg_decode_tiff": ([_P, _L, _P, _L, _I, _P, _I, _P, _I], _I),
    # cmyk, n, out
    "cpt_cmyk_to_rgb": ([_P, _L, _P], _L),
    # data, n, out, occ, fault, err, errlen
    "cpt_tiff_lzw": ([_P, _L, _P, _L, _I, _P, _I], _L),
    # data, n, out, occ, err, errlen
    "cpt_tiff_packbits": ([_P, _L, _P, _L, _P, _I], _L),
    # buf, rows, rowbytes, stride, bytes, swap, err, errlen
    "cpt_tiff_unpredict": ([_P, _L, _L, _I, _I, _I, _P, _I], _L),
    # buf, n
    "cpt_tiff_reverse_bits": ([_P, _L], _L),
    # packed, blocks_per_row, hs, vs, width, rows, coeffs, rbw, out, err, errlen
    "cpt_tiff_ycbcr": ([_P, _L, _I, _I, _L, _L, _P, _P, _P, _P, _I], _L),
}
LIBRARY = build.Library(build.build_host, SIGNATURES)


def _lib():
    return LIBRARY.get()


def _ptr(a) -> int:
    if isinstance(a, np.ndarray):
        return a.ctypes.data
    return ctypes.cast(ctypes.c_char_p(a), ctypes.c_void_p).value


def _check(status: int, err) -> None:
    if status < 0:
        raise ImageCodecError(err.value.decode(errors="replace"))


def _check_size(w: int, h: int) -> None:
    """Pillow's decompression-bomb refusal (the C++ makes it for a JPEG)."""
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise ImageCodecError(
            f"image size ({w * h} pixels) exceeds limit of "
            f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb "
            f"DOS attack")


# ------------------------------------------------------------------ JPEG

_SOF_MARKERS = frozenset((0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                          0xCB, 0xCD, 0xCE, 0xCF, 0xDE))
_SKIPPED_MARKERS = frozenset((0xC4, 0xCC, 0xDA, 0xDC, 0xDD, 0xDF))
_BARE_MARKERS = frozenset((0xC8, *range(0xD0, 0xDA), *range(0xF0, 0xFE)))


def _jpeg_open(data: bytes) -> Tuple[int, int, int]:
    """(width, height, layers) as ``Image.open`` reads a JPEG: Pillow 12.1's
    JpegImagePlugin walks the markers up to the first SOS itself (a marker
    it does not know, a short segment, a quantisation table cut short, a
    frame header of other than 8 bits or 1, 3 or 4 layers, a short JFIF,
    Adobe or Photoshop segment or ICC_PROFILE chunk raise), keeps its last
    frame header, and refuses an empty size or a decompression bomb. Raises
    where ``Image.open`` raises; EXIF and MPF contents, which Pillow parses
    further, are not read."""
    def broken(why: str):
        raise ImageCodecError(f"cannot identify image file (JPEG: {why})")

    pos = 3
    size, layers, icc = None, 0, []

    def read(k: int) -> bytes:
        nonlocal pos
        out = data[pos:pos + k]
        pos += len(out)
        return out

    def i16(b: bytes, at: int = 0) -> int:
        if len(b) < at + 2:
            broken("a marker segment is cut short")
        return (b[at] << 8) | b[at + 1]

    def i32(b: bytes, at: int) -> int:
        return struct.unpack_from(">I", b, at)[0]

    def segment() -> bytes:
        n = i16(read(2)) - 2
        if n <= 0:
            return b""
        out = read(n)
        if len(out) < n:
            broken("Truncated File Read")
        return out

    s = b"\xff"
    while True:
        if not s:
            broken("the data ends before a scan")
        if s[0] != 0xFF:
            s = read(1)
            continue
        s = s + read(1)
        i = i16(s)
        marker = i & 0xFF
        if i >> 8 != 0xFF or i == 0xFFFF:
            s = b"\xff"
            continue
        if marker in _SOF_MARKERS:
            body = segment()
            if len(body) < 5:
                broken("a frame header is cut short")
            size = (i16(body, 3), i16(body, 1))
            if body[0] != 8:
                broken(f"cannot handle {body[0]}-bit layers")
            if len(body) < 6:
                broken("a frame header is cut short")
            layers = body[5]
            if layers not in (1, 3, 4):
                broken(f"cannot handle {layers}-layer images")
            if icc:
                icc.sort()
                if len(icc[0]) < 14:
                    broken("an ICC_PROFILE chunk is cut short")
                icc = []
            if (len(body) - 6) % 3:
                broken("a frame header's last component is cut short")
        elif marker in _SKIPPED_MARKERS:
            segment()
            if marker == 0xDA:
                break
        elif marker == 0xDB:
            body = segment()
            while body:
                length = 1 + (64 if body[0] < 16 else 128)
                if len(body) < length:
                    broken("bad quantization table marker")
                body = body[length:]
        elif 0xE0 <= marker <= 0xEF:
            body = segment()
            if marker == 0xE0 and body.startswith(b"JFIF"):
                i16(body, 5)
            elif marker == 0xEE and body.startswith(b"Adobe"):
                i16(body, 5)
            elif marker == 0xE2 and body.startswith(b"ICC_PROFILE\0"):
                icc.append(body)
            elif marker == 0xED and body.startswith(b"Photoshop 3.0\x00"):
                at = 14
                try:
                    while body[at:at + 4] == b"8BIM":
                        at += 4
                        code = struct.unpack_from(">H", body, at)[0]
                        at += 2
                        if at >= len(body):
                            broken("a Photoshop resource is cut short")
                        at += 1 + body[at]
                        at += at & 1
                        n = i32(body, at)
                        at += 4
                        block = body[at:at + n]
                        if code == 0x03ED:
                            struct.unpack_from(">IHHIH", block)
                        at += n + ((at + n) & 1)
                except struct.error:
                    pass
        elif marker == 0xFE:
            segment()
        elif marker in _BARE_MARKERS:
            pass
        elif marker == 0:
            s = read(1)
            continue
        else:
            broken("no marker found")
        s = read(1)
    if size is None or size[0] <= 0 or size[1] <= 0:
        broken("no frame header before the scan")
    _check_size(*size)
    return size[0], size[1], layers


def _decode_jpeg(data: bytes, fault: int) -> np.ndarray:
    """[H, W] (one component) or [H, W, 3] RGB (three; four, CMYK or YCCK,
    converted as Pillow's ``convert("RGB")`` does)."""
    w, h, c = _jpeg_open(data)
    out = np.empty((h, w) if c == 1 else (h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_lib().cpt_jpeg_decode(_ptr(data), len(data), w, h, c, _ptr(out), fault,
                                  err, _ERR_LEN), err)
    return out


def encode_jpeg(arr: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """The bytes of ``Image.fromarray(arr).save(f, format="JPEG",
    quality=quality)`` for a uint8 ``[H, W]`` (L) or ``[H, W, 3]`` (RGB)
    array: baseline, JFIF, 4:2:0 for RGB, the standard Huffman tables."""
    return _encode_jpeg(arr, quality, 0)


def _encode_jpeg(arr: np.ndarray, quality: int, fault: int) -> bytes:
    """:func:`encode_jpeg` with ``fault`` (bits of FAULTS) set in the C++."""
    px = np.ascontiguousarray(arr, np.uint8)
    if px.ndim == 3 and px.shape[2] == 1:
        px = np.ascontiguousarray(px[:, :, 0])
    if px.ndim not in (2, 3) or (px.ndim == 3 and px.shape[2] != 3):
        raise ImageCodecError(f"JPEG encoder takes [H, W] or [H, W, 3] "
                              f"arrays, got shape {tuple(np.shape(arr))}")
    h, w = px.shape[:2]
    ncomp = 1 if px.ndim == 2 else 3
    err = ctypes.create_string_buffer(_ERR_LEN)
    cap = h * w * ncomp + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = _lib().cpt_jpeg_encode(_ptr(px), w, h, ncomp, int(quality), fault,
                                   _ptr(out), cap, err, _ERR_LEN)
        _check(n, err)
        if n <= cap:
            return out[:n].tobytes()
        cap = n


# ------------------------------------------------------------------- PNG

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))   # x0, y0, dx, dy


def _png_chunks(data: bytes):
    if not data.startswith(PNG_SIGNATURE):
        raise ImageCodecError("not a PNG file")
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ImageCodecError("truncated PNG file (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ImageCodecError("truncated PNG file (data ends inside a "
                                  f"{ctype.decode(errors='replace')} chunk)")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(body, zlib.crc32(ctype)) != crc:
            raise ImageCodecError("broken PNG file (bad checksum in "
                                  f"{ctype.decode(errors='replace')})")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def _png_header(data: bytes) -> dict:
    for ctype, body in _png_chunks(data):
        if ctype != b"IHDR" or len(body) != 13:
            raise ImageCodecError("broken PNG file (no IHDR first)")
        w, h, depth, ctype_, comp, filt, interlace = struct.unpack(
            ">IIBBBBB", body)
        _check_size(w, h)
        return {"width": w, "height": h, "depth": depth, "color": ctype_,
                "interlace": interlace, "comp": comp, "filter": filt}
    raise ImageCodecError("broken PNG file (no IHDR)")


def _unfilter(raw: memoryview, rows: int, rowbytes: int, bpp: int,
              fault: int) -> np.ndarray:
    out = np.empty((rows, rowbytes), np.uint8)
    if rows == 0 or rowbytes == 0:
        return out
    src = np.frombuffer(raw, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_lib().cpt_png_unfilter(_ptr(src), rows, rowbytes, bpp, fault,
                                   _ptr(out), err, _ERR_LEN), err)
    return out


def _unpack(rows: np.ndarray, width: int, depth: int,
            channels: int) -> np.ndarray:
    """Unfiltered row bytes → [h, width, channels] samples (uint8; uint16
    at depth 16)."""
    if depth == 8:
        return rows[:, :width * channels].reshape(len(rows), width, channels)
    if depth == 16:
        return (rows[:, :width * channels * 2].reshape(len(rows), -1).view(">u2")
                .reshape(len(rows), width, channels))
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    bits = bits.reshape(len(rows), width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :, None]


def _decode_png(data: bytes, fault: int) -> Tuple[np.ndarray, str, object]:
    """→ (samples [H, W, channels], Pillow's mode, palette [n, 3] or None);
    16-bit samples as Pillow unpacks them: grey (mode ``I;16``) clipped at
    255 by its ``convert``, the colour types' high bytes (``*;16B``)."""
    hdr = _png_header(data)
    w, h, depth, color = (hdr["width"], hdr["height"], hdr["depth"],
                          hdr["color"])
    if color not in _PNG_CHANNELS or not (
            depth == 8 or (depth == 16 and color != 3)
            or (color in (0, 3) and depth in (1, 2, 4))):
        raise ImageCodecError(f"PNG of colour type {color} at bit depth "
                              f"{depth} is not supported")
    if hdr["comp"] != 0 or hdr["filter"] != 0 or hdr["interlace"] > 1:
        raise ImageCodecError("PNG with an unknown compression, filter or "
                              "interlace method")
    if w == 0 or h == 0:
        raise ImageCodecError("PNG with an empty image")
    channels = _PNG_CHANNELS[color]
    idat, palette = [], None
    for ctype, body in _png_chunks(data):
        if ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3],
                                    np.uint8).reshape(-1, 3)
    if color == 3 and palette is None:
        raise ImageCodecError("broken PNG file (palette image without PLTE)")
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageCodecError(f"broken PNG file (image data: {e})") from None
    bpp = max(1, channels * depth // 8)
    if hdr["interlace"] == 0:
        passes = [(0, 0, 1, 1)]
    else:
        passes = _ADAM7
    samples = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    view, at = memoryview(raw), 0
    for x0, y0, dx, dy in passes:
        pw = (w - x0 + dx - 1) // dx if w > x0 else 0
        ph = (h - y0 + dy - 1) // dy if h > y0 else 0
        if pw == 0 or ph == 0:
            continue
        rowbytes = (pw * channels * depth + 7) // 8
        size = ph * (rowbytes + 1)
        if at + size > len(raw):
            raise ImageCodecError("truncated PNG file (image data too short)")
        rows = _unfilter(view[at:at + size], ph, rowbytes, bpp, fault)
        at += size
        samples[y0::dy, x0::dx] = _unpack(rows, pw, depth, channels)
    if depth == 16:
        if color == 0:
            grey = samples[:, :, 0]
            grey = (grey >> 8 if fault & FAULTS["sixteen_bit_shift"]
                    else np.minimum(grey, 255))
            return grey.astype(np.uint8), "L", None
        samples = (samples >> 8).astype(np.uint8)
    if color == 0:
        if depth == 1:
            return samples[:, :, 0] * np.uint8(255), "1", None
        scale = {2: 85, 4: 17, 8: 1}[depth]
        return samples[:, :, 0] * np.uint8(scale), "L", None
    mode = {2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}[color]
    return (samples[:, :, 0] if color == 3 else samples), mode, palette


def _palette_table(palette: np.ndarray) -> np.ndarray:
    """Pillow's 256-entry palette: the file's entries, then black."""
    table = np.zeros((256, 3), np.uint8)
    if palette is not None:
        table[:min(256, len(palette))] = palette[:256]
    return table


def _rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """Pillow's ``rgb2l``: ITU-R 601-2 luma in 16-bit fixed point."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _convert(arr: np.ndarray, src: str, mode: str,
             palette=None) -> np.ndarray:
    """``Image.convert(mode)`` for the modes the readers produce ("L;P":
    a GIF's mode L image holding a palette, see :func:`_gif_header`): a
    palette image through its palette (entries past the file's black),
    ``1`` as 0 / 255, 32-bit integers (``I``) clipped to 0 .. 255, floats
    (``F``) truncated and clipped (NaN 0), CMYK through Pillow's cmyk2rgb,
    alpha and padding bands dropped."""
    if src == "L;P":
        if mode == "L":
            return arr
        src = "P"
    if src == "PA":
        arr, src = arr[..., 0], "P"
    if src == "P":
        arr, src = _palette_table(palette)[arr], "RGB"
    if src == "1":
        src = "L"
    if src == "I":
        arr, src = np.clip(arr, 0, 255).astype(np.uint8), "L"
    if src == "F":
        with np.errstate(invalid="ignore"):
            arr = np.where(np.isnan(arr), 0, np.clip(arr, 0, 255)).astype(np.uint8)
        src = "L"
    if src == "CMYK":
        rgb = np.empty(arr.shape[:2] + (3,), np.uint8)
        _lib().cpt_cmyk_to_rgb(_ptr(np.ascontiguousarray(arr)),
                               arr.shape[0] * arr.shape[1], _ptr(rgb))
        arr, src = rgb, "RGB"
    if src in ("LA", "RGBA", "RGBX"):
        arr, src = arr[..., :-1], src[:-1]
        if src == "L":
            arr = arr[..., 0]
    if mode == "RGB":
        if src == "L":
            return np.repeat(arr[..., None], 3, axis=2)
        return np.ascontiguousarray(arr)
    if mode == "L":
        return arr if src == "L" else _rgb_to_l(arr)
    raise ImageCodecError(f"decode gives mode 'RGB' or 'L', not {mode!r}")


def encode_png(arr: np.ndarray) -> bytes:
    """A lossless PNG of a uint8 ``[H, W]`` (L) or ``[H, W, 3]`` (RGB)
    array: adaptive row filters, zlib level 6."""
    px = np.ascontiguousarray(arr, np.uint8)
    if px.ndim == 2:
        px = px[:, :, None]
    color = {1: 0, 3: 2}.get(px.shape[2] if px.ndim == 3 else 0)
    if px.ndim != 3 or color is None:
        raise ImageCodecError(f"PNG encoder takes [H, W] or [H, W, 3] "
                              f"arrays, got {tuple(np.shape(arr))}")
    h, w, c = px.shape
    rowbytes = w * c
    filtered = np.empty((h, rowbytes + 1), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_lib().cpt_png_filter(_ptr(px), h, rowbytes, c, _ptr(filtered),
                                 err, _ERR_LEN), err)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(filtered.tobytes(), PNG_LEVEL))
            + chunk(b"IEND", b""))


# ------------------------------------------------------------------- GIF

def _gif_blocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The data sub-blocks from ``pos`` joined, and the position after
    their terminator (the file may end first, as Pillow reads it)."""
    parts = []
    while pos < len(data) and data[pos]:
        parts.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    return b"".join(parts), pos + 1


def _gif_palette(data: bytes, pos: int, flags: int):
    """(palette [n, 3] or None when the table is grey 0, 1, 2, ... (Pillow's
    ``_is_palette_needed``: mode L), the position after the table)."""
    n = 3 << ((flags & 7) + 1)
    table = data[pos:pos + n]
    pal = np.frombuffer(table[:len(table) // 3 * 3], np.uint8).reshape(-1, 3)
    grey = np.arange(len(pal))[:, None]
    identity = len(table) % 3 == 0 and bool((pal == grey).all())
    return (None if identity else pal), pos + n


def _gif_header(data: bytes) -> dict:
    """The first frame as GifImagePlugin's ``_seek(0)`` finds it: the image
    size (the screen's, grown to hold the frame), the frame box, its
    palette (local, else global; a table that is grey 0, 1, 2, ... counts
    as none) and mode, interlace, transparent index, LZW code size and the
    offset of its data."""
    if len(data) < 13:
        raise ImageCodecError("truncated GIF file (no screen descriptor)")
    sw, sh, flags = struct.unpack("<HHB", data[6:11])
    pos, global_pal = 13, None
    if flags & 0x80:
        global_pal, pos = _gif_palette(data, pos, flags)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ImageCodecError("broken GIF file (no image in its first "
                                  "frame)")
        kind = data[pos]
        pos += 1
        if kind == 0x21:                                   # extension
            if pos >= len(data):
                continue
            label = data[pos]
            pos += 1
            if (label == 0xF9 and pos < len(data) and data[pos] >= 4
                    and data[pos + 1] & 1):
                transparency = data[pos + 4]
            _, pos = _gif_blocks(data, pos)
        elif kind == 0x2C:                                 # image descriptor
            if pos + 10 > len(data):
                raise ImageCodecError("truncated GIF file (data ends inside "
                                      "an image descriptor)")
            x0, y0, w, h, lflags = struct.unpack("<HHHHB", data[pos:pos + 9])
            pos += 9
            pal, mode = global_pal, ("L" if global_pal is None else "P")
            if lflags & 0x80:
                local, pos = _gif_palette(data, pos, lflags)
                # a grey local table: Pillow opens the frame as mode L, then
                # loads the global palette into it, which its convert("RGB")
                # applies and its convert("L") does not (mode "L;P" here)
                pal = global_pal if local is None else local
                mode = ("L" if local is None and global_pal is None else
                        "L;P" if local is None else "P")
            if pos >= len(data):
                raise ImageCodecError("truncated GIF file (no image data)")
            size = (max(sw, x0 + w), max(sh, y0 + h))
            _check_size(*size)
            return {"size": size, "box": (x0, y0, w, h), "palette": pal,
                    "mode": mode, "interlace": bool(lflags & 0x40),
                    "transparency": transparency, "min_bits": data[pos],
                    "at": pos + 1}


def _decode_gif(data: bytes, fault: int) -> Tuple[np.ndarray, str, object]:
    """The first frame → (indices [H, W], "P", "L" or "L;P", palette or
    None): outside the frame the transparent index (else 0), as Pillow
    fills it."""
    hdr = _gif_header(data)
    (W, H), (x0, y0, w, h) = hdr["size"], hdr["box"]
    codes, _ = _gif_blocks(data, hdr["at"])
    frame = np.empty(w * h, np.uint8)
    if frame.size:
        err = ctypes.create_string_buffer(_ERR_LEN)
        src = np.frombuffer(codes, np.uint8)
        n = _lib().cpt_gif_lzw(_ptr(src) if src.size else None, src.size,
                               hdr["min_bits"], _ptr(frame), frame.size, fault,
                               err, _ERR_LEN)
        _check(n, err)
        if n < frame.size:
            raise ImageCodecError(f"truncated GIF file (image data gives {n} "
                                  f"of {frame.size} pixels)")
    frame = frame.reshape(h, w)
    if hdr["interlace"]:
        rows = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                               np.arange(2, h, 4), np.arange(1, h, 2)])
        out = np.empty_like(frame)
        out[rows] = frame
        frame = out
    canvas = np.full((H, W), hdr["transparency"] or 0, np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = frame
    return canvas, hdr["mode"], hdr["palette"]


# ------------------------------------------------------------------- BMP

# BmpImagePlugin's bit fields (mask → Pillow's raw mode) and each raw mode's
# bytes of R, G and B in a 32-bit pixel
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_BMP_RGB_BYTES = {"BGRX": (2, 1, 0), "XBGR": (3, 2, 1), "BGXR": (3, 1, 0),
                  "ABGR": (3, 2, 1), "RGBA": (0, 1, 2), "BGRA": (2, 1, 0),
                  "BGAR": (3, 1, 0), "BGR": (2, 1, 0)}
_BMP_RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}
_BMP_BITS = {"P;1": 1, "1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16,
             "BGR;16": 16, "BGR": 24}


def _bmp_header(data: bytes, at: int = 14, offset: Optional[int] = None) -> dict:
    """BmpImagePlugin's ``_bitmap`` of the header at ``at`` (14: a BMP file,
    whose file header gives the pixels' offset; else, with ``offset`` 0, a
    DIB, an icon's or a cursor's bitmap, its pixels right after the header,
    bit fields and palette): the size, Pillow's mode and raw mode, the
    palette, the row stride and direction, the compression and the offset
    of the pixels."""
    def u32(at: int) -> int:
        return struct.unpack_from("<I", data, at)[0]

    def u16(at: int) -> int:
        return struct.unpack_from("<H", data, at)[0]

    if len(data) < at + 4:
        raise ImageCodecError("truncated BMP file (no header)")
    if offset is None:
        offset = u32(10)
    size = u32(at)
    if len(data) < at + size:
        raise ImageCodecError("truncated BMP file (data ends inside its "
                              "header)")
    pos = at + size
    colors = 0
    if size == 12:
        w, h, bits, compression, pad, direction = (u16(at + 4), u16(at + 6),
                                                   u16(at + 10), 0, 3, -1)
    elif size in (40, 52, 56, 64, 108, 124):
        flip = data[at + 11] == 0xFF
        w, h = u32(at + 4), (2 ** 32 - u32(at + 8) if flip else u32(at + 8))
        bits, compression, colors = u16(at + 14), u32(at + 16), u32(at + 32)
        pad, direction = 4, (1 if flip else -1)
        if compression == 3:
            if size >= 52:
                masks = [u32(at + 40 + 4 * i)
                         for i in range(4 if size >= 56 else 3)]
            else:
                if len(data) < pos + 12:
                    raise ImageCodecError("truncated BMP file (no bit "
                                          "fields)")
                masks = [u32(pos + 4 * i) for i in range(3)]
                pos += 12
            masks = (masks + [0])[:4]
    else:
        raise ImageCodecError(f"BMP with an unsupported header ({size} "
                              f"bytes)")
    _check_size(w, h)
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    after = pos
    if bits not in _BMP_RAW:
        raise ImageCodecError(f"BMP of unsupported pixel depth ({bits})")
    mode, raw = ("P" if bits <= 8 else "RGB"), _BMP_RAW[bits]
    if compression == 3:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if key not in _BMP_MASKS:
            raise ImageCodecError(f"BMP with unsupported bit fields {masks}")
        raw = _BMP_MASKS[key]
    elif compression not in (0, 1, 2):
        raise ImageCodecError(f"BMP with unsupported compression "
                              f"({compression})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ImageCodecError(f"BMP with an unsupported palette size "
                                  f"({colors})")
        table = data[pos:pos + pad * colors]
        after = pos + len(table)
        grey = (0, 255) if colors == 2 else range(colors)
        if all(table[i * pad:i * pad + 3] == bytes([v & 255]) * 3
               for i, v in enumerate(grey)):
            mode = raw = "1" if colors == 2 else "L"
        else:
            if len(table) // pad > 256:
                raise ImageCodecError("BMP palette of more than 256 colours")
            palette = np.frombuffer(table[:len(table) // pad * pad], np.uint8
                                    ).reshape(-1, pad)[:, 2::-1]
    return {"size": (w, h), "mode": mode, "raw": raw, "palette": palette,
            "stride": ((w * bits + 31) >> 3) & ~3, "direction": direction,
            "compression": compression, "offset": offset or after}


def _bmp_pixels(rows: np.ndarray, raw: str, w: int) -> np.ndarray:
    """Raw rows [h, bytes] → [h, w] indices or grey, or [h, w, 3] RGB, by
    Pillow's unpacker for ``raw``."""
    if raw in ("P;1", "1", "P;4"):
        bits = 1 if raw != "P;4" else 4
        v = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(len(rows), w, bits)
        v = (v * (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)).sum(
            2, dtype=np.uint8)
        return v * np.uint8(255) if raw == "1" else v
    if raw in ("P", "L"):
        return rows[:, :w]
    if raw.startswith("BGR;"):
        px = rows[:, :2 * w].reshape(len(rows), w, 2).astype(np.uint32)
        px = px[..., 0] | px[..., 1] << 8
        if raw == "BGR;15":
            fields = ((10, 31), (5, 31), (0, 31))
        else:
            fields = ((11, 31), (5, 63), (0, 31))
        return np.stack([((px >> s) & m) * 255 // m for s, m in fields],
                        -1).astype(np.uint8)
    n = 3 if raw == "BGR" else 4
    px = rows[:, :n * w].reshape(len(rows), w, n)
    return px[..., list(_BMP_RGB_BYTES[raw])]


def _decode_bmp(data: bytes, fault: int,
                hdr: Optional[dict] = None) -> Tuple[np.ndarray, str, object]:
    """→ (pixels, Pillow's mode, palette or None), as Image.open reads a
    BMP (rows bottom-up unless the height is negative), or the bitmap of
    ``hdr`` (a DIB's, an icon's or a cursor's)."""
    hdr = hdr or _bmp_header(data)
    (w, h), raw, start = hdr["size"], hdr["raw"], hdr["offset"]
    if hdr["compression"] in (1, 2):
        if raw not in ("P", "L", "P;1", "P;4"):
            raise ImageCodecError(f"BMP RLE data in a {hdr['mode']} image")
        raw = "L" if hdr["mode"] == "L" else "P"
        need = w * h
        cap = need + 256 * (w + 1)
        out = np.empty(cap, np.uint8)
        src = np.frombuffer(data, np.uint8)
        err = ctypes.create_string_buffer(_ERR_LEN)
        n = _lib().cpt_bmp_rle(_ptr(src), src.size, start,
                               int(hdr["compression"] == 2), w, h, _ptr(out),
                               cap, err, _ERR_LEN)
        _check(n, err)
        if n < need:
            raise ImageCodecError(f"truncated BMP file (RLE data gives {n} of "
                                  f"{need} pixels)")
        rows = out[:need].reshape(h, w)
    else:
        stride = hdr["stride"]
        rowbytes = (w * _BMP_BITS.get(raw, 32) + 7) // 8
        if rowbytes > stride:
            raise ImageCodecError(f"BMP of {raw} rows wider than their "
                                  f"stride (Pillow's codec configuration "
                                  f"error)")
        # the last row's padding may be missing, as Pillow's raw decoder
        # allows
        need = (h - 1) * stride + rowbytes if h else 0
        if start + need > len(data):
            raise ImageCodecError("truncated BMP file (image data too "
                                  "short)")
        rows = np.zeros((h, stride), np.uint8)
        if need:
            have = min(h * stride, len(data) - start)
            rows.reshape(-1)[:have] = np.frombuffer(data, np.uint8, count=have,
                                                    offset=start)
    if hdr["direction"] < 0 and not fault & FAULTS["bmp_top_down"]:
        rows = rows[::-1]
    return _bmp_pixels(rows, raw, w), hdr["mode"], hdr["palette"]


def encode_bmp(arr: np.ndarray) -> bytes:
    """The bytes of ``Image.fromarray(arr).save(f, format="BMP")`` for a
    uint8 ``[H, W]`` (L: 8 bits, a grey palette) or ``[H, W, 3]`` (RGB: 24
    bits) array: BITMAPINFOHEADER, 96 dpi, bottom-up rows padded to 4
    bytes."""
    px = np.ascontiguousarray(arr, np.uint8)
    if px.ndim == 3 and px.shape[2] == 1:
        px = px[:, :, 0]
    if px.ndim not in (2, 3) or (px.ndim == 3 and px.shape[2] != 3):
        raise ImageCodecError(f"BMP encoder takes [H, W] or [H, W, 3] "
                              f"arrays, got shape {tuple(np.shape(arr))}")
    h, w = px.shape[:2]
    bits, colors = (8, 256) if px.ndim == 2 else (24, 0)
    stride = ((w * bits + 7) // 8 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = (px if px.ndim == 2
                               else px[:, :, ::-1]).reshape(h, -1)
    palette = (np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
               * np.array([1, 1, 1, 0], np.uint8)).tobytes() if colors else b""
    offset = 14 + 40 + colors * 4
    ppm = int(96 * 39.3701 + 0.5)
    return (b"BM" + struct.pack("<III", offset + stride * h, 0, offset)
            + struct.pack("<IIIHHIIIIII", 40, w, h, 1, bits, 0, stride * h,
                          ppm, ppm, colors, colors)
            + palette + rows[::-1].tobytes())


# ------------------------------------------------------------------ WEBP

# libwebp's container constants (src/demux/demux.c, src/webp/format_constants.h)
_WEBP_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_WEBP_ALPHA_FLAG, _WEBP_ANIM_FLAG, _WEBP_VALID_FLAGS = 0x10, 0x02, 0x3E
_WEBP_CHUNKS = (b"VP8 ", b"VP8X", b"VP8L")


def _webp_broken(why: str):
    raise ImageCodecError(f"broken WEBP file ({why})")


def _webp_features(data: bytes, at: int, avail: int) -> Tuple[int, int, bool]:
    """(width, height, has_alpha) of the VP8 / VP8L chunk at ``at`` with
    ``avail`` payload bytes, as libwebp's WebPGetFeatures checks it."""
    kind, size = data[at:at + 4], struct.unpack_from("<I", data, at + 4)[0]
    d = data[at + 8:at + 8 + avail]
    if kind == b"VP8 ":
        if len(d) < 10:
            _webp_broken("VP8 frame header too short")
        bits = d[0] | d[1] << 8 | d[2] << 16
        w, h = (d[7] << 8 | d[6]) & 0x3FFF, (d[9] << 8 | d[8]) & 0x3FFF
        if (d[3:6] != b"\x9d\x01\x2a" or bits & 1 or (bits >> 1) & 7 > 3
                or not (bits >> 4) & 1 or bits >> 5 >= size or not w or not h):
            _webp_broken("bad VP8 frame header")
        return w, h, False
    if len(d) < 5 or d[0] != 0x2F or d[4] >> 5:
        _webp_broken("bad VP8L header")
    bits = int.from_bytes(d[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool(bits >> 28 & 1)


def _webp_store_frame(data: bytes, pos: int, min_size: int, frame: dict,
                      number: int) -> int:
    """libwebp's StoreFrame: an ALPH chunk and a VP8 / VP8L chunk from
    ``pos`` into ``frame``; returns the position after them."""
    end = len(data)
    if end - pos < 8 or end - pos < min_size:
        _webp_broken("data ends inside a frame")
    while True:
        start = pos
        kind = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        pos += 8
        padded = size + (size & 1)
        if size > _WEBP_MAX_PAYLOAD or padded > end - pos:
            _webp_broken(f"{kind!r} chunk larger than the file")
        if kind == b"ALPH" and "alpha" not in frame:
            frame.update(alpha=(pos, size), number=number)
        elif kind in (b"VP8 ", b"VP8L") and "image" not in frame:
            if kind == b"VP8L" and "alpha" in frame:
                _webp_broken("ALPH chunk before a lossless frame")
            w, h, alpha = _webp_features(data, start, padded)
            frame.update(image=(pos, padded), lossless=kind == b"VP8L",
                         width=w, height=h, number=number,
                         has_alpha=frame.get("has_alpha", "alpha" in frame) or alpha)
        else:
            return start
        pos += padded
        if pos == end:
            return pos
        if end - pos < 8:
            _webp_broken("data ends inside a chunk header")


def _webp_header(data: bytes) -> dict:
    """libwebp's demuxer as Pillow's WebPAnimDecoder opens a file: the
    canvas size (the VP8X canvas where there is one), whether Pillow's mode
    is RGBA, and the first frame (its offset on the canvas, size, VP8 or
    VP8L payload and ALPH payload). Raises where the demuxer fails, then
    where the size is a decompression bomb."""
    if len(data) < 20:
        raise ImageCodecError("truncated WEBP file (no chunk header)")
    riff_size = struct.unpack_from("<I", data, 4)[0]
    if riff_size < 8 or riff_size > _WEBP_MAX_PAYLOAD:
        _webp_broken(f"RIFF size {riff_size}")
    if len(data) < riff_size + 8:
        raise ImageCodecError("truncated WEBP file (data ends before its RIFF "
                              "size)")
    data = data[:riff_size + 8]
    frames, flags, canvas = [], 0, None

    def single_image(pos: int, ext: bool) -> int:
        nonlocal flags, canvas
        if frames or len(data) - pos < 8:
            _webp_broken("a second image, or no image chunk")
        frame = {"offset": (0, 0)}
        pos = _webp_store_frame(data, pos, 0, frame, 1)
        if not flags & _WEBP_ALPHA_FLAG and "alpha" in frame:
            del frame["alpha"]             # ignored without the alpha flag
            frame["has_alpha"] = False
        if not ext and frame.get("width"):
            canvas = (frame["width"], frame["height"])
            flags |= _WEBP_ALPHA_FLAG if frame["has_alpha"] else 0
        frames.append(frame)
        return pos

    kind = data[12:16]
    if kind in (b"VP8 ", b"VP8L"):
        single_image(12, False)
    elif kind == b"VP8X":
        size = struct.unpack_from("<I", data, 16)[0]
        padded = size + (size & 1)
        if size > _WEBP_MAX_PAYLOAD or size < 10 or padded > len(data) - 20:
            _webp_broken(f"VP8X chunk of {size} bytes")
        flags = data[20]
        canvas = (1 + int.from_bytes(data[24:27], "little"),
                  1 + int.from_bytes(data[27:30], "little"))
        if canvas[0] * canvas[1] >= 1 << 32:
            _webp_broken("canvas too large")
        pos = 20 + padded
        anim, animation = False, bool(flags & _WEBP_ANIM_FLAG)
        while True:
            if len(data) - pos < 8:
                _webp_broken("data ends inside a chunk header")
            start = pos
            kind = data[pos:pos + 4]
            size = struct.unpack_from("<I", data, pos + 4)[0]
            padded = size + (size & 1)
            pos += 8
            if size > _WEBP_MAX_PAYLOAD or padded > len(data) - pos:
                _webp_broken(f"{kind!r} chunk larger than the file")
            if kind == b"VP8X":
                _webp_broken("a second VP8X chunk")
            elif kind in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim or animation:
                    _webp_broken("an image outside the animation's frames")
                pos = single_image(start, True)
            elif kind == b"ANIM":
                if padded < 6:
                    _webp_broken("ANIM chunk too short")
                anim = True
                pos += padded
            elif kind == b"ANMF":
                if not anim or padded < 16:
                    _webp_broken("ANMF chunk before ANIM, or too short")
                x0, y0, w1, h1 = (int.from_bytes(data[pos + i:pos + i + 3],
                                                 "little") for i in (0, 3, 6, 9))
                if (w1 + 1) * (h1 + 1) >= 1 << 32:
                    _webp_broken("frame too large")
                frame = {"offset": (2 * x0, 2 * y0)}
                after = _webp_store_frame(data, pos + 16, padded - 16, frame,
                                          len(frames) + 1)
                if after - (pos + 16) > padded - 16:
                    _webp_broken("frame larger than its ANMF chunk")
                if animation and "number" in frame:
                    if frames and "image" not in frames[-1]:
                        _webp_broken("a frame after an incomplete one")
                    frames.append(frame)
                pos = after
            else:
                pos += padded
            if pos == len(data):
                break
    else:
        raise ImageCodecError(f"cannot identify image file ({_READS})")
    # IsValidSimpleFormat / IsValidExtendedFormat
    if not canvas or not frames or flags & ~_WEBP_VALID_FLAGS & 0xFF:
        _webp_broken("no frame, or unknown VP8X flags")
    exact = not flags & _WEBP_ANIM_FLAG
    for frame in frames:
        if "image" not in frame:
            _webp_broken("a frame without an image")
        if "alpha" in frame and frame["alpha"][0] > frame["image"][0]:
            _webp_broken("ALPH chunk after its image")
        (x0, y0), w, h = frame["offset"], frame["width"], frame["height"]
        if (exact and (x0, y0, w, h) != (0, 0) + canvas) or (
                x0 + w > canvas[0] or y0 + h > canvas[1]):
            _webp_broken("frame outside the canvas")
    _check_size(*canvas)
    return {"size": canvas, "alpha": bool(flags & _WEBP_ALPHA_FLAG),
            "frame": frames[0]}


def _decode_webp(data: bytes, fault: int) -> Tuple[np.ndarray, str, object]:
    """The first frame → ([H, W, 4] RGBA or [H, W, 3] RGB, Pillow's mode,
    None): decoded into its rectangle of a transparent black canvas, as
    WebPAnimDecoder gives it (a lossy frame's ALPH plane decoded too, so
    that a broken one raises as it does there)."""
    hdr = _webp_header(data)
    (cw, ch), frame = hdr["size"], hdr["frame"]
    w, h = frame["width"], frame["height"]
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rgba = np.empty((h, w, 4), np.uint8)
    at, n = frame["image"]
    lib = _lib()
    if frame["lossless"]:
        _check(lib.cpt_webp_lossless(_ptr(src) + at, n, 0, w, h, fault,
                                     _ptr(rgba), err, _ERR_LEN), err)
    else:
        _check(lib.cpt_webp_lossy(_ptr(src) + at, n, w, h, fault, _ptr(rgba),
                                  err, _ERR_LEN), err)
        if "alpha" in frame:
            at, n = frame["alpha"]
            alpha = np.empty((h, w), np.uint8)
            _check(lib.cpt_webp_lossless(_ptr(src) + at, n, 1, w, h, fault,
                                         _ptr(alpha), err, _ERR_LEN), err)
            rgba[:, :, 3] = alpha
    if (cw, ch) != (w, h):
        canvas = np.zeros((ch, cw, 4), np.uint8)
        x0, y0 = frame["offset"]
        canvas[y0:y0 + h, x0:x0 + w] = rgba
        rgba = canvas
    if hdr["alpha"]:
        return rgba, "RGBA", None
    return np.ascontiguousarray(rgba[:, :, :3]), "RGB", None


# ------------------------------------------------------------------ TIFF

# TiffImagePlugin's header prefixes (the two invalid ones are read as TIFF)
_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                  b"MM\x00\x2b", b"II\x2b\x00")
# TiffImagePlugin's value loaders: type -> (bytes a value, struct code)
_TIFF_LOADERS = {1: (1, "byte"), 2: (1, "ascii"), 3: (2, "H"), 4: (4, "L"),
                 5: (8, "rational"), 6: (1, "b"), 7: (1, "undefined"),
                 8: (2, "h"), 9: (4, "l"), 10: (8, "srational"), 11: (4, "f"),
                 12: (8, "d"), 13: (4, "L"), 16: (8, "Q")}
# TiffTags' spec'd value counts of the tags _setup reads (1: one value,
# stored as a scalar; 0: any number, stored as a tuple)
_TIFF_TAG_LENGTH = {256: 1, 257: 1, 258: 0, 259: 1, 262: 1, 266: 1, 273: 0,
                    274: 1, 277: 1, 278: 1, 284: 1, 320: 0, 322: 1, 323: 1,
                    324: 0, 338: 0, 339: 0}
_TIFF_COMPRESSION = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                     5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                     8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                     32773: "packbits", 32809: "tiff_thunderscan",
                     32946: "tiff_deflate", 34676: "tiff_sgilog",
                     34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                     50001: "webp"}
_TIFF_READ = ("raw", "tiff_lzw", "jpeg", "tiff_adobe_deflate", "packbits",
              "tiff_deflate")
_TIFF_MAX_SAMPLES = 6


def _tiff_open_info() -> dict:
    """TiffImagePlugin's OPEN_INFO, the rows of the kinds read here:
    (byte order, photometric, sample format, fill order, bits, extra
    samples) -> (Pillow's mode, raw mode)."""
    rows = {}
    for order in (b"II", b"MM"):
        def put(photo, fmt, fill, bits, extra, mode, raw):
            rows[(order, photo, fmt, fill, bits, extra)] = (mode, raw)

        for photo, inv in ((0, "I"), (1, "")):
            for fill, rev in ((1, ""), (2, "R")):
                put(photo, (1,), fill, (1,), (), "1", "1" + (";" + inv + rev if inv + rev else ""))
                for b in (2, 4):
                    put(photo, (1,), fill, (b,), (), "L", f"L;{b}{inv}{rev}")
                put(photo, (1,), fill, (8,), (), "L",
                    "L" + (";" + inv + rev if inv + rev else ""))
        put(1, (2,), 1, (8,), (), "L", "L")
        put(6, (1,), 1, (8,), (), "L", "L")
        put(1, (1,), 1, (8, 8), (2,), "LA", "LA")
        for fill, raw in ((1, "RGB"), (2, "RGB;R")):
            put(2, (1,), fill, (8, 8, 8), (), "RGB", raw)
        put(2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA")
        for n in range(1, 4):
            for first, mode, raw in ((0, "RGB", "RGB"), (1, "RGBA", "RGBa"),
                                     (2, "RGBA", "RGBA")):
                put(2, (1,), 1, (8,) * (3 + n), (first,) + (0,) * (n - 1), mode,
                    raw + "X" * (n - 1 + (first == 0)))
        put(2, (1,), 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA")
        e = "L" if order == b"II" else "B"
        put(2, (1,), 1, (16, 16, 16), (), "RGB", f"RGB;16{e}")
        for extra, mode, raw in (((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"),
                                 ((1,), "RGBA", "RGBa"), ((2,), "RGBA", "RGBA")):
            put(2, (1,), 1, (16,) * 4, extra, mode, f"{raw};16{e}")
        for fill, rev in ((1, ""), (2, "R")):
            for b in (1, 2, 4):
                put(3, (1,), fill, (b,), (), "P", f"P;{b}{rev}")
            put(3, (1,), fill, (8,), (), "P", "P;R" if rev else "P")
        put(3, (1,), 1, (8, 8), (0,), "P", "PX")
        put(3, (1,), 1, (8, 8), (2,), "PA", "PA")
        put(5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK")
        put(5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX")
        put(5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX")
        put(5, (1,), 1, (16,) * 4, (), "CMYK", f"CMYK;16{e}")
        put(6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX")
    rows[(b"II", 1, (1,), 1, (16,), ())] = ("I;16", "I;16")
    rows[(b"II", 0, (1,), 1, (16,), ())] = ("I;16", "I;16")
    rows[(b"MM", 1, (1,), 1, (16,), ())] = ("I;16B", "I;16B")
    return rows


_TIFF_OPEN_INFO = _tiff_open_info()


# The rest of OPEN_INFO: kinds Pillow reads that this codec refuses
_TIFF_LEFT_OUT = {}
for _order in (b"II", b"MM"):
    _TIFF_LEFT_OUT.update({
        (_order, 8, (1,), 1, (8, 8, 8), ()): "CIELab colour",
        (_order, 0, (3,), 1, (32,), ()): "32-bit floating-point samples",
        (_order, 1, (3,), 1, (32,), ()): "32-bit floating-point samples",
        (_order, 1, (2,), 1, (16,), ()): "16-bit signed samples",
        (_order, 1, (2,), 1, (32,), ()): "32-bit signed samples"})
_TIFF_LEFT_OUT.update({
    (b"II", 1, (1,), 1, (12,), ()): "12-bit samples",
    (b"II", 1, (1,), 2, (16,), ()): "16-bit samples in fill order 2",
    (b"II", 1, (1,), 1, (32,), ()): "32-bit integer samples"})


def _tiff_broken(why: str):
    raise ImageCodecError(f"broken TIFF file ({why})")


class _TiffFile:
    """A TIFF file's first image as Pillow 12.1 opens it (TiffImagePlugin:
    the header, the first IFD's tags by Pillow's own parser, ``_setup``'s
    mode, raw mode, size and tiles); raises where ``Image.open`` raises.
    libtiff's reading of the same directory is :class:`_LibtiffDir`."""

    def __init__(self, data: bytes):
        self.data = data
        ifh = data[:8]
        if ifh[2:3] == b"+":
            ifh += data[8:16]
        if not ifh.startswith(_TIFF_PREFIXES):
            raise ImageCodecError(f"cannot identify image file ({_READS})")
        self.prefix = ifh[:2]
        self.e = ">" if self.prefix == b"MM" else "<"
        self.big = ifh[2] == 43
        if len(ifh) < (16 if self.big else 8):
            _tiff_broken("no header")
        first = struct.unpack(self.e + ("Q" if self.big else "L"),
                              ifh[8:16] if self.big else ifh[4:8])[0]
        if not first:
            _tiff_broken("no image in it")
        if first >= 2 ** 63:
            _tiff_broken("IFD offset out of range")
        self.ifd_offset = first
        self.tagdata, self.tagtype = self._pillow_ifd(first)
        self.values = {}
        try:
            self._setup()
        except ImageCodecError:
            raise
        except (ArithmeticError, LookupError, TypeError, ValueError,
                AttributeError, struct.error) as e:
            _tiff_broken(f"{type(e).__name__}: {e}")

    # -- Pillow's IFD parser (ImageFileDirectory_v2.load)

    def _pillow_ifd(self, at: int):
        data, e, big = self.data, self.e, self.big
        tags, types = {}, {}
        pos = at

        def read(n):
            nonlocal pos
            chunk = data[pos:pos + n] if pos < len(data) else b""
            pos += n
            if len(chunk) != n:
                raise EOFError
            return chunk

        try:
            count = struct.unpack(e + ("Q" if big else "H"), read(8 if big else 2))[0]
            for _ in range(count):
                tag, typ, cnt, value = struct.unpack(
                    e + ("HHQ8s" if big else "HHL4s"), read(20 if big else 12))
                if typ not in _TIFF_LOADERS:
                    continue
                size = cnt * _TIFF_LOADERS[typ][0]
                if size > (8 if big else 4):
                    off = struct.unpack(e + ("Q" if big else "L"), value)[0]
                    value = data[off:off + size]
                    if len(value) < size:
                        raise EOFError      # _safe_read: "Truncated File Read"
                else:
                    value = value[:size]
                if not value:
                    continue
                tags[tag], types[tag] = value, typ
        except EOFError:
            pass                            # Pillow warns and keeps what it read
        return tags, types

    def get(self, tag: int, default=None):
        """``tag_v2.get(tag)``: the value as ImageFileDirectory_v2 converts
        it (a scalar for one-value tags, else a tuple; rationals as
        fractions, a zero denominator NaN)."""
        if tag not in self.tagdata:
            return default
        if tag not in self.values:
            data, typ = self.tagdata[tag], self.tagtype[tag]
            size, code = _TIFF_LOADERS[typ]
            if code in ("byte", "undefined"):
                vals = [data]
            elif code == "ascii":
                vals = [(data[:-1] if data.endswith(b"\0") else data).decode(
                    "latin-1", "replace")]
            elif code in ("rational", "srational"):
                fmt = "L" if code == "rational" else "l"
                raw = struct.unpack(f"{self.e}{len(data) // 4}{fmt}", data)
                vals = [Fraction(a, b) if b else float("nan")
                        for a, b in zip(raw[::2], raw[1::2])]
            else:
                vals = list(struct.unpack(f"{self.e}{len(data) // size}{code}", data))
            length = _TIFF_TAG_LENGTH.get(tag)
            if length == 1 or typ == 1 or (length is None and len(vals) == 1):
                self.values[tag] = vals[0]
            else:
                self.values[tag] = tuple(vals)
        return self.values[tag]

    # -- TiffImagePlugin._setup

    def _setup(self) -> None:
        if 0xBC01 in self.tagdata:
            _tiff_broken("Windows Media Photo")
        compression = _TIFF_COMPRESSION[self.get(259, 1)]
        planar = self.get(284, 1)
        photo = self.get(262, 0)
        if compression == "tiff_jpeg":
            photo = 6
        fill = self.get(266, 1)
        if 256 not in self.tagdata or 257 not in self.tagdata:
            _tiff_broken("missing dimensions")
        xsize, ysize = self.get(256), self.get(257)
        if not isinstance(xsize, int) or not isinstance(ysize, int):
            _tiff_broken("invalid dimensions")
        orientation = self.get(274)
        self.tile_size = (xsize, ysize)
        self.size = (ysize, xsize) if orientation in (5, 6, 7, 8) else (xsize, ysize)
        fmt = self.get(339, (1,))
        if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
            fmt = (1,)
        bps = self.get(258, (1,))
        extra = self.get(338, ())
        count = 3 if photo in (2, 6, 8) else 4 if photo == 5 else 1
        count += len(extra)
        spp = self.get(277, 3 if compression == "tiff_jpeg" and photo in (2, 6) else 1)
        if spp > _TIFF_MAX_SAMPLES:
            _tiff_broken("invalid value for samples per pixel")
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        if len(bps) != spp:
            _tiff_broken("unknown data organization")
        key = (self.prefix, photo, fmt, fill, bps, extra)
        if key in _TIFF_LEFT_OUT:
            raise ImageCodecError(f"TIFF of {_TIFF_LEFT_OUT[key]} is not "
                                  f"supported")
        if key not in _TIFF_OPEN_INFO:
            _tiff_broken("unknown pixel mode")
        mode, raw = _TIFF_OPEN_INFO[key]
        if compression not in _TIFF_READ:
            raise ImageCodecError(f"TIFF of {compression} compression is not "
                                  f"supported")
        self.compression, self.photo, self.planar = compression, photo, planar
        self.bps, self.extra, self.count = bps, extra, count
        self.orientation = orientation
        tiles = []
        if compression != "raw":
            if fill == 2:
                mode, raw = _TIFF_OPEN_INFO[key[:3] + (1,) + key[4:]]
            if photo == 6 and compression == "jpeg" and planar == 1:
                raw = "RGB"
            elif raw == "I;16":
                raw = "I;16N"
            elif raw.endswith((";16B", ";16L")):
                raw = raw[:-1] + "N"
        elif 273 in self.tagdata or 324 in self.tagdata:
            if 273 in self.tagdata:
                offsets, h, w = self.get(273), self.get(278, ysize), xsize
            else:
                offsets, w, h = self.get(324), self.get(322), self.get(323)
                if not isinstance(w, int) or not isinstance(h, int):
                    _tiff_broken("invalid tile dimensions")
            if w == xsize and h == ysize and planar != 2:
                offsets = offsets[-1:]
            x = y = layer = 0
            for offset in offsets:
                stride = w * sum(bps) / 8 if x + w > xsize else 0
                tile_raw = raw
                if planar == 2:
                    tile_raw = raw[layer]
                    stride /= count
                tiles.append(((x, y, min(x + w, xsize), min(y + h, ysize)),
                              offset, tile_raw, int(stride)))
                x += w
                if x >= xsize:
                    x, y = 0, y + h
                    if y >= ysize:
                        y = 0
                        layer += 1
        else:
            _tiff_broken("unknown data organization")
        self.mode, self.raw, self.tiles = mode, raw, tiles
        self.palette = None
        if mode in ("P", "PA"):
            cmap = self.get(320)
            if cmap is None:
                _tiff_broken("palette image without a ColorMap")
            self.palette = b"".join(struct.pack("B", b // 256) for b in cmap)


# libtiff's type widths (0: a type it does not know) and its integer types
_LT_WIDTH = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
             11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_LT_INT = {1: "B", 6: "b", 3: "H", 8: "h", 4: "L", 9: "l", 13: "L", 16: "Q",
           17: "q", 18: "Q"}
_LT_SHORT_TYPES = (1, 6, 3, 8, 4, 9, 16, 17)
_LT_LONG_TYPES = _LT_SHORT_TYPES + (13,)
_LT_LONG8_TYPES = _LT_LONG_TYPES + (18,)
_LT_NUMBER_TYPES = _LT_SHORT_TYPES + (5, 10, 11, 12)
# tags libtiff knows (tif_dirinfo.c) among those a damaged file may name;
# other tags are anonymous fields, read and ignored
_LT_FIRST_PASS = (256, 257, 32997, 322, 323, 32998, 284, 278, 338)
_LT_PER_SAMPLE = (258, 339, 280, 281, 32996)


class _LibtiffError(Exception):
    """libtiff fails to read the directory, or a strip or tile."""


def _lt_fail(why: str):
    raise _LibtiffError(why)


class _LibtiffDir:
    """The directory as libtiff 4.7.1's TIFFClientOpen + TIFFReadDirectory
    read it for Pillow's libtiff decoder (the first IFD; a duplicated tag
    taken at its first entry; each tag's own type and range rules, its
    errors fatal or ignored as libtiff treats them)."""

    def __init__(self, f: _TiffFile):
        self.data, self.e, self.big = f.data, f.e, f.big
        data, e = self.data, self.e
        version = struct.unpack(e + "H", data[2:4])[0]
        if version not in (42, 43) or (version == 43) != self.big:
            _lt_fail("bad TIFF version")
        if self.big and struct.unpack(e + "HH", data[4:8]) != (8, 0):
            _lt_fail("bad BigTIFF header")
        at, head, size = f.ifd_offset, (8 if self.big else 2), (20 if self.big else 12)
        if at + head > len(data):
            _lt_fail("cannot read the directory count")
        count = struct.unpack(e + ("Q" if self.big else "H"), data[at:at + head])[0]
        if count > 4096:
            _lt_fail("directory count fails its sanity check")
        if count == 0:
            _lt_fail("zero tag directories are not supported")
        at += head
        if at + count * size > len(data):
            _lt_fail("cannot read the directory")
        self.entries, seen = [], set()
        for i in range(count):
            tag, typ, cnt, value = struct.unpack(
                e + ("HHQ8s" if self.big else "HHL4s"),
                data[at + i * size:at + (i + 1) * size])
            if tag not in seen:
                seen.add(tag)
                self.entries.append((tag, typ, cnt, value))
        self.read()

    # -- TIFFReadDirEntry*

    def _values(self, ent, limit=None) -> list:
        tag, typ, cnt, value = ent
        width = _LT_WIDTH.get(typ, 0)
        if not width:
            raise _LibtiffError("type")
        n = cnt if limit is None else min(cnt, limit)
        size = n * width
        if size > len(self.data):
            raise _LibtiffError("io")
        # inline or not by the entry's own count (up to 10 values)
        if min(cnt, 10) * width <= (8 if self.big else 4):
            raw = value[:size]
        else:
            off = struct.unpack(self.e + ("Q" if self.big else "L"),
                                value[:8 if self.big else 4])[0]
            if off + size > len(self.data):
                raise _LibtiffError("io")
            raw = self.data[off:off + size]
        if typ in _LT_INT:
            return list(struct.unpack(f"{self.e}{n}{_LT_INT[typ]}", raw))
        if typ in (5, 10):
            v = struct.unpack(f"{self.e}{2 * n}{'L' if typ == 5 else 'l'}", raw)
            return [a / b if b else 0.0 for a, b in zip(v[::2], v[1::2])]
        if typ in (11, 12):
            return list(struct.unpack(f"{self.e}{n}{'f' if typ == 11 else 'd'}", raw))
        return list(raw)                   # ASCII, UNDEFINED

    def _ints(self, ent, types, hi, limit=None) -> list:
        if ent[1] not in types:
            raise _LibtiffError("type")
        vals = self._values(ent, limit)
        if any(v < 0 or v > hi for v in vals):
            raise _LibtiffError("range")
        return vals

    def short(self, ent) -> int:
        if ent[2] != 1:
            raise _LibtiffError("count")
        return self._ints(ent, _LT_SHORT_TYPES, 0xFFFF)[0]

    def long(self, ent) -> int:
        if ent[2] != 1:
            raise _LibtiffError("count")
        return self._ints(ent, _LT_LONG_TYPES, 0xFFFFFFFF)[0]

    def per_sample_short(self, ent) -> int:
        try:
            return self.short(ent)
        except _LibtiffError as err:
            if str(err) != "count":
                raise
        if ent[2] < self.spp:
            raise _LibtiffError("count")
        vals = self._ints(ent, _LT_SHORT_TYPES, 0xFFFF)
        if any(v != vals[0] for v in vals[:self.spp]):
            raise _LibtiffError("different values per sample")
        return vals[0]

    def floats(self, ent, count: int) -> list:
        if ent[2] != count or ent[1] not in _LT_NUMBER_TYPES:
            raise _LibtiffError("count or type")
        return self._values(ent)

    # -- TIFFReadDirectory

    def find(self, tag: int):
        for ent in self.entries:
            if ent[0] == tag:
                return ent
        return None

    def read(self) -> None:
        self.spp, self.extrasamples = 1, []
        ent = self.find(277)
        if ent:
            try:
                self.spp = self.short(ent)
            except _LibtiffError:
                _lt_fail("bad SamplesPerPixel")
            if self.spp == 0:
                _lt_fail("SamplesPerPixel 0")
        ent = self.find(259)
        self.compression = 1
        if ent:
            try:
                self.compression = self.per_sample_short(ent)
            except _LibtiffError:
                _lt_fail("bad Compression")
        self.width = self.length = 0
        self.planar, self.rowsperstrip, self.tilewidth, self.tilelength = 1, None, None, None
        fields = set()
        codec_tags = {317: (5, 8, 32946), 347: (7,)}
        for tag, typ, cnt, value in self.entries:
            ent = (tag, typ, cnt, value)
            if tag in (277, 259):
                continue
            if tag in (273, 279, 324, 325):
                fields.add(tag)
            elif tag in _LT_FIRST_PASS:
                try:
                    if tag == 338:
                        vals = self._ints(ent, _LT_SHORT_TYPES, 0xFFFF)
                        if len(vals) > self.spp or any(v > 2 for v in vals):
                            raise _LibtiffError("value")
                        self.extrasamples = vals
                    elif tag == 284:
                        self.planar = self.short(ent)
                        if self.planar not in (1, 2):
                            raise _LibtiffError("value")
                    else:
                        v = self.long(ent)
                        if tag == 278 and v == 0:
                            raise _LibtiffError("value")
                        if tag in (32997, 32998):
                            continue
                        setattr(self, {256: "width", 257: "length", 278: "rowsperstrip",
                                       322: "tilewidth", 323: "tilelength"}[tag], v)
                except _LibtiffError:
                    _lt_fail(f"bad tag {tag}")
                fields.add(tag)
        if not {256, 257} & fields:
            _lt_fail("missing ImageLength")
        tiled = bool({322, 323} & fields)
        rps = 0xFFFFFFFF if self.rowsperstrip is None else self.rowsperstrip
        if not tiled:
            nstrips = 1 if rps == 0xFFFFFFFF else _howmany(self.length, rps)
            self.tilewidth, self.tilelength = self.width, rps
        else:
            tw = self.width if self.tilewidth in (None, 0xFFFFFFFF) else self.tilewidth
            th = self.length if self.tilelength in (None, 0xFFFFFFFF) else self.tilelength
            self.tilewidth = 0 if self.tilewidth is None else self.tilewidth
            self.tilelength = 0 if self.tilelength is None else self.tilelength
            nstrips = (0 if not tw or not th
                       else _howmany(self.width, tw) * _howmany(self.length, th))
        if self.planar == 2:
            nstrips *= self.spp
        if nstrips == 0 or nstrips >= 1 << 32:
            _lt_fail("zero strips or tiles")
        self.tiled, self.nstrips, self.rowsperstrip_ = tiled, nstrips, rps
        self.stripsperimage = nstrips // self.spp if self.planar == 2 else nstrips
        off_tag, cnt_tag = (324, 325) if tiled else (273, 279)
        if off_tag not in fields:
            _lt_fail("missing strip offsets")
        # second pass
        self.bps, self.sampleformat, self.photometric = 1, 1, None
        self.fillorder, self.predictor = 1, 1
        self.subsampling, self.refbw, self.coeffs = None, None, None
        self.jpegtables, self.colormap = None, None
        bps_read = False
        for tag, typ, cnt, value in self.entries:
            ent = (tag, typ, cnt, value)
            if tag in (277, 259) or tag in _LT_FIRST_PASS:
                continue
            if tag in codec_tags and self.compression not in codec_tags[tag]:
                continue
            if tag in _LT_PER_SAMPLE:
                try:
                    v = self.per_sample_short(ent)
                except _LibtiffError:
                    _lt_fail(f"bad tag {tag}")
                if tag == 258:
                    self.bps, bps_read = v, True
                elif tag == 339:
                    if not 1 <= v <= 6:
                        _lt_fail("bad SampleFormat")
                    self.sampleformat = v
                continue
            try:
                if tag == 320:
                    if not bps_read or self.bps > 24:
                        continue
                    if cnt != 3 << self.bps:
                        continue
                    self.colormap = self._ints(ent, _LT_SHORT_TYPES, 0xFFFF)
                elif tag == 262:
                    self.photometric = self.short(ent)
                elif tag == 266:
                    v = self.short(ent)
                    if v in (1, 2):
                        self.fillorder = v
                elif tag == 317:
                    self.predictor = self.short(ent)
                elif tag == 530:
                    if cnt == 2:
                        self.subsampling = tuple(self._ints(ent, _LT_SHORT_TYPES, 0xFFFF))
                elif tag == 532:
                    self.refbw = self.floats(ent, 6)
                elif tag == 529:
                    self.coeffs = self.floats(ent, 3)
                elif tag == 347:
                    if typ not in (1, 2, 7) + _LT_SHORT_TYPES:
                        continue
                    vals = self._values(ent)
                    if cnt and all(0 <= v <= 255 for v in vals):
                        self.jpegtables = bytes(vals)
            except _LibtiffError:
                pass                          # recovered: the tag is ignored
        if self.photometric is None:
            self.photometric = 0
        if self.photometric == 3 and self.colormap is None:
            if self.bps >= 8:
                self.photometric = 2 if self.spp == 3 else 1
            else:
                _lt_fail("missing Colormap")
        try:
            self.offsets = self._ints(self.find(off_tag), _LT_LONG8_TYPES,
                                      2 ** 63 - 1, self.nstrips)
            counts = self.find(cnt_tag)
            self.bytecounts = (None if counts is None else
                               self._ints(counts, _LT_LONG8_TYPES, 2 ** 63 - 1,
                                          self.nstrips))
        except _LibtiffError:
            _lt_fail("bad strip offsets or byte counts")
        self.offsets += [0] * (self.nstrips - len(self.offsets))
        if self.bytecounts is None:
            if (self.planar == 1 and nstrips > 1) or (self.planar == 2 and nstrips != self.spp):
                _lt_fail("missing StripByteCounts")
            self._estimate_bytecounts()
        else:
            self.bytecounts += [0] * (self.nstrips - len(self.bytecounts))
            if (nstrips == 1 and not tiled and self.offsets[0] != 0
                    and self.bytecounts[0] == 0):
                self._estimate_bytecounts()
        if (self.compression == 7 and self.photometric == 6 and self.planar == 1
                and self.spp == 3 and self.subsampling is None):
            self._jpeg_subsampling()
        if self.subsampling is None:
            self.subsampling = (2, 2)
        if self.scanline_size() == 0:
            _lt_fail("zero scanline size")
        if (self.tile_size() if tiled else self.strip_size(min(rps, self.length))) == 0:
            _lt_fail("zero strip or tile size")

    def _estimate_bytecounts(self) -> None:
        """EstimateStripByteCounts for compressed data: the file's size less
        the header, the directory and its out-of-line values."""
        space = ((16 + 8 + len(self.entries) * 20 + 8) if self.big
                 else (8 + 2 + len(self.entries) * 12 + 4))
        for tag, typ, cnt, value in self.entries:
            width = _LT_WIDTH.get(typ, 0)
            if not width:
                _lt_fail("unknown tag type")
            size = width * cnt
            space += 0 if size <= (8 if self.big else 4) else size
        filesize = len(self.data)
        space = filesize if filesize < space else filesize - space
        if self.planar == 2:
            space //= self.spp
        self.bytecounts = [space] * self.nstrips
        last = self.offsets[-1]
        if last + space > filesize:
            self.bytecounts[-1] = 0 if last >= filesize else filesize - last
        if self.rowsperstrip is None:
            self.rowsperstrip_ = self.length
            if not self.tiled:
                self.tilelength = self.length

    def _jpeg_subsampling(self) -> None:
        """JPEGFixupTagsSubsampling: a YCbCr JPEG file without
        YCbCrSubsampling takes its first strip's luma sampling."""
        off, n = self.offsets[0], self.bytecounts[0]
        if not n or off >= len(self.data):
            return
        info = (ctypes.c_int * 23)()
        err = ctypes.create_string_buffer(_ERR_LEN)
        strip = self.data[off:off + n]
        if _lib().cpt_jpeg_frame_tiff(None, 0, strip, len(strip), info, err,
                                      _ERR_LEN) < 0 or info[2] != 3:
            return
        h, v = info[3], info[4]
        if h in (1, 2, 4) and v in (1, 2, 4) and all(
                info[3 + 2 * c] == 1 and info[4 + 2 * c] == 1 for c in (1, 2)):
            self.subsampling = (h, v)

    # -- sizes (tif_strip.c, tif_tile.c)

    def _ycbcr_packed(self, upsampled: bool) -> bool:
        return (self.planar == 1 and self.photometric == 6 and self.spp == 3
                and not upsampled)

    def _subsampling_ok(self) -> bool:
        hs, vs = self.subsampling
        return hs in (1, 2, 4) and vs in (1, 2, 4)

    def scanline_size(self, upsampled: bool = False) -> int:
        if self._ycbcr_packed(upsampled):
            if not self._subsampling_ok():
                return 0
            hs, vs = self.subsampling
            row = _howmany(self.width, hs) * (hs * vs + 2)
            return (row * self.bps + 7) // 8 // vs
        samples = self.width * (self.spp if self.planar == 1 else 1)
        return (samples * self.bps + 7) // 8

    def strip_size(self, rows: int, upsampled: bool = False) -> int:
        if self._ycbcr_packed(upsampled):
            if not self._subsampling_ok():
                return 0
            hs, vs = self.subsampling
            row = (_howmany(self.width, hs) * (hs * vs + 2) * self.bps + 7) // 8
            return row * _howmany(rows, vs)
        return rows * self.scanline_size(upsampled)

    def tile_row_size(self) -> int:
        if not self.tilelength or not self.tilewidth:
            return 0
        bits = self.bps * self.tilewidth * (self.spp if self.planar == 1 else 1)
        return (bits + 7) // 8

    def tile_size(self, upsampled: bool = False) -> int:
        if not self.tilelength or not self.tilewidth:
            return 0
        if self._ycbcr_packed(upsampled):
            if not self._subsampling_ok():
                return 0
            hs, vs = self.subsampling
            row = (_howmany(self.tilewidth, hs) * (hs * vs + 2) * self.bps + 7) // 8
            return row * _howmany(self.tilelength, vs)
        return self.tilelength * self.tile_row_size()


def _howmany(x: int, y: int) -> int:
    """TIFFhowmany_32: ceil(x / y), 0 where it would overflow 32 bits."""
    return (x + y - 1) // y if x < 0xFFFFFFFF - (y - 1) else 0


# -- Pillow's unpackers for the TIFF raw modes (Unpack.c)

_TIFF_BANDS = {"1": "1", "L": "L", "P": "P", "I;16": "I", "I;16B": "I",
               "LA": "LA", "PA": "PA", "RGB": "RGB", "RGBA": "RGBA",
               "CMYK": "CMYK"}


def _tiff_raw_bits(raw: str) -> int:
    """Bits a pixel of Pillow's unpacker for ``raw``."""
    if len(raw) == 1:
        return 1 if raw == "1" else 8
    base, _, suffix = raw.partition(";")
    if suffix[:1].isdigit():
        bits = int(suffix[:2] if suffix[:2].isdigit() else suffix[0])
        return bits * (len(base) if base in ("RGB", "RGBA", "RGBa", "RGBX", "CMYK") else 1)
    if base == "1":
        return 1
    return 8 * len(base)


def _reverse_bits(buf: np.ndarray) -> np.ndarray:
    out = np.ascontiguousarray(buf, np.uint8).copy()
    _lib().cpt_tiff_reverse_bits(_ptr(out), out.size)
    return out


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's "RGBa" unpacker: colour * 255 // alpha, clipped."""
    a = rgba[..., 3:4].astype(np.int32)
    c = rgba[..., :3].astype(np.int32)
    out = np.where(a == 0, 0, np.where(a == 255, c, np.minimum(
        c * 255 // np.maximum(a, 1), 255)))
    return np.concatenate([out, a], -1).astype(np.uint8)


def _tiff_unpack(rows: np.ndarray, raw: str, w: int) -> np.ndarray:
    """Rows of raw bytes [h, n] -> pixels by Pillow's unpacker for
    ``raw``: [h, w] ("1", "L", "P", 16-bit grey), else [h, w, bands]."""
    h = len(rows)
    base, _, suffix = raw.partition(";")
    if suffix.endswith("R") and not suffix.startswith("16"):
        rows = _reverse_bits(rows)
        suffix = suffix[:-1]
    invert = suffix.endswith("I")
    if invert:
        suffix = suffix[:-1]
    if base in ("1", "L", "P") and suffix in ("", "1", "2", "4"):
        bits = 1 if base == "1" else int(suffix or 8)
        if bits == 8:
            v = rows[:, :w]
        else:
            v = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
            v = (v * (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)).sum(
                2, dtype=np.uint8)
            if base != "P":
                v = v * np.uint8({1: 255, 2: 85, 4: 17}[bits])
        return (~v if invert else v).astype(np.uint8)
    if base == "I":                                   # 16-bit grey
        order = {"16": "<", "16B": ">", "16N": "="}[suffix]
        return rows[:, :2 * w].reshape(h, -1).view(order + "u2")[:, :w]
    if suffix.startswith("16"):
        n = {"RGB": 3}.get(base, 4)
        px = rows[:, :2 * n * w].reshape(h, w, n, 2)
        high = 0 if suffix == "16B" or (suffix == "16N" and sys.byteorder == "big") else 1
        px = px[..., high]
        if base == "RGBX":
            return np.ascontiguousarray(px[..., :3])
        return _unpremultiply(px) if base == "RGBa" else np.ascontiguousarray(px)
    n = len(base)
    px = rows[:, :n * w].reshape(h, w, n)
    if base in ("LA", "PA"):
        return np.ascontiguousarray(px)
    if base in ("PX",):
        return np.ascontiguousarray(px[..., 0])
    if base.startswith("RGBa"):
        return _unpremultiply(px[..., :4])
    if base.startswith(("RGBA", "CMYK")):
        return np.ascontiguousarray(px[..., :4])
    return np.ascontiguousarray(px[..., :3])          # RGB, RGBX, RGBXX, RGBXXX


def _tiff_canvas(mode: str, w: int, h: int) -> np.ndarray:
    bands = len(_TIFF_BANDS[mode])
    dtype = np.uint16 if mode.startswith("I;16") else np.uint8
    return np.zeros((h, w) if bands == 1 else (h, w, bands), dtype)


def _tiff_raw_image(f: _TiffFile, fault: int) -> np.ndarray:
    """ImageFile.load over the raw tiles: sorted by offset, consecutive
    duplicates kept last, each read from its offset to its last row (the
    file ends first: truncated), unpacked into its box."""
    w, h = f.tile_size
    img = _tiff_canvas(f.mode, w, h)
    bands = _TIFF_BANDS[f.mode]
    tiles = sorted(f.tiles, key=lambda t: t[1])
    kept = []
    for t in tiles:
        if kept and (kept[-1][0], kept[-1][2:]) == (t[0], t[2:]):
            kept[-1] = t
        else:
            kept.append(t)
    for (x0, y0, x1, y1), offset, raw, stride in kept:
        if not all(isinstance(v, int) for v in (x0, y0, x1, y1, offset)):
            _tiff_broken("non-integer tile")
        tw, th = x1 - x0, y1 - y0
        if tw <= 0 or th <= 0 or x1 > w or y1 > h:
            _tiff_broken("tile cannot extend outside image")
        if offset < 0:
            _tiff_broken("negative seek value")
        band = raw not in _TIFF_RAW_MODES     # a plane's band unpacker
        if band and (len(raw) != 1 or raw not in bands):
            _tiff_broken(f"unknown raw mode {raw!r}")
        line = (tw * _tiff_raw_bits(raw) + 7) // 8
        skip = stride - line if stride else 0
        if skip < 0:
            _tiff_broken("tile rows wider than their stride")
        pitch = line + skip
        if offset + (th - 1) * pitch + line > len(f.data):
            raise ImageCodecError("truncated TIFF file (image data too short)")
        buf = np.frombuffer(f.data, np.uint8, count=(th - 1) * pitch + line,
                            offset=offset)
        rows = np.lib.stride_tricks.as_strided(buf, (th, line), (pitch, 1))
        if band:
            img[y0:y1, x0:x1, bands.index(raw)] = rows[:, :tw]
        else:
            img[y0:y1, x0:x1] = _tiff_unpack(np.ascontiguousarray(rows), raw, tw)
    return img


_TIFF_RAW_MODES = {raw for _, raw in _TIFF_OPEN_INFO.values()}
# Pillow's unpackers for the libtiff decoder's raw modes: OPEN_INFO's pairs,
# 16-bit ones in native order, YCbCr JPEG as "RGB"
_TIFF_UNPACKERS = set(_TIFF_OPEN_INFO.values()) | {
    (mode, raw[:-1] + "N") for mode, raw in _TIFF_OPEN_INFO.values()
    if raw.endswith(("16B", "16L"))} | {("I;16", "I;16N")}


# -- libtiff's strip and tile reading, as Pillow's libtiff decoder drives it

_INT_MAX = 2 ** 31 - 1


def _inflate(src: bytes, occ: int, partial: bool) -> Tuple[bytes, bool]:
    """ZIPDecode: (the bytes inflated into a buffer of ``occ``, whether it
    filled without a zlib error); after an error, the bytes inflated before
    it only if ``partial`` (else none)."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(src, occ)
        return out, len(out) == occ
    except zlib.error:
        if not partial:
            return b"", False
    d, parts = zlib.decompressobj(), []   # the output before the error
    try:
        for i in range(len(src)):
            parts.append(d.decompress(src[i:i + 1], occ - sum(map(len, parts))))
    except zlib.error:
        pass
    return b"".join(parts)[:occ], False


class _LibtiffReader:
    """TIFFReadEncodedStrip / TIFFReadEncodedTile over the directory
    libtiff read: each returns (buffer, ok), the buffer holding what libtiff
    leaves in it when the decode fails."""

    def __init__(self, f: _TiffFile, lt: _LibtiffDir, upsampled: bool, fault: int,
                 partial: bool = False):
        """``partial``: a strip that fails to decode is used as far as it
        decoded (TIFFRGBAImage), not refused."""
        self.f, self.lt, self.up, self.fault = f, lt, upsampled, fault
        self.partial = partial
        self.swab = (f.e == ">") != (sys.byteorder == "big")
        self.setup_error = None
        if lt.compression in (5, 8, 32946):
            if lt.predictor == 2 and lt.bps not in (8, 16, 32, 64):
                self.setup_error = "predictor with samples of that size"
            elif lt.predictor == 3 and lt.sampleformat != 3:
                self.setup_error = "floating-point predictor on integers"
            elif lt.predictor not in (1, 2, 3):
                self.setup_error = f"predictor {lt.predictor}"
            elif lt.predictor != 1 and lt.bps not in (8, 16):
                raise ImageCodecError(f"TIFF of a predictor on {lt.bps}-bit "
                                      f"samples is not supported")
        if lt.compression == 7:
            self.tables = lt.jpegtables or b""
            if self.tables and (len(self.tables) < 2 or self.tables[:2] != b"\xff\xd8"):
                self.setup_error = "bogus JPEGTables field"

    def _fill(self, index: int, size: int) -> bytes:
        """TIFFFillStrip / TIFFFillTile: the strip's bytes, bit-reversed
        under FillOrder 2."""
        lt = self.lt
        count, off = lt.bytecounts[index], lt.offsets[index]
        if count == 0 or count > 2 ** 63 - 1:
            raise _LibtiffError(f"invalid byte count {count}")
        if count > 1 << 20 and size and (count - 4096) // 10 > size:
            count = size * 10 + 4096
        if count > len(self.f.data) or off > len(self.f.data) - count:
            raise _LibtiffError("read error on a strip")
        raw = self.f.data[off:off + count]
        if lt.fillorder == 2:
            raw = _reverse_bits(np.frombuffer(raw, np.uint8)).tobytes()
        if self.setup_error:
            raise _LibtiffError(self.setup_error)
        return raw

    def read(self, index: int, size: int, rowsize: int, segment: tuple,
             buf: Optional[np.ndarray] = None):
        """Decode strip or tile ``index`` (``size`` bytes in rows of
        ``rowsize``; ``segment`` = its width, height and whether it is the
        image's last strip) into ``buf`` (a new zeroed buffer when None):
        (buf, ok). Raises _LibtiffError where it cannot be filled."""
        lt = self.lt
        raw = self._fill(index, size)
        out = np.zeros(size, np.uint8) if buf is None else buf
        err = ctypes.create_string_buffer(_ERR_LEN)
        src = np.frombuffer(raw, np.uint8)
        if lt.compression == 5:
            if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
                raise ImageCodecError("TIFF of old-style LZW codes is not "
                                      "supported")
            ok = _lib().cpt_tiff_lzw(_ptr(src), src.size, _ptr(out), size,
                                     self.fault, err, _ERR_LEN) >= 0
        elif lt.compression == 32773:
            ok = _lib().cpt_tiff_packbits(_ptr(src), src.size, _ptr(out), size,
                                          err, _ERR_LEN) >= 0
        elif lt.compression in (8, 32946):
            got, ok = _inflate(raw, size, self.partial)
            out[:len(got)] = np.frombuffer(got, np.uint8)
        else:
            self._jpeg(raw, out, size, rowsize, segment)
            return out, True
        if not ok:
            return out, False
        if lt.compression != 32773 and lt.predictor == 2:
            if size % rowsize:
                return out, False
            if not self.fault & FAULTS["tiff_no_predictor"]:
                _check(_lib().cpt_tiff_unpredict(
                    _ptr(out), size // rowsize, rowsize,
                    lt.spp if lt.planar == 1 else 1, lt.bps // 8,
                    int(self.swab), err, _ERR_LEN), err)
            return out, True
        if lt.bps == 16 and self.swab:
            out[:size & ~1] = out[:size & ~1].view(np.uint16).byteswap().view(np.uint8)
        return out, True

    def _jpeg(self, raw: bytes, out: np.ndarray, size: int, rowsize: int,
              segment: tuple) -> None:
        """JPEGPreDecode's checks, then JPEGDecode of the strip or tile
        (raises _LibtiffError where libtiff or libjpeg fails)."""
        lt = self.lt
        sw, sh, last = segment
        info = (ctypes.c_int * 23)()
        err = ctypes.create_string_buffer(_ERR_LEN)
        tables = self.tables
        if _lib().cpt_jpeg_frame_tiff(tables or None, len(tables), raw, len(raw),
                                      info, err, _ERR_LEN) < 0:
            raise _LibtiffError(err.value.decode(errors="replace"))
        jw, jh, nc = info[0], info[1], info[2]
        if not (jw == sw and jh > sh and last) and (jw > sw or jh > sh):
            raise _LibtiffError("JPEG strip or tile larger than expected")
        if nc != (lt.spp if lt.planar == 1 else 1):
            raise _LibtiffError("improper JPEG component count")
        ycbcr = lt.planar == 1 and lt.photometric == 6
        if (info[3], info[4]) != (lt.subsampling if ycbcr else (1, 1)) or any(
                (info[3 + 2 * c], info[4 + 2 * c]) != (1, 1) for c in range(1, nc)):
            raise _LibtiffError("improper JPEG sampling factors")
        if jw < sw or jh < sh:
            raise ImageCodecError("TIFF of JPEG strips or tiles smaller than "
                                  "their space is not supported")
        fault = (FAULTS["replicate_upsample"]
                 if self.fault & FAULTS["tiff_jpeg_replicate"] else 0)
        px = np.empty(jw * jh * (3 if ycbcr else nc), np.uint8)
        if _lib().cpt_jpeg_decode_tiff(tables or None, len(tables), raw, len(raw),
                                       int(ycbcr), _ptr(px), fault, err,
                                       _ERR_LEN) < 0:
            raise _LibtiffError(err.value.decode(errors="replace"))
        n = min(size // rowsize, jh) * rowsize
        out[:n] = px[:n]


def _tiff_color_channels(photometric: int) -> int:
    """_TIFFGetMaxColorChannels."""
    return {0: 1, 1: 1, 3: 1, 4: 1, 32844: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3,
            32845: 3, 5: 4}.get(photometric, 0)


def _tiff_plane(rows: np.ndarray, plane: int, bits: int, w: int) -> np.ndarray:
    """_pickUnpackers' plane unpacker: "R" / "G" / "B" ("R;16N" ... at 16
    bits: the high byte) for planes 0-2, "A" (8 bits) for plane 3."""
    if bits == 16 and plane < 3:
        return (rows[:, :2 * w].view("=u2") >> 8).astype(np.uint8)
    return rows[:, :w]


def _tiff_libtiff_image(f: _TiffFile, fault: int) -> np.ndarray:
    """Pillow's ImagingLibTiffDecode: the directory as libtiff reads it,
    then the strips or tiles (or, for YCbCr not in JPEG, TIFFRGBAImage)
    unpacked by Pillow's unpacker for the file's raw mode."""
    w, h = f.tile_size
    if (f.mode, f.raw) not in _TIFF_UNPACKERS:
        _tiff_broken(f"unknown raw mode {f.raw!r} for mode {f.mode!r}")
    try:
        lt = _LibtiffDir(f)
    except _LibtiffError as e:
        _tiff_broken(f"libtiff: {e}")
    if (lt.width, lt.length) != (w, h):
        _tiff_broken("libtiff reads another size")
    extras = list(lt.extrasamples)
    colors = _tiff_color_channels(lt.photometric)
    if colors and lt.spp - len(extras) > colors:
        extras += [0] * (lt.spp - colors - len(extras))
    try:
        if lt.photometric == 6 and not (lt.compression == 7 and lt.planar == 1):
            return _tiff_rgba(f, lt, fault)
        return _tiff_planes(f, lt, fault, extras)
    except _LibtiffError as e:
        _tiff_broken(f"libtiff: {e}")


def _tiff_planes(f: _TiffFile, lt: _LibtiffDir, fault: int, extras: list) -> np.ndarray:
    """_decodeStrip / _decodeTile."""
    w, h = f.tile_size
    up = lt.photometric == 6
    reader = _LibtiffReader(f, lt, up, fault)
    img = _tiff_canvas(f.mode, w, h)
    bits = _tiff_raw_bits(f.raw)
    bands = len(_TIFF_BANDS[f.mode])
    planes = 1
    if lt.planar == 2 and bands > 1:
        if lt.bps not in (8, 16):
            _tiff_broken("bits per sample of a separate plane")
        planes = bands

    def paste(rows: np.ndarray, plane: int, y: int, x: int, n: int) -> None:
        if planes == 1:
            img[y:y + len(rows), x:x + n] = _tiff_unpack(rows, f.raw, n)
        elif plane < bands and not (bands == 2 and plane == 1):
            img[y:y + len(rows), x:x + n, plane] = _tiff_plane(rows, plane, lt.bps, n)

    if not lt.tiled:
        row_bytes = lt.scanline_size(up)
        if row_bytes <= 0 or row_bytes != (w * bits // planes + 7) // 8:
            _tiff_broken("scanline size differs from its pixels'")
        rps = h if lt.rowsperstrip in (None, 0xFFFFFFFF) else lt.rowsperstrip
        if _INT_MAX // row_bytes < rps:
            _tiff_broken("strip too large")
        rps_lt = min(lt.rowsperstrip_, lt.length)
        per_plane = _howmany(lt.length, rps_lt)
        for y in range(0, h, rps):
            for plane in range(planes):
                strip = y // lt.rowsperstrip_ + (plane * lt.stripsperimage
                                                 if lt.planar == 2 else 0)
                if strip >= lt.nstrips:
                    _tiff_broken("strip out of range")
                first = (strip % per_plane) * rps_lt
                rows = min(lt.length - first, rps_lt)
                size = min(lt.strip_size(rows, up), row_bytes * rps)
                if size <= 0:
                    _tiff_broken("zero strip size")
                top = (strip % lt.stripsperimage) * lt.rowsperstrip_
                seg_h = min(lt.length - top, lt.rowsperstrip_)
                buf, ok = reader.read(strip, size, row_bytes,
                                      (lt.width, seg_h, top + seg_h == lt.length))
                if not ok:
                    _tiff_broken("libtiff fails to decode a strip")
                n = min(rps, h - y)
                paste(buf[:n * row_bytes].reshape(n, row_bytes), plane, y, 0, w)
    else:
        tw, th = lt.tilewidth, lt.tilelength
        row_bytes = lt.tile_row_size()
        if (tw <= 0 or th <= 0 or row_bytes <= 0
                or row_bytes != (tw * bits // planes + 7) // 8):
            _tiff_broken("tile row size differs from its pixels'")
        if _INT_MAX // row_bytes < th:
            _tiff_broken("tile too large")
        size = lt.tile_size(up)
        across, down = _howmany(lt.width, tw), _howmany(lt.length, th)
        pixel = bits // planes // 8 or 1
        for y in range(0, h, th):
            for plane in range(planes):
                for x in range(0, w, tw):
                    if lt.planar == 2 and plane >= lt.spp:
                        _tiff_broken("sample out of range")
                    tile = (across * (y // th) + x // tw
                            + (across * down * plane if lt.planar == 2 else 0))
                    if tile >= lt.nstrips:
                        _tiff_broken("tile out of range")
                    buf, ok = reader.read(tile, size, row_bytes, (tw, th, False))
                    if not ok:
                        _tiff_broken("libtiff fails to decode a tile")
                    cw, ch = min(tw, w - x), min(th, h - y)
                    pitch = row_bytes
                    if cw < tw and fault & FAULTS["tiff_edge_tile_stride"]:
                        pitch = cw * pixel
                    rows = np.lib.stride_tricks.as_strided(
                        buf, (ch, row_bytes), (pitch, 1))
                    paste(np.ascontiguousarray(rows), plane, y, x, cw)
    if planes > 3 and f.mode == "RGBA" and extras[:1] in ([0], [1]):
        img = _unpremultiply(img)
    return img


_TIFF_YCBCR_SAMPLING = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def _tiff_rgba(f: _TiffFile, lt: _LibtiffDir, fault: int) -> np.ndarray:
    """_decodeAsRGBA for YCbCr that is not in JPEG: TIFFRGBAImageGet a strip
    (or a row of tiles) at a time into an RGBA raster (the put routines'
    replicated chroma; a strip that fails to decode used as far as libtiff
    left it), its rows then read by Pillow's unpacker for the raw mode."""
    w, h = f.tile_size
    if lt.planar != 1:
        raise ImageCodecError("TIFF of YCbCr in separate planes is not "
                              "supported")
    if lt.bps != 8 or lt.spp != 3 or lt.subsampling not in _TIFF_YCBCR_SAMPLING:
        _tiff_broken("libtiff cannot handle this YCbCr format")
    coeffs = np.array(lt.coeffs or (0.299, 0.587, 0.114), np.float32)
    rbw = np.array(lt.refbw or (0, 255, 128, 255, 128, 255), np.float32)
    if np.isnan(coeffs).any() or coeffs[1] == 0:
        _tiff_broken("invalid YCbCrCoefficients")
    if not ((rbw > np.float32(-0x7FFFFFFF + 128)) & (rbw < np.float32(0x7FFFFFFF))).all():
        _tiff_broken("invalid ReferenceBlackWhite")
    hs, vs = lt.subsampling
    block = hs * vs + 2
    reader = _LibtiffReader(f, lt, False, fault, partial=True)
    out = np.zeros((h, w, 4), np.uint8)
    out[..., 3] = 255
    err = ctypes.create_string_buffer(_ERR_LEN)

    def put(buf: np.ndarray, rows: int, width: int, per_row: int) -> np.ndarray:
        rgb = np.empty((rows, width, 3), np.uint8)
        need = _howmany(rows, vs) * per_row * block
        src = buf if buf.size >= need else np.concatenate(
            [buf, np.zeros(need - buf.size, np.uint8)])
        _check(_lib().cpt_tiff_ycbcr(_ptr(src), per_row, hs, vs, width, rows,
                                     _ptr(coeffs), _ptr(rbw), _ptr(rgb), err,
                                     _ERR_LEN), err)
        return rgb

    if not lt.tiled:
        step = h if lt.rowsperstrip_ == 0xFFFFFFFF else lt.rowsperstrip_
        rps_lt = min(lt.rowsperstrip_, lt.length)
        scan = lt.scanline_size()
        for y in range(0, h, step):
            n = min(step, h - y)
            strip = y // lt.rowsperstrip_
            if strip >= lt.nstrips:
                _tiff_broken("strip out of range")
            first = strip * rps_lt
            this = lt.strip_size(min(lt.length - first, rps_lt))
            size = min(this, _howmany(n, vs) * vs * scan)
            buf = np.zeros(lt.strip_size(rps_lt), np.uint8)
            reader.read(strip, size, scan, (lt.width, n, False), buf)
            out[y:y + n, :, :3] = put(buf, n, w, _howmany(w, hs))
    else:
        tw, th = lt.tilewidth, lt.tilelength
        size = lt.tile_size()
        across = _howmany(lt.width, tw)
        for y in range(0, h, th):
            n = min(th, h - y)
            buf, row = None, np.zeros((n, w, 3), np.uint8)
            for x in range(0, w, tw):
                tile = across * (y // th) + x // tw
                if tile >= lt.nstrips and buf is None:
                    _tiff_broken("tile out of range")
                if tile < lt.nstrips:   # out of range: the buffer as it was
                    try:
                        buf, _ = reader.read(tile, size, lt.tile_row_size(),
                                             (tw, th, False), buf)
                    except _LibtiffError:
                        if buf is None:
                            raise
                        buf[:] = 0      # TIFFReadEncodedTile zeroes it
                cw = min(tw, w - x)
                # the put routines skip (tw - cw) // hs blocks a row after a
                # cropped tile's ceil(cw / hs): a row of blocks unless tw is
                # odd (as libtiff counts it)
                row[:, x:x + cw] = put(buf, n, cw, _howmany(cw, hs) + (tw - cw) // hs)
            out[y:y + n, :, :3] = row
    # the RGBA raster's rows through Pillow's unpacker for the file's raw mode
    return _tiff_unpack(out.reshape(h, 4 * w), f.raw, w)


# Pillow's ImageOps.exif_transpose, by the Orientation tag's value
_TIFF_TRANSPOSE = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
                   4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
                   6: lambda a: a.swapaxes(0, 1)[:, ::-1],
                   7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
                   8: lambda a: a.swapaxes(0, 1)[::-1]}


def _tiff_header(data: bytes) -> _TiffFile:
    """The first image as Image.open finds it (raises where it raises; a
    size over twice MAX_IMAGE_PIXELS raises, as Pillow's bomb check does)."""
    f = _TiffFile(data)
    w, h = f.size
    _check_size(max(1, w), max(1, h))
    return f


def _decode_tiff(data: bytes, fault: int) -> Tuple[np.ndarray, str, object]:
    """The first image → (pixels, mode, palette table or None) in a mode
    ``_convert`` takes: 16-bit grey clipped to L, CMYK through Pillow's
    cmyk2rgb, a palette's alpha dropped; Pillow's exif_transpose applied."""
    f = _tiff_header(data)
    w, h = f.tile_size
    if w <= 0 or h <= 0:
        _tiff_broken("empty image")
    if f.compression == "raw":
        img = _tiff_raw_image(f, fault)
    else:
        img = _tiff_libtiff_image(f, fault)
    mode, table = f.mode, None
    if mode in ("P", "PA"):
        n = len(f.palette) // 3
        if n > 256:
            _tiff_broken("invalid palette size")
        table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        pal = np.frombuffer(f.palette, np.uint8)
        table[:n] = pal[:3 * n].reshape(3, n).T
        if fault & FAULTS["tiff_colormap_low_byte"]:
            low = np.array([v & 0xFF for v in f.get(320)][:3 * n], np.uint8)
            table[:n] = low.reshape(3, n).T
        if mode == "PA":
            img, mode = np.ascontiguousarray(img[..., 0]), "P"
    elif mode.startswith("I;16"):
        img, mode = np.minimum(img, 255).astype(np.uint8), "L"
    elif mode == "CMYK":
        rgb = np.empty(img.shape[:2] + (3,), np.uint8)
        _lib().cpt_cmyk_to_rgb(_ptr(np.ascontiguousarray(img)), img.shape[0] * img.shape[1],
                               _ptr(rgb))
        img, mode = rgb, "RGB"
    transpose = _TIFF_TRANSPOSE.get(f.orientation)
    if transpose is not None:
        img = np.ascontiguousarray(transpose(img))
    return img, mode, table


def encode_tiff(arr: np.ndarray) -> bytes:
    """The bytes of ``Image.fromarray(arr).save(f, format="TIFF")`` for a
    uint8 ``[H, W]`` (L) or ``[H, W, 3]`` (RGB) array: Pillow's own writer
    (no libtiff), little-endian, uncompressed, one strip; its tags in
    ascending order, BitsPerSample out of line for RGB."""
    px = np.ascontiguousarray(arr, np.uint8)
    if px.ndim == 3 and px.shape[2] == 1:
        px = px[:, :, 0]
    if px.ndim not in (2, 3) or (px.ndim == 3 and px.shape[2] != 3) or not px.size:
        raise ImageCodecError(f"TIFF encoder takes non-empty [H, W] or [H, W, "
                              f"3] arrays, got shape {tuple(np.shape(arr))}")
    h, w = px.shape[:2]
    spp = 1 if px.ndim == 2 else 3
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp), (259, 3, [1]),
            (262, 3, [1 if spp == 1 else 2]), (273, 4, [0])]
    tags += [(277, 3, [3])] if spp == 3 else []
    tags += [(278, 4, [h]), (279, 4, [w * spp * h]), (284, 3, [1])]
    aux_at = 8 + 2 + 12 * len(tags) + 4
    entries, aux = b"", b""
    for tag, typ, vals in tags:
        body = struct.pack(f"<{len(vals)}{'H' if typ == 3 else 'L'}", *vals)
        if len(body) > 4:
            entries += struct.pack("<HHLL", tag, typ, len(vals), aux_at + len(aux))
            aux += body + b"\0" * (len(body) & 1)
        else:
            entries += struct.pack("<HHL", tag, typ, len(vals)) + body.ljust(4, b"\0")
    at = entries.index(struct.pack("<HHL", 273, 4, 1)) + 8
    data_at = aux_at + len(aux)
    entries = entries[:at] + struct.pack("<L", data_at) + entries[at + 4:]
    return (b"II*\0" + struct.pack("<LH", 8, len(tags)) + entries
            + struct.pack("<L", 0) + aux + px.tobytes())


# ------------------------------------------------------------------- API

_READS = ("JPEG, PNG, GIF, BMP, DIB, WEBP, TIFF, PPM (netpbm), TGA, PSD, ICO, "
          "CUR, SGI, PCX, DCX, QOI, SUN, IM, MSP, XBM and XPM are")


def _prefix(*magics: bytes):
    return lambda p: p.startswith(magics)


def _taken(data: bytes):
    """A reader that parses its own header: the format is taken on its
    prefix, as it was before the ordered table (its header errors fail)."""
    return None


@functools.lru_cache(maxsize=None)
def _formats() -> tuple:
    """Pillow 12.1's Image.open order: (format, its ``_accept`` on the first
    16 bytes or None (tried on every file), the opener (its ``_open``:
    NotThis to go on to the next format), the reader or None when this
    codec does not read the format). First the plugins Image.preinit
    loads, then Image._plugins' in turn."""
    rf = _rf
    jpeg2k = _prefix(b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")
    return (
        ("BMP", _prefix(b"BM"), _taken, _decode_bmp),
        ("DIB", rf.dib_accept, rf.dib_open, rf.dib_decode),
        ("GIF", _prefix(b"GIF87a", b"GIF89a"), _taken, _decode_gif),
        ("JPEG", _prefix(b"\xff\xd8\xff"), _taken, None),
        ("PPM", rf.ppm_accept, rf.ppm_open, rf.ppm_decode),
        ("PNG", _prefix(PNG_SIGNATURE), _taken, _decode_png),
        ("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in (
            b"avif", b"avis", b"mif1", b"msf1"), None, None),
        ("BLP", _prefix(b"BLP1", b"BLP2"), None, None),
        ("BUFR", _prefix(b"BUFR", b"ZCZC"), None, None),
        ("CUR", _prefix(b"\0\0\2\0"), rf.cur_open, rf.cur_decode),
        ("PCX", rf.pcx_accept, rf.pcx_open, rf.pcx_decode),
        ("DCX", rf.dcx_accept, rf.dcx_open, rf.dcx_decode),
        ("DDS", _prefix(b"DDS "), None, None),
        ("EPS", lambda p: p.startswith(b"%!PS") or p[:4] == b"\xc5\xd0\xd3\xc6",
         None, None),
        ("FITS", _prefix(b"SIMPLE"), None, None),
        ("FLI", lambda p: (len(p) >= 16 and struct.unpack_from("<H", p, 4)[0]
                           in (0xAF11, 0xAF12)
                           and struct.unpack_from("<H", p, 14)[0] in (0, 3)),
         rf.fli_probe, None),
        ("FTEX", _prefix(b"FTEX"), None, None),
        ("GBR", lambda p: (len(p) >= 8 and struct.unpack_from(">I", p)[0] >= 20
                           and struct.unpack_from(">I", p, 4)[0] in (1, 2)),
         rf.gbr_probe, None),
        ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
         None, None),
        ("HDF5", _prefix(b"\x89HDF\r\n\x1a\n"), None, None),
        ("JPEG2000", jpeg2k, None, None),
        ("ICNS", _prefix(b"icns"), None, None),
        ("ICO", rf.ico_accept, rf.ico_open, rf.ico_decode),
        ("IM", None, rf.im_open, rf.im_decode),
        ("IMT", None, rf.imt_probe, None),
        ("IPTC", None, rf.iptc_probe, None),
        ("MCIDAS", _prefix(b"\x00\x00\x00\x00\x00\x00\x00\x04"), None, None),
        ("MPEG", _prefix(b"\x00\x00\x01\xb3"), None, None),
        ("TIFF", _prefix(*_TIFF_PREFIXES), _taken, _decode_tiff),
        ("MSP", rf.msp_accept, rf.msp_open, rf.msp_decode),
        ("PCD", None, rf.pcd_probe, None),
        ("PIXAR", _prefix(b"\200\350\000\000"), None, None),
        ("PSD", rf.psd_accept, rf.psd_open, rf.psd_decode),
        ("QOI", rf.qoi_accept, rf.qoi_open, rf.qoi_decode),
        ("SGI", rf.sgi_accept, rf.sgi_open, rf.sgi_decode),
        ("SPIDER", None, rf.spider_probe, None),
        ("SUN", rf.sun_accept, rf.sun_open, rf.sun_decode),
        ("TGA", None, rf.tga_open, rf.tga_decode),
        ("WEBP", lambda p: (p.startswith(b"RIFF") and p[8:12] == b"WEBP"
                            and p[12:16] in _WEBP_CHUNKS), _taken, _decode_webp),
        ("WMF", _prefix(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"), None, None),
        ("XBM", rf.xbm_accept, rf.xbm_open, rf.xbm_decode),
        ("XPM", rf.xpm_accept, rf.xpm_open, rf.xpm_decode),
        ("XVTHUMB", _prefix(b"P7 332"), None, None),
    )


def _identify(data: bytes) -> Tuple[str, object]:
    """(format, header) as ``Image.open`` identifies the file: each format
    in Pillow's order whose prefix test passes, until one's ``_open``
    takes the file (its size positive, then the decompression-bomb check).
    A format this codec does not read raises, naming it."""
    prefix = data[:16]
    for name, accept, opener, reader in _formats():
        if accept is not None and not accept(prefix):
            continue
        if opener is None:
            raise ImageCodecError(f"{name} images are not supported ({_READS})")
        try:
            hdr = opener(data)
        except _rf.NotThis:
            continue
        if opener is _taken:
            return name, None
        if reader is None:
            raise ImageCodecError(f"{name} images are not supported ({_READS})")
        try:     # ImageFile's check: a mode, a positive size (a TypeError
            w, h = hdr["size"][0], hdr["size"][1]    # goes on too)
        except TypeError:
            continue
        if not hdr["mode"] or w <= 0 or h <= 0:
            continue
        _check_size(w, h)
        return name, hdr
    raise ImageCodecError(f"cannot identify image file ({_READS})")


def decode(data: bytes, mode: str = "RGB") -> np.ndarray:
    """``np.asarray(Image.open(io.BytesIO(data)).convert(mode))`` for any
    of the formats of ``_READS``: uint8 ``[H, W, 3]`` for ``"RGB"``,
    ``[H, W]`` for ``"L"``."""
    return _decode(data, mode, 0)


def _decode(data: bytes, mode: str, fault: int) -> np.ndarray:
    """:func:`decode` with ``fault`` (bits of FAULTS) set."""
    data = bytes(data)
    fmt, hdr = _identify(data)
    if fmt == "JPEG":
        arr = _decode_jpeg(data, fault)
        return _convert(arr, "RGB" if arr.ndim == 3 else "L", mode)
    reader = {name: r for name, _, _, r in _formats()}[fmt]
    if hdr is None:
        arr, src, palette = reader(data, fault)
    else:
        arr, src, palette = reader(data, hdr, fault)
    return _convert(arr, src, mode, palette)


def _read(data_or_path) -> bytes:
    if isinstance(data_or_path, (bytes, bytearray, memoryview)):
        return bytes(data_or_path)
    with open(data_or_path, "rb") as f:
        return f.read()


def image_size(data_or_path) -> Tuple[int, int]:
    """(width, height) from the file's header alone (``Image.open(f).size``;
    an icon, which Image.open loads, from its pixels)."""
    data = _read(data_or_path)
    fmt, hdr = _identify(data)
    if hdr is not None:
        size = hdr["size"]
        if not (len(size) == 2 and all(isinstance(v, int) for v in size)):
            raise ImageCodecError(f"{fmt} image of size {size!r}")
        return size
    if fmt == "JPEG":
        w, h, _ = _jpeg_open(data)
        return w, h
    if fmt == "GIF":
        return _gif_header(data)["size"]
    if fmt == "BMP":
        return _bmp_header(data)["size"]
    if fmt == "WEBP":
        return _webp_header(data)["size"]
    if fmt == "TIFF":
        return _tiff_header(data).size
    hdr = _png_header(data)
    return hdr["width"], hdr["height"]


def read_image(path, mode: str = "RGB") -> np.ndarray:
    """``np.asarray(Image.open(path).convert(mode))``."""
    return decode(_read(path), mode)


# the extensions Pillow's registered_extensions() maps to the formats
# written here (or, for MSP and XBM, whose writers refuse an RGB or L image)
_WRITE_EXTENSIONS = {
    ".jpg": "JPEG", ".jpeg": "JPEG", ".jpe": "JPEG", ".jfif": "JPEG", ".png": "PNG",
    ".bmp": "BMP", ".dib": "DIB", ".tif": "TIFF", ".tiff": "TIFF",
    ".pbm": "PPM", ".pgm": "PPM", ".ppm": "PPM", ".pnm": "PPM", ".pfm": "PPM",
    ".tga": "TGA", ".icb": "TGA", ".vda": "TGA", ".vst": "TGA",
    ".bw": "SGI", ".rgb": "SGI", ".rgba": "SGI", ".sgi": "SGI",
    ".pcx": "PCX", ".qoi": "QOI", ".msp": "MSP", ".xbm": "XBM"}


def write_image(path_or_file, arr: np.ndarray, format: Optional[str] = None,
                quality: Optional[int] = None) -> None:
    """``Image.fromarray(arr).save(path_or_file, format, quality=...)`` for
    JPEG, PNG, BMP, DIB, TIFF, PPM, TGA, SGI, PCX and QOI: the format from
    ``format`` or the file's extension as Pillow maps it, JPEG at
    ``quality`` (75 when None, Pillow's default). MSP and XBM refuse an RGB
    or L array, as Pillow's writers do."""
    fmt = (format or "").upper()
    name = (os.fspath(path_or_file) if isinstance(path_or_file, (str, os.PathLike))
            else getattr(path_or_file, "name", ""))
    name = name if isinstance(name, str) else ""
    if not fmt:
        ext = Path(name).suffix.lower()
        fmt = _WRITE_EXTENSIONS.get(ext, "")
        if not fmt:
            raise ImageCodecError(f"cannot tell the image format of {name!r} (use "
                                  f"{', '.join(sorted(_WRITE_EXTENSIONS))})")
    if fmt in ("JPEG", "JPG"):
        data = encode_jpeg(arr, JPEG_QUALITY if quality is None else quality)
    elif fmt == "PNG":
        data = encode_png(arr)
    elif fmt == "BMP":
        data = encode_bmp(arr)
    elif fmt in ("TIFF", "TIF"):
        data = encode_tiff(arr)
    elif fmt in ("MSP", "XBM"):
        raise ImageCodecError(f"cannot write mode {'L' if np.ndim(arr) == 2 else 'RGB'} "
                              f"as {fmt}")
    elif fmt in ("DIB", "PPM", "TGA", "PCX", "QOI", "SGI"):
        encode = {"DIB": _rf.encode_dib, "PPM": _rf.encode_ppm, "TGA": _rf.encode_tga,
                  "PCX": _rf.encode_pcx, "QOI": _rf.encode_qoi}.get(fmt)
        data = _rf.encode_sgi(arr, name) if fmt == "SGI" else encode(arr)
    else:
        raise ImageCodecError(f"writing {fmt} images is not supported (JPEG, PNG, BMP, "
                              "DIB, TIFF, PPM, TGA, SGI, PCX and QOI are)")
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "wb") as f:
            f.write(data)


from cpt_tpu_torch.utils import raster_formats as _rf  # noqa: E402  (it uses this module's readers)
