"""Reading and writing JPEG, PNG, GIF, BMP and WEBP files without Pillow
(the port's counterpart of the ``Image.open(...).convert(...)`` and
``Image.save`` calls the JAX package makes).

``decode`` gives Pillow 12.1's pixels bit for bit, converted to ``"RGB"``
or ``"L"`` by Pillow's rules: for a JPEG the pixels of libjpeg-turbo's
default decompression (islow IDCT, fancy upsampling, its fixed-point YCbCr
and YCCK conversions; a CMYK or YCCK file inverted as Pillow unpacks it,
then through its cmyk2rgb), for a PNG those of Pillow's reader (16-bit
samples: a grey one clipped at 255, colour ones cut to their high byte),
for a GIF its first frame as ``Image.open`` gives it (mode ``P`` or ``L``,
a short palette padded with black, the transparent index left as it is),
for a BMP those of Pillow's BmpImagePlugin (core, info, V4 and V5 headers;
1, 4, 8, 16, 24 and 32 bits; RLE8, RLE4 and the bit fields it takes), for
a WEBP its first frame as libwebp 1.6.0's animation decoder gives it to
Pillow (lossy VP8 with its loop filter, fancy upsampling and fixed-point
YUV conversion; lossless VP8L; an ALPH alpha plane; an ANMF frame on a
transparent black canvas).
``encode_jpeg`` writes the bytes of Pillow's ``save(format="JPEG",
quality=q)`` with default options, ``encode_bmp`` those of
``save(format="BMP")``; ``encode_png`` writes a lossless PNG (its bytes
differ from Pillow's, whose zlib differs from Python's).

The JPEG codec, the PNG row filters, GIF's LZW, BMP's RLE
(``cpt_tpu_torch/csrc/image_codec.cpp``) and the WEBP decoders
(``csrc/webp_vp8.cpp``, ``csrc/webp_vp8l.cpp``) are host C++, built by
``kernels/build.py`` with the host C++ compiler at first use and called
through ``ctypes``; zlib and the RIFF container are Python's. A failed build
raises ``KernelError``; a file this module cannot read (TIFF, arithmetic /
lossless / 12-bit JPEG, other formats, truncated or damaged data) raises
:class:`ImageCodecError` naming its kind, and so does a file whose header
declares more than twice ``MAX_IMAGE_PIXELS`` (Pillow's decompression-bomb
limit), before anything is allocated for it. Nothing falls back to Pillow
or returns a partial image.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib
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
    # data, n, &width, &height, &ncomp, err, errlen
    "cpt_jpeg_header": ([_P, _L, _IP, _IP, _IP, _P, _I], _I),
    # data, n, out, fault, err, errlen
    "cpt_jpeg_decode": ([_P, _L, _P, _I, _P, _I], _I),
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

def _jpeg_header(data: bytes) -> Tuple[int, int, int]:
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_lib().cpt_jpeg_header(_ptr(data), len(data), ctypes.byref(w),
                                  ctypes.byref(h), ctypes.byref(c), err,
                                  _ERR_LEN), err)
    return w.value, h.value, c.value


def _decode_jpeg(data: bytes, fault: int) -> np.ndarray:
    """[H, W] (one component) or [H, W, 3] RGB (three; four, CMYK or YCCK,
    converted as Pillow's ``convert("RGB")`` does)."""
    w, h, c = _jpeg_header(data)
    out = np.empty((h, w) if c == 1 else (h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_lib().cpt_jpeg_decode(_ptr(data), len(data), _ptr(out), fault,
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
    table[:min(256, len(palette))] = palette[:256]
    return table


def _rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """Pillow's ``rgb2l``: ITU-R 601-2 luma in 16-bit fixed point."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _convert(arr: np.ndarray, src: str, mode: str,
             palette=None) -> np.ndarray:
    """``Image.convert(mode)`` for the modes the readers produce ("L;P":
    a GIF's mode L image holding a palette, see :func:`_gif_header`)."""
    if src == "L;P":
        if mode == "L":
            return arr
        src = "P"
    if src == "P":
        arr, src = _palette_table(palette)[arr], "RGB"
    if src == "1":
        src = "L"
    if src in ("LA", "RGBA"):
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


def _bmp_header(data: bytes) -> dict:
    """BmpImagePlugin's ``_bitmap``: the size, Pillow's mode and raw mode,
    the palette, the row stride and direction, the compression and the
    offset of the pixels."""
    def u32(at: int) -> int:
        return struct.unpack_from("<I", data, at)[0]

    def u16(at: int) -> int:
        return struct.unpack_from("<H", data, at)[0]

    if len(data) < 18:
        raise ImageCodecError("truncated BMP file (no header)")
    offset, size = u32(10), u32(14)
    if len(data) < 14 + size:
        raise ImageCodecError("truncated BMP file (data ends inside its "
                              "header)")
    pos = 14 + size
    colors = 0
    if size == 12:
        w, h, bits, compression, pad, direction = (u16(18), u16(20), u16(24),
                                                   0, 3, -1)
    elif size in (40, 52, 56, 64, 108, 124):
        flip = data[25] == 0xFF
        w, h = u32(18), (2 ** 32 - u32(22) if flip else u32(22))
        bits, compression, colors = u16(28), u32(30), u32(46)
        pad, direction = 4, (1 if flip else -1)
        if compression == 3:
            if size >= 52:
                masks = [u32(54 + 4 * i) for i in range(4 if size >= 56 else 3)]
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
            "compression": compression, "offset": offset}


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


def _decode_bmp(data: bytes, fault: int) -> Tuple[np.ndarray, str, object]:
    """→ (pixels, Pillow's mode, palette or None), as Image.open reads a
    BMP (rows bottom-up unless the height is negative)."""
    hdr = _bmp_header(data)
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


# ------------------------------------------------------------------- API

_READS = "JPEG, PNG, GIF, BMP and WEBP are"


def _format_of(data: bytes) -> str:
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data.startswith(b"BM"):
        return "BMP"
    if (data.startswith(b"RIFF") and data[8:12] == b"WEBP"
            and data[12:16] in _WEBP_CHUNKS):
        return "WEBP"
    for magic, name in ((b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF")):
        if data.startswith(magic):
            raise ImageCodecError(f"{name} images are not supported "
                                  f"({_READS})")
    raise ImageCodecError(f"cannot identify image file ({_READS})")


def decode(data: bytes, mode: str = "RGB") -> np.ndarray:
    """``np.asarray(Image.open(io.BytesIO(data)).convert(mode))`` for a
    JPEG, PNG, GIF, BMP or WEBP: uint8 ``[H, W, 3]`` for ``"RGB"``, ``[H, W]`` for
    ``"L"``."""
    return _decode(data, mode, 0)


def _decode(data: bytes, mode: str, fault: int) -> np.ndarray:
    """:func:`decode` with ``fault`` (bits of FAULTS) set."""
    data = bytes(data)
    fmt = _format_of(data)
    if fmt == "JPEG":
        arr = _decode_jpeg(data, fault)
        return _convert(arr, "RGB" if arr.ndim == 3 else "L", mode)
    reader = {"PNG": _decode_png, "GIF": _decode_gif, "BMP": _decode_bmp,
              "WEBP": _decode_webp}[fmt]
    arr, src, palette = reader(data, fault)
    return _convert(arr, src, mode, palette)


def _read(data_or_path) -> bytes:
    if isinstance(data_or_path, (bytes, bytearray, memoryview)):
        return bytes(data_or_path)
    with open(data_or_path, "rb") as f:
        return f.read()


def image_size(data_or_path) -> Tuple[int, int]:
    """(width, height) from the file's header alone (``Image.open(f).size``)."""
    data = _read(data_or_path)
    fmt = _format_of(data)
    if fmt == "JPEG":
        w, h, _ = _jpeg_header(data)
        return w, h
    if fmt == "GIF":
        return _gif_header(data)["size"]
    if fmt == "BMP":
        return _bmp_header(data)["size"]
    if fmt == "WEBP":
        return _webp_header(data)["size"]
    hdr = _png_header(data)
    return hdr["width"], hdr["height"]


def read_image(path, mode: str = "RGB") -> np.ndarray:
    """``np.asarray(Image.open(path).convert(mode))``."""
    return decode(_read(path), mode)


def write_image(path_or_file, arr: np.ndarray, format: Optional[str] = None,
                quality: Optional[int] = None) -> None:
    """``Image.fromarray(arr).save(path_or_file, format, quality=...)`` for
    JPEG, PNG and BMP: the format from ``format`` or the file's extension,
    JPEG at ``quality`` (75 when None, Pillow's default)."""
    fmt = (format or "").upper()
    if not fmt:
        name = (os.fspath(path_or_file)
                if isinstance(path_or_file, (str, os.PathLike))
                else getattr(path_or_file, "name", ""))
        ext = Path(str(name)).suffix.lower()
        fmt = {".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG",
               ".bmp": "BMP"}.get(ext, "")
        if not fmt:
            raise ImageCodecError(f"cannot tell the image format of "
                                  f"{name!r} (use .jpg, .jpeg, .png or .bmp)")
    if fmt in ("JPEG", "JPG"):
        data = encode_jpeg(arr, JPEG_QUALITY if quality is None else quality)
    elif fmt == "PNG":
        data = encode_png(arr)
    elif fmt == "BMP":
        data = encode_bmp(arr)
    else:
        raise ImageCodecError(f"writing {fmt} images is not supported (JPEG, "
                              "PNG and BMP are)")
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "wb") as f:
            f.write(data)
