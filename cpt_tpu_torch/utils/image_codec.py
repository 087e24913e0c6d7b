"""Reading and writing JPEG and PNG files without Pillow (the port's
counterpart of the ``Image.open(...).convert(...)`` and ``Image.save`` calls
the JAX package makes).

``decode`` gives Pillow 12.1's pixels bit for bit: for a JPEG the pixels of
libjpeg-turbo's default decompression (islow IDCT, fancy upsampling, its
fixed-point YCbCr conversion), for a PNG those of Pillow's reader, each then
converted to ``"RGB"`` or ``"L"`` by Pillow's rules. ``encode_jpeg`` writes
the bytes of Pillow's ``save(format="JPEG", quality=q)`` with default
options; ``encode_png`` writes a lossless PNG (its bytes differ from
Pillow's, whose zlib differs from Python's).

The JPEG codec and the PNG row filters are host C++
(``cpt_tpu_torch/csrc/image_codec.cpp``), built by ``kernels/build.py`` with
the host C++ compiler at first use and called through ``ctypes``; zlib is
Python's. A failed build raises ``KernelError``; a file this module cannot
read (16-bit PNG, CMYK / arithmetic / lossless / 12-bit JPEG, other
formats, truncated data) raises :class:`ImageCodecError`, and so does a
file whose header declares more than twice ``MAX_IMAGE_PIXELS`` (Pillow's
decompression-bomb limit), before anything is allocated for it. Nothing
falls back to Pillow or returns a partial image.
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


# ------------------------------------------------------------------ JPEG

def _jpeg_header(data: bytes) -> Tuple[int, int, int]:
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_lib().cpt_jpeg_header(_ptr(data), len(data), ctypes.byref(w),
                                  ctypes.byref(h), ctypes.byref(c), err,
                                  _ERR_LEN), err)
    return w.value, h.value, c.value


def _decode_jpeg(data: bytes, fault: int) -> np.ndarray:
    """The file's own pixels: [H, W] (one component) or [H, W, 3] RGB."""
    w, h, c = _jpeg_header(data)
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.uint8)
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
        if w * h > 2 * MAX_IMAGE_PIXELS:     # the C++ refuses a JPEG's
            raise ImageCodecError(
                f"image size ({w * h} pixels) exceeds limit of "
                f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb "
                f"DOS attack")
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
    """Unfiltered row bytes → [h, width, channels] samples (uint8)."""
    if depth == 8:
        return rows[:, :width * channels].reshape(len(rows), width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    bits = bits.reshape(len(rows), width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :, None]


def _decode_png(data: bytes, fault: int) -> Tuple[np.ndarray, str, object]:
    """→ (samples [H, W, channels], Pillow's mode, palette [n, 3] or None)."""
    hdr = _png_header(data)
    w, h, depth, color = (hdr["width"], hdr["height"], hdr["depth"],
                          hdr["color"])
    if depth == 16:
        raise ImageCodecError("16-bit PNG is not supported")
    if color not in _PNG_CHANNELS or (
            depth != 8 and not (color in (0, 3) and depth in (1, 2, 4))):
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
    samples = np.zeros((h, w, channels), np.uint8)
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
    """``Image.convert(mode)`` for the modes the readers produce."""
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


# ------------------------------------------------------------------- API

def _format_of(data: bytes) -> str:
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    for magic, name in ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"RIFF", "WEBP"),
                        (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF")):
        if data.startswith(magic):
            raise ImageCodecError(f"{name} images are not supported "
                                  "(JPEG and PNG are)")
    raise ImageCodecError("cannot identify image file (not JPEG or PNG)")


def decode(data: bytes, mode: str = "RGB") -> np.ndarray:
    """``np.asarray(Image.open(io.BytesIO(data)).convert(mode))`` for a JPEG
    or PNG: uint8 ``[H, W, 3]`` for ``"RGB"``, ``[H, W]`` for ``"L"``."""
    return _decode(data, mode, 0)


def _decode(data: bytes, mode: str, fault: int) -> np.ndarray:
    """:func:`decode` with ``fault`` (bits of FAULTS) set in the C++."""
    data = bytes(data)
    if _format_of(data) == "JPEG":
        arr = _decode_jpeg(data, fault)
        return _convert(arr, "RGB" if arr.ndim == 3 else "L", mode)
    arr, src, palette = _decode_png(data, fault)
    return _convert(arr, src, mode, palette)


def _read(data_or_path) -> bytes:
    if isinstance(data_or_path, (bytes, bytearray, memoryview)):
        return bytes(data_or_path)
    with open(data_or_path, "rb") as f:
        return f.read()


def image_size(data_or_path) -> Tuple[int, int]:
    """(width, height) from the file's header alone (``Image.open(f).size``)."""
    data = _read(data_or_path)
    if _format_of(data) == "JPEG":
        w, h, _ = _jpeg_header(data)
        return w, h
    hdr = _png_header(data)
    return hdr["width"], hdr["height"]


def read_image(path, mode: str = "RGB") -> np.ndarray:
    """``np.asarray(Image.open(path).convert(mode))``."""
    return decode(_read(path), mode)


def write_image(path_or_file, arr: np.ndarray, format: Optional[str] = None,
                quality: Optional[int] = None) -> None:
    """``Image.fromarray(arr).save(path_or_file, format, quality=...)`` for
    JPEG and PNG: the format from ``format`` or the file's extension, JPEG
    at ``quality`` (75 when None, Pillow's default)."""
    fmt = (format or "").upper()
    if not fmt:
        name = (os.fspath(path_or_file)
                if isinstance(path_or_file, (str, os.PathLike))
                else getattr(path_or_file, "name", ""))
        ext = Path(str(name)).suffix.lower()
        fmt = {".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG"}.get(ext, "")
        if not fmt:
            raise ImageCodecError(f"cannot tell the image format of "
                                  f"{name!r} (use .jpg, .jpeg or .png)")
    if fmt in ("JPEG", "JPG"):
        data = encode_jpeg(arr, JPEG_QUALITY if quality is None else quality)
    elif fmt == "PNG":
        data = encode_png(arr)
    else:
        raise ImageCodecError(f"{fmt} images are not supported (JPEG and "
                              "PNG are)")
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "wb") as f:
            f.write(data)
