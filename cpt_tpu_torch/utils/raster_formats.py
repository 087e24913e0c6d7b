"""Pillow's other raster formats without Pillow: the headers, readers and
writers behind :mod:`cpt_tpu_torch.utils.image_codec` for netpbm (PPM,
PGM, PBM, PFM and Pillow's own ``Py*`` kinds), DIB, Targa, Photoshop's
composite image, Windows icons and cursors, SGI, PCX and DCX, QOI, Sun
raster, IFUNC Image Memory (IM), Windows Paint (MSP), X11 bitmaps and
pixmaps; and the header checks of the formats Image.open tries on every
file it has not yet identified (IMT, IPTC, PCD, SPIDER) or on a prefix
its other plugins accept (GBR, FLI), so that files are identified in
Pillow 12.1's order (``image_codec._formats``).

Each opener is the plugin's ``_open`` as Image.open runs it: it returns
the header, raises :class:`NotThis` where the plugin raises SyntaxError
(or an IndexError, TypeError, KeyError, EOFError or struct.error, which
ImageFile turns into one: Image.open then tries the next format), and
:class:`image_codec.ImageCodecError` where it raises anything else (the
open fails). Each reader gives the pixels ``ImageFile.load`` gives, as
(array, Pillow's mode, palette or None) for ``image_codec._convert``:
raw tiles from their offsets (a file that ends first is truncated),
Pillow's decoders over the rest of the file (``csrc/raster.cpp`` for the
run-length and text decoders), rows bottom-up where Pillow's orientation
is -1.
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import struct

import numpy as np

from cpt_tpu_torch.kernels import build
from cpt_tpu_torch.utils import image_codec as ic

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long

# The readers' named faults (``image_codec.FAULTS`` holds them, bits 2^32
# and up); the codec's checks show each one changes a digest. Some pass to
# csrc/raster.cpp as its own ``fault`` bits (_C_FAULTS).
FAULTS = ic.FAULTS
READER_FAULTS = ("psd_packbits_short_run", "sgi_rle_table_swapped", "qoi_hash_prime",
                 "sun_run_exact", "xbm_msb_first", "netpbm_truncated_scaling",
                 "tga_origin_ignored", "pcx_planes_interleaved", "ico_first_entry",
                 "cur_first_entry", "dcx_second_page", "im_top_down",
                 "msp_blank_rows_black", "xpm_keys_sorted", "dib_palette_ignored")
_C_FAULTS = {"psd_packbits_short_run": 1, "sgi_rle_table_swapped": 2,
             "qoi_hash_prime": 4, "sun_run_exact": 8,
             "netpbm_truncated_scaling": 32, "msp_blank_rows_black": 64}

SIGNATURES = {
    # data, n, depth, linebytes, rows, out, err, errlen
    "cpt_tga_rle": ([_P, _L, _I, _L, _L, _P, _P, _I], _L),
    # data, n, linebytes, rows, fault, out
    "cpt_packbits_rows": ([_P, _L, _L, _L, _I, _P], _L),
    # data, n, linebytes, xsize, bits, rows, out, overrun
    "cpt_pcx_rle": ([_P, _L, _L, _L, _I, _L, _P, ctypes.POINTER(ctypes.c_int)], _L),
    # data, n, linebytes, rows, fault, out
    "cpt_sun_rle": ([_P, _L, _L, _L, _I, _P], _L),
    # file, n, xsize, ysize, zsize, bpc, ystep, fault, out, err, errlen
    "cpt_sgi_rle": ([_P, _L, _L, _L, _I, _I, _I, _I, _P, _P, _I], _L),
    # data, n, npix, fault, out, err, errlen
    "cpt_qoi": ([_P, _L, _L, _I, _P, _P, _I], _L),
    # data, n, linebytes, rows, out
    "cpt_xbm": ([_P, _L, _L, _L, _P], _L),
    # data, n, rows, blank, fault, out, cap, err, errlen
    "cpt_msp_rle": ([_P, _L, _L, _L, _I, _P, _L, _P, _I], _L),
    # data, n, bitonal, total, maxval, out_max, fault, out, err, errlen
    "cpt_ppm_plain": ([_P, _L, _I, _L, _L, _L, _I, _P, _P, _I], _L),
    # pixels, w, h, planes, out, cap
    "cpt_pcx_encode": ([_P, _L, _L, _I, _P, _L], _L),
    # rgb, npix, channels, out, cap
    "cpt_qoi_encode": ([_P, _L, _I, _P, _L], _L),
}
LIBRARY = build.Library(build.build_host, SIGNATURES)


class NotThis(Exception):
    """The plugin's ``_open`` fails as SyntaxError does: Image.open tries
    the next format."""


_SYNTAX = (IndexError, TypeError, KeyError, EOFError, struct.error)


def _c_fault(fault: int) -> int:
    return sum(bit for name, bit in _C_FAULTS.items() if fault & FAULTS[name])


def _buf(data) -> np.ndarray:
    a = np.frombuffer(data, np.uint8)
    return a if a.size else np.zeros(1, np.uint8)


def _err():
    return ctypes.create_string_buffer(ic._ERR_LEN)


def _truncated(what: str):
    raise ic.ImageCodecError(f"image file is truncated ({what})")


class _File:
    """``io.BytesIO``'s read, readline, seek and tell over the file's bytes
    (a seek past the end allowed, a read there giving nothing)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, k: int = -1) -> bytes:
        r = self.data[self.pos:] if k < 0 else self.data[self.pos:self.pos + k]
        self.pos += len(r)
        return r

    def readline(self) -> bytes:
        i = self.data.find(b"\n", self.pos)
        r = self.data[self.pos:len(self.data) if i < 0 else i + 1]
        self.pos += len(r)
        return r


def _u16le(b: bytes, at: int = 0) -> int:
    return struct.unpack_from("<H", b, at)[0]


def _u16be(b: bytes, at: int = 0) -> int:
    return struct.unpack_from(">H", b, at)[0]


def _u32le(b: bytes, at: int = 0) -> int:
    return struct.unpack_from("<I", b, at)[0]


def _u32be(b: bytes, at: int = 0) -> int:
    return struct.unpack_from(">I", b, at)[0]


def _opener(fn):
    """``fn`` with the errors ImageFile turns into SyntaxError as NotThis."""
    def wrapped(data: bytes, *args):
        try:
            return fn(data, *args)
        except _SYNTAX as e:
            raise NotThis(f"{fn.__name__}: {e!r}") from e
    wrapped.__name__ = fn.__name__
    return wrapped


# --------------------------------------------------------------- unpacking

def _bits(rows: np.ndarray, w: int, lsb_first: bool = False) -> np.ndarray:
    """1-bit rows [h, bytes] → [h, w] of 0 / 1."""
    if not len(rows):
        return np.zeros((0, w), np.uint8)
    return np.unpackbits(rows, axis=1, bitorder="little" if lsb_first else "big")[:, :w]


def _raw_rows(data: bytes, offset: int, rows: int, linebytes: int,
              stride: int = 0, what: str = "raw data") -> np.ndarray:
    """Pillow's raw decoder's input: ``rows`` rows of ``linebytes`` from
    ``offset``, ``stride`` apart (0: packed); the last row's padding may be
    missing, as the decoder allows."""
    stride = stride or linebytes
    need = (rows - 1) * stride + linebytes if rows else 0
    if offset + need > len(data) or offset < 0:
        _truncated(what)
    out = np.zeros((rows, stride), np.uint8)
    have = min(rows * stride, len(data) - offset)
    out.reshape(-1)[:have] = np.frombuffer(data, np.uint8, count=have, offset=offset)
    return out[:, :linebytes]


def _palette(raw: bytes, rawmode: str) -> np.ndarray:
    """An ImagePalette.raw → its RGB entries [n, 3]."""
    k = {"RGB": 3, "BGR": 3, "BGRX": 4, "BGRA": 4, "RGB;L": 3, "BGRA;15Z": 2}[rawmode]
    n = len(raw) // k
    a = np.frombuffer(raw, np.uint8, count=n * k)
    if rawmode == "RGB;L":
        return np.ascontiguousarray(a.reshape(3, n).T)
    if rawmode == "BGRA;15Z":
        return _bgr15(a.reshape(n, 2))
    a = a.reshape(n, k)
    return np.ascontiguousarray(a[:, 2::-1] if rawmode[0] == "B" else a[:, :3])


def _with_palette(mode: str, palette) -> str:
    """The mode an image of ``mode`` takes when Image.load puts its file's
    palette into it, raising where putpalette does (more than 256 entries;
    a mode without a palette): an L image becomes "L;P" (its convert("L")
    a copy of the indices, its convert("RGB") through the palette), an LA
    one PA."""
    if palette is None:
        return mode
    if len(palette) > 256:
        raise ic.ImageCodecError("invalid palette size")
    if mode not in ("L", "LA", "P", "PA"):
        raise ic.ImageCodecError(f"a palette in an image of mode {mode} (illegal image mode)")
    return {"L": "L;P", "LA": "PA"}.get(mode, mode)


def _bgr15(px: np.ndarray) -> np.ndarray:
    """Pillow's "BGRA;15Z" / "BGR;15" unpacking of 16-bit pixels [..., 2]
    → RGB: five bits a channel, red highest, scaled by 255 / 31."""
    v = px[..., 0].astype(np.uint32) | px[..., 1].astype(np.uint32) << 8
    return np.stack([((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)], -1).astype(np.uint8)


# ------------------------------------------------------------------ netpbm

_WS = b" \t\n\x0b\x0c\r"
_PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
              b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA",
              b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "F": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def ppm_accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in b"0123456fy"


def ppm_open(data: bytes) -> dict:
    """PpmImagePlugin's ``_open``: the magic, then whitespace-separated
    header tokens (comments from ``#`` to the line's end anywhere in them),
    the data right after the last token's one whitespace byte."""
    f = _File(data)
    magic = b""
    for _ in range(6):
        c = f.read(1)
        if not c or c in _WS:
            break
        magic += c
    if magic not in _PPM_MODES:
        raise NotThis("not a PPM file")
    mode = _PPM_MODES[magic]

    def token() -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = f.read(1)
            if not c:
                break
            if c in _WS:
                if not tok:
                    continue
                break
            if c == b"#":
                while f.read(1) not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok:
            raise ic.ImageCodecError("Reached EOF while reading header")
        if len(tok) > 10:
            raise ic.ImageCodecError(f"Token too long in file header: {tok!r}")
        return tok

    def number(conv):
        tok = token()
        try:
            return conv(tok)
        except ValueError as e:
            raise ic.ImageCodecError(f"PPM header: {e}") from e

    w = number(int)
    h = number(int)
    plain = magic in (b"P1", b"P2", b"P3")
    hdr = {"size": (w, h), "mode": mode, "plain": plain, "maxval": 255,
           "rawmode": mode, "scaled": False}
    if mode == "1":
        hdr["rawmode"] = "1;I"
    elif mode == "F":
        scale = number(float)
        if scale == 0.0 or not math.isfinite(scale):
            raise ic.ImageCodecError("scale must be finite and non-zero")
        hdr["rawmode"] = "F;32F" if scale < 0 else "F;32BF"
    else:
        maxval = number(int)
        if not 0 < maxval < 65536:
            raise ic.ImageCodecError("maxval must be greater than 0 and less than 65536")
        hdr["maxval"] = maxval
        if maxval > 255 and mode == "L":
            hdr["mode"] = "I"
        if not plain:
            if maxval == 65535 and mode == "L":
                hdr["rawmode"] = "I;16B"
            elif maxval != 255:
                hdr["scaled"] = True
    hdr["offset"] = f.pos
    return hdr


def ppm_decode(data: bytes, hdr: dict, fault: int):
    (w, h), mode, at = hdr["size"], hdr["mode"], hdr["offset"]
    bands = _BANDS[mode]
    body = data[at:]
    if hdr["plain"]:
        bitonal = mode == "1"
        total = w * h * (1 if bitonal else bands)
        out = np.empty(max(total, 1), np.uint8 if bitonal else np.int32)
        err = _err()
        src = _buf(body)
        out_max = 65535 if mode == "I" else 255
        n = LIBRARY.get().cpt_ppm_plain(src.ctypes.data, len(body), int(bitonal), total,
                                        hdr["maxval"], out_max, _c_fault(fault),
                                        out.ctypes.data, err, ic._ERR_LEN)
        ic._check(n, err)
        if n < total:
            raise ic.ImageCodecError("not enough image data")
        out = out[:total]
        if mode != "I":
            out = out.astype(np.uint8)
        return out.reshape((h, w) if bands == 1 else (h, w, bands)), mode, None
    if hdr["scaled"]:
        maxval = hdr["maxval"]
        wide = maxval >= 256
        n = w * h * bands
        if len(body) < n * (2 if wide else 1):
            raise ic.ImageCodecError("not enough image data")
        v = np.frombuffer(body, ">u2" if wide else np.uint8, count=n).astype(np.float64)
        out_max = 65535 if mode == "I" else 255
        scaled = v / maxval * out_max
        scaled = (np.floor(scaled) if fault & FAULTS["netpbm_truncated_scaling"]
                  else np.rint(scaled))
        v = np.minimum(out_max, scaled).astype(np.int32 if mode == "I" else np.uint8)
        return v.reshape((h, w) if bands == 1 else (h, w, bands)), mode, None
    raw = hdr["rawmode"]
    if raw == "1;I":
        rows = _raw_rows(data, at, h, (w + 7) // 8)
        return (1 - _bits(rows, w)) * np.uint8(255), "1", None
    if raw == "I;16B":
        rows = _raw_rows(data, at, h, 2 * w)
        return rows.view(">u2").astype(np.int32), "I", None
    if raw.startswith("F;32"):
        rows = _raw_rows(data, at, h, 4 * w)[::-1]
        return rows.view("<f4" if raw == "F;32F" else ">f4"), "F", None
    rows = _raw_rows(data, at, h, w * bands)
    arr = rows if bands == 1 else rows.reshape(h, w, bands)
    return arr, mode, (np.zeros((0, 3), np.uint8) if mode == "P" else None)


def encode_ppm(arr: np.ndarray) -> bytes:
    """``save(format="PPM")``: P6 for RGB, P5 for L, maxval 255."""
    px = _writable(arr, "PPM")
    head = b"P5" if px.ndim == 2 else b"P6"
    return head + b"\n%d %d\n255\n" % (px.shape[1], px.shape[0]) + px.tobytes()


def _writable(arr: np.ndarray, fmt: str) -> np.ndarray:
    px = np.ascontiguousarray(arr, np.uint8)
    if px.ndim == 3 and px.shape[2] == 1:
        px = px[:, :, 0]
    if px.ndim not in (2, 3) or (px.ndim == 3 and px.shape[2] != 3) or not px.size:
        raise ic.ImageCodecError(f"{fmt} encoder takes non-empty [H, W] or [H, W, 3] "
                                 f"arrays, got shape {tuple(np.shape(arr))}")
    return px


# ----------------------------------------------------------- DIB, ICO, CUR

def dib_accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and _u32le(prefix) in (12, 40, 52, 56, 64, 108, 124)


def _bitmap(data: bytes, at: int) -> dict:
    """BmpImagePlugin's ``_bitmap(header=at)`` with no file header: the
    pixels right after the header, its bit fields and palette."""
    if len(data) < at + 4:
        raise NotThis("no BITMAPINFO header size")
    return ic._bmp_header(data, at=at, offset=0)


def dib_open(data: bytes) -> dict:
    return _bitmap(data, 0)


def dib_decode(data: bytes, hdr: dict, fault: int):
    if fault & FAULTS["dib_palette_ignored"] and hdr["mode"] in ("P", "L", "1"):
        hdr = dict(hdr, offset=hdr["offset"] - 4 * len(hdr["palette"] if hdr["palette"]
                                                        is not None else ()))
    return ic._decode_bmp(data, fault & 0x7FFFFFFF, hdr)


def encode_dib(arr: np.ndarray) -> bytes:
    """``save(format="DIB")``: the BMP bytes without their 14-byte file
    header."""
    return ic.encode_bmp(arr)[14:]


@_opener
def cur_open(data: bytes, fault: int = 0) -> dict:
    """CurImagePlugin's ``_open``: the largest entry (both sides larger
    than the one before), its bitmap at half its height."""
    f = _File(data)
    s = f.read(6)
    if not s.startswith(b"\0\0\2\0"):
        raise NotThis("not a CUR file")
    m = b""
    for _ in range(_u16le(s, 4)):
        s = f.read(16)
        if not m or (not fault & FAULTS["cur_first_entry"] and s[0] > m[0] and s[1] > m[1]):
            m = s
    if not m:
        raise TypeError("No cursors were found")
    at = _u32le(m, 12)
    hdr = _bitmap(data, at if at else f.pos)
    w, h = hdr["size"]
    return dict(hdr, size=(w, h // 2))


def cur_decode(data: bytes, hdr: dict, fault: int):
    if fault & FAULTS["cur_first_entry"]:
        hdr = cur_open(data, fault)
    return ic._decode_bmp(data, fault & 0x7FFFFFFF, hdr)


def ico_accept(prefix: bytes) -> bool:
    return prefix.startswith(b"\0\0\1\0")


@_opener
def _ico_entries(data: bytes) -> list:
    f = _File(data)
    s = f.read(6)
    if not ico_accept(s):
        raise NotThis("not an ICO file")
    entries = []
    for _ in range(_u16le(s, 4)):
        s = f.read(16)
        width, height, colors = s[0] or 256, s[1] or 256, s[2]
        bpp = _u16le(s, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append({"dim": (width, height), "square": width * height, "bpp": bpp,
                        "depth": depth, "size": _u32le(s, 8), "offset": _u32le(s, 12)})
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["square"], reverse=True)
    return entries


def ico_open(data: bytes, fault: int = 0) -> dict:
    """IcoImagePlugin's ``_open``, which loads the image: the entry Pillow
    picks (the largest, the deepest of those), a PNG through the PNG
    reader, a BMP as a DIB of half its height whose AND mask (or 32-bit
    alpha) must be there in full; → {"size", "pixels"}."""
    entries = _ico_entries(data)
    if not entries:
        raise NotThis("ICO with no entries")
    e = _ico_first_entry(data) if fault & FAULTS["ico_first_entry"] else entries[0]
    at = e["offset"]
    if data[at:at + 8] == ic.PNG_SIGNATURE:
        px = ic._decode_png(data[at:], fault & 0x7FFFFFFF)
        return {"size": (px[0].shape[1], px[0].shape[0]), "mode": px[1], "pixels": px}
    hdr = _bitmap(data, at)
    w, h = hdr["size"]
    hdr = dict(hdr, size=(w, int(h / 2)))
    w, h = hdr["size"]
    if e["bpp"] == 32:
        o = hdr["offset"]
        alpha = data[o:o + w * h * 4][3::4]
        if len(alpha) < w * h:
            raise ic.ImageCodecError("ICO: buffer is not large enough for the alpha")
    else:
        wp = w + (32 - w % 32) % 32
        total = int(wp * h / 8)
        mask_at = e["offset"] + e["size"] - total
        if mask_at < 0:
            raise ic.ImageCodecError(f"ICO: negative seek value {mask_at}")
        got = len(data[mask_at:mask_at + total])
        stride = int(wp / 8)
        if h and got < (h - 1) * stride + (w + 7) // 8:
            raise ic.ImageCodecError("ICO: not enough image data for the AND mask")
    px = ic._decode_bmp(data, fault & 0x7FFFFFFF, hdr)
    return {"size": (px[0].shape[1], px[0].shape[0]), "mode": px[1], "pixels": px}


def _ico_first_entry(data: bytes) -> dict:
    f = _File(data, 6)
    s = f.read(16)
    return {"bpp": _u16le(s, 6), "size": _u32le(s, 8), "offset": _u32le(s, 12)}


def ico_decode(data: bytes, hdr: dict, fault: int):
    if fault & FAULTS["ico_first_entry"]:
        hdr = ico_open(data, fault)
    return hdr["pixels"]


# ------------------------------------------------------------------ Targa

_TGA_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
              (2, 24): "BGR", (2, 32): "BGRA"}
_TGA_UNPACK = {("P", "P"), ("1", "1"), ("L", "L"), ("LA", "LA"), ("RGBA", "BGRA;15Z"),
               ("RGB", "BGR"), ("RGBA", "BGRA")}
_RAW_BITS = {"1": 1, "P": 8, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}


@_opener
def tga_open(data: bytes) -> dict:
    """TgaImagePlugin's ``_open`` (no prefix check: tried on every file no
    format before it took)."""
    f = _File(data)
    s = f.read(18)
    id_len, cmap, kind, depth, flags = s[0], s[1], s[2], s[16], s[17]
    size = (_u16le(s, 12), _u16le(s, 14))
    if cmap not in (0, 1) or size[0] <= 0 or size[1] <= 0 or depth not in (1, 8, 16, 24, 32):
        raise NotThis("not a TGA file")
    if kind in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif kind in (1, 9):
        mode = "P" if cmap else "L"
    elif kind in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThis("unknown TGA mode")
    origin = flags & 0x30
    if id_len:
        f.read(id_len)
    palette = None
    if cmap:
        start, n, mapdepth = _u16le(s, 3), _u16le(s, 5), s[7]
        raw = {16: "BGRA;15Z", 24: "BGR", 32: "BGRA"}.get(mapdepth)
        if raw is None:
            raise NotThis("unknown TGA map depth")
        k = {16: 2, 24: 3, 32: 4}[mapdepth]
        palette = _palette(bytes(k * start) + f.read(k * n), raw)
    return {"size": size, "mode": mode, "rawmode": _TGA_MODES.get((kind & 7, depth)),
            "rle": bool(kind & 8), "top_down": origin in (0x20, 0x30),
            "mirrored": origin in (0x10, 0x30), "depth": depth, "palette": palette,
            # Image.load's putpalette("RGB", "BGRA") raises for a 32-bit map
            "map32": cmap and s[7] == 32, "offset": f.pos}


def tga_decode(data: bytes, hdr: dict, fault: int):
    (w, h), mode, raw = hdr["size"], hdr["mode"], hdr["rawmode"]
    if raw is None:
        raise ic.ImageCodecError(f"cannot load this TGA image (mode {mode}, "
                                 f"{hdr['depth']} bits)")
    if (mode, raw) not in _TGA_UNPACK:
        raise ic.ImageCodecError(f"unknown raw mode {raw} for a TGA image of mode {mode}")
    linebytes = (w * _RAW_BITS[raw] + 7) // 8
    if hdr["rle"]:
        rows = np.empty((h, linebytes), np.uint8)
        src = _buf(data[hdr["offset"]:])
        err = _err()
        n = LIBRARY.get().cpt_tga_rle(src.ctypes.data, len(data) - min(len(data), hdr["offset"]),
                                      hdr["depth"] // 8, linebytes, h, rows.ctypes.data, err,
                                      ic._ERR_LEN)
        ic._check(n, err)
        if n < h:
            _truncated(f"Targa RLE data gives {n} of {h} rows")
    else:
        rows = _raw_rows(data, hdr["offset"], h, linebytes)
    ignore = fault & FAULTS["tga_origin_ignored"]
    if not hdr["top_down"] and not ignore:
        rows = rows[::-1]
    px = _unpack(rows, raw, w)
    if hdr["mirrored"] and not ignore:
        px = px[:, ::-1]
    if hdr["map32"]:
        raise ic.ImageCodecError("a TGA palette of 32-bit entries (unrecognized raw mode)")
    mode = _with_palette(mode, hdr["palette"])
    # the BGRA kinds unpack to RGB here (the alpha band is dropped anyway)
    return np.ascontiguousarray(px), "RGB" if mode == "RGBA" else mode, hdr["palette"]


def _unpack(rows: np.ndarray, raw: str, w: int) -> np.ndarray:
    """Rows [h, bytes] → pixels by Pillow's unpacker for ``raw``: [h, w]
    for one band, else [h, w, bands] (RGB for the BGR kinds)."""
    h = len(rows)
    if raw == "1":
        return _bits(rows, w) * np.uint8(255)
    if raw in ("L", "P"):
        return rows[:, :w]
    if raw == "LA":
        return rows[:, :2 * w].reshape(h, w, 2)
    if raw == "BGRA;15Z":
        return _bgr15(rows[:, :2 * w].reshape(h, w, 2))
    n = 3 if raw == "BGR" else 4
    return rows[:, :n * w].reshape(h, w, n)[..., 2::-1]


def encode_tga(arr: np.ndarray) -> bytes:
    """``save(format="TGA")``: uncompressed (type 2 BGR for RGB, type 3 for
    L), bottom-up, Pillow's TRUEVISION-XFILE footer."""
    px = _writable(arr, "TGA")
    h, w = px.shape[:2]
    kind, bits = (3, 8) if px.ndim == 2 else (2, 24)
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, kind, 0, 0, 0, 0, 0, w, h, bits, 0)
    rows = px[::-1] if px.ndim == 2 else px[::-1, :, ::-1]
    return head + rows.tobytes() + b"\0" * 8 + b"TRUEVISION-XFILE.\0"


# -------------------------------------------------------------------- PSD

_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
              (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
              (9, 8): ("LAB", 3)}


def psd_accept(prefix: bytes) -> bool:
    return prefix.startswith(b"8BPS")


@_opener
def psd_open(data: bytes) -> dict:
    """PsdImagePlugin's ``_open``: the header, the colour mode data (a
    768-byte palette for mode P), the image resources walked as Pillow
    walks them, the layer and mask section skipped by its length, then
    the composite image's compression and (PackBits) row byte counts."""
    f = _File(data)
    s = f.read(26)
    if not psd_accept(s) or struct.unpack_from(">H", s, 4)[0] != 1:
        raise NotThis("not a PSD file")
    bits, channels_in, psd_mode = _u16be(s, 22), _u16be(s, 12), _u16be(s, 24)
    mode, channels = _PSD_MODES[(psd_mode, bits)]
    if channels > channels_in:
        raise ic.ImageCodecError("not enough channels")
    if mode == "RGB" and channels_in == 4:
        mode, channels = "RGBA", 4
    size = (_u32be(s, 18), _u32be(s, 14))
    n = _u32be(f.read(4))
    palette = None
    if n:
        body = f.read(n)
        if mode == "P" and n == 768:
            palette = _palette(body, "RGB;L")
    n = _u32be(f.read(4))
    if n:
        end = f.pos + n
        while f.pos < end:
            f.read(4)
            _u16be(f.read(2))
            name = f.read(f.read(1)[0])
            if not len(name) & 1:
                f.read(1)
            body = f.read(_u32be(f.read(4)))
            if len(body) & 1:
                f.read(1)
    n = _u32be(f.read(4))
    if n:
        end = f.pos + n
        _u32be(f.read(4))
        f.pos = end
    compression = _u16be(f.read(2))
    w, h = size
    tiles = []
    at = f.pos
    if compression == 0:
        for c in range(channels):
            tiles.append(at)
            at += w * h
    elif compression == 1:
        counts = f.read(channels * h * 2)
        at = f.pos
        i = 0
        for c in range(channels):
            tiles.append(at)
            for _ in range(h):
                at += _u16be(counts, i)
                i += 2
    return {"size": size, "mode": mode, "channels": channels, "palette": palette,
            "compression": compression, "tiles": tiles}


def psd_decode(data: bytes, hdr: dict, fault: int):
    (w, h), mode = hdr["size"], hdr["mode"]
    if not hdr["tiles"]:
        raise ic.ImageCodecError(f"cannot load this PSD image (compression "
                                 f"{hdr['compression']})")
    if mode == "LAB":
        raise ic.ImageCodecError("PSD images of type 'LAB' are not supported")
    linebytes = (w + 7) // 8 if mode == "1" else w
    planes = []
    # ImageFile.load decodes the tiles in the order of their offsets
    for at in sorted(hdr["tiles"]):
        if hdr["compression"] == 0:
            rows = _raw_rows(data, at, h, linebytes, what="PSD channel")
        else:
            rows = np.empty((h, linebytes), np.uint8)
            body = data[at:]
            src = _buf(body)
            n = LIBRARY.get().cpt_packbits_rows(src.ctypes.data, len(body), linebytes, h,
                                                _c_fault(fault), rows.ctypes.data)
            if n < h:
                _truncated(f"PSD PackBits data gives {n} of {h} rows")
        planes.append((at, rows))
    by_offset = dict(planes)
    chans = [by_offset[at] for at in hdr["tiles"]]
    if mode == "1":
        return _bits(chans[0], w) * np.uint8(255), "1", None
    if mode in ("L", "P"):
        return chans[0], mode, (hdr["palette"] if hdr["palette"] is not None
                                else np.zeros((0, 3), np.uint8))
    px = np.stack(chans, -1)
    if mode == "CMYK":
        return 255 - px, "CMYK", None
    return px, mode, None


# -------------------------------------------------------------------- SGI

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B",
              (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def sgi_accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and _u16be(prefix) == 474


@_opener
def sgi_open(data: bytes) -> dict:
    s = data[:512]
    compression, bpc = s[2], s[3]
    dimension, xsize, ysize, zsize = (_u16be(s, 4), _u16be(s, 6), _u16be(s, 8),
                                      _u16be(s, 10))
    raw = _SGI_MODES.get((bpc, dimension, zsize))
    if raw is None:
        raise ic.ImageCodecError("Unsupported SGI image mode")
    return {"size": (xsize, ysize), "mode": raw.split(";")[0], "bpc": bpc,
            "compression": compression}


def sgi_decode(data: bytes, hdr: dict, fault: int):
    (w, h), mode, bpc = hdr["size"], hdr["mode"], hdr["bpc"]
    z = len(mode)
    if hdr["compression"] == 1:
        out = np.zeros((h, w * z * bpc), np.uint8)
        src = _buf(data)
        err = _err()
        ic._check(LIBRARY.get().cpt_sgi_rle(src.ctypes.data, len(data), w, h, z, bpc, -1,
                                            _c_fault(fault), out.ctypes.data, err,
                                            ic._ERR_LEN), err)
        px = out.reshape(h, w, z, bpc)[..., 0]
        return (px[..., 0] if z == 1 else px), mode, None
    if hdr["compression"] != 0:
        raise ic.ImageCodecError(f"cannot load this SGI image (compression "
                                 f"{hdr['compression']})")
    page = w * h * bpc
    chans = []
    for c in range(z):
        at = 512 + c * page
        if bpc == 2 and len(data[at:at + page]) < page:
            raise ic.ImageCodecError("not enough image data")
        rows = _raw_rows(data, at, h, w * bpc, what="SGI channel")
        chans.append(rows[::-1, ::bpc])
    return (chans[0] if z == 1 else np.stack(chans, -1)), mode, None


def encode_sgi(arr: np.ndarray, name: str = "") -> bytes:
    """``save(format="SGI")`` to a file named ``name`` (its base name
    without extension fills the header's name field): uncompressed, one
    byte a sample, planar, rows bottom-up."""
    px = _writable(arr, "SGI")
    h, w = px.shape[:2]
    z = 1 if px.ndim == 2 else 3
    dimension = (1 if h == 1 else 2) if z == 1 else 3
    img_name = os.path.splitext(os.path.basename(name))[0].encode("ascii", "ignore")
    head = (struct.pack(">hBBHHHHll4s79ss", 474, 0, 1, dimension, w, h, z, 0, 255, b"",
                        img_name, b"") + struct.pack(">l404s", 0, b""))
    planes = px[None] if z == 1 else px.transpose(2, 0, 1)
    return head + np.ascontiguousarray(planes[:, ::-1]).tobytes()


# -------------------------------------------------------------- PCX, DCX

def pcx_accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def _pcx_at(data: bytes, at: int) -> dict:
    """PcxImageFile's ``_open`` from ``at`` (DCX's pages)."""
    f = _File(data, at)
    s = f.read(68)
    if not pcx_accept(s):
        raise NotThis("not a PCX file")
    box = (_u16le(s, 4), _u16le(s, 6), _u16le(s, 8) + 1, _u16le(s, 10) + 1)
    if box[2] <= box[0] or box[3] <= box[1]:
        raise NotThis("bad PCX image size")
    offset = f.pos + 60
    version, bits, planes, provided = s[1], s[3], s[65], _u16le(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = raw = "1"
    elif bits == 1 and planes in (2, 4):
        mode, raw = "P", f"P;{planes}L"
        palette = _palette(s[16:64], "RGB")
    elif version == 5 and bits == 8 and planes == 1:
        mode = raw = "L"
        tail = data[max(0, len(data) - 769):]    # BytesIO's seek(-769, 2)
        if len(tail) == 769 and tail[0] == 12:
            grey = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
            if tail[1:] != grey:
                mode = raw = "P"
                palette = _palette(tail[1:], "RGB")
    elif version == 5 and bits == 8 and planes == 3:
        mode, raw = "RGB", "RGB;L"
    else:
        raise ic.ImageCodecError("unknown PCX mode")
    size = (box[2] - box[0], box[3] - box[1])
    stride = (size[0] * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    return {"size": size, "mode": mode, "rawmode": raw, "linebytes": planes * stride,
            "palette": palette, "offset": offset}


pcx_open = _opener(lambda data: _pcx_at(data, 0))
pcx_open.__name__ = "pcx_open"


def pcx_decode(data: bytes, hdr: dict, fault: int):
    (w, h), raw, linebytes = hdr["size"], hdr["rawmode"], hdr["linebytes"]
    bits = {"1": 1, "L": 8, "P": 8, "P;2L": 2, "P;4L": 4, "RGB;L": 24}[raw]
    if (w * bits + 7) // 8 > linebytes:
        raise ic.ImageCodecError("buffer overrun when reading image file")
    _with_palette(hdr["mode"], hdr["palette"])
    body = data[hdr["offset"]:]
    rows = np.empty((h, linebytes), np.uint8)
    src = _buf(body)
    overrun = ctypes.c_int()
    n = LIBRARY.get().cpt_pcx_rle(src.ctypes.data, len(body), linebytes, w, bits, h,
                                  rows.ctypes.data, ctypes.byref(overrun))
    if n < h:
        _truncated(f"PCX data gives {n} of {h} rows")
    if overrun.value:
        raise ic.ImageCodecError("buffer overrun when reading image file")
    if raw in ("P;2L", "P;4L"):
        s, k = (w + 7) // 8, int(raw[2])
        px = sum(_bits(rows[:, i * s:(i + 1) * s], w) << i for i in range(k))
        return px.astype(np.uint8), "P", hdr["palette"]
    if raw == "RGB;L":
        if fault & FAULTS["pcx_planes_interleaved"]:
            return rows[:, :3 * w].reshape(h, w, 3), "RGB", None
        return np.ascontiguousarray(rows[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1)), \
            "RGB", None
    if raw == "1":
        return _bits(rows, w) * np.uint8(255), "1", None
    return rows[:, :w], hdr["mode"], hdr["palette"]


def encode_pcx(arr: np.ndarray) -> bytes:
    """``save(format="PCX")``: version 5, 8 bits, one plane (L, with a grey
    palette after the data) or three (RGB), rows padded to even lengths,
    Pillow's run-length encoder."""
    px = _writable(arr, "PCX")
    h, w = px.shape[:2]
    planes = 1 if px.ndim == 2 else 3
    stride = w + w % 2
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 100, 100)
            + b"\0" * 24 + b"\xff" * 24 + b"\0" + struct.pack("<BHHHH", planes, stride, 1, w, h)
            + b"\0" * 54)
    cap = h * planes * 2 * (stride + 1) + 16
    out = np.empty(cap, np.uint8)
    src = np.ascontiguousarray(px if planes == 1 else px.transpose(0, 2, 1))
    n = LIBRARY.get().cpt_pcx_encode(src.ctypes.data, w, h, planes, out.ctypes.data, cap)
    body = out[:n].tobytes()
    if planes == 1:
        body += b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    return head + body


def dcx_accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and _u32le(prefix) == 0x3ADE68B1


@_opener
def dcx_open(data: bytes, fault: int = 0) -> dict:
    f = _File(data, 4)
    offsets = []
    for _ in range(1024):
        at = _u32le(f.read(4))
        if not at:
            break
        offsets.append(at)
    page = 1 if fault & FAULTS["dcx_second_page"] and len(offsets) > 1 else 0
    if not offsets:
        raise EOFError("attempt to seek outside sequence")
    return _pcx_at(data, offsets[page])


def dcx_decode(data: bytes, hdr: dict, fault: int):
    if fault & FAULTS["dcx_second_page"]:
        hdr = dcx_open(data, fault)
    return pcx_decode(data, hdr, fault)


# -------------------------------------------------------------------- QOI

def qoi_accept(prefix: bytes) -> bool:
    return prefix.startswith(b"qoif")


@_opener
def qoi_open(data: bytes) -> dict:
    f = _File(data, 4)
    size = (_u32be(f.read(4)), _u32be(f.read(4)))
    channels = f.read(1)[0]
    return {"size": size, "mode": "RGB" if channels == 3 else "RGBA", "offset": f.pos + 1}


def qoi_decode(data: bytes, hdr: dict, fault: int):
    (w, h), mode = hdr["size"], hdr["mode"]
    body = data[hdr["offset"]:]
    npix = w * h
    if npix > 62 * len(body):        # a byte gives at most 62 pixels
        _truncated("QOI data too short")
    out = np.empty((npix + 62) * 4, np.uint8)
    src = _buf(body)
    err = _err()
    n = LIBRARY.get().cpt_qoi(src.ctypes.data, len(body), npix, _c_fault(fault),
                              out.ctypes.data, err, ic._ERR_LEN)
    ic._check(n, err)
    px = out[:npix * 4].reshape(h, w, 4)
    return (px[..., :3] if mode == "RGB" else px), mode, None


def encode_qoi(arr: np.ndarray) -> bytes:
    """``save(format="QOI")`` of an RGB array (colorspace 1, as Pillow
    writes it by default); Pillow refuses L."""
    px = np.ascontiguousarray(arr, np.uint8)
    if px.ndim != 3 or px.shape[2] != 3 or not px.size:
        raise ic.ImageCodecError("Unsupported QOI image mode (RGB only)")
    h, w = px.shape[:2]
    cap = 5 * w * h + 16
    out = np.empty(cap, np.uint8)
    n = LIBRARY.get().cpt_qoi_encode(px.ctypes.data, w * h, 3, out.ctypes.data, cap)
    return (b"qoif" + struct.pack(">IIBB", w, h, 3, 1) + out[:n].tobytes()
            + bytes((0, 0, 0, 0, 0, 0, 0, 1)))


# -------------------------------------------------------------------- SUN

def sun_accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and _u32be(prefix) == 0x59A66A95


@_opener
def sun_open(data: bytes) -> dict:
    f = _File(data)
    s = f.read(32)
    offset = 32
    size = (_u32be(s, 4), _u32be(s, 8))
    depth, kind, ptype, plen = _u32be(s, 12), _u32be(s, 20), _u32be(s, 24), _u32be(s, 28)
    modes = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"),
             24: ("RGB", "RGB" if kind == 3 else "BGR"),
             32: ("RGB", "RGBX" if kind == 3 else "BGRX")}
    if depth not in modes:
        raise NotThis("Unsupported Mode/Bit Depth")
    mode, raw = modes[depth]
    palette = None
    if plen:
        if plen > 1024:
            raise NotThis("Unsupported Color Palette Length")
        if ptype != 1:
            raise NotThis("Unsupported Palette Type")
        offset += plen
        palette = _palette(f.read(plen), "RGB;L")
        if mode == "L":
            mode, raw = "P", raw.replace("L", "P")
    if kind not in (0, 1, 2, 3, 4, 5):
        raise NotThis("Unsupported Sun Raster file type")
    return {"size": size, "mode": mode, "rawmode": raw, "rle": kind == 2,
            "stride": ((size[0] * depth + 15) // 16) * 2, "depth": depth,
            "palette": palette, "offset": offset}


def sun_decode(data: bytes, hdr: dict, fault: int):
    (w, h), raw = hdr["size"], hdr["rawmode"]
    linebytes = (w * hdr["depth"] + 7) // 8
    if hdr["rle"]:
        rows = np.empty((h, linebytes), np.uint8)
        body = data[hdr["offset"]:]
        src = _buf(body)
        n = LIBRARY.get().cpt_sun_rle(src.ctypes.data, len(body), linebytes, h,
                                      _c_fault(fault), rows.ctypes.data)
        if n < h:
            _truncated(f"Sun RLE data gives {n} of {h} rows")
    else:
        rows = _raw_rows(data, hdr["offset"], h, linebytes, hdr["stride"])
    _with_palette(hdr["mode"], hdr["palette"])
    if raw == "1;I":
        return (1 - _bits(rows, w)) * np.uint8(255), "1", None
    if raw in ("L;4", "P;4"):
        v = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        return (v * np.uint8(17) if raw == "L;4" else v), hdr["mode"], hdr["palette"]
    if raw in ("L", "P"):
        return rows, hdr["mode"], hdr["palette"]
    n = 3 if raw in ("RGB", "BGR") else 4
    px = rows.reshape(h, w, n)
    return (px[..., :3] if raw[0] == "R" else px[..., 2::-1]), "RGB", None


# --------------------------------------------------------------------- IM

_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)",
            "Lut", "Name", "Scale (x,y)", "Image size (x*y)", "Image type")


def _im_open_modes() -> dict:
    """ImImagePlugin.OPEN: the "Image type" values → (mode, raw mode)."""
    modes = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
             "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
             "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
             "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
             "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"),
             "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"),
             "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"),
             "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
             "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
             "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
    for i in ("8", "8S", "16", "16S", "32", "32F"):
        modes[f"L {i} image"] = modes[f"L*{i} image"] = ("F", f"F;{i}")
    for i in ("16", "16L", "16B"):
        modes[f"L {i} image"] = modes[f"L*{i} image"] = (f"I;{i}", f"I;{i}")
    modes["L 32S image"] = modes["L*32S image"] = ("I", "I;32S")
    for j in range(2, 33):
        modes[f"L*{j} image"] = ("F", f"F;{j}")
    return modes


_IM_OPEN = _im_open_modes()
# raw mode → (numpy dtype of a sample, samples a pixel) of the kinds read
_IM_RAW = {"L": (np.uint8, 1), "P": (np.uint8, 1), "RGB": (np.uint8, 3),
           "RGB;L": (np.uint8, 3), "LA;L": (np.uint8, 2), "PA;L": (np.uint8, 2),
           "RGBA;L": (np.uint8, 4), "RGBX;L": (np.uint8, 4), "CMYK;L": (np.uint8, 4),
           "I;16": ("<u2", 1), "I;16L": ("<u2", 1), "I;16B": (">u2", 1),
           "I;32": ("<i4", 1), "I;32S": ("<i4", 1), "F;8": (np.uint8, 1),
           "F;8S": (np.int8, 1), "F;16": ("<u2", 1), "F;16S": ("<i2", 1),
           "F;32": ("<i4", 1), "F;32F": ("<f4", 1)}


def _im_number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


@_opener
def im_open(data: bytes) -> dict:
    """ImImagePlugin's ``_open`` (no prefix check: tried on every file no
    format before it took): "Key: value" lines up to a NUL, ^Z or the end
    of the data, the pixels after the ^Z (and a 768-byte Lut)."""
    if b"\n" not in data[:100]:
        raise NotThis("not an IM file")
    f = _File(data)
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode, n = "L", 0
    while True:
        s = f.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + f.readline()
        if len(s) > 100:
            raise NotThis("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _IM_SPLIT.match(s)
        if not m:
            raise NotThis("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            try:
                v = tuple(map(_im_number, v.replace("*", ",").split(",")))
            except ValueError as e:
                raise ic.ImageCodecError(f"IM header: {e}") from e
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        n += k in _IM_TAGS
    if not n:
        raise NotThis("Not an IM file")
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = f.read(1)
    if not s:
        raise NotThis("File truncated")
    palette = None
    if "Lut" in info:
        lut = f.read(768)
        grey = all(lut[i] == lut[i + 256] == lut[i + 512] for i in range(256))
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = _palette(lut, "RGB;L")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise NotThis("not identified by this plugin")
    return {"size": size, "mode": mode, "rawmode": rawmode, "palette": palette,
            "offset": f.pos}


def im_decode(data: bytes, hdr: dict, fault: int):
    size, mode, raw, at = hdr["size"], hdr["mode"], hdr["rawmode"], hdr["offset"]
    if (not isinstance(size, tuple) or len(size) != 2
            or not all(isinstance(v, int) for v in size)):
        raise ic.ImageCodecError(f"IM image of size {size!r}")
    w, h = size
    flip = (lambda a: a) if fault & FAULTS["im_top_down"] else (lambda a: a[::-1])
    if raw == "RGB;T":
        planes = {c: flip(_raw_rows(data, at + k * w * h, h, w))
                  for k, c in enumerate("GRB")}
        return np.stack([planes[c] for c in "RGB"], -1), "RGB", None
    if raw in ("1", "P;2", "P;4"):
        bits = {"1": 1, "P;2": 2, "P;4": 4}[raw]
        rows = flip(_raw_rows(data, at, h, (w * bits + 7) // 8))
        v = _bits(rows, w * bits).reshape(h, w, bits)
        v = (v * (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)).sum(2, dtype=np.uint8)
        if raw == "1":
            return v * np.uint8(255), "1", None
        return v, "P", (hdr["palette"] if hdr["palette"] is not None
                        else np.zeros((0, 3), np.uint8))
    if raw not in _IM_RAW or mode not in ("L", "P", "RGB", "LA", "PA", "RGBA", "CMYK",
                                          "I", "F", "I;16", "I;16L", "I;16B"):
        raise ic.ImageCodecError(f"IM images of type {mode!r} ({raw}) are not supported")
    dtype, k = _IM_RAW[raw]
    size_k = np.dtype(dtype).itemsize * k
    rows = flip(_raw_rows(data, at, h, w * size_k))
    if raw.endswith(";L"):           # a line of each band in turn
        v = rows.reshape(h, k, w).transpose(0, 2, 1)
    else:
        v = np.ascontiguousarray(rows).view(dtype).reshape((h, w) if k == 1 else (h, w, k))
    if mode == "F":
        return v.astype(np.float32), "F", None
    if mode.startswith("I"):
        return v.astype(np.int32), "I", None
    if mode in ("LA", "PA"):
        out_mode = "PA" if mode == "PA" else "LA"
        return np.ascontiguousarray(v), out_mode, hdr["palette"]
    if raw == "RGBX;L":
        v = v[..., :3]
    if mode == "P":
        return np.ascontiguousarray(v), "P", (hdr["palette"] if hdr["palette"] is not None
                                              else np.zeros((0, 3), np.uint8))
    return np.ascontiguousarray(v), mode, None


# -------------------------------------------------------------------- MSP

def msp_accept(prefix: bytes) -> bool:
    return prefix.startswith((b"DanM", b"LinS"))


@_opener
def msp_open(data: bytes) -> dict:
    s = data[:32]
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= _u16le(s, i)
    if checksum:
        raise NotThis("bad MSP checksum")
    return {"size": (_u16le(s, 4), _u16le(s, 6)), "mode": "1", "v2": s.startswith(b"LinS")}


def msp_decode(data: bytes, hdr: dict, fault: int):
    w, h = hdr["size"]
    linebytes = (w + 7) // 8
    if not hdr["v2"]:
        rows = _raw_rows(data, 32, h, linebytes)
        return _bits(rows, w) * np.uint8(255), "1", None
    body = data[32:]
    src = _buf(body)
    cap = linebytes * h + 255 * len(body) + 1
    out = np.empty(cap, np.uint8)
    err = _err()
    n = LIBRARY.get().cpt_msp_rle(src.ctypes.data, len(body), h, linebytes, _c_fault(fault),
                                  out.ctypes.data, cap, err, ic._ERR_LEN)
    ic._check(n, err)
    if n < linebytes * h:
        raise ic.ImageCodecError("not enough image data")
    rows = out[:linebytes * h].reshape(h, linebytes)
    return _bits(rows, w) * np.uint8(255), "1", None


# -------------------------------------------------------------- XBM, XPM

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def xbm_accept(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


def xbm_open(data: bytes) -> dict:
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise NotThis("not a XBM file")
    return {"size": (int(m.group("width")), int(m.group("height"))), "mode": "1",
            "offset": m.end()}


def xbm_decode(data: bytes, hdr: dict, fault: int):
    w, h = hdr["size"]
    linebytes = (w + 7) // 8
    rows = np.empty((h, linebytes), np.uint8)
    body = data[hdr["offset"]:]
    src = _buf(body)
    n = LIBRARY.get().cpt_xbm(src.ctypes.data, len(body), linebytes, h, rows.ctypes.data)
    if n < h:
        _truncated(f"XBM data gives {n} of {h} rows")
    lsb = not fault & FAULTS["xbm_msb_first"]
    return _bits(rows, w, lsb_first=lsb) * np.uint8(255), "1", None


_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def xpm_accept(prefix: bytes) -> bool:
    return prefix.startswith(b"/* XPM */")


@_opener
def xpm_open(data: bytes) -> dict:
    """XpmImagePlugin's ``_open``: the values line, then a palette line for
    each colour (``c #rrggbb`` or ``c None`` only)."""
    f = _File(data, 9)
    while True:
        line = f.readline()
        if not line:
            raise NotThis("broken XPM file")
        m = _XPM_HEAD.match(line)
        if m:
            break
    try:
        w, h, n, bpp = (int(g) for g in m.groups())
    except ValueError as e:
        raise ic.ImageCodecError(f"XPM header: {e}") from e
    palette = {}
    for _ in range(n):
        line = f.readline().rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError as e:
                        raise ic.ImageCodecError(f"XPM colour: {e}") from e
                    palette[c] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ic.ImageCodecError("cannot read this XPM file")
                break
        else:
            raise ic.ImageCodecError("cannot read this XPM file")
    return {"size": (w, h), "mode": "RGB" if n > 256 else "P", "bpp": bpp,
            "palette": palette, "offset": f.pos}


def xpm_decode(data: bytes, hdr: dict, fault: int):
    """XpmDecoder: each line's text between its first and last quote (a
    lone ``/* pixels */`` line skipped), ``bpp`` characters a pixel, until
    the image is full or the file ends."""
    (w, h), bpp, pal = hdr["size"], hdr["bpp"], hdr["palette"]
    keys = list(pal)
    index = {k: i for i, k in enumerate(sorted(keys) if fault & FAULTS["xpm_keys_sorted"]
                                        else keys)}
    if bpp <= 0:
        raise ic.ImageCodecError("XPM of 0 characters a pixel")
    need = w * h
    f = _File(data, hdr["offset"])
    lines, have, header = [], 0, False
    while have < need:
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        lines.append(line)
        have += -(-len(line) // bpp)
    # every line's keys, a short last one padded: each key a number (its
    # bytes big-endian, then its length), looked up among the palette's
    codes, lens = [], []
    for line in lines:
        k = -(-len(line) // bpp)
        codes.append(line.ljust(k * bpp, b"\0"))
        lens.append(np.full(k, bpp, np.int64))
        if len(line) % bpp:
            lens[-1][-1] = len(line) % bpp
    blob = np.frombuffer(b"".join(codes), np.uint8).reshape(-1, bpp)
    klen = np.concatenate(lens) if lens else np.zeros(0, np.int64)

    def number(keys: np.ndarray, n: np.ndarray) -> np.ndarray:
        v = np.zeros(len(keys), object if bpp > 7 else np.int64)
        for j in range(bpp):
            v = v * 256 + keys[:, j].astype(v.dtype)
        return v * 256 + n.astype(v.dtype)

    pkeys = list(index)
    ptab = np.zeros((len(pkeys), bpp), np.uint8)
    for i, k in enumerate(pkeys):
        ptab[i, :len(k)] = np.frombuffer(k, np.uint8)[:bpp]
    pnum = number(ptab, np.array([len(k) for k in pkeys], np.int64))
    order = np.argsort(pnum, kind="stable")
    num = number(blob, klen)
    at = np.searchsorted(pnum[order], num)
    at = np.minimum(at, max(len(pkeys) - 1, 0))
    if len(num) and (not len(pkeys) or not (pnum[order][at] == num).all()):
        raise ic.ImageCodecError("XPM pixel not in its palette")
    if len(num) < need:
        raise ic.ImageCodecError("not enough image data")
    idx = np.asarray([index[k] for k in pkeys], np.int64)[order][at][:need].reshape(h, w)
    table = np.asarray([pal[k] for k in keys], np.uint8).reshape(-1, 3)
    if hdr["mode"] == "RGB":
        return table[idx], "RGB", None
    return idx.astype(np.uint8), "P", table


# ------------------------------------- formats tried but not read (probes)

@_opener
def gbr_probe(data: bytes) -> bool:
    """GbrImagePlugin's ``_open`` checks (its prefix test passed)."""
    f = _File(data)
    if _u32be(f.read(4)) < 20:
        raise NotThis("not a GIMP brush")
    version = _u32be(f.read(4))
    if version not in (1, 2):
        raise NotThis("Unsupported GIMP brush version")
    width, height, depth = (_u32be(f.read(4)) for _ in range(3))
    if width == 0 or height == 0 or depth not in (1, 4):
        raise NotThis("not a GIMP brush")
    if version == 2 and f.read(4) != b"GIMP":
        raise NotThis("not a GIMP brush, bad magic number")
    return True


def fli_probe(data: bytes) -> bool:
    s = data[:128]
    if not (s[20:22] == b"\0\0" and s[42:80] == b"\0" * 38 and s[88:] == b"\0" * 40):
        raise NotThis("not an FLI/FLC file")
    return True


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def imt_probe(data: bytes) -> bool:
    """ImtImagePlugin's ``_open``: identified when it found "pixel n8" and
    a positive width and height."""
    f = _File(data)
    buffer = f.read(100)
    if b"\n" not in buffer:
        raise NotThis("not an IM file")
    w = h = 0
    mode = None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = f.read(1)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += f.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError as e:
            raise ic.ImageCodecError(f"IMT header: {e}") from e
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or w <= 0 or h <= 0:
        raise NotThis("not identified by this plugin")
    return True


@_opener
def iptc_probe(data: bytes) -> bool:
    """IptcImagePlugin's ``_open``: the fields up to the image data tag
    (8, 10), then the layers, size and compression it needs."""
    f = _File(data)
    info = {}
    tag = None

    def field():
        s = f.read(5)
        if not s.strip(b"\0"):
            return None, 0
        t = s[1], s[2]
        if s[0] != 0x1C or t[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise NotThis("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise ic.ImageCodecError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _u32be((b"\0\0\0\0" + f.read(size - 128))[-4:])
        else:
            size = _u16be(s, 3)
        return t, size

    while True:
        tag, size = field()
        if not tag or tag == (8, 10):
            break
        value = f.read(size) if size else None
        if tag in info:
            info[tag] = (info[tag] + [value] if isinstance(info[tag], list)
                         else [info[tag], value])
        else:
            info[tag] = value

    def getint(key):
        return _u32be((b"\0\0\0\0" + info[key])[-4:])

    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode = None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        if (3, 65) in info:      # read for the errors it raises (the band)
            info[(3, 65)][0] - 1
    size = getint((3, 20)), getint((3, 30))
    if getint((3, 120)) not in (1, 5):
        raise ic.ImageCodecError("Unknown IPTC image compression")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise NotThis("not identified by this plugin")
    return True


def pcd_probe(data: bytes) -> bool:
    if not data[2048:2048 + 1539].startswith(b"PCD_"):
        raise NotThis("not a PCD file")
    return True


def _spider_int(v: float) -> bool:
    try:
        return v - int(v) == 0
    except (ValueError, OverflowError):
        return False


def _spider_header(t: tuple) -> int:
    h = (99,) + t
    if not all(_spider_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def spider_probe(data: bytes) -> bool:
    """SpiderImagePlugin's ``_open``: 27 floats, big- then little-endian,
    that make a 2D image's header."""
    f = data[:108]
    try:
        t = struct.unpack(">27f", f)
        n = _spider_header(t)
        if n == 0:
            t = struct.unpack("<27f", f)
            n = _spider_header(t)
    except struct.error as e:
        raise NotThis("not a valid Spider file") from e
    if n == 0:
        raise NotThis("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThis("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    stack, number = int(h[24]), int(h[27])
    if not (stack == 0 and number >= 0 or stack > 0 and number == 0):
        raise NotThis("inconsistent stack header values")
    if size[0] <= 0 or size[1] <= 0:
        raise NotThis("not identified by this plugin")
    return True
