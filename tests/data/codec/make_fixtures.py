#!/usr/bin/env python3
"""Write the image codec's fixture files (this directory) with Pillow, and
print the SHA-256 digest of each one's decoded pixels as Pillow gives them
(``chip_smoke.CODEC_DIGESTS`` holds them; ``tests/test_torch_image_codec.py``
checks them against Pillow).

    python3 tests/data/codec/make_fixtures.py

JPEG: baseline 4:4:4, 4:2:2 and 4:2:0; quality 10, 75 and 95; optimized
Huffman tables; progressive; restart markers; grayscale; an odd size
(481x641); an Adobe RGB file (``keep_rgb=True``). PNG: L, LA, RGB, RGBA,
P at 1, 2, 4 and 8 bits (Pillow's writer), and one Adam7-interlaced RGB
file whose rows all take the Paeth filter (built here with zlib; Pillow
does not write interlaced PNGs).
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
    return out


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def main() -> dict:
    digests = {}
    for name, data in fixtures().items():
        (HERE / name).write_bytes(data)
        for mode in ("RGB", "L"):
            im = Image.open(io.BytesIO(data)).convert(mode)
            digests[f"{name}:{mode}"] = digest(np.asarray(im))
    total = sum((HERE / n).stat().st_size for n in fixtures())
    print(f"# {len(digests) // 2} files, {total} bytes")
    for k, v in digests.items():
        print(f'    "{k}": "{v}",')
    return digests


if __name__ == "__main__":
    main()
