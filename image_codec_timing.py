#!/usr/bin/env python3
"""Host time of the port's image codec (``cpt_tpu_torch/utils/
image_codec``) beside Pillow's on the same inputs: every fixture of
``chip_smoke.CODEC_DIGESTS`` decoded to RGB (among them the four 480x640
WEBP files: lossy at quality 75 and 95, lossy with alpha, lossless; and
three 480x640 JPEG files: arithmetic-coded progressive, lossless grey and
progressive left unrefined (block smoothing); committed, so the card's
host, which has no Pillow, times them too); a
480x640 photo in each kind
the codec reads besides YCbCr JPEG (CMYK JPEG, baseline and progressive;
YCCK JPEG; 16-bit grey, 48-bit and 64-bit PNG; GIF, plain and interlaced;
BMP at 24 bits, 8 bits RLE and 16 bits 565) decoded to RGB (``big:``
entries; written with Pillow and the fixture script's writers, so they
need Pillow); the 480x640 photo as a TIFF, raw (Pillow's layout), LZW
under the horizontal predictor, Deflate and PackBits in strips of 34 rows
(``tiff:`` entries; written by the fixture script's plain TIFF writer, so
the card's host makes them too; the YCbCr JPEG TIFF is a committed
fixture); every seeded array of ``chip_smoke.codec_encode_inputs`` encoded
to JPEG, the 480x640 photo encoded to BMP, and the arrays of
``chip_smoke.codec_tiff_encode_inputs`` to TIFF. Prints one JSON
line: for each input, the median of ``--reps`` calls in ms of the codec
and of Pillow (null where Pillow is absent), and whether the two outputs
are equal. The times are of the host this runs on (no card is used).
``chip_smoke.CODEC_PILLOW_MS`` holds Pillow's figures for the 480x640
quality-95 JPEG decode and encode, the arithmetic, lossless and smoothed
480x640 JPEG decodes, the 480x640 WEBP decodes, the 480x640 YCbCr JPEG
TIFF decode and the 480x640 TIFF encode from runs of this script.

    python3 image_codec_timing.py [--reps 20]
"""
from __future__ import annotations

import argparse
import importlib.util
import io
import json

import numpy as np

import chip_smoke
from cpt_tpu_torch.utils import image_codec


def pillow():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def fixture_script():
    """tests/data/codec/make_fixtures.py (its TIFF writer needs no Pillow)."""
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", chip_smoke.CODEC_DIR / "make_fixtures.py")
    mf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mf)
    return mf


def tiff_inputs() -> dict:
    """name → TIFF bytes of the 480x640 photo: raw (encode_tiff, Pillow's
    layout), LZW under the horizontal predictor, Deflate and PackBits."""
    mf = fixture_script()
    photo = chip_smoke.codec_tiff_encode_inputs()["photo_rgb"]
    return {"raw_480x640.tif": image_codec.encode_tiff(photo),
            "lzw_pred_480x640.tif": mf.tiff_file(photo, 5, 2, rows=34),
            "deflate_480x640.tif": mf.tiff_file(photo, 8, rows=34),
            "packbits_480x640.tif": mf.tiff_file(photo, 32773, rows=34)}


def big_inputs(Image) -> dict:
    """name → file bytes of the 480x640 photo in each new kind."""
    mf = fixture_script()
    photo = chip_smoke.codec_photo(11, 480, 640)
    k = chip_smoke.codec_photo(12, 480, 640)[..., 1]
    wide = photo.astype(np.uint16) * 257 + k[..., None]

    def pil(im, **kw):
        buf = io.BytesIO()
        im.save(buf, **kw)
        return buf.getvalue()

    rgb = Image.fromarray(photo)
    blocky = np.kron(photo[::8, ::8, 0] // 16, np.ones((8, 8), np.uint8))
    return {
        "cmyk_q95.jpg": pil(rgb.convert("CMYK"), format="JPEG", quality=95),
        "cmyk_progressive_q95.jpg": pil(rgb.convert("CMYK"), format="JPEG",
                                        quality=95, progressive=True),
        "ycck_q95.jpg": mf.ycck_jpeg(mf.ycck_planes(photo, k), 95),
        "i16.png": pil(Image.fromarray(wide[..., 0]), format="PNG"),
        "rgb48.png": mf.png16(wide, 2),
        "rgba64.png": mf.png16(np.concatenate([wide, wide[..., :1]], 2), 6),
        "p.gif": pil(rgb.quantize(256), format="GIF", interlace=0),
        "p_interlaced.gif": pil(rgb.quantize(256), format="GIF"),
        "rgb.bmp": pil(rgb, format="BMP"),
        "rle8.bmp": mf.bmp_file(blocky, 8, np.arange(768).reshape(256, 3) % 256,
                                compression=1),
        "bitfields565.bmp": mf.bmp_file(photo, 16, compression=3,
                                        masks=(0xF800, 0x7E0, 0x1F)),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    Image = pillow()
    out = {}
    for path in chip_smoke.codec_fixture_files():
        data = path.read_bytes()
        pil = (lambda: np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
               ) if Image else None
        out[f"decode:{path.name}"] = {
            "bytes": len(data),
            "codec_ms": chip_smoke.median_ms(
                lambda: image_codec.decode(data), args.reps),
            "pillow_ms": chip_smoke.median_ms(pil, args.reps) if pil else None,
            "equal": bool(np.array_equal(image_codec.decode(data), pil()))
            if pil else None}
    for name, data in (big_inputs(Image) if Image else {}).items():
        def pil_decode(data=data):
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        out[f"big:{name}"] = {
            "bytes": len(data),
            "codec_ms": chip_smoke.median_ms(
                lambda: image_codec.decode(data), args.reps),
            "pillow_ms": chip_smoke.median_ms(pil_decode, args.reps),
            "equal": bool(np.array_equal(image_codec.decode(data),
                                         pil_decode()))}
    for name, data in tiff_inputs().items():
        def pil_decode(data=data):
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        out[f"tiff:{name}"] = {
            "bytes": len(data),
            "codec_ms": chip_smoke.median_ms(
                lambda: image_codec.decode(data), args.reps),
            "pillow_ms": chip_smoke.median_ms(pil_decode, args.reps)
            if Image else None,
            "equal": bool(np.array_equal(image_codec.decode(data),
                                         pil_decode())) if Image else None}
    photo = chip_smoke.codec_encode_inputs()["photo_q95"][0]

    def pil_bmp():
        buf = io.BytesIO()
        Image.fromarray(photo).save(buf, format="BMP")
        return buf.getvalue()
    out["encode:photo_bmp"] = {
        "shape": list(photo.shape),
        "codec_ms": chip_smoke.median_ms(lambda: image_codec.encode_bmp(photo),
                                         args.reps),
        "pillow_ms": chip_smoke.median_ms(pil_bmp, args.reps) if Image else None,
        "equal": image_codec.encode_bmp(photo) == pil_bmp() if Image else None}
    for name, (arr, quality) in chip_smoke.codec_encode_inputs().items():
        def pil_encode(arr=arr, quality=quality):
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
            return buf.getvalue()
        out[f"encode:{name}"] = {
            "shape": list(arr.shape),
            "codec_ms": chip_smoke.median_ms(
                lambda: image_codec.encode_jpeg(arr, quality), args.reps),
            "pillow_ms": chip_smoke.median_ms(pil_encode, args.reps)
            if Image else None,
            "equal": image_codec.encode_jpeg(arr, quality) == pil_encode()
            if Image else None}
    for name, arr in chip_smoke.codec_tiff_encode_inputs().items():
        def pil_tiff(arr=arr):
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="TIFF")
            return buf.getvalue()
        out[f"encode_tiff:{name}"] = {
            "shape": list(arr.shape),
            "codec_ms": chip_smoke.median_ms(
                lambda: image_codec.encode_tiff(arr), args.reps),
            "pillow_ms": chip_smoke.median_ms(pil_tiff, args.reps)
            if Image else None,
            "equal": image_codec.encode_tiff(arr) == pil_tiff() if Image else None}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
