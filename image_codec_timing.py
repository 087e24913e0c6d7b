#!/usr/bin/env python3
"""Host time of the port's JPEG / PNG codec (``cpt_tpu_torch/utils/
image_codec``) beside Pillow's on the same inputs: every fixture of
``chip_smoke.CODEC_DIGESTS`` decoded to RGB, and every seeded array of
``chip_smoke.codec_encode_inputs`` encoded to JPEG. Prints one JSON line:
for each input, the median of ``--reps`` calls in ms of the codec and of
Pillow (null where Pillow is absent), and whether the two outputs are
equal. ``chip_smoke.CODEC_PILLOW_MS`` holds Pillow's figures for the
480x640 quality-95 decode and encode from a run of this script.

    python3 image_codec_timing.py [--reps 20]
"""
from __future__ import annotations

import argparse
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
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
