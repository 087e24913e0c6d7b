#!/usr/bin/env python3
"""Host time of the port's Pillow-free pixel operations
(``cpt_tpu_torch/utils/image_ops``) beside Pillow's on the same inputs: the
inputs of ``chip_smoke.RESIZE_DIGESTS`` (phase 8's two resized requests,
phase 17's ×0.75 and ×1.25 rescales, a nearest mask scale, phase 9's
polygons). Prints one JSON line: for each input, the median of ``--reps``
calls in ms of image_ops and of Pillow (null where Pillow is absent), and
whether the two outputs are equal.

    python3 image_ops_timing.py [--reps 5]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

import chip_smoke
from cpt_tpu_torch.utils import image_ops


def pillow_call(fn: str, args: tuple):
    """The Pillow call ``fn`` stands for, or None without Pillow."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        return None
    if fn == "resize_bilinear":
        return lambda: np.asarray(Image.fromarray(args[0]).resize(
            args[1], Image.BILINEAR))
    if fn == "resize_nearest":
        return lambda: np.asarray(Image.fromarray(args[0]).resize(
            args[1], Image.NEAREST))

    def fill():
        polygon, h, w = args
        img = Image.new("L", (w, h), 0)
        draw = ImageDraw.Draw(img)
        for part in image_ops._parts(polygon):
            if len(part):
                part = list(part) + ([part[0]] if len(part) < 2 else [])
                draw.polygon([(float(x), float(y)) for x, y in part], fill=1)
        return np.asarray(img)
    return fill


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    out = {}
    for name, (fn, fargs) in chip_smoke.resize_digest_inputs().items():
        ours = getattr(image_ops, fn)
        pil = pillow_call(fn, fargs)
        out[name] = {
            "shape": list(np.shape(fargs[0])) if fn != "fill_polygon"
            else [fargs[1], fargs[2]],
            "image_ops_ms": chip_smoke.median_ms(lambda: ours(*fargs), args.reps),
            "pillow_ms": chip_smoke.median_ms(pil, args.reps) if pil else None,
            "equal": bool(np.array_equal(ours(*fargs), pil())) if pil else None}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
