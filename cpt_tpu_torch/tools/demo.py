"""Visualization demo: colored prompts, grounding boxes and detections (port
of ``cpt_tpu/tools/demo.py``).

Mirrors the reference's ``demo/`` visualizers: ``color_image.py`` (prompt
paints, on ``ops/render.paste_rect``), and ``predictor.py``'s COCODemo: run
the detector on an image (:func:`run_detector`, RPN mode on the kernels
K1, K2 and K5; ``compute_prediction`` + ``select_top_predictions``,
``predictor.py:224-280``), keep the detections above ``--conf``, and overlay
per-class-colored boxes with class names and scores
(``predictor.py:261-411``), written as PNGs. ``--webcam`` runs the same
over a capture device (``webcam.py``; cv2). Images are read and written
through ``utils/image_codec`` (JPEG, PNG, GIF, BMP, WEBP and TIFF in;
``--out`` as .png, .jpg, .bmp or .tif); the detection captions
(:func:`overlay_detections`) are drawn by ``utils/text`` in Pillow's
default font, pixel for pixel.
Nothing here needs Pillow.

Usage:
  # prompt painting
  python -m cpt_tpu_torch.tools.demo --image img.jpg \\
      --boxes '[[10,10,120,140],[150,40,300,220]]' --out out.png \\
      [--pred_box '[10,10,120,140]'] [--multi_color]
  # detection overlay (COCODemo equivalent)
  python -m cpt_tpu_torch.tools.demo --image img.jpg --detect \\
      --checkpoint vinvl_vg_x152c4.pth --labelmap VG-SGG-dicts.json \\
      --conf 0.5 --out det.png

The image is pasted, unresized, at the top left of the square ``pad_h ×
pad_h`` canvas. Without ``--checkpoint`` the detector's weights are random,
drawn from ``--seed`` in the reference layout.
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Tuple

import numpy as np
import torch

from cpt_tpu_torch.data.prompts import CROSS_TASK_COLORS, REFCOCO_COLORS
from cpt_tpu_torch.models.detector.config import DetectorConfig
from cpt_tpu_torch.models.detector.rpn import grid_anchors
from cpt_tpu_torch.ops.render import paste_rect
from cpt_tpu_torch.utils import text


def draw_box_outline(img: np.ndarray, box, color, thickness: int = 3
                     ) -> np.ndarray:
    """A copy of ``img`` with the inclusive box's outline in ``color``."""
    x1, y1, x2, y2 = [int(v) for v in box]
    h, w = img.shape[:2]
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, w - 1), min(y2, h - 1)
    out = img.copy()
    c = np.asarray(color[:3], np.uint8)
    out[y1:y1 + thickness, x1:x2 + 1] = c
    out[max(y2 - thickness + 1, 0):y2 + 1, x1:x2 + 1] = c
    out[y1:y2 + 1, x1:x1 + thickness] = c
    out[y1:y2 + 1, max(x2 - thickness + 1, 0):x2 + 1] = c
    return out


# COCODemo's per-class color hash (predictor.py:127: palette constant)
_PALETTE = np.asarray([2 ** 25 - 1, 2 ** 15 - 1, 2 ** 21 - 1],
                      dtype=np.int64)


def colors_for_labels(labels: np.ndarray) -> np.ndarray:
    """Fixed per-class colors (predictor.py:282-288)."""
    return (np.asarray(labels, np.int64)[:, None] * _PALETTE % 255
            ).astype(np.uint8)


def overlay_detections(img: np.ndarray, boxes, labels, scores,
                       class_names=None) -> np.ndarray:
    """Box outlines in per-class colors + "name: score" captions
    (predictor.py:290-311 overlay_boxes + :384-411 overlay_class_names),
    the captions as Pillow's ``ImageDraw.text`` draws them."""
    colors = colors_for_labels(labels)
    for box, color in zip(boxes, colors):
        img = draw_box_outline(img, box, color, thickness=2)
    for box, label, score, color in zip(boxes, labels, scores, colors):
        name = (class_names.get(int(label), str(int(label)))
                if class_names else str(int(label)))
        img = text.draw_text(img, (int(box[0]) + 2, max(int(box[1]) - 11, 0)),
                             f"{name}: {score:.2f}",
                             tuple(int(c) for c in color))
    return img


def detector_canvas(img: np.ndarray, cfg: DetectorConfig
                    ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """RGB image → (uint8 canvas [pad_h, pad_h, 3], true (h, w) on it)."""
    h = w = cfg.input.pad_h
    canvas = np.zeros((h, w, 3), np.uint8)
    ih, iw = img.shape[:2]
    canvas[: min(ih, h), : min(iw, w)] = img[:h, :w]
    return canvas, (min(ih, h), min(iw, w))


def canvas_anchors(cfg: DetectorConfig, device) -> torch.Tensor:
    """The RPN anchors of the square canvas's C4 grid, on ``device``."""
    n = cfg.input.pad_h // cfg.rpn.anchor_stride
    return torch.from_numpy(grid_anchors(cfg.rpn, n, n)).to(device)


def run_detector(detect_fn: Callable, anchors: torch.Tensor,
                 cfg: DetectorConfig, img: np.ndarray, conf: float):
    """``detect_fn`` (``engine/extract.make_detect_fn``) on the image's
    canvas → (boxes [n, 4], labels [n], scores [n]) numpy, the valid
    detections with score > ``conf``, by descending score."""
    canvas, hw = detector_canvas(img, cfg)
    _, boxes, labels, scores, valid, _ = detect_fn(
        torch.from_numpy(canvas).to(anchors.device), anchors, hw)
    boxes, labels, scores, valid = (t.cpu().numpy()
                                    for t in (boxes, labels, scores, valid))
    keep = valid & (scores > conf)
    order = np.argsort(-scores[keep])
    return boxes[keep][order], labels[keep][order], scores[keep][order]


def build_detect(args) -> Callable:
    """The detector of ``args`` (``--tiny``, ``--checkpoint`` or random
    weights from ``--seed``, ``--dtype``, ``--device``), built once → a
    function image → (boxes, labels, scores) of :func:`run_detector` at
    ``--conf``."""
    from cpt_tpu_torch.engine.extract import make_detect_fn
    from cpt_tpu_torch.models.detector.config import (VINVL_X152C4,
                                                      tiny_detector_config)
    from cpt_tpu_torch.tools.extract_features import build_detector

    cfg = tiny_detector_config() if args.tiny else VINVL_X152C4
    model = build_detector(cfg, args)
    fn = make_detect_fn(model, cfg, with_attributes=False)
    anchors = canvas_anchors(cfg, args.device)
    return lambda img: run_detector(fn, anchors, cfg, img, args.conf)


def run_webcam(args, detect: Callable) -> None:
    """Live detection loop over a capture device (reference
    ``demo/webcam.py:1-71``): grab a frame, ``detect`` it, overlay, and
    display it (or write the frames to ``--out`` with no display)."""
    import cv2

    cam = cv2.VideoCapture(args.webcam_device)
    if not cam.isOpened():
        raise RuntimeError(f"cannot open camera {args.webcam_device}")
    n = 0
    try:
        while args.max_frames <= 0 or n < args.max_frames:
            ok, bgr = cam.read()
            if not ok:
                break
            img = bgr[:, :, ::-1]
            boxes, labels, scores = detect(img)
            vis = overlay_detections(np.ascontiguousarray(img), boxes,
                                     labels, scores)
            if args.out:
                cv2.imwrite(args.out.replace(".png", f"_{n:04d}.png"),
                            vis[:, :, ::-1])
            else:  # pragma: no cover - needs a display
                cv2.imshow("cpt_tpu_torch detections", vis[:, :, ::-1])
                if cv2.waitKey(1) == 27:
                    break
            n += 1
    finally:
        cam.release()
    print(f"processed {n} frames")


def paint(img: np.ndarray, boxes, multi_color: bool, device) -> list:
    """The prompt paints of ``boxes`` → [(tag, RGB array)]: one red copy a
    box (RefCOCO, ``[x1, x2)``), or with ``multi_color`` all boxes on one
    copy in the cross-task palette, inclusive (GQA / VCR)."""
    base = torch.from_numpy(np.array(img)).to(device)

    def rgba(c):
        return torch.tensor(c, dtype=torch.uint8, device=device)

    def rect(b):
        return torch.tensor(b, dtype=torch.float32, device=device)

    if multi_color:
        canvas = base
        for i, box in enumerate(boxes):
            _, color = CROSS_TASK_COLORS[i % len(CROSS_TASK_COLORS)]
            canvas = paste_rect(canvas, rect(box), rgba(color), inclusive=True)
        return [("all", canvas.cpu().numpy())]
    _, color = REFCOCO_COLORS[0]
    return [(f"copy{i}", paste_rect(base, rect(box), rgba(color)).cpu().numpy())
            for i, box in enumerate(boxes)]


def build_args():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image", default=None)
    p.add_argument("--boxes", default=None, help="json [[x1,y1,x2,y2],...]")
    p.add_argument("--out", required=True)
    p.add_argument("--pred_box", default=None)
    p.add_argument("--multi_color", action="store_true",
                   help="use the 6-color cross-task palette (one color per "
                        "box) instead of one red copy per box")
    p.add_argument("--detect", action="store_true",
                   help="run the detector and overlay per-class boxes + "
                        "names/scores (COCODemo equivalent)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--labelmap", default=None,
                   help="VG-SGG-dicts json (idx_to_label) for class names")
    p.add_argument("--conf", type=float, default=0.5,
                   help="confidence threshold (predictor.py:139)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--webcam", action="store_true",
                   help="live detection from a capture device (reference "
                        "demo/webcam.py); frames written to --out when "
                        "headless")
    p.add_argument("--webcam_device", type=int, default=0)
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop the webcam loop after N frames (0 = until "
                        "ESC/stream end)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used without --checkpoint")
    return p


def main(argv=None):
    args = build_args().parse_args(argv)
    if args.webcam:
        return run_webcam(args, build_detect(args))
    if not args.image:
        raise SystemExit("demo: --image is required (or --webcam)")
    from cpt_tpu_torch.utils.image_codec import read_image, write_image

    img = read_image(args.image)
    if args.detect:
        from cpt_tpu_torch.tools.extract_features import load_labelmap

        boxes, labels, scores = build_detect(args)(img)
        names = load_labelmap(args.labelmap) if args.labelmap else None
        arr = overlay_detections(img.copy(), boxes, labels, scores, names)
        write_image(args.out, arr)
        print(f"wrote {args.out} ({len(boxes)} detections > {args.conf})")
        return boxes, labels, scores
    if not args.boxes:
        raise SystemExit("demo: --boxes is required unless --detect")
    outputs = paint(img, json.loads(args.boxes), args.multi_color, args.device)
    for tag, arr in outputs:
        if args.pred_box:
            arr = draw_box_outline(arr, json.loads(args.pred_box),
                                   (0, 255, 0))
        out_path = (args.out if len(outputs) == 1
                    else args.out.replace(".png", f"_{tag}.png"))
        write_image(out_path, arr)
        print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
