"""Detection on one image (port of ``run_detector`` in
``cpt_tpu/tools/demo.py``, the reference's ``COCODemo.compute_prediction``
+ ``select_top_predictions``, ``demo/predictor.py:224-280``).

The image is pasted, unresized, at the top left of the square
``pad_h × pad_h`` canvas, the detector runs in RPN mode, and the
detections above the confidence threshold come back in descending score
order. The overlay drawing and the webcam loop of the JAX tool are not
ported yet.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from cpt_tpu_torch.models.detector.config import DetectorConfig
from cpt_tpu_torch.models.detector.rpn import grid_anchors


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
