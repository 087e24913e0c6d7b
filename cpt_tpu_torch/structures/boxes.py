"""Host-side box helpers (port of the host functions of
``cpt_tpu/structures/boxes.py``).

Boxes are inclusive pixel xyxy with ``TO_REMOVE = 1`` (widths are
``x2 - x1 + 1``), exactly the reference's convention.
"""
from __future__ import annotations

import numpy as np

TO_REMOVE = 1.0  # reference's +1 box-width convention


def xywh_iou(a, b) -> float:
    """Scalar IoU over xywh boxes; mirrors the reference's
    ``Oscar/oscar/utils/iou.py::computeIoU`` used by every eval rule."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2 = min(a[0] + a[2] - 1, b[0] + b[2] - 1)
    iy2 = min(a[1] + a[3] - 1, b[1] + b[3] - 1)
    iw, ih = max(ix2 - ix1 + 1, 0), max(iy2 - iy1 + 1, 0)
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def pad_boxes(xyxy, max_boxes: int):
    """Pad an ``(n, 4)`` array to ``(max_boxes, 4)`` + validity mask (boxes
    beyond ``max_boxes`` are dropped)."""
    n = min(len(xyxy), max_boxes)
    out = np.zeros((max_boxes, 4), dtype=np.float32)
    out[:n] = np.asarray(xyxy, dtype=np.float32)[:n]
    mask = np.zeros((max_boxes,), dtype=bool)
    mask[:n] = True
    return out, mask
