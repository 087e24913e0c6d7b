"""Box helpers (port of the host functions and ``decode_boxes`` of
``cpt_tpu/structures/boxes.py``).

Boxes are inclusive pixel xyxy with ``TO_REMOVE = 1`` (widths are
``x2 - x1 + 1``), exactly the reference's convention.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights: Tuple[float, float, float, float],
                 bbox_xform_clip: float = 4.135166556742356,  # log(1000/16)
                 ) -> torch.Tensor:
    """Faster-RCNN box decoding (reference ``modeling/box_coder.py:67-95``).

    ``deltas`` (..., N, 4*k) · ``anchors`` (..., N, 4) → (..., N, 4*k) xyxy,
    inclusive corners (``x2 = cx + w/2 - 1``)."""
    w = anchors[..., 2] - anchors[..., 0] + TO_REMOVE
    h = anchors[..., 3] - anchors[..., 1] + TO_REMOVE
    cx = anchors[..., 0] + 0.5 * w
    cy = anchors[..., 1] + 0.5 * h

    wx, wy, ww, wh = weights
    dx = deltas[..., 0::4] / wx
    dy = deltas[..., 1::4] / wy
    dw = torch.clamp(deltas[..., 2::4] / ww, max=bbox_xform_clip)
    dh = torch.clamp(deltas[..., 3::4] / wh, max=bbox_xform_clip)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w - TO_REMOVE,
                       pred_cy + 0.5 * pred_h - TO_REMOVE], dim=-1)
    return out.reshape(*deltas.shape[:-1], -1)


def pad_boxes(xyxy, max_boxes: int):
    """Pad an ``(n, 4)`` array to ``(max_boxes, 4)`` + validity mask (boxes
    beyond ``max_boxes`` are dropped)."""
    n = min(len(xyxy), max_boxes)
    out = np.zeros((max_boxes, 4), dtype=np.float32)
    out[:n] = np.asarray(xyxy, dtype=np.float32)[:n]
    mask = np.zeros((max_boxes,), dtype=bool)
    mask[:n] = True
    return out, mask
