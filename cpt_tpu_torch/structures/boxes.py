"""Box helpers (port of the host functions and ``decode_boxes`` of
``cpt_tpu/structures/boxes.py``): the scalar IoU of the eval rules, the
pairwise IoU of VG's pair enumeration (numpy) and of the detector's
training matcher (torch), box encoding, decoding and padding.

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


def box_iou_np(a, b) -> np.ndarray:
    """Pairwise IoU [N, M] of inclusive xyxy boxes (+1 widths), in numpy
    f32: the host-side pair enumeration of VG's pickle route."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    area = lambda x: (np.maximum(x[:, 2] - x[:, 0] + TO_REMOVE, 0.0)
                      * np.maximum(x[:, 3] - x[:, 1] + TO_REMOVE, 0.0))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt + TO_REMOVE, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter,
                              1e-10)


def box_area(xyxy: torch.Tensor) -> torch.Tensor:
    """Area with the reference's +1 convention (``bounding_box.py:66-70``)."""
    w = torch.clamp(xyxy[..., 2] - xyxy[..., 0] + TO_REMOVE, min=0.0)
    h = torch.clamp(xyxy[..., 3] - xyxy[..., 1] + TO_REMOVE, min=0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of ``a [N, 4]`` and ``b [M, 4]`` → ``[N, M]`` (reference
    ``boxlist_ops.boxlist_iou:52-91``, inclusive +1 widths)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + TO_REMOVE, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


def encode_boxes(ref: torch.Tensor, proposals: torch.Tensor,
                 weights: Tuple[float, float, float, float]) -> torch.Tensor:
    """Faster-RCNN box encoding (reference ``modeling/box_coder.py:35-65``):
    the deltas that take ``proposals`` to ``ref``."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0] + TO_REMOVE
    ex_h = proposals[..., 3] - proposals[..., 1] + TO_REMOVE
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w = ref[..., 2] - ref[..., 0] + TO_REMOVE
    gt_h = ref[..., 3] - ref[..., 1] + TO_REMOVE
    gt_cx = ref[..., 0] + 0.5 * gt_w
    gt_cy = ref[..., 1] + 0.5 * gt_h
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w,
                        wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w),
                        wh * torch.log(gt_h / ex_h)], dim=-1)


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
