"""Test-time box augmentation: horizontal flip and rescales (port of
``cpt_tpu/engine/bbox_aug.py``; reference ``engine/bbox_aug.py``,
``TEST.BBOX_AUG``). Detections of the image, its horizontal flip and each
rescale are pooled, mapped back to the image's coordinates, and merged by
one class-agnostic NMS to ``max_dets`` slots: kernel K5
(``ops/nms_pallas.nms_pallas``, where the JAX module calls XLA's
``nms_padded``) on a CUDA ``device``, at a K that depends on the data (the
count of pooled boxes, ≤ ``max_dets`` × passes).

Rescaling resizes bilinear as Pillow does (``utils/image_ops``), without
Pillow.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from cpt_tpu_torch.ops.nms_pallas import nms_pallas
from cpt_tpu_torch.utils.image_ops import resize_bilinear


def hflip_boxes(boxes: np.ndarray, width: float) -> np.ndarray:
    out = boxes.copy()
    out[:, 0] = width - boxes[:, 2] - 1
    out[:, 2] = width - boxes[:, 0] - 1
    return out


def im_detect_bbox_aug(detect_fn: Callable, image_u8: np.ndarray, image_hw, *,
                       scales: Sequence[float] = (), hflip: bool = True,
                       nms_thresh: float = 0.5, max_dets: int = 100,
                       device) -> Dict[str, np.ndarray]:
    """``detect_fn(image_u8, (h, w)) -> {boxes, scores, labels, valid}``
    (numpy) runs one detection pass; the passes over the augmentations are
    pooled and merged on ``device`` (K5 on a CUDA device, its plain version
    on the CPU). → merged {boxes, scores, labels, valid} (numpy, the
    image's coordinates)."""
    h, w = int(image_hw[0]), int(image_hw[1])
    pooled_boxes: List[np.ndarray] = []
    pooled_scores: List[np.ndarray] = []
    pooled_labels: List[np.ndarray] = []

    def add(out, unmap=None):
        v = np.asarray(out["valid"])
        boxes = np.asarray(out["boxes"])[v]
        if unmap is not None:
            boxes = unmap(boxes)
        pooled_boxes.append(boxes)
        pooled_scores.append(np.asarray(out["scores"])[v])
        pooled_labels.append(np.asarray(out["labels"])[v])

    add(detect_fn(image_u8, (h, w)))
    if hflip:
        flipped = np.ascontiguousarray(np.asarray(image_u8)[:, ::-1])
        add(detect_fn(flipped, (h, w)), unmap=lambda b: hflip_boxes(b, w))
    for s in scales:
        sh, sw = int(round(h * s)), int(round(w * s))
        scaled = np.zeros_like(np.asarray(image_u8))
        arr = resize_bilinear(np.asarray(image_u8)[:h, :w], (sw, sh))
        ch = min(sh, scaled.shape[0])
        cw = min(sw, scaled.shape[1])
        scaled[:ch, :cw] = arr[:ch, :cw]
        add(detect_fn(scaled, (ch, cw)), unmap=lambda b, s=s: b / s)

    boxes = np.concatenate(pooled_boxes)
    scores = np.concatenate(pooled_scores)
    labels = np.concatenate(pooled_labels)
    n = len(boxes)
    out_boxes = np.zeros((max_dets, 4), np.float32)
    out_scores = np.zeros((max_dets,), np.float32)
    out_labels = np.zeros((max_dets,), np.int64)
    if n == 0:
        return {"boxes": out_boxes, "scores": out_scores, "labels": out_labels,
                "valid": np.zeros((max_dets,), bool)}
    idx, keep = nms_pallas(
        torch.as_tensor(boxes, dtype=torch.float32, device=device),
        torch.as_tensor(scores, dtype=torch.float32, device=device),
        torch.ones(n, dtype=torch.bool, device=device), nms_thresh,
        max_out=max_dets)
    idx, keep = idx.cpu().numpy(), keep.cpu().numpy()
    out_boxes[keep] = boxes[idx[keep]]
    out_scores[keep] = scores[idx[keep]]
    out_labels[keep] = labels[idx[keep]]
    return {"boxes": out_boxes, "scores": out_scores, "labels": out_labels,
            "valid": keep}
