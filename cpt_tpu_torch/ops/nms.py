"""Fixed-shape greedy NMS, plain PyTorch (port of ``cpt_tpu/ops/nms.py``).

At most ``max_out`` steps of {argmax over the live scores → record the
index → suppress its IoU neighbourhood}, each one IoU row computed on the
fly, with static output shapes and no host synchronisation per step. This
is the plain version of kernel K5 (``ops/nms_pallas.py``), which call sites
go through; on the CPU that wrapper runs this.

Semantics, exactly the JAX package's:
  * ``NEG_INF = -1e10``; a pick is live while its score is > ``NEG_INF/2``;
  * ``iou > thr`` is strict (torchvision); the IoU denominator is clamped at
    ``1e-10``; ``iou_offset=1.0`` switches to the legacy +1 widths;
  * ties go to the lowest index (``torch.argmax`` returns the first maximum);
  * picks come out in descending score order; unused slots hold index 0 and
    ``keep=False``.

An optional leading batch dim runs independent problems side by side:
``[B, K, 4]`` / ``[B, K]`` → ``[B, max_out]``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

NEG_INF = -1e10


def _iou_row(box: torch.Tensor, boxes: torch.Tensor,
             offset: float) -> torch.Tensor:
    """IoU of one box ``[B, 4]`` against boxes ``[B, K, 4]`` → ``[B, K]``,
    in the JAX package's order of operations."""
    area = (torch.clamp(box[:, 2] - box[:, 0] + offset, min=0)
            * torch.clamp(box[:, 3] - box[:, 1] + offset, min=0))
    areas = (torch.clamp(boxes[..., 2] - boxes[..., 0] + offset, min=0)
             * torch.clamp(boxes[..., 3] - boxes[..., 1] + offset, min=0))
    lt = torch.maximum(box[:, None, :2], boxes[..., :2])
    rb = torch.minimum(box[:, None, 2:], boxes[..., 2:])
    wh = torch.clamp(rb - lt + offset, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area[:, None] + areas - inter, min=1e-10)


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, max_out: int, iou_offset: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with static shapes.

    boxes [(B,) K, 4] xyxy · scores [(B,) K] · valid [(B,) K] bool →
    (indices [(B,) max_out] int32, keep [(B,) max_out] bool)."""
    batched = boxes.dim() == 3
    if not batched:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    boxes = boxes.float()
    live = torch.where(valid, scores.float(),
                       torch.full_like(scores, NEG_INF, dtype=torch.float32))
    b = boxes.shape[0]
    rows = torch.arange(b, device=boxes.device)
    out_idx = torch.zeros((b, max_out), dtype=torch.int32, device=boxes.device)
    out_keep = torch.zeros((b, max_out), dtype=torch.bool, device=boxes.device)
    for i in range(max_out):
        # once a row has nothing live it never has again, so its picks fill
        # a prefix of the slots and slot i is the JAX loop's ``count``
        pick = torch.argmax(live, dim=1)
        ok = live[rows, pick] > NEG_INF / 2
        iou = _iou_row(boxes[rows, pick], boxes, iou_offset)
        live = torch.where(ok[:, None] & (iou > iou_threshold), NEG_INF, live)
        live[rows, pick] = NEG_INF
        out_idx[:, i] = torch.where(ok, pick, 0).to(torch.int32)
        out_keep[:, i] = ok
    if not batched:
        return out_idx[0], out_keep[0]
    return out_idx, out_keep


def nms_indices_list(boxes, scores, iou_threshold: float, max_out: int,
                     iou_offset: float = 0.0) -> List[int]:
    """Host convenience: the kept indices as a Python list."""
    b = torch.as_tensor(boxes, dtype=torch.float32)
    s = torch.as_tensor(scores, dtype=torch.float32)
    idx, keep = nms_padded(b, s, torch.ones(s.shape, dtype=torch.bool),
                           iou_threshold, max_out, iou_offset)
    return idx[keep].tolist()
