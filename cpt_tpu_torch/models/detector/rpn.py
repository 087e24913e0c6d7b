"""Region Proposal Network: anchors, head and static-shape proposal
selection (port of ``cpt_tpu/models/detector/rpn.py``).

  * classic Detectron cell anchors (rounded ratio enumeration around the
    ``(stride-1)``-square window), precomputed on the host per canvas size;
  * single-conv head: 3×3 conv + ReLU → 1×1 objectness / 1×1 box deltas,
    NHWC out; the dense convs stay ``F.conv2d``, as the JAX package leaves
    them to XLA;
  * selection: top ``pre_nms_top_n`` by objectness, decode with weights
    (1, 1, 1, 1), clip to the true image size, drop small boxes, NMS 0.7
    through kernel K5, keep ``post_nms_top_n`` slots with a validity mask.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.models.detector.config import RPNConfig
from cpt_tpu_torch.ops.nms_pallas import nms_pallas
from cpt_tpu_torch.structures.boxes import decode_boxes


def cell_anchors(stride: int, sizes, aspect_ratios) -> np.ndarray:
    """Detectron base anchors [A, 4] (x1, y1, x2, y2), rounded enumeration."""
    scales = np.asarray(sizes, np.float64) / stride
    base = np.array([0, 0, stride - 1, stride - 1], np.float64)

    def whctrs(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mkanchors(ws, hs, xc, yc):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                          xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)])

    w, h, xc, yc = whctrs(base)
    ratios = np.asarray(aspect_ratios, np.float64)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    out = []
    for a in mkanchors(ws, hs, xc, yc):
        w, h, xc, yc = whctrs(a)
        out.append(mkanchors(w * scales, h * scales, xc, yc))
    return np.vstack(out).astype(np.float32)


def grid_anchors(cfg: RPNConfig, feat_h: int, feat_w: int) -> np.ndarray:
    """All anchors of a feature grid, [feat_h * feat_w * A, 4] (host),
    in the [H, W, A] order of the NHWC head outputs."""
    base = cell_anchors(cfg.anchor_stride, cfg.anchor_sizes, cfg.aspect_ratios)
    shift_x = np.arange(feat_w, dtype=np.float32) * cfg.anchor_stride
    shift_y = np.arange(feat_h, dtype=np.float32) * cfg.anchor_stride
    sx, sy = np.meshgrid(shift_x, shift_y)                 # [H, W]
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


class RPNHead(nn.Module):
    """SingleConvRPNHead: shared 3×3 conv, 1×1 objectness + 1×1 deltas
    (OIHW weights in the model dtype)."""

    def __init__(self, channels: int, num_anchors: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=dtype),
                                requires_grad=False)

        self.conv_weight = p(channels, channels, 3, 3)
        self.conv_bias = p(channels)
        self.cls_logits_weight = p(num_anchors, channels, 1, 1)
        self.cls_logits_bias = p(num_anchors)
        self.bbox_pred_weight = p(num_anchors * 4, channels, 1, 1)
        self.bbox_pred_bias = p(num_anchors * 4)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feat [B, h, w, C] → (logits [B, h, w, A], deltas [B, h, w, 4A])."""
        t = F.conv2d(feat.permute(0, 3, 1, 2).to(self.conv_weight.dtype),
                     self.conv_weight, self.conv_bias, padding=1)
        t = torch.relu(t)
        logits = F.conv2d(t, self.cls_logits_weight, self.cls_logits_bias)
        deltas = F.conv2d(t, self.bbox_pred_weight, self.bbox_pred_bias)
        return logits.permute(0, 2, 3, 1), deltas.permute(0, 2, 3, 1)


def select_proposals(cfg: RPNConfig, objectness: torch.Tensor,
                     deltas: torch.Tensor, anchors: torch.Tensor,
                     image_hw: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One image's test-time proposal selection with static shapes.

    objectness [h, w, A] · deltas [h, w, 4A] · anchors [h*w*A, 4] ·
    image_hw (true h, w) → (boxes [post_n, 4], scores [post_n],
    valid [post_n])."""
    scores_flat = torch.sigmoid(objectness.float()).reshape(-1)
    deltas_flat = deltas.float().reshape(-1, 4)
    k = min(cfg.pre_nms_top_n_test, scores_flat.shape[0])
    # jax.lax.top_k puts the lower index first among equal scores (common:
    # sigmoid saturates at 1.0); torch.topk promises no order, a stable
    # descending sort does
    top_scores, top_idx = torch.sort(scores_flat, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    boxes = decode_boxes(deltas_flat[top_idx], anchors[top_idx],
                         (1.0, 1.0, 1.0, 1.0))
    h, w = float(image_hw[0]), float(image_hw[1])
    x1 = torch.clamp(boxes[:, 0], 0, w - 1)
    y1 = torch.clamp(boxes[:, 1], 0, h - 1)
    x2 = torch.clamp(boxes[:, 2], 0, w - 1)
    y2 = torch.clamp(boxes[:, 3], 0, h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    valid = ((x2 - x1 + 1 >= cfg.min_size) & (y2 - y1 + 1 >= cfg.min_size))
    idx, keep = nms_pallas(boxes, top_scores, valid, cfg.nms_thresh,
                           cfg.post_nms_top_n_test)
    return boxes[idx], top_scores[idx], keep
