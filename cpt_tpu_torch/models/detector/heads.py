"""RoI box head and force-boxes post-processing (port of the force-boxes
parts of ``cpt_tpu/models/detector/heads.py``).

``BoxFeatureExtractor`` is the stage-5 head over pooled RoIs (the pooling
itself runs batched in ``attr_rcnn.py`` through kernel K2);
``FastRCNNPredictor`` is global average pooling → class / box linears.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from cpt_tpu.models.detector.config import DetectorConfig
from cpt_tpu_torch.models.detector.resnet import ResNetC5Head


class BoxFeatureExtractor(nn.Module):
    """Stage-5 head: pooled [N, 14, 14, C4] → [N, 7, 7, 2048]."""

    def __init__(self, config: DetectorConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head = ResNetC5Head(config.backbone, dtype)

    def run_head(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.head(pooled)


class Linear(nn.Module):
    """``y = x·Wᵀ + b`` with a PyTorch-layout [out, in] weight, in the
    weight dtype."""

    def __init__(self, fin: int, fout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin, dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(fout, dtype=dtype),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.linear(x.to(self.weight.dtype), self.weight,
                                          self.bias)


class FastRCNNPredictor(nn.Module):
    def __init__(self, config: DetectorConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        rh = config.roi_heads
        c5 = config.backbone.res2_out_channels * 2 ** len(config.backbone.stage_blocks)
        self.cls_score = Linear(c5, rh.num_classes, dtype)
        n_reg = 2 if rh.cls_agnostic_bbox_reg else rh.num_classes
        self.bbox_pred = Linear(c5, n_reg * 4, dtype)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [N, 7, 7, C] → (cls_logits [N, classes], bbox_deltas, pooled [N, C])."""
        pooled = x.mean(dim=(1, 2))
        return self.cls_score(pooled), self.bbox_pred(pooled), pooled


def postprocess_force_boxes(class_logits: torch.Tensor,
                            pooled_features: torch.Tensor, boxes: torch.Tensor,
                            valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Extraction-mode post-processing (reference ``inference.py:106-119``):
    keep the given boxes, attach the max foreground label/score, the pooled
    features and the full softmax."""
    prob = torch.softmax(class_logits.float(), dim=-1)
    scores, labels = prob[..., 1:].max(dim=-1)
    return {
        "boxes": boxes,
        "scores": torch.where(valid, scores, torch.zeros_like(scores)),
        "labels": torch.where(valid, labels + 1, torch.zeros_like(labels)),
        "box_features": pooled_features,
        "scores_all": prob,
        "valid": valid,
    }
