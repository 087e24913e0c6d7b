"""The VinVL detector in force-boxes extraction mode (port of the extraction
path of ``cpt_tpu/models/detector/attr_rcnn.py``).

All C colored copies of a query go through the backbone together; each
given box is pooled from every copy with kernel K2 and run through the
stage-5 head and the predictor, in chunks of ``roi_heads.head_chunk`` RoI
slots (the pooled [C, M, 14, 14, C4] tensor is the peak-memory hog).

The RPN head's parameters load with the checkpoint but are not run here:
force-boxes mode takes the given boxes as proposals. The attribute head is
not part of this port yet.
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import torch
from torch import nn

from cpt_tpu.models.detector.config import DetectorConfig
from cpt_tpu_torch.models.detector.heads import (BoxFeatureExtractor,
                                                 FastRCNNPredictor,
                                                 postprocess_force_boxes)
from cpt_tpu_torch.models.detector.resnet import ResNetC4
from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align


class RPNHead(nn.Module):
    """RPN parameters (3×3 conv + objectness / box 1×1 convs, OIHW), held so
    a full checkpoint loads; the RPN detect path is not ported yet."""

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


class AttrRCNN(nn.Module):
    def __init__(self, config: DetectorConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        c4 = config.backbone.out_channels
        self.backbone = ResNetC4(config.backbone, dtype)
        self.rpn = RPNHead(c4, config.rpn.num_anchors, dtype)
        self.box_extractor = BoxFeatureExtractor(config, dtype)
        self.box_predictor = FastRCNNPredictor(config, dtype)

    def forward_batch_force(self, images: torch.Tensor, image_hw,
                            force_boxes: torch.Tensor,
                            force_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [C, H, W, 3] (BGR255, mean-subtracted) · shared
        force_boxes [M, 4] / force_valid [M] → dict of [C, M, ...] outputs."""
        feats = self.backbone(images)                       # [C, h, w, C4]
        return self.heads_from_feats(feats, force_boxes, force_valid)

    def heads_from_feats(self, feats: torch.Tensor, force_boxes: torch.Tensor,
                         force_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        rh = self.config.roi_heads
        n_copies = feats.shape[0]
        m = force_boxes.shape[0]

        def run_chunk(boxes_chunk):
            ck = boxes_chunk.shape[0]
            pooled = batched_roi_align(feats, boxes_chunk, rh.pooler_scale,
                                       rh.pooler_resolution,
                                       rh.pooler_sampling_ratio, 8)
            flat = pooled.reshape((n_copies * ck,) + pooled.shape[2:])
            x = self.box_extractor.run_head(flat)           # stage 5
            cls_logits, _deltas, pooled_vec = self.box_predictor(x)
            return (cls_logits.reshape(n_copies, ck, -1),
                    pooled_vec.reshape(n_copies, ck, -1))

        ck = rh.head_chunk
        if ck and m > ck and m % ck == 0:
            parts = [run_chunk(force_boxes[i:i + ck]) for i in range(0, m, ck)]
            cls_logits, pooled = (torch.cat(t, dim=1) for t in zip(*parts))
        else:
            cls_logits, pooled = run_chunk(force_boxes)
        return postprocess_force_boxes(
            cls_logits, pooled, force_boxes.expand(n_copies, m, 4),
            force_valid.expand(n_copies, m))


def geometry_features(boxes: torch.Tensor,
                      image_hw: Union[torch.Tensor, Sequence[int]]) -> torch.Tensor:
    """The 6 normalized box-geometry dims appended to the pooled feature
    (reference ``engine/inference_ref.py:263-274``): (x1/W, y1/H, x2/W,
    y2/H, (x2-x1)/W, (y2-y1)/H) — exclusive extents."""
    h = float(image_hw[0])
    w = float(image_hw[1])
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    return torch.stack([x1 / w, y1 / h, x2 / w, y2 / h,
                        (x2 - x1) / w, (y2 - y1) / h], dim=-1)


def region_features_2054(pooled_2048: torch.Tensor, boxes: torch.Tensor,
                         image_hw) -> torch.Tensor:
    """Pooled features ⊕ geometry → the 2054-d TSV features ([..., M, ·])."""
    geo = geometry_features(boxes, image_hw).to(pooled_2048.dtype)
    return torch.cat([pooled_2048, geo], dim=-1)
