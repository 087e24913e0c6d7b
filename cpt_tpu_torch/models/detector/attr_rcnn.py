"""The VinVL detector (port of ``cpt_tpu/models/detector/attr_rcnn.py``):
backbone → RPN → box head → post-processing → attribute head.

Two modes, as in the JAX package:

* :meth:`AttrRCNN.forward` — RPN mode on one padded canvas: proposals from
  the RPN (NMS on kernel K5), the box head over them (pooling on K2,
  stage 5 on K1), then the post-processor that ``roi_heads.nms_filter``
  names (NMS on K5), and optionally the attribute head on the final boxes;
* :meth:`AttrRCNN.forward_batch_force` — force-boxes extraction: all C
  colored copies of a query go through the backbone together; each given
  box is pooled from every copy with K2 and run through the stage-5 head
  and the predictor, in chunks of ``roi_heads.head_chunk`` RoI slots (the
  pooled [C, M, 14, 14, C4] tensor is the peak-memory hog).
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import torch
from torch import nn

from cpt_tpu_torch.models.detector.config import DetectorConfig
from cpt_tpu_torch.models.detector.heads import (AttributePredictor,
                                                 BoxFeatureExtractor,
                                                 FastRCNNPredictor,
                                                 postprocess_fast,
                                                 postprocess_force_boxes,
                                                 postprocess_peter,
                                                 postprocess_per_class)
from cpt_tpu_torch.models.detector.resnet import ResNetC4
from cpt_tpu_torch.models.detector.rpn import RPNHead, select_proposals
from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align


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
        self.attr_extractor = BoxFeatureExtractor(config, dtype)
        self.attr_predictor = AttributePredictor(config, dtype)

    def forward(self, image: torch.Tensor, image_hw: Sequence[int],
                anchors: torch.Tensor, with_attributes: bool = True
                ) -> Dict[str, torch.Tensor]:
        """RPN-mode inference on one image.

        image [H, W, 3] preprocessed pixels (the padded canvas) · image_hw
        the true (h, w) · anchors [h*w*A, 4] (``rpn.grid_anchors`` of the
        C4 grid) → dict of ``detections_per_img`` slots with ``valid``."""
        c = self.config
        feat = self.backbone(image[None])[0]                # [h, w, C4]
        logits, deltas = self.rpn(feat[None])
        proposals, _scores, prop_valid = select_proposals(
            c.rpn, logits[0], deltas[0], anchors, image_hw)
        x = self.box_extractor(feat, proposals)
        cls_logits, box_deltas, pooled = self.box_predictor(x)
        post = {0: postprocess_per_class, 1: postprocess_peter}.get(
            c.roi_heads.nms_filter, postprocess_fast)
        out = post(c, cls_logits, box_deltas, pooled, proposals, prop_valid,
                   image_hw)
        if with_attributes:
            ax = self.attr_extractor(feat, out["boxes"])
            attr_logits, _ = self.attr_predictor(ax, out["labels"])
            out["attr_logits"] = attr_logits.float()
        return out

    def forward_batch_force(self, images: torch.Tensor, image_hw,
                            force_boxes: torch.Tensor,
                            force_valid: torch.Tensor,
                            with_attributes: bool = False
                            ) -> Dict[str, torch.Tensor]:
        """images [C, H, W, 3] (BGR255, mean-subtracted) · shared
        force_boxes [M, 4] / force_valid [M] → dict of [C, M, ...] outputs."""
        feats = self.backbone(images)                       # [C, h, w, C4]
        return self.heads_from_feats(feats, force_boxes, force_valid,
                                     with_attributes)

    def heads_from_feats(self, feats: torch.Tensor, force_boxes: torch.Tensor,
                         force_valid: torch.Tensor,
                         with_attributes: bool = False
                         ) -> Dict[str, torch.Tensor]:
        rh = self.config.roi_heads
        n_copies = feats.shape[0]
        m = force_boxes.shape[0]

        def pool(boxes_chunk):
            pooled = batched_roi_align(feats, boxes_chunk, rh.pooler_scale,
                                       rh.pooler_resolution,
                                       rh.pooler_sampling_ratio, 8)
            return pooled.reshape((-1,) + pooled.shape[2:])

        def run_chunk(boxes_chunk):
            ck = boxes_chunk.shape[0]
            x = self.box_extractor.run_head(pool(boxes_chunk))   # stage 5
            cls_logits, _deltas, pooled_vec = self.box_predictor(x)
            res = (cls_logits.reshape(n_copies, ck, -1),
                   pooled_vec.reshape(n_copies, ck, -1))
            if with_attributes:
                labels = torch.softmax(cls_logits.float(), -1)[:, 1:].argmax(-1) + 1
                ax = self.attr_extractor.run_head(pool(boxes_chunk))
                attr_logits, _ = self.attr_predictor(ax, labels)
                res += (attr_logits.float().reshape(n_copies, ck, -1),)
            return res

        ck = rh.head_chunk
        if ck and m > ck and m % ck == 0:
            parts = [run_chunk(force_boxes[i:i + ck]) for i in range(0, m, ck)]
            merged = tuple(torch.cat(t, dim=1) for t in zip(*parts))
        else:
            merged = run_chunk(force_boxes)
        out = postprocess_force_boxes(
            merged[0], merged[1], force_boxes.expand(n_copies, m, 4),
            force_valid.expand(n_copies, m))
        if with_attributes:
            out["attr_logits"] = merged[2]
        return out


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
