"""RoI box head, post-processing and attribute head (port of
``cpt_tpu/models/detector/heads.py``).

  * ``BoxFeatureExtractor``: RoIAlign (kernel K2) → the stage-5 head;
  * ``FastRCNNPredictor``: global average pooling → class / box linears;
  * ``AttributePredictor``: pooled feature ⊕ class embedding → fc + ReLU →
    attribute scores;
  * post-processing: force-boxes attach, and the three RPN-mode filters
    (``NMS_FILTER`` 0 per-class, 1 "peter", 2 fast), whose NMS runs
    through kernel K5 (each per-class filter is one batched launch).

All outputs are fixed-shape with validity masks, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.models.detector.config import DetectorConfig
from cpt_tpu_torch.models.detector.resnet import ResNetC5Head
from cpt_tpu_torch.ops.nms_pallas import nms_pallas
from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align
from cpt_tpu_torch.structures.boxes import decode_boxes


class BoxFeatureExtractor(nn.Module):
    """RoIAlign(14², 1/16) → stage-5 head: [N, 7, 7, 2048]."""

    def __init__(self, config: DetectorConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.roi_heads = config.roi_heads
        self.head = ResNetC5Head(config.backbone, dtype)

    def forward(self, feature_map: torch.Tensor, rois: torch.Tensor
                ) -> torch.Tensor:
        """feature_map [h, w, C4] · rois [N, 4] → [N, 7, 7, C5]; the pooling
        is K2 over a batch of one map."""
        rh = self.roi_heads
        pooled = batched_roi_align(feature_map[None], rois, rh.pooler_scale,
                                   rh.pooler_resolution,
                                   rh.pooler_sampling_ratio, 8)[0]
        return self.head(pooled)

    def run_head(self, pooled: torch.Tensor) -> torch.Tensor:
        """Stage 5 only (batched extraction pools separately)."""
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
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


def _c5(config: DetectorConfig) -> int:
    return config.backbone.res2_out_channels * 2 ** len(config.backbone.stage_blocks)


class FastRCNNPredictor(nn.Module):
    def __init__(self, config: DetectorConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        rh = config.roi_heads
        self.cls_score = Linear(_c5(config), rh.num_classes, dtype)
        n_reg = 2 if rh.cls_agnostic_bbox_reg else rh.num_classes
        self.bbox_pred = Linear(_c5(config), n_reg * 4, dtype)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [N, 7, 7, C] → (cls_logits [N, classes], bbox_deltas, pooled [N, C])."""
        pooled = x.mean(dim=(1, 2))
        return self.cls_score(pooled), self.bbox_pred(pooled), pooled


class AttributePredictor(nn.Module):
    """avgpool(RoI feature) ⊕ Embed(label) → fc + ReLU → attribute scores."""

    def __init__(self, config: DetectorConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        a = config.attributes
        self.cls_embedding = nn.Embedding(config.roi_heads.num_classes,
                                          a.cls_emd_dim, dtype=dtype)
        self.cls_embedding.weight.requires_grad_(False)
        self.fc_attr = Linear(_c5(config) + a.cls_emd_dim, a.attr_emd_dim, dtype)
        self.attr_score = Linear(a.attr_emd_dim, a.num_attributes, dtype)

    def forward(self, x: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, 7, 7, C] (or pooled [N, C]) · labels [N] →
        (attribute logits [N, num_attributes], hidden [N, attr_emd_dim])."""
        pooled = x.mean(dim=(1, 2)) if x.dim() == 4 else x
        emb = self.cls_embedding(labels.long())
        h = torch.relu(self.fc_attr(torch.cat([pooled.to(emb.dtype), emb], -1)))
        return self.attr_score(h), h


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


def _clip(decoded: torch.Tensor, image_hw: Sequence[int]) -> torch.Tensor:
    h, w = float(image_hw[0]), float(image_hw[1])
    return torch.stack([decoded[..., 0].clamp(0, w - 1),
                        decoded[..., 1].clamp(0, h - 1),
                        decoded[..., 2].clamp(0, w - 1),
                        decoded[..., 3].clamp(0, h - 1)], dim=-1)


def _decode_clip_per_class(cfg: DetectorConfig, class_logits, box_deltas,
                           proposals, image_hw):
    """→ (softmax [N, C], per-class boxes [N, C, 4] clipped to the image);
    with ``ignore_box_regression`` the raw proposals stand for every class."""
    rh = cfg.roi_heads
    prob = torch.softmax(class_logits.float(), dim=-1)
    n, c = prob.shape
    if rh.ignore_box_regression:
        decoded = proposals.float()[:, None, :].expand(n, c, 4)
    else:
        decoded = decode_boxes(box_deltas.float(), proposals.float(),
                               rh.bbox_reg_weights).reshape(n, c, 4)
    return prob, _clip(decoded, image_hw)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last dim: the lower index first among
    equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def postprocess_per_class(cfg: DetectorConfig, class_logits, box_deltas,
                          pooled_features, proposals, proposal_valid,
                          image_hw, score_thresh: float = None,
                          per_class_cap: int = 32) -> Dict[str, torch.Tensor]:
    """``filter_results`` (NMS_FILTER=0, reference ``inference.py:188-244``):
    per-class score threshold + per-class NMS (one batched K5 launch over
    the foreground classes, each keeping ≤ ``per_class_cap`` survivors),
    then the global top ``detections_per_img`` by score."""
    rh = cfg.roi_heads
    thresh = rh.score_thresh if score_thresh is None else score_thresh
    prob, decoded = _decode_clip_per_class(cfg, class_logits, box_deltas,
                                           proposals, image_hw)
    n, c = prob.shape
    scores = prob[:, 1:].T.contiguous()                      # [C-1, N]
    keep = (scores > thresh) & proposal_valid[None]
    idxs, kepts = nms_pallas(decoded[:, 1:].transpose(0, 1), scores, keep,
                             rh.nms_thresh, per_class_cap)   # [C-1, cap]
    idxs = idxs.long()
    flat_idx = idxs.reshape(-1)
    flat_keep = kepts.reshape(-1)
    flat_scores = torch.where(flat_keep,
                              torch.gather(scores, 1, idxs).reshape(-1), -1.0)
    class_ids = torch.arange(1, c, device=prob.device)
    flat_labels = class_ids.repeat_interleave(per_class_cap)
    top_scores, top_slots = _top_k(flat_scores, rh.detections_per_img)
    src = flat_idx[top_slots]
    labels = flat_labels[top_slots]
    valid = top_scores > -0.5
    return {
        "boxes": decoded[src, labels],
        "scores": torch.where(valid, top_scores, 0.0),
        "labels": torch.where(valid, labels, 0),
        "box_features": pooled_features[src],
        "scores_all": prob[src],
        "valid": valid,
    }


def postprocess_per_class_with_retry(cfg: DetectorConfig, class_logits,
                                     box_deltas, pooled_features, proposals,
                                     proposal_valid, image_hw,
                                     max_retries: int = 10):
    """The reference's threshold loop (``inference.py:130-143``): halve
    ``score_thresh`` until at least ``min_detections_per_img`` survive
    (one host read of the count per try)."""
    thresh = cfg.roi_heads.score_thresh
    out = postprocess_per_class(cfg, class_logits, box_deltas, pooled_features,
                                proposals, proposal_valid, image_hw, thresh)
    for _ in range(max_retries):
        if int(out["valid"].sum()) >= cfg.roi_heads.min_detections_per_img:
            break
        thresh /= 2.0
        out = postprocess_per_class(cfg, class_logits, box_deltas,
                                    pooled_features, proposals,
                                    proposal_valid, image_hw, thresh)
    return out


def postprocess_peter(cfg: DetectorConfig, class_logits, box_deltas,
                      pooled_features, proposals, proposal_valid,
                      image_hw) -> Dict[str, torch.Tensor]:
    """``filter_results_peter`` (NMS_FILTER=1, reference
    ``inference.py:246-308``): per-class NMS at 0.3 (one batched K5 launch)
    builds a survivor mask, each box takes its best surviving class,
    zero-score boxes drop, sort descending, clamp the count to
    [min_detections, detections_per_img]."""
    rh = cfg.roi_heads
    prob, decoded = _decode_clip_per_class(cfg, class_logits, box_deltas,
                                           proposals, image_hw)
    n, c = prob.shape
    idx, kept = nms_pallas(decoded[:, 1:].transpose(0, 1),
                           prob[:, 1:].T.contiguous(),
                           proposal_valid[None].expand(c - 1, n), 0.3, n)
    # scatter-max: a padded slot (idx 0, kept False) must not clear a
    # genuine survivor at index 0
    masks = torch.zeros((c - 1, n), dtype=torch.int32, device=prob.device)
    masks.scatter_reduce_(1, idx.long(), kept.to(torch.int32), reduce="amax")
    dists = torch.cat([torch.zeros((n, 1), device=prob.device),
                       masks.T.bool() * prob[:, 1:]], dim=1)
    scores = dists.max(dim=1).values
    labels = torch.argmax(dists, dim=1)
    nonzero = scores > 0
    order = torch.argsort(-torch.where(nonzero, scores, -1.0), stable=True)
    sorted_scores = scores[order]
    sorted_valid = nonzero[order]
    num_above = (sorted_valid & (sorted_scores >= rh.score_thresh)).sum()
    n_keep = torch.clamp(num_above, rh.min_detections_per_img,
                         rh.detections_per_img)
    n_keep = torch.minimum(n_keep, sorted_valid.sum())
    k = rh.detections_per_img
    valid = torch.arange(k, device=prob.device) < n_keep
    top = order[:k]
    return {
        "boxes": decoded[top, labels[top]],
        "scores": torch.where(valid, scores[top], 0.0),
        "labels": torch.where(valid, labels[top], 0),
        "box_features": pooled_features[top],
        "scores_all": prob[top],
        "valid": valid,
    }


def postprocess_fast(cfg: DetectorConfig, class_logits, box_deltas,
                     pooled_features, proposals, proposal_valid,
                     image_hw) -> Dict[str, torch.Tensor]:
    """``filter_results_fast`` with static shapes (NMS_FILTER=2, the
    default; reference ``inference.py:310-353``):

    1. per-class boxes decoded and clipped, then averaged over classes;
    2. per-box max foreground class → (score, label);
    3. prefilter: w ≥ 0, h ≥ 0, score > score_thresh·0.01;
    4. one NMS (0.5) through K5, picks in descending score order;
    5. n_dets = clamp(#{score ≥ score_thresh}, min_det, max_det): emit
       ``detections_per_img`` slots with a validity mask of length n_dets.

    (The JAX package's docstring explains why the mean-decoded boxes stand
    where the reference's dead live-regression branch misindexes.)"""
    rh = cfg.roi_heads
    prob, decoded = _decode_clip_per_class(cfg, class_logits, box_deltas,
                                           proposals, image_hw)
    bbox = decoded.mean(dim=1)                               # [N, 4]
    scores, labels = prob[:, 1:].max(dim=-1)
    labels = labels + 1
    keep = ((bbox[:, 2] - bbox[:, 0] >= 0) & (bbox[:, 3] - bbox[:, 1] >= 0)
            & (scores > rh.score_thresh * 0.01) & proposal_valid)
    max_det = rh.detections_per_img
    idx, kept = nms_pallas(bbox, scores, keep, rh.nms_thresh, max_det)
    idx = idx.long()
    out_scores = torch.where(kept, scores[idx], 0.0)
    num_above = ((out_scores >= rh.score_thresh) & kept).sum()
    n_dets = torch.clamp(num_above, rh.min_detections_per_img, max_det)
    n_dets = torch.minimum(n_dets, kept.sum())
    valid = torch.arange(max_det, device=prob.device) < n_dets
    return {
        "boxes": bbox[idx],
        "scores": out_scores,
        "labels": torch.where(valid, labels[idx], 0),
        "box_features": pooled_features[idx],
        "scores_all": prob[idx],
        "valid": valid & kept,
    }
