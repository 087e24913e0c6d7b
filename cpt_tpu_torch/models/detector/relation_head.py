"""Scene-graph relation head, RelDN (port of
``cpt_tpu/models/detector/relation_head.py``; reference
``scene_graph_benchmark/relation_head`` with the ``sg_reldn`` algorithm,
``reldn/reldn.py``, the configuration VinVL's relation pretraining used):

  * the union-box visual feature: RoIAlign of the subject ∪ object box on
    kernel K2 (a batch of one map, as the box head pools), then the head's
    own stage-5 extractor (``pred_feature_extractor``, a ``ResNetC5Head``
    whose grouped 3×3 convs run on kernel K1), average-pooled;
  * the relation embedding MLP over [subj_feat ‖ union_feat ‖ obj_feat]
    (3d → 3d/2 → d, LeakyReLU 0.1);
  * three visual predictors (subject / object / predicate linears), summed;
  * 28-d spatial pair features → MLP(28 → 64 → 64, LeakyReLU 0.1) → linear
    (``reldn/spatial.py``);
  * the frequency bias ``log(freq_prior[subj_label, obj_label] + 1e-3)``
    (``sparse_targets.FrequencyBias``);
  * logits = visual + spatial + semantic, zero on invalid pairs.

Pairing is the static all-pairs enumeration over the detection slots, masked
by validity; the loss is the predicate cross entropy with ignore −1, and the
RelDN graphical contrastive losses are here too (no tool calls them, as in
the JAX package). Module and parameter names are flax's, so a JAX tree maps
leaf for leaf (``models/detector/convert.params_from_jax``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.models.bert.heads import cross_entropy_ignore_index
from cpt_tpu_torch.models.bert.model import Dense
from cpt_tpu_torch.models.detector.config import DetectorConfig
from cpt_tpu_torch.models.detector.heads import c5_channels
from cpt_tpu_torch.models.detector.resnet import ResNetC5Head
from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align
from cpt_tpu_torch.structures.boxes import box_iou, encode_boxes

HW = Union[torch.Tensor, Sequence[int]]


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def boxes_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.minimum(a[..., 0], b[..., 0]),
                        torch.minimum(a[..., 1], b[..., 1]),
                        torch.maximum(a[..., 2], b[..., 2]),
                        torch.maximum(a[..., 3], b[..., 3])], dim=-1)


def _pair_delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bbox_transform_inv with unit weights (``reldn/spatial.py:16-48``):
    the +1 widths of ``structures/boxes.encode_boxes``."""
    return encode_boxes(b, a, (1.0, 1.0, 1.0, 1.0))


def spatial_pair_features(subj: torch.Tensor, obj: torch.Tensor,
                          image_hw: HW) -> torch.Tensor:
    """[P, 28] spatial features (``spatial.py:_get_spt_features``)."""
    h = float(image_hw[0])
    w = float(image_hw[1])
    subj, obj = subj.float(), obj.float()
    union = boxes_union(subj, obj)

    def box_feat(bx):
        area = (bx[:, 2] - bx[:, 0] + 1) * (bx[:, 3] - bx[:, 1] + 1) / (w * h)
        return torch.stack([bx[:, 0] / w, bx[:, 1] / h, bx[:, 2] / w,
                            bx[:, 3] / h, area], dim=1)

    d12 = _pair_delta(subj, obj)
    d21 = _pair_delta(obj, subj)[:, :2]
    d1u = torch.cat([_pair_delta(subj, union), _pair_delta(union, subj)[:, :2]], 1)
    du2 = torch.cat([_pair_delta(union, obj), _pair_delta(obj, union)[:, :2]], 1)
    return torch.cat([d12, d21, d1u, du2, box_feat(subj), box_feat(obj)], dim=1)


def all_pairs(num_slots: int, device=None) -> torch.Tensor:
    """Static (i, j) index pairs, i ≠ j, row-major → [n·(n−1), 2] int64."""
    i, j = torch.meshgrid(torch.arange(num_slots, device=device),
                          torch.arange(num_slots, device=device), indexing="ij")
    keep = i != j
    return torch.stack([i[keep], j[keep]], dim=-1)


def union_features(extractor: ResNetC5Head, config: DetectorConfig,
                   feature_map: torch.Tensor, subj_boxes: torch.Tensor,
                   obj_boxes: torch.Tensor) -> torch.Tensor:
    """The union box of each pair pooled from ``feature_map`` [h, w, C4]
    (K2, one map), through ``extractor`` (stage 5: K1), averaged → [P, C5]."""
    rh = config.roi_heads
    union = boxes_union(subj_boxes, obj_boxes).float()
    pooled = batched_roi_align(feature_map[None], union, rh.pooler_scale,
                               rh.pooler_resolution, rh.pooler_sampling_ratio,
                               8)[0]
    return extractor(pooled).mean(dim=(1, 2))


class RelDNHead(nn.Module):
    def __init__(self, config: DetectorConfig, num_rel_classes: int = 51,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        d = c5_channels(config)
        r = num_rel_classes
        self.pred_feature_extractor = ResNetC5Head(config.backbone, dtype)
        self.rel_embedding_0 = Dense(3 * d, 3 * d // 2, dtype)
        self.rel_embedding_1 = Dense(3 * d // 2, d, dtype)
        self.rel_pred_predictor = Dense(d, r, dtype)
        self.rel_subj_predictor = Dense(d, r, dtype)
        self.rel_obj_predictor = Dense(d, r, dtype)
        self.spatial_0 = Dense(28, 64, dtype)
        self.spatial_1 = Dense(64, 64, dtype)
        self.rel_spt_predictor = Dense(64, r, dtype)

    def forward(self, feature_map: torch.Tensor, det_boxes: torch.Tensor,
                det_labels: torch.Tensor, box_features: torch.Tensor,
                pairs: torch.Tensor, pair_valid: torch.Tensor, image_hw: HW,
                freq_prior: Optional[torch.Tensor] = None) -> torch.Tensor:
        """→ relation logits [P, num_rel_classes] (f32).

        feature_map [h, w, C4] · det_boxes [N, 4] · det_labels [N] ·
        box_features [N, D] (the box head's pooled features) · pairs [P, 2] ·
        freq_prior [num_obj_classes, num_obj_classes, num_rel_classes]."""
        s, o = pairs[:, 0], pairs[:, 1]
        subj_boxes, obj_boxes = det_boxes[s], det_boxes[o]
        x_pred = union_features(self.pred_feature_extractor, self.config,
                                feature_map, subj_boxes, obj_boxes)
        subj_feat = box_features[s].to(self.dtype)
        obj_feat = box_features[o].to(self.dtype)

        x_rel = torch.cat([subj_feat, x_pred.to(self.dtype), obj_feat], dim=1)
        x_rel = leaky(self.rel_embedding_1(leaky(self.rel_embedding_0(x_rel))))
        vis = (self.rel_pred_predictor(x_rel) + self.rel_subj_predictor(subj_feat)
               + self.rel_obj_predictor(obj_feat))

        spt = spatial_pair_features(subj_boxes, obj_boxes, image_hw)
        spt = leaky(self.spatial_1(leaky(self.spatial_0(spt))))
        logits = vis.float() + self.rel_spt_predictor(spt).float()
        if freq_prior is not None:
            logits = logits + torch.log(freq_prior + 1e-3)[det_labels[s].long(),
                                                           det_labels[o].long()]
        return torch.where(pair_valid[:, None], logits, 0.0)


def relation_loss(rel_logits: torch.Tensor, rel_labels: torch.Tensor) -> torch.Tensor:
    """Predicate CE with ignore −1 (the sampled-pair loss core,
    ``relation_head/loss.py``)."""
    return cross_entropy_ignore_index(rel_logits, rel_labels)


def match_pair_labels(pairs: torch.Tensor, det_boxes: torch.Tensor,
                      gt_rels: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_valid: torch.Tensor, iou_thresh: float = 0.5
                      ) -> torch.Tensor:
    """Predicate labels of detection pairs: (i, j) takes gt relation (s, o,
    p)'s predicate when box i best matches gt s and box j gt o, each at IoU ≥
    ``iou_thresh``; 0 (background) otherwise. ``gt_valid`` masks the
    RELATION rows (length ≥ R). Ties take the first index, as ``jnp.argmax``
    does: for the best gt and for the first matching relation (``hit`` is
    cast to int first: ``torch.argmax`` takes no bool tensor)."""
    iou = box_iou(det_boxes.float(), gt_boxes.float())       # [N, G]
    best_gt = torch.argmax(iou, dim=1)
    matched = iou.max(dim=1).values >= iou_thresh
    s, o = pairs[:, 0], pairs[:, 1]
    rels = gt_rels.long()
    hit = ((best_gt[s][:, None] == rels[None, :, 0])
           & (best_gt[o][:, None] == rels[None, :, 1])
           & matched[s][:, None] & matched[o][:, None]
           & gt_valid[None, :rels.shape[0]])
    first = torch.argmax(hit.to(torch.int32), dim=1)
    return torch.where(hit.any(dim=1), rels[first, 2], 0)


def balanced_pair_sample(pair_labels: torch.Tensor, generator: torch.Generator,
                         batch_size: int, positive_fraction: float
                         ) -> torch.Tensor:
    """Fixed-proportion pair subsampling
    (``balanced_positive_negative_pair_sampler.py``): labels −1 ignore, 0
    negative, ≥ 1 positive → bool keep mask with ≤ bs·frac positives and
    positives + negatives ≤ bs; the picks uniform from ``generator``."""
    n = pair_labels.shape[0]
    pos = pair_labels >= 1
    neg = pair_labels == 0
    dev = pair_labels.device

    def pick(mask, limit):
        pri = torch.rand(n, generator=generator, device=dev) + (~mask) * 10.0
        order = torch.argsort(pri, stable=True)
        rank = torch.empty(n, dtype=torch.long, device=dev)
        rank[order] = torch.arange(n, device=dev)
        return mask & (rank < limit)

    num_pos = torch.clamp(pos.sum(), max=int(batch_size * positive_fraction))
    pos_mask = pick(pos, num_pos)
    num_neg = torch.minimum(neg.sum(), batch_size - num_pos)
    return pos_mask | pick(neg, num_neg)


def _segment(values: torch.Tensor, ids: torch.Tensor, n: int, fill: float,
             reduce: str) -> torch.Tensor:
    """``jax.ops.segment_min`` / ``segment_max``: an empty group keeps the
    identity, +inf / −inf (``include_self`` on a filled start; a start the
    reduction skips would leave an empty group at a finite initial value)."""
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, ids.long(), values, reduce, include_self=True)


def _grouped_margin_loss(affinity: torch.Tensor, group_ids: torch.Tensor,
                         pos: torch.Tensor, neg: torch.Tensor, num_groups: int,
                         margin: float) -> torch.Tensor:
    """RelDN contrastive core (``relation_head/loss.py:529-552``): per
    group, the MIN positive affinity ranked above the MAX negative one by a
    margin; mean over the groups that have both (+1, the reference's
    seeded dummy element)."""
    inf = float("inf")
    pos_min = _segment(torch.where(pos, affinity, inf), group_ids, num_groups,
                       inf, "amin")
    neg_max = _segment(torch.where(neg, affinity, -inf), group_ids, num_groups,
                       -inf, "amax")
    has_pos = _segment(pos.float(), group_ids, num_groups, -inf, "amax") > 0
    has_neg = _segment(neg.float(), group_ids, num_groups, -inf, "amax") > 0
    ok = has_pos & has_neg
    per = torch.clamp(margin - (pos_min - neg_max), min=0.0)
    return torch.where(ok, per, 0.0).sum() / (ok.sum() + 1)


def reldn_contrastive_losses(rel_logits: torch.Tensor, pairs: torch.Tensor,
                             pair_labels: torch.Tensor, pair_valid: torch.Tensor,
                             det_labels: torch.Tensor, num_objs: int, *,
                             num_obj_classes: int, num_rel_classes: int,
                             margin: float = 0.2, so_margin: float = 0.2,
                             p_margin: float = 0.2) -> Dict[str, torch.Tensor]:
    """RelDN graphical contrastive losses (``relation_head/loss.py:398-527``,
    ``CONTRASTIVE_LOSS.USE_FLAG``): for anchor groups of pairs sharing a
    subject (resp. object) detection, true-relation affinity (1 − p(no
    relation)) ranked above non-relation affinity — by the anchor alone
    (node), split by the other endpoint's class (SO-aware), and by the
    positives' gt predicate / the negatives' detected one (P-aware).
    pair_labels [P]: 0 no relation, ≥ 1 the gt predicate, −1 ignored."""
    probs = torch.softmax(rel_logits.float(), dim=-1)
    affinity = 1.0 - probs[:, 0]
    valid = pair_valid & (pair_labels >= 0)
    pos = valid & (pair_labels >= 1)
    neg = valid & (pair_labels == 0)
    det_prd = torch.argmax(probs[:, 1:], dim=-1) + 1
    prd_of_pair = torch.where(pos, pair_labels.long(), det_prd)

    out = {}
    for name, anchor, other in (("sbj", pairs[:, 0], pairs[:, 1]),
                                ("obj", pairs[:, 1], pairs[:, 0])):
        anchor = anchor.long()
        out[f"loss_contrastive_{name}"] = _grouped_margin_loss(
            affinity, anchor, pos, neg, num_objs, margin)
        so_ids = anchor * num_obj_classes + torch.clamp(
            det_labels[other].long(), 0, num_obj_classes - 1)
        out[f"loss_so_contrastive_{name}"] = _grouped_margin_loss(
            affinity, so_ids, pos, neg, num_objs * num_obj_classes, so_margin)
        p_ids = anchor * num_rel_classes + torch.clamp(prd_of_pair, 0,
                                                       num_rel_classes - 1)
        out[f"loss_p_contrastive_{name}"] = _grouped_margin_loss(
            affinity, p_ids, pos, neg, num_objs * num_rel_classes, p_margin)
    return out
