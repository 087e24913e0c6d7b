"""Detector training losses: matcher, balanced sampling, RPN / FastRCNN /
attribute losses, all static-shape (port of
``cpt_tpu/models/detector/losses.py``).

As the reference ``maskrcnn_benchmark/modeling`` computes them:
  * ``matcher.py:121``: IoU matcher with the BELOW_LOW (−1) / BETWEEN (−2)
    sentinels and the allow-low-quality force match of each gt's best
    predictions;
  * ``balanced_positive_negative_sampler.py:68``: per-image positive /
    negative minibatch sampling (``positive_fraction``);
  * ``rpn/loss.py:157``: objectness BCE + smooth-L1 (β = 1/9) over the
    sampled anchors;
  * ``roi_heads/box_head/loss.py:227``: cross entropy + per-class smooth-L1
    (β = 1) box regression, over the number of sampled proposals;
  * ``scene_graph_benchmark/attribute_head/loss.py``: soft-target cross
    entropy over attribute logits (uniform over a box's gt attributes).

No index lists: everything is a fixed-shape mask, and "sampling" keeps the
``limit`` eligible entries of lowest random priority, drawn from a
``torch.Generator`` (the same distribution as torch's randperm subset; the
draws cannot be JAX's, so parity tests patch :func:`balanced_sample` in
both packages with one deterministic pick).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from cpt_tpu_torch.structures.boxes import box_iou, encode_boxes

BELOW_LOW = -1
BETWEEN = -2


def match_proposals(iou: torch.Tensor, high: float, low: float,
                    allow_low_quality: bool = False,
                    gt_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """iou [num_gt, num_pred] → matches [num_pred] (gt index, or −1/−2)."""
    if gt_valid is not None:
        iou = torch.where(gt_valid[:, None], iou, -1.0)
    matched_vals, matches = iou.max(dim=0)       # the first max, as argmax
    matches = matches.to(torch.int32)
    out = torch.where(matched_vals < low, BELOW_LOW,
                      torch.where(matched_vals < high, BETWEEN, matches))
    if allow_low_quality:
        # any prediction reaching some gt's best IoU is matched anyway
        gt_max = iou.max(dim=1, keepdim=True).values
        force = ((iou == gt_max) & (gt_max > 0)).any(dim=0)
        out = torch.where(force, matches, out)
    return out.to(torch.int32)


def balanced_sample(matches: torch.Tensor, generator: torch.Generator,
                    batch_size: int, positive_fraction: float,
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (pos_mask, neg_mask) with |pos| ≤ bs·frac and |pos|+|neg| ≤ bs."""
    pos = matches >= 0
    neg = matches == BELOW_LOW
    if valid is not None:
        pos = pos & valid
        neg = neg & valid
    n = matches.shape[0]

    def pick(mask, limit):
        # rank random priorities among the eligible; keep the `limit` first
        pri = torch.rand(n, generator=generator,
                         device=matches.device) + (~mask) * 10.0
        rank = torch.empty(n, dtype=torch.long, device=matches.device)
        rank[torch.argsort(pri)] = torch.arange(n, device=matches.device)
        return mask & (rank < limit)

    max_pos = int(batch_size * positive_fraction)
    num_pos = torch.clamp(pos.sum(), max=max_pos)
    pos_mask = pick(pos, num_pos)
    num_neg = torch.minimum(neg.sum(), batch_size - num_pos)
    return pos_mask, pick(neg, num_neg)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def rpn_loss(objectness: torch.Tensor, box_deltas: torch.Tensor,
             anchors: torch.Tensor, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor, generator: torch.Generator, *,
             fg_iou: float = 0.7, bg_iou: float = 0.3,
             batch_size_per_image: int = 256, positive_fraction: float = 0.5,
             anchor_visible: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image. objectness [A], box_deltas [A, 4], anchors [A, 4],
    gt_boxes [G, 4] (+ gt_valid [G]) → (objectness_loss, box_loss)."""
    iou = box_iou(gt_boxes, anchors)
    matches = match_proposals(iou, fg_iou, bg_iou, allow_low_quality=True,
                              gt_valid=gt_valid)
    if anchor_visible is not None:
        matches = torch.where(anchor_visible, matches, BETWEEN)
    pos, neg = balanced_sample(matches, generator, batch_size_per_image,
                               positive_fraction)
    sampled = pos | neg
    n_sampled = torch.clamp(sampled.sum(), min=1)

    labels = (matches >= 0).float()
    logits = objectness.float()
    bce = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    objectness_loss = torch.where(sampled, bce, 0.0).sum() / n_sampled

    matched_gt = gt_boxes[matches.clamp(min=0).long()]
    targets = encode_boxes(matched_gt, anchors, (1.0, 1.0, 1.0, 1.0))
    l1 = smooth_l1(box_deltas.float(), targets, beta=1.0 / 9)
    box_loss = torch.where(pos[:, None], l1, 0.0).sum() / n_sampled
    return objectness_loss, box_loss


def subsample_proposals(proposals: torch.Tensor, proposal_valid: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                        gt_valid: torch.Tensor, generator: torch.Generator, *,
                        batch_size_per_image: int = 384,
                        positive_fraction: float = 0.5, fg_iou: float = 0.5,
                        bg_iou: float = 0.5):
    """FastRCNN train-time proposal subsampling (``box_head/loss.py``
    prepare_targets + subsample) → per proposal (labels [P] (0 = bg),
    reg_targets [P, 4], pos_mask, sampled_mask). The targets stay
    differentiable in ``proposals``, as in JAX."""
    iou = box_iou(gt_boxes, proposals)
    matches = match_proposals(iou, fg_iou, bg_iou, allow_low_quality=False,
                              gt_valid=gt_valid)
    pos, neg = balanced_sample(matches, generator, batch_size_per_image,
                               positive_fraction, valid=proposal_valid)
    idx = matches.clamp(min=0).long()
    labels = torch.where(pos, gt_labels[idx], 0)
    reg_targets = encode_boxes(gt_boxes[idx], proposals, (10.0, 10.0, 5.0, 5.0))
    return labels, reg_targets, pos, pos | neg


def fast_rcnn_loss(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                   labels: torch.Tensor, reg_targets: torch.Tensor,
                   pos_mask: torch.Tensor, sampled_mask: torch.Tensor, *,
                   num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """class_logits [P, C], box_deltas [P, C*4] → (cls_loss, box_loss)."""
    n_sampled = torch.clamp(sampled_mask.sum(), min=1)
    logp = torch.log_softmax(class_logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    cls_loss = torch.where(sampled_mask, nll, 0.0).sum() / n_sampled

    deltas = box_deltas.float().reshape(box_deltas.shape[0], num_classes, 4)
    per_label = torch.gather(
        deltas, 1, labels.long()[:, None, None].expand(-1, 1, 4))[:, 0]
    l1 = smooth_l1(per_label, reg_targets, beta=1.0)
    box_loss = torch.where(pos_mask[:, None], l1, 0.0).sum() / n_sampled
    return cls_loss, box_loss


def attribute_loss(attr_logits: torch.Tensor, gt_attributes: torch.Tensor,
                   valid: torch.Tensor, *, loss_weight: float = 1.0
                   ) -> torch.Tensor:
    """Soft-target cross entropy (reference ``attribute_head/loss.py:
    48-64``): gt_attributes [P, K] attribute ids (0 = none), the target
    uniform over a box's nonzero ids; boxes with none add 0. The mean runs
    over the valid proposals (padded slots left out of the denominator)."""
    num_attr = attr_logits.shape[1]
    present = gt_attributes > 0                                  # [P, K]
    counts = present.sum(dim=1)                                  # [P]
    onehots = (torch.nn.functional.one_hot(gt_attributes.long(), num_attr)
               * present[..., None])
    soft = onehots.sum(dim=1) / torch.clamp(counts, min=1)[:, None]
    logp = torch.log_softmax(attr_logits.float(), dim=-1)
    per_box = -(soft * logp).sum(dim=1)
    per_box = torch.where(valid & (counts > 0), per_box, 0.0)
    return loss_weight * per_box.sum() / torch.clamp(valid.sum(), min=1)
