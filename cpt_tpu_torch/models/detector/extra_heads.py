"""Mask, keypoint and RetinaNet heads (port of
``cpt_tpu/models/detector/extra_heads.py``).

The reference framework's heads outside the VinVL pipeline:

* Mask head: the conv 3×3 stack (``roi_mask_feature_extractors.py``), the
  MaskRCNNC4Predictor (``roi_mask_predictors.py:10-31``: deconv 2×2 s2,
  ReLU, per-class 1×1 logits), the BCE at the matched class on positives
  (``loss.py``), class selection and the paste into the image
  (``inference.py``, ``paste_mask_in_image:119-159``).
* Keypoint head: conv 3×3 ×8 at 512, deconv k4 s2 and a ×2 bilinear
  upsample (``roi_keypoint_predictors.py:8-33``), the per-keypoint argmax
  to image coordinates (``heatmaps_to_keypoints``).
* RetinaNet: the shared 4-conv towers over the FPN levels with the focal
  prior's bias, the focal + smooth-L1 loss over #fg, and the per-level
  top-k, decode and one cross-level NMS (``rpn/retinanet/*.py``).

flax's ``nn.ConvTranspose`` (kernel ``(kh, kw, in, out)``, not flipped,
``"SAME"`` padding) is :class:`ConvTranspose` here: torch's transposed
convolution on the flipped kernel ``[in, out, kh, kw]``
(``models/detector/convert.module_params_from_jax`` flips it), with the
padding derived from lax's rule (:func:`transpose_padding`).
``retinanet_select``'s NMS runs kernel K5 through ``ops/nms_pallas``, its
top-k is ``top_k_stable`` (``jax.lax.top_k``'s order among ties).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.models.bert.captioning import top_k_stable
from cpt_tpu_torch.models.detector.fpn import upsample_bilinear
from cpt_tpu_torch.models.detector.losses import match_proposals, smooth_l1
from cpt_tpu_torch.models.detector.resnet import Conv
from cpt_tpu_torch.ops.focal_loss import sigmoid_focal_loss
from cpt_tpu_torch.ops.nms_pallas import nms_pallas
from cpt_tpu_torch.structures.boxes import box_iou, decode_boxes, encode_boxes


def transpose_padding(kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of the stride-dilated input that lax's
    ``conv_transpose`` takes for ``"SAME"`` (``_conv_transpose_padding``):
    the output is ``stride ×`` the input."""
    pad_len = kernel + stride - 2
    low = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return low, pad_len - low


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(s, s))`` on NHWC:
    ``weight`` [in, out, k, k] is the flax kernel flipped and transposed,
    f32 like ``bias``, both cast to ``dtype`` at use. lax pads the dilated
    input by :func:`transpose_padding`; torch pads ``k − 1 − padding`` below
    and that plus ``output_padding`` above."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))
        low, high = transpose_padding(kernel, stride)
        self.stride, self.dtype = stride, dtype
        self.padding, self.output_padding = kernel - 1 - low, high - low
        if self.padding < 0 or not 0 <= self.output_padding < stride:
            raise ValueError(f"no torch padding for a {kernel}x{kernel} "
                             f"stride-{stride} transposed conv")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), self.bias.to(dt),
                               self.stride, self.padding, self.output_padding)
        return y.permute(0, 2, 3, 1)


def _conv_stack(module: nn.Module, prefix: str, cin: int,
                channels: Sequence[int], dtype: torch.dtype) -> int:
    """Registers the 3×3 convs ``{prefix}{i + 1}``; returns the last width."""
    for i, ch in enumerate(channels):
        module.add_module(f"{prefix}{i + 1}", Conv(cin, ch, 3, padding=1,
                                                   dtype=dtype))
        cin = ch
    return cin


# ---------------------------------------------------------------- mask head


class MaskHead(nn.Module):
    """Conv stack + MaskRCNNC4Predictor on pooled RoI features:
    [N, P, P, C] → [N, 2P, 2P, num_classes] mask logits. ``conv_layers=()``
    is the C4 flavour, a non-empty one the FPN flavour."""

    def __init__(self, in_channels: int, num_classes: int,
                 conv_layers: Tuple[int, ...] = (), dim_reduced: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_convs = len(conv_layers)
        cin = _conv_stack(self, "mask_fcn", in_channels, conv_layers, dtype)
        self.conv5_mask = ConvTranspose(cin, dim_reduced, 2, 2, dtype)
        self.mask_fcn_logits = Conv(dim_reduced, num_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = torch.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.mask_fcn_logits(torch.relu(self.conv5_mask(x)))


def _class_channel(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[N, M, M, K] at each RoI's class (clipped to the K channels)."""
    cls = torch.clamp(labels, 0, x.shape[-1] - 1).to(torch.int64)
    return torch.gather(x, 3, cls[:, None, None, None].expand(
        *x.shape[:3], 1))[..., 0]


def mask_loss(mask_logits: torch.Tensor, gt_masks: torch.Tensor,
              labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """BCE at the matched gt class's channel, positives only
    (``mask_head/loss.py:112-125``): mask_logits [N, M, M, K] · gt_masks
    [N, M, M] (0/1) · labels [N] (0 = bg) · valid [N] bool."""
    sel = _class_channel(mask_logits, labels).float()
    per_px = (torch.clamp(sel, min=0) - sel * gt_masks
              + torch.log1p(torch.exp(-sel.abs())))
    fg = valid & (labels > 0)
    per_roi = per_px.mean(dim=(1, 2))
    denom = torch.clamp(fg.sum(), min=1)
    return torch.where(fg, per_roi, 0.0).sum() / denom


def select_class_masks(mask_logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """sigmoid, then the predicted class's channel
    (``mask_head/inference.py:38-45``): [N, M, M, K], [N] → [N, M, M]."""
    return _class_channel(torch.sigmoid(mask_logits.float()), labels)


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, im_h: int,
                im_w: int, *, threshold: float = 0.5,
                padding: int = 1) -> torch.Tensor:
    """[N, M, M] mask probabilities → [N, im_h, im_w] bool, as
    ``paste_mask_in_image``: pad by ``padding``, widen the box by
    (M + 2p) / M, sample bilinearly with half-pixel centres, threshold, and
    zero outside the box clipped to the image. One gather over all masks
    (the reference loops over them on the host)."""
    n, m, _ = masks.shape
    mp = m + 2 * padding
    dev = masks.device
    padded = F.pad(masks.float(), (padding,) * 4)
    scale = mp / m
    boxes = boxes.float()
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    xc = (boxes[:, 2] + boxes[:, 0]) * 0.5
    yc = (boxes[:, 3] + boxes[:, 1]) * 0.5
    x0 = torch.floor(xc - w_half)[:, None]
    y0 = torch.floor(yc - h_half)[:, None]
    x1 = torch.floor(xc + w_half)[:, None]
    y1 = torch.floor(yc + h_half)[:, None]
    bw = torch.clamp(x1 - x0 + 1, min=1.0)
    bh = torch.clamp(y1 - y0 + 1, min=1.0)
    ys = torch.arange(im_h, dtype=torch.float32, device=dev)
    xs = torch.arange(im_w, dtype=torch.float32, device=dev)
    u = (xs[None] - x0 + 0.5) / bw * mp - 0.5                      # [N, W]
    v = (ys[None] - y0 + 0.5) / bh * mp - 0.5                      # [N, H]

    def sample_axis(coord):
        lo = torch.clamp(torch.floor(coord), 0, mp - 1)
        hi = torch.clamp(lo + 1, 0, mp - 1)
        frac = torch.clamp(coord - lo, 0.0, 1.0)
        return lo.to(torch.int64), hi.to(torch.int64), frac

    vy0, vy1, fy = sample_axis(v)
    ux0, ux1, fx = sample_axis(u)
    rows = torch.arange(n, device=dev)[:, None, None]

    def at(yi, xi):
        return padded[rows, yi[:, :, None], xi[:, None, :]]        # [N, H, W]

    fxb, fyb = fx[:, None, :], fy[:, :, None]
    top = at(vy0, ux0) * (1 - fxb) + at(vy0, ux1) * fxb
    bot = at(vy1, ux0) * (1 - fxb) + at(vy1, ux1) * fxb
    val = top * (1 - fyb) + bot * fyb
    inside_x = (xs[None] >= torch.clamp(x0, min=0)) & (
        xs[None] < torch.clamp(x1 + 1, max=im_w))
    inside_y = (ys[None] >= torch.clamp(y0, min=0)) & (
        ys[None] < torch.clamp(y1 + 1, max=im_h))
    return (val > threshold) & inside_y[:, :, None] & inside_x[:, None, :]


# ------------------------------------------------------------ keypoint head


class KeypointHead(nn.Module):
    """KeypointRCNNFeatureExtractor + KeypointRCNNPredictor: [N, P, P, C] →
    conv 3×3 stack → deconv k4 s2 → ×2 bilinear → [N, 4P, 4P, K] logits."""

    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 conv_layers: Tuple[int, ...] = (512,) * 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_convs = len(conv_layers)
        cin = _conv_stack(self, "conv_fcn", in_channels, conv_layers, dtype)
        self.kps_score_lowres = ConvTranspose(cin, num_keypoints, 4, 2, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = torch.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        x = self.kps_score_lowres(x)
        return upsample_bilinear(x, 2 * x.shape[1], 2 * x.shape[2])


def heatmaps_to_keypoints(heatmaps: torch.Tensor, rois: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint argmax (the first maximum) → image coordinates and
    score: [N, H, W, K], [N, 4] xyxy → (xy [N, K, 2], score [N, K])."""
    n, h, w, k = heatmaps.shape
    flat = heatmaps.reshape(n, h * w, k)
    score = flat.amax(dim=1)
    idx = torch.argmax(flat, dim=1)
    yi = torch.div(idx, w, rounding_mode="floor").float()
    xi = (idx % w).float()
    rois = rois.float()
    bw = torch.clamp(rois[:, 2] - rois[:, 0], min=1.0)[:, None]
    bh = torch.clamp(rois[:, 3] - rois[:, 1], min=1.0)[:, None]
    x = rois[:, 0:1] + (xi + 0.5) * bw / w
    y = rois[:, 1:2] + (yi + 0.5) * bh / h
    return torch.stack([x, y], dim=-1), score


# --------------------------------------------------------------- RetinaNet


def retinanet_cell_anchors(stride: int, base_size: float,
                           aspect_ratios: Sequence[float],
                           scales_per_octave: int) -> np.ndarray:
    """[A, 4] anchors centred at (0, 0): octave scales × aspect ratios
    (``anchor_generator.py:make_anchor_generator_retinanet``)."""
    out = []
    for octave in range(scales_per_octave):
        size = base_size * 2.0 ** (octave / scales_per_octave)
        area = size * size
        for ratio in aspect_ratios:
            w = math.sqrt(area / ratio)
            h = w * ratio
            out.append([-w / 2, -h / 2, w / 2, h / 2])
    del stride
    return np.asarray(out, np.float32)


def retinanet_grid_anchors(feat_shapes: Sequence[Tuple[int, int]],
                           strides: Sequence[int],
                           aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                           scales_per_octave: int = 3,
                           octave_base: float = 4.0) -> np.ndarray:
    """Anchors of every pyramid level, concatenated: [Σ H·W·A, 4]."""
    grids = []
    for (h, w), stride in zip(feat_shapes, strides):
        cell = retinanet_cell_anchors(stride, octave_base * stride,
                                      aspect_ratios, scales_per_octave)
        sx = (np.arange(w) * stride)[None, :, None]
        sy = (np.arange(h) * stride)[:, None, None]
        shift = np.stack([np.broadcast_to(sx, (h, w, 1)),
                          np.broadcast_to(sy, (h, w, 1))] * 2, -1)
        grids.append((shift + cell[None, None]).reshape(-1, 4))
    return np.concatenate(grids, 0).astype(np.float32)


class RetinaNetHead(nn.Module):
    """The shared cls / bbox towers over every FPN level
    (``retinanet.py:13-86``) → per-level [B, H, W, A·C] class logits and
    [B, H, W, A·4] deltas. The flax head starts its class bias at the focal
    prior −log((1 − π)/π), π = 0.01; here the bias comes with the weights."""

    def __init__(self, num_classes: int, num_anchors: int = 9,
                 num_convs: int = 4, in_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_convs = num_convs
        for tower in ("cls_tower", "bbox_tower"):
            for i in range(num_convs):
                self.add_module(f"{tower}{i}", Conv(
                    in_channels if i == 0 else 256, 256, 3, padding=1,
                    dtype=dtype))
        last = 256 if num_convs else in_channels
        self.cls_logits = Conv(last, num_anchors * num_classes, 3, padding=1,
                               dtype=dtype)
        self.bbox_pred = Conv(last, num_anchors * 4, 3, padding=1, dtype=dtype)

    def forward(self, features: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for f in features:
            c = b = f
            for i in range(self.num_convs):
                c = torch.relu(getattr(self, f"cls_tower{i}")(c))
            logits.append(self.cls_logits(c))
            for i in range(self.num_convs):
                b = torch.relu(getattr(self, f"bbox_tower{i}")(b))
            deltas.append(self.bbox_pred(b))
        return logits, deltas


RETINANET_CODER = (10.0, 10.0, 5.0, 5.0)


def _flatten_levels(per_level: Sequence[torch.Tensor], last_dim: int
                    ) -> torch.Tensor:
    return torch.cat([x.reshape(x.shape[0], -1, last_dim) for x in per_level],
                     dim=1)


def retinanet_loss(cls_logits: Sequence[torch.Tensor],
                   box_deltas: Sequence[torch.Tensor], anchors: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_valid: torch.Tensor, *, num_classes: int,
                   fg_iou: float = 0.5, bg_iou: float = 0.4) -> dict:
    """Focal class loss and smooth-L1 box loss, both over #fg
    (``rpn/retinanet/loss.py``), for one image."""
    cls = _flatten_levels(cls_logits, num_classes)[0]            # [A, C]
    reg = _flatten_levels(box_deltas, 4)[0]                      # [A, 4]
    iou = box_iou(gt_boxes, anchors)
    matches = match_proposals(iou, fg_iou, bg_iou, allow_low_quality=True,
                              gt_valid=gt_valid)
    fg = matches >= 0
    safe = torch.clamp(matches, min=0).to(torch.int64)
    labels = torch.where(fg, gt_labels[safe], 0)                 # 0 = bg
    ignore = matches == -2
    per_elem = sigmoid_focal_loss(cls, torch.where(ignore, -1, labels))
    n_fg = torch.clamp(fg.sum(), min=1)
    cls_loss = per_elem.sum() / n_fg
    target = encode_boxes(gt_boxes[safe], anchors, RETINANET_CODER)
    reg_per = smooth_l1(reg.float(), target, 1.0 / 9).sum(-1)
    reg_loss = torch.where(fg, reg_per, 0.0).sum() / n_fg
    return {"loss_retina_cls": cls_loss, "loss_retina_reg": reg_loss}


def retinanet_select(cls_logits: Sequence[torch.Tensor],
                     box_deltas: Sequence[torch.Tensor],
                     level_anchors: Sequence[torch.Tensor], *,
                     num_classes: int, image_size: Tuple[int, int],
                     pre_nms_top_n: int = 1000, score_thresh: float = 0.05,
                     nms_thresh: float = 0.4, max_det: int = 100):
    """Per-level top-k and decode, then one class-aware NMS over the levels
    (``rpn/retinanet/inference.py``), for one image: K5 on the boxes
    shifted by ``label · (max(image_size) + 1)``. Returns (boxes [max_det,
    4], scores [max_det], labels [max_det], keep [max_det] bool)."""
    all_boxes, all_scores, all_labels, all_valid = [], [], [], []
    h, w = image_size
    for logit, delta, anchors in zip(cls_logits, box_deltas, level_anchors):
        scores = torch.sigmoid(logit.reshape(-1, num_classes).float())
        deltas = delta.reshape(-1, 4).float()
        k = min(pre_nms_top_n, scores.shape[0] * num_classes)
        top, idx = top_k_stable(scores.reshape(-1), k)
        a_idx = torch.div(idx, num_classes, rounding_mode="floor")
        cls_id = idx % num_classes + 1
        boxes = decode_boxes(deltas[a_idx], anchors[a_idx].float(),
                             RETINANET_CODER)
        boxes = torch.stack([boxes[:, 0].clamp(0, w - 1),
                             boxes[:, 1].clamp(0, h - 1),
                             boxes[:, 2].clamp(0, w - 1),
                             boxes[:, 3].clamp(0, h - 1)], -1)
        all_boxes.append(boxes)
        all_scores.append(top)
        all_labels.append(cls_id)
        all_valid.append(top > score_thresh)
    boxes = torch.cat(all_boxes)
    scores = torch.cat(all_scores)
    labels = torch.cat(all_labels)
    valid = torch.cat(all_valid)
    offset = labels.float()[:, None] * (max(image_size) + 1)
    idx, keep = nms_pallas(boxes + offset, scores, valid, nms_thresh, max_det)
    idx = idx.to(torch.int64)
    return boxes[idx], scores[idx], labels[idx], keep
