"""Cityscapes-protocol instance-level AP (box and mask).

The port's copy of ``cpt_tpu/engine/cityscapes_eval.py`` (numpy only; its code is
the original's, held so by ``tests/test_torch_isolation.py``).

Host-side reimplementation of the reference's cityscapes evaluation
package (`prompt_feat/maskrcnn_benchmark/data/datasets/evaluation/
cityscapes/eval_instances.py:99-844` and `cityscapes_eval.py:22-103`),
closing the one evaluation protocol that was previously descoped.  The
reference file is the maskrcnn-benchmark adaptation of the official
cityscapesScripts instance eval; its semantics differ from COCO/VOC mAP
in several deliberate (and some quirky) ways, all reproduced here:

* Boxes are truncated to integers (`bbs.long()`, eval_instances.py:289)
  and areas/intersections use the EXCLUSIVE convention
  (`(xmax-xmin)*(ymax-ymin)`, :291) — unlike the detector's inclusive
  +1 convention.
* Mask pixel counts are taken over the instance's own box crop
  (:307-309), and mask intersections over the union-box crop (:201-220),
  so mask pixels outside the (truncated) boxes do not count.
* GT↔prediction links are registered CLASS-AGNOSTICALLY before the
  per-class grouping (matchGtWithPred links every overlapping pair,
  :230-255, then groups by label :257-267), so a prediction can match a
  ground truth of a different class during the per-class sweeps.
* A second prediction matching an already-matched GT immediately
  contributes a false positive with the smaller of the two confidences
  (:497-509).
* GTs below the min region size are filtered from the match pool but
  still "ignore" overlapping predictions: an unmatched prediction is
  dropped (not a FP) when the ignored-GT intersection proportion exceeds
  the overlap threshold (:528-546).
* Predictions carrying an (all-empty) pasted mask are dropped outright
  when masks are being evaluated (:398-401).
* The PR curve is built from unique score thresholds with hard false
  negatives folded into the recall denominator, integrated by the
  step-width convolution trick (:552-615).

Inputs are plain per-image dicts (the same contract as
`engine/detection_eval.py`):

    gt:   {"boxes": [N,4] xyxy, "labels": [N] int (index into
           class_names), "masks": optional [N,H,W] binary}
    pred: gt keys + {"scores": [N] float}

Masks, when given, are full-canvas binary arrays at the evaluation
resolution (the reference pastes its 28x28 RoI masks onto the canvas via
`Masker` first — the port's equivalent is
`cpt_tpu_torch/models/detector/extra_heads.py::paste_masks`).
"""
from __future__ import annotations

import json
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

# The reference evaluates overlaps .50:.05:.95 and one min region size of
# 100 px (eval_instances.py:87-89).
DEFAULT_OVERLAPS = np.arange(0.5, 1.0, 0.05)
DEFAULT_MIN_REGION_SIZES = (100,)


def _as_int_boxes(boxes: np.ndarray) -> np.ndarray:
    # torch `.long()` truncates toward zero (eval_instances.py:289,349).
    return np.asarray(boxes, dtype=np.float64).astype(np.int64)


def _own_box_pixel_counts(boxes: np.ndarray,
                          masks: Optional[np.ndarray]) -> np.ndarray:
    """Mask pixels inside each instance's own (truncated) box
    (eval_instances.py:307-309, :390-392). Raw Python slice semantics on
    purpose: the reference slices ``mask[ymin:ymax, xmin:xmax]`` directly,
    so a NEGATIVE coordinate wraps to the array tail (usually an empty or
    near-empty slice) — numpy slicing reproduces that quirk exactly."""
    n = boxes.shape[0]
    counts = np.zeros(n, dtype=np.int64)
    if masks is None:
        return counts
    for i in range(n):
        x0, y0, x1, y1 = boxes[i]
        counts[i] = int(np.count_nonzero(masks[i][y0:y1, x0:x1]))
    return counts


class _Instances:
    """Per-image instance table (one side: GT or prediction)."""

    def __init__(self, rec: dict, with_scores: bool):
        boxes = _as_int_boxes(np.asarray(rec.get("boxes",
                                                 np.zeros((0, 4)))))
        labels = np.asarray(rec.get("labels", np.zeros((0,), np.int64)),
                            dtype=np.int64)
        masks = rec.get("masks")
        if masks is not None:
            masks = np.asarray(masks)
            masks = (masks > 0) if masks.dtype != bool else masks
        scores = (np.asarray(rec["scores"], dtype=np.float64)
                  if with_scores else np.zeros(len(labels)))
        areas = ((boxes[:, 2] - boxes[:, 0]) *
                 (boxes[:, 3] - boxes[:, 1])).astype(np.int64)
        pixels = _own_box_pixel_counts(boxes, masks)
        if with_scores and masks is not None:
            # predictions whose pasted mask is empty are dropped
            # (eval_instances.py:398-401)
            keep = pixels > 0
            boxes, labels, scores = boxes[keep], labels[keep], scores[keep]
            areas, pixels = areas[keep], pixels[keep]
            masks = masks[keep]
        self.boxes = boxes
        self.labels = labels
        self.scores = scores
        self.areas = areas
        self.pixels = pixels
        self.masks = masks

    def __len__(self):
        return len(self.labels)


class _ImageMatch:
    """Class-agnostic GT↔pred link table for one image
    (matchGtWithPred, eval_instances.py:223-271)."""

    def __init__(self, gt: dict, pred: dict):
        self.gt = _Instances(gt, with_scores=False)
        self.pred = _Instances(pred, with_scores=True)
        g, p = self.gt, self.pred
        # strict-inequality box overlap test on int boxes
        # (isOverlapping, :159-163)
        if len(g) and len(p):
            gx0, gy0, gx1, gy1 = (g.boxes[:, i][:, None] for i in range(4))
            px0, py0, px1, py1 = (p.boxes[:, i][None, :] for i in range(4))
            overlapping = ((gx0 < px1) & (px0 < gx1) &
                           (gy0 < py1) & (py0 < gy1))
            iw = np.minimum(gx1, px1) - np.maximum(gx0, px0)
            ih = np.minimum(gy1, py1) - np.maximum(gy0, py0)
            box_inter = iw * ih
            linked = overlapping & (box_inter > 0)
        else:
            linked = np.zeros((len(g), len(p)), dtype=bool)
            box_inter = np.zeros((len(g), len(p)), dtype=np.int64)
        self.box_inter = box_inter
        self.linked = linked
        # mask intersection over the union-box crop
        # (computeMaskIntersection, :201-220)
        self.mask_inter = np.zeros_like(box_inter)
        if g.masks is not None and p.masks is not None:
            for gi, pi in zip(*np.nonzero(linked)):
                ux0 = min(g.boxes[gi, 0], p.boxes[pi, 0])
                uy0 = min(g.boxes[gi, 1], p.boxes[pi, 1])
                ux1 = max(g.boxes[gi, 2], p.boxes[pi, 2])
                uy1 = max(g.boxes[gi, 3], p.boxes[pi, 3])
                self.mask_inter[gi, pi] = int(np.count_nonzero(
                    g.masks[gi][uy0:uy1, ux0:ux1] &
                    p.masks[pi][uy0:uy1, ux0:ux1]))

    def sizes(self, kind: str, side: str) -> np.ndarray:
        inst = self.gt if side == "gt" else self.pred
        return inst.areas if kind == "box" else inst.pixels

    def inter(self, kind: str) -> np.ndarray:
        return self.box_inter if kind == "box" else self.mask_inter


def match_instances(gt_per_image: Sequence[dict],
                    pred_per_image: Sequence[dict]) -> List[_ImageMatch]:
    assert len(gt_per_image) == len(pred_per_image)
    return [_ImageMatch(g, p)
            for g, p in zip(gt_per_image, pred_per_image)]


def evaluate_instance_ap(matches: Sequence[_ImageMatch],
                         num_classes: int,
                         kind: str = "box",
                         overlaps: np.ndarray = DEFAULT_OVERLAPS,
                         min_region_sizes: Sequence[float] =
                         DEFAULT_MIN_REGION_SIZES) -> np.ndarray:
    """AP matrix [min_region_size, class, overlap]
    (evaluateBoxMatches/evaluateMaskMatches, eval_instances.py:418-820;
    the two differ only in the size/intersection fields and in the
    zero-size guard of the ignore-proportion branch)."""
    assert kind in ("box", "mask")
    overlaps = np.asarray(overlaps, dtype=np.float64)
    ap = np.zeros((len(min_region_sizes), num_classes, len(overlaps)))
    for di, min_size in enumerate(min_region_sizes):
        for oi, overlap_th in enumerate(overlaps):
            for cls in range(num_classes):
                y_true: List[float] = []
                y_score: List[float] = []
                hard_fns = 0
                have_gt = have_pred = False
                for m in matches:
                    gt_sizes = m.sizes(kind, "gt")
                    pred_sizes = m.sizes(kind, "pred")
                    inter = m.inter(kind)
                    gt_idx = np.nonzero((m.gt.labels == cls) &
                                        (gt_sizes >= min_size))[0]
                    pred_idx = np.nonzero(m.pred.labels == cls)[0]
                    have_gt |= len(gt_idx) > 0
                    have_pred |= len(pred_idx) > 0
                    # GT sweep: best match keeps its confidence; extra
                    # matches append FPs at the lower confidence
                    # (:483-513)
                    for gi in gt_idx:
                        matched = False
                        score = -np.inf
                        # linked preds of ANY class (class-agnostic link
                        # table; grouping happens before evaluation in
                        # the reference, :230-267)
                        for pi in np.nonzero(m.linked[gi])[0]:
                            denom = (gt_sizes[gi] + pred_sizes[pi] -
                                     inter[gi, pi])
                            ov = inter[gi, pi] / denom if denom else 0.0
                            if ov > overlap_th:
                                conf = m.pred.scores[pi]
                                if matched:
                                    y_true.append(0.0)
                                    y_score.append(min(score, conf))
                                    score = max(score, conf)
                                else:
                                    matched = True
                                    score = conf
                        if matched:
                            y_true.append(1.0)
                            y_score.append(score)
                        else:
                            hard_fns += 1
                    # prediction sweep: unmatched preds become FPs
                    # unless mostly covered by too-small GTs (:519-546)
                    for pi in pred_idx:
                        found_gt = False
                        for gi in np.nonzero(m.linked[:, pi])[0]:
                            denom = (gt_sizes[gi] + pred_sizes[pi] -
                                     inter[gi, pi])
                            ov = inter[gi, pi] / denom if denom else 0.0
                            if ov > overlap_th:
                                found_gt = True
                                break
                        if found_gt:
                            continue
                        ignore = sum(int(inter[gi, pi])
                                     for gi in np.nonzero(m.linked[:, pi])[0]
                                     if gt_sizes[gi] < min_size)
                        size = pred_sizes[pi]
                        proportion = ignore / size if size > 0 else 0.0
                        if proportion <= overlap_th:
                            y_true.append(0.0)
                            y_score.append(m.pred.scores[pi])
                if have_gt and have_pred:
                    ap[di, cls, oi] = _average_precision(
                        np.asarray(y_true), np.asarray(y_score), hard_fns)
                elif have_gt:
                    ap[di, cls, oi] = 0.0
                else:
                    ap[di, cls, oi] = np.nan
    return ap


def _average_precision(y_true: np.ndarray, y_score: np.ndarray,
                       hard_fns: int) -> float:
    """PR curve over unique ascending thresholds + step-width
    integration (eval_instances.py:552-608)."""
    order = np.argsort(y_score)
    y_score, y_true = y_score[order], y_true[order]
    cumsum = np.cumsum(y_true)
    n, n_true = len(y_score), cumsum[-1] if len(cumsum) else 0.0
    _, first_idx = np.unique(y_score, return_index=True)
    precision = np.zeros(len(first_idx) + 1)
    recall = np.zeros(len(first_idx) + 1)
    cumsum = np.append(cumsum, 0.0)  # index -1 → 0 (":580")
    for out_i, idx in enumerate(first_idx):
        below = cumsum[idx - 1]
        tp = n_true - below
        fp = n - idx - tp
        fn = below + hard_fns
        precision[out_i] = tp / (tp + fp)
        recall[out_i] = tp / (tp + fn)
    precision[-1] = 1.0
    recall[-1] = 0.0
    padded = np.concatenate(([recall[0]], recall, [0.0]))
    step_widths = np.convolve(padded, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def compute_averages(ap: np.ndarray, class_names: Sequence[str],
                     overlaps: np.ndarray = DEFAULT_OVERLAPS,
                     min_region_sizes: Sequence[float] =
                     DEFAULT_MIN_REGION_SIZES) -> dict:
    """(computeAverages, eval_instances.py:823-844)."""
    overlaps = np.asarray(overlaps, dtype=np.float64)
    d = int(np.argmin(np.asarray(min_region_sizes)))
    o50 = np.where(np.isclose(overlaps, 0.5))
    o75 = np.where(np.isclose(overlaps, 0.75))
    with warnings.catch_warnings():
        # all-NaN slices (a class with no GT and no predictions) mean
        # NaN here by protocol, not by accident
        warnings.simplefilter("ignore", RuntimeWarning)
        out = {
            "allAp": float(np.nanmean(ap[d, :, :])),
            "allAp50%": float(np.nanmean(ap[d, :, o50])),
            "allAp75%": float(np.nanmean(ap[d, :, o75])),
            "classes": {},
        }
    for ci, name in enumerate(class_names):
        out["classes"][name] = {
            "ap": float(np.average(ap[d, ci, :])),
            "ap50%": float(np.average(ap[d, ci, o50])),
            "ap75%": float(np.average(ap[d, ci, o75])),
        }
    return out


def format_results(avg: dict, class_names: Sequence[str]) -> str:
    """Plain-text results table (printResults, eval_instances.py:847-897,
    without the ANSI colorization)."""
    lines = ["#" * 65,
             "{:<15}:{:>15}{:>15}{:>15}".format("what", "AP", "AP_50%",
                                                "AP_75%"),
             "#" * 65]
    for name in class_names:
        c = avg["classes"][name]
        lines.append("{:<15}:{:>15.3f}{:>15.3f}{:>15.3f}".format(
            name, c["ap"], c["ap50%"], c["ap75%"]))
    lines.append("-" * 65)
    lines.append("{:<15}:{:>15.3f}{:>15.3f}{:>15.3f}".format(
        "average", avg["allAp"], avg["allAp50%"], avg["allAp75%"]))
    return "\n".join(lines)


def cityscapes_instance_eval(gt_per_image: Sequence[dict],
                             pred_per_image: Sequence[dict],
                             class_names: Sequence[str],
                             iou_types: Sequence[str] = ("bbox", "segm"),
                             overlaps: np.ndarray = DEFAULT_OVERLAPS,
                             min_region_sizes: Sequence[float] =
                             DEFAULT_MIN_REGION_SIZES,
                             output_json: Optional[str] = None) -> Dict:
    """Full protocol: match once, evaluate bbox and/or segm AP
    (do_cityscapes_evaluation, cityscapes_eval.py:22-103)."""
    matches = match_instances(gt_per_image, pred_per_image)
    results: Dict[str, dict] = {}
    for iou_type, kind in (("bbox", "box"), ("segm", "mask")):
        if iou_type not in iou_types:
            continue
        ap = evaluate_instance_ap(matches, len(class_names), kind,
                                  overlaps, min_region_sizes)
        avg = compute_averages(ap, class_names, overlaps, min_region_sizes)
        results[iou_type] = {
            "averages": avg,
            "overlaps": np.asarray(overlaps).tolist(),
            "minRegionSizes": list(min_region_sizes),
            "instLabels": list(class_names),
            "resultApMatrix": ap.tolist(),
            "table": format_results(avg, class_names),
        }
    if output_json:
        with open(output_json, "w") as f:
            json.dump(results, f, indent=2)
    return results
