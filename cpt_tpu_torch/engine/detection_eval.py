"""Detection evaluation (the port's copy of ``cpt_tpu/engine/detection_eval.py``):
VOC-style mAP (VG convention), COCO AP and the expected-results assertion.

Parity with reference
``data/datasets/evaluation/vg/vg_eval.py`` (``eval_detection_voc:104``,
``calc_detection_voc_prec_rec:177``, ``voc_ap:301``): per-class greedy
matching at IoU ≥ 0.5 with the +1 box-extent convention, difficult-gt
exclusion, continuous-interpolation AP (or the 11-point VOC07 metric), and
the ``TEST.EXPECTED_RESULTS`` σ-tolerance regression check
(``evaluation/coco/coco_eval.py:377`` / ``defaults.py:476-477``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _iou_plus_one(box: np.ndarray, gts: np.ndarray) -> np.ndarray:
    ixmin = np.maximum(gts[:, 0], box[0])
    iymin = np.maximum(gts[:, 1], box[1])
    ixmax = np.minimum(gts[:, 2], box[2])
    iymax = np.minimum(gts[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inter = iw * ih
    union = ((box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
             + (gts[:, 2] - gts[:, 0] + 1.0) * (gts[:, 3] - gts[:, 1] + 1.0)
             - inter)
    return inter / np.maximum(union, 1e-10)


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_detection_voc(pred_per_image: Sequence[dict],
                       gt_per_image: Sequence[dict],
                       num_classes: int, iou_thresh: float = 0.5,
                       use_07_metric: bool = False,
                       double_inclusive: bool = False) -> Dict[str, float]:
    """pred_per_image: [{"boxes" [N,4], "labels" [N], "scores" [N]}];
    gt_per_image: [{"boxes" [M,4], "labels" [M], "difficult" [M]?}].
    Classes are 1-indexed (0 = background, skipped).
    Returns {"mAP": ..., "AP/<c>": ...} (classes with no gt excluded).

    The reference ships TWO box conventions: ``vg_eval.py`` (the
    test_sg_net / VG-TSV protocol behind the VinVL numbers) matches with
    the single inclusive +1 — the default here — while ``voc_eval.py``
    (plain-VOC datasets) adds +1 to x2/y2 ON TOP of boxlist_iou's
    TO_REMOVE=1; ``double_inclusive=True`` reproduces that effective +2.
    The JAX package holds both to the reference evaluators; the port's
    copy is held to the JAX package's."""
    aps = {}
    for c in range(1, num_classes):
        scores: List[float] = []
        matched: List[bool] = []
        n_pos = 0
        for preds, gts in zip(pred_per_image, gt_per_image):
            gt_sel = np.asarray(gts["labels"]) == c
            gt_boxes = np.asarray(gts["boxes"], np.float64)[gt_sel]
            difficult = np.asarray(
                gts.get("difficult", np.zeros(len(gts["labels"]))))[gt_sel]
            n_pos += int((~difficult.astype(bool)).sum())
            p_sel = np.asarray(preds["labels"]) == c
            p_boxes = np.asarray(preds["boxes"], np.float64)[p_sel]
            if double_inclusive:
                if len(p_boxes):
                    p_boxes = p_boxes.copy()
                    p_boxes[:, 2:] += 1
                if len(gt_boxes):
                    gt_boxes = gt_boxes.copy()
                    gt_boxes[:, 2:] += 1
            p_scores = np.asarray(preds["scores"], np.float64)[p_sel]
            order = np.argsort(-p_scores, kind="stable")
            taken = np.zeros(len(gt_boxes), bool)
            for pi in order:
                scores.append(p_scores[pi])
                ok = False
                if len(gt_boxes):
                    ious = _iou_plus_one(p_boxes[pi], gt_boxes)
                    best = int(np.argmax(ious))
                    if ious[best] >= iou_thresh:
                        if difficult.astype(bool)[best]:
                            scores.pop()   # difficult gt: ignore detection
                            continue
                        if not taken[best]:
                            taken[best] = True
                            ok = True
                matched.append(ok)
        if n_pos == 0:
            continue
        if not scores:
            aps[f"AP/{c}"] = 0.0
            continue
        order = np.argsort(-np.asarray(scores), kind="stable")
        tp = np.cumsum(np.asarray(matched)[order])
        fp = np.cumsum(~np.asarray(matched)[order])
        rec = tp / n_pos
        prec = tp / np.maximum(tp + fp, 1e-10)
        aps[f"AP/{c}"] = voc_ap(rec, prec, use_07_metric)
    out = {"mAP": float(np.mean(list(aps.values()))) if aps else 0.0}
    out.update(aps)
    return out


def eval_detection_attributes(pred_per_image: Sequence[dict],
                              gt_per_image: Sequence[dict],
                              num_attr_classes: int,
                              iou_thresh: float = 0.5,
                              use_07_metric: bool = False
                              ) -> Dict[str, float]:
    """Attribute-detection mAP — the ``test_sg_net.py:115``
    force-box attribute evaluation (reference ``vg_eval.py``
    ``eval_attributes=True`` branch):

    pred_per_image: [{"boxes" [N,4], "attr_labels" [N,K],
    "attr_scores" [N,K]}] — each box contributes its K attribute slots
    (zero-score slots skipped); gt_per_image: [{"boxes" [M,4],
    "attributes" [M,Kg]}] — a gt counts for every attribute id its row
    contains. Greedy +1-IoU matching with per-(image, class) taken
    flags; classes with no gt score AP 0 and ARE averaged (the
    reference's behavior). Returns mAP, npos-weighted mAP and per-class
    APs (attribute id 0 = __no_attribute__, skipped)."""
    aps, nposs = [], []
    per_class = {}
    for c in range(1, num_attr_classes):
        scores: List[float] = []
        matched: List[bool] = []
        n_pos = 0
        for preds, gts in zip(pred_per_image, gt_per_image):
            gt_boxes_all = np.asarray(gts["boxes"], np.float64).reshape(
                -1, 4)
            gt_attr = np.asarray(gts["attributes"]).reshape(
                len(gt_boxes_all), -1)
            gt_sel = (gt_attr == c).any(axis=1)
            gt_boxes = gt_boxes_all[gt_sel]
            n_pos += int(gt_sel.sum())
            al = np.asarray(preds["attr_labels"])
            asc = np.asarray(preds["attr_scores"], np.float64)
            rows, slots = np.nonzero((al == c) & (asc != 0.0))
            p_boxes = np.asarray(preds["boxes"], np.float64)[rows]
            p_scores = asc[rows, slots]
            order = np.argsort(-p_scores, kind="stable")
            taken = np.zeros(len(gt_boxes), bool)
            for pi in order:
                scores.append(p_scores[pi])
                ok = False
                if len(gt_boxes):
                    ious = _iou_plus_one(p_boxes[pi], gt_boxes)
                    best = int(np.argmax(ious))
                    if ious[best] >= iou_thresh and not taken[best]:
                        taken[best] = True
                        ok = True
                matched.append(ok)
        if n_pos == 0 or not scores:
            aps.append(0.0)
            nposs.append(float(n_pos))
            continue
        order = np.argsort(-np.asarray(scores), kind="stable")
        tp = np.cumsum(np.asarray(matched)[order])
        fp = np.cumsum(~np.asarray(matched)[order])
        rec = tp / n_pos
        prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        ap = voc_ap(rec, prec, use_07_metric)
        aps.append(float(ap))
        nposs.append(float(n_pos))
        per_class[f"attrAP/{c}"] = float(ap)
    w = np.asarray(nposs)
    out = {"attr_mAP": float(np.mean(aps)) if aps else 0.0,
           "attr_weighted_mAP": (float(np.average(aps, weights=w))
                                 if w.sum() > 0 else 0.0)}
    out.update(per_class)
    return out


def check_expected_results(results: Dict[str, float],
                           expected: Sequence[Tuple[str, float, float]],
                           logger=print) -> bool:
    """σ-tolerance regression assertion (reference
    ``coco_eval.py:check_expected_results``): each entry is
    (metric, expected_value, sigma_tol); returns True if all pass."""
    ok = True
    for metric, mean, std in expected:
        actual = results[metric]
        lo, hi = mean - std, mean + std
        passed = lo < actual < hi
        msg = (f"{metric}: {actual:.4f} vs expected {mean:.4f} ± {std:.4f} "
               f"-> {'OK' if passed else 'FAIL'}")
        logger(msg)
        ok &= passed
    return ok


def _iou_xyxy(box: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """Exclusive-coordinate IoU (COCO convention, areas = w*h)."""
    ix1 = np.maximum(box[0], gts[:, 0])
    iy1 = np.maximum(box[1], gts[:, 1])
    ix2 = np.minimum(box[2], gts[:, 2])
    iy2 = np.minimum(box[3], gts[:, 3])
    iw = np.maximum(ix2 - ix1, 0.0)
    ih = np.maximum(iy2 - iy1, 0.0)
    inter = iw * ih
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    return inter / np.maximum(a + b - inter, 1e-9)


COCO_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _coco_ap_single(preds, gts, iou_thresh, area_range, max_dets=100):
    """AP for one class at one IoU threshold with COCO matching rules:
    greedy score-order matching, crowd-free, gts outside the area range
    are 'ignored' (matches don't count as TP or FP)."""
    npos = 0
    gt_by_img = {}
    for img, boxes in gts.items():
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        ignore = ~((areas >= area_range[0]) & (areas < area_range[1]))
        npos += int((~ignore).sum())
        gt_by_img[img] = (boxes, ignore, np.zeros(len(boxes), bool))
    if npos == 0:
        return np.nan

    per_img_count = {}
    rows = []
    for img, score, box in sorted(preds, key=lambda r: -r[1]):
        per_img_count[img] = per_img_count.get(img, 0) + 1
        if per_img_count[img] > max_dets:
            continue
        rows.append((img, score, np.asarray(box, np.float64)))

    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    for i, (img, _score, box) in enumerate(rows):
        boxes, ignore, used = gt_by_img.get(img, (np.zeros((0, 4)),
                                                  np.zeros(0, bool),
                                                  np.zeros(0, bool)))
        if len(boxes) == 0:
            fp[i] = 1
            continue
        ious = _iou_xyxy(box, boxes)
        # prefer non-ignored matches (pycocotools ordering)
        cand = np.where(~used & (ious >= iou_thresh))[0]
        if cand.size == 0:
            fp[i] = 1
            continue
        nonign = cand[~ignore[cand]]
        j = (nonign[np.argmax(ious[nonign])] if nonign.size
             else cand[np.argmax(ious[cand])])
        used[j] = True
        if ignore[j]:
            continue                         # ignored match: neither TP/FP
        tp[i] = 1

    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    rec = ctp / npos
    prec = ctp / np.maximum(ctp + cfp, 1e-9)
    # 101-point interpolation (pycocotools accumulate)
    prec_interp = np.zeros(101)
    if rec.size:
        prec_mono = np.maximum.accumulate(prec[::-1])[::-1]
        rec_points = np.linspace(0, 1, 101)
        idx = np.searchsorted(rec, rec_points, side="left")
        valid = idx < len(prec_mono)
        prec_interp[valid] = prec_mono[idx[valid]]
    return float(prec_interp.mean())


def eval_detection_coco(pred_per_image: Sequence[dict],
                        gt_per_image: Sequence[dict],
                        iou_thresholds: Optional[Sequence[float]] = None,
                        max_dets: int = 100) -> Dict[str, float]:
    """COCO-protocol bbox mAP (the reference's pycocotools path,
    ``evaluation/coco/coco_eval.py``): per-class AP at IoU .50:.95 with
    101-point interpolation, greedy matching, area-range breakdowns.

    Each pred dict: {"boxes" [N,4] xyxy, "scores" [N], "labels" [N]};
    each gt dict: {"boxes", "labels"}. Returns AP, AP50, AP75,
    AP_small/medium/large.
    """
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 0.951, 0.05)
    classes = sorted({int(l) for g in gt_per_image
                      for l in np.asarray(g["labels"]).tolist()})

    def collect(cls):
        preds, gts = [], {}
        for img, (p, g) in enumerate(zip(pred_per_image, gt_per_image)):
            pb = np.asarray(p["boxes"], np.float64).reshape(-1, 4)
            pl = np.asarray(p["labels"]).reshape(-1)
            ps = np.asarray(p["scores"]).reshape(-1)
            for b, s in zip(pb[pl == cls], ps[pl == cls]):
                preds.append((img, float(s), b))
            gb = np.asarray(g["boxes"], np.float64).reshape(-1, 4)
            gl = np.asarray(g["labels"]).reshape(-1)
            gts[img] = gb[gl == cls]
        return preds, gts

    out = {}
    for area_name, area_range in COCO_AREA_RANGES.items():
        aps = []
        for cls in classes:
            preds, gts = collect(cls)
            vals = [_coco_ap_single(preds, gts, t, area_range, max_dets)
                    for t in iou_thresholds]
            vals = [v for v in vals if not np.isnan(v)]
            if vals:
                aps.append(np.mean(vals))
        key = "AP" if area_name == "all" else f"AP_{area_name}"
        out[key] = float(np.mean(aps)) if aps else float("nan")

    ap50, ap75 = [], []
    for cls in classes:
        preds, gts = collect(cls)
        v50 = _coco_ap_single(preds, gts, 0.5, COCO_AREA_RANGES["all"],
                              max_dets)
        v75 = _coco_ap_single(preds, gts, 0.75, COCO_AREA_RANGES["all"],
                              max_dets)
        if not np.isnan(v50):
            ap50.append(v50)
        if not np.isnan(v75):
            ap75.append(v75)
    out["AP50"] = float(np.mean(ap50)) if ap50 else float("nan")
    out["AP75"] = float(np.mean(ap75)) if ap75 else float("nan")
    return out
