"""Scene-graph triplet evaluation — VG recall@K (both conventions) + OI-VRD.

The port's copy of ``cpt_tpu/engine/sg_eval.py`` (numpy only; its code is
the original's, held so by ``tests/test_torch_isolation.py``).

Host-side metric package reproducing
``prompt_feat/maskrcnn_benchmark/data/datasets/evaluation/sg/``
(``evaluator.py`` — the Rowan-Zellers/neural-motifs protocol;
``sg_tsv_eval.py`` — the Danfei-Xu/IMP protocol) and
``evaluation/openimages_vrd/`` (triplet/phrase AP + recall@50).

Conventions preserved exactly:

* the motifs evaluator matches triplets with INCLUSIVE (+1) IoU
  (``sg/box.py:bbox_overlaps``) and unions matched GT indices over the
  top-K score-sorted predictions;
* the IMP evaluator derives GT relations from the N×N predicate matrix,
  casts triplet boxes to int32 (``sg_tsv_eval.py:236``), takes top
  min(K, #rels) by triplet score, and counts each GT triplet once;
* OI-VRD uses EXCLUSIVE-area IoU (``eval_utils.py:IoU``), per-class
  greedy TP assignment on min(subject IoU, object IoU) (triplet) or the
  union/phrase box, then VOC-style interpolated AP and Recall@50 over
  per-image score-sorted detections.
"""
from __future__ import annotations

from collections import defaultdict
from functools import reduce
from typing import Dict, List, Optional, Sequence

import numpy as np

MODES = ("sgdet", "sgcls", "predcls")
TOP_KS = (20, 50, 100)


def iou_inclusive(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4]×[K,4] → [N,K] IoU with +1 widths (sg/box.py:6-35)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]) + 1, 0, None)
    ih = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]) + 1, 0, None)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None] - inter)


def intersect_2d(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """[m1,n]×[m2,n] → [m1,m2] row-equality (evaluator.py:284-297)."""
    if x1.shape[1] != x2.shape[1]:
        raise ValueError("Input arrays must have same #columns")
    return (x1[..., None] == x2.T[None, ...]).all(1)


def argsort_desc(scores: np.ndarray) -> np.ndarray:
    """Indices sorting a (possibly 2-D) score array descending
    (evaluator.py:300-308)."""
    return np.column_stack(
        np.unravel_index(np.argsort(-scores.ravel()), scores.shape))


def _triplet(predicates, relations, classes, boxes,
             predicate_scores=None, class_scores=None):
    """(evaluator.py:222-252): rows (subj_cls, predicate, obj_cls) +
    concat subject/object boxes (+ per-part scores when given)."""
    sub_ob = classes[relations[:, :2]]
    triplets = np.column_stack((sub_ob[:, 0], predicates, sub_ob[:, 1]))
    triplet_boxes = np.column_stack((boxes[relations[:, 0]],
                                     boxes[relations[:, 1]]))
    triplet_scores = None
    if predicate_scores is not None and class_scores is not None:
        triplet_scores = np.column_stack((
            class_scores[relations[:, 0]],
            class_scores[relations[:, 1]],
            predicate_scores))
    return triplets, triplet_boxes, triplet_scores


def _compute_pred_matches(gt_triplets, pred_triplets, gt_boxes, pred_boxes,
                          iou_thresh: float, phrdet: bool = False
                          ) -> List[List[int]]:
    """Per-prediction list of matching GT indices (evaluator.py:255-281)."""
    keeps = intersect_2d(gt_triplets, pred_triplets)
    gt_has_match = keeps.any(1)
    pred_to_gt: List[List[int]] = [[] for _ in range(pred_boxes.shape[0])]
    for gt_ind, gt_box, keep_inds in zip(np.where(gt_has_match)[0],
                                         gt_boxes[gt_has_match],
                                         keeps[gt_has_match]):
        boxes = pred_boxes[keep_inds]
        if phrdet:
            gt_u = gt_box.reshape(2, 4)
            gt_u = np.concatenate((gt_u.min(0)[:2], gt_u.max(0)[2:]), 0)
            bu = boxes.reshape(-1, 2, 4)
            bu = np.concatenate((bu.min(1)[:, :2], bu.max(1)[:, 2:]), 1)
            inds = iou_inclusive(gt_u[None], bu)[0] >= iou_thresh
        else:
            sub_iou = iou_inclusive(gt_box[None, :4], boxes[:, :4])[0]
            obj_iou = iou_inclusive(gt_box[None, 4:], boxes[:, 4:])[0]
            inds = (sub_iou >= iou_thresh) & (obj_iou >= iou_thresh)
        for i in np.where(keep_inds)[0][inds]:
            pred_to_gt[i].append(int(gt_ind))
    return pred_to_gt


def evaluate_recall(gt_rels, gt_boxes, gt_classes, pred_rels, pred_boxes,
                    pred_classes, rel_scores=None, cls_scores=None,
                    iou_thresh: float = 0.5, phrdet: bool = False):
    """(evaluator.py:153-219)."""
    if pred_rels.size == 0:
        return [[]], np.zeros((0, 5)), np.zeros(0)
    assert gt_rels.shape[0] != 0
    gt_triplets, gt_triplet_boxes, _ = _triplet(
        gt_rels[:, 2], gt_rels[:, :2], gt_classes, gt_boxes)
    assert pred_rels[:, :2].max() < pred_classes.shape[0]
    assert np.all(pred_rels[:, 2] > 0)
    pred_triplets, pred_triplet_boxes, relation_scores = _triplet(
        pred_rels[:, 2], pred_rels[:, :2], pred_classes, pred_boxes,
        rel_scores, cls_scores)
    sorted_inds = np.argsort(relation_scores.prod(1))[::-1]
    pred_to_gt = _compute_pred_matches(
        gt_triplets, pred_triplets[sorted_inds], gt_triplet_boxes,
        pred_triplet_boxes[sorted_inds], iou_thresh, phrdet=phrdet)
    pred_5ples = np.column_stack((pred_rels[:, :2],
                                  pred_triplets[:, [0, 2, 1]]))
    return pred_to_gt, pred_5ples, relation_scores


class SceneGraphEvaluator:
    """The neural-motifs protocol (evaluator.py:13-44): recall@{20,50,100}
    per mode, accumulated over entries."""

    def __init__(self, mode: str, multiple_preds: bool = False):
        assert mode in MODES + ("phrdet", "preddet")
        self.mode = mode
        self.multiple_preds = multiple_preds
        self.result_dict = {mode + "_recall": {k: [] for k in TOP_KS}}

    @classmethod
    def all_modes(cls, **kw):
        return {m: cls(mode=m, **kw) for m in MODES}

    @classmethod
    def vrd_modes(cls, **kw):
        return {m: cls(mode=m, multiple_preds=True, **kw)
                for m in ("preddet", "phrdet")}

    def evaluate_scene_graph_entry(self, gt_entry, pred_entry,
                                   iou_thresh: float = 0.5):
        return evaluate_from_dict(gt_entry, pred_entry, self.mode,
                                  self.result_dict, iou_thresh=iou_thresh,
                                  multiple_preds=self.multiple_preds)

    def means(self) -> Dict[int, float]:
        return {k: float(np.mean(v)) if v else 0.0
                for k, v in self.result_dict[self.mode + "_recall"].items()}


def evaluate_from_dict(gt_entry, pred_entry, mode, result_dict,
                       multiple_preds: bool = False, iou_thresh: float = 0.5):
    """(evaluator.py:47-129)."""
    gt_rels = np.asarray(gt_entry["gt_relations"])
    gt_boxes = np.asarray(gt_entry["gt_boxes"], float)
    gt_classes = np.asarray(gt_entry["gt_classes"])
    pred_rel_inds = np.asarray(pred_entry["pred_rel_inds"])
    rel_scores = np.asarray(pred_entry["rel_scores"])

    if len(pred_rel_inds) == 0:
        for k in result_dict[mode + "_recall"]:
            result_dict[mode + "_recall"][k].append(0)
        return None

    if mode == "predcls":
        pred_boxes, pred_classes = gt_boxes, gt_classes
        obj_scores = np.ones(gt_classes.shape[0])
    elif mode == "sgcls":
        pred_boxes = gt_boxes
        pred_classes = np.asarray(pred_entry["pred_classes"])
        obj_scores = np.asarray(pred_entry["obj_scores"])
    elif mode in ("sgdet", "phrdet"):
        pred_boxes = np.asarray(pred_entry["pred_boxes"], float)
        pred_classes = np.asarray(pred_entry["pred_classes"])
        obj_scores = np.asarray(pred_entry["obj_scores"])
    elif mode == "preddet":
        prc = intersect_2d(pred_rel_inds, gt_rels[:, :2])
        if prc.size == 0:
            for k in result_dict[mode + "_recall"]:
                result_dict[mode + "_recall"][k].append(0.0)
            return None
        pred_inds_per_gt = prc.argmax(0)
        pred_rel_inds = pred_rel_inds[pred_inds_per_gt]
        rel_scores = rel_scores[pred_inds_per_gt]
        sorted_ = argsort_desc(rel_scores[:, 1:])
        sorted_[:, 1] += 1
        sorted_ = np.column_stack((pred_rel_inds[sorted_[:, 0]],
                                   sorted_[:, 1]))
        matches = intersect_2d(sorted_, gt_rels)
        for k in result_dict[mode + "_recall"]:
            rec = float(matches[:k].any(0).sum()) / float(gt_rels.shape[0])
            result_dict[mode + "_recall"][k].append(rec)
        return None
    else:
        raise ValueError(f"invalid mode {mode}")

    if multiple_preds:
        obj_scores_per_rel = obj_scores[pred_rel_inds].prod(1)
        overall = obj_scores_per_rel[:, None] * rel_scores[:, 1:]
        score_inds = argsort_desc(overall)[:100]
        pred_rels = np.column_stack((pred_rel_inds[score_inds[:, 0]],
                                     score_inds[:, 1] + 1))
        predicate_scores = rel_scores[score_inds[:, 0], score_inds[:, 1] + 1]
    else:
        pred_rels = np.column_stack((pred_rel_inds,
                                     1 + rel_scores[:, 1:].argmax(1)))
        predicate_scores = rel_scores[:, 1:].max(1)

    pred_to_gt, pred_5ples, _ = evaluate_recall(
        gt_rels, gt_boxes, gt_classes, pred_rels, pred_boxes, pred_classes,
        predicate_scores, obj_scores, iou_thresh=iou_thresh,
        phrdet=mode == "phrdet")
    for k in result_dict[mode + "_recall"]:
        match = reduce(np.union1d, pred_to_gt[:k]) if pred_to_gt else []
        result_dict[mode + "_recall"][k].append(
            float(len(match)) / float(gt_rels.shape[0]))
    return pred_to_gt


# ---------------------------------------------------------------- IMP metric

def evaluate_danfei(gt_classes, gt_boxes, gt_pred_matrix, pred_boxes,
                    obj_scores, obj_labels, rel_inds, rel_scores_all,
                    result_dict, mode: str = "sgdet",
                    iou_thresh: float = 0.5) -> None:
    """The Danfei-Xu/IMP recall (``sg_tsv_eval.py:101-225``): GT relations
    from the N×N predicate matrix, top-min(K, #rels) predictions by
    triplet score, int32 triplet boxes, one credit per GT triplet."""
    gt_pred_matrix = np.asarray(gt_pred_matrix)
    if (gt_pred_matrix != 0).sum() == 0:
        return
    if len(rel_inds) == 0:
        for k in result_dict[mode + "_recall"]:
            result_dict[mode + "_recall"][k].append(0)
        return

    gt_boxes = np.asarray(gt_boxes)
    gt_relations = np.column_stack(np.nonzero(gt_pred_matrix))
    gt_pred_labels = gt_pred_matrix[gt_pred_matrix != 0].reshape(-1)
    gt_classes = np.asarray(gt_classes).reshape(-1)
    n_gt = gt_relations.shape[0]
    if n_gt == 0:
        return
    gt_trip, gt_trip_boxes, _ = _danfei_triplet(
        gt_pred_labels, gt_relations, gt_classes, gt_boxes,
        np.ones(n_gt), np.ones(len(gt_boxes)))

    preds = np.asarray(rel_scores_all)[:, 1:]
    predicates = preds.argmax(1).ravel() + 1
    predicate_scores = preds.max(1).ravel()
    relations = np.asarray(rel_inds)
    if mode == "predcls":
        classes, class_scores, boxes = (gt_classes,
                                        np.ones(len(gt_boxes)), gt_boxes)
    elif mode == "sgcls":
        classes = np.asarray(obj_labels)
        class_scores = np.asarray(obj_scores)
        boxes = gt_boxes
    elif mode in ("sgdet", "sgdet+"):
        classes = np.asarray(obj_labels)
        class_scores = np.asarray(obj_scores)
        boxes = np.asarray(pred_boxes)
    else:
        raise NotImplementedError(mode)

    pred_trip, pred_trip_boxes, rel_sc = _danfei_triplet(
        predicates, relations, classes, boxes, predicate_scores,
        class_scores)
    sorted_inds = np.argsort(rel_sc)[::-1]
    for k in result_dict[mode + "_recall"]:
        keep = sorted_inds[: min(k, relations.shape[0])]
        recall = _relation_recall(gt_trip, pred_trip[keep],
                                  gt_trip_boxes, pred_trip_boxes[keep],
                                  iou_thresh)
        result_dict[mode + "_recall"][k].append(recall / gt_trip.shape[0])


def _danfei_triplet(predicates, relations, classes, boxes,
                    predicate_scores, class_scores):
    """(sg_tsv_eval.py:228-259) — note the int32 box cast."""
    predicates = np.asarray(predicates).reshape(-1)
    n = relations.shape[0]
    triplets = np.zeros((n, 3), np.int32)
    triplet_boxes = np.zeros((n, 8), np.int32)
    triplet_scores = np.zeros((n,), np.float32)
    classes = np.asarray(classes).reshape(-1)
    for i in range(n):
        s, o = relations[i, :2]
        triplets[i] = (classes[s], predicates[i], classes[o])
        triplet_boxes[i, :4] = boxes[s]
        triplet_boxes[i, 4:] = boxes[o]
        triplet_scores[i] = (class_scores[s] * class_scores[o]
                             * predicate_scores[i])
    return triplets, triplet_boxes, triplet_scores


def _relation_recall(gt_triplets, pred_triplets, gt_boxes, pred_boxes,
                     iou_thresh) -> float:
    """(sg_tsv_eval.py:262-281): one credit per GT triplet."""
    n_correct = 0
    for gt, gt_box in zip(gt_triplets, gt_boxes):
        keep = (pred_triplets == gt[None]).all(1)
        if not keep.any():
            continue
        boxes = pred_boxes[keep]
        sub_iou = iou_inclusive(gt_box[None, :4], boxes[:, :4])[0]
        obj_iou = iou_inclusive(gt_box[None, 4:], boxes[:, 4:])[0]
        if ((sub_iou >= iou_thresh) & (obj_iou >= iou_thresh)).any():
            n_correct += 1
    return float(n_correct)


def do_sg_evaluation(entries) -> Dict[str, Dict[str, float]]:
    """Full VG SG eval over (gt_entry, pred_entry) pairs — both protocols,
    sgdet mode (``sg_tsv_eval.py:14-99``). ``gt_entry`` needs gt_classes /
    gt_boxes / gt_relations / pred_label_matrix; ``pred_entry`` needs
    pred_boxes / pred_classes / obj_scores / pred_rel_inds / rel_scores
    (full [R, P+1] including background column)."""
    mode = "sgdet"
    rowan = SceneGraphEvaluator(mode)
    danfei_dict = {mode + "_recall": {k: [] for k in TOP_KS}}
    for gt_entry, pred_entry in entries:
        rel_scores = np.asarray(pred_entry["rel_scores"])
        rel_inds = np.asarray(pred_entry["pred_rel_inds"])
        obj_scores = np.asarray(pred_entry["obj_scores"])
        if len(rel_inds):
            # sgdet ordering: (s_score · o_score · best predicate) desc,
            # zero-score rows dropped (sg_tsv_eval.py:56-64)
            scores = (obj_scores[rel_inds[:, 0]] * obj_scores[rel_inds[:, 1]]
                      * rel_scores[:, 1:].max(1))
            order = np.argsort(-scores)
            order = order[scores[order] > 0]
            pred_sorted = dict(pred_entry,
                               pred_rel_inds=rel_inds[order],
                               rel_scores=rel_scores[order])
        else:
            pred_sorted = pred_entry
        rowan.evaluate_scene_graph_entry(gt_entry, pred_sorted)
        evaluate_danfei(gt_entry["gt_classes"], gt_entry["gt_boxes"],
                        gt_entry["pred_label_matrix"],
                        pred_entry.get("pred_boxes", np.zeros((0, 4))),
                        obj_scores, pred_entry.get("pred_classes", []),
                        rel_inds, rel_scores, danfei_dict, mode)
    return {
        "rowan_metric": {f"{mode}{k}": v for k, v in rowan.means().items()},
        "danfei_metric": {
            f"{mode}{k}": float(np.mean(v)) if v else 0.0
            for k, v in danfei_dict[mode + "_recall"].items()},
    }


# ------------------------------------------------------------------ OI-VRD

def iou_exclusive(rc1, rc2) -> float:
    """Scalar IoU with exclusive areas (openimages eval_utils.py:13-20)."""
    ix1, iy1 = max(rc1[0], rc2[0]), max(rc1[1], rc2[1])
    ix2, iy2 = min(rc1[2], rc2[2]), min(rc1[3], rc2[3])
    if ix2 > ix1 and iy2 > iy1:
        inter = (ix2 - ix1) * (iy2 - iy1)
        a1 = (rc1[2] - rc1[0]) * (rc1[3] - rc1[1])
        a2 = (rc2[2] - rc2[0]) * (rc2[3] - rc2[1])
        return inter / (a1 + a2 - inter)
    return 0.0


def compute_precision_recall(scores, labels, num_gt):
    """(eval_utils.py:60-74)."""
    assert np.sum(labels) <= num_gt
    order = np.argsort(scores)[::-1]
    tp = labels[order]
    fp = (tp <= 0).astype(float)
    cum_tp, cum_fp = np.cumsum(tp), np.cumsum(fp)
    return cum_tp / (cum_tp + cum_fp), cum_tp / num_gt


def compute_average_precision(precision, recall):
    """VOC-interpolated AP (eval_utils.py:77-97)."""
    if not precision.size:
        return 0.0
    rec = np.concatenate([[0], recall, [1]])
    prec = np.concatenate([[0], precision, [0]])
    for i in range(len(prec) - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    idx = np.where(rec[1:] != rec[:-1])[0] + 1
    return float(np.sum((rec[idx] - rec[idx - 1]) * prec[idx]))


def compute_recall_at_k(tp_fp_list, num_gt, k):
    """(eval_utils.py:100-116)."""
    vals = [np.asarray(t)[: min(k, len(t))] for t in tp_fp_list]
    return float(np.sum(np.concatenate(vals)) / num_gt) if vals else 0.0


def eval_per_class(c_dets, c_truths, overlap_thresh=0.5, eval_phrase=False):
    """Per-triplet-class greedy TP assignment
    (openimages_vrd_eval.py:95-175). Detections: {img_key: [{"score",
    "subject_rect", "object_rect"} or {"score", "rect"}]}."""
    num_gt_all = sum(len(v) for v in c_truths.values())
    scores_all, tp_fp_all, img_keys = [], [], []
    for key, img_det in c_dets.items():
        img_keys.append(key)
        scores = np.array([d["score"] for d in img_det])
        tp_fp = np.zeros(len(img_det), dtype=bool)
        if key not in c_truths or (len(scores) and all(scores < 0)):
            scores_all.append(scores)
            tp_fp_all.append(tp_fp)
            continue
        img_gt = c_truths[key]
        if eval_phrase:
            ious = np.array([[iou_exclusive(d["rect"], g["rect"])
                              for g in img_gt] for d in img_det])
        else:
            ious = np.array(
                [[min(iou_exclusive(d["subject_rect"], g["subject_rect"]),
                      iou_exclusive(d["object_rect"], g["object_rect"]))
                  for g in img_gt] for d in img_det])
        if ious.size and ious.shape[1] > 0:
            best_gt = ious.argmax(1)
            gt_used = np.zeros(ious.shape[1], dtype=bool)
            for i in range(len(img_det)):
                g = best_gt[i]
                if ious[i, g] >= overlap_thresh and not gt_used[g]:
                    tp_fp[i] = True
                    gt_used[g] = True
        scores_all.append(scores)
        tp_fp_all.append(tp_fp)
    return scores_all, tp_fp_all, num_gt_all, img_keys


def openimages_vrd_relation_eval(gt_dict, pred_dict, eval_phrase=False
                                 ) -> Dict[str, float]:
    """Triplet (or phrase) mAP/weighted-mAP/Recall@50 over
    {(subj_cls, obj_cls, predicate): {img_key: [entries]}} dicts
    (openimages_vrd_eval.py:38-93)."""
    scores_per_class = defaultdict(list)
    tp_fp_per_class = defaultdict(list)
    num_gt_per_class = defaultdict(int)
    scores_per_img = defaultdict(list)
    tp_fp_per_img = defaultdict(list)
    for cls in set(gt_dict) | set(pred_dict):
        scores, tp_fp, num_gt, keys = eval_per_class(
            pred_dict.get(cls, {}), gt_dict.get(cls, {}),
            eval_phrase=eval_phrase)
        scores_per_class[cls[2]] += scores
        tp_fp_per_class[cls[2]] += tp_fp
        num_gt_per_class[cls[2]] += num_gt
        if not eval_phrase:
            for key, s, t in zip(keys, scores, tp_fp):
                scores_per_img[key] += s.tolist()
                tp_fp_per_img[key] += t.tolist()

    class_ap = {}
    for cls, chunks in scores_per_class.items():
        if num_gt_per_class[cls] == 0 or not chunks:
            continue
        scores = np.concatenate(chunks)
        if not scores.size:
            continue
        tp_fp = np.concatenate(tp_fp_per_class[cls])
        p, r = compute_precision_recall(scores, tp_fp,
                                        num_gt_per_class[cls])
        class_ap[cls] = compute_average_precision(p, r)
    if not class_ap:
        return {"map": 0.0, "weighted_map": 0.0, "recall@50": 0.0}
    total_gt = sum(num_gt_per_class.values())
    out = {
        "map": sum(class_ap.values()) / len(class_ap),
        "weighted_map": sum(class_ap[c] * num_gt_per_class[c]
                            for c in class_ap) / total_gt,
        "categories": class_ap,
    }
    if not eval_phrase:
        ordered = []
        for key in tp_fp_per_img:
            pairs = sorted(zip(scores_per_img[key], tp_fp_per_img[key]),
                           key=lambda x: x[0], reverse=True)
            ordered.append(np.asarray([t for _, t in pairs]))
        out["recall@50"] = compute_recall_at_k(ordered, total_gt, k=50)
    return out
