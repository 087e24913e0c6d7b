"""Evaluation and reporting utilities (the port's copy of
``cpt_tpu/engine/evaluate.py``).

Numpy ports of the reference eval harnesses:
  * ``vg_recall_eval`` — relation R@20/50/100 + mean-recall
    (``Oscar/oscar/utils/vg_eval.py:8-61`` / ``eval/vg/eval_vg.py:15-71``)
  * ``seed_sweep_report`` — mean±std over the 5-seed protocol
    (``Oscar/eval/refcoco/fewshot_eval.py:17-44``)
  * ``ensemble_logits`` — the GQA pt·3 + cpt·1 logit ensemble
    (``Oscar/eval/gqa/show_ensemble_results.py:10-21``, ``show.sh:9``)
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Mapping, Sequence

import numpy as np


def _softmax(x: np.ndarray, axis=-1) -> np.ndarray:
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def imkey2pair(imkey: str) -> List[int]:
    return [int(x) for x in imkey.split("_")[-2:]]


def vg_recall_eval(preds: Mapping[str, np.ndarray], gts: Sequence[dict],
                   *, apply_softmax: bool = True,
                   num_classes: int = 51) -> Dict[str, float]:
    """preds: {"<img>.jpg_<s>_<o>": logits [num_classes]}, gts: list of
    {"img_path": ..., "relations": np.ndarray [R, 3] (s, o, predicate)}.

    Returns {"R@20": ..., "R@50": ..., "R@100": ..., "mR@20": ...} ×100.
    """
    new_preds: Dict[str, List[dict]] = {}
    for imkey, prd in preds.items():
        img_name = imkey.split(".jpg")[0] + ".jpg"
        new_preds.setdefault(img_name, []).append(
            {"pair": imkey2pair(imkey), "pred": np.asarray(prd, np.float32)})
    for g in gts:
        if g["img_path"] not in new_preds:
            new_preds[g["img_path"]] = [
                {"pair": [0, 0], "pred": np.zeros(num_classes, np.float32)}]
    gts = [g for g in gts if g["img_path"] in new_preds]
    pred_lists = [new_preds[g["img_path"]] for g in gts]

    recall = {20: [], 50: [], 100: []}
    mrecall = {k: [[] for _ in range(num_classes)] for k in (20, 50, 100)}

    for p_list, gt in zip(pred_lists, gts):
        pairs = np.asarray([p["pair"] for p in p_list])
        prds = np.stack([p["pred"] for p in p_list])
        if apply_softmax:
            prds = _softmax(prds, axis=1)
            # reference's cross-version tie-break nudge (eval_vg.py:41-43)
            if prds.shape[1] > 49 and np.all(prds[:, 48] == prds[:, 49]):
                prds[:, 49] += 1e-5
        rels = prds[:, 1:].argmax(1) + 1
        scores = prds[np.arange(len(prds)), rels]
        order = np.argsort(-scores, kind="stable")
        triplets = np.concatenate(
            [pairs[order], rels[order][:, None]], axis=-1)   # [P, 3]

        gt_rels = np.asarray(gt["relations"])
        for mode in recall:
            pred_rels = triplets[:mode]
            hit = (gt_rels[:, :, None] == pred_rels.T[None]).all(1).any(1)
            recall[mode].append(hit.sum() / float(len(gt_rels)))
            cnt = Counter(gt_rels[:, 2].tolist())
            per_rel: Dict[int, int] = {}
            for r, c in zip(gt_rels[:, 2].tolist(), hit):
                per_rel[r] = per_rel.get(r, 0) + int(c)
            for r in per_rel:
                mrecall[mode][r].append(per_rel[r] / cnt[r])

    out = {}
    for mode in (20, 50, 100):
        out[f"R@{mode}"] = 100.0 * float(np.mean(recall[mode]))
        out[f"mR@{mode}"] = 100.0 * float(np.mean(
            [np.mean(v) if v else 0.0 for v in mrecall[mode][1:]]))
    return out


def seed_sweep_report(results: Mapping[int, Mapping[int, float]]) -> str:
    """{n_shot: {seed: accuracy}} → per-shot "mean±std" lines (the 5-seed
    protocol of ``fewshot_eval.py``)."""
    lines = []
    for shot in sorted(results):
        vals = np.asarray(list(results[shot].values()), np.float64)
        lines.append(f"shot {shot}: {vals.mean():.2f} ± {vals.std():.2f} "
                     f"(n={len(vals)})")
    return "\n".join(lines)


def ensemble_logits(pt_scores: np.ndarray, cpt_scores: np.ndarray,
                    pt_weight: float = 3.0, cpt_weight: float = 1.0
                    ) -> np.ndarray:
    """GQA prompt-tuning ensemble: argmax(pt·3 + cpt·1)."""
    return pt_weight * np.asarray(pt_scores) + cpt_weight * np.asarray(cpt_scores)
