"""Scene-graph inference → sg_eval entries (port of
``cpt_tpu/engine/sg_infer.py``; the reference's ``test_sg_net.py`` →
``do_sg_evaluation`` path, ``sg_tsv_eval.py:14-99``): per image, the
detector's kept detections become pred_boxes / classes / obj_scores and the
relation head's pair logits become ``rel_scores`` rows (softmax over the
predicates, background column included).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cpt_tpu_torch.engine.sg_eval import do_sg_evaluation


def sg_pred_entry(out: Dict) -> Dict[str, np.ndarray]:
    """SceneParser inference dict (numpy leaves) → sg_eval pred_entry."""
    k = np.asarray(out["pairs"]).max() + 1 if len(out["pairs"]) else 0
    keep = np.asarray(out["pair_valid"])
    logits = np.asarray(out["rel_logits"], np.float32)
    ex = np.exp(logits - logits.max(-1, keepdims=True))
    probs = ex / ex.sum(-1, keepdims=True)
    return {
        "pred_boxes": np.asarray(out["boxes"])[:k],
        "pred_classes": np.asarray(out["labels"])[:k],
        "obj_scores": np.asarray(out["scores"])[:k],
        "pred_rel_inds": np.asarray(out["pairs"])[keep],
        "rel_scores": probs[keep],
    }


def sg_gt_entry(target: Dict) -> Dict[str, np.ndarray]:
    """VGTSVDataset target → sg_eval gt_entry."""
    return {
        "gt_boxes": np.asarray(target["boxes"], float),
        "gt_classes": np.asarray(target["labels"]),
        "gt_relations": np.asarray(target["relation_triplets"], int),
        "pred_label_matrix": np.asarray(target["pred_labels"]),
    }


@torch.inference_mode()
def scene_graph_entries(model, dataset, anchors: torch.Tensor,
                        canvas_hw: Sequence[int],
                        freq_prior: Optional[torch.Tensor] = None) -> list:
    """(gt_entry, pred_entry) of every image of ``dataset`` (a
    ``VGTSVDataset``) that has relations: the image on the zero canvas
    ``canvas_hw`` as it is (no mean subtraction, as the JAX package hands
    it), ``model`` (a ``SceneParser``) on its device. Images without
    relations are skipped, as in JAX."""
    h, w = canvas_hw
    device = next(model.parameters()).device
    entries = []
    for i in range(len(dataset)):
        img, target, _ = dataset[i]
        if target is None or not len(target.get("relation_triplets", [])):
            continue
        canvas = np.zeros((h, w, 3), np.float32)
        ih, iw = img.shape[:2]
        canvas[:min(ih, h), :min(iw, w)] = img[:h, :w]
        out = model(torch.from_numpy(canvas).to(device),
                    (min(ih, h), min(iw, w)), anchors, freq_prior)
        host = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                for k, v in out.items()}
        entries.append((sg_gt_entry(target), sg_pred_entry(host)))
    return entries


def evaluate_scene_graphs(model, dataset, anchors: torch.Tensor,
                          canvas_hw: Sequence[int],
                          freq_prior: Optional[torch.Tensor] = None
                          ) -> Dict[str, Dict[str, float]]:
    """Run ``model`` (a ``SceneParser``) over a VG-TSV dataset and evaluate
    both SG recall protocols (reference ``test_sg_net.py`` inference +
    ``do_sg_evaluation``)."""
    return do_sg_evaluation(scene_graph_entries(model, dataset, anchors,
                                                canvas_hw, freq_prior))
