"""Color-word scoring for RefCOCO grounding (port of the RefCOCO parts of
``cpt_tpu/engine/scoring.py``).

Device side: one forward returning the MLM logits at each sequence's
[MASK]. Host side: the reference decision rule
(``Oscar/oscar/fewshot/refcoco_cpt.py:258-315``): per copy,
score = logits[mask, color] / logits[mask, "none"]; the argmax over all
copies of a query picks the box; accuracy = IoU(pred, gt) > 0.5.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cpt_tpu_torch.data.refcoco import FlatBatch, RefcocoCPTData, iter_eval_batches
from cpt_tpu_torch.structures.boxes import xywh_iou
from cpt_tpu_torch.utils.tokenization import BertTokenizer


def make_mlm_at_mask_fn(model) -> Callable:
    """fn(input_ids, segment_ids, attention_mask, img_feats, mask_pos), numpy
    in → float32 [N, vocab] numpy logits at each sequence's mask position.
    The vocab projection runs only at the gathered positions."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def fn(input_ids, segment_ids, attention_mask, img_feats, mask_pos):
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        _, at_mask = model(dev(input_ids), dev(segment_ids),
                           dev(attention_mask), img_feats=dev(img_feats),
                           mask_pos=dev(mask_pos))
        return at_mask.float().cpu().numpy()

    return fn


def run_mlm_batch(fn, batch: FlatBatch) -> np.ndarray:
    t = batch.tensors
    return fn(t.input_ids, t.segment_ids, t.attention_mask, t.img_feats,
              t.mask_pos)


def refcoco_collect_scores(at_mask: np.ndarray, batch: FlatBatch,
                           tokenizer: BertTokenizer
                           ) -> Dict[int, Tuple[List[float], List[List[float]]]]:
    """Group the color/none ratio scores per example index:
    {example idx in batch: (scores, rects)}, scores parallel to the
    flattened candidate rect list."""
    none_id = tokenizer.convert_tokens_to_ids("none")
    grouped: Dict[int, Tuple[List[float], List[List[float]]]] = {}
    for slot, (ex_i, _copy_i) in enumerate(batch.slot_meta):
        color_ids = tokenizer.convert_tokens_to_ids(batch.slot_colors[slot])
        ratios = at_mask[slot, color_ids] / at_mask[slot, none_id]
        scores, rects = grouped.setdefault(ex_i, ([], []))
        scores.extend(float(r) for r in ratios)
        rects.extend(batch.slot_rects[slot])
    return grouped


def refcoco_evaluate(model, data: RefcocoCPTData, tokenizer: BertTokenizer,
                     batch_size: int = 128,
                     indices: Optional[List[int]] = None
                     ) -> Tuple[float, Dict[str, List[float]]]:
    """Zero-shot RefCOCO grounding eval → (accuracy·100, {query: box})."""
    fn = make_mlm_at_mask_fn(model)
    predictions: Dict[str, List[float]] = {}
    n_correct, n_total = 0, 0
    for batch, examples in iter_eval_batches(data, batch_size, indices):
        grouped = refcoco_collect_scores(run_mlm_batch(fn, batch), batch,
                                         tokenizer)
        for ex_i, (scores, rects) in grouped.items():
            ex = examples[ex_i]
            pred = rects[int(np.argmax(scores))]
            predictions[ex.img_key] = pred
            if ex.gt_bbox is not None:
                pred_xywh = [pred[0], pred[1], pred[2] - pred[0] + 1,
                             pred[3] - pred[1] + 1]
                n_correct += xywh_iou(pred_xywh, ex.gt_bbox) > 0.5
                n_total += 1
    return 100.0 * n_correct / max(n_total, 1), predictions
