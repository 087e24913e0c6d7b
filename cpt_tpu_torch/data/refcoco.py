"""RefCOCO CPT grounding dataset, stage 2 (port of
``cpt_tpu/data/refcoco.py``).

Reads the stage-1 interchange TSV (``predictions.tsv``: one row per query,
json payload ``[objects, caption, colors, rect_lists]``), the annotation
json (gt bbox per query id) and the od-label json. Faithful to reference
``Oscar/oscar/datasets/refcoco_fsl_cpt_dataset.py``:

  * prompt ``"<caption> is in [MASK] color."`` (or a zero-shot template,
    ``zsl_template`` 1-6); text_b = od-labels with the copy's color word
    before the colored object
  * gt per copy = the color of the candidate with IoU > 0.5 against the gt
    box, else "none" (``:81-94``)
  * training slot sampling: every positive copy (one when the dataset has
    16 queries) and as many random negatives (``:96-118``), drawn from a
    ``random.Random`` in the JAX package's order

Each query expands into one sub-sequence per colored copy; batches are flat
over sub-sequences with host bookkeeping to regroup scores per query.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from cpt_tpu_torch.data import prompts
from cpt_tpu_torch.data.tensorize import TensorizedBatch, TensorizedSeq, stack_batch, tensorize_pair
from cpt_tpu_torch.structures.boxes import xywh_iou
from cpt_tpu_torch.utils.tokenization import BertTokenizer
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


@dataclasses.dataclass
class RefcocoExample:
    """One grounding query, expanded into per-copy sub-sequences."""

    img_key: str
    seqs: List[TensorizedSeq]
    feats: List[np.ndarray]            # per copy [n_boxes, D]
    colors: List[List[str]]            # per copy color-name set
    rects: List[List[List[float]]]     # per copy candidate boxes (xyxy)
    gt_color_ids: List[int]            # per copy gt color token id (or "none")
    gt_bbox: Optional[List[float]]     # xywh gt (None at pure test time)


def _xyxy_to_xywh(rect: Sequence[float]) -> List[float]:
    return [rect[0], rect[1], rect[2] - rect[0] + 1, rect[3] - rect[1] + 1]


class RefcocoCPTData:
    def __init__(self, data_file: str, ann_file: str, det_file: str,
                 tokenizer: BertTokenizer, txt_seq_len: int = 70,
                 img_seq_len: int = 50, img_feat_dim: int = 2054,
                 zsl_template: Optional[int] = None,
                 soft_slots: Optional[Tuple[int, int]] = None):
        self.tsv = TSVFile(data_file)
        self.tokenizer = tokenizer
        self.txt_seq_len = txt_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim
        # zero-shot template variant 1-6 (reference
        # refcoco_zsl_cpt_dataset.py); None = the few-shot template
        self.zsl_template = zsl_template
        # (n_pre, n_post) learnable [unusedN] slots around [MASK] — the
        # continuous-template probe (sgd_to_explore_template.py)
        self.soft_slots = soft_slots
        if soft_slots is not None:
            k = soft_slots[0] + soft_slots[1]
            tokenizer.add_special_tokens(
                [f"[unused{i}]" for i in range(1, k + 1)])
        with open(ann_file) as f:
            self.anns: Dict[str, dict] = {str(d["id"]): d for d in json.load(f)}
        with open(det_file) as f:
            self.det_dic: Dict[str, List[str]] = json.load(f)
        self.none_id = tokenizer.convert_tokens_to_ids(prompts.NONE_TOKEN)

    def __len__(self) -> int:
        return len(self.tsv)

    def decode_row(self, idx: int):
        img_name, payload = self.tsv.seek(idx)
        objs, caption, colors, rect_lists = json.loads(payload)["objects"]
        feats, od_labels = [], []
        for boxlist in objs:
            feats.append(np.stack([decode_feature(o["feature"]) for o in boxlist]))
            od_labels.append(" ".join(o["class"] for o in boxlist))
        return img_name, od_labels, feats, caption, colors, rect_lists

    def example(self, idx: int) -> RefcocoExample:
        img_name, _, feats, caption, colors, rect_lists = self.decode_row(idx)
        od_labels = self.det_dic[str(img_name)]
        if self.soft_slots is not None:
            prompt = prompts.refcoco_soft_prompt(caption, *self.soft_slots)
        elif self.zsl_template is not None:
            ann0 = self.anns.get(str(img_name), {})
            posi = ann0.get("tokens_positive", [[len(caption)]])[-1]
            prompt = prompts.refcoco_zsl_prompt(caption, posi, self.zsl_template)
        else:
            prompt = prompts.refcoco_fsl_prompt(caption)
        cname = colors[0][0]
        seqs = [tensorize_pair(self.tokenizer, prompt,
                               prompts.refcoco_od_labels_with_color(
                                   od_labels, copy_idx, cname),
                               feat.shape[0], max_seq_len=self.txt_seq_len,
                               max_img_seq_len=self.img_seq_len)
                for copy_idx, feat in enumerate(feats)]

        ann = self.anns.get(str(img_name))
        gt_bbox = ann.get("bbox") if ann else None
        gt_color_ids = []
        if gt_bbox is not None:
            for color_set, boxes in zip(colors, rect_lists):
                ious = [xywh_iou(gt_bbox, _xyxy_to_xywh(b)) for b in boxes]
                best = int(np.argmax(ious))
                name = color_set[best] if ious[best] > 0.5 else prompts.NONE_TOKEN
                gt_color_ids.append(self.tokenizer.convert_tokens_to_ids(name))
        return RefcocoExample(str(img_name), seqs, feats, colors, rect_lists,
                              gt_color_ids, gt_bbox)

    def train_slots(self, ex: RefcocoExample, rng: random.Random,
                    dataset_len: Optional[int] = None) -> List[int]:
        """Positive/negative copy sampling for training (reference ``:96-118``)."""
        n = dataset_len if dataset_len is not None else len(self)
        pos = [i for i, g in enumerate(ex.gt_color_ids) if g != self.none_id]
        neg = [i for i, g in enumerate(ex.gt_color_ids) if g == self.none_id]
        if not pos:
            pos = [0]
        if len(pos) > 1 and n == 16:
            rng.shuffle(pos)
            pos = pos[:1]
        if len(pos) < len(neg):
            rng.shuffle(neg)
            neg = neg[: len(pos)]
        return pos + neg


@dataclasses.dataclass
class FlatBatch:
    """Device batch + host bookkeeping for regrouping scores per query."""

    tensors: TensorizedBatch
    slot_meta: List[Tuple[int, int]]        # per slot: (example idx, copy idx)
    slot_colors: List[List[str]]
    slot_rects: List[List[List[float]]]
    labels: Optional[np.ndarray] = None     # [N] gt color token id (train)


def iter_eval_batches(data: RefcocoCPTData, batch_size: int,
                      indices: Optional[Sequence[int]] = None
                      ) -> Iterator[Tuple[FlatBatch, List[RefcocoExample]]]:
    """Fixed-size flat batches over all sub-sequences; one example's copies
    never straddle two batches (an example with more copies than
    ``batch_size`` is cut to ``batch_size``)."""
    idxs = list(indices) if indices is not None else list(range(len(data)))
    pend_seqs: List[TensorizedSeq] = []
    pend_feats: List[np.ndarray] = []
    meta: List[Tuple[int, int]] = []
    colors: List[List[str]] = []
    rects: List[List[List[float]]] = []
    examples: List[RefcocoExample] = []

    def flush():
        batch = stack_batch(pend_seqs, pend_feats, data.img_seq_len,
                            data.img_feat_dim, pad_to=batch_size)
        return FlatBatch(batch, meta, colors, rects), examples

    for ex_i in idxs:
        ex = data.example(ex_i)
        k = min(len(ex.seqs), batch_size)
        if pend_seqs and len(pend_seqs) + k > batch_size:
            yield flush()
            pend_seqs, pend_feats, meta, colors, rects, examples = (
                [], [], [], [], [], [])
        base = len(examples)
        examples.append(ex)
        for copy_i in range(k):
            pend_seqs.append(ex.seqs[copy_i])
            pend_feats.append(ex.feats[copy_i])
            meta.append((base, copy_i))
            colors.append(ex.colors[copy_i])
            rects.append(ex.rects[copy_i])
    if pend_seqs:
        yield flush()


def iter_train_batches(data: RefcocoCPTData, batch_size: int, seed: int,
                       num_epochs: int = 1,
                       indices: Optional[Sequence[int]] = None
                       ) -> Iterator[FlatBatch]:
    """Shuffled train batches of sampled pos/neg sub-sequences with labels
    (−1 on padded slots); the same ``random.Random(seed)`` draws as JAX."""
    rng = random.Random(seed)
    idxs = list(indices) if indices is not None else list(range(len(data)))
    for _ in range(num_epochs):
        order = idxs[:]
        rng.shuffle(order)
        pend = []
        for ex_i in order:
            ex = data.example(ex_i)
            for copy_i in data.train_slots(ex, rng, dataset_len=len(idxs)):
                pend.append((ex.seqs[copy_i], ex.feats[copy_i], ex_i, copy_i,
                             ex.colors[copy_i], ex.rects[copy_i],
                             ex.gt_color_ids[copy_i]))
        rng.shuffle(pend)
        for start in range(0, len(pend), batch_size):
            chunk = pend[start:start + batch_size]
            batch = stack_batch([c[0] for c in chunk], [c[1] for c in chunk],
                                data.img_seq_len, data.img_feat_dim,
                                pad_to=batch_size)
            labels = np.full((batch_size,), -1, np.int32)
            labels[: len(chunk)] = [c[6] for c in chunk]
            yield FlatBatch(batch, [(c[2], c[3]) for c in chunk],
                            [c[4] for c in chunk], [c[5] for c in chunk],
                            labels=labels)


def det_json_for_stage2(tsv_path: str, out_path: str) -> None:
    """Stage-2 od-label dict {query_id: [class names]} built from the
    extraction TSV's own payload (what the reference's inference directory
    provides next to predictions.tsv)."""
    det = {}
    tsv = TSVFile(tsv_path)
    for i in range(len(tsv)):
        key, payload = tsv.seek(i)
        objs = json.loads(payload)["objects"][0]
        det[key] = [b["class"] for b in objs[0]]
    tsv.close()
    with open(out_path, "w") as f:
        json.dump(det, f)


def tsv_region_features(tsv_path: str, row: int = 0) -> np.ndarray:
    """Region features of one extraction-TSV row → [n_copies, n_dets, D]."""
    tsv = TSVFile(tsv_path)
    objs = json.loads(tsv.seek(row)[1])["objects"][0]
    tsv.close()
    return np.stack([[decode_feature(b["feature"]) for b in copy]
                     for copy in objs])
