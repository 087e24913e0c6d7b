"""RefCOCO CPT grounding dataset, stage 2 (the evaluation half of
``cpt_tpu/data/refcoco.py``).

Reads the stage-1 interchange TSV (``predictions.tsv``: one row per query,
json payload ``[objects, caption, colors, rect_lists]``), the annotation
json (gt bbox per query id) and the od-label json. Faithful to reference
``Oscar/oscar/datasets/refcoco_fsl_cpt_dataset.py``: prompt
``"<caption> is in [MASK] color."``, text_b = od-labels with the copy's
color word before the colored object. The training-side fields (gt color
per copy, slot sampling) are not ported yet.

Each query expands into one sub-sequence per colored copy; batches are flat
over sub-sequences with host bookkeeping to regroup scores per query.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from cpt_tpu_torch.data import prompts
from cpt_tpu_torch.data.tensorize import TensorizedBatch, TensorizedSeq, stack_batch, tensorize_pair
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
    gt_bbox: Optional[List[float]]     # xywh gt (None at pure test time)


class RefcocoCPTData:
    def __init__(self, data_file: str, ann_file: str, det_file: str,
                 tokenizer: BertTokenizer, txt_seq_len: int = 70,
                 img_seq_len: int = 50, img_feat_dim: int = 2054):
        self.tsv = TSVFile(data_file)
        self.tokenizer = tokenizer
        self.txt_seq_len = txt_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim
        with open(ann_file) as f:
            self.anns: Dict[str, dict] = {str(d["id"]): d for d in json.load(f)}
        with open(det_file) as f:
            self.det_dic: Dict[str, List[str]] = json.load(f)

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
        prompt = prompts.refcoco_fsl_prompt(caption)
        cname = colors[0][0]
        seqs = [tensorize_pair(self.tokenizer, prompt,
                               prompts.refcoco_od_labels_with_color(
                                   od_labels, copy_idx, cname),
                               feat.shape[0], max_seq_len=self.txt_seq_len,
                               max_img_seq_len=self.img_seq_len)
                for copy_idx, feat in enumerate(feats)]

        ann = self.anns.get(str(img_name))
        return RefcocoExample(str(img_name), seqs, feats, colors, rect_lists,
                              ann.get("bbox") if ann else None)


@dataclasses.dataclass
class FlatBatch:
    """Device batch + host bookkeeping for regrouping scores per query."""

    tensors: TensorizedBatch
    slot_meta: List[Tuple[int, int]]        # per slot: (example idx, copy idx)
    slot_colors: List[List[str]]
    slot_rects: List[List[List[float]]]


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
