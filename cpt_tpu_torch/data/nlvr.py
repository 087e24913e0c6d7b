"""NLVR2 dataset — statement over an image pair; the port's copy of
``cpt_tpu/data/nlvr.py``, which imports no JAX.

Parity with reference ``Oscar/oscar/run_nlvr.py`` (``NLVRDataset:114``,
``ImageBertForMultipleChoice`` with ``num_choices=2``): each example yields
two (statement, od_labels, image) sequences — one per image of the pair —
classified jointly; ``use_pair``/label semantics follow the reference's
binary true/false task.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np

from cpt_tpu_torch.data.tensorize import pad_img_feats, tensorize_pair
from cpt_tpu_torch.utils.tokenization import BertTokenizer
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


@dataclasses.dataclass
class NLVRExample:
    ex_id: str
    img_left: str
    img_right: str
    statement: str
    label: Optional[int] = None     # 0 = false, 1 = true


class NLVRData:
    NUM_CHOICES = 2

    def __init__(self, feat_file: str, examples: Sequence[NLVRExample],
                 tokenizer: BertTokenizer, max_seq_len: int = 55,
                 img_seq_len: int = 40, img_feat_dim: int = 2054,
                 mode: str = "pair", use_od_labels: bool = True):
        """``mode="pair"``: two (statement, od, image) sequences per
        example for ``ImageBertForMultipleChoice`` (reference
        ``--use_pair``, ``tensorize_example_pair``). ``mode="concat"``:
        ONE sequence with both images' od labels joined and their
        features stacked, for ``ImageBertForSequenceClassification``
        (the reference's default ``tensorize_example`` construction,
        run_nlvr.py:132-146). ``use_od_labels=False`` drops the od-label
        text_b segment (reference ``--use_label_seq`` off,
        run_nlvr.py:73-94)."""
        assert mode in ("pair", "concat")
        self.mode = mode
        self.use_od_labels = use_od_labels
        self.tsv = TSVFile(feat_file)
        self.imgid2idx = {self.tsv.seek(i)[0]: i for i in range(len(self.tsv))}
        self.examples = [e for e in examples
                         if str(e.img_left) in self.imgid2idx
                         and str(e.img_right) in self.imgid2idx]
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim

    def __len__(self):
        return len(self.examples)

    def _feats(self, img_key: str):
        _, payload = self.tsv.seek(self.imgid2idx[str(img_key)])
        info = json.loads(payload)
        boxlist = info["objects"]
        feats = np.stack([decode_feature(o["feature"]) for o in boxlist])
        od = " ".join(o["class"] for o in boxlist)
        return feats, od

    def batch(self, indices: Sequence[int], pad_to: Optional[int] = None):
        """→ [N, 2, ...] choice arrays (pair mode) or flat [N, ...]
        concatenated-pair arrays (concat mode)."""
        if self.mode == "concat":
            return self._concat_batch(indices, pad_to)
        n = len(indices)
        total = pad_to if pad_to is not None else n
        t, r, d = self.max_seq_len, self.img_seq_len, self.img_feat_dim
        nc = self.NUM_CHOICES
        ids = np.zeros((total, nc, t), np.int32)
        segs = np.zeros((total, nc, t), np.int32)
        attn = np.zeros((total, nc, t + r), np.int32)
        feats = np.zeros((total, nc, r, d), np.float32)
        labels = np.full((total,), -1, np.int32)
        for i, idx in enumerate(indices):
            ex = self.examples[idx]
            # the reference tokenizes the statement ONCE and each
            # choice's _truncate_seq_pair mutates it in place, so the
            # right image sees the left-truncated statement
            # (run_nlvr.py:253,263-265) — share the token list
            toks_a = self.tokenizer.tokenize(ex.statement)
            for c, key in enumerate((ex.img_left, ex.img_right)):
                f, od = self._feats(key)
                seq = tensorize_pair(self.tokenizer, ex.statement,
                                     od if self.use_od_labels else None,
                                     f.shape[0], t, r, tokens_a=toks_a)
                ids[i, c] = seq.input_ids
                segs[i, c] = seq.segment_ids
                attn[i, c] = seq.attention_mask
                feats[i, c] = pad_img_feats(f, r)
            if ex.label is not None:
                labels[i] = ex.label
        return ids, segs, attn, feats, labels

    def _concat_batch(self, indices: Sequence[int],
                      pad_to: Optional[int] = None):
        n = len(indices)
        total = pad_to if pad_to is not None else n
        t, r, d = self.max_seq_len, self.img_seq_len, self.img_feat_dim
        # the reference's concat construction carries BOTH images' regions
        # — the stacked features truncate/pad at 2*max_img_seq_length
        # (run_nlvr.py:199-216)
        rr = 2 * r
        ids = np.zeros((total, t), np.int32)
        segs = np.zeros((total, t), np.int32)
        attn = np.zeros((total, t + rr), np.int32)
        feats = np.zeros((total, rr, d), np.float32)
        labels = np.full((total,), -1, np.int32)
        for i, idx in enumerate(indices):
            ex = self.examples[idx]
            fl, odl = self._feats(ex.img_left)
            fr, odr = self._feats(ex.img_right)
            f = np.concatenate([fl, fr])[:rr]
            seq = tensorize_pair(self.tokenizer, ex.statement,
                                 (odl + " " + odr) if self.use_od_labels
                                 else None, f.shape[0], t, rr)
            ids[i], segs[i], attn[i] = (seq.input_ids, seq.segment_ids,
                                        seq.attention_mask)
            feats[i] = pad_img_feats(f, rr)
            if ex.label is not None:
                labels[i] = ex.label
        return ids, segs, attn, feats, labels


class Nlvr2JsonData(NLVRData):
    """The reference's NLVR2 data layout loaded WITHOUT conversion
    (``run_nlvr.py:73-107`` + ``task_utils.py::NLVRProcessor``):
    ``nlvr2_{split}.json`` rows ``{"q", "o": {img_key: od string},
    "label", "img_id": [left, right]}`` + the
    ``nlvr2_img_frcnn_feats.pt`` torch feature dict."""

    def __init__(self, data_dir: str, split: str,
                 tokenizer: BertTokenizer, max_seq_len: int = 55,
                 img_seq_len: int = 40, img_feat_dim: int = 2054,
                 mode: str = "pair", use_od_labels: bool = True):
        import os

        import torch

        feats = torch.load(os.path.join(
            data_dir, "nlvr2_img_frcnn_feats.pt"), weights_only=False)
        self._feat_map = {str(k): np.asarray(v, np.float32)
                          for k, v in feats.items()}
        rows = json.load(open(os.path.join(data_dir,
                                           f"nlvr2_{split}.json")))
        examples, self._od = [], {}
        for i, row in enumerate(rows):
            left, right = (str(k) for k in row["img_id"])
            examples.append(NLVRExample(str(i), left, right, row["q"],
                                        row.get("label")))
            od = row.get("o") or {}
            for k in (left, right):
                if k in od:
                    self._od[k] = str(od[k]).replace(";", " ").strip()

        assert mode in ("pair", "concat")
        self.mode = mode
        self.use_od_labels = use_od_labels
        self.tsv = None
        self.imgid2idx = {k: 0 for k in self._feat_map}
        self.examples = [e for e in examples
                         if e.img_left in self._feat_map
                         and e.img_right in self._feat_map]
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim

    def _feats(self, img_key: str):
        return (self._feat_map[str(img_key)],
                self._od.get(str(img_key), ""))


def load_nlvr_examples(path: str) -> List[NLVRExample]:
    raw = json.load(open(path))
    return [NLVRExample(str(x["ex_id"]), str(x["img_left"]),
                        str(x["img_right"]), x["statement"], x.get("label"))
            for x in raw]
