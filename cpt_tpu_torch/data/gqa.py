"""GQA CPT dataset (stage 2): question rewrite + [MASK]-answer scoring
(port of ``cpt_tpu/data/gqa.py``).

Faithful to reference ``Oscar/oscar/fewshot/gqa_cpt.py`` (``GQADataset``):
  * two feature TSVs: plain per-image features and color-marked per-question
    features; a question uses the color TSV when its q_id was marked
    (``gqa_cpt.py:225-267``), with the question rewritten by inserting color
    words at the parsed entity positions
  * sequence layout: ``[CLS](seg1) question(seg0) [SEP](seg0) [MASK](seg1)
    [SEP](seg1)`` + image features (``tensorize_example:106-176``;
    note ``cls_token_segment_id=1``)
  * train subset: seeded ``random.choices`` (WITH replacement) of n_sample
    examples that have color features (``gqa_cpt.py:86-90``)
  * labels: answer's first wordpiece token id at the mask position; eval
    scores = mask logits over the answer vocabulary's first tokens
    (``gqa_cpt.py:427-435, 590-614``)
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cpt_tpu_torch.data.prompts import gqa_rewrite_question
from cpt_tpu_torch.data.tensorize import TensorizedBatch, pad_img_feats
from cpt_tpu_torch.utils.tokenization import BertTokenizer
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


@dataclasses.dataclass
class GQAExample:
    q_id: str
    img_key: str
    question: str
    label: Optional[int] = None    # answer index into the answer vocab


def build_imgid2idx(tsv: TSVFile, cache_path: Optional[str] = None
                    ) -> Dict[str, int]:
    """Key → row index map with the reference's json cache convention."""
    if cache_path and os.path.exists(cache_path):
        return json.load(open(cache_path))
    dic = {tsv.seek(i)[0]: i for i in range(len(tsv))}
    if cache_path:
        json.dump(dic, open(cache_path, "w"))
    return dic


def tensorize_gqa(tokenizer: BertTokenizer, question: str,
                  num_img_feats: int, max_seq_len: int = 45,
                  max_img_seq_len: int = 45):
    """GQA sequence layout (CLS seg-id 1, text_b = [MASK])."""
    tokens_a = tokenizer.tokenize(question)
    tokens_b = ["[MASK]"]
    while len(tokens_a) + len(tokens_b) > max_seq_len - 3:
        tokens_a.pop()
    tokens = ["[CLS]"] + tokens_a + ["[SEP]"] + tokens_b + ["[SEP]"]
    segments = [1] + [0] * (len(tokens_a) + 1) + [1, 1]
    ids = tokenizer.convert_tokens_to_ids(tokens)
    attn = [1] * len(ids)
    while len(ids) < max_seq_len:
        ids.append(0)
        attn.append(0)
        segments.append(0)
    n_img = min(num_img_feats, max_img_seq_len)
    attn += [1] * n_img + [0] * (max_img_seq_len - n_img)
    mask_pos = ids.index(tokenizer.mask_token_id)
    return (np.asarray(ids, np.int32), np.asarray(segments, np.int32),
            np.asarray(attn, np.int32), mask_pos)


class GQACPTData:
    def __init__(self, img_feat_file: str, color_img_feat_file: Optional[str],
                 examples: Sequence[GQAExample], ans2label: Dict[str, int],
                 tokenizer: BertTokenizer, max_seq_len: int = 45,
                 img_seq_len: int = 45, img_feat_dim: int = 2054,
                 use_color: bool = True):
        self.img_feat_tsv = TSVFile(img_feat_file)
        self.imgid2feat = build_imgid2idx(
            self.img_feat_tsv,
            img_feat_file.replace("predictions.tsv", "imgid2idx.json")
            if img_feat_file.endswith("predictions.tsv") else None)
        self.color_tsv = (TSVFile(color_img_feat_file)
                          if (color_img_feat_file and use_color) else None)
        self.qid2feat = (build_imgid2idx(self.color_tsv)
                         if self.color_tsv is not None else {})
        self.examples = list(examples)
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim

        self.ans2label = ans2label
        self.label2ans = {v: k for k, v in ans2label.items()}
        # answer-vocab first-token ids, ordered by label index
        self.answer_token_ids = np.asarray([
            tokenizer.convert_tokens_to_ids(
                tokenizer.tokenize(self.label2ans[i]))[0]
            for i in range(len(self.label2ans))], np.int32)

    def __len__(self) -> int:
        return len(self.examples)

    def train_indices(self, n_sample: int, seed: int) -> List[int]:
        """Seeded sampling WITH replacement among color-marked examples;
        without a color TSV (``use_color=0`` pt baseline / FT variant) the
        pool is every labeled example instead."""
        if self.color_tsv is not None:
            pool = [i for i, ex in enumerate(self.examples)
                    if str(ex.q_id) in self.qid2feat]
        else:
            pool = [i for i, ex in enumerate(self.examples)
                    if ex.label is not None]
        rng = random.Random(seed)
        return rng.choices(pool, k=n_sample) if pool else []

    def features_for(self, ex: GQAExample) -> Tuple[str, np.ndarray]:
        """(possibly-rewritten question, [n, D] features)."""
        color_idx = self.qid2feat.get(str(ex.q_id)) if self.color_tsv else None
        if color_idx is not None:
            _, payload = self.color_tsv.seek(color_idx)
            info = json.loads(payload)
            boxlist, meta = info["objects"]
            question = gqa_rewrite_question(ex.question, meta[0])
        else:
            _, payload = self.img_feat_tsv.seek(
                self.imgid2feat[str(ex.img_key)])
            info = json.loads(payload)
            boxlist = info["objects"]
            question = ex.question
        feats = np.stack([decode_feature(o["feature"]) for o in boxlist])
        return question, feats

    def tensorize(self, idx: int):
        ex = self.examples[idx]
        question, feats = self.features_for(ex)
        ids, segs, attn, mask_pos = tensorize_gqa(
            self.tokenizer, question, feats.shape[0], self.max_seq_len,
            self.img_seq_len)
        label_token = -1
        if ex.label is not None:
            label_token = int(self.answer_token_ids[ex.label])
        return (ids, segs, attn, pad_img_feats(feats, self.img_seq_len),
                mask_pos, label_token, ex.label)

    def batch(self, indices: Sequence[int], pad_to: Optional[int] = None
              ) -> Tuple[TensorizedBatch, np.ndarray]:
        n = len(indices)
        total = pad_to if pad_to is not None else n
        t = self.max_seq_len
        b = TensorizedBatch(
            input_ids=np.zeros((total, t), np.int32),
            segment_ids=np.zeros((total, t), np.int32),
            attention_mask=np.zeros((total, t + self.img_seq_len), np.int32),
            img_feats=np.zeros((total, self.img_seq_len, self.img_feat_dim),
                               np.float32),
            mask_pos=np.zeros((total,), np.int32),
            valid=np.zeros((total,), bool),
        )
        label_tokens = np.full((total,), -1, np.int32)
        answer_idx = np.full((total,), -1, np.int32)
        for i, idx in enumerate(indices):
            ids, segs, attn, feats, mp, lt, ans = self.tensorize(idx)
            b.input_ids[i] = ids
            b.segment_ids[i] = segs
            b.attention_mask[i] = attn
            b.img_feats[i] = feats
            b.mask_pos[i] = mp
            b.valid[i] = True
            label_tokens[i] = lt
            answer_idx[i] = -1 if ans is None else ans
        return b, label_tokens, answer_idx


def load_gqa_examples(questions_file: str) -> List[GQAExample]:
    """Load examples from a json list of {q_id, img_id, question, answer?}
    (a simplified stand-in for the reference's csv/tsv processor zoo in
    ``utils/task_utils.py`` — same fields, no pandas dependency)."""
    raw = json.load(open(questions_file))
    return [GQAExample(str(r["q_id"]), str(r["img_id"]), r["question"],
                       r.get("label")) for r in raw]
