"""VCR CPT dataset (stage 2): entity textization + NSP candidate scoring
(port of ``cpt_tpu/data/vcr.py``).

As the reference ``Oscar/oscar/fewshot/vcr_nsp_cpt.py`` does it:
  * feature TSV rows carry ``objects = [boxlist, [obj_colors, obj_names]]``,
    both metas dicts keyed by the sorted-underscore entity key
    (``load_image_features:132-151``; ``engine/extract.vcr_payload``)
  * each example expands into one sequence per candidate (4 for q→a):
    text_a = the textized question ("person in red ..."), text_b = the
    textized candidate (``tensorize_example:171-188``)
  * layout: ``[CLS](seg0) a [SEP] b [SEP]`` + image features
  * train labels: ``next_sentence_label`` = 1 for every candidate, 0 at the
    correct one (``train:434-436``); eval score = 1 − softmax[:, 1], argmax
    per candidate group (``evaluate:586-612``)
  * q→ar (``vcr_qar_nsp_cpt.py``): rationale candidates are conditioned on
    the gt answer appended to the question.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np

from cpt_tpu_torch.data.prompts import vcr_textize
from cpt_tpu_torch.data.tensorize import stack_batch, tensorize_pair
from cpt_tpu_torch.utils.tokenization import BertTokenizer
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


@dataclasses.dataclass
class VCRExample:
    q_id: str
    img_key: str
    question: Sequence            # mixed tokens: str | [entity ids]
    choices: List[Sequence]       # candidate answers (mixed tokens)
    label: Optional[int] = None   # index of the correct choice
    rationale_choices: Optional[List[Sequence]] = None
    rationale_label: Optional[int] = None


class VCRCPTData:
    def __init__(self, feat_file: str, examples: Sequence[VCRExample],
                 tokenizer: BertTokenizer, max_seq_len: int = 80,
                 img_seq_len: int = 60, img_feat_dim: int = 2054):
        self.tsv = TSVFile(feat_file)
        self.imgid2feat = {self.tsv.seek(i)[0]: i for i in range(len(self.tsv))}
        self.examples = [ex for ex in examples
                         if str(ex.img_key) in self.imgid2feat]
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim

    def __len__(self) -> int:
        return len(self.examples)

    def load_features(self, img_key: str):
        _, payload = self.tsv.seek(self.imgid2feat[str(img_key)])
        boxlist, meta = json.loads(payload)["objects"]
        feats = np.stack([decode_feature(o["feature"]) for o in boxlist])
        return feats, meta[0], meta[1]

    def tensorize_example(self, ex: VCRExample, *, use_rationale: bool = False,
                          chosen_answer: Optional[int] = None):
        """→ list over candidates of (TensorizedSeq, feats)."""
        feats, colors, names = self.load_features(ex.img_key)
        question = vcr_textize(ex.question, colors, names, colorful=True)
        if use_rationale:
            if chosen_answer is None:
                raise ValueError("rationale candidates need the chosen answer")
            ans_txt = vcr_textize(ex.choices[chosen_answer], colors, names)
            question = question + " " + ans_txt
            candidates = ex.rationale_choices
        else:
            candidates = ex.choices
        out = []
        for cand in candidates:
            text_b = vcr_textize(cand, colors, names, colorful=True)
            seq = tensorize_pair(self.tokenizer, question, text_b,
                                 feats.shape[0], self.max_seq_len,
                                 self.img_seq_len)
            out.append((seq, feats))
        return out

    def batch(self, indices: Sequence[int], *, use_rationale: bool = False,
              pad_to: Optional[int] = None):
        """Flat batch over candidates → (TensorizedBatch, nsp_labels [N]
        (−1 on padded slots), group_meta [(example idx, cand idx)])."""
        seqs, featlist, labels, meta = [], [], [], []
        for idx in indices:
            ex = self.examples[idx]
            chosen = ex.label if use_rationale else None
            cands = self.tensorize_example(ex, use_rationale=use_rationale,
                                           chosen_answer=chosen)
            gt = ex.rationale_label if use_rationale else ex.label
            for ci, (seq, feats) in enumerate(cands):
                seqs.append(seq)
                featlist.append(feats)
                labels.append(1 if (gt is None or ci != gt) else 0)
                meta.append((idx, ci))
        b = stack_batch(seqs, featlist, self.img_seq_len, self.img_feat_dim,
                        pad_to=pad_to)
        nsp_labels = np.full((len(b),), -1, np.int32)
        nsp_labels[: len(labels)] = labels
        return b, nsp_labels, meta


def load_vcr_examples(path: str) -> List[VCRExample]:
    """jsonl/json with fields {q_id, img_key, question, choices, label,
    rationale_choices?, rationale_label?}; question and choices are the VCR
    mixed token lists (strings and entity-id lists)."""
    with open(path) as f:
        raw = (json.load(f) if path.endswith(".json")
               else [json.loads(line) for line in f])
    return [VCRExample(str(r["q_id"]), str(r["img_key"]), r["question"],
                       r["choices"], r.get("label"),
                       r.get("rationale_choices"), r.get("rationale_label"))
            for r in raw]
