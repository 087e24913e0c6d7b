"""Visual Genome relation-detection CPT dataset, stage 2 (port of
``cpt_tpu/data/vg.py``).

Faithful to reference ``Oscar/oscar/datasets/vg_cpt_dataset.py`` and the
scoring rule in ``fewshot/vg_cpt.py:255-306``:
  * TSV rows keyed ``<img>_<subj>_<obj>``; subject painted red, object blue
  * template ``"<subj> in red color is [MASK]*k a <obj> in blue color"`` for
    mask widths k = 1..3; od-labels get the pair's color words prefixed
  * per-width label token lists: the true relation at its own width, the
    "no relation" fillers elsewhere (``vg_cpt_dataset.py:71-74``)
  * relation canonicalization has→having / wears→wearing / says→saying
  * eval: softmax at mask positions; per predicate, mean log-prob at the
    matching-width sequence; both pair directions (6 sequences per pair)
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cpt_tpu_torch.data import prompts
from cpt_tpu_torch.data.tensorize import (TensorizedBatch, pad_img_feats,
                                          tensorize_pair)
from cpt_tpu_torch.utils.tokenization import BertTokenizer
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


def pair_from_key(img_key: str) -> Tuple[int, int]:
    parts = img_key.split("_")
    return int(parts[-2]), int(parts[-1])


def reverse_imkey(img_key: str) -> str:
    parts = img_key.split("_")
    return "_".join(parts[:-2] + [parts[-1], parts[-2]])


class VGCPTData:
    def __init__(self, feat_file: str, tokenizer: BertTokenizer,
                 max_seq_len: int = 70, img_seq_len: int = 50,
                 img_feat_dim: int = 2054):
        self.tsv = TSVFile(feat_file)
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim

    def __len__(self):
        return len(self.tsv)

    def decode_row(self, idx: int):
        img_key, payload = self.tsv.seek(idx)
        info = json.loads(payload)
        # reference layout: [[boxlist], color_names, pair_labels, rel]
        # (inference_vg.py:179-181 / vg_cpt_dataset.py:103-121)
        nested, colors, subj_obj_names, rel_label = info["objects"]
        boxlist = nested[0]
        od_labels = [o["class"] for o in boxlist]
        feats = np.stack([decode_feature(o["feature"]) for o in boxlist])
        return img_key, od_labels, feats, subj_obj_names, colors, rel_label

    def rel_token_ids(self, rel_label: str) -> List[int]:
        rel = prompts.REL_CANONICALIZE.get(rel_label, rel_label)
        return self.tokenizer.convert_tokens_to_ids(
            self.tokenizer.tokenize(rel))

    def sequences(self, idx: int, *, both_directions: bool = False):
        """→ (img_key, [seqs], feats, per-width label token lists).

        Width order matches the reference: k=1,2,3 forward (+ k=1,2,3
        reversed when ``both_directions``)."""
        img_key, od_labels, feats, names, colors, rel_label = self.decode_row(idx)
        pair = pair_from_key(img_key)
        rel_ids = self.rel_token_ids(rel_label)

        def build(subj_name, obj_name, p):
            text_b = prompts.vg_od_labels_with_colors(od_labels, p,
                                                      tuple(colors))
            seqs = []
            for k in range(1, prompts.VG_MAX_MASK_WIDTH + 1):
                caption = prompts.vg_prompt(subj_name, obj_name, k,
                                            tuple(colors))
                seqs.append(tensorize_pair(self.tokenizer, caption, text_b,
                                           feats.shape[0], self.max_seq_len,
                                           self.img_seq_len))
            return seqs

        seqs = build(names[0], names[1], pair)
        if both_directions:
            seqs += build(names[1], names[0], (pair[1], pair[0]))
        labels = prompts.vg_filler_label_ids(
            rel_ids, lambda s: self.tokenizer.convert_tokens_to_ids(
                self.tokenizer.tokenize(s)))
        return img_key, seqs, feats, labels

    def batch(self, indices: Sequence[int], *, both_directions: bool = False,
              pad_to: Optional[int] = None):
        """Flat batch of width-sequences with multi-position MLM labels.

        Returns (TensorizedBatch, mlm_label_rows [N, max_width] of token ids
        (−1 pad), mask_positions [N, max_width] (−1 pad), meta)."""
        seqs, featlist, label_rows, meta = [], [], [], []
        for idx in indices:
            img_key, s, feats, labels = self.sequences(
                idx, both_directions=both_directions)
            for si, seq in enumerate(s):
                width = (si % prompts.VG_MAX_MASK_WIDTH) + 1
                seqs.append(seq)
                featlist.append(feats)
                label_rows.append(labels[width - 1])
                meta.append((idx, img_key, si))
        n = len(seqs)
        total = pad_to if pad_to is not None else n
        t = self.max_seq_len
        w = prompts.VG_MAX_MASK_WIDTH
        b = TensorizedBatch(
            input_ids=np.zeros((total, t), np.int32),
            segment_ids=np.zeros((total, t), np.int32),
            attention_mask=np.zeros((total, t + self.img_seq_len), np.int32),
            img_feats=np.zeros((total, self.img_seq_len, self.img_feat_dim),
                               np.float32),
            mask_pos=np.zeros((total,), np.int32),
            valid=np.zeros((total,), bool),
        )
        mask_positions = np.full((total, w), -1, np.int32)
        mlm_labels = np.full((total, w), -1, np.int32)
        for i, (seq, feats) in enumerate(zip(seqs, featlist)):
            b.input_ids[i] = seq.input_ids
            b.segment_ids[i] = seq.segment_ids
            b.attention_mask[i] = seq.attention_mask
            b.img_feats[i] = pad_img_feats(feats, self.img_seq_len)
            b.valid[i] = True
            pos = seq.mask_positions
            b.mask_pos[i] = pos[0] if pos else 0
            mask_positions[i, : len(pos)] = pos
            row = label_rows[i]
            mlm_labels[i, : min(len(row), len(pos))] = row[: len(pos)]
        return b, mlm_labels, mask_positions, meta


def vg_predicate_scores(probs_at_masks: np.ndarray,
                        mask_counts: Sequence[int],
                        idx2pred_tokens: Dict[int, List[int]]) -> np.ndarray:
    """Reference scoring (``vg_cpt.py:272-291``) for ONE direction.

    probs_at_masks: [3, max_width, vocab] softmax probs at each width-seq's
    mask positions. → logits [num_predicates + 1] (index 0 = background,
    left 0)."""
    n_pred = max(idx2pred_tokens) + 1
    logits = np.zeros(n_pred, np.float32)
    for idx, tokens in idx2pred_tokens.items():
        k = len(tokens)
        probs = probs_at_masks[k - 1, np.arange(k), tokens]
        logits[idx] = float(np.mean(np.log(np.maximum(probs, 1e-20))))
    return logits
