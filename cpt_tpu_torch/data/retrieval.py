"""Image-text retrieval dataset; the port's copy of
``cpt_tpu/data/retrieval.py``, which imports no JAX.

Parity with reference ``Oscar/oscar/run_retrieval.py`` (``RetrievalDataset:
23``): training pairs a caption with its image (label 1) or a sampled
negative caption/image (label 0), classified by
``ImageBertForSequenceClassification`` (binary). Evaluation ranks all
caption×image pair scores → R@1/5/10 both directions.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cpt_tpu_torch.data.tensorize import pad_img_feats, tensorize_pair
from cpt_tpu_torch.utils.tokenization import BertTokenizer
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


def retrieval_attention_mask(att_mask_type: str, seq_a_len: int,
                             seq_len: int, max_seq_len: int, img_len: int,
                             max_img_seq_len: int) -> np.ndarray:
    """Structured attention between the Caption/od-Label/Region blocks
    (reference ``RetrievalDataset.tensorize_example``,
    run_retrieval.py:169-194): ``'CLR'`` → the plain 1-D validity mask;
    ``'CL'``/``'CR'``/``'LR'`` → a 2-D mask with full within-block
    attention plus the one named cross-block pair."""
    total = max_seq_len + max_img_seq_len
    if att_mask_type == "CLR":
        m = np.zeros((total,), np.int32)
        m[:seq_len] = 1
        m[max_seq_len:max_seq_len + img_len] = 1
        return m
    m = np.zeros((total, total), np.int32)
    c = slice(0, seq_a_len)
    l = slice(seq_a_len, seq_len)
    r = slice(max_seq_len, max_seq_len + img_len)
    m[c, c] = 1
    m[l, l] = 1
    m[r, r] = 1
    if att_mask_type == "CL":
        m[c, l] = 1
        m[l, c] = 1
    elif att_mask_type == "CR":
        m[c, r] = 1
        m[r, c] = 1
    elif att_mask_type == "LR":
        m[l, r] = 1
        m[r, l] = 1
    else:
        raise ValueError(f"Unsupported attention mask type {att_mask_type}")
    return m


class RetrievalData:
    def __init__(self, feat_file: str, captions: Dict[str, List[str]],
                 tokenizer: BertTokenizer, max_seq_len: int = 70,
                 img_seq_len: int = 50, img_feat_dim: int = 2054,
                 eval_img_keys: Optional[Sequence[str]] = None,
                 caption_indexs: Optional[Dict[str, List]] = None,
                 att_mask_type: str = "CLR",
                 num_captions_per_img: Optional[int] = None,
                 use_od_labels: bool = True):
        """captions: {img_key: [caption strings]}.

        ``eval_img_keys`` restricts evaluation to a key subset (reference
        ``--eval_img_keys_file``, run_retrieval.py:76-84 — the COCO 1k/5k
        folds). ``caption_indexs`` is {img_key: [(img_key, cap_idx), ...]}
        — per-image hard-negative caption candidates for the re-rank
        evaluation setting (``--eval_caption_index_file``,
        run_retrieval.py:86-95), the setting the reference's published
        R@K numbers use. ``att_mask_type``/``num_captions_per_img``/
        ``use_od_labels`` mirror the reference flags of the same names.
        """
        self.tsv = TSVFile(feat_file)
        self.imgid2idx = {self.tsv.seek(i)[0]: i for i in range(len(self.tsv))}
        self._init_common(
            {k: v for k, v in captions.items() if k in self.imgid2idx},
            tokenizer, max_seq_len=max_seq_len, img_seq_len=img_seq_len,
            img_feat_dim=img_feat_dim, eval_img_keys=eval_img_keys,
            caption_indexs=caption_indexs, att_mask_type=att_mask_type,
            num_captions_per_img=num_captions_per_img,
            use_od_labels=use_od_labels)

    def _init_common(self, captions, tokenizer,
                     max_seq_len=70, img_seq_len=50, img_feat_dim=2054,
                     eval_img_keys=None, caption_indexs=None,
                     att_mask_type="CLR", num_captions_per_img=None,
                     use_od_labels=True):
        # the UNCAPPED pool — the reference builds separate train/eval
        # datasets that each cap from the full pool, so an eval cap
        # (--num_captions_per_img_val) larger than the train cap must
        # still see every caption (run_retrieval.py:60-75)
        self.full_captions = captions
        self.captions = captions
        if num_captions_per_img is not None:
            self.captions = {k: v[:num_captions_per_img]
                             for k, v in self.captions.items()}
        self.att_mask_type = att_mask_type
        self.use_od_labels = use_od_labels
        self.img_keys = sorted(self.captions)
        if eval_img_keys is not None:
            keep = [str(k) for k in eval_img_keys]
            missing = [k for k in keep if k not in self.captions]
            if missing:
                raise KeyError(f"eval_img_keys not in captions: {missing[:5]}")
            self.img_keys = keep
            self.captions = {k: self.captions[k] for k in keep}
            self.full_captions = {k: self.full_captions[k] for k in keep}
        self.caption_indexs = None
        if caption_indexs is not None:
            self.caption_indexs = {
                str(k): [(str(ik), int(ci)) for ik, ci in v]
                for k, v in caption_indexs.items()}
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim

    def _feats(self, img_key: str):
        _, payload = self.tsv.seek(self.imgid2idx[str(img_key)])
        info = json.loads(payload)
        boxlist = info["objects"]
        feats = np.stack([decode_feature(o["feature"]) for o in boxlist])
        od = " ".join(o["class"] for o in boxlist)
        return feats, od

    @property
    def attn_shape(self) -> Tuple[int, ...]:
        t = self.max_seq_len + self.img_seq_len
        return (t,) if self.att_mask_type == "CLR" else (t, t)

    def tensorize(self, caption: str, img_key: str):
        feats, od = self._feats(img_key)
        # the reference's retrieval tensorizer truncates ONLY text_b
        # (run_retrieval.py:137-150), unlike the VQA/NLVR/pretrain
        # longer-pops-first scheme
        seq = tensorize_pair(self.tokenizer, caption,
                             od if self.use_od_labels else None,
                             feats.shape[0], self.max_seq_len,
                             self.img_seq_len, truncation="b_only")
        if self.att_mask_type != "CLR":
            t = self.max_seq_len
            seq_len = int(seq.attention_mask[:t].sum())
            n_b = int((seq.segment_ids == 1).sum())   # od tokens + [SEP]
            img_len = int(seq.attention_mask[t:].sum())
            seq = dataclasses.replace(
                seq, attention_mask=retrieval_attention_mask(
                    self.att_mask_type, seq_len - n_b, seq_len, t,
                    img_len, self.img_seq_len))
        return seq, pad_img_feats(feats, self.img_seq_len)

    def train_batch(self, batch_size: int, rng: random.Random,
                    hard_negatives: bool = False):
        """Balanced positive/negative pairs.

        Negatives follow the reference's 50/50 split (run_retrieval.py:
        210-222): either a random caption from a different image paired
        with this image's features, or this caption paired with a random
        different image's features. With ``hard_negatives=True`` the
        negative caption/image is drawn from the image's
        ``caption_indexs`` candidate list instead of uniformly.
        """
        t, r, d = self.max_seq_len, self.img_seq_len, self.img_feat_dim
        ids = np.zeros((batch_size, t), np.int32)
        segs = np.zeros((batch_size, t), np.int32)
        attn = np.zeros((batch_size, *self.attn_shape), np.int32)
        feats = np.zeros((batch_size, r, d), np.float32)
        labels = np.zeros((batch_size,), np.int32)
        for i in range(batch_size):
            key = rng.choice(self.img_keys)
            if i % 2 == 0:
                cap = rng.choice(self.captions[key])
                labels[i] = 1
            else:
                if hard_negatives and self.caption_indexs:
                    cands = [(ik, ci) for ik, ci in self.caption_indexs[key]
                             if ik != key]
                    ok, oc = rng.choice(cands)
                else:
                    ok = rng.choice([k for k in self.img_keys if k != key])
                    oc = rng.randrange(len(self.captions[ok]))
                if rng.random() <= 0.5:   # negative caption, own image
                    cap = self.captions[ok][oc]
                else:                     # own caption, negative image
                    cap = rng.choice(self.captions[key])
                    key = ok
                labels[i] = 0
            seq, f = self.tensorize(cap, key)
            ids[i], segs[i], attn[i] = (seq.input_ids, seq.segment_ids,
                                        seq.attention_mask)
            feats[i] = f
        return ids, segs, attn, feats, labels

    def rerank_entries(
            self, num_captions_per_img: Optional[int] = None
    ) -> List[Tuple[str, str, int, int]]:
        """Re-rank evaluation pairs, reference index order
        (run_retrieval.py:113-116): for each eval image, its first
        ``num_captions_per_img`` ``caption_indexs`` candidates (the
        reference's eval indexing caps at --num_captions_per_img_val,
        run_retrieval.py:75,114-116). Returns
        [(img_key, cand_img_key, cand_cap_idx, label)]."""
        assert self.caption_indexs is not None
        cands = {k: (self.caption_indexs[k][:num_captions_per_img]
                     if num_captions_per_img is not None
                     else self.caption_indexs[k]) for k in self.img_keys}
        n_cand = {len(cands[k]) for k in self.img_keys}
        assert len(n_cand) == 1, (
            "re-rank requires a uniform candidate count per image "
            f"(reference compute_ranks reshapes [-1, n]); got {n_cand}")
        out = []
        for key in self.img_keys:
            for ik, ci in cands[key]:
                out.append((key, ik, ci, int(ik == key)))
        return out

    def all_pairs(self):
        """Every (caption, image) pair for ranking eval, with gt flags."""
        pairs = []
        for ck in self.img_keys:
            for cap in self.captions[ck]:
                for ik in self.img_keys:
                    pairs.append((cap, ck, ik))
        return pairs


class CocoIRRetrievalData(RetrievalData):
    """The reference's coco_ir data layout loaded WITHOUT conversion
    (``run_retrieval.py:23-75,236-243``): ``{split}_captions.pt`` (torch
    dict {img_id: list[str] or json str}), ``imageid2idx.json`` beside
    the feature TSV, 3-column feature rows ``(key, num_boxes,
    b64 f32 [n, D])``, od labels from the sibling ``predictions.tsv``."""

    def __init__(self, data_dir: str, img_feat_file: str,
                 tokenizer: BertTokenizer, split: str = "train", **kw):
        import base64
        import os

        import torch

        self._b64 = base64
        blob = torch.load(os.path.join(data_dir,
                                       f"{split}_captions.pt"),
                          weights_only=False)
        captions = {}
        for k, v in blob.items():
            captions[str(k)] = v if isinstance(v, list) else json.loads(v)

        feat_dir = os.path.dirname(os.path.abspath(img_feat_file))
        id2idx = json.load(open(os.path.join(feat_dir,
                                             "imageid2idx.json")))
        self._coco_tsv = TSVFile(img_feat_file)
        self._coco_id2idx = {str(k): int(v) for k, v in id2idx.items()}

        self._od = {}
        pred_path = os.path.join(feat_dir, "predictions.tsv")
        if os.path.exists(pred_path):
            ltsv = TSVFile(pred_path)
            for i in range(len(ltsv)):
                row = ltsv.seek(i)
                info = json.loads(row[1])
                objs = info["objects"] if isinstance(info, dict) else info
                self._od[str(row[0])] = " ".join(o["class"] for o in objs)

        # bypass RetrievalData's predictions-TSV ctor: replicate its
        # caption bookkeeping with our own feature access
        self.tsv = None
        self.imgid2idx = self._coco_id2idx
        captions = {k: v for k, v in captions.items()
                    if k in self._coco_id2idx}
        self._init_common(captions, tokenizer, **kw)

    def _feats(self, img_key: str):
        row = self._coco_tsv.seek(self._coco_id2idx[str(img_key)])
        feats = np.frombuffer(self._b64.b64decode(row[-1]),
                              np.float32).reshape(int(row[1]), -1)
        return feats, self._od.get(str(img_key), "")


def rank_rerank(scores: np.ndarray, labels: np.ndarray,
                n_candidates: int) -> Dict[str, float]:
    """Hard-negative re-rank R@K (reference ``compute_ranks`` in the
    ``has_caption_indexs`` branch, run_retrieval.py:264-281): scores and
    0/1 labels are flat in (image, candidate) order; per image the
    candidates are sorted by score and the rank of the first positive
    taken. Only image→text recalls are defined in this setting."""
    sim = np.reshape(scores, [-1, n_candidates])
    lab = np.reshape(labels, [-1, n_candidates])
    ranks = []
    for l, s in zip(lab, sim):
        inds = np.argsort(s)[::-1]
        rank = n_candidates
        for r, ind in enumerate(inds):
            if l[ind] == 1:
                rank = r
                break
        ranks.append(rank)
    return {f"i2t_R@{k}": 100.0 * np.mean([r < k for r in ranks])
            for k in (1, 5, 10)}


def rank_scores(scores: np.ndarray, caption_owner: Sequence[int],
                n_images: int) -> Dict[str, float]:
    """scores [n_captions, n_images] (higher = better match);
    caption_owner[i] = gt image index → R@1/5/10 for text→image and
    image→text."""
    n_cap = scores.shape[0]
    out = {}
    ranks_t2i = []
    for i in range(n_cap):
        order = np.argsort(-scores[i], kind="stable")
        ranks_t2i.append(int(np.where(order == caption_owner[i])[0][0]))
    for k in (1, 5, 10):
        out[f"t2i_R@{k}"] = 100.0 * np.mean([r < k for r in ranks_t2i])
    ranks_i2t = []
    owners = np.asarray(caption_owner)
    for j in range(n_images):
        order = np.argsort(-scores[:, j], kind="stable")
        gt_rows = np.where(owners == j)[0]
        if len(gt_rows) == 0:
            continue
        pos = min(int(np.where(order == g)[0][0]) for g in gt_rows)
        ranks_i2t.append(pos)
    for k in (1, 5, 10):
        out[f"i2t_R@{k}"] = 100.0 * np.mean([r < k for r in ranks_i2t])
    return out
