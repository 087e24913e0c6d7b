"""VQA dataset (full-finetune path); the port's copy of
``cpt_tpu/data/vqa.py``, which imports no JAX.

Parity with reference ``Oscar/oscar/run_vqa.py`` (``VQADataset:82``,
``convert_examples_to_features_vqa``): sequence = ``[CLS] question [SEP]
od_labels [SEP]`` + image features; labels are soft target vectors over the
3129-answer vocabulary (bce loss) or hard labels (xe, the GQA variant —
``run_gqa.py``). Examples come from a json list with per-example answer
scores.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from cpt_tpu_torch.data.tensorize import TensorizedBatch, pad_img_feats, tensorize_pair
from cpt_tpu_torch.utils.tokenization import BertTokenizer
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


@dataclasses.dataclass
class VQAExample:
    q_id: str
    img_key: str
    question: str
    # {answer label index: score}; empty at test time
    label_scores: Dict[int, float] = dataclasses.field(default_factory=dict)
    # per-example od-label text (the qla json 'o' field); None = derive
    # from the feature file's object classes
    od_text: Optional[str] = None


class VQAData:
    def __init__(self, feat_file: str, examples: Sequence[VQAExample],
                 num_labels: int, tokenizer: BertTokenizer,
                 max_seq_len: int = 128, img_seq_len: int = 50,
                 img_feat_dim: int = 2054, use_od_labels: bool = True):
        self.tsv = TSVFile(feat_file)
        self.imgid2idx = {self.tsv.seek(i)[0]: i for i in range(len(self.tsv))}
        self.examples = [e for e in examples if str(e.img_key) in self.imgid2idx]
        self.num_labels = num_labels
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim
        self.use_od_labels = use_od_labels
        self.code_mode = False   # dis_code loaders set True (int code ids)

    # dis_code_t transposed-code layout (class-level defaults: QlaVQAData
    # sets code_mode without calling this __init__)
    code_t = False
    code_size = 0
    code_dim = 0

    def enable_code_t(self, code_size: int, code_dim: int):
        """dis_code_t layout (modeling_bert.py:255-257): codes [N,
        code_size] embed → transpose → the IMAGE SEQUENCE LENGTH after the
        transpose is ``code_dim``, not img_seq_len — the attention mask
        must cover t + code_dim positions (all live: the transpose mixes
        every code into each position), and codes pad to code_size (the
        img_embedding input dim, modeling_bert.py:172)."""
        assert self.code_mode, "dis_code_t needs integer code features"
        assert code_size > 0, "--code_size must be set for dis_code_t"
        self.code_t = True
        self.code_size = code_size
        self.code_dim = code_dim

    def __len__(self):
        return len(self.examples)

    def features_for(self, img_key: str):
        _, payload = self.tsv.seek(self.imgid2idx[str(img_key)])
        info = json.loads(payload)
        boxlist = info["objects"]
        feats = np.stack([decode_feature(o["feature"]) for o in boxlist])
        od = " ".join(o["class"] for o in boxlist)
        return feats, od

    def batch(self, indices: Sequence[int], pad_to: Optional[int] = None):
        """→ (TensorizedBatch, soft_targets [N, num_labels], hard [N])."""
        n = len(indices)
        total = pad_to if pad_to is not None else n
        t = self.max_seq_len
        # dis_code_t: post-transpose image seq len is code_dim and codes
        # pad to code_size slots (see enable_code_t)
        img_len = self.code_dim if self.code_t else self.img_seq_len
        slots = self.code_size if self.code_t else self.img_seq_len
        b = TensorizedBatch(
            input_ids=np.zeros((total, t), np.int32),
            segment_ids=np.zeros((total, t), np.int32),
            attention_mask=np.zeros((total, t + img_len), np.int32),
            # dis_code: [N, r] int code ids (embedding-table lookup);
            # else [N, r, D] float region features
            img_feats=(np.zeros((total, slots), np.int32)
                       if self.code_mode else
                       np.zeros((total, self.img_seq_len,
                                 self.img_feat_dim), np.float32)),
            mask_pos=np.zeros((total,), np.int32),
            valid=np.zeros((total,), bool),
        )
        soft = np.zeros((total, self.num_labels), np.float32)
        hard = np.full((total,), -1, np.int32)
        for i, idx in enumerate(indices):
            ex = self.examples[idx]
            feats, od = self.features_for(ex.img_key)
            if ex.od_text is not None:
                od = ex.od_text
            seq = tensorize_pair(self.tokenizer, ex.question,
                                 od if self.use_od_labels else None,
                                 feats.shape[0], self.max_seq_len,
                                 self.img_seq_len)
            b.input_ids[i] = seq.input_ids
            b.segment_ids[i] = seq.segment_ids
            if self.code_t:
                b.attention_mask[i, :t] = seq.attention_mask[:t]
                b.attention_mask[i, t:] = 1
            else:
                b.attention_mask[i] = seq.attention_mask
            if self.code_mode:
                nc = min(feats.shape[0],
                         self.code_size if self.code_t else self.img_seq_len)
                b.img_feats[i, :nc] = feats[:nc]
            else:
                b.img_feats[i] = pad_img_feats(feats, self.img_seq_len)
            b.valid[i] = True
            if ex.label_scores:
                for lab, score in ex.label_scores.items():
                    soft[i, int(lab)] = score
                hard[i] = max(ex.label_scores, key=ex.label_scores.get)
        return b, soft, hard


class QlaVQAData(VQAData):
    """The reference's VQA data layout loaded WITHOUT conversion
    (``run_vqa.py:82-133`` + ``task_utils.py::VQATextProcessor``):
    ``{split}_img_frcnn_feats.pt`` torch dict {img_id: [n, D] features}
    and ``{split}_qla.json`` rows ``{"q", "o" (';'-joined od labels),
    "an" (answer label ids), "s" (scores), "img_id", "q_id"}``. Train
    rows with empty ``an`` are skipped, as the reference does."""

    def __init__(self, data_dir: str, split: str, num_labels: int,
                 tokenizer: BertTokenizer, max_seq_len: int = 128,
                 img_seq_len: int = 50, img_feat_dim: int = 2054,
                 use_od_labels: bool = True, is_test: bool = False,
                 feat_split: Optional[str] = None,
                 vqvae_level: Optional[str] = None):
        """``feat_split`` names the feature .pt when it differs from the
        qla split — the reference's composite splits (``train+val2014``,
        ``train2014_vg``, ``vg`` dev; run_vqa.py:47-67 --use_vg/
        --use_vg_dev/--do_train_val) reuse another split's features.

        ``vqvae_level`` ("top"/"bottom"/"both") switches the feature
        source to the reference's VQ-VAE code files —
        ``{data_dir}/vqvae/{split}.pt`` key ``feats_{level}``
        (run_vqa.py:111) — instead of the frcnn features."""
        import os

        import torch

        if vqvae_level:
            feats = torch.load(os.path.join(
                data_dir, "vqvae", f"{feat_split or split}.pt"),
                weights_only=False)[f"feats_{vqvae_level}"]
        else:
            feats = torch.load(os.path.join(
                data_dir, f"{feat_split or split}_img_frcnn_feats.pt"),
                weights_only=False)
        # integer arrays = VQ-VAE discrete-code features (the reference's
        # --img_feature_type dis_code path, run_vqa.py:87-96 /
        # modeling_bert.py:167-176): 1-D code ids per image, fed to an
        # embedding table instead of the linear projection
        self._feat_map = {}
        self.code_mode = False
        for k, v in feats.items():
            arr = np.asarray(v)
            if np.issubdtype(arr.dtype, np.integer):
                self._feat_map[str(k)] = arr.astype(np.int32)
                self.code_mode = True
            else:
                self._feat_map[str(k)] = arr.astype(np.float32)
        qla = None
        for cand in (f"{split}_qla.json", f"{split}_qla_mrcnn.json"):
            path = os.path.join(data_dir, cand)
            if os.path.isfile(path):
                qla = json.load(open(path))
                break
        if qla is None:
            raise FileNotFoundError(
                f"no {split}_qla[_mrcnn].json under {data_dir}")
        examples = []
        for i, row in enumerate(qla):
            an = row.get("an") or []
            if not is_test and not an:
                continue
            examples.append(VQAExample(
                q_id=str(row.get("q_id", i)), img_key=str(row["img_id"]),
                question=row["q"],
                label_scores={int(a): float(s)
                              for a, s in zip(an, row.get("s") or [])},
                od_text=row.get("o", "").replace(";", " ").strip()))

        self.tsv = None
        self.imgid2idx = {k: 0 for k in self._feat_map}
        self.examples = [e for e in examples
                         if e.img_key in self._feat_map]
        self.num_labels = num_labels
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.img_seq_len = img_seq_len
        self.img_feat_dim = img_feat_dim
        self.use_od_labels = use_od_labels

    def features_for(self, img_key: str):
        return self._feat_map[str(img_key)], ""


def load_vqa_examples(path: str) -> List[VQAExample]:
    raw = json.load(open(path))
    return [VQAExample(str(r["q_id"]), str(r["img_id"]), r["question"],
                       {int(k): float(v)
                        for k, v in (r.get("label_scores") or {}).items()})
            for r in raw]
