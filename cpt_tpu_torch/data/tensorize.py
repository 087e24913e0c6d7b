"""Host-side tensorization: prompts + region features → fixed-shape arrays
(the port's copy of the pair-truncation path of ``cpt_tpu/data/tensorize.py``,
the one RefCOCO grounding uses).

Reproduces the reference's sequence-pair layout exactly
(``Oscar/oscar/datasets/refcoco_fsl_cpt_dataset.py::tokenize``, lines
170-261): ``[CLS] text_a [SEP] text_b [SEP]`` with pair truncation to
``max_seq_len - 3`` (longest-first), zero-padding of text to
``max_seq_len``, image features appended after the text segment with their
own attention-mask span and zero-padded to ``max_img_seq_len``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from cpt_tpu_torch.utils.tokenization import BertTokenizer


@dataclasses.dataclass
class TensorizedSeq:
    input_ids: np.ndarray      # [T] int32
    segment_ids: np.ndarray    # [T] int32
    attention_mask: np.ndarray  # [T + R] int32
    mask_positions: List[int]  # positions of [MASK] in input_ids


def truncate_seq_pair(tokens_a: List[str], tokens_b: List[str],
                      max_length: int) -> None:
    """In-place longest-first truncation (reference ``_truncate_seq_pair``)."""
    while len(tokens_a) + len(tokens_b) > max_length:
        if len(tokens_a) > len(tokens_b):
            tokens_a.pop()
        else:
            tokens_b.pop()


def tensorize_pair(tokenizer: BertTokenizer, text_a: str,
                   text_b: Optional[str], num_img_feats: int,
                   max_seq_len: int = 70,
                   max_img_seq_len: int = 50) -> TensorizedSeq:
    tokens_a = tokenizer.tokenize(text_a)
    if text_b:
        tokens_b = tokenizer.tokenize(text_b)
        truncate_seq_pair(tokens_a, tokens_b, max_seq_len - 3)
    else:
        tokens_b = []
        tokens_a = tokens_a[: max_seq_len - 2]

    tokens = ["[CLS]"] + tokens_a + ["[SEP]"]
    segments = [0] * len(tokens)
    # the b-segment is gated on the truncated list being non-empty
    # (reference ``if tokens_b:``)
    if tokens_b:
        tokens += tokens_b + ["[SEP]"]
        segments += [1] * (len(tokens_b) + 1)

    ids = tokenizer.convert_tokens_to_ids(tokens)
    attn = [1] * len(ids)
    while len(ids) < max_seq_len:
        ids.append(0)
        attn.append(0)
        segments.append(0)

    n_img = min(num_img_feats, max_img_seq_len)
    attn = attn + [1] * n_img + [0] * (max_img_seq_len - n_img)

    mask_id = tokenizer.mask_token_id
    mask_positions = [i for i, t in enumerate(ids) if t == mask_id]
    return TensorizedSeq(
        input_ids=np.asarray(ids, np.int32),
        segment_ids=np.asarray(segments, np.int32),
        attention_mask=np.asarray(attn, np.int32),
        mask_positions=mask_positions,
    )


def pad_img_feats(feats: np.ndarray, max_img_seq_len: int) -> np.ndarray:
    """[n, D] → [max_img_seq_len, D], truncating or zero-padding."""
    n, d = feats.shape
    out = np.zeros((max_img_seq_len, d), np.float32)
    out[: min(n, max_img_seq_len)] = feats[:max_img_seq_len]
    return out


@dataclasses.dataclass
class TensorizedBatch:
    """A fixed-shape batch of N sequence slots (padded with ``valid=False``)."""

    input_ids: np.ndarray       # [N, T]
    segment_ids: np.ndarray     # [N, T]
    attention_mask: np.ndarray  # [N, T + R]
    img_feats: np.ndarray       # [N, R, D]
    mask_pos: np.ndarray        # [N] first [MASK] position (0 if none)
    valid: np.ndarray           # [N] bool

    def __len__(self) -> int:
        return self.input_ids.shape[0]

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())


def stack_batch(seqs: Sequence[TensorizedSeq], feats: Sequence[np.ndarray],
                max_img_seq_len: int, img_feat_dim: int,
                pad_to: Optional[int] = None) -> TensorizedBatch:
    n = len(seqs)
    total = pad_to if pad_to is not None else n
    if total < n:
        raise ValueError(f"pad_to {total} < {n} sequences")
    t = seqs[0].input_ids.shape[0] if n else 0
    batch = TensorizedBatch(
        input_ids=np.zeros((total, t), np.int32),
        segment_ids=np.zeros((total, t), np.int32),
        attention_mask=np.zeros((total, t + max_img_seq_len), np.int32),
        img_feats=np.zeros((total, max_img_seq_len, img_feat_dim), np.float32),
        mask_pos=np.zeros((total,), np.int32),
        valid=np.zeros((total,), bool),
    )
    for i, (s, f) in enumerate(zip(seqs, feats)):
        batch.input_ids[i] = s.input_ids
        batch.segment_ids[i] = s.segment_ids
        batch.attention_mask[i] = s.attention_mask
        batch.img_feats[i] = pad_img_feats(np.asarray(f, np.float32),
                                           max_img_seq_len)
        batch.mask_pos[i] = s.mask_positions[0] if s.mask_positions else 0
        batch.valid[i] = True
    return batch
