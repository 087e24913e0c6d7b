"""The CPT task models of ``cpt_tpu/models/bert/heads.py``: the masked-LM
head and ``REC_MLM_CPT`` (RefCOCO color-word scoring), and the NSP head
with ``NSPCPT`` and the twin-head ``VCRQAR_NSPCPT`` (VCR candidate
scoring). Each model's ``TASK`` names its parameter layout in
``utils/convert.py``.

The decoder is tied to the word-embedding table, read at call time and
cast to the compute dtype there (separately from the embedding lookup,
as in JAX), so autograd sums the two gradient contributions into the one
f32 table. Losses use −1 as the ignore index
(``CrossEntropyLoss(ignore_index=-1)``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cpt_tpu_torch.config.bert import BertConfig
from cpt_tpu_torch.models.bert.model import (ACT, BertImgModel, Dense,
                                             LayerNorm, _param)


def cross_entropy_ignore_index(logits: torch.Tensor, labels: torch.Tensor,
                               ignore_index: int = -1) -> torch.Tensor:
    """Mean f32 cross entropy over the positions whose label is not
    ``ignore_index`` (0 when there are none)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.act = ACT[config.hidden_act]
        self.dense = Dense(config.hidden_size, config.hidden_size, dtype)
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.act(self.dense(x)))


class BertLMPredictionHead(nn.Module):
    """MLM head; decoder weight tied to the embedding table (passed in)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.transform = BertPredictionHeadTransform(config, dtype)
        self.bias = _param(config.vocab_size)

    def forward(self, hidden: torch.Tensor, word_embedding_table: torch.Tensor
                ) -> torch.Tensor:
        x = self.transform(hidden)
        logits = x @ word_embedding_table.to(x.dtype).T
        return logits + self.bias.to(x.dtype)


class REC_MLM_CPT(nn.Module):
    """RefCOCO / GQA / VG CPT model: masked-LM color-word scoring."""

    TASK = "rec_mlm_cpt"

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.bert = BertImgModel(config, dtype)
        self.mlm_head = BertLMPredictionHead(config, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, masked_lm_labels=None,
                mask_pos: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``mask_pos`` [N] or [N, k]: the MLM head (including the vocab
        projection) runs only on the hidden states gathered there — the
        same math as full scoring at those positions — and returns
        (None, logits). Otherwise → (loss, logits) over every position,
        the loss the masked-LM cross entropy against ``masked_lm_labels``
        [N, S] (−1 ignored), or None without labels. ``generator`` feeds
        dropout in training mode."""
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask,
                           img_feats=img_feats, generator=generator)
        table = self.bert.embeddings.word_embeddings
        if mask_pos is not None:
            idx = (mask_pos[:, None] if mask_pos.dim() == 1 else mask_pos).long()
            gathered = torch.gather(
                seq, 1, idx[..., None].expand(-1, -1, seq.shape[-1]))
            logits = self.mlm_head(gathered, table)      # [N, k, vocab]
            if mask_pos.dim() == 1:
                logits = logits[:, 0]
            return None, logits
        logits = self.mlm_head(seq, table)
        if masked_lm_labels is None:
            return None, logits
        return cross_entropy_ignore_index(logits, masked_lm_labels), logits


class SeqRelationshipHead(nn.Module):
    """NSP head: Linear(hidden → num_classes) on the pooled [CLS] state."""

    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.dense = Dense(config.hidden_size, config.num_contrast_classes,
                           dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.dense(pooled)


class NSPCPT(nn.Module):
    """VCR CPT model: the pretrained NSP head scores each candidate pair."""

    TASK = "nsp_cpt"

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.bert = BertImgModel(config, dtype)
        self.nsp_head = SeqRelationshipHead(config, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, next_sentence_label=None,
                generator: Optional[torch.Generator] = None):
        """→ (loss, logits [N, 2]); the loss is the cross entropy against
        ``next_sentence_label`` [N] (−1 ignored), None without labels."""
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              img_feats=img_feats, generator=generator)
        logits = self.nsp_head(pooled)
        if next_sentence_label is None:
            return None, logits
        return cross_entropy_ignore_index(logits, next_sentence_label), logits


class VCRQAR_NSPCPT(nn.Module):
    """VCR q→ar: twin NSP heads, ``cls_ans`` for answers and ``cls_rat``
    for rationales; ``head`` ("ans" or "rat") picks one per call, and only
    that head runs."""

    TASK = "vcr_qar_nsp_cpt"

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.bert = BertImgModel(config, dtype)
        self.cls_ans = SeqRelationshipHead(config, dtype)
        self.cls_rat = SeqRelationshipHead(config, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, next_sentence_label=None, head: str = "ans",
                generator: Optional[torch.Generator] = None):
        heads = {"ans": self.cls_ans, "rat": self.cls_rat}
        if head not in heads:
            raise ValueError(f"head must be 'ans' or 'rat', got {head!r}")
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              img_feats=img_feats, generator=generator)
        logits = heads[head](pooled)
        if next_sentence_label is None:
            return None, logits
        return cross_entropy_ignore_index(logits, next_sentence_label), logits
