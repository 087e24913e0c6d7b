"""The masked-LM head and ``REC_MLM_CPT`` (port of the RefCOCO scoring
model of ``cpt_tpu/models/bert/heads.py``).

The decoder is tied to the word-embedding table, read at call time.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cpt_tpu.config.bert import BertConfig
from cpt_tpu_torch.models.bert.model import (ACT, BertImgModel, Dense,
                                             LayerNorm, _param)


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
        self.bias = _param(config.vocab_size, dtype=torch.float32)

    def forward(self, hidden: torch.Tensor, word_embedding_table: torch.Tensor
                ) -> torch.Tensor:
        x = self.transform(hidden)
        logits = x @ word_embedding_table.to(x.dtype).T
        return logits + self.bias.to(x.dtype)


class REC_MLM_CPT(nn.Module):
    """RefCOCO / GQA / VG CPT model: masked-LM color-word scoring."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.bert = BertImgModel(config, dtype)
        self.mlm_head = BertLMPredictionHead(config, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, mask_pos: Optional[torch.Tensor] = None):
        """``mask_pos`` [N] or [N, k]: the MLM head (including the vocab
        projection) runs only on the hidden states gathered there — the
        same math as full scoring at those positions. → (None, logits); the
        first slot is the training loss in the JAX model, not ported."""
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask,
                           img_feats=img_feats)
        table = self.bert.embeddings.word_embeddings
        if mask_pos is not None:
            idx = (mask_pos[:, None] if mask_pos.dim() == 1 else mask_pos).long()
            gathered = torch.gather(
                seq, 1, idx[..., None].expand(-1, -1, seq.shape[-1]))
            logits = self.mlm_head(gathered, table)      # [N, k, vocab]
            if mask_pos.dim() == 1:
                logits = logits[:, 0]
            return None, logits
        return None, self.mlm_head(seq, table)
