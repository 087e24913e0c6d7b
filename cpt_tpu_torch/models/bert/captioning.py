"""Image captioning on the Oscar stack (port of
``cpt_tpu/models/bert/captioning.py``).

As the reference ``BertForImageCaptioning``
(``Oscar/oscar/modeling/modeling_bert.py:575-913``) and
``CaptionTensorizer`` (``run_captioning.py:198-326``) do it:

  * sequence layout ``[CLS] caption [SEP] (pad to max_seq_a) od_labels
    [SEP]`` + image features;
  * seq2seq attention: triangular caption→caption, full caption→context,
    the context blocks do not attend back to the caption. The mask is a
    full ``[S, S]`` matrix per example, so the model's attention bias is
    ``[B, 1, S, S]``: under ``attention_impl="auto"`` the layers bypass
    kernel K3 (it takes a key-only bias) and run K4, under ``"flash"``
    kernel K6 reads the bias through its four strides;
  * training: BERT-style random caption-token masking (80/10/10), the loss
    a label-smoothed KL with optional drop-worst (``BertCaptioningLoss``,
    ``modeling_bert.py:575-600``).

``caption_attention_mask`` and ``CaptionTensorizer`` are numpy and
``random.Random``: the JAX module's code (``tests/test_torch_isolation.py``
holds them to it).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.config.bert import BertConfig
from cpt_tpu_torch.models.bert.heads import BertLMPredictionHead, _FreshHeads
from cpt_tpu_torch.models.bert.model import BertImgModel


class BertForImageCaptioning(_FreshHeads, nn.Module):
    """Oscar encoder + the MLM head, its decoder tied to the word
    embeddings by ``config.tie_weights`` (``modeling_bert.py:616-625``; the
    reference caption recipes default to an untied decoder). The head
    starts fresh (:meth:`init_heads`) where a checkpoint gives the encoder
    alone, as the JAX runner loads it."""

    TASK = "caption"

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.bert = BertImgModel(config, dtype)
        self.mlm_head = BertLMPredictionHead(config, dtype,
                                             tied=config.tie_weights)

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                img_feats=None, masked_pos=None, masked_ids=None,
                label_smoothing: float = 0.1, drop_worst_ratio: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """Training / scoring forward. ``attention_mask`` [B, S, S] is the
        seq2seq mask. With ``masked_pos`` [B, M] the head runs on the
        hidden states gathered there → (loss against ``masked_ids``, or
        None without them; logits [B, M, V]); without → (None, logits of
        every position). ``drop_worst_ratio``: the share of highest-loss
        slots left out (switching it on after ``--drop_worst_after`` steps
        is the caller's job). ``generator`` feeds dropout in training
        mode."""
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask,
                           img_feats=img_feats, generator=generator)
        table = self.bert.embeddings.word_embeddings
        if masked_pos is None:
            return None, self.mlm_head(seq, table)
        idx = masked_pos.long()[..., None].expand(-1, -1, seq.shape[-1])
        logits = self.mlm_head(torch.gather(seq, 1, idx), table)
        if masked_ids is None:
            return None, logits
        loss = smoothed_caption_loss(logits, masked_ids, label_smoothing,
                                     drop_worst_ratio)
        return loss, logits


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, in
    descending order, the lower index first among ties: ``jax.lax.top_k``'s
    order, which ``torch.topk`` does not promise (and on CUDA does not
    keep). The result is a stable descending sort sliced to ``k``, found
    in linear time: ``torch.topk`` gives the k-th value, every entry above
    it is taken and the entries equal to it by ascending index, and only
    those ``k`` are sorted (no host sync). ``k`` ≤ the axis' length."""
    n = x.shape[-1]
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > kth
    tied = x == kth
    need = k - above.sum(-1, keepdim=True)
    take = above | (tied & (torch.cumsum(tied, -1) <= need))
    # the k taken entries by ascending index: the lower index, the higher key
    rank = torch.arange(n, 0, -1, device=x.device)
    idx = torch.topk(torch.where(take, rank, 0), k, dim=-1).indices
    values = torch.gather(x, -1, idx)
    order = torch.sort(values, dim=-1, descending=True, stable=True).indices
    return torch.gather(values, -1, order), torch.gather(idx, -1, order)


def smoothed_caption_loss(logits: torch.Tensor, targets: torch.Tensor,
                          label_smoothing: float = 0.1,
                          drop_worst_ratio: float = 0.0) -> torch.Tensor:
    """Label-smoothed KL loss over the masked slots in f32; ``targets ==
    0`` (the PAD id) marks padding slots, which are left out, as the
    reference's ``masked_ids[masked_ids != 0]`` (``modeling_bert.py:
    647-649``). ``drop_worst_ratio`` keeps the ``int(n · (1 − ratio))``
    slots of least loss among all ``n`` (padding counts as worst)."""
    logits = logits.float().reshape(-1, logits.shape[-1])
    targets = targets.reshape(-1).long()
    n_class = logits.shape[-1]
    eps = label_smoothing
    one_hot = F.one_hot(targets, n_class).float()
    smooth = one_hot * (1 - eps) + (1 - one_hot) * eps / (n_class - 1)
    logp = torch.log_softmax(logits, dim=-1)
    per_slot = torch.sum(smooth * (torch.log(torch.clamp(smooth, min=1e-20))
                                   - logp), dim=-1)
    valid = targets != 0
    if drop_worst_ratio > 0:
        k = int(per_slot.shape[0] * (1 - drop_worst_ratio))
        per_slot = -top_k_stable(-torch.where(valid, per_slot, torch.inf), k)[0]
        valid = torch.isfinite(per_slot)
        per_slot = torch.where(valid, per_slot, 0.0)
    return (torch.where(valid, per_slot, 0.0).sum()
            / torch.clamp(valid.sum(), min=1))


def caption_attention_mask(max_seq_a: int, od_len: int, img_len: int,
                           seq_a_len: int, od_valid: int, img_valid: int
                           ) -> np.ndarray:
    """[S, S] mask (reference ``run_captioning.py:300-318``): triangular
    caption block (rows/cols < seq_a_len), full context blocks, caption
    attends to context, context does not attend to caption."""
    s = max_seq_a + od_len + img_len
    m = np.zeros((s, s), np.int32)
    tri = np.tril(np.ones((seq_a_len, seq_a_len), np.int32))
    m[:seq_a_len, :seq_a_len] = tri
    l0, l1 = max_seq_a, max_seq_a + od_valid
    r0, r1 = max_seq_a + od_len, max_seq_a + od_len + img_valid
    m[l0:l1, l0:l1] = 1
    m[r0:r1, r0:r1] = 1
    m[:seq_a_len, l0:l1] = 1
    m[:seq_a_len, r0:r1] = 1
    m[l0:l1, r0:r1] = 1
    m[r0:r1, l0:l1] = 1
    return m


@dataclasses.dataclass
class CaptionTensorizer:
    """Host-side example builder (reference ``CaptionTensorizer``)."""

    tokenizer: Any
    max_img_seq_len: int = 50
    max_seq_len: int = 70
    max_seq_a_len: int = 40
    mask_prob: float = 0.15
    max_masked_tokens: int = 3
    is_train: bool = True

    def tensorize(self, text_a: str, img_feats: np.ndarray,
                  text_b: Optional[str] = None,
                  rng: Optional[random.Random] = None):
        tok = self.tokenizer
        rng = rng or random.Random(0)
        if self.is_train:
            tokens_a = tok.tokenize(text_a)[: self.max_seq_a_len - 2]
        else:
            tokens_a = ["[MASK]"] * (self.max_seq_a_len - 2)
        tokens = ["[CLS]"] + tokens_a + ["[SEP]"]
        segment_ids = [0] * len(tokens)
        seq_a_len = len(tokens)
        if text_b is not None:
            tokens += ["[PAD]"] * (self.max_seq_a_len - seq_a_len)
            segment_ids += [0] * (self.max_seq_a_len - seq_a_len)
            tokens_b = tok.tokenize(text_b)[: self.max_seq_len - len(tokens) - 1]
            tokens += tokens_b + ["[SEP]"]
            segment_ids += [1] * (len(tokens_b) + 1)

        # fixed-slot masking: positions [max_masked_tokens] (pad 0) + target
        # ids (pad 0 → excluded by the loss), replacing the reference's
        # dynamic boolean gather
        masked_pos = np.zeros(self.max_masked_tokens, np.int32)
        masked_ids = np.zeros(self.max_masked_tokens, np.int32)
        if self.is_train:
            candidates = list(range(1, seq_a_len))
            rng.shuffle(candidates)
            num = int(min(max(round(self.mask_prob * seq_a_len), 1),
                          self.max_masked_tokens))
            chosen = sorted(candidates[:num])
            for j, pos in enumerate(chosen):
                masked_ids[j] = tok.convert_tokens_to_ids(tokens[pos])
                masked_pos[j] = pos
                r = rng.random()
                if r <= 0.8:
                    tokens[pos] = "[MASK]"
                elif r <= 0.9:
                    tokens[pos] = rng.choice(list(tok.vocab.keys()))

        ids = tok.convert_tokens_to_ids(tokens)
        while len(ids) < self.max_seq_len:
            ids.append(0)
            segment_ids.append(0)
        od_len = self.max_seq_len - self.max_seq_a_len
        od_valid = (len(tokens) - self.max_seq_a_len
                    if text_b is not None else 0)
        img_valid = min(img_feats.shape[0], self.max_img_seq_len)
        attn = caption_attention_mask(self.max_seq_a_len, od_len,
                                      self.max_img_seq_len, seq_a_len,
                                      max(od_valid, 0), img_valid)
        feats = np.zeros((self.max_img_seq_len, img_feats.shape[1]),
                         np.float32)
        feats[:img_valid] = img_feats[:img_valid]
        return (np.asarray(ids, np.int32), np.asarray(segment_ids, np.int32),
                attn, feats, masked_pos, masked_ids, seq_a_len)
