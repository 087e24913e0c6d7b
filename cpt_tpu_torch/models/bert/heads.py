"""The task models of ``cpt_tpu/models/bert/heads.py``: the masked-LM
head and ``REC_MLM_CPT`` (RefCOCO color-word scoring), the NSP head with
``NSPCPT`` and the twin-head ``VCRQAR_NSPCPT`` (VCR candidate scoring), and
the full-finetune baselines ``REC_FT``, ``NSPFT``, ``VCR_QAR_NSPFT``,
``VGFT``, ``ImageBertForSequenceClassification`` and
``ImageBertForMultipleChoice``, whose classifiers start fresh
(:meth:`init_heads`, flax's default initializers). Each model's ``TASK``
names its parameter layout in ``utils/convert.py``; each attribute carries
the name of its parameters in the JAX tree.

The decoder is tied to the word-embedding table, read at call time and
cast to the compute dtype there (separately from the embedding lookup,
as in JAX), so autograd sums the two gradient contributions into the one
f32 table. Losses use −1 as the ignore index
(``CrossEntropyLoss(ignore_index=-1)``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.config.bert import BertConfig
from cpt_tpu_torch.models.bert.model import (ACT, BertImgModel, Dense, Dropout,
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
    """MLM head; decoder weight tied to the embedding table (passed in).

    ``tied=False`` gives the head its own ``decoder [V, H]`` table: the
    reference captioning model's ``config.tie_weights=False``, where a
    finetuned checkpoint's decoder has diverged from the embeddings
    (``modeling_bert.py:616-625``). The CPT heads always tie."""

    def __init__(self, config: BertConfig, dtype: torch.dtype, tied: bool = True):
        super().__init__()
        self.tied = tied
        self.transform = BertPredictionHeadTransform(config, dtype)
        if not tied:
            self.decoder = _param(config.vocab_size, config.hidden_size)
        self.bias = _param(config.vocab_size)

    def forward(self, hidden: torch.Tensor, word_embedding_table: torch.Tensor
                ) -> torch.Tensor:
        x = self.transform(hidden)
        table = word_embedding_table if self.tied else self.decoder
        logits = x @ table.to(x.dtype).T
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
    """NSP head: Linear(hidden → num_classes) on the pooled [CLS] state
    (``num_classes`` defaults to ``config.num_contrast_classes``)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype,
                 num_classes: Optional[int] = None):
        super().__init__()
        self.dense = Dense(config.hidden_size,
                           num_classes or config.num_contrast_classes, dtype)

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


# the score of an empty candidate slot (REC_FT's ``box_mask``)
ATTN_FILL = -1e4
# the standard deviation of a unit normal truncated at ±2: flax's
# ``variance_scaling(..., "truncated_normal")`` divides its scale by it
_TRUNC_STD = 0.87962566103423978


class _FreshHeads:
    """The full-finetune models' classifiers, and the caption model's MLM
    head, start fresh: :meth:`init_heads` draws every parameter outside
    ``bert`` as flax's defaults do."""

    @torch.no_grad()
    def init_heads(self, generator: torch.Generator) -> None:
        """Dense kernels from lecun_normal (a normal of variance 1/fan_in
        truncated at two standard deviations), an untied MLM ``decoder``
        from a normal of std ``initializer_range``, biases 0, LayerNorm
        scales 1, drawn on the CPU from ``generator`` (a CPU generator) in
        the order of ``named_parameters``, then copied to the parameters'
        device."""
        for name, p in self.named_parameters():
            if name.startswith("bert."):
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                std = (1.0 / p.shape[0]) ** 0.5 / _TRUNC_STD
                w = torch.empty(p.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                p.copy_(w)
            elif leaf == "decoder":
                p.copy_(torch.randn(p.shape, generator=generator)
                        * self.config.initializer_range)
            elif leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()


class REC_FT(_FreshHeads, nn.Module):
    """RefCOCO full-finetune baseline: an MLP (dense, gelu, LayerNorm,
    dense → 1) scores each image hidden state (positions ``txt_seq_len:``),
    cross entropy over the candidates. Empty slots (``box_mask`` False)
    score ``ATTN_FILL``."""

    TASK = "rec_ft"

    def __init__(self, config: BertConfig, txt_seq_len: int = 70,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.dtype = dtype
        self.txt_seq_len = txt_seq_len
        self.bert = BertImgModel(config, dtype)
        self.cls_dense = Dense(h, h, dtype)
        self.cls_LayerNorm = LayerNorm(h, 1e-12)
        self.cls_out = Dense(h, 1, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, box_mask=None, target_idx=None,
                generator: Optional[torch.Generator] = None):
        """→ (loss, scores [B, R], argmax [B]); the loss is the cross
        entropy against ``target_idx`` [B] (−1 ignored), None without."""
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask,
                           img_feats=img_feats, generator=generator)
        x = ACT["gelu"](self.cls_dense(seq[:, self.txt_seq_len:]))
        scores = self.cls_out(self.cls_LayerNorm(x))[..., 0]
        if box_mask is not None:
            scores = torch.where(box_mask.bool(), scores, ATTN_FILL)
        loss = (None if target_idx is None
                else cross_entropy_ignore_index(scores, target_idx))
        return loss, scores, scores.argmax(-1)


class NSPFT(_FreshHeads, nn.Module):
    """VCR full-finetune baseline: a fresh Linear(hidden → 2) on the pooled
    output."""

    TASK = "nsp_ft"

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.bert = BertImgModel(config, dtype)
        self.classifier = SeqRelationshipHead(config, dtype, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, next_sentence_label=None,
                generator: Optional[torch.Generator] = None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              img_feats=img_feats, generator=generator)
        logits = self.classifier(pooled)
        if next_sentence_label is None:
            return None, logits
        return cross_entropy_ignore_index(logits, next_sentence_label), logits


class VCR_QAR_NSPFT(_FreshHeads, nn.Module):
    """VCR q→ar full-finetune baseline: twin fresh classifiers,
    ``classifier_ans`` and ``classifier_rat``, ``head`` picks one."""

    TASK = "vcr_qar_nsp_ft"

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.bert = BertImgModel(config, dtype)
        self.classifier_ans = SeqRelationshipHead(config, dtype, 2)
        self.classifier_rat = SeqRelationshipHead(config, dtype, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, next_sentence_label=None, head: str = "ans",
                generator: Optional[torch.Generator] = None):
        heads = {"ans": self.classifier_ans, "rat": self.classifier_rat}
        if head not in heads:
            raise ValueError(f"head must be 'ans' or 'rat', got {head!r}")
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              img_feats=img_feats, generator=generator)
        logits = heads[head](pooled)
        if next_sentence_label is None:
            return None, logits
        return cross_entropy_ignore_index(logits, next_sentence_label), logits


class VGFT(_FreshHeads, nn.Module):
    """VG relation full-finetune baseline: the subject's and the object's
    image hidden states (positions ``txt_seq_len + pairs[..., 0|1]``),
    concatenated, through a fresh Linear(2·hidden → ``num_rel_classes``);
    cross entropy over predicates, −100 ignored (padded pair slots)."""

    TASK = "vg_ft"

    def __init__(self, config: BertConfig, num_rel_classes: int = 51,
                 txt_seq_len: int = 70, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.txt_seq_len = txt_seq_len
        self.bert = BertImgModel(config, dtype)
        self.classifier = Dense(2 * config.hidden_size, num_rel_classes, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, pairs=None, rel_labels=None,
                generator: Optional[torch.Generator] = None):
        """``pairs`` [B, P, 2] region indices → (loss, logits [B, P, C])."""
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask,
                           img_feats=img_feats, generator=generator)
        img_hidden = seq[:, self.txt_seq_len:]                  # [B, R, H]
        h = img_hidden.shape[-1]

        def take(idx):
            return torch.gather(img_hidden, 1,
                                idx.long()[..., None].expand(-1, -1, h))

        logits = self.classifier(torch.cat([take(pairs[..., 0]),
                                            take(pairs[..., 1])], -1))
        if rel_labels is None:
            return None, logits
        return cross_entropy_ignore_index(logits, rel_labels, -100), logits


def _classifier_loss(logits: torch.Tensor, labels: torch.Tensor,
                     loss_type: str) -> torch.Tensor:
    """The sequence classifier's loss in f32: ``"kl"`` (KL divergence to
    soft labels, summed, over the batch), ``"bce"`` (mean binary cross
    entropy × the number of labels) or ``"xe"`` (cross entropy, −1
    ignored)."""
    lf32 = logits.float()
    if loss_type == "kl":
        labels = labels.float()
        logp = torch.log_softmax(lf32, dim=-1)
        log_labels = torch.where(labels > 0,
                                 torch.log(torch.clamp(labels, min=1e-12)), 0.0)
        return (labels * (log_labels - logp)).sum() / labels.shape[0]
    if loss_type == "bce":
        labels = labels.float()
        p, n = F.logsigmoid(lf32), F.logsigmoid(-lf32)
        return -(labels * p + (1 - labels) * n).mean() * labels.shape[1]
    return cross_entropy_ignore_index(lf32, labels)


class ImageBertForSequenceClassification(_FreshHeads, nn.Module):
    """GQA / VQA / retrieval classifier over the pooled output:
    ``config.classifier`` "linear" (``cls_out``) or "mlp" (``cls_hidden``,
    ReLU, ``cls_out``), after a dropout of the pooled output (its mask from
    the step's generator); ``config.loss_type`` xe, kl or bce."""

    TASK = "seq_classification"

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.bert = BertImgModel(c, dtype)
        self.cls_dropout = Dropout(c.hidden_dropout_prob)
        width = c.hidden_size
        self.cls_hidden = None
        if c.classifier == "mlp":
            width = c.hidden_size * c.cls_hidden_scale
            self.cls_hidden = Dense(c.hidden_size, width, dtype)
        self.cls_out = Dense(width, c.num_labels, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, labels=None,
                generator: Optional[torch.Generator] = None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              img_feats=img_feats, generator=generator)
        x = self.cls_dropout(pooled, generator)
        if self.cls_hidden is not None:
            x = F.relu(self.cls_hidden(x))
        logits = self.cls_out(x)
        if labels is None:
            return None, logits
        return _classifier_loss(logits, labels, self.config.loss_type), logits


class ImageBertForMultipleChoice(_FreshHeads, nn.Module):
    """NLVR2-style multiple choice: ``[B, num_choices, ...]`` inputs are
    encoded as ``B·num_choices`` sequences, and the classifier reads the
    concatenation of each example's pooled outputs (``[B, nc·hidden]``);
    "mlp" is ``cls_hidden``, ReLU, ``cls_LayerNorm`` (with
    ``use_img_layernorm``), ``cls_out``. Cross entropy, −1 ignored."""

    TASK = "multiple_choice"

    def __init__(self, config: BertConfig, num_choices: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.num_choices = num_choices
        self.bert = BertImgModel(c, dtype)
        self.cls_dropout = Dropout(c.hidden_dropout_prob)
        width = num_choices * c.hidden_size
        self.cls_hidden = self.cls_LayerNorm = None
        if c.classifier == "mlp":
            self.cls_hidden = Dense(width, c.hidden_size * c.cls_hidden_scale,
                                    dtype)
            width = c.hidden_size * c.cls_hidden_scale
            if c.use_img_layernorm:
                self.cls_LayerNorm = LayerNorm(width, c.layer_norm_eps)
        self.cls_out = Dense(width, c.num_labels, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                img_feats=None, labels=None,
                generator: Optional[torch.Generator] = None):
        b, nc = input_ids.shape[:2]

        def flat(x):
            return None if x is None else x.reshape((b * nc,) + x.shape[2:])

        _, pooled = self.bert(flat(input_ids), flat(token_type_ids),
                              flat(attention_mask), img_feats=flat(img_feats),
                              generator=generator)
        x = self.cls_dropout(pooled, generator).reshape(b, -1)
        if self.cls_hidden is not None:
            x = F.relu(self.cls_hidden(x))
            if self.cls_LayerNorm is not None:
                x = self.cls_LayerNorm(x)
        logits = self.cls_out(x)
        if labels is None:
            return None, logits
        return cross_entropy_ignore_index(logits, labels), logits
