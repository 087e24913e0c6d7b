"""Neural-Motif relation head (port of ``cpt_tpu/models/detector/motif.py``;
reference ``scene_graph_benchmark/relation_head/neural_motif/``):

  * ``roi_sorter.py``: RoIs ordered (leftright = box centre-x, confidence,
    size) before the context LSTMs;
  * ``context_encoder.py:43-323``: the object context is an LSTM over the
    sorted [box feature; soft label embedding (the detector's class
    distribution @ an embedding table); position embedding]; a decoder LSTM
    predicts labels greedily, feeding the previous label's embedding back;
    the edge context is a second LSTM over [label embedding; object context];
  * ``neuralmotif.py:90-182``: ``post_lstm_fc`` splits the edge context into
    subject / object representations, the edge is ``subj[s] · obj[o] ·
    union_feats`` (eqn 6), tanh, then the predicate classifier.

As in the JAX package (one ``lax.scan`` there) each LSTM walks the sorted,
validity-masked slot axis, its state frozen on invalid slots (the
reference's pack_padded_sequence); the reference's ``BatchNorm1d(4)`` on the
position input is a LayerNorm (flax's ``pos_norm``, at flax's epsilon 1e-6,
not torch's 1e-5, and in the input's f32).

flax's ``nn.LSTMCell`` is not torch's: its input Denses ``ii/if/ig/io`` carry
no bias, its hidden ``hi/hf/hg/ho`` do, and its carry is (c, h). The cells
here are ``torch.nn.LSTMCell``s (``weight_ih`` = [i, f, g, o] stacked,
``bias_ih`` 0, ``bias_hh`` the hidden biases; ``models/detector/convert.
params_from_jax`` maps them) on an (h, c) state, stepped by
:func:`lstm_step` in the compute dtype.

A JAX defect mirrored (ROADMAP, "Defects of the reference, mirrored"):
without ``gt_labels`` (every SceneParser call) the edge context embeds
label 0 for every object, not the decoder's predictions: ``gt_sorted`` is
zeros then, and the edge LSTM takes ``gt_sorted`` whenever it is not None,
which is always (``cpt_tpu/models/detector/motif.py:152-154,166-167``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from cpt_tpu_torch.models.bert.model import Dense, LayerNorm

FLAX_LN_EPS = 1e-6


def sort_rois(boxes: torch.Tensor, valid: torch.Tensor,
              scores: Optional[torch.Tensor] = None, order: str = "leftright"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (perm [N], inv_perm [N]), invalid slots last (``roi_sorter.py``:
    'leftright' centre-x, 'confidence', 'size'). Stable, as ``jnp.argsort``
    is: aligned boxes tie on their centre-x."""
    if order == "leftright":
        key = (boxes[:, 0] + boxes[:, 2]) / 2.0
    elif order == "confidence":
        key = -scores
    elif order == "size":
        key = -((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
    else:                                   # 'random': fixed, as under jit
        key = torch.arange(boxes.shape[0], dtype=torch.float32,
                           device=boxes.device)
    key = key.float()
    big = key.abs().max() + 1.0
    key = torch.where(valid, key, big + torch.arange(key.shape[0],
                                                     device=key.device))
    perm = torch.argsort(key, stable=True)
    return perm, torch.argsort(perm, stable=True)


def lstm_step(cell: nn.LSTMCell, x: torch.Tensor,
              state: Tuple[torch.Tensor, torch.Tensor], dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of flax ``nn.LSTMCell(dtype=dtype)`` on ``x`` [B, D] from
    the (h, c) ``state`` → the new (h, c), the gates in ``dtype``."""
    h, c = state
    return torch.lstm_cell(x.to(dtype), (h.to(dtype), c.to(dtype)),
                           cell.weight_ih.to(dtype), cell.weight_hh.to(dtype),
                           cell.bias_ih.to(dtype), cell.bias_hh.to(dtype))


def lstm_cell(fin: int, hidden: int) -> nn.LSTMCell:
    """An LSTM cell with f32 parameters whose ``bias_ih``, which flax's cell
    does not have (its input Denses carry no bias), stays 0: a hook zeroes
    its gradient (else it would train beside ``bias_hh``, doubling the
    biases' step)."""
    cell = nn.LSTMCell(fin, hidden, dtype=torch.float32)
    cell.bias_ih.register_hook(torch.zeros_like)
    return cell


class _MaskedLSTM(nn.Module):
    """The LSTM over the slot axis, frozen on invalid slots (flax's
    ``nn.scan(_MaskedLSTMCell)``; its one cell is named ``cell``)."""

    def __init__(self, fin: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.cell = lstm_cell(fin, hidden)

    def forward(self, seq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """seq [N, D] · mask [N] → outputs [N, hidden] (0 on masked slots)."""
        hidden = self.cell.hidden_size
        h = c = torch.zeros(1, hidden, dtype=self.dtype, device=seq.device)
        outs = []
        for t in range(seq.shape[0]):
            nh, nc = lstm_step(self.cell, seq[t:t + 1], (h, c), self.dtype)
            m = mask[t]
            h, c = torch.where(m, nh, h), torch.where(m, nc, c)
            outs.append(torch.where(m, nh[0], 0.0))
        return torch.stack(outs)


class _Decoder(nn.Module):
    """The greedy label decoder (flax ``nn.scan(_DecoderCell)``): an LSTM on
    [ctx; embed(previous label)], argmax over the foreground classes, the
    previous label the prediction (or, teacher-forced, the gt label)."""

    def __init__(self, num_obj_classes: int, embed_dim: int, hidden: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.num_obj_classes = num_obj_classes
        self.embed = nn.Parameter(torch.empty(num_obj_classes + 1, embed_dim))
        self.cell = lstm_cell(hidden + embed_dim, hidden)
        self.out = Dense(hidden, num_obj_classes, dtype)

    def forward(self, ctx: torch.Tensor, mask: torch.Tensor,
                forced: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """ctx [N, hidden] · mask [N] · forced [N] (teacher forcing) or None →
        (logits [N, C], preds [N]), 0 on masked slots."""
        hidden = self.cell.hidden_size
        dev = ctx.device
        h = c = torch.zeros(1, hidden, dtype=self.dtype, device=dev)
        prev = torch.tensor(self.num_obj_classes, device=dev)   # 'start'
        logits_out, preds_out = [], []
        for t in range(ctx.shape[0]):
            xin = torch.cat([ctx[t].float(), self.embed[prev]])[None]
            nh, nc = lstm_step(self.cell, xin, (h, c), self.dtype)
            logits = self.out(nh[0])
            pred = torch.argmax(logits[1:]) + 1                  # never bg
            nxt = forced[t] if forced is not None else pred
            m = mask[t]
            h, c = torch.where(m, nh, h), torch.where(m, nc, c)
            prev = torch.where(m, nxt, prev)
            logits_out.append(torch.where(m, logits, 0.0))
            preds_out.append(torch.where(m, pred, 0))
        return torch.stack(logits_out), torch.stack(preds_out)


class MotifContext(nn.Module):
    """Object + edge context encoder (``context_encoder.py``)."""

    def __init__(self, num_obj_classes: int, obj_dim: int = 2048,
                 embed_dim: int = 200, pos_embed_dim: int = 128,
                 hidden_dim: int = 256, order: str = "leftright",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_obj_classes = num_obj_classes
        self.order = order
        self.dtype = dtype
        self.obj_embed = nn.Parameter(torch.empty(num_obj_classes, embed_dim))
        self.pos_norm = LayerNorm(4, FLAX_LN_EPS)
        self.pos_embed = Dense(4, pos_embed_dim, dtype)
        self.obj_ctx_rnn = _MaskedLSTM(obj_dim + embed_dim + pos_embed_dim,
                                       hidden_dim, dtype)
        self.decoder_rnn = _Decoder(num_obj_classes, embed_dim, hidden_dim, dtype)
        self.obj_embed2 = nn.Parameter(torch.empty(num_obj_classes, embed_dim))
        self.edge_ctx_rnn = _MaskedLSTM(embed_dim + hidden_dim, hidden_dim, dtype)

    def forward(self, obj_feats, obj_dists, boxes, image_hw: Sequence,
                valid, gt_labels: Optional[torch.Tensor] = None):
        """obj_feats [N, obj_dim] · obj_dists [N, C] (the detector's class
        distributions) · boxes [N, 4] xyxy · image_hw (h, w) · valid [N] →
        (obj_logits [N, C], obj_preds [N], edge_ctx [N, hidden])."""
        n = obj_feats.shape[0]
        # an f32 table, so the soft embedding and the concatenation promote
        # to f32 as in JAX
        soft_embed = obj_dists.float() @ self.obj_embed
        h, w = float(image_hw[0]), float(image_hw[1])
        boxes = boxes.float()
        pos_in = torch.stack([boxes[:, 0] / w, boxes[:, 1] / h,
                              boxes[:, 2] / w, boxes[:, 3] / h], -1)
        pos = torch.relu(self.pos_embed(self.pos_norm(pos_in)))
        obj_pre = torch.cat([obj_feats.float(), soft_embed, pos.float()], -1)

        perm, inv = sort_rois(boxes, valid, obj_dists.float().max(-1).values,
                              self.order)
        mask = valid[perm]
        obj_ctx_sorted = self.obj_ctx_rnn(obj_pre[perm], mask)

        gt_sorted = (gt_labels[perm].long() if gt_labels is not None
                     else torch.zeros(n, dtype=torch.long, device=boxes.device))
        obj_logits_sorted, obj_preds_sorted = self.decoder_rnn(
            obj_ctx_sorted, mask, gt_sorted if gt_labels is not None else None)
        # the mirrored defect: gt_sorted is never None, so without gt labels
        # every edge embeds label 0 (not obj_preds_sorted)
        labels_for_edges = gt_sorted
        edge_in = torch.cat([
            self.obj_embed2[torch.clamp(labels_for_edges, 0,
                                        self.num_obj_classes - 1)],
            obj_ctx_sorted.float()], -1)
        edge_ctx_sorted = self.edge_ctx_rnn(edge_in, mask)
        return (obj_logits_sorted[inv], obj_preds_sorted[inv],
                edge_ctx_sorted[inv])


class NeuralMotifHead(nn.Module):
    """The motif predicate head (``neuralmotif.py:103-182``)."""

    def __init__(self, num_obj_classes: int, num_rel_classes: int = 51,
                 obj_dim: int = 2048, hidden_dim: int = 256,
                 use_tanh: bool = True, order: str = "leftright",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.obj_dim = obj_dim
        self.use_tanh = use_tanh
        self.context = MotifContext(num_obj_classes, obj_dim=obj_dim,
                                    hidden_dim=hidden_dim, order=order,
                                    dtype=dtype)
        self.post_lstm_fc = Dense(hidden_dim, 2 * obj_dim, dtype)
        self.pred_predictor = Dense(obj_dim, num_rel_classes, dtype)

    def forward(self, obj_feats, obj_dists, boxes, image_hw, obj_valid,
                union_feats, pairs, pair_valid,
                gt_labels: Optional[torch.Tensor] = None):
        """union_feats [P, obj_dim] (the union boxes' pooled features) ·
        pairs [P, 2] → (obj_logits [N, C], rel_logits [P, R], obj_preds [N])."""
        obj_logits, obj_preds, edge_ctx = self.context(
            obj_feats, obj_dists, boxes, image_hw, obj_valid, gt_labels)
        edge_rep = self.post_lstm_fc(edge_ctx).reshape(-1, 2, self.obj_dim)
        subj_rep, obj_rep = edge_rep[:, 0], edge_rep[:, 1]
        prod = subj_rep[pairs[:, 0]] * obj_rep[pairs[:, 1]] * union_feats
        if self.use_tanh:
            prod = torch.tanh(prod)
        rel_logits = self.pred_predictor(prod) * pair_valid[:, None]
        return obj_logits, rel_logits, obj_preds
