"""Scene-graph relation-head variants: IMP, MSDN, GRCNN and the learned RelPN
(port of ``cpt_tpu/models/detector/relation_variants.py``; the reference's
non-RelDN algorithms, ``scene_graph_benchmark/relation_head/``):

  * IMP (``imp/imp.py:17-126``): gated message passing between object nodes
    and predicate edges with GRU updates, gates shared across steps;
  * MSDN (``msdn/msdn.py``, ``msdn_base.py``): message-passing units
    (v1: the mean of sigmoid(W·[unary; pair]) gates the pair term) and a
    linear "GRU" with residual updates;
  * GRCNN (``grcnn/grcnn.py`` + ``agcn/agcn.py``): attentional GCN collect
    (relu(W·source), incidence-normalised) and an additive update, at the
    feature level, then again at the score level;
  * RelPN relationshipness (``relpn/relationshipness.py:9-54``): a bilinear
    64-d subject/object scorer (+ optional 6-d box position encoders),
    sigmoid, to pick top-K candidate pairs.

As in the JAX package the per-edge ``index_select`` / ``scatter_`` loops are
dense one-hot incidence maps ([N, P] subject / object) and matmuls, with
validity masks; the update loops are unrolled. Each head takes the pooled
box features [N, F] and the union-box features [P, F] that
``scene_parser.SceneParser`` computes (K2 and K1); the heads themselves are
plain torch, as JAX leaves them to XLA.

flax's ``nn.GRUCell`` is not torch's: its input Denses ``ir/iz/in`` carry
biases, the hidden ``hr/hz`` none and ``hn`` one. The cells here are
``torch.nn.GRUCell``s whose ``bias_hh`` is [0, 0, b_hn]
(``models/detector/convert.params_from_jax`` maps them), stepped by
:func:`gru_step` in the compute dtype from f32 parameters (flax's
``dtype=`` semantics). GRCNN's collect units compute in f32, as their
flax modules carry no dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.models.bert.model import Dense


def incidence_maps(pairs: torch.Tensor, num_objs: int, pair_valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pairs [P, 2] → (subj_map [N, P], obj_map [N, P]) 0/1 incidence (the
    reference's ``_get_map_idxs`` scatter, built densely)."""
    v = pair_valid.float()
    subj = F.one_hot(pairs[:, 0].long(), num_objs).T.float() * v[None, :]
    obj = F.one_hot(pairs[:, 1].long(), num_objs).T.float() * v[None, :]
    return subj, obj


def add_mlp2(module: nn.Module, name: str, fin: int, dim: int,
             dtype: torch.dtype) -> None:
    """The two Denses of flax ``_mlp2(x, dim, name)`` on ``module``:
    ``{name}_fc1`` and ``{name}_fc2``."""
    setattr(module, f"{name}_fc1", Dense(fin, dim, dtype))
    setattr(module, f"{name}_fc2", Dense(dim, dim, dtype))


def mlp2(module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(getattr(module, f"{name}_fc1")(x))
    return getattr(module, f"{name}_fc2")(x)


def gru_cell(dim: int) -> nn.GRUCell:
    """A GRU cell with f32 parameters (``torch.nn.GRUCell`` layout) whose
    ``bias_hh`` slots for r and z, which flax's cell does not have, stay 0:
    a hook zeroes their gradient."""
    cell = nn.GRUCell(dim, dim, dtype=torch.float32)
    keep = torch.ones(3 * dim)
    keep[:2 * dim] = 0
    cell.bias_hh.register_hook(lambda g: g * keep.to(g.device, g.dtype))
    return cell


def gru_step(cell: nn.GRUCell, h: torch.Tensor, x: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """One step of flax ``nn.GRUCell(dtype=dtype)`` on carry ``h`` and input
    ``x`` → the new carry: every gate in ``dtype``. With ``bias_hh`` = [0, 0,
    b_hn], torch's ``n = tanh(W_in x + b_in + r·(W_hn h + b_hn))`` is flax's
    ``tanh(in(x) + r·hn(h))``."""
    return torch.gru_cell(x.to(dtype), h.to(dtype), cell.weight_ih.to(dtype),
                          cell.weight_hh.to(dtype), cell.bias_ih.to(dtype),
                          cell.bias_hh.to(dtype))


class IMPHead(nn.Module):
    """Iterative message passing (``imp/imp.py``): object / predicate
    features in → (obj_logits [N, C], rel_logits [P, R])."""

    def __init__(self, num_obj_classes: int, num_rel_classes: int = 51,
                 obj_dim: int = 2048, pred_dim: int = 2048, dim: int = 512,
                 update_step: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.update_step = update_step
        add_mlp2(self, "obj_embedding", obj_dim, dim, dtype)
        add_mlp2(self, "pred_embedding", pred_dim, dim, dtype)
        self.node_gru = gru_cell(dim)
        self.edge_gru = gru_cell(dim)
        for k in ("subj_node", "obj_node", "subj_edge", "obj_edge"):
            setattr(self, f"{k}_gate", Dense(2 * dim, 1, dtype))
        self.obj_predictor = Dense(dim, num_obj_classes, dtype)
        self.pred_predictor = Dense(dim, num_rel_classes, dtype)

    def forward(self, obj_feats, pred_feats, pairs, obj_valid, pair_valid):
        n = obj_feats.shape[0]
        subj_map, obj_map = incidence_maps(pairs, n, pair_valid)
        subj_map, obj_map = subj_map.to(self.dtype), obj_map.to(self.dtype)
        h_obj = mlp2(self, "obj_embedding", obj_feats)
        h_edge = mlp2(self, "pred_embedding", pred_feats)
        s, o = pairs[:, 0], pairs[:, 1]
        for _ in range(self.update_step):
            sub_vert, obj_vert = h_obj[s], h_obj[o]
            g_ps = torch.sigmoid(self.subj_node_gate(torch.cat([sub_vert, h_edge], 1)))
            g_po = torch.sigmoid(self.obj_node_gate(torch.cat([obj_vert, h_edge], 1)))
            node_msg = (subj_map @ (g_ps * h_edge)
                        / (subj_map.sum(1, keepdim=True) + 1e-5)
                        + obj_map @ (g_po * h_edge)
                        / (obj_map.sum(1, keepdim=True) + 1e-5)) / 2.0
            h_obj = gru_step(self.node_gru, h_obj, node_msg, self.dtype)

            g_sp = torch.sigmoid(self.subj_edge_gate(torch.cat([sub_vert, h_edge], 1)))
            g_op = torch.sigmoid(self.obj_edge_gate(torch.cat([obj_vert, h_edge], 1)))
            edge_msg = (g_sp * sub_vert + g_op * obj_vert) / 2.0
            h_edge = gru_step(self.edge_gru, h_edge, edge_msg, self.dtype)
        return self.obj_predictor(h_obj), self.pred_predictor(h_edge)


class _MPU(nn.Module):
    """Message_Passing_Unit_v1 (``msdn_base.py:38-63``): the mean of a
    sigmoid gate on [unary; pair] scales the pair term."""

    def __init__(self, dim: int, filter_size: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w = Dense(2 * dim, filter_size, dtype)

    def forward(self, unary: torch.Tensor, pair: torch.Tensor) -> torch.Tensor:
        gate = self.w(torch.relu(torch.cat([unary, pair], 1)))
        return pair * torch.sigmoid(gate).mean(1, keepdim=True)


class _LinearGRU(nn.Module):
    """Gated_Recurrent_Unit (``msdn_base.py:66-78``): W_ih·relu(x) +
    W_hh·relu(h)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.wih = Dense(dim, dim, dtype)
        self.whh = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.wih(torch.relu(x)) + self.whh(torch.relu(h))


class MSDNHead(nn.Module):
    """Multi-level scene description network (``msdn/msdn.py``)."""

    def __init__(self, num_obj_classes: int, num_rel_classes: int = 51,
                 obj_dim: int = 2048, pred_dim: int = 2048, dim: int = 1024,
                 update_step: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.update_step = update_step
        add_mlp2(self, "obj_embedding", obj_dim, dim, dtype)
        add_mlp2(self, "rel_embedding", pred_dim, dim, dtype)
        for name in ("gate_pred2sub", "gate_pred2obj", "gate_sub2pred",
                     "gate_obj2pred"):
            setattr(self, name, _MPU(dim, dtype=dtype))
        self.gru_object = _LinearGRU(dim, dtype)
        self.gru_pred = _LinearGRU(dim, dtype)
        self.obj_predictor = Dense(dim, num_obj_classes, dtype)
        self.pred_predictor = Dense(dim, num_rel_classes, dtype)

    def forward(self, obj_feats, pred_feats, pairs, obj_valid, pair_valid):
        n = obj_feats.shape[0]
        subj_map, obj_map = incidence_maps(pairs, n, pair_valid)
        subj_map, obj_map = subj_map.to(self.dtype), obj_map.to(self.dtype)
        x_obj = mlp2(self, "obj_embedding", obj_feats)
        x_pred = mlp2(self, "rel_embedding", pred_feats)
        s, o = pairs[:, 0], pairs[:, 1]
        for _ in range(self.update_step):
            sub_vert, obj_vert = x_obj[s], x_obj[o]
            m_sub = self.gate_pred2sub(sub_vert, x_pred)
            m_obj = self.gate_pred2obj(obj_vert, x_pred)
            obj_in = ((subj_map @ m_sub) / (subj_map.sum(1, keepdim=True) + 1e-5)
                      + (obj_map @ m_obj) / (obj_map.sum(1, keepdim=True) + 1e-5)
                      ) / 2.0
            x_obj_new = x_obj + self.gru_object(obj_in, x_obj)
            pred_in = (self.gate_sub2pred(x_pred, sub_vert) / 2.0
                       + self.gate_obj2pred(x_pred, obj_vert) / 2.0)
            x_pred = x_pred + self.gru_pred(pred_in, x_pred)
            x_obj = x_obj_new
        return self.obj_predictor(x_obj), self.pred_predictor(x_pred)


class _Collect(nn.Module):
    """_Collection_Unit (``agcn.py:18-30``): incidence-normalised attention @
    relu(W·source), in f32 (the flax unit has no dtype)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.fc = Dense(dim_in, dim_out, torch.float32)

    def forward(self, source: torch.Tensor, attention: torch.Tensor) -> torch.Tensor:
        out = attention.float() @ torch.relu(self.fc(source))
        return out / (attention.float().sum(1, keepdim=True) + 1e-7)


# GRCNN's collect units by role, in the order of their flax names c0 .. c4
_GRCNN_UNITS = ("obj_from_rel_s", "obj_from_rel_o", "rel_from_obj_s",
                "rel_from_obj_o", "obj_from_obj")


class GRCNNHead(nn.Module):
    """Graph R-CNN attentional GCN (``grcnn/grcnn.py``): feature-level
    message rounds, then score-level rounds. ``obj_scores_all`` (the
    detector's per-class scores) is accepted and unused, as in JAX."""

    def __init__(self, num_obj_classes: int, num_rel_classes: int = 51,
                 obj_dim: int = 2048, pred_dim: int = 2048, dim: int = 1024,
                 feat_update_step: int = 2, score_update_step: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.feat_update_step = feat_update_step
        self.score_update_step = score_update_step
        add_mlp2(self, "obj_embedding", obj_dim, dim, dtype)
        add_mlp2(self, "rel_embedding", pred_dim, dim, dtype)
        c, r = num_obj_classes, num_rel_classes
        # (source width, output width) of each role at the score level
        score_io = {"obj_from_rel_s": (r, c), "obj_from_rel_o": (r, c),
                    "rel_from_obj_s": (c, r), "rel_from_obj_o": (c, r),
                    "obj_from_obj": (c, c)}
        for i, role in enumerate(_GRCNN_UNITS):
            setattr(self, f"feat_c{i}", _Collect(dim, dim))
            setattr(self, f"score_c{i}", _Collect(*score_io[role]))
        self.obj_predictor = Dense(dim, c, dtype)
        self.pred_predictor = Dense(dim, r, dtype)

    def _round(self, level: str, x_obj, x_pred, maps):
        u = {role: getattr(self, f"{level}_c{i}")
             for i, role in enumerate(_GRCNN_UNITS)}
        subj_map, obj_map, obj_obj = maps
        src_obj = u["obj_from_obj"](x_obj, obj_obj)
        src_sub = u["obj_from_rel_s"](x_pred, subj_map)
        src_o = u["obj_from_rel_o"](x_pred, obj_map)
        new_obj = x_obj + (src_obj + src_sub + src_o) / 3.0
        src_s2r = u["rel_from_obj_s"](x_obj, subj_map.T)
        src_o2r = u["rel_from_obj_o"](x_obj, obj_map.T)
        return new_obj, x_pred + (src_s2r + src_o2r) / 2.0

    def forward(self, obj_feats, pred_feats, pairs, obj_valid, pair_valid,
                obj_scores_all: Optional[torch.Tensor] = None):
        n = obj_feats.shape[0]
        subj_map, obj_map = incidence_maps(pairs, n, pair_valid)
        ov = obj_valid.float()
        eye = torch.eye(n, device=ov.device)
        maps = (subj_map, obj_map, (1.0 - eye) * ov[:, None] * ov[None, :])
        x_obj = mlp2(self, "obj_embedding", obj_feats)
        x_pred = mlp2(self, "rel_embedding", pred_feats)
        for _ in range(self.feat_update_step):
            x_obj, x_pred = self._round("feat", x_obj, x_pred, maps)
        obj_logits = self.obj_predictor(x_obj)
        rel_logits = self.pred_predictor(x_pred)
        for _ in range(self.score_update_step):
            obj_logits, rel_logits = self._round("score", obj_logits,
                                                 rel_logits, maps)
        return obj_logits, rel_logits


class Relationshipness(nn.Module):
    """RelPN pair scorer (``relpn/relationshipness.py``): [N, N] sigmoid
    relationshipness from 64-d subject / object projections (+ optional box
    position encoders over normalised (x1, y1, x2, y2, cx, cy))."""

    def __init__(self, feat_dim: int, pos_encoding: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_encoding = pos_encoding
        add_mlp2(self, "subj_proj", feat_dim, 64, dtype)
        add_mlp2(self, "obj_proj", feat_dim, 64, dtype)
        if pos_encoding:
            add_mlp2(self, "sub_pos_encoder", 6, 64, dtype)
            add_mlp2(self, "obj_pos_encoder", 6, 64, dtype)

    def forward(self, x: torch.Tensor, boxes: Optional[torch.Tensor] = None,
                image_hw: Optional[Sequence] = None) -> torch.Tensor:
        scores = mlp2(self, "subj_proj", x) @ mlp2(self, "obj_proj", x).T
        if self.pos_encoding:
            h, w = float(image_hw[0]), float(image_hw[1])
            pos = torch.stack([boxes[:, 0] / w, boxes[:, 1] / h,
                               boxes[:, 2] / w, boxes[:, 3] / h,
                               (boxes[:, 0] + boxes[:, 2]) / 2 / w,
                               (boxes[:, 1] + boxes[:, 3]) / 2 / h], -1)
            scores = scores + (mlp2(self, "sub_pos_encoder", pos)
                               @ mlp2(self, "obj_pos_encoder", pos).T)
        return torch.sigmoid(scores)


def _off_diagonal(obj_valid: torch.Tensor) -> torch.Tensor:
    n = obj_valid.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=obj_valid.device)
    return obj_valid[:, None] & obj_valid[None, :] & ~eye


def relpn_select_pairs(relness: torch.Tensor, obj_valid: torch.Tensor,
                       top_k: int) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Top-K off-diagonal pairs by relationshipness (``relpn.py`` proposal
    selection, static shapes; ``lax.top_k``'s ties, the lower index first)
    → (pairs [K, 2], scores [K], valid [K])."""
    n = relness.shape[0]
    flat = torch.where(_off_diagonal(obj_valid).reshape(-1),
                       relness.reshape(-1), -1.0)
    k = min(top_k, n * n)
    scores, idx = torch.sort(flat, descending=True, stable=True)
    scores, idx = scores[:k], idx[:k]
    return torch.stack([idx // n, idx % n], -1), scores, scores >= 0.0


def relpn_loss(relness: torch.Tensor, gt_adjacency: torch.Tensor,
               obj_valid: torch.Tensor) -> torch.Tensor:
    """RelPN training loss (``relpn/relpn.py:147-160``): BCE between the
    [N, N] relationshipness and the gt pair adjacency, the diagonal and the
    invalid slots masked out."""
    ok = _off_diagonal(obj_valid)
    r = torch.clamp(relness.float(), 1e-7, 1 - 1e-7)
    y = gt_adjacency.float()
    bce = -(y * torch.log(r) + (1 - y) * torch.log(1 - r))
    return torch.where(ok, bce, 0.0).sum() / torch.clamp(ok.sum(), min=1)
