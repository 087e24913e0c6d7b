"""SceneParser: detection + scene-graph relations (port of
``cpt_tpu/models/detector/scene_parser.py``; reference
``scene_graph_benchmark/scene_parser.py``, the VinVL relation-training
meta-architecture). The port's ``AttrRCNN`` detects; a relation head scores
predicates over all ordered pairs of the top ``max_rel_dets`` detections.

``algorithm`` picks the head as the reference's
``MODEL.ROI_RELATION_HEAD.ALGORITHM`` registry does: ``sg_reldn`` (RelDN,
with its own union-box stage-5 extractor), ``sg_imp`` / ``sg_msdn`` /
``sg_grcnn`` (``relation_variants.py``) and ``sg_nm`` (Neural Motif,
``motif.py``), the last four fed by a shared top-level
``pred_feature_extractor``. The union boxes pool on kernel K2 and their
stage 5 runs on kernel K1, as the detector's own box head does; the heads'
Denses, cells and message passing are plain torch.

The JAX module runs the backbone twice an image: the detector's call, then
``self.detector.features(image)`` for the union pooling
(``cpt_tpu/models/detector/scene_parser.py:109,117,134,137``), the same map
twice. The port computes the C4 map once and hands it to both, which
changes no output (``tests/test_torch_scene_graph.py`` holds the outputs to
JAX's; ROADMAP, "Known and kept on purpose"): an image takes 47 + 3 + 3
K1 launches, not 97 + 6.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from cpt_tpu_torch.models.bert.heads import _TRUNC_STD
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
from cpt_tpu_torch.models.detector.config import DetectorConfig
from cpt_tpu_torch.models.detector.heads import c5_channels
from cpt_tpu_torch.models.detector.motif import NeuralMotifHead
from cpt_tpu_torch.models.detector.relation_head import (RelDNHead, all_pairs,
                                                         match_pair_labels,
                                                         relation_loss,
                                                         union_features)
from cpt_tpu_torch.models.detector.relation_variants import (GRCNNHead,
                                                             IMPHead, MSDNHead)
from cpt_tpu_torch.models.detector.resnet import ResNetC5Head

ALGORITHMS = ("sg_reldn", "sg_imp", "sg_msdn", "sg_grcnn", "sg_nm")


def _hw(image_hw) -> tuple:
    return int(image_hw[0]), int(image_hw[1])


class SceneParser(nn.Module):
    def __init__(self, config: DetectorConfig, num_rel_classes: int = 51,
                 max_rel_dets: int = 16, algorithm: str = "sg_reldn",
                 dtype: torch.dtype = torch.float32,
                 detector: Optional[AttrRCNN] = None):
        """``detector``: an ``AttrRCNN`` to share (its weights reused), else
        a new one in ``dtype``."""
        super().__init__()
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, got "
                             f"{algorithm!r}")
        self.config = config
        self.num_rel_classes = num_rel_classes
        self.max_rel_dets = max_rel_dets
        self.algorithm = algorithm
        self.dtype = dtype
        self.detector = (detector if detector is not None
                         else AttrRCNN(config, dtype))
        if algorithm == "sg_reldn":
            self.relation = RelDNHead(config, num_rel_classes, dtype)
            return
        self.pred_feature_extractor = ResNetC5Head(config.backbone, dtype)
        n_cls, d = config.roi_heads.num_classes, c5_channels(config)
        if algorithm == "sg_nm":
            self.relation = NeuralMotifHead(n_cls, num_rel_classes, obj_dim=d,
                                            dtype=dtype)
        else:
            head = {"sg_imp": IMPHead, "sg_msdn": MSDNHead,
                    "sg_grcnn": GRCNNHead}[algorithm]
            self.relation = head(n_cls, num_rel_classes, obj_dim=d, pred_dim=d,
                                 dtype=dtype)

    def relation_parameters(self) -> Dict[str, torch.Tensor]:
        """{state-dict name: tensor} of every leaf outside the detector: the
        relation head's parameters and its stage-5 extractor's FrozenBN
        buffers (trained too, as JAX's FrozenBN pairs are parameters)."""
        return {k: v for k, v in self.state_dict(keep_vars=True).items()
                if not k.startswith("detector.")}

    @torch.no_grad()
    def init_relation(self, generator: torch.Generator) -> None:
        """Draw every leaf outside the detector as flax's initializers do
        (what the JAX tools run at): Dense and conv kernels lecun_normal (a
        normal of variance 1/fan_in truncated at two standard deviations;
        GRCNN's collect units normal(0.01), the motif's ``post_lstm_fc``
        normal(10/√hidden)), the cells' hidden weights orthogonal per gate,
        the embedding tables normal(1), biases 0, FrozenBN and LayerNorm
        scales 1. Drawn on the CPU from ``generator`` in state-dict order,
        then copied to each leaf's device and dtype."""
        gates = {name: 4 if isinstance(m, nn.LSTMCell) else 3
                 for name, m in self.named_modules()
                 if isinstance(m, (nn.LSTMCell, nn.GRUCell))}
        for name, t in self.relation_parameters().items():
            parts = name.split(".")
            leaf, owner = parts[-1], parts[-2]
            shape = tuple(t.shape)
            w = torch.zeros(shape)
            if leaf in ("obj_embed", "obj_embed2", "embed"):
                w.normal_(generator=generator)
            elif leaf == "scale":
                w.fill_(1.0)
            elif leaf in ("weight_ih", "weight_hh"):
                for g in w.chunk(gates[name.rsplit(".", 1)[0]], 0):
                    if leaf == "weight_ih":
                        _lecun(g, g.shape[1], generator)
                    else:
                        nn.init.orthogonal_(g, generator=generator)
            elif leaf == "kernel" and owner == "fc" and parts[-3].startswith(
                    ("feat_c", "score_c")):
                w.normal_(generator=generator).mul_(0.01)
            elif leaf == "kernel" and owner == "post_lstm_fc":
                w.normal_(generator=generator).mul_(10.0 * (1.0 / shape[0]) ** 0.5)
            elif leaf == "kernel":
                _lecun(w, shape[0], generator)
            elif leaf == "weight":             # stage-5 convs: OIHW or HWIO
                fan_in = (shape[0] * shape[1] * shape[2] if owner == "conv2"
                          else shape[1] * shape[2] * shape[3])
                _lecun(w, fan_in, generator)
            t.copy_(w)

    def _relation_logits(self, feat_map, det, boxes, labels, feats, valid,
                         pairs, pair_valid, image_hw, freq_prior):
        if self.algorithm == "sg_reldn":
            return self.relation(feat_map, boxes, labels, feats, pairs,
                                 pair_valid, image_hw, freq_prior)
        union = union_features(self.pred_feature_extractor, self.config,
                               feat_map, boxes[pairs[:, 0]], boxes[pairs[:, 1]])
        feats = feats.to(self.dtype)
        if self.algorithm == "sg_nm":
            dists = det["scores_all"][:boxes.shape[0]].to(self.dtype)
            _obj_logits, rel_logits, _preds = self.relation(
                feats, dists, boxes, image_hw, valid, union, pairs, pair_valid)
            return rel_logits
        _obj_logits, rel_logits = self.relation(feats, union, pairs, valid,
                                                pair_valid)
        return rel_logits

    def relation_outputs(self, feat: torch.Tensor, det: Dict[str, torch.Tensor],
                         image_hw: Sequence[int],
                         freq_prior: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
        """The relation head on the detector's C4 map ``feat`` and RPN-mode
        outputs ``det`` → ``pairs`` [P, 2], ``pair_valid`` [P] and
        ``rel_logits`` [P, R] over the top ``max_rel_dets`` slots."""
        k = self.max_rel_dets
        valid = det["valid"][:k]
        pairs = all_pairs(k, device=valid.device)
        pair_valid = valid[pairs[:, 0]] & valid[pairs[:, 1]]
        rel_logits = self._relation_logits(
            feat, det, det["boxes"][:k], det["labels"][:k],
            det["box_features"][:k], valid, pairs, pair_valid, _hw(image_hw),
            freq_prior)
        return {"pairs": pairs, "pair_valid": pair_valid,
                "rel_logits": rel_logits}

    def forward(self, image: torch.Tensor, image_hw: Sequence[int],
                anchors: torch.Tensor, freq_prior: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Inference on one canvas ``image`` [H, W, 3] (as the JAX tools
        hand it: the pixels as they are) → the detector's outputs and
        :meth:`relation_outputs`'."""
        hw = _hw(image_hw)
        feat = self.detector.features(image.to(self.dtype))
        det = self.detector.detect_from_feats(feat, hw, anchors,
                                              with_attributes=False)
        return {**det, **self.relation_outputs(feat, det, hw, freq_prior)}

    def detector_outputs(self, image: torch.Tensor, det_boxes: torch.Tensor,
                         det_valid: torch.Tensor) -> tuple:
        """(C4 map, force-boxes outputs) of the detector on ``det_boxes``:
        what :meth:`relation_train_loss` reads from the frozen detector."""
        feat = self.detector.features(image.to(self.dtype))
        return feat, self.detector.force_from_feats(feat, det_boxes, det_valid)

    def relation_train_loss(self, image, image_hw, det_boxes, det_labels,
                            det_valid, gt_rels, gt_boxes, gt_valid,
                            freq_prior: Optional[torch.Tensor] = None,
                            frozen: Optional[tuple] = None) -> torch.Tensor:
        """The relation loss with given (gt) detections: the detector runs in
        force-boxes mode, pairs are labelled by ``match_pair_labels``
        (``gt_valid`` masks the relation rows), invalid pairs ignored.
        ``frozen`` is :meth:`detector_outputs`' result where the caller ran
        the detector already (under ``torch.no_grad``: it is frozen)."""
        hw = _hw(image_hw)
        feat, det = frozen if frozen is not None else self.detector_outputs(
            image, det_boxes, det_valid)
        k = min(self.max_rel_dets, det_boxes.shape[0])
        pairs = all_pairs(k, device=det_boxes.device)
        pair_valid = det_valid[pairs[:, 0]] & det_valid[pairs[:, 1]]
        rel_logits = self._relation_logits(
            feat, det, det_boxes[:k], det_labels[:k], det["box_features"][:k],
            det_valid[:k], pairs, pair_valid, hw, freq_prior)
        labels = match_pair_labels(pairs, det_boxes[:k], gt_rels, gt_boxes,
                                   gt_valid)
        return relation_loss(rel_logits, torch.where(pair_valid, labels, -1))


def _lecun(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def triplet_predictions(out: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inference output → {"<s>_<o>": predicate logits} of the valid pairs
    (the ``engine/evaluate.vg_recall_eval`` prediction layout; host side)."""
    pairs, valid, logits = (out[k].detach().cpu().numpy()
                            for k in ("pairs", "pair_valid", "rel_logits"))
    return {f"{int(p[0])}_{int(p[1])}": lg
            for p, v, lg in zip(pairs, valid, logits) if v}
