"""VinVL detector weights → the port's ``AttrRCNN`` state dict (port of
``cpt_tpu/models/detector/convert.py``).

Two sources:

* :func:`state_from_reference` — the reference ``.pth`` layout
  (maskrcnn_benchmark names ``backbone.body.*``, ``rpn.head.*``,
  ``roi_heads.box.*``), loaded natively: OIHW conv weights stay OIHW, the
  grouped 3×3 becomes HWIO for kernel K1, FrozenBatchNorm's running stats
  fold into ``(scale, bias)`` with eps 0 (reference
  ``layers/batch_norm.py:24-27``), linears keep [out, in]. Attribute-head
  keys are ignored (that head is not ported yet).
* :func:`params_from_jax` — the JAX package's detector parameter tree
  (numpy leaves), for holding the two packages against each other.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from cpt_tpu.models.detector.config import DetectorConfig


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _fold_bn(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    weight = sd[prefix + ".weight"]
    mean = sd[prefix + ".running_mean"]
    var = sd[prefix + ".running_var"]
    scale = weight / np.sqrt(var)  # eps = 0 (reference FrozenBatchNorm2d)
    return {"scale": scale.astype(np.float32),
            "bias": (sd[prefix + ".bias"] - mean * scale).astype(np.float32)}


def _stage_names(cfg: DetectorConfig):
    """(port prefix, reference prefix, block count) for every ResNet stage."""
    n = len(cfg.backbone.stage_blocks)
    for i, blocks in enumerate(cfg.backbone.stage_blocks):
        yield f"backbone.layer{i + 1}", f"backbone.body.layer{i + 1}", blocks
    head = f"layer{n + 1}"
    yield (f"box_extractor.head.{head}",
           f"roi_heads.box.feature_extractor.head.{head}",
           cfg.backbone.head_blocks)


def state_from_reference(sd: Mapping[str, Any], cfg: DetectorConfig
                         ) -> Dict[str, torch.Tensor]:
    """Reference ``.pth`` state dict → port state dict (f32 tensors; the
    model's ``load_state_dict`` casts to its own dtypes)."""
    sd = {k: _np(v) for k, v in sd.items()}
    out: Dict[str, np.ndarray] = {
        "backbone.stem.conv1.weight": sd["backbone.body.stem.conv1.weight"]}
    for k, v in _fold_bn(sd, "backbone.body.stem.bn1").items():
        out[f"backbone.stem.bn1.{k}"] = v
    for port, ref, blocks in _stage_names(cfg):
        for j in range(blocks):
            p, r = f"{port}.block_{j}", f"{ref}.{j}"
            out[f"{p}.conv1.weight"] = sd[f"{r}.conv1.weight"]
            out[f"{p}.conv2.weight"] = np.transpose(sd[f"{r}.conv2.weight"],
                                                    (2, 3, 1, 0))
            out[f"{p}.conv3.weight"] = sd[f"{r}.conv3.weight"]
            bns = [("bn1", "bn1"), ("bn2", "bn2"), ("bn3", "bn3")]
            if f"{r}.downsample.0.weight" in sd:
                out[f"{p}.downsample_conv.weight"] = sd[f"{r}.downsample.0.weight"]
                bns.append(("downsample_bn", "downsample.1"))
            for pb, rb in bns:
                for k, v in _fold_bn(sd, f"{r}.{rb}").items():
                    out[f"{p}.{pb}.{k}"] = v
    for name in ("conv", "cls_logits", "bbox_pred"):
        out[f"rpn.{name}_weight"] = sd[f"rpn.head.{name}.weight"]
        out[f"rpn.{name}_bias"] = sd[f"rpn.head.{name}.bias"]
    for name in ("cls_score", "bbox_pred"):
        for part in ("weight", "bias"):
            out[f"box_predictor.{name}.{part}"] = \
                sd[f"roi_heads.box.predictor.{name}.{part}"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def params_from_jax(tree: Mapping[str, Any], cfg: DetectorConfig
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``AttrRCNN`` params (``{"params": ...}`` or the inner tree, numpy
    or jax leaves) → port state dict."""
    t = tree.get("params", tree)

    def conv(kernel):      # HWIO → OIHW
        return np.transpose(_np(kernel), (3, 2, 0, 1))

    def bn(dst, node):
        dst["scale"] = _np(node["scale"])
        dst["bias"] = _np(node["bias"])

    out: Dict[str, np.ndarray] = {}
    bb = t["backbone"]
    out["backbone.stem.conv1.weight"] = conv(bb["stem"]["conv1"]["kernel"])
    out["backbone.stem.bn1.scale"] = _np(bb["stem"]["bn1"]["scale"])
    out["backbone.stem.bn1.bias"] = _np(bb["stem"]["bn1"]["bias"])
    n = len(cfg.backbone.stage_blocks)
    stages = [(f"backbone.layer{i + 1}", bb[f"layer{i + 1}"]) for i in range(n)]
    head = f"layer{n + 1}"
    stages.append((f"box_extractor.head.{head}",
                   t["box_extractor"]["head"][head]))
    for port, node in stages:
        for bname, blk in node.items():
            p = f"{port}.{bname}"
            for conv_name in ("conv1", "conv3", "downsample_conv"):
                if conv_name in blk:
                    out[f"{p}.{conv_name}.weight"] = conv(blk[conv_name]["kernel"])
            out[f"{p}.conv2.weight"] = _np(blk["conv2"]["kernel"])
            for bn_name in ("bn1", "bn2", "bn3", "downsample_bn"):
                if bn_name in blk:
                    for k in ("scale", "bias"):
                        out[f"{p}.{bn_name}.{k}"] = _np(blk[bn_name][k])
    rpn = t["rpn"]
    for name in ("conv", "cls_logits", "bbox_pred"):
        out[f"rpn.{name}_weight"] = conv(rpn[name]["kernel"])
        out[f"rpn.{name}_bias"] = _np(rpn[name]["bias"])
    pred = t["box_predictor"]
    for name in ("cls_score", "bbox_pred"):
        out[f"box_predictor.{name}.weight"] = _np(pred[name]["kernel"]).T
        out[f"box_predictor.{name}.bias"] = _np(pred[name]["bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load`` a checkpoint on the CPU; unwraps the
    DetectronCheckpointer ``{"model": state_dict}`` layout."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and isinstance(blob.get("model"), dict):
        blob = blob["model"]
    return blob
