"""VinVL detector weights → the port's ``AttrRCNN`` state dict (port of
``cpt_tpu/models/detector/convert.py``).

Two sources:

* :func:`state_from_reference` — the reference ``.pth`` layout
  (maskrcnn_benchmark names ``backbone.body.*``, ``rpn.head.*``,
  ``roi_heads.box.*``, ``attribute.*``), loaded natively: OIHW conv weights
  stay OIHW, the grouped 3×3 becomes HWIO for kernel K1, FrozenBatchNorm's
  running stats fold into ``(scale, bias)`` with eps 0 (reference
  ``layers/batch_norm.py:24-27``), linears keep [out, in], the class
  embedding is copied. The attribute head maps when the checkpoint has it
  (as in the JAX converter).
* :func:`params_from_jax` — the JAX package's detector parameter tree
  (numpy leaves), for holding the two packages against each other;
  :func:`module_params_from_jax` the same for the library modules (FPN,
  the mask / keypoint / RetinaNet heads, FBNet, MsViT, DFConv2d).

:func:`jax_path` names each port leaf's path in the JAX tree.
:func:`random_vinvl_state_dict` draws random weights in the reference
layout from a seed (the serving path without a checkpoint).
:func:`load_vinvl_checkpoint` loads every checkpoint the JAX package loads:
a ``.pth`` state dict (suffix-aligned when its keys carry another nesting,
such as a ``module.`` DDP wrapper) or a legacy Detectron/Caffe2 ``.pkl``
blob file (:func:`load_caffe2_pickle`, :func:`rename_c2_keys`).
"""
from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from cpt_tpu_torch.models.detector.config import DetectorConfig
from cpt_tpu_torch.utils.convert import align_state_dict


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _fold_bn(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    weight = sd[prefix + ".weight"]
    mean = sd[prefix + ".running_mean"]
    var = sd[prefix + ".running_var"]
    scale = weight / np.sqrt(var)  # eps = 0 (reference FrozenBatchNorm2d)
    return {"scale": scale.astype(np.float32),
            "bias": (sd[prefix + ".bias"] - mean * scale).astype(np.float32)}


ATTR_KEY = "attribute.predictor.attr_score.weight"


def _stage_names(cfg: DetectorConfig, with_attributes: bool):
    """(port prefix, reference prefix, block count) for every ResNet stage."""
    n = len(cfg.backbone.stage_blocks)
    for i, blocks in enumerate(cfg.backbone.stage_blocks):
        yield f"backbone.layer{i + 1}", f"backbone.body.layer{i + 1}", blocks
    head = f"layer{n + 1}"
    heads = [("box_extractor", "roi_heads.box.feature_extractor")]
    if with_attributes:
        heads.append(("attr_extractor", "attribute.feature_extractor"))
    for port, ref in heads:
        yield (f"{port}.head.{head}", f"{ref}.head.{head}",
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
    for port, ref, blocks in _stage_names(cfg, ATTR_KEY in sd):
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
    if ATTR_KEY in sd:
        out["attr_predictor.cls_embedding.weight"] = \
            sd["attribute.predictor.cls_embedding.weight"]
        for name in ("fc_attr", "attr_score"):
            for part in ("weight", "bias"):
                out[f"attr_predictor.{name}.{part}"] = \
                    sd[f"attribute.predictor.{name}.{part}"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def _conv(kernel) -> np.ndarray:
    """A dense conv kernel, HWIO → OIHW."""
    return np.transpose(_np(kernel), (3, 2, 0, 1))


def _stage_params(port: str, node: Mapping[str, Any],
                  out: Dict[str, np.ndarray]) -> None:
    """One ResNet stage's JAX blocks → the port's entries under ``port``
    (the grouped 3×3 stays HWIO, kernel K1's layout)."""
    for bname, blk in node.items():
        p = f"{port}.{bname}"
        for conv_name in ("conv1", "conv3", "downsample_conv"):
            if conv_name in blk:
                out[f"{p}.{conv_name}.weight"] = _conv(blk[conv_name]["kernel"])
        out[f"{p}.conv2.weight"] = _np(blk["conv2"]["kernel"])
        for bn_name in ("bn1", "bn2", "bn3", "downsample_bn"):
            if bn_name in blk:
                for k in ("scale", "bias"):
                    out[f"{p}.{bn_name}.{k}"] = _np(blk[bn_name][k])


# flax's recurrent cells: their gate Denses in torch's stacking order
_CELL_GATES = {"ii": "ifgo", "ir": "rzn"}


def _cell_params(port: str, node: Mapping[str, Any],
                 out: Dict[str, np.ndarray]) -> None:
    """A flax ``nn.LSTMCell`` / ``nn.GRUCell`` → a ``torch.nn.LSTMCell`` /
    ``GRUCell`` under ``port``. ``weight_ih`` / ``weight_hh`` stack the
    gates' kernels (transposed) as torch orders them: LSTM [i, f, g, o], GRU
    [r, z, n]. flax's LSTM has no input biases and hidden ones; its GRU has
    input biases, no hidden ones for r and z, and one for n: so the LSTM's
    ``bias_ih`` is 0 and ``bias_hh`` its hidden biases, the GRU's ``bias_ih``
    its input biases and ``bias_hh`` [0, 0, b_hn]."""
    gates = _CELL_GATES["ii" if "ii" in node else "ir"]
    hidden = _np(node["h" + gates[0]]["kernel"]).shape[1]
    zeros = np.zeros(hidden, np.float32)

    def bias(name):
        return _np(node[name]["bias"]) if "bias" in node[name] else zeros

    for side in ("i", "h"):
        out[f"{port}.weight_{side}h"] = np.concatenate(
            [_np(node[side + g]["kernel"]).T for g in gates])
        out[f"{port}.bias_{side}h"] = np.concatenate(
            [bias(side + g) for g in gates])


def _relation_params(port: str, node: Mapping[str, Any], cfg: DetectorConfig,
                     out: Dict[str, np.ndarray]) -> None:
    """A SceneParser subtree outside the detector (the relation head, the
    shared ``pred_feature_extractor``): stage-5 heads as the detector's,
    recurrent cells by :func:`_cell_params`, every other leaf (Dense
    ``kernel`` [in, out] / ``bias``, LayerNorm, embedding tables) as it is."""
    head = f"layer{len(cfg.backbone.stage_blocks) + 1}"
    for key, child in node.items():
        name = f"{port}.{key}" if port else key
        if not isinstance(child, Mapping):
            out[name] = _np(child)
        elif key == head:
            _stage_params(name, child, out)
        elif "ii" in child or "ir" in child:
            _cell_params(name, child, out)
        else:
            _relation_params(name, child, cfg, out)


def params_from_jax(tree: Mapping[str, Any], cfg: DetectorConfig
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``AttrRCNN`` params, a whole ``SceneParser`` tree (its
    ``detector``, ``relation`` and, for the four non-RelDN heads, the
    top-level ``pred_feature_extractor``) or a relation module's own tree
    (a head, a cell), as ``{"params": ...}`` or the inner tree, numpy or
    jax leaves → port state dict."""
    t = tree.get("params", tree)
    if "backbone" not in t:
        out = ({f"detector.{k}": v for k, v in
                params_from_jax(t["detector"], cfg).items()}
               if "detector" in t else {})
        rest: Dict[str, np.ndarray] = {}
        _relation_params("", {k: v for k, v in t.items() if k != "detector"},
                         cfg, rest)
        out.update({k: torch.from_numpy(np.array(v, np.float32))
                    for k, v in rest.items()})
        return out
    out: Dict[str, np.ndarray] = {}
    bb = t["backbone"]
    out["backbone.stem.conv1.weight"] = _conv(bb["stem"]["conv1"]["kernel"])
    out["backbone.stem.bn1.scale"] = _np(bb["stem"]["bn1"]["scale"])
    out["backbone.stem.bn1.bias"] = _np(bb["stem"]["bn1"]["bias"])
    n = len(cfg.backbone.stage_blocks)
    stages = [(f"backbone.layer{i + 1}", bb[f"layer{i + 1}"]) for i in range(n)]
    head = f"layer{n + 1}"
    for name in ("box_extractor", "attr_extractor"):
        if name in t:
            stages.append((f"{name}.head.{head}", t[name]["head"][head]))
    for port, node in stages:
        _stage_params(port, node, out)
    rpn = t["rpn"]
    for name in ("conv", "cls_logits", "bbox_pred"):
        out[f"rpn.{name}_weight"] = _conv(rpn[name]["kernel"])
        out[f"rpn.{name}_bias"] = _np(rpn[name]["bias"])
    pred = t["box_predictor"]
    for name in ("cls_score", "bbox_pred"):
        out[f"box_predictor.{name}.weight"] = _np(pred[name]["kernel"]).T
        out[f"box_predictor.{name}.bias"] = _np(pred[name]["bias"])
    if "attr_predictor" in t:
        attr = t["attr_predictor"]
        out["attr_predictor.cls_embedding.weight"] = _np(
            attr["cls_embedding"]["embedding"])
        for name in ("fc_attr", "attr_score"):
            out[f"attr_predictor.{name}.weight"] = _np(attr[name]["kernel"]).T
            out[f"attr_predictor.{name}.bias"] = _np(attr[name]["bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def module_params_from_jax(tree: Mapping[str, Any], model: torch.nn.Module
                           ) -> Dict[str, torch.Tensor]:
    """The flax tree of one of the library modules (``fpn``, ``extra_heads``,
    ``fbnet``, ``msvit``, ``ops/deform_conv``) → ``model``'s state dict,
    read by the model's own names (they are the flax tree's paths): a
    ``Conv`` / ``Conv2d`` kernel HWIO → the OIHW ``weight``; a
    ``ConvTranspose`` kernel ``(kh, kw, in, out)`` flipped in space →
    ``[in, out, kh, kw]`` (flax does not flip it, torch's transposed conv
    does); the grouped 3×3 kept HWIO (kernel K1's layout); every other leaf
    as it is (Dense ``kernel`` [in, out] and ``bias``, LayerNorm and
    FrozenBN ``scale`` / ``bias``, the ``*_scale`` / ``*_bias`` pairs, the
    ``ape`` / ``glo`` / relative-bias tables, ``DFConv2d.kernel``)."""
    from cpt_tpu_torch.models.detector.extra_heads import ConvTranspose
    from cpt_tpu_torch.models.detector.resnet import Conv, Conv2d

    t = tree.get("params", tree)
    out = {}
    for name in model.state_dict():
        *path, leaf = name.split(".")
        node = t
        for key in path:
            node = node[key]
        mod = model.get_submodule(".".join(path))
        if leaf == "weight" and isinstance(mod, ConvTranspose):
            v = np.transpose(_np(node["kernel"])[::-1, ::-1], (2, 3, 0, 1))
        elif leaf == "weight" and isinstance(mod, (Conv, Conv2d)):
            v = _conv(node["kernel"])
        elif leaf == "weight":
            v = _np(node["kernel"])
        else:
            v = _np(node[leaf])
        out[name] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return out


# a torch cell's tensors → (the flax gate Denses they stack, their leaf)
_CELL_LEAVES = {"weight_ih": ("i*", "kernel"), "weight_hh": ("h*", "kernel"),
                "bias_ih": ("i*", "bias"), "bias_hh": ("h*", "bias")}


def jax_path(name: str) -> Tuple[str, ...]:
    """The path in the JAX ``AttrRCNN`` tree of the leaf that the port's
    state-dict entry ``name`` holds (the map :func:`params_from_jax` reads
    by; the solver's bias groups and the trainer's freeze mask are decided
    on it): ``backbone.layer1.block_0.conv1.weight`` →
    ``("backbone", "layer1", "block_0", "conv1", "kernel")``,
    ``rpn.conv_weight`` → ``("rpn", "conv", "kernel")``, a linear's
    ``weight`` → its ``kernel``, the class embedding's → ``embedding``. A
    ``SceneParser``'s names map the same way under ``detector.``; a
    recurrent cell's ``weight_ih`` → ``(..., "i*", "kernel")`` (it stacks
    the input gates' kernels), ``bias_hh`` → ``(..., "h*", "bias")``."""
    parts = name.split(".")
    if parts[0] == "detector":
        return ("detector",) + jax_path(name[len("detector."):])
    if parts[-1] in _CELL_LEAVES:
        side, leaf = _CELL_LEAVES[parts[-1]]
        return tuple(parts[:-1]) + (side, leaf)
    if parts[0] == "rpn":
        layer, leaf = parts[1].rsplit("_", 1)
        return ("rpn", layer, "kernel" if leaf == "weight" else leaf)
    if parts[-1] == "weight":
        parts[-1] = "embedding" if parts[-2] == "cls_embedding" else "kernel"
    return tuple(parts)


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load`` a checkpoint on the CPU; unwraps the
    DetectronCheckpointer ``{"model": state_dict}`` layout."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and isinstance(blob.get("model"), dict):
        blob = blob["model"]
    return blob


def load_vinvl_checkpoint(path: str, cfg: DetectorConfig
                          ) -> Dict[str, torch.Tensor]:
    """A VinVL checkpoint → port state dict, as
    ``cpt_tpu/models/detector/convert.py::load_vinvl_checkpoint`` loads
    it: a ``.pkl`` Detectron/Caffe2 blob file through
    :func:`load_caffe2_pickle`; a ``.pth`` state dict as it is or, where its
    keys carry another nesting (a ``module.`` DDP wrapper), suffix-aligned
    onto the VinVL layout first (reference ``model_serialization.py:35``)."""
    if path.endswith(".pkl"):
        return load_caffe2_pickle(path, cfg)
    sd = load_torch_file(path)
    try:
        return state_from_reference(sd, cfg)
    except KeyError:
        return state_from_reference(
            align_state_dict(sd, random_vinvl_state_dict(cfg)), cfg)


def rename_c2_keys(keys) -> Dict[str, str]:
    """Caffe2/Detectron blob names → maskrcnn-benchmark torch names (a copy
    of ``cpt_tpu/models/detector/convert.py::rename_c2_keys``, the
    reference's ``c2_model_loading.py:13-62`` chain): underscores to dots
    with the weight/bias/bn fixups, res{N} stages to torchvision
    layer{N-1}, branch2{a,b,c} to conv1/2/3, branch1 to the downsample
    pair, and the RPN head names. Returns {c2_key: torch_key}."""
    chain = [
        ("_", "."), (".w", ".weight"), (".bn", "_bn"), (".b", ".bias"),
        ("_bn.s", "_bn.scale"), (".biasranch", ".branch"),
        ("bbox.pred", "bbox_pred"), ("cls.score", "cls_score"),
        ("res.conv1_", "conv1_"), (".biasbox", ".bbox"),
        ("conv.rpn", "rpn.conv"), ("rpn.bbox.pred", "rpn.bbox_pred"),
        ("rpn.cls.logits", "rpn.cls_logits"),
        ("_bn.scale", "_bn.weight"), ("conv1_bn.", "bn1."),
        ("res2.", "layer1."), ("res3.", "layer2."), ("res4.", "layer3."),
        ("res5.", "layer4."),
        (".branch2a.", ".conv1."), (".branch2a_bn.", ".bn1."),
        (".branch2b.", ".conv2."), (".branch2b_bn.", ".bn2."),
        (".branch2c.", ".conv3."), (".branch2c_bn.", ".bn3."),
        (".branch1.", ".downsample.0."), (".branch1_bn.", ".downsample.1."),
        ("rpn.", "rpn.head."),
    ]
    out = {}
    for orig in keys:
        k = "fc1000_w" if orig == "pred_w" else (
            "fc1000_b" if orig == "pred_b" else orig)
        for a, b in chain:
            k = k.replace(a, b)
        out[orig] = k
    return out


def load_caffe2_pickle(path: str, cfg: DetectorConfig
                       ) -> Dict[str, torch.Tensor]:
    """Legacy Detectron/Caffe2 ``.pkl`` checkpoint → port state dict (as
    ``cpt_tpu/models/detector/convert.py::load_caffe2_pickle``; reference
    ``c2_model_loading.py::load_c2_format``). Caffe2's AffineChannel has no
    running stats, so each ``*_bn`` gets identity stats (mean 0, var 1)
    before the frozen-BN fold; heads the blob file lacks keep the weights
    of ``random_vinvl_state_dict(cfg)`` (reference
    ``skip_unmatched_layers``)."""
    with open(path, "rb") as f:
        blobs = pickle.load(f, encoding="latin1")
    if "blobs" in blobs:
        blobs = blobs["blobs"]
    blobs = {k: v for k, v in blobs.items()
             if "momentum" not in k and isinstance(v, np.ndarray)}
    renamed = {tk: np.asarray(blobs[c2k])
               for c2k, tk in rename_c2_keys(blobs.keys()).items()}
    # identity running stats for every affine-only BN (bn1/2/3, the stem
    # bn1, downsample.1)
    bn_pat = re.compile(r"(\.bn\d|\.downsample\.1|^bn1)\.weight$")
    for k in list(renamed):
        if bn_pat.search(k):
            base = k[: -len(".weight")]
            renamed.setdefault(base + ".running_mean", np.zeros_like(renamed[k]))
            renamed.setdefault(base + ".running_var", np.ones_like(renamed[k]))
    base_sd = random_vinvl_state_dict(cfg)
    base_sd.update(align_state_dict(renamed, base_sd))
    return state_from_reference(base_sd, cfg)


def random_vinvl_state_dict(cfg: DetectorConfig, seed: int = 0
                            ) -> Dict[str, np.ndarray]:
    """Random state dict in the exact VinVL ``.pth`` key layout (maskrcnn
    naming, raw FrozenBN running stats), drawn from ``seed`` with numpy:
    the same arrays as the JAX package's ``random_vinvl_state_dict``."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def r(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    def bn(prefix, n):
        sd[f"{prefix}.weight"] = (rng.rand(n) * 0.5 + 0.75).astype(np.float32)
        sd[f"{prefix}.bias"] = r(n)
        sd[f"{prefix}.running_mean"] = r(n)
        sd[f"{prefix}.running_var"] = (rng.rand(n) + 0.5).astype(np.float32)

    def bottleneck(prefix, cin, cb, cout, groups):
        sd[f"{prefix}.conv1.weight"] = r(cb, cin, 1, 1)
        bn(f"{prefix}.bn1", cb)
        sd[f"{prefix}.conv2.weight"] = r(cb, cb // groups, 3, 3)
        bn(f"{prefix}.bn2", cb)
        sd[f"{prefix}.conv3.weight"] = r(cout, cb, 1, 1)
        bn(f"{prefix}.bn3", cout)
        if cin != cout:
            sd[f"{prefix}.downsample.0.weight"] = r(cout, cin, 1, 1)
            bn(f"{prefix}.downsample.1", cout)

    def stage(prefix, cin, cb, cout, blocks, groups):
        for j in range(blocks):
            bottleneck(f"{prefix}.{j}", cin if j == 0 else cout, cb, cout,
                       groups)

    bb = cfg.backbone
    sd["backbone.body.stem.conv1.weight"] = r(bb.stem_out_channels, 3, 7, 7)
    bn("backbone.body.stem.bn1", bb.stem_out_channels)
    cin = bb.stem_out_channels
    for i, blocks in enumerate(bb.stage_blocks):
        f = 2 ** i
        stage(f"backbone.body.layer{i + 1}", cin,
              bb.stage2_bottleneck_channels * f, bb.res2_out_channels * f,
              blocks, bb.num_groups)
        cin = bb.res2_out_channels * f

    fs = 2 ** len(bb.stage_blocks)
    layer = f"layer{len(bb.stage_blocks) + 1}"
    for prefix in ("roi_heads.box.feature_extractor",
                   "attribute.feature_extractor"):
        stage(f"{prefix}.head.{layer}", cin,
              bb.stage2_bottleneck_channels * fs, bb.res2_out_channels * fs,
              bb.head_blocks, bb.num_groups)
    c5 = bb.res2_out_channels * fs

    a = cfg.rpn.num_anchors
    sd["rpn.head.conv.weight"] = r(cin, cin, 3, 3)
    sd["rpn.head.conv.bias"] = r(cin)
    sd["rpn.head.cls_logits.weight"] = r(a, cin, 1, 1)
    sd["rpn.head.cls_logits.bias"] = r(a)
    sd["rpn.head.bbox_pred.weight"] = r(a * 4, cin, 1, 1)
    sd["rpn.head.bbox_pred.bias"] = r(a * 4)

    nc = cfg.roi_heads.num_classes
    sd["roi_heads.box.predictor.cls_score.weight"] = r(nc, c5)
    sd["roi_heads.box.predictor.cls_score.bias"] = r(nc)
    sd["roi_heads.box.predictor.bbox_pred.weight"] = r(nc * 4, c5)
    sd["roi_heads.box.predictor.bbox_pred.bias"] = r(nc * 4)

    at = cfg.attributes
    sd["attribute.predictor.cls_embedding.weight"] = r(nc, at.cls_emd_dim)
    sd["attribute.predictor.fc_attr.weight"] = r(at.attr_emd_dim,
                                                 c5 + at.cls_emd_dim)
    sd["attribute.predictor.fc_attr.bias"] = r(at.attr_emd_dim)
    sd["attribute.predictor.attr_score.weight"] = r(at.num_attributes,
                                                    at.attr_emd_dim)
    sd["attribute.predictor.attr_score.bias"] = r(at.num_attributes)
    return sd
