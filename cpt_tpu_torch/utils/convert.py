"""Oscar BERT weights → the state dict of one of the port's task models
(port of ``cpt_tpu/utils/convert.py``). ``task`` names the model's
parameter layout (its ``TASK``), as ``params_for_task`` does for the CPT
models: ``"rec_mlm_cpt"`` (``REC_MLM_CPT``, the MLM head), ``"nsp_cpt"``
(``NSPCPT``, the NSP head) or ``"vcr_qar_nsp_cpt"`` (``VCRQAR_NSPCPT``, twin
copies of the NSP head); ``"caption"`` (``BertForImageCaptioning``, the MLM
head, with its own decoder table when ``config.tie_weights`` is False);
the full-finetune baselines ``"rec_ft"``,
``"nsp_ft"``, ``"vcr_qar_nsp_ft"``, ``"vg_ft"``, ``"seq_classification"``
and ``"multiple_choice"`` take only the encoder from a checkpoint
(``"bert_only"``, :func:`load_bert_only`) and keep their fresh heads.

* :func:`state_from_reference` — the Oscar ``pytorch_model.bin`` layout
  (``bert.*`` + ``cls.predictions.*`` + ``cls.seq_relationship.*``),
  loaded natively: the three ``(out, in)`` Q/K/V linears pack into one
  ``wqkv [H, 3H]`` (columns ``[q|k|v]``), linears become ``[in, out]``
  kernels, the tied ``cls.predictions.decoder.weight`` is dropped (the
  head reads the embedding table; a warning says so where it differs from
  that table) and an untied caption decoder is kept, as
  ``convert_bert_state_dict`` + ``params_for_task`` do.
* :func:`params_from_jax` — the JAX task model's parameter tree, by
  :func:`jax_paths` (each port parameter's path in that tree).

:func:`random_oscar_state_dict` draws random weights in the reference
layout from a seed (the serving path without a checkpoint).
:func:`align_state_dict` suffix-aligns a checkpoint whose keys carry
another nesting (a ``module.`` DDP wrapper, a bare ``BertModel``) onto the
reference layout; :func:`state_from_reference` falls back to it, as the
JAX converter does.
"""
from __future__ import annotations

import functools
import operator
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from cpt_tpu_torch.config.bert import BertConfig


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tensors(d: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in d.items()}


CPT_TASKS = ("rec_mlm_cpt", "nsp_cpt", "vcr_qar_nsp_cpt", "caption")
# the models with the MLM head
MLM_TASKS = ("rec_mlm_cpt", "caption")
FT_TASKS = ("rec_ft", "nsp_ft", "vcr_qar_nsp_ft", "vg_ft",
            "seq_classification", "multiple_choice")
TASKS = CPT_TASKS + FT_TASKS + ("bert_only",)
# the task models' NSP heads: the one head of NSPCPT, the twin heads of
# VCRQAR_NSPCPT (both copies of the pretrained ``cls.seq_relationship``)
NSP_HEADS = {"rec_mlm_cpt": (), "nsp_cpt": ("nsp_head",),
             "vcr_qar_nsp_cpt": ("cls_ans", "cls_rat")}
_DENSE, _LN = ("kernel", "bias"), ("scale", "bias")


def ft_head_params(config: BertConfig, task: str) -> Dict[str, Tuple[str, ...]]:
    """The fresh head of a full-finetune ``task``: {module: its parameter
    leaves}, the module named as in the JAX tree (``.`` between levels)."""
    c = config
    mlp = c.classifier == "mlp"
    heads = {
        "rec_ft": {"cls_dense": _DENSE, "cls_LayerNorm": _LN, "cls_out": _DENSE},
        "nsp_ft": {"classifier.dense": _DENSE},
        "vcr_qar_nsp_ft": {"classifier_ans.dense": _DENSE,
                           "classifier_rat.dense": _DENSE},
        "vg_ft": {"classifier": _DENSE},
        "seq_classification": {**({"cls_hidden": _DENSE} if mlp else {}),
                               "cls_out": _DENSE},
        "multiple_choice": {**({"cls_hidden": _DENSE} if mlp else {}),
                            **({"cls_LayerNorm": _LN}
                               if mlp and c.use_img_layernorm else {}),
                            "cls_out": _DENSE},
    }
    return heads.get(task, {})


def _check_task(task: str) -> None:
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; one of {TASKS}")


def untied_decoder(config: BertConfig, task: str) -> bool:
    """Whether the ``task`` model's MLM head owns its decoder table: the
    caption model's, under ``config.tie_weights`` False."""
    return task == "caption" and not config.tie_weights


def warn_dropped_decoder(sd: Mapping[str, np.ndarray], config: BertConfig) -> None:
    """The JAX converter's warning (``cpt_tpu/utils/convert.py:134-162``):
    a tied ``config`` drops a ``cls.predictions.decoder.weight`` that
    differs from the embedding table."""
    if ("cls.predictions.transform.dense.weight" not in sd
            or "cls.predictions.decoder.weight" not in sd or not config.tie_weights):
        return
    emb = sd.get("bert.embeddings.word_embeddings.weight")
    dec = sd["cls.predictions.decoder.weight"]
    if emb is not None and (emb.shape != dec.shape or not np.allclose(emb, dec)):
        print("WARNING: checkpoint has an untied "
              "cls.predictions.decoder.weight that differs "
              "from the embedding table, but tie_weights=True "
              "drops it — pass --no_tie_weights to keep the "
              "finetuned decoder")


def state_from_reference(sd: Mapping[str, Any], config: BertConfig,
                         task: str = "rec_mlm_cpt", warn: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """``BertImgForPreTraining`` state dict → the port's state dict of the
    ``task`` model: a CPT task or the caption model, or ``"bert_only"``
    (the encoder alone, what a full-finetune model takes from a
    checkpoint). ``warn``: print :func:`warn_dropped_decoder`'s warning
    (a checkpoint's; random weights drawn in the layout do not warn)."""
    _check_task(task)
    if task in FT_TASKS:
        raise ValueError(f"a {task} model takes the encoder alone from a "
                         "checkpoint: task 'bert_only' (load_bert_only)")
    sd = {k: _np(v) for k, v in sd.items()}
    if "bert.embeddings.word_embeddings.weight" not in sd:
        # another nesting (e.g. a "module." DDP wrapper): suffix-align onto
        # the canonical Oscar layout (cpt_tpu/utils/convert.py:116-123)
        sd = align_state_dict(sd, random_oscar_state_dict(config))
    if "bert.embeddings.word_embeddings.weight" not in sd:
        raise KeyError("expected the Oscar pytorch_model.bin layout "
                       "(bert.* and cls.predictions.* keys)")
    if warn:
        warn_dropped_decoder(sd, config)
    c = config
    out: Dict[str, np.ndarray] = {
        "bert.embeddings.word_embeddings": sd["bert.embeddings.word_embeddings.weight"],
        "bert.embeddings.position_embeddings":
            sd["bert.embeddings.position_embeddings.weight"],
        "bert.embeddings.token_type_embeddings":
            sd["bert.embeddings.token_type_embeddings.weight"],
        "bert.embeddings.LayerNorm.scale": sd["bert.embeddings.LayerNorm.weight"],
        "bert.embeddings.LayerNorm.bias": sd["bert.embeddings.LayerNorm.bias"],
        "bert.img_embedding.kernel": sd["bert.img_embedding.weight"].T,
        "bert.img_embedding.bias": sd["bert.img_embedding.bias"],
        "bert.pooler.dense.kernel": sd["bert.pooler.dense.weight"].T,
        "bert.pooler.dense.bias": sd["bert.pooler.dense.bias"],
    }
    if task in MLM_TASKS:
        out.update({
            "mlm_head.transform.dense.kernel":
                sd["cls.predictions.transform.dense.weight"].T,
            "mlm_head.transform.dense.bias":
                sd["cls.predictions.transform.dense.bias"],
            "mlm_head.transform.LayerNorm.scale":
                sd["cls.predictions.transform.LayerNorm.weight"],
            "mlm_head.transform.LayerNorm.bias":
                sd["cls.predictions.transform.LayerNorm.bias"],
            "mlm_head.bias": sd["cls.predictions.bias"],
        })
    if untied_decoder(c, task):
        out["mlm_head.decoder"] = sd["cls.predictions.decoder.weight"]
    for head in NSP_HEADS.get(task, ()):
        out[f"{head}.dense.kernel"] = sd["cls.seq_relationship.weight"].T
        out[f"{head}.dense.bias"] = sd["cls.seq_relationship.bias"]
    if c.use_img_layernorm:
        # a checkpoint without it leaves flax's init (scale 1, bias 0), as
        # JAX's merge into the initialized tree does
        h = c.hidden_size
        out["bert.img_LayerNorm.scale"] = sd.get("bert.LayerNorm.weight",
                                                 np.ones(h, np.float32))
        out["bert.img_LayerNorm.bias"] = sd.get("bert.LayerNorm.bias",
                                                np.zeros(h, np.float32))
    for i in range(c.num_hidden_layers):
        r = p = f"bert.encoder.layer.{i}."
        qkv = ("query", "key", "value")
        out[p + "attention.wqkv"] = np.concatenate(
            [sd[r + f"attention.self.{n}.weight"].T for n in qkv], axis=1)
        out[p + "attention.bqkv"] = np.concatenate(
            [sd[r + f"attention.self.{n}.bias"] for n in qkv])
        out[p + "attention.wo"] = sd[r + "attention.output.dense.weight"].T
        out[p + "attention.bo"] = sd[r + "attention.output.dense.bias"]
        out[p + "attention_out_LayerNorm.scale"] = \
            sd[r + "attention.output.LayerNorm.weight"]
        out[p + "attention_out_LayerNorm.bias"] = \
            sd[r + "attention.output.LayerNorm.bias"]
        out[p + "intermediate.kernel"] = sd[r + "intermediate.dense.weight"].T
        out[p + "intermediate.bias"] = sd[r + "intermediate.dense.bias"]
        out[p + "output.kernel"] = sd[r + "output.dense.weight"].T
        out[p + "output.bias"] = sd[r + "output.dense.bias"]
        out[p + "output_LayerNorm.scale"] = sd[r + "output.LayerNorm.weight"]
        out[p + "output_LayerNorm.bias"] = sd[r + "output.LayerNorm.bias"]
    return _tensors(out)


def jax_paths(config: BertConfig, task: str = "rec_mlm_cpt"
              ) -> Dict[str, Tuple[str, ...]]:
    """Port state-dict name → the path of the same parameter in the JAX
    ``task`` model's tree (what optax masks and ``freeze_params`` see)."""
    _check_task(task)
    c = config
    paths = {
        "bert.embeddings.word_embeddings": ("bert", "embeddings", "word_embeddings", "embedding"),
        "bert.embeddings.position_embeddings":
            ("bert", "embeddings", "position_embeddings", "embedding"),
        "bert.embeddings.token_type_embeddings":
            ("bert", "embeddings", "token_type_embeddings", "embedding"),
        "bert.embeddings.LayerNorm.scale": ("bert", "embeddings", "LayerNorm", "scale"),
        "bert.embeddings.LayerNorm.bias": ("bert", "embeddings", "LayerNorm", "bias"),
        "bert.img_embedding.kernel": ("bert", "img_embedding", "kernel"),
        "bert.img_embedding.bias": ("bert", "img_embedding", "bias"),
        "bert.pooler.dense.kernel": ("bert", "pooler", "dense", "kernel"),
        "bert.pooler.dense.bias": ("bert", "pooler", "dense", "bias"),
    }
    if task in MLM_TASKS:
        for name in ("transform.dense.kernel", "transform.dense.bias",
                     "transform.LayerNorm.scale", "transform.LayerNorm.bias",
                     "bias"):
            paths[f"mlm_head.{name}"] = ("mlm_head",) + tuple(name.split("."))
    if untied_decoder(c, task):
        paths["mlm_head.decoder"] = ("mlm_head", "decoder")
    for head in NSP_HEADS.get(task, ()):
        for leaf in ("kernel", "bias"):
            paths[f"{head}.dense.{leaf}"] = (head, "dense", leaf)
    for module, leaves in ft_head_params(c, task).items():
        for leaf in leaves:
            paths[f"{module}.{leaf}"] = tuple(module.split(".")) + (leaf,)
    if c.use_img_layernorm:
        paths["bert.img_LayerNorm.scale"] = ("bert", "img_LayerNorm", "scale")
        paths["bert.img_LayerNorm.bias"] = ("bert", "img_LayerNorm", "bias")
    for i in range(c.num_hidden_layers):
        p, j = f"bert.encoder.layer.{i}.", ("bert", "encoder", f"layer_{i}")
        paths[p + "attention.wqkv"] = j + ("attention", "qkv", "kernel")
        paths[p + "attention.bqkv"] = j + ("attention", "qkv", "bias")
        paths[p + "attention.wo"] = j + ("attention", "out", "kernel")
        paths[p + "attention.bo"] = j + ("attention", "out", "bias")
        for name in ("attention_out_LayerNorm", "output_LayerNorm"):
            paths[p + f"{name}.scale"] = j + (name, "scale")
            paths[p + f"{name}.bias"] = j + (name, "bias")
        for name in ("intermediate", "output"):
            paths[p + f"{name}.kernel"] = j + (name, "kernel")
            paths[p + f"{name}.bias"] = j + (name, "bias")
    return paths


def params_from_jax(tree: Mapping[str, Any], config: BertConfig,
                    task: str = "rec_mlm_cpt") -> Dict[str, torch.Tensor]:
    """The JAX ``task`` model's params (``{"params": ...}`` or the inner
    tree), or any tree of that structure (gradients, optimizer moments) →
    port state dict. The attention's ``[H, 3, heads, D]`` / ``[heads, D, H]``
    kernels and ``[3, heads, D]`` bias flatten to the port's 2-D / 1-D."""
    t = tree.get("params", tree)
    h = config.hidden_size
    flat = {"attention.wqkv": (h, 3 * h), "attention.bqkv": (3 * h,),
            "attention.wo": (h, h)}
    out: Dict[str, np.ndarray] = {}
    for name, path in jax_paths(config, task).items():
        a = _np(functools.reduce(operator.getitem, path, t))
        shape = flat.get(name.split(".", 4)[-1])
        out[name] = a.reshape(shape) if shape else a
    return _tensors(out)


def load_bert_only(model: torch.nn.Module, sd: Mapping[str, Any],
                   warn: bool = True) -> None:
    """Load the encoder of a reference-layout state dict ``sd`` into a
    full-finetune ``model`` and leave its fresh head as it is (JAX's
    ``params_for_task(..., "bert_only")`` merged into the init). Raises
    unless the parameters left unloaded are exactly the head's."""
    cfg = model.config
    head = set(jax_paths(cfg, model.TASK)) - set(jax_paths(cfg, "bert_only"))
    missing, unexpected = model.load_state_dict(
        state_from_reference(sd, cfg, "bert_only", warn), strict=False)
    if set(missing) != head or unexpected:
        raise KeyError(f"bert_only load into {model.TASK}: missing "
                       f"{sorted(missing)}, unexpected {sorted(unexpected)}; "
                       f"the fresh head is {sorted(head)}")


def random_oscar_state_dict(config: BertConfig, seed: int = 0
                            ) -> Dict[str, np.ndarray]:
    """Random state dict in the Oscar ``pytorch_model.bin`` key layout
    (``bert.*`` BertImgModel + ``cls.*`` pretraining heads), drawn from
    ``seed`` with numpy: the same arrays as the JAX package's
    ``random_oscar_state_dict``."""
    rng = np.random.RandomState(seed)
    c = config
    h, im, vs = c.hidden_size, c.intermediate_size, c.vocab_size

    def r(*shape):
        return (rng.randn(*shape) * 0.02).astype(np.float32)

    sd: Dict[str, np.ndarray] = {
        "bert.embeddings.word_embeddings.weight": r(vs, h),
        "bert.embeddings.position_embeddings.weight":
            r(c.max_position_embeddings, h),
        "bert.embeddings.token_type_embeddings.weight":
            r(c.type_vocab_size, h),
        "bert.embeddings.LayerNorm.weight": np.ones(h, np.float32),
        "bert.embeddings.LayerNorm.bias": r(h),
        "bert.pooler.dense.weight": r(h, h),
        "bert.pooler.dense.bias": r(h),
        "bert.img_embedding.weight": r(h, c.img_feature_dim),
        "bert.img_embedding.bias": r(h),
        "cls.predictions.transform.dense.weight": r(h, h),
        "cls.predictions.transform.dense.bias": r(h),
        "cls.predictions.transform.LayerNorm.weight": np.ones(h, np.float32),
        "cls.predictions.transform.LayerNorm.bias": r(h),
        "cls.predictions.bias": r(vs),
        "cls.predictions.decoder.weight": r(vs, h),
        "cls.seq_relationship.weight": r(2, h),
        "cls.seq_relationship.bias": r(2),
    }
    for i in range(c.num_hidden_layers):
        pre = f"bert.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            sd[pre + f"attention.self.{n}.weight"] = r(h, h)
            sd[pre + f"attention.self.{n}.bias"] = r(h)
        sd[pre + "attention.output.dense.weight"] = r(h, h)
        sd[pre + "attention.output.dense.bias"] = r(h)
        sd[pre + "attention.output.LayerNorm.weight"] = np.ones(h, np.float32)
        sd[pre + "attention.output.LayerNorm.bias"] = r(h)
        sd[pre + "intermediate.dense.weight"] = r(im, h)
        sd[pre + "intermediate.dense.bias"] = r(im)
        sd[pre + "output.dense.weight"] = r(h, im)
        sd[pre + "output.dense.bias"] = r(h)
        sd[pre + "output.LayerNorm.weight"] = np.ones(h, np.float32)
        sd[pre + "output.LayerNorm.bias"] = r(h)
    return sd


def align_state_dict(loaded: Mapping[str, Any], expected: Mapping[str, Any]
                     ) -> Dict[str, np.ndarray]:
    """Suffix-match checkpoint keys onto the converter's expected names
    (reference ``model_serialization.py:35-100``
    align_and_update_state_dicts; a copy of
    ``cpt_tpu/utils/convert.py::align_state_dict``).

    For each expected key, pick the loaded key related by suffix, in either
    direction (model keys with extra nesting, or checkpoint keys with a
    ``module.``/``model.`` prefix), preferring an exact match, then the
    longest common suffix. Shape-mismatched picks are skipped, so heads the
    checkpoint does not have keep their initialization."""
    out: Dict[str, np.ndarray] = {}
    loaded_keys = list(loaded.keys())
    for ek, ev in expected.items():
        best, best_len = None, -1
        for lk in loaded_keys:
            if lk == ek:
                best, best_len = lk, 1 << 30
                break
            if lk.endswith("." + ek) or ek.endswith("." + lk):
                score = min(len(lk), len(ek))
                if score > best_len:
                    best, best_len = lk, score
        if best is None:
            continue
        v = _np(loaded[best])
        eshape = getattr(ev, "shape", None)
        if eshape is not None and tuple(v.shape) != tuple(eshape):
            continue
        out[ek] = v
    return out
