"""Oscar BERT weights → the port's ``REC_MLM_CPT`` state dict (port of
``cpt_tpu/utils/convert.py``).

* :func:`state_from_reference` — the Oscar ``pytorch_model.bin`` layout
  (``bert.*`` + ``cls.predictions.*``), loaded natively: the three
  ``(out, in)`` Q/K/V linears pack into one ``wqkv [H, 3H]`` (columns
  ``[q|k|v]``), linears become ``[in, out]`` kernels, the tied
  ``cls.predictions.decoder.weight`` is dropped (the head reads the
  embedding table), as ``convert_bert_state_dict`` +
  ``params_for_task(..., "rec_mlm_cpt")`` do.
* :func:`params_from_jax` — the JAX ``REC_MLM_CPT`` parameter tree.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from cpt_tpu.config.bert import BertConfig


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tensors(d: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in d.items()}


def state_from_reference(sd: Mapping[str, Any], config: BertConfig
                         ) -> Dict[str, torch.Tensor]:
    """``BertImgForPreTraining`` state dict → port ``REC_MLM_CPT`` state dict."""
    sd = {k: _np(v) for k, v in sd.items()}
    if "bert.embeddings.word_embeddings.weight" not in sd:
        raise KeyError("expected the Oscar pytorch_model.bin layout "
                       "(bert.* and cls.predictions.* keys)")
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
        "mlm_head.transform.dense.kernel":
            sd["cls.predictions.transform.dense.weight"].T,
        "mlm_head.transform.dense.bias": sd["cls.predictions.transform.dense.bias"],
        "mlm_head.transform.LayerNorm.scale":
            sd["cls.predictions.transform.LayerNorm.weight"],
        "mlm_head.transform.LayerNorm.bias":
            sd["cls.predictions.transform.LayerNorm.bias"],
        "mlm_head.bias": sd["cls.predictions.bias"],
    }
    if c.use_img_layernorm:
        out["bert.img_LayerNorm.scale"] = sd["bert.LayerNorm.weight"]
        out["bert.img_LayerNorm.bias"] = sd["bert.LayerNorm.bias"]
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


def params_from_jax(tree: Mapping[str, Any], config: BertConfig
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``REC_MLM_CPT`` params (``{"params": ...}`` or the inner tree) →
    port state dict."""
    t = tree.get("params", tree)
    c = config
    h = c.hidden_size
    b, m = t["bert"], t["mlm_head"]
    emb = b["embeddings"]
    out: Dict[str, np.ndarray] = {
        "bert.embeddings.word_embeddings": _np(emb["word_embeddings"]["embedding"]),
        "bert.embeddings.position_embeddings":
            _np(emb["position_embeddings"]["embedding"]),
        "bert.embeddings.token_type_embeddings":
            _np(emb["token_type_embeddings"]["embedding"]),
        "bert.embeddings.LayerNorm.scale": _np(emb["LayerNorm"]["scale"]),
        "bert.embeddings.LayerNorm.bias": _np(emb["LayerNorm"]["bias"]),
        "bert.img_embedding.kernel": _np(b["img_embedding"]["kernel"]),
        "bert.img_embedding.bias": _np(b["img_embedding"]["bias"]),
        "bert.pooler.dense.kernel": _np(b["pooler"]["dense"]["kernel"]),
        "bert.pooler.dense.bias": _np(b["pooler"]["dense"]["bias"]),
        "mlm_head.transform.dense.kernel": _np(m["transform"]["dense"]["kernel"]),
        "mlm_head.transform.dense.bias": _np(m["transform"]["dense"]["bias"]),
        "mlm_head.transform.LayerNorm.scale": _np(m["transform"]["LayerNorm"]["scale"]),
        "mlm_head.transform.LayerNorm.bias": _np(m["transform"]["LayerNorm"]["bias"]),
        "mlm_head.bias": _np(m["bias"]),
    }
    if c.use_img_layernorm:
        out["bert.img_LayerNorm.scale"] = _np(b["img_LayerNorm"]["scale"])
        out["bert.img_LayerNorm.bias"] = _np(b["img_LayerNorm"]["bias"])
    for i in range(c.num_hidden_layers):
        layer = b["encoder"][f"layer_{i}"]
        att = layer["attention"]
        p = f"bert.encoder.layer.{i}."
        out[p + "attention.wqkv"] = _np(att["qkv"]["kernel"]).reshape(h, 3 * h)
        out[p + "attention.bqkv"] = _np(att["qkv"]["bias"]).reshape(3 * h)
        out[p + "attention.wo"] = _np(att["out"]["kernel"]).reshape(h, h)
        out[p + "attention.bo"] = _np(att["out"]["bias"])
        for name in ("attention_out_LayerNorm", "output_LayerNorm"):
            out[p + f"{name}.scale"] = _np(layer[name]["scale"])
            out[p + f"{name}.bias"] = _np(layer[name]["bias"])
        for name in ("intermediate", "output"):
            out[p + f"{name}.kernel"] = _np(layer[name]["kernel"])
            out[p + f"{name}.bias"] = _np(layer[name]["bias"])
    return _tensors(out)
