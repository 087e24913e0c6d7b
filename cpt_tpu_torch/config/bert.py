"""Oscar cross-modal BERT configuration (the port's copy of
``cpt_tpu/config/bert.py``: the same fields, defaults and presets, so a
config built here and one built there compare equal field by field).

Mirrors the capability surface of the reference's vendored
``pytorch_transformers.BertConfig`` plus the Oscar image-input extensions used
by ``BertImgModel`` (reference ``Oscar/oscar/modeling/modeling_bert.py:150-198``):
``img_feature_dim`` (2054 = 2048 pooled RoI + 6 box geometry),
``img_feature_type`` and optional image-embedding LayerNorm.

``img_feature_type`` also names the reference's discrete-code
("dis_code*") variants: VQ-VAE code ids through an embedding table
(``code_voc`` × ``code_dim``) before the image projection; the plain
linear-projection path ("faster_r-cnn") is the one every CPT task uses.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    # captioning decoder/embedding tying (reference modeling_bert.py:
    # 616-625: BertForImageCaptioning ties only when config.tie_weights;
    # pretraining/CPT heads tie unconditionally, :980-1000)
    tie_weights: bool = True
    layer_norm_eps: float = 1e-12

    # Oscar image-input extensions
    img_feature_dim: int = 2054
    img_feature_type: str = "faster_r-cnn"
    use_img_layernorm: bool = False
    img_layer_norm_eps: float = 1e-12
    code_voc: int = 512       # dis_code variants only
    code_dim: int = 512
    code_size: int = 0

    # attention backend: "auto"/"fused" send each layer's attention
    # sub-block to kernel K3 (ops/fused_attention.py) when eligible
    # (key-only 2-D mask, no KV history/head mask, no active dropout),
    # else the exact einsum path; "einsum" forces the einsum path;
    # "flash" sends the attention core to kernel K6 (ops/attention.py
    # flash_mha; long-context variants) with the projections outside it.
    attention_impl: str = "auto"

    # FFN backend: "auto"/"fused" send the FFN sub-block to kernel K4
    # (ops/fused_ffn.py) when no dropout applies and the activation is a
    # gelu, else the dense path; "dense" forces the dense path.
    ffn_impl: str = "auto"

    # task head knobs
    num_labels: int = 2
    num_contrast_classes: int = 2
    loss_type: str = "xe"        # xe | kl | bce (ImageBertForSequenceClassification)
    classifier: str = "linear"   # linear | mlp
    cls_hidden_scale: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


# The checkpoint-2000000 Oscar-base pretrained configuration used by every CPT
# task script (reference `Oscar/oscar/fewshot/refcoco_cpt.py:492-499`).
OSCAR_BASE = BertConfig()

# BERT-large geometry for the VinVL_L rows in the Oscar performance table
# (`Oscar/README.md:30`; same img-feature pipeline, bigger encoder)
OSCAR_LARGE = BertConfig(hidden_size=1024, num_hidden_layers=24,
                         num_attention_heads=16, intermediate_size=4096)


def tiny_bert_config(**kw) -> BertConfig:
    """A tiny config for unit tests (fast CPU tracing, real code paths)."""
    base = dict(
        vocab_size=128,
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=64,
        max_position_embeddings=96,
        img_feature_dim=20,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
    )
    base.update(kw)
    return BertConfig(**base)
