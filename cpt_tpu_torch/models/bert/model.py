"""Oscar cross-modal BERT (``BertImgModel``) in PyTorch (port of
``cpt_tpu/models/bert/model.py``).

Text-token embeddings ⊕ linearly projected region features (2054 → hidden)
through a BERT encoder with joint self-attention and the additive
``(1 − mask)·−10000`` attention bias.

Each ``BertLayer`` routes its attention sub-block through kernel K3
(``ops/fused_attention.py``) and its FFN through kernel K4
(``ops/fused_ffn.py``) whenever the semantics allow: for K3 no KV history,
no head mask, no active dropout and a key-only (2-D) mask; for K4 no active
dropout and a gelu activation. Unlike the TPU gate, S and H need not be
multiples of 128 (the kernels mask the ragged edge). Otherwise the layer
takes the plain einsum/dense path, whose LayerNorm uses ``E[y²]−μ²`` like
the JAX model path.

Layouts follow the JAX parameter tree: ``wqkv [H, 3H]`` (columns
``[q|k|v]``, head-major), ``wo [H, H]``, dense kernels ``[in, out]``.
Matmul weights and embedding tables live in the model dtype; biases and
LayerNorm parameters in f32 (cast at use, as the JAX modules do).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu.config.bert import BertConfig
from cpt_tpu_torch.ops.fused_attention import fused_attention_block
from cpt_tpu_torch.ops.fused_ffn import fused_ffn

ATTN_MASK_BIAS = -10000.0  # reference additive-mask constant

ACT = {"gelu": F.gelu, "relu": F.relu,
       "gelu_new": lambda x: F.gelu(x, approximate="tanh")}


def extend_attention_mask(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, S] or [B, S, S] 0/1 mask → additive bias [B, 1, {1|S}, S]."""
    if mask.dim() == 2:
        ext = mask[:, None, None, :]
    elif mask.dim() == 3:
        ext = mask[:, None, :, :]
    else:
        raise ValueError(f"attention mask must be 2D or 3D, got {mask.dim()}D")
    return (1.0 - ext.to(dtype)) * ATTN_MASK_BIAS


def layer_norm_fast(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """f32 LayerNorm with ``var = E[y²] − μ²`` (the JAX model path and
    flax's ``nn.LayerNorm``), returned in the input dtype."""
    y = x.float()
    mu = y.mean(-1, keepdim=True)
    var = torch.clamp(y.square().mean(-1, keepdim=True) - mu.square(), min=0.0)
    return ((y - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def _param(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


class Dense(nn.Module):
    """``x·kernel + bias`` with ``kernel [in, out]`` in the model dtype and an
    f32 bias cast to it (flax ``nn.Dense(dtype=...)`` semantics)."""

    def __init__(self, fin: int, fout: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = _param(fin, fout, dtype=dtype)
        self.bias = _param(fout, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.kernel.dtype
        return x.to(dt) @ self.kernel + self.bias.to(dt)


class LayerNorm(nn.Module):
    """f32 LayerNorm parameters (``scale``, ``bias``) with the fast variance."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.scale = _param(dim, dtype=torch.float32)
        self.bias = _param(dim, dtype=torch.float32)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_fast(x, self.scale, self.bias, self.eps)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.word_embeddings = _param(c.vocab_size, c.hidden_size, dtype=dtype)
        self.position_embeddings = _param(c.max_position_embeddings,
                                          c.hidden_size, dtype=dtype)
        self.token_type_embeddings = _param(c.type_vocab_size, c.hidden_size,
                                            dtype=dtype)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)[None, :]
        x = (self.word_embeddings[input_ids]
             + self.position_embeddings[position_ids]
             + self.token_type_embeddings[token_type_ids])
        return self.dropout(self.LayerNorm(x))


class BertSelfAttention(nn.Module):
    """Joint self-attention parameters (fused QKV) and its plain einsum
    path, with optional KV history (keys/values over ``[history, hidden]``,
    queries over ``hidden``) and head mask."""

    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.wqkv = _param(h, 3 * h, dtype=dtype)
        self.bqkv = _param(3 * h, dtype=torch.float32)
        self.wo = _param(h, h, dtype=dtype)
        self.bo = _param(h, dtype=torch.float32)
        self.probs_dropout = nn.Dropout(config.attention_probs_dropout_prob)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                history_state: Optional[torch.Tensor] = None,
                head_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.config
        nh, hd = c.num_attention_heads, c.head_dim
        dt = self.wqkv.dtype
        b, s, _ = hidden.shape
        bq = self.bqkv.to(dt)
        proj = (hidden @ self.wqkv + bq).reshape(b, s, 3, nh, hd)
        q, k, v = proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]
        if history_state is not None:
            hist = (history_state @ self.wqkv + bq).reshape(
                b, history_state.shape[1], 3, nh, hd)
            k = torch.cat([hist[:, :, 1], k], dim=1)
            v = torch.cat([hist[:, :, 2], v], dim=1)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
            float(hd) ** 0.5, dtype=dt)
        scores = scores + attn_bias
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        probs = self.probs_dropout(probs)
        if head_mask is not None:
            probs = probs * head_mask
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, nh * hd)
        return ctx @ self.wo + self.bo.to(dt)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.config = c
        self.attention = BertSelfAttention(c, dtype)
        self.attention_out_LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.intermediate = Dense(c.hidden_size, c.intermediate_size, dtype)
        self.output = Dense(c.intermediate_size, c.hidden_size, dtype)
        self.output_LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                history_state: Optional[torch.Tensor] = None,
                head_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.config
        if c.attention_impl == "flash":
            raise NotImplementedError(
                "attention_impl='flash' (the TPU flash-attention kernel) is "
                "not ported yet")
        dropout_h = c.hidden_dropout_prob > 0.0 and self.training
        dropout_a = c.attention_probs_dropout_prob > 0.0 and self.training
        key_bias_only = attn_bias.dim() == 4 and attn_bias.shape[2] == 1
        attn = self.attention
        ln_a = self.attention_out_LayerNorm
        if (c.attention_impl in ("auto", "fused") and history_state is None
                and head_mask is None and not dropout_h and not dropout_a
                and key_bias_only):
            hidden = fused_attention_block(
                hidden, attn.wqkv, attn.bqkv, attn.wo, attn.bo, ln_a.scale,
                ln_a.bias, attn_bias[:, 0, 0, :].float(),
                c.num_attention_heads, c.layer_norm_eps)
        else:
            attn_out = self.dropout(attn(hidden, attn_bias, history_state,
                                         head_mask))
            hidden = layer_norm_fast(hidden + attn_out, ln_a.scale, ln_a.bias,
                                     c.layer_norm_eps)

        ln = self.output_LayerNorm
        if (c.ffn_impl in ("auto", "fused") and not dropout_h
                and c.hidden_act in ("gelu", "gelu_new")):
            return fused_ffn(hidden, self.intermediate.kernel,
                             self.intermediate.bias, self.output.kernel,
                             self.output.bias, ln.scale, ln.bias,
                             eps=c.layer_norm_eps,
                             approximate=c.hidden_act == "gelu_new")
        inter = ACT[c.hidden_act](self.intermediate(hidden))
        out = self.dropout(self.output(inter))
        return layer_norm_fast(hidden + out, ln.scale, ln.bias, c.layer_norm_eps)


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(config, dtype)
                                   for _ in range(config.num_hidden_layers))

    def forward(self, hidden, attn_bias, history_states=None, head_mask=None):
        for i, layer in enumerate(self.layer):
            hs = None if history_states is None else history_states[i]
            hm = None if head_mask is None else head_mask[i]
            hidden = layer(hidden, attn_bias, hs, hm)
        return hidden


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.dense = Dense(config.hidden_size, config.hidden_size, dtype)

    def forward(self, sequence_output: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(sequence_output[:, 0]))


class BertImgModel(nn.Module):
    """Text ⊕ image-region joint encoder (reference ``BertImgModel``), for
    the region-feature input every CPT task uses (``img_feature_type``
    "faster_r-cnn"; the discrete-code variants are not ported yet)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        if c.img_feature_type != "faster_r-cnn":
            raise NotImplementedError(
                f"img_feature_type {c.img_feature_type!r} is not ported yet")
        self.config = c
        self.dtype = dtype
        self.embeddings = BertEmbeddings(c, dtype)
        self.img_embedding = Dense(c.img_feature_dim, c.hidden_size, dtype)
        self.img_LayerNorm = (LayerNorm(c.hidden_size, c.img_layer_norm_eps)
                              if c.use_img_layernorm else None)
        self.img_dropout = nn.Dropout(c.hidden_dropout_prob)
        self.encoder = BertEncoder(c, dtype)
        self.pooler = BertPooler(c, dtype)

    def embed(self, input_ids, token_type_ids=None, attention_mask=None,
              position_ids=None, img_feats=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (embeddings ⊕ projected image features, additive attention
        bias): everything before the encoder stack."""
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            n_img = 0 if img_feats is None else img_feats.shape[1]
            attention_mask = torch.ones(
                (input_ids.shape[0], input_ids.shape[1] + n_img),
                dtype=input_ids.dtype, device=input_ids.device)
        attn_bias = extend_attention_mask(attention_mask, self.dtype)
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        if img_feats is not None:
            img_emb = self.img_embedding(img_feats)
            if self.img_LayerNorm is not None:
                img_emb = self.img_LayerNorm(img_emb)
            emb = torch.cat([emb, self.img_dropout(img_emb)], dim=1)
        return emb, attn_bias

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None, img_feats=None, history_states=None,
                head_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        emb, attn_bias = self.embed(input_ids, token_type_ids, attention_mask,
                                    position_ids, img_feats)
        seq = self.encoder(emb, attn_bias, history_states, head_mask)
        return seq, self.pooler(seq)
