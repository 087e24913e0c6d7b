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
the JAX model path. Under ``attention_impl="flash"`` the layer never takes
K3: ``BertSelfAttention`` sends its attention core to kernel K6
(``ops/attention.py``) as the JAX module does (no KV history, no head
mask, no active probability dropout), with the projections as matmuls.

Layouts follow the JAX parameter tree: ``wqkv [H, 3H]`` (columns
``[q|k|v]``, head-major), ``wo [H, H]``, dense kernels ``[in, out]``.
Every parameter is f32 and trainable, and is cast to the module's compute
dtype where it is used, as the JAX modules do (``nn.Embed``/``nn.Dense``
with ``dtype``, the ``astype(dt)`` of the attention and FFN weights).
Dropout is active in training mode (``model.train()``, JAX's
``deterministic=False``) and draws its masks from the ``torch.Generator``
passed to ``forward`` (``generator=``), never from the global RNG.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.config.bert import BertConfig
from cpt_tpu_torch.ops.attention import flash_mha
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


def _param(*shape) -> nn.Parameter:
    """An f32 parameter (filled by ``load_state_dict``)."""
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training mode keep each element with
    probability ``1 − rate`` and scale it by ``1 / (1 − rate)``; the keep
    mask comes from ``generator``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode draws from the train "
                             "step's torch.Generator; none was passed")
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class Dense(nn.Module):
    """``x·kernel + bias`` with ``kernel [in, out]`` and ``bias`` f32, both
    cast to the compute dtype (flax ``nn.Dense(dtype=...)`` semantics)."""

    def __init__(self, fin: int, fout: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(fin, fout)
        self.bias = _param(fout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """f32 LayerNorm parameters (``scale``, ``bias``) with the fast variance."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.scale = _param(dim)
        self.bias = _param(dim)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_fast(x, self.scale, self.bias, self.eps)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.dtype = dtype
        self.word_embeddings = _param(c.vocab_size, c.hidden_size)
        self.position_embeddings = _param(c.max_position_embeddings,
                                          c.hidden_size)
        self.token_type_embeddings = _param(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)[None, :]
        dt = self.dtype
        x = (self.word_embeddings[input_ids].to(dt)
             + self.position_embeddings[position_ids].to(dt)
             + self.token_type_embeddings[token_type_ids].to(dt))
        return self.dropout(self.LayerNorm(x), generator)


class BertSelfAttention(nn.Module):
    """Joint self-attention parameters (fused QKV), its flash path (K6) and
    its plain einsum path, with optional KV history (keys/values over
    ``[history, hidden]``, queries over ``hidden``) and head mask."""

    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.dtype = dtype
        self.wqkv = _param(h, 3 * h)
        self.bqkv = _param(3 * h)
        self.wo = _param(h, h)
        self.bo = _param(h)
        self.probs_dropout = Dropout(config.attention_probs_dropout_prob)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                history_state: Optional[torch.Tensor] = None,
                head_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.config
        nh, hd = c.num_attention_heads, c.head_dim
        dt = self.dtype
        b, s, _ = hidden.shape
        wqkv, bq, wo = self.wqkv.to(dt), self.bqkv.to(dt), self.wo.to(dt)
        proj = (hidden @ wqkv + bq).reshape(b, s, 3, nh, hd)
        q, k, v = proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]
        if history_state is not None:
            hist = (history_state @ wqkv + bq).reshape(
                b, history_state.shape[1], 3, nh, hd)
            k = torch.cat([hist[:, :, 1], k], dim=1)
            v = torch.cat([hist[:, :, 2], v], dim=1)
        if (c.attention_impl == "flash" and history_state is None
                and head_mask is None
                and (not self.training or c.attention_probs_dropout_prob == 0.0)):
            # [B, S, H, D] views → [B, H, S, D]; the bias broadcasts over
            # heads and rows
            ctx = flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), attn_bias,
                            sm_scale=1.0 / float(hd) ** 0.5)
            ctx = ctx.transpose(1, 2).reshape(b, s, nh * hd)
            return ctx @ wo + self.bo.to(dt)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
            float(hd) ** 0.5, dtype=dt)
        scores = scores + attn_bias
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        probs = self.probs_dropout(probs, generator)
        if head_mask is not None:
            probs = probs * head_mask
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, nh * hd)
        return ctx @ wo + self.bo.to(dt)


def auto_fuses_attention(c: BertConfig) -> bool:
    """``attention_impl="auto"``'s width rule, the JAX gate's
    (``cpt_tpu/models/bert/model.py``: ``hidden_size % 128``); the TPU's
    ``S % 128`` rule is not kept (K3's core takes any S). K3 runs at every
    width this rule passes, with any head count: its core at every head_dim
    (``kernels/gemm.attention_path``: the tensor-core tile up to 256, its
    CUDA-core kernel past it), its output projection's row LayerNorm at
    every hidden size (``ln_gemm_path``: a cluster up to 1024, the split
    path past it). Under ``"fused"`` at a hidden size off 128 the
    LayerNorm GEMM raises ``KernelError`` on the card."""
    return c.hidden_size % 128 == 0


def auto_fuses_ffn(c: BertConfig) -> bool:
    """``ffn_impl="auto"``'s width rule, the JAX gate's (``hidden_size``
    and ``intermediate_size`` multiples of 128). K4 runs at every width it
    passes (the row-LayerNorm GEMM's split path past a hidden size of
    1024)."""
    return c.hidden_size % 128 == 0 and c.intermediate_size % 128 == 0


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
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                history_state: Optional[torch.Tensor] = None,
                head_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.config
        dropout_h = c.hidden_dropout_prob > 0.0 and self.training
        dropout_a = c.attention_probs_dropout_prob > 0.0 and self.training
        key_bias_only = attn_bias.dim() == 4 and attn_bias.shape[2] == 1
        attn = self.attention
        ln_a = self.attention_out_LayerNorm
        if ((c.attention_impl == "fused"
             or (c.attention_impl == "auto" and auto_fuses_attention(c)))
                and history_state is None and head_mask is None
                and not dropout_h and not dropout_a and key_bias_only):
            hidden = fused_attention_block(
                hidden, attn.wqkv, attn.bqkv, attn.wo, attn.bo, ln_a.scale,
                ln_a.bias, attn_bias[:, 0, 0, :].float(),
                c.num_attention_heads, c.layer_norm_eps)
        else:
            attn_out = self.dropout(attn(hidden, attn_bias, history_state,
                                         head_mask, generator), generator)
            hidden = layer_norm_fast(hidden + attn_out, ln_a.scale, ln_a.bias,
                                     c.layer_norm_eps)

        ln = self.output_LayerNorm
        if ((c.ffn_impl == "fused"
             or (c.ffn_impl == "auto" and auto_fuses_ffn(c)))
                and not dropout_h and c.hidden_act in ("gelu", "gelu_new")):
            return fused_ffn(hidden, self.intermediate.kernel,
                             self.intermediate.bias, self.output.kernel,
                             self.output.bias, ln.scale, ln.bias,
                             eps=c.layer_norm_eps,
                             approximate=c.hidden_act == "gelu_new")
        inter = ACT[c.hidden_act](self.intermediate(hidden))
        out = self.dropout(self.output(inter), generator)
        return layer_norm_fast(hidden + out, ln.scale, ln.bias, c.layer_norm_eps)


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(config, dtype)
                                   for _ in range(config.num_hidden_layers))

    def forward(self, hidden, attn_bias, history_states=None, head_mask=None,
                generator=None):
        for i, layer in enumerate(self.layer):
            hs = None if history_states is None else history_states[i]
            hm = None if head_mask is None else head_mask[i]
            hidden = layer(hidden, attn_bias, hs, hm, generator)
        return hidden


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.dense = Dense(config.hidden_size, config.hidden_size, dtype)

    def forward(self, sequence_output: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(sequence_output[:, 0]))


IMG_FEATURE_TYPES = ("faster_r-cnn", "dis_code", "dis_code_t")


def img_embedding_in(config: BertConfig) -> int:
    """The input width of ``img_embedding``: the region-feature width, or
    for the discrete codes the code embedding's width (``dis_code``) or,
    transposed, the code length per image (``dis_code_t``, ``code_size``)."""
    c = config
    return {"dis_code": c.code_dim,
            "dis_code_t": c.code_size}.get(c.img_feature_type, c.img_feature_dim)


class BertImgModel(nn.Module):
    """Text ⊕ image-region joint encoder (reference ``BertImgModel``).
    ``img_feature_type`` "faster_r-cnn" projects float region features
    (LayerNorm and dropout after, where configured); "dis_code" looks integer
    VQ-VAE code ids up in ``code_embeddings [code_voc, code_dim]`` and
    projects each code's row, "dis_code_t" projects each embedding dimension's
    column over the codes; neither code branch has the image LayerNorm or
    dropout (``cpt_tpu/models/bert/model.py:367-371``)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        if c.img_feature_type not in IMG_FEATURE_TYPES:
            raise ValueError(f"img_feature_type {c.img_feature_type!r}: one "
                             f"of {IMG_FEATURE_TYPES}")
        self.config = c
        self.dtype = dtype
        self.embeddings = BertEmbeddings(c, dtype)
        self.code_embeddings = (_param(c.code_voc, c.code_dim)
                                if c.img_feature_type.startswith("dis_code")
                                else None)
        self.img_embedding = Dense(img_embedding_in(c), c.hidden_size, dtype)
        self.img_LayerNorm = (LayerNorm(c.hidden_size, c.img_layer_norm_eps)
                              if c.use_img_layernorm else None)
        self.img_dropout = Dropout(c.hidden_dropout_prob)
        self.encoder = BertEncoder(c, dtype)
        self.pooler = BertPooler(c, dtype)

    def embed(self, input_ids, token_type_ids=None, attention_mask=None,
              position_ids=None, img_feats=None, generator=None
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
        emb = self.embeddings(input_ids, token_type_ids, position_ids,
                              generator)
        if img_feats is not None:
            if self.code_embeddings is not None:
                code = self.code_embeddings.to(self.dtype)[img_feats.long()]
                if self.config.img_feature_type == "dis_code_t":
                    code = code.transpose(1, 2)
                emb = torch.cat([emb, self.img_embedding(code)], dim=1)
            else:
                img_emb = self.img_embedding(img_feats)
                if self.img_LayerNorm is not None:
                    img_emb = self.img_LayerNorm(img_emb)
                emb = torch.cat([emb, self.img_dropout(img_emb, generator)],
                                dim=1)
        return emb, attn_bias

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None, img_feats=None, history_states=None,
                head_mask=None, generator=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        emb, attn_bias = self.embed(input_ids, token_type_ids, attention_mask,
                                    position_ids, img_feats, generator)
        seq = self.encoder(emb, attn_bias, history_states, head_mask,
                           generator)
        return seq, self.pooler(seq)
