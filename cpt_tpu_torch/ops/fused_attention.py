"""K3 — the BERT attention sub-block (port of ``cpt_tpu/ops/fused_attention.py``).

Computes ``LayerNorm(x + OutProj(softmax(QKᵀ·scale + key_bias)·V))``. On a
Hopper card ``fused_attention_block`` chains three hand-written launches:
the GEMM (``csrc/gemm.cu``: TMA-fed ``wgmma``) with a bias epilogue for
the QKV projection, the attention core (``csrc/attention.cu``: the
tensor-core tile of ``csrc/mma_attention.cuh`` with f32 scores and f32
softmax, any S with the ragged edge masked), and the GEMM with the
bias + residual + row-LayerNorm epilogue, on a thread-block cluster that
owns whole rows, for the output projection. These
replace the TPU's single ``_attn_kernel``; the [B·S, 3H] QKV and [B·S, H]
context make one bf16 round trip through device memory each.

On the CPU it runs :func:`reference_attention_block`, the JAX reference's
semantics: params cast to the input dtype, scores in that dtype, f32
softmax, LayerNorm with ``E[(y−μ)²]`` in f32.

Where an input requires a gradient the block is a
``torch.autograd.Function``, as the JAX block is a custom VJP: the forward
is the kernel chain (weights cast to the activation dtype first, as the
JAX ``_forward`` casts them), the backward differentiates the plain
version with autograd (:func:`plain_vjp`), as the JAX ``_bwd`` takes
``jax.vjp`` of ``reference_attention_block``. There is no backward kernel.
"""
from __future__ import annotations

import torch

from typing import Callable, Sequence

from cpt_tpu_torch.kernels.build import uses_kernel
from cpt_tpu_torch.kernels.gemm import (attention_core, gemm_bias_act,
                                        gemm_bias_residual_ln)


def layer_norm_f32(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """f32 LayerNorm with the fused kernels' variance ``E[(y−μ)²]``."""
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + eps) * gamma + beta


def reference_attention_core(qkv: torch.Tensor, key_bias: torch.Tensor,
                             num_heads: int, scale: float) -> torch.Tensor:
    """Plain version of the attention core alone, in f32:
    ``softmax(QKᵀ·scale + key_bias)·V`` on the packed projection
    qkv [B, S, 3H] (columns [q|k|v], head-major) → context [B, S, H]."""
    b, s, h3 = qkv.shape
    q, k, v = qkv.float().reshape(b, s, 3, num_heads, -1).unbind(2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = scores + key_bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h3 // 3)


def reference_attention_block(x, wqkv, bqkv, wo, bo, gamma, beta, key_bias,
                              *, num_heads: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``reference_attention_block``)."""
    dt = x.dtype
    b, s, h = x.shape
    hd = h // num_heads
    qkv = x @ wqkv.to(dt) + bqkv.to(dt)
    qkv = qkv.reshape(b, s, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
        float(hd) ** 0.5, dtype=dt)
    scores = scores + key_bias[:, None, None, :].to(dt)
    probs = torch.softmax(scores.float(), dim=-1).to(dt)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h)
    y = ctx @ wo.to(dt) + bo.to(dt)
    y = (y + x).float()
    return layer_norm_f32(y, gamma.float(), beta.float(), eps).to(dt)


def plain_vjp(plain: Callable, inputs: Sequence[torch.Tensor],
              needs_grad: Sequence[bool], g: torch.Tensor) -> tuple:
    """The gradients of ``plain(*inputs)`` for the output gradient ``g``,
    by autograd through the plain version; None where not needed."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(plain(*leaves), wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


def _block_forward(x, wqkv, bqkv, wo, bo, gamma, beta, key_bias, num_heads,
                   eps):
    if not uses_kernel(x):
        return reference_attention_block(x, wqkv, bqkv, wo, bo, gamma, beta,
                                         key_bias, num_heads=num_heads, eps=eps)
    b, s, h = x.shape
    xm = x.reshape(b * s, h)
    qkv = gemm_bias_act(xm, wqkv.to(x.dtype), bqkv.float())
    ctx = attention_core(qkv.reshape(b, s, 3 * h), key_bias.float(),
                         num_heads, 1.0 / float(h // num_heads) ** 0.5)
    out = gemm_bias_residual_ln(ctx.reshape(b * s, h), wo.to(x.dtype),
                                bo.float(), xm, gamma.float(), beta.float(),
                                eps)
    fused_attention_block.launches += 1
    return out.reshape(b, s, h)


class _FusedAttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, gamma, beta, key_bias, num_heads,
                eps):
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo, gamma, beta, key_bias)
        ctx.num_heads, ctx.eps = num_heads, eps
        return _block_forward(x, wqkv, bqkv, wo, bo, gamma, beta, key_bias,
                              num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        def plain(*a):
            return reference_attention_block(*a, num_heads=ctx.num_heads,
                                             eps=ctx.eps)

        return plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:8],
                         g) + (None, None)


def fused_attention_block(x: torch.Tensor, wqkv: torch.Tensor,
                          bqkv: torch.Tensor, wo: torch.Tensor,
                          bo: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, key_bias: torch.Tensor,
                          num_heads: int = 12, eps: float = 1e-12
                          ) -> torch.Tensor:
    """x [B, S, H]; wqkv [H, 3H] (columns [q|k|v], head-major within each);
    wo [H, H] (rows head-major); key_bias [B, S] additive f32 (0 / −10000);
    biases and LayerNorm params f32. Returns the post-LN hidden [B, S, H]."""
    args = (x, wqkv, bqkv, wo, bo, gamma, beta, key_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedAttentionBlock.apply(*args, num_heads, eps)
    return _block_forward(*args, num_heads, eps)


fused_attention_block.launches = 0
