"""K4 — the BERT FFN block (port of ``cpt_tpu/ops/fused_ffn.py``).

Computes ``LayerNorm(x + gelu(x·W1 + b1)·W2 + b2)`` (erf gelu, or tanh for
``gelu_new``). On a Hopper card ``fused_ffn`` chains two launches of the
hand-written GEMM (``csrc/gemm.cu``: TMA-fed ``wgmma``): epilogue (b)
bias + gelu into a bf16 [M, F] intermediate, then epilogue (c) bias +
residual + row LayerNorm on a thread-block cluster that owns whole rows
(hidden up to 1024; past it the split path of ``kernels/gemm.ln_gemm_path``,
so every hidden size that is a multiple of 128 runs, as on the TPU).
These replace the TPU's ``_ffn_kernel``, which kept the [M, F]
intermediate in VMEM; here it makes one round trip through device memory
(at the scoring batch 11.8 MB, ~7 µs at HBM rate), because keeping it on
chip would hold a [rows, H] f32 accumulator across the F loop in every
block and leave too few blocks to fill the card (``csrc/gemm.cu``).

On the CPU it runs :func:`reference_ffn`, the JAX ``_reference_ffn``
semantics: params cast to the input dtype, exact gelu, LayerNorm with
``E[(y−μ)²]`` in f32.

Where an input requires a gradient the block is a
``torch.autograd.Function`` whose forward is the kernel chain (weights
cast to the activation dtype) and whose backward differentiates
:func:`reference_ffn` with autograd, as the JAX custom VJP does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cpt_tpu_torch.kernels.build import uses_kernel
from cpt_tpu_torch.kernels.gemm import gemm_bias_act, gemm_bias_residual_ln
from cpt_tpu_torch.ops.fused_attention import layer_norm_f32, plain_vjp


def reference_ffn(x, w1, b1, w2, b2, gamma, beta, eps: float,
                  approximate: bool) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``_reference_ffn``)."""
    dt = x.dtype
    h = x @ w1.to(dt) + b1.to(dt)
    h = F.gelu(h, approximate="tanh" if approximate else "none")
    y = h @ w2.to(dt) + b2.to(dt)
    y = (y + x).float()
    return layer_norm_f32(y, gamma.float(), beta.float(), eps).to(dt)


def _ffn_forward(x, w1, b1, w2, b2, gamma, beta, eps, approximate):
    if not uses_kernel(x):
        return reference_ffn(x, w1, b1, w2, b2, gamma, beta, eps, approximate)
    shape = x.shape
    xm = x.reshape(-1, shape[-1])
    inter = gemm_bias_act(xm, w1.to(x.dtype), b1.float(),
                          "gelu_new" if approximate else "gelu")
    out = gemm_bias_residual_ln(inter, w2.to(x.dtype), b2.float(), xm,
                                gamma.float(), beta.float(), eps)
    fused_ffn.launches += 1
    return out.reshape(shape)


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, eps, approximate):
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma, beta)
        ctx.eps, ctx.approximate = eps, approximate
        return _ffn_forward(x, w1, b1, w2, b2, gamma, beta, eps, approximate)

    @staticmethod
    def backward(ctx, g):
        def plain(*a):
            return reference_ffn(*a, ctx.eps, ctx.approximate)

        return plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:7],
                         g) + (None, None)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor, eps: float = 1e-12,
              approximate: bool = False) -> torch.Tensor:
    """x [..., H] → LayerNorm(x + gelu(x·W1+b1)·W2+b2); w1 [H, F], w2 [F, H]
    (cast to x's dtype), biases and LayerNorm params f32."""
    args = (x, w1, b1, w2, b2, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedFFN.apply(*args, eps, approximate)
    return _ffn_forward(*args, eps, approximate)


fused_ffn.launches = 0
