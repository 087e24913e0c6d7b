"""Launchers for the shared tensor-core GEMM (``csrc/gemm.cu``) and the
attention core (``csrc/attention.cu``) that K3 and K4 chain together.

These take CUDA tensors only; the public wrappers with their plain
versions and launch counters are ``ops/fused_ffn.py`` and
``ops/fused_attention.py``.
"""
from __future__ import annotations

import torch

from cpt_tpu_torch.kernels.build import aligned16, check, lib, require, stream

ACTS = {"none": 0, "gelu": 1, "gelu_new": 2}
HOPPER_SMEM_PER_BLOCK = 232448   # opt-in dynamic shared memory of one block


def _rows(x: torch.Tensor, k: int, name: str) -> torch.Tensor:
    if x.shape[-1] != k or k % 8:
        raise ValueError(f"{name}: last dim {x.shape[-1]} must be {k} and a "
                         f"multiple of 8")
    return aligned16(require(x, name, torch.bfloat16))


def gemm_bias_act(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  act: str = "none") -> torch.Tensor:
    """a [M, K] . w [K, N] + bias [N] (f32), then ``act`` → [M, N] bf16."""
    k, n = w.shape
    a = _rows(a, k, "a")
    w = _rows(w, n, "w")
    bias = require(bias, "bias", torch.float32, (n,))
    out = torch.empty((a.shape[0], n), dtype=torch.bfloat16, device=a.device)
    check(lib().cpt_gemm_bias_act(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                  out.data_ptr(), a.shape[0], n, k, ACTS[act],
                                  stream(a)), "cpt_gemm_bias_act")
    return out


def gemm_bias_residual_ln(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                          residual: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm(a [M, K] . w [K, N] + bias + residual [M, N]) * gamma + beta
    → [M, N] bf16, with N a multiple of 128 up to 1024."""
    k, n = w.shape
    if n % 128 or n > 1024:
        raise ValueError(f"row LayerNorm GEMM takes N = 128..1024 in steps "
                         f"of 128, got {n}")
    a = _rows(a, k, "a")
    w = _rows(w, n, "w")
    residual = require(residual, "residual", torch.bfloat16, (a.shape[0], n))
    bias = require(bias, "bias", torch.float32, (n,))
    gamma = require(gamma, "gamma", torch.float32, (n,))
    beta = require(beta, "beta", torch.float32, (n,))
    out = torch.empty((a.shape[0], n), dtype=torch.bfloat16, device=a.device)
    check(lib().cpt_gemm_bias_residual_ln(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), residual.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), a.shape[0], n, k,
        float(eps), stream(a)), "cpt_gemm_bias_residual_ln")
    return out


def attention_core(qkv: torch.Tensor, key_bias: torch.Tensor, num_heads: int,
                   scale: float) -> torch.Tensor:
    """qkv [B, S, 3H] bf16, key_bias [B, S] f32 → context [B, S, H] bf16."""
    b, s, h3 = qkv.shape
    h = h3 // 3
    if h != num_heads * 64:
        raise ValueError(f"attention kernel takes head_dim 64; got hidden "
                         f"{h} over {num_heads} heads")
    smem = lib().cpt_attention_smem_bytes(s, 64)
    if smem > HOPPER_SMEM_PER_BLOCK:
        raise ValueError(f"sequence length {s} needs {smem} B of shared "
                         f"memory; a Hopper block has {HOPPER_SMEM_PER_BLOCK}")
    qkv = aligned16(require(qkv, "qkv", torch.bfloat16))
    key_bias = require(key_bias, "key_bias", torch.float32, (b, s))
    ctx = torch.empty((b, s, h), dtype=torch.bfloat16, device=qkv.device)
    check(lib().cpt_attention(qkv.data_ptr(), key_bias.data_ptr(),
                              ctx.data_ptr(), b, s, h, num_heads, float(scale),
                              stream(qkv)), "cpt_attention")
    return ctx
