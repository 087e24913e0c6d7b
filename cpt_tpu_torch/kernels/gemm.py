"""Launchers for the shared tensor-core GEMM (``csrc/gemm.cu``) and the
attention core (``csrc/attention.cu``) that K3 and K4 chain together.

These take CUDA tensors only. They run at every width the JAX gate sends
to its Pallas kernels (``hidden_size % 128 == 0``, any head count): the
attention core at any head_dim, on the path :func:`attention_path` names
(the tensor-core tile up to 256, a multiple of 8; the CUDA-core kernel
otherwise), and the row-LayerNorm GEMM at any N that is a multiple of 128,
on the path :func:`ln_gemm_path` names (a cluster up to 1024, the split
path past it). They raise ``KernelError`` only where the JAX gate refuses
too (a LayerNorm width off 128, a hidden size the heads do not divide) or
the TMA loads cannot stride (K or N off 8). The public wrappers with their
plain versions and launch counters are ``ops/fused_ffn.py`` and
``ops/fused_attention.py``.
"""
from __future__ import annotations

import torch

from cpt_tpu_torch.kernels.build import (KernelError, aligned16, check, lib,
                                         require, stream)

ACTS = {"none": 0, "gelu": 1, "gelu_new": 2}
ATTENTION_PATHS = ("mma", "simt")
LN_GEMM_PATHS = ("cluster", "split")
TILE_MAX_HEAD_DIM = 256         # csrc/mma_attention.cuh kMaxD
CLUSTER_MAX_N = 1024            # 8 blocks of 128 columns, the portable cluster


def attention_path(head_dim: int) -> str:
    """The attention kernels' path for ``head_dim`` (K3's core and K6 / K6b
    / K6c alike): ``"mma"``, the tensor-core tile, for a multiple of 8 up to
    256 (one that is not a multiple of 16 zero-padded to the next 16 in
    shared memory); ``"simt"``, the CUDA-core kernel, for any other."""
    if head_dim < 1:
        raise KernelError(f"head_dim {head_dim}")
    return ("mma" if head_dim % 8 == 0 and head_dim <= TILE_MAX_HEAD_DIM
            else "simt")


def ln_gemm_path(n: int) -> str:
    """The row-LayerNorm GEMM's path for rows of ``n``: ``"cluster"`` (N / 128
    blocks exchange the row sums through distributed shared memory) up to
    1024, ``"split"`` (f32 rows and per-tile statistics through device
    memory, merged by a row kernel) past it; ``KernelError`` unless ``n`` is
    a positive multiple of 128 (as the JAX gate's ``hidden_size % 128``)."""
    if n <= 0 or n % 128:
        raise KernelError(f"row LayerNorm GEMM takes N a multiple of 128, "
                          f"got {n}")
    return "cluster" if n <= CLUSTER_MAX_N else "split"


def _rows(x: torch.Tensor, k: int, name: str) -> torch.Tensor:
    if x.shape[-1] != k or k % 8:
        raise KernelError(f"{name}: last dim {x.shape[-1]} must be {k} and a "
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
    → [M, N] bf16, N a multiple of 128, on the path :func:`ln_gemm_path`
    names (a cluster the card refuses raises ``KernelError``)."""
    k, n = w.shape
    path = ln_gemm_path(n)
    a = _rows(a, k, "a")
    w = _rows(w, n, "w")
    m = a.shape[0]
    residual = require(residual, "residual", torch.bfloat16, (m, n))
    bias = require(bias, "bias", torch.float32, (n,))
    gamma = aligned16(require(gamma, "gamma", torch.float32, (n,)))
    beta = aligned16(require(beta, "beta", torch.float32, (n,)))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    ptrs = (a.data_ptr(), w.data_ptr(), bias.data_ptr(), residual.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr())
    if path == "split":
        y = torch.empty((m, n), dtype=torch.float32, device=a.device)
        stats = torch.empty((m, n // 128, 2), dtype=torch.float32,
                            device=a.device)
        check(lib().cpt_gemm_bias_residual_ln_split(
            *ptrs, y.data_ptr(), stats.data_ptr(), m, n, k, float(eps),
            stream(a)), "cpt_gemm_bias_residual_ln_split")
    else:
        check(lib().cpt_gemm_bias_residual_ln(*ptrs, m, n, k, float(eps),
                                              stream(a)),
              "cpt_gemm_bias_residual_ln")
    gemm_bias_residual_ln.path_launches[path] += 1
    return out


def attention_core(qkv: torch.Tensor, key_bias: torch.Tensor, num_heads: int,
                   scale: float) -> torch.Tensor:
    """qkv [B, S, 3H] bf16, key_bias [B, S] f32 → context [B, S, H] bf16,
    at any S (the tile streams the keys through a fixed ring) and any head
    dim H / num_heads, on the path :func:`attention_path` names."""
    b, s, h3 = qkv.shape
    h = h3 // 3
    if num_heads < 1 or h3 % 3 or h % num_heads:
        raise KernelError(f"attention kernel: hidden {h} over {num_heads} "
                          f"heads")
    path = attention_path(h // num_heads)
    qkv = require(qkv, "qkv", torch.bfloat16)
    if path == "mma":
        qkv = aligned16(qkv)
    key_bias = require(key_bias, "key_bias", torch.float32, (b, s))
    ctx = torch.empty((b, s, h), dtype=torch.bfloat16, device=qkv.device)
    check(lib().cpt_attention(qkv.data_ptr(), key_bias.data_ptr(),
                              ctx.data_ptr(), b, s, h, num_heads, float(scale),
                              int(path == "simt"), stream(qkv)),
          "cpt_attention")
    attention_core.path_launches[path] += 1
    return ctx


# launches per path, beside the block counters of ops/fused_attention.py and
# ops/fused_ffn.py (which count one a block)
gemm_bias_residual_ln.path_launches = dict.fromkeys(LN_GEMM_PATHS, 0)
attention_core.path_launches = dict.fromkeys(ATTENTION_PATHS, 0)
