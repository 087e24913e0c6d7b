"""K6 — flash attention (port of ``cpt_tpu/ops/attention.py``).

``flash_mha(q, k, v, bias, sm_scale=...)`` keeps the JAX signature and
layout: q/k/v ``[B, H, S, D]`` (strided views are taken as they are),
``bias`` broadcastable to ``[B, H, S, S]``. It computes what the library's
TPU flash-attention forward computes, in its order: the bias cast to
``q.dtype``, ``s = (q·kᵀ in f32 + bias) · sm_scale`` (the bias is added
before the scale, unlike :func:`einsum_mha`), softmax in f32 with the
unnormalised probabilities rounded to ``v.dtype`` before P·V, f32
accumulation, the output in ``q.dtype``.

On a Hopper card it launches ``csrc/flash_attention.cu`` (online softmax
over 64-key tiles, the ragged edge masked by index, the bias read through
its strides); on the CPU it runs :func:`reference_flash_mha`. The output is
a ``[B, H, S, D]`` view of a ``[B, S, H, D]`` buffer, so the model's
transpose back to ``[B, S, H·D]`` is free.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cpt_tpu_torch.kernels.build import check, lib, stream, uses_kernel

HEAD_DIMS = (32, 64, 128)


def reference_flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *,
                        sm_scale: float = 1.0) -> torch.Tensor:
    """Plain version with the library's numerics. A row whose scores are
    all −inf comes out 0 (the library's ``l_next_inv_safe`` guard)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if bias is not None:
        s = s + bias.to(q.dtype).float()
    s = s * sm_scale
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / torch.where(denom == 0, 1.0, denom)).to(q.dtype)


def einsum_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               sm_scale: float = 1.0) -> torch.Tensor:
    """Reference einsum attention (f32 softmax), [B, H, S, D] layout: the
    bias is added after the scale."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _rows16(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` where the kernel's 16-byte row loads can read it in place
    (last dim contiguous, other strides multiples of 8, base aligned),
    else a fresh contiguous copy."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: kernel takes torch.bfloat16, got {t.dtype}")
    if (t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *,
              sm_scale: float = 1.0) -> torch.Tensor:
    """q/k/v [B, H, S, D]; bias broadcastable to [B, H, S, S] additive.
    Returns [B, H, S, D] in ``q.dtype``."""
    if not uses_kernel(q):
        return reference_flash_mha(q, k, v, bias, sm_scale=sm_scale)
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {d}")
    q, k, v = (_rows16(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device
                      ).transpose(1, 2)
    bias_ptr, bias_strides = None, [0, 0, 0, 0]
    if bias is not None:
        bias = torch.broadcast_to(bias.to(q.dtype), (b, h, s, s))
        bias_ptr, bias_strides = bias.data_ptr(), list(bias.stride())
    strides = (ctypes.c_longlong * 16)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *bias_strides)
    if b and h and s:
        check(lib().cpt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), strides, b, h, s, d, float(sm_scale), stream(q)),
            "cpt_flash_attention")
        flash_mha.launches += 1
    return out


flash_mha.launches = 0
