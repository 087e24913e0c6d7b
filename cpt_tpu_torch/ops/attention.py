"""K6, K6b, K6c — flash attention and its backward (port of
``cpt_tpu/ops/attention.py``).

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
its strides); on the CPU it runs the plain version. The output is a
``[B, H, S, D]`` view of a ``[B, S, H, D]`` buffer, so the model's
transpose back to ``[B, S, H·D]`` is free.

Where q, k or v require a gradient, ``flash_mha`` is a
``torch.autograd.Function``, as the library's ``_flash_attention`` is a
custom VJP: the forward also keeps each row's max ``m`` and sum ``l``; the
backward computes ``di = Σ_d o·do`` in f32 as a torch op (as the library
does, outside its kernels), then :func:`flash_mha_bwd_dkv` (K6b,
``csrc/flash_attention_bwd.cu``) for dK and dV and :func:`flash_mha_bwd_dq`
(K6c) for dQ, from ``p = exp((q·kᵀ + bias)·scale − m) / l``. On the CPU the
same Function runs the plain forward and the plain backward. The bias
gradient (the library's ``ds``) is on no model path: asking for it raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cpt_tpu_torch.kernels.build import check, lib, require, stream, uses_kernel

HEAD_DIMS = (32, 64, 128)


def _flash_forward_plain(q, k, v, bias, sm_scale):
    """→ (o in ``q.dtype``, row max m, row sum l) in f32, the library's
    numerics. A row whose scores are all −inf gets m = 0, l = 0 and comes
    out 0 (the library's ``l_next_inv_safe`` guard)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if bias is not None:
        s = s + bias.to(q.dtype).float()
    s = s * sm_scale
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    o = (o / torch.where(denom == 0, 1.0, denom)).to(q.dtype)
    return o, m[..., 0], denom[..., 0]


def reference_flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *,
                        sm_scale: float = 1.0) -> torch.Tensor:
    """Plain version of the forward with the library's numerics."""
    return _flash_forward_plain(q, k, v, bias, sm_scale)[0]


def _probs_dscores(q, k, v, bias, do, m, l, di, sm_scale):
    """The library backward's ``p = exp((q·kᵀ + bias)·scale − m) · (1/l)``
    (0 where l == 0) and ``ds = (do·vᵀ − di)·p·scale``, [B, H, S, S] f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if bias is not None:
        s = s + bias.to(q.dtype).float()
    inv_l = torch.where(l == 0, 0.0, 1.0 / l)
    p = torch.exp(s * sm_scale - m[..., None]) * inv_l[..., None]
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, (dp - di[..., None]) * p * sm_scale


def flash_mha_bwd_dkv_plain(q, k, v, bias, do, m, l, di, sm_scale):
    """Plain version of K6b (the kernel's arithmetic and roundings)."""
    p, ds = _probs_dscores(q, k, v, bias, do, m, l, di, sm_scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(do.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_mha_bwd_dq_plain(q, k, v, bias, do, m, l, di, sm_scale):
    """Plain version of K6c."""
    _, ds = _probs_dscores(q, k, v, bias, do, m, l, di, sm_scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def _row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = Σ_d o·do in f32, contiguous [B, H, S]."""
    return (o.float() * do.float()).sum(-1).contiguous()


def reference_flash_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: Optional[torch.Tensor], do: torch.Tensor, *,
                            sm_scale: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain (dq, dk, dv) of ``flash_mha`` for the output gradient ``do``,
    by the library's formula (``mha_reference_bwd``): the plain forward's o,
    m and l, ``di = Σ_d o·do``, ``p = exp((q·kᵀ + bias)·scale − m) / l``,
    ``dv = pᵀ·do``, ``ds = (do·vᵀ − di)·p·scale``, ``dq = ds·k``,
    ``dk = dsᵀ·q``; p and ds rounded to the input dtype before their
    products, as the library's kernels round them."""
    o, m, l = _flash_forward_plain(q, k, v, bias, sm_scale)
    di = _row_dot(o, do)
    dk, dv = flash_mha_bwd_dkv_plain(q, k, v, bias, do, m, l, di, sm_scale)
    return flash_mha_bwd_dq_plain(q, k, v, bias, do, m, l, di, sm_scale), dk, dv


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


def _check_qkv(q, k, v, *more) -> None:
    if any(t.shape != q.shape for t in (k, v, *more)):
        raise ValueError(f"q, k, v (and do) must share one [B, H, S, D] shape; "
                         f"got {[tuple(t.shape) for t in (q, k, v, *more)]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")


def _bias_arg(bias, q):
    """(tensor, pointer, four strides) of the bias broadcast to
    [B, H, S, S] in ``q.dtype`` (None, None, zeros without a bias); the
    caller holds the tensor while the kernel reads it."""
    if bias is None:
        return None, None, [0, 0, 0, 0]
    b, h, s, _ = q.shape
    bias = torch.broadcast_to(bias.to(q.dtype), (b, h, s, s))
    return bias, bias.data_ptr(), list(bias.stride())


def _bhsd_out(q: torch.Tensor) -> torch.Tensor:
    """An empty [B, H, S, D] view of a [B, S, H, D] buffer."""
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *, sm_scale: float = 1.0,
                  stats: bool = False):
    """K6 → (o, m, l): the output and each row's max and sum [B, H, S]
    f32, which the backward reads; on the card m and l are None unless
    ``stats`` (the serving path writes none)."""
    if not uses_kernel(q):
        return _flash_forward_plain(q, k, v, bias, sm_scale)
    _check_qkv(q, k, v)
    b, h, s, d = q.shape
    q, k, v = (_rows16(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    out = _bhsd_out(q)
    m = l = None
    if stats:
        m, l = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
                for _ in range(2))
    bias, bias_ptr, bias_strides = _bias_arg(bias, q)
    strides = (ctypes.c_longlong * 16)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *bias_strides)
    if b and h and s:
        check(lib().cpt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(), strides, b, h, s, d,
            float(sm_scale), stream(q)), "cpt_flash_attention")
        flash_mha.launches += 1
    return out, m, l


def _bwd_args(q, k, v, bias, do, m, l, di, dq=None, dk=None, dv=None):
    """Validated kernel arguments and the strides array shared by K6b and
    K6c (q, k, v, do, dq, dk, dv, bias)."""
    _check_qkv(q, k, v, do)
    b, h, s, _ = q.shape
    q, k, v, do = (_rows16(t, n) for t, n in
                   ((q, "q"), (k, "k"), (v, "v"), (do, "do")))
    m, l, di = (require(t, n, torch.float32, (b, h, s))
                for t, n in ((m, "m"), (l, "l"), (di, "di")))
    bias, bias_ptr, bias_strides = _bias_arg(bias, q)
    strides = [st for t in (q, k, v, do, dq, dk, dv)
               for st in (t.stride()[:3] if t is not None else (0, 0, 0))]
    strides = (ctypes.c_longlong * 25)(*strides, *bias_strides)
    return (q, k, v, bias, do, m, l, di), bias_ptr, strides


def flash_mha_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: Optional[torch.Tensor], do: torch.Tensor,
                      m: torch.Tensor, l: torch.Tensor, di: torch.Tensor, *,
                      sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6b: (dk, dv) from the forward's row stats m, l [B, H, S] and
    ``di = Σ_d o·do``; [B, H, S, D] in the inputs' dtype."""
    if not uses_kernel(q):
        return flash_mha_bwd_dkv_plain(q, k, v, bias, do, m, l, di, sm_scale)
    dk, dv = _bhsd_out(q), _bhsd_out(q)
    keep, bias_ptr, strides = _bwd_args(q, k, v, bias, do, m, l, di, dk=dk, dv=dv)
    q, k, v, _, do, m, l, di = keep
    b, h, s, d = q.shape
    if b and h and s:
        check(lib().cpt_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, do.data_ptr(),
            m.data_ptr(), l.data_ptr(), di.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), strides, b, h, s, d, float(sm_scale), stream(q)),
            "cpt_flash_attention_bwd_dkv")
        flash_mha_bwd_dkv.launches += 1
    return dk, dv


def flash_mha_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor], do: torch.Tensor,
                     m: torch.Tensor, l: torch.Tensor, di: torch.Tensor, *,
                     sm_scale: float) -> torch.Tensor:
    """K6c: dq [B, H, S, D] from the same inputs as :func:`flash_mha_bwd_dkv`."""
    if not uses_kernel(q):
        return flash_mha_bwd_dq_plain(q, k, v, bias, do, m, l, di, sm_scale)
    dq = _bhsd_out(q)
    keep, bias_ptr, strides = _bwd_args(q, k, v, bias, do, m, l, di, dq=dq)
    q, k, v, _, do, m, l, di = keep
    b, h, s, d = q.shape
    if b and h and s:
        check(lib().cpt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, do.data_ptr(),
            m.data_ptr(), l.data_ptr(), di.data_ptr(), dq.data_ptr(), strides,
            b, h, s, d, float(sm_scale), stream(q)), "cpt_flash_attention_bwd_dq")
        flash_mha_bwd_dq.launches += 1
    return dq


class _FlashMHA(torch.autograd.Function):
    """The library's ``_flash_attention`` custom VJP: forward K6 with row
    stats, backward K6b + K6c."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale):
        o, m, l = flash_mha_fwd(q, k, v, bias, sm_scale=sm_scale, stats=True)
        ctx.save_for_backward(q, k, v, bias, o, m, l)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, m, l = ctx.saved_tensors
        if ctx.needs_input_grad[3]:
            raise NotImplementedError(
                "flash_mha: the bias gradient is not computed (the bias is a "
                "mask on every model path)")
        di = _row_dot(o, do)
        dk, dv = flash_mha_bwd_dkv(q, k, v, bias, do, m, l, di,
                                   sm_scale=ctx.sm_scale)
        dq = flash_mha_bwd_dq(q, k, v, bias, do, m, l, di, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *,
              sm_scale: float = 1.0) -> torch.Tensor:
    """q/k/v [B, H, S, D]; bias broadcastable to [B, H, S, S] additive.
    Returns [B, H, S, D] in ``q.dtype``, differentiable in q, k and v."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FlashMHA.apply(q, k, v, bias, sm_scale)
    return flash_mha_fwd(q, k, v, bias, sm_scale=sm_scale)[0]


flash_mha.launches = 0
flash_mha_bwd_dkv.launches = 0
flash_mha_bwd_dq.launches = 0
