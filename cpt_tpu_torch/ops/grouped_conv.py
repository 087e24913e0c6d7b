"""K1 — grouped 3×3 convolution with fused frozen-BN affine and ReLU (port
of ``cpt_tpu/ops/grouped_conv.py``).

``grouped_conv3x3`` covers both TPU kernels, ``grouped_conv3x3_sd`` (stride
1) and ``grouped_conv3x3`` (stride 1 or 2): on a Hopper card it launches
one of two kernels of ``csrc/grouped_conv.cu``, chosen by :func:`conv_path`
(the tensor-core implicit GEMM, ``"mma"``, or the CUDA-core direct sum,
``"simt"``); on the CPU it runs the plain version,
:func:`reference_grouped_conv3x3` (``F.conv2d(groups=G)`` then the affine
and ReLU in the input dtype, as the JAX XLA path computes them). The kernel
keeps the affine and ReLU in its f32 epilogue, so in bf16 the two agree to
bf16 tolerance.

K1q, ``grouped_conv3x3_int8``, is the same conv on int8 inputs for the W8A8
path (``ops/quant.py``: the JAX package runs it as an XLA int8 conv, so it
has no Pallas counterpart, and PyTorch has no int8 grouped conv on CUDA): on
a Hopper card it launches one of two kernels of the same source by the same
rule, :func:`conv_path` (the int8 tensor-core implicit GEMM on
``mma.sync`` m16n8k32, ``"mma"``, or the ``__dp4a`` CUDA-core kernel,
``"simt"``), exact int32 sums and an f32 epilogue; its plain version is
:func:`reference_grouped_conv3x3_int8`. Both compute the epilogue
``y·scale + bias`` as two roundings, so they agree bit for bit.

Layouts are the JAX package's: x NHWC, weights HWIO ``[3, 3, C//G, C]``.

Under autograd (an input that requires grad, grad mode on) K1 is a
``torch.autograd.Function`` whose forward is the same dispatch and whose
backward is the plain version's VJP (dx, dw, and dscale / dbias where the
affine is fused), as the JAX kernel's custom VJP is its XLA formulation's
(``cpt_tpu/ops/grouped_conv.py:130,523-540``): on the card the kernel runs
forward and cuDNN's grouped conv the backward. Without it a CUDA result
would carry no ``grad_fn`` and cut the backbone's gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cpt_tpu_torch.kernels.build import (aligned16, check, lib, require,
                                         stream, uses_kernel)
from cpt_tpu_torch.ops.fused_attention import plain_vjp


def reference_grouped_conv3x3(x: torch.Tensor, w33: torch.Tensor,
                              scale: Optional[torch.Tensor],
                              bias: Optional[torch.Tensor], groups: int,
                              stride: int = 1, relu: bool = False
                              ) -> torch.Tensor:
    """Plain PyTorch version with the JAX reference's semantics."""
    w_oihw = w33.to(x.dtype).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=stride, padding=1,
                 groups=groups).permute(0, 2, 3, 1)
    if scale is not None:
        y = y * scale.to(y.dtype) + bias.to(y.dtype)
    if relu:
        y = torch.relu(y)
    return y


MMA_CPG = (8, 16, 32, 64)


def conv_path(c: int, cpg: int) -> str:
    """The dispatch rule between K1's two kernels, and between K1q's: the
    tensor-core implicit GEMM (``"mma"``) takes every shape it can (cpg 8,
    16, 32 or 64, C a multiple of its 64-channel slice), which is every
    X152 shape; on the H100 it is 4-12× faster there than the CUDA-core
    kernel in bf16, and K1q's int8 one is 1.9-4.7× faster than its
    ``__dp4a`` kernel at those shapes (PERF.md §6).
    The CUDA-core kernel (``"simt"``) stays only because it is the one
    kernel for the rest (cpg 4, as in a ResNeXt 32×4d, or C not a multiple
    of 64, as in ``tiny_detector_config``; cpg a multiple of 4 that tiles
    128-channel slices), not because it wins at any shape."""
    return "mma" if cpg in MMA_CPG and c % 64 == 0 else "simt"


def grouped_conv3x3(x: torch.Tensor, w33: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, groups: int = 32,
                    stride: int = 1, relu: bool = False) -> torch.Tensor:
    """Grouped 3×3 conv, pad 1, stride 1 or 2, NHWC (+ optional fused affine
    and ReLU). x [N, H, W, C], w33 [3, 3, C//groups, C], scale/bias [C]."""
    args = [t for t in (x, w33, scale, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GroupedConv.apply(groups, stride, relu, x, w33, scale, bias)
    return _conv_forward(x, w33, scale, bias, groups, stride, relu)


class _GroupedConv(torch.autograd.Function):
    """K1 under autograd: the dispatch forward, the plain version's VJP
    backward (None for an absent affine)."""

    @staticmethod
    def forward(ctx, groups, stride, relu, x, w33, scale, bias):
        ctx.conv = (groups, stride, relu)
        ctx.affine = scale is not None
        ctx.save_for_backward(*[t for t in (x, w33, scale, bias)
                                if t is not None])
        return _conv_forward(x, w33, scale, bias, groups, stride, relu)

    @staticmethod
    def backward(ctx, g):
        groups, stride, relu = ctx.conv

        def plain(x, w33, scale=None, bias=None):
            return reference_grouped_conv3x3(x, w33, scale, bias, groups,
                                             stride, relu)

        n = 4 if ctx.affine else 2
        grads = plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[3:3 + n],
                          g)
        return (None, None, None) + grads + (None,) * (4 - n)


def _conv_forward(x, w33, scale, bias, groups, stride, relu) -> torch.Tensor:
    if not uses_kernel(x):
        return reference_grouped_conv3x3(x, w33, scale, bias, groups, stride,
                                         relu)
    c = x.shape[-1]
    return launch_grouped_conv3x3(conv_path(c, c // groups), x, w33, scale,
                                  bias, groups, stride, relu)


_ENTRY = {"mma": "cpt_grouped_conv3x3_mma", "simt": "cpt_grouped_conv3x3"}


def launch_grouped_conv3x3(path: str, x: torch.Tensor, w33: torch.Tensor,
                           scale: Optional[torch.Tensor],
                           bias: Optional[torch.Tensor], groups: int,
                           stride: int, relu: bool) -> torch.Tensor:
    """Launch K1's ``path`` kernel (``"mma"`` or ``"simt"``) on CUDA
    tensors. :func:`grouped_conv3x3` passes :func:`conv_path`'s choice;
    ``chip_smoke.py`` times the other path through this too. Each launch
    counts in ``grouped_conv3x3.launches`` and ``.path_launches[path]``."""
    n, h, w, c = x.shape
    cpg = c // groups
    cb = min(c, 128)
    if stride not in (1, 2) or c % groups:
        raise ValueError(f"grouped conv kernel takes stride 1|2 and C a "
                         f"multiple of groups; got C={c}, groups={groups}, "
                         f"stride={stride}")
    if path == "mma" and (cpg not in MMA_CPG or c % 64):
        raise ValueError(f"the tensor-core grouped conv takes cpg in "
                         f"{MMA_CPG} and C a multiple of 64; got C={c}, "
                         f"groups={groups}")
    if path == "simt" and (c % 8 or c % cb or cb % cpg or cpg % 4):
        raise ValueError(f"grouped conv kernel takes stride 1|2 and groups "
                         f"of a multiple of 4 channels that tile 128-channel "
                         f"slices; got C={c}, groups={groups}, stride={stride}")
    x = aligned16(require(x, "x", torch.bfloat16))
    w33 = aligned16(require(w33, "w33", torch.bfloat16, (3, 3, cpg, c)))
    if scale is None:
        scale = torch.ones(c, dtype=torch.float32, device=x.device)
        bias = torch.zeros(c, dtype=torch.float32, device=x.device)
    scale = require(scale.to(torch.float32), "scale", torch.float32, (c,))
    bias = require(bias.to(torch.float32), "bias", torch.float32, (c,))
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = torch.empty((n, ho, wo, c), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    entry = _ENTRY[path]
    check(getattr(lib(), entry)(x.data_ptr(), w33.data_ptr(),
                                scale.data_ptr(), bias.data_ptr(),
                                out.data_ptr(), n, h, w, c, cpg, stride,
                                int(relu), stream(x)), entry)
    grouped_conv3x3.launches += 1
    grouped_conv3x3.path_launches[path] += 1
    return out


grouped_conv3x3.launches = 0
grouped_conv3x3.path_launches = {"mma": 0, "simt": 0}


def exact_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int,
               padding: int, groups: int = 1) -> torch.Tensor:
    """xq int8 NHWC ⊛ wq int8 HWIO computed exactly (a float64 conv of the
    integer values: every product and partial sum is an integer below
    2^53), → f32 NHWC, the integer sum rounded to f32 once as an int32
    ``astype(float32)`` rounds it. cuDNN is kept out: its transform
    algorithms are not exact."""
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                     wq.permute(3, 2, 0, 1).double(), stride=stride,
                     padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1).float()


def reference_grouped_conv3x3_int8(xq: torch.Tensor, w33q: torch.Tensor,
                                   scale: torch.Tensor, bias: torch.Tensor,
                                   groups: int, stride: int = 1,
                                   relu: bool = False,
                                   out_dtype: torch.dtype = torch.bfloat16
                                   ) -> torch.Tensor:
    """Plain version of K1q: the exact grouped conv, then ``y·scale +
    bias`` in f32, ReLU, cast."""
    y = exact_conv(xq, w33q, stride, 1, groups) * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def grouped_conv3x3_int8(xq: torch.Tensor, w33q: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         groups: int = 32, stride: int = 1,
                         relu: bool = False,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """K1q: int8 grouped 3×3 conv, pad 1, stride 1 or 2, NHWC, with the
    f32 epilogue ``y·scale[c] + bias[c]`` (+ ReLU). xq int8 [N, H, W, C],
    w33q int8 [3, 3, C//groups, C]; scale f32 [C] is the whole dequant
    multiplier ``(s_x·s_w[c])·bn_scale[c]``, bias f32 [C]. The kernels
    write bf16."""
    if not uses_kernel(xq):
        return reference_grouped_conv3x3_int8(xq, w33q, scale, bias, groups,
                                              stride, relu, out_dtype)
    c = xq.shape[-1]
    if c % groups:
        raise ValueError(f"int8 grouped conv: C={c} is not a multiple of "
                         f"groups={groups}")
    return launch_grouped_conv3x3_int8(conv_path(c, c // groups), xq, w33q,
                                       scale, bias, groups, stride, relu,
                                       out_dtype)


_ENTRY_INT8 = {"mma": "cpt_grouped_conv3x3_int8_mma",
               "simt": "cpt_grouped_conv3x3_int8"}


def launch_grouped_conv3x3_int8(path: str, xq: torch.Tensor,
                                w33q: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, groups: int, stride: int,
                                relu: bool,
                                out_dtype: torch.dtype = torch.bfloat16
                                ) -> torch.Tensor:
    """Launch K1q's ``path`` kernel (``"mma"``, the int8 tensor-core
    implicit GEMM, or ``"simt"``, the ``__dp4a`` kernel) on CUDA tensors.
    :func:`grouped_conv3x3_int8` passes :func:`conv_path`'s choice;
    ``chip_e2e.py`` times the other path through this too. Each launch
    counts in ``grouped_conv3x3_int8.launches`` and ``.path_launches``."""
    n, h, w, c = xq.shape
    cpg = c // groups
    cb = min(c, 128)
    if stride not in (1, 2) or c % groups:
        raise ValueError(f"int8 grouped conv kernel takes stride 1|2 and C a "
                         f"multiple of groups; got C={c}, groups={groups}, "
                         f"stride={stride}")
    if path == "mma" and (cpg not in MMA_CPG or c % 64):
        raise ValueError(f"the int8 tensor-core grouped conv takes cpg in "
                         f"{MMA_CPG} and C a multiple of 64; got C={c}, "
                         f"groups={groups}")
    if path == "simt" and (c % 16 or c % cb or cb % cpg or cpg % 4):
        raise ValueError(f"int8 grouped conv kernel takes stride 1|2 and "
                         f"groups of a multiple of 4 channels that tile "
                         f"128-channel slices of a multiple of 16; got C={c}, "
                         f"groups={groups}, stride={stride}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the int8 grouped conv kernel writes bf16, not "
                        f"{out_dtype}")
    xq = aligned16(require(xq, "xq", torch.int8))
    w33q = aligned16(require(w33q, "w33q", torch.int8, (3, 3, cpg, c)))
    scale = require(scale.float(), "scale", torch.float32, (c,))
    bias = require(bias.float(), "bias", torch.float32, (c,))
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = torch.empty((n, ho, wo, c), dtype=torch.bfloat16, device=xq.device)
    if out.numel() == 0:
        return out
    entry = _ENTRY_INT8[path]
    check(getattr(lib(), entry)(xq.data_ptr(), w33q.data_ptr(),
                                scale.data_ptr(), bias.data_ptr(),
                                out.data_ptr(), n, h, w, c, cpg, stride,
                                int(relu), stream(xq)), entry)
    grouped_conv3x3_int8.launches += 1
    grouped_conv3x3_int8.path_launches[path] += 1
    return out


grouped_conv3x3_int8.launches = 0
grouped_conv3x3_int8.path_launches = {"mma": 0, "simt": 0}
