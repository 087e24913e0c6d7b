"""K1 — grouped 3×3 convolution with fused frozen-BN affine and ReLU (port
of ``cpt_tpu/ops/grouped_conv.py``).

``grouped_conv3x3`` covers both TPU kernels, ``grouped_conv3x3_sd`` (stride
1) and ``grouped_conv3x3`` (stride 1 or 2): on a Hopper card it launches
``csrc/grouped_conv.cu``; on the CPU it runs the plain version,
:func:`reference_grouped_conv3x3` (``F.conv2d(groups=G)`` then the affine
and ReLU in the input dtype, as the JAX XLA path computes them). The kernel
keeps the affine and ReLU in its f32 epilogue, so in bf16 the two agree to
bf16 tolerance.

Layouts are the JAX package's: x NHWC, weights HWIO ``[3, 3, C//G, C]``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cpt_tpu_torch.kernels.build import (aligned16, check, lib, require,
                                         stream, uses_kernel)


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


def grouped_conv3x3(x: torch.Tensor, w33: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, groups: int = 32,
                    stride: int = 1, relu: bool = False) -> torch.Tensor:
    """Grouped 3×3 conv, pad 1, stride 1 or 2, NHWC (+ optional fused affine
    and ReLU). x [N, H, W, C], w33 [3, 3, C//groups, C], scale/bias [C]."""
    if not uses_kernel(x):
        return reference_grouped_conv3x3(x, w33, scale, bias, groups, stride,
                                         relu)
    n, h, w, c = x.shape
    cpg = c // groups
    cb = min(c, 128)
    if (stride not in (1, 2) or c % groups or c % 8 or c % cb or cb % cpg
            or cpg % 4):
        raise ValueError(f"grouped conv kernel takes stride 1|2 and groups "
                         f"of a multiple of 4 channels that tile 128-channel "
                         f"slices; got C={c}, groups={groups}, stride={stride}")
    x = aligned16(require(x, "x", torch.bfloat16))
    w33 = require(w33, "w33", torch.bfloat16, (3, 3, cpg, c))
    if scale is None:
        scale = torch.ones(c, dtype=torch.float32, device=x.device)
        bias = torch.zeros(c, dtype=torch.float32, device=x.device)
    scale = require(scale.to(torch.float32), "scale", torch.float32, (c,))
    bias = require(bias.to(torch.float32), "bias", torch.float32, (c,))
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = torch.empty((n, ho, wo, c), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    check(lib().cpt_grouped_conv3x3(x.data_ptr(), w33.data_ptr(),
                                    scale.data_ptr(), bias.data_ptr(),
                                    out.data_ptr(), n, h, w, c, cpg, stride,
                                    int(relu), stream(x)),
          "cpt_grouped_conv3x3")
    grouped_conv3x3.launches += 1
    return out


grouped_conv3x3.launches = 0
