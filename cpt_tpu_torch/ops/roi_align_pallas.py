"""K2 — batched RoIAlign (port of ``cpt_tpu/ops/roi_align_pallas.py``).

``batched_roi_align`` pools one shared RoI set over a batch of feature maps.
On a Hopper card it launches ``csrc/roi_align.cu`` (which replaces the TPU's
``_pool_kernel``): one block per bin row of a RoI and channel slice folds
the RoI's sample weights per distinct row and column into tables once for
a group of copies, then each thread sums one bin's folded rows × columns of
the separable function for the copies in turn; on the CPU it runs the plain
separable version, :func:`batched_roi_align_plain`.
The kernel accumulates in f32 straight through, while the plain version
rounds its intermediate to the feature dtype (as the JAX path does), so the
two agree to bf16 tolerance in bf16.

Under autograd (``feats`` requires grad, grad mode on) K2 is a
``torch.autograd.Function``: the same dispatch forward, and the plain
version's VJP for ``feats`` backward; the RoIs get a zero gradient, as the
JAX kernel's custom VJP gives them (``cpt_tpu/ops/roi_align_pallas.py:
134-187``). Without it a CUDA result would carry no ``grad_fn`` and cut the
gradient into the C4 map.
"""
from __future__ import annotations

import torch

from cpt_tpu_torch.kernels.build import (aligned16, check, lib, require,
                                         stream, uses_kernel)
from cpt_tpu_torch.ops.fused_attention import plain_vjp
from cpt_tpu_torch.ops.roi_align import interp_matrices, separable_pool


def batched_roi_align_plain(feats: torch.Tensor, rois: torch.Tensor,
                            spatial_scale: float, pooled: int = 14,
                            sampling: int = 0, max_sampling: int = 8
                            ) -> torch.Tensor:
    """Plain PyTorch version: the separable contractions of
    ``ops/roi_align.py`` over every map of the batch."""
    _, h, w, _ = feats.shape
    ry, rx = interp_matrices(rois, h, w, spatial_scale=spatial_scale,
                             pooled=pooled, sampling=sampling,
                             max_sampling=max_sampling, dtype=feats.dtype)
    return separable_pool(feats, ry, rx)


def batched_roi_align(feats: torch.Tensor, rois: torch.Tensor,
                      spatial_scale: float, pooled: int = 14,
                      sampling: int = 0, max_sampling: int = 8
                      ) -> torch.Tensor:
    """feats [B, H, W, C] · rois [N, 4] xyxy → [B, N, pooled, pooled, C].

    ``sampling=0`` is the adaptive grid (``ceil(bin)`` capped at
    ``max_sampling``); ``sampling>0`` a fixed grid."""
    if torch.is_grad_enabled() and (feats.requires_grad or rois.requires_grad):
        return _BatchedRoIAlign.apply(feats, rois, spatial_scale, pooled,
                                      sampling, max_sampling)
    return _pool_forward(feats, rois, spatial_scale, pooled, sampling,
                         max_sampling)


class _BatchedRoIAlign(torch.autograd.Function):
    """K2 under autograd: the dispatch forward; backward, the plain
    version's VJP to ``feats`` and zeros to the RoIs."""

    @staticmethod
    def forward(ctx, feats, rois, spatial_scale, pooled, sampling,
                max_sampling):
        ctx.pool = (spatial_scale, pooled, sampling, max_sampling)
        ctx.save_for_backward(feats, rois)
        return _pool_forward(feats, rois, spatial_scale, pooled, sampling,
                             max_sampling)

    @staticmethod
    def backward(ctx, g):
        feats, rois = ctx.saved_tensors

        def plain(f):
            return batched_roi_align_plain(f, rois, *ctx.pool)

        (dfeats,) = plain_vjp(plain, (feats,), ctx.needs_input_grad[:1], g)
        drois = torch.zeros_like(rois) if ctx.needs_input_grad[1] else None
        return (dfeats, drois) + (None,) * 4


def _pool_forward(feats, rois, spatial_scale, pooled, sampling,
                  max_sampling) -> torch.Tensor:
    if not uses_kernel(feats):
        return batched_roi_align_plain(feats, rois, spatial_scale, pooled,
                                       sampling, max_sampling)
    b, h, w, c = feats.shape
    n = rois.shape[0]
    if c % 8:
        raise ValueError(f"RoIAlign kernel takes channels in multiples of 8, "
                         f"got {c}")
    feats = aligned16(require(feats, "feats", torch.bfloat16))
    rois = require(rois.to(torch.float32), "rois", torch.float32, (n, 4))
    out = torch.empty((b, n, pooled, pooled, c), dtype=torch.bfloat16,
                      device=feats.device)
    if out.numel() == 0:
        return out
    check(lib().cpt_roi_align(feats.data_ptr(), rois.data_ptr(),
                              out.data_ptr(), b, h, w, c, n, pooled,
                              float(spatial_scale), int(sampling),
                              int(max_sampling), stream(feats)),
          "cpt_roi_align")
    batched_roi_align.launches += 1
    return out


batched_roi_align.launches = 0
