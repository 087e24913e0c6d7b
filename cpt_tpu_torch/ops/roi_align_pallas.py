"""K2 — batched RoIAlign (port of ``cpt_tpu/ops/roi_align_pallas.py``).

``batched_roi_align`` pools one shared RoI set over a batch of feature maps.
On a Hopper card it launches the direct bilinear-gather kernel
``csrc/roi_align.cu`` (which replaces the TPU's ``_pool_kernel``); on the
CPU it runs the plain separable version, :func:`batched_roi_align_plain`.
The kernel accumulates in f32 straight through, while the plain version
rounds its intermediate to the feature dtype (as the JAX path does), so the
two agree to bf16 tolerance in bf16.
"""
from __future__ import annotations

import torch

from cpt_tpu_torch.kernels.build import (aligned16, check, lib, require,
                                         stream, uses_kernel)
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
