"""RoIAlign as separable interpolation contractions (port of
``cpt_tpu/ops/roi_align.py``) — the plain PyTorch version of kernel K2.

With sample points ``y(p, s) = y0 + (p + (s + .5) / S) · bin_h`` the pooled
value is ``out[p, q, c] = Σ_h Σ_w Ry[p, h] · Rx[q, w] · f[h, w, c]``, where
``Ry[p, h] = (1/S) Σ_s w_bilin(y(p, s), h)`` folds the in-bin average over
the S×S sample grid. Legacy maskrcnn semantics (``aligned=False``): samples
outside ``[-1, size]`` weigh 0, the rest clamp to ``[0, size-1]``; the
adaptive grid (``sampling == 0``) is ``ceil(bin)`` per axis capped at
``max_sampling``. As in the JAX path, the intermediate of the two
contractions is rounded to the feature dtype.
"""
from __future__ import annotations

from typing import Union

import torch


def _interp_matrix(starts: torch.Tensor, bin_sizes: torch.Tensor, size: int,
                   pooled: int, sampling: Union[int, torch.Tensor],
                   dtype: torch.dtype, max_sampling: int = 8) -> torch.Tensor:
    """R[n, pooled, size]: folded bilinear + average interpolation rows.

    ``sampling``: a fixed int grid, or a per-RoI [N] int tensor (the
    adaptive grid, realised with a masked ``max_sampling`` grid)."""
    n = starts.shape[0]
    dev = starts.device
    f32 = torch.float32
    adaptive = isinstance(sampling, torch.Tensor)
    smax = max_sampling if adaptive else sampling
    if adaptive:
        s_n = sampling.to(f32)[:, None, None]                        # [N,1,1]
    else:
        s_n = torch.full((n, 1, 1), float(sampling), dtype=f32, device=dev)
    p_idx = torch.arange(pooled, dtype=f32, device=dev)[None, :, None]
    s_idx = torch.arange(smax, dtype=f32, device=dev)[None, None, :]
    offs = p_idx + (s_idx + 0.5) / s_n                               # [N,P,S]
    pos = starts[:, None, None] + offs * bin_sizes[:, None, None]
    live = s_idx < s_n

    in_range = (pos >= -1.0) & (pos <= size) & live
    pos = pos.clamp(0.0, size - 1)
    low = torch.floor(pos)
    frac = pos - low
    low = low.to(torch.int64)
    high = (low + 1).clamp(max=size - 1)

    grid = torch.arange(size, device=dev)
    w_low = (1.0 - frac) * in_range
    w_high = frac * in_range
    rows = (w_low[..., None] * (grid == low[..., None])
            + w_high[..., None] * (grid == high[..., None]))         # [N,P,S,size]
    return (rows.sum(dim=2) / s_n).to(dtype)                         # [N,P,size]


def interp_matrices(rois: torch.Tensor, h: int, w: int, *,
                    spatial_scale: float, pooled: int, sampling: int,
                    max_sampling: int = 8, dtype: torch.dtype = torch.float32):
    """Separable interpolation matrices (Ry [N, P, H], Rx [N, P, W])."""
    rois = rois.to(torch.float32)
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    x2 = rois[:, 2] * spatial_scale
    y2 = rois[:, 3] * spatial_scale
    bin_w = torch.clamp(x2 - x1, min=1.0) / pooled
    bin_h = torch.clamp(y2 - y1, min=1.0) / pooled
    if sampling == 0:
        s_y = torch.clamp(torch.ceil(bin_h), 1, max_sampling).to(torch.int32)
        s_x = torch.clamp(torch.ceil(bin_w), 1, max_sampling).to(torch.int32)
    else:
        s_y = s_x = sampling
    ry = _interp_matrix(y1, bin_h, h, pooled, s_y, dtype, max_sampling)
    rx = _interp_matrix(x1, bin_w, w, pooled, s_x, dtype, max_sampling)
    return ry, rx


def separable_pool(features: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor,
                   contract: str = "auto") -> torch.Tensor:
    """features [..., H, W, C] · Ry [N, P, H] · Rx [N, P, W] →
    [..., N, P, P, C] in the feature dtype. Contracts the larger spatial dim
    first ("auto"), like the JAX path, and rounds the intermediate to the
    feature dtype between the two f32 contractions."""
    h, w = features.shape[-3:-1]
    dtype = features.dtype
    f = features.float()
    w_first = w > h if contract == "auto" else contract == "x"
    if w_first:
        t = torch.einsum("nqw,...hwc->...nqhc", rx.float(), f)
        out = torch.einsum("nph,...nqhc->...npqc", ry.float(),
                           t.to(dtype).float())
    else:
        t = torch.einsum("nph,...hwc->...npwc", ry.float(), f)
        out = torch.einsum("nqw,...npwc->...npqc", rx.float(),
                           t.to(dtype).float())
    return out.to(dtype)


def roi_align(features: torch.Tensor, rois: torch.Tensor, *,
              spatial_scale: float, pooled: int = 14, sampling: int = 2,
              max_sampling: int = 8, contract: str = "auto") -> torch.Tensor:
    """RoIAlign over one feature map: features [H, W, C] · rois [N, 4] xyxy
    in image coordinates → [N, pooled, pooled, C]."""
    h, w, _ = features.shape
    ry, rx = interp_matrices(rois, h, w, spatial_scale=spatial_scale,
                             pooled=pooled, sampling=sampling,
                             max_sampling=max_sampling, dtype=features.dtype)
    return separable_pool(features, ry, rx, contract)
