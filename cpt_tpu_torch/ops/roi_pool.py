"""RoIPool, the legacy max-pooling RoI extractor (port of
``cpt_tpu/ops/roi_pool.py``).

Semantics of the reference ``layers/roi_pool.py``: the RoI's corners are
scaled and rounded (half to even, as ``jnp.round`` and ``torch.round``
both round), its extent is ``x2 − x1 + 1`` (at least 1), bin ``i`` covers
the integer range ``[floor(i·h/P), ceil((i+1)·h/P))`` from the RoI's
corner, clipped to the map, and an empty bin is 0. Plain PyTorch, as the
JAX package computes it in XLA: a masked max over the map per bin.
"""
from __future__ import annotations

import torch


def roi_pool(features: torch.Tensor, rois: torch.Tensor, *,
             spatial_scale: float, pooled: int = 7) -> torch.Tensor:
    """features [H, W, C] · rois [N, 4] xyxy → [N, pooled, pooled, C]."""
    h, w, _ = features.shape
    dev = features.device
    r = torch.round(rois.float() * spatial_scale).to(torch.int64)
    x1, y1, x2, y2 = r.unbind(1)
    roi_w = torch.clamp(x2 - x1 + 1, min=1)
    roi_h = torch.clamp(y2 - y1 + 1, min=1)
    i = torch.arange(pooled, device=dev)

    def edges(start, extent, size):
        # [N, P] bin starts and ends, clipped to the map
        lo = start[:, None] + torch.div(i[None] * extent[:, None], pooled,
                                        rounding_mode="floor")
        hi = start[:, None] - torch.div(-(i[None] + 1) * extent[:, None],
                                        pooled, rounding_mode="floor")
        return lo.clamp(0, size), hi.clamp(0, size)

    hs, he = edges(y1, roi_h, h)
    ws, we = edges(x1, roi_w, w)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    in_y = (ys[None, None] >= hs[..., None]) & (ys[None, None] < he[..., None])
    in_x = (xs[None, None] >= ws[..., None]) & (xs[None, None] < we[..., None])
    # max over rows, then over columns, per bin: [N, P, W, C] → [N, P, P, C]
    neg = torch.tensor(float("-inf"), dtype=features.dtype, device=dev)
    rows = torch.where(in_y[..., None, None], features[None, None], neg
                       ).amax(dim=2)
    out = torch.where(in_x[:, None, :, :, None], rows[:, :, None], neg
                      ).amax(dim=3)
    empty = ~(in_y.any(-1)[:, :, None] & in_x.any(-1)[:, None, :])
    return torch.where(empty[..., None], torch.zeros((), dtype=features.dtype,
                                                     device=dev), out)
