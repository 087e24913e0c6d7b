"""Feature Pyramid Network backbone and multi-level RoI pooling (port of
``cpt_tpu/models/detector/fpn.py``).

The reference's FPN builders (``modeling/backbone/fpn.py``,
``backbone.py:build_resnet_fpn_backbone``) and its multi-level ``Pooler`` /
``LevelMapper`` (``poolers.py:10-43,95-120``):

* lateral 1×1 convs on C2..C5, top-down bilinear upsampling with half-pixel
  centres (``F.interpolate(mode="bilinear", align_corners=False)``, which is
  what ``jax.image.resize(method="linear")`` computes when it enlarges), 3×3
  output convs, and P6 as the stride-2 subsample of P5 (``LastLevelMaxPool``:
  a 1×1 max-pool of stride 2, ``ceil(H / 2)`` rows);
* the level of a RoI, ``⌊4 + log2(√area / 224)⌋`` clamped to the pyramid.

:class:`ResNetFPN` is built on the port's own ``Stem`` and ``make_stage``,
so every grouped 3×3 of its body runs kernel K1 as in ``ResNetC4``;
:func:`multilevel_roi_align` pools every level through kernel K2
(``ops/roi_align_pallas.batched_roi_align``, one map), where the JAX
function calls XLA's ``roi_align``. Not used by the VinVL C4 config: the
reference's R-*-FPN model family. NHWC throughout.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.models.detector.config import BackboneConfig
from cpt_tpu_torch.models.detector.resnet import Conv, Stem, make_stage
from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align
from cpt_tpu_torch.structures.boxes import box_area


def upsample_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC ``x`` enlarged to ``h × w`` with half-pixel centres
    (``jax.image.resize(method="linear")`` on an enlargement)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


class FPNTopDown(nn.Module):
    """The FPN top-down module alone (``fpn.py:8-77``): lateral 1×1s,
    bilinear upsample-and-add, 3×3 output convs, P6. Takes the C2..C5 list
    (``in_channels`` their widths)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 with_p6: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(in_channels)
        self.with_p6 = with_p6
        for i, c in enumerate(in_channels):
            self.add_module(f"fpn_inner{i + 1}",
                            Conv(c, out_channels, 1, dtype=dtype))
            self.add_module(f"fpn_layer{i + 1}",
                            Conv(out_channels, out_channels, 3, padding=1,
                                 dtype=dtype))

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"fpn_inner{i + 1}")(f)
                    for i, f in enumerate(features)]
        outs: List[torch.Tensor] = [None] * self.n
        last = laterals[-1]
        outs[-1] = getattr(self, f"fpn_layer{self.n}")(last)
        for i in range(self.n - 2, -1, -1):
            h, w = laterals[i].shape[1:3]
            last = laterals[i] + upsample_bilinear(last, h, w)
            outs[i] = getattr(self, f"fpn_layer{i + 1}")(last)
        if self.with_p6:
            outs.append(outs[-1][:, ::2, ::2])
        return outs


class ResNetFPN(nn.Module):
    """ResNet body returning C2..C5, then the pyramid P2..P6. The body's
    weights live in ``dtype`` like ``ResNetC4``'s, the FPN's in f32, cast
    at use."""

    def __init__(self, config: BackboneConfig, out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.stem = Stem(c.stem_out_channels, dtype)
        cin, widths = c.stem_out_channels, []
        self.stage_names = []
        for i, blocks in enumerate(c.stage_blocks):
            factor = 2 ** i
            name = f"layer{i + 1}"
            self.add_module(name, make_stage(
                blocks, cin, c.stage2_bottleneck_channels * factor,
                c.res2_out_channels * factor, c.num_groups,
                1 if i == 0 else 2, c.stride_in_1x1, dtype))
            self.stage_names.append(name)
            cin = c.res2_out_channels * factor
            widths.append(cin)
        self.fpn = FPNTopDown(widths, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        features = []
        for name in self.stage_names:
            x = getattr(self, name)(x)
            features.append(x)
        return self.fpn(features)


def fpn_level_map(boxes: torch.Tensor, *, k_min: int = 2, k_max: int = 5,
                  canonical_scale: int = 224, canonical_level: int = 4
                  ) -> torch.Tensor:
    """LevelMapper (``poolers.py:10-43``): each RoI's level index, from 0."""
    s = torch.sqrt(box_area(boxes))
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale + 1e-6))
    return torch.clamp(lvl, k_min, k_max).to(torch.int64) - k_min


def multilevel_roi_align(pyramid: Sequence[torch.Tensor], boxes: torch.Tensor,
                         *, scales: Sequence[float], pooled: int = 7,
                         sampling: int = 2) -> torch.Tensor:
    """pyramid levels [H_l, W_l, C] · boxes [N, 4] → [N, pooled, pooled, C]:
    every level pools every RoI (one K2 launch a level, as the JAX function
    pools every level), then each RoI takes its own level's result. A
    gather by level stands for the JAX one-hot einsum, which it equals."""
    levels = fpn_level_map(boxes, k_min=2, k_max=2 + len(scales) - 1)
    per_level = torch.stack([
        batched_roi_align(feat[None], boxes, scale, pooled, sampling, 8)[0]
        for feat, scale in zip(pyramid, scales)])          # [L, N, P, P, C]
    return per_level[levels, torch.arange(boxes.shape[0],
                                          device=boxes.device)]
