"""ResNeXt C4 backbone + C5 RoI head stage, NHWC, frozen BN (port of
``cpt_tpu/models/detector/resnet.py``).

VinVL R-152-C4 ResNeXt 32×8d: frozen BN stored pre-folded as per-channel
``(scale, bias)``, the stride in the grouped 3×3 (``STRIDE_IN_1X1=False``),
stem = 7×7/2 conv + BN + relu + 3×3/2 maxpool. The grouped 3×3 + BN + relu
of every bottleneck runs through kernel K1 (``ops/grouped_conv.py``); the
dense 1×1 and stem convs stay ``F.conv2d``, as the JAX package leaves them
to XLA.

Activations are NHWC; dense conv weights are PyTorch OIHW, the grouped
weight is HWIO ``[3, 3, C//G, C]`` (the kernel's layout). Weights live in
the model dtype, the folded BN pairs in f32.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.models.detector.config import BackboneConfig
from cpt_tpu_torch.ops.grouped_conv import grouped_conv3x3


def _frozen(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


class FrozenBN(nn.Module):
    """Per-channel affine ``y = x·scale + bias`` (pre-folded frozen BN),
    computed in the activation dtype like the JAX module."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype) + self.bias.to(x.dtype)


class Conv2d(nn.Module):
    """Bias-free NHWC convolution with an OIHW weight."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = _frozen(cout, cin, kernel, kernel, dtype=dtype)
        self.stride = stride
        self.padding = (kernel - 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, stride=self.stride,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)


class GroupedConv3x3(nn.Module):
    """Grouped 3×3 weight in HWIO ``[3, 3, C//groups, C]`` (no forward of its
    own: the bottleneck calls K1 with it and the following BN pair)."""

    def __init__(self, channels: int, groups: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = _frozen(3, 3, channels // groups, channels, dtype=dtype)


class Bottleneck(nn.Module):
    """1×1 → grouped 3×3 (stride here) → 1×1, residual add, relu."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, num_groups: int, stride: int,
                 stride_in_1x1: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.num_groups = num_groups
        self.stride3 = s3
        if in_channels != out_channels:
            self.downsample_conv = Conv2d(in_channels, out_channels, 1, stride,
                                          dtype)
            self.downsample_bn = FrozenBN(out_channels)
        else:
            self.downsample_conv = None
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, s1, dtype)
        self.bn1 = FrozenBN(bottleneck_channels)
        self.conv2 = GroupedConv3x3(bottleneck_channels, num_groups, dtype)
        self.bn2 = FrozenBN(bottleneck_channels)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, 1, dtype)
        self.bn3 = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        out = torch.relu(self.bn1(self.conv1(x)))
        out = grouped_conv3x3(out.contiguous(), self.conv2.weight,
                              self.bn2.scale, self.bn2.bias, self.num_groups,
                              self.stride3, relu=True)
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


class Stem(nn.Module):
    def __init__(self, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, out_channels, 7, 2, dtype)
        self.bn1 = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        # 3×3/2 maxpool, pad 1 with -inf (torch's max_pool2d padding)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
        return x.permute(0, 2, 3, 1)


def make_stage(block_count: int, in_channels: int, bottleneck_channels: int,
               out_channels: int, num_groups: int, first_stride: int,
               stride_in_1x1: bool, dtype: torch.dtype) -> nn.Sequential:
    """Blocks named ``block_{i}`` like the JAX parameter tree."""
    blocks = OrderedDict()
    for i in range(block_count):
        blocks[f"block_{i}"] = Bottleneck(
            in_channels if i == 0 else out_channels, bottleneck_channels,
            out_channels, num_groups, first_stride if i == 0 else 1,
            stride_in_1x1, dtype)
    return nn.Sequential(blocks)


class ResNetC4(nn.Module):
    """Stem + layer1..layerN body; returns the C4 feature map (stride 16)."""

    def __init__(self, config: BackboneConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.stem = Stem(c.stem_out_channels, dtype)
        cin = c.stem_out_channels
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self.stage_names:
            x = getattr(self, name)(x)
        return x


class ResNetC5Head(nn.Module):
    """layer4 (stage-5) RoI feature head: 14×14 → 7×7, stride-2 first block
    (reference ``ResNet50Conv5ROIFeatureExtractor``)."""

    def __init__(self, config: BackboneConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        idx = len(c.stage_blocks)
        factor = 2 ** idx
        self.stage_name = f"layer{idx + 1}"
        self.add_module(self.stage_name, make_stage(
            c.head_blocks, c.res2_out_channels * factor // 2,
            c.stage2_bottleneck_channels * factor,
            c.res2_out_channels * factor, c.num_groups, 2, c.stride_in_1x1,
            dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.stage_name)(x)
