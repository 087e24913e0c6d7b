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

``BackboneConfig.precision`` picks the conv body's arithmetic, as in the JAX
package: ``"bf16"`` (the model dtype), or W8A8 int8 (``"int8"``, dynamic
per-tensor activation scales; ``"int8:<s>"``, the scale pinned to s) through
``ops/quant.py``: the grouped 3×3 on kernel K1q, the dense convs through
``torch._int_mm``. An int8 conv quantizes its weight once, per output
channel, from the tensor its state dict is loaded from (the f32 reference
weights; never the model-dtype copy, whose rounding would move amax/127),
and keeps the int8 weight and its f32 scales beside the unchanged
parameter: the state dict's keys are the bf16 model's.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.models.detector.config import BackboneConfig
from cpt_tpu_torch.ops.grouped_conv import grouped_conv3x3
from cpt_tpu_torch.ops.quant import (QuantTensor, int8_conv, is_int8,
                                     quant_act, quant_weight, static_scale)


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


class _Quantized(nn.Module):
    """A conv weight that, when ``quantized``, also holds its int8 copy and
    per-output-channel scales (non-persistent buffers), quantized from the
    state dict's own tensor at load. ``_to_hwio`` maps the parameter's
    layout to HWIO; ``_store`` is the int8 buffer's layout (a permutation
    of HWIO that :attr:`qweight` undoes)."""

    _to_hwio = (0, 1, 2, 3)
    _store = (0, 1, 2, 3)

    def _init_quant(self, quantized: bool) -> None:
        if quantized:
            hwio = tuple(self.weight.shape[i] for i in self._to_hwio)
            self.register_buffer("qdata", torch.zeros(
                [hwio[i] for i in self._store], dtype=torch.int8),
                persistent=False)
            self.register_buffer("qscale", torch.ones(hwio[3]),
                                 persistent=False)
        else:
            self.qdata = None

    def _load_from_state_dict(self, state_dict, prefix, *args):
        super()._load_from_state_dict(state_dict, prefix, *args)
        w = state_dict.get(prefix + "weight")
        if self.qdata is not None and w is not None:
            q = quant_weight(w.permute(*self._to_hwio), (0, 1, 2))
            with torch.no_grad():
                self.qdata.copy_(q.data.permute(*self._store))
                self.qscale.copy_(q.scale)

    @property
    def qweight(self) -> QuantTensor:
        """The int8 HWIO weight (a view of the stored layout) and its scales."""
        inverse = [self._store.index(i) for i in range(4)]
        return QuantTensor(self.qdata.permute(*inverse), self.qscale)


class Conv2d(_Quantized):
    """Bias-free NHWC convolution with an OIHW weight. Quantized, its int8
    weight is stored OHWI, so that the HWIO view flattens to the
    column-major [K, Cout] operand ``torch._int_mm`` takes."""

    _to_hwio = (2, 3, 1, 0)
    _store = (3, 0, 1, 2)

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, quantized: bool = False):
        super().__init__()
        self.weight = _frozen(cout, cin, kernel, kernel, dtype=dtype)
        self.stride = stride
        self.padding = (kernel - 1) // 2
        self._init_quant(quantized)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, stride=self.stride,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)

    def int8(self, qx: QuantTensor, bn: "FrozenBN", relu: bool,
             out_dtype: torch.dtype) -> torch.Tensor:
        """The conv on a quantized input, with the dequant, ``bn`` and ReLU
        in its epilogue."""
        return int8_conv(qx, self.qweight, self.stride, self.padding, 1,
                         bn.scale, bn.bias, relu, out_dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC activations: an f32 OIHW ``weight`` and, with
    ``bias``, an f32 ``bias``, both cast to ``dtype`` at use, as the input is.
    ``padding`` is an int (each side) or ``"SAME"`` (flax's default: the
    output is ``ceil(size / stride)``, the lower side taking the smaller
    half of the padding). The library modules' convs (FPN, the extra
    heads, FBNet, MsViT) are these; the VinVL body keeps :class:`Conv2d`."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding="SAME", dilation: int = 1, groups: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dilation, self.groups, self.dtype = dilation, groups, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        pad = self.padding
        if pad == "SAME":
            k = self.dilation * (self.kernel - 1) + 1
            sides = []
            for size in (x.shape[3], x.shape[2]):
                total = max((-(-size // self.stride) - 1) * self.stride + k
                            - size, 0)
                sides += [total // 2, total - total // 2]
            x, pad = F.pad(x, sides), 0
        y = F.conv2d(x, self.weight.to(dt),
                     None if self.bias is None else self.bias.to(dt),
                     self.stride, pad, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class GroupedConv3x3(_Quantized):
    """Grouped 3×3 weight in HWIO ``[3, 3, C//groups, C]`` (no forward of its
    own: the bottleneck calls K1, or K1q on its int8 copy, with it and the
    following BN pair)."""

    def __init__(self, channels: int, groups: int,
                 dtype: torch.dtype = torch.float32, quantized: bool = False):
        super().__init__()
        self.weight = _frozen(3, 3, channels // groups, channels, dtype=dtype)
        self._init_quant(quantized)


class Bottleneck(nn.Module):
    """1×1 → grouped 3×3 (stride here) → 1×1, residual add, relu."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, num_groups: int, stride: int,
                 stride_in_1x1: bool, dtype: torch.dtype = torch.float32,
                 precision: str = "bf16"):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        q = self.quantized = is_int8(precision)
        self.act_scale = static_scale(precision)
        self.num_groups = num_groups
        self.stride3 = s3
        if in_channels != out_channels:
            self.downsample_conv = Conv2d(in_channels, out_channels, 1, stride,
                                          dtype, q)
            self.downsample_bn = FrozenBN(out_channels)
        else:
            self.downsample_conv = None
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, s1, dtype, q)
        self.bn1 = FrozenBN(bottleneck_channels)
        self.conv2 = GroupedConv3x3(bottleneck_channels, num_groups, dtype, q)
        self.bn2 = FrozenBN(bottleneck_channels)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, 1, dtype, q)
        self.bn3 = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantized:
            return self._int8(x)
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        out = torch.relu(self.bn1(self.conv1(x)))
        out = grouped_conv3x3(out.contiguous(), self.conv2.weight,
                              self.bn2.scale, self.bn2.bias, self.num_groups,
                              self.stride3, relu=True)
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)

    def _int8(self, x: torch.Tensor) -> torch.Tensor:
        """W8A8 (JAX ``Bottleneck._int8``): x quantized once for conv1 and
        the downsample; the identity of a block without one is x itself;
        the residual add and the last ReLU stay in x's dtype."""
        sc, dt = self.act_scale, x.dtype
        qx = quant_act(x, sc)
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_conv.int8(qx, self.downsample_bn,
                                                 False, dt)
        out = self.conv1.int8(qx, self.bn1, True, dt)
        out = int8_conv(quant_act(out, sc), self.conv2.qweight, self.stride3,
                        1, self.num_groups, self.bn2.scale, self.bn2.bias,
                        True, dt)
        out = self.conv3.int8(quant_act(out, sc), self.bn3, False, dt)
        return torch.relu(out + identity)


class Stem(nn.Module):
    def __init__(self, out_channels: int, dtype: torch.dtype = torch.float32,
                 precision: str = "bf16"):
        super().__init__()
        self.quantized = is_int8(precision)
        self.act_scale = static_scale(precision)
        self.conv1 = Conv2d(3, out_channels, 7, 2, dtype, self.quantized)
        self.bn1 = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantized:
            x = self.conv1.int8(quant_act(x, self.act_scale), self.bn1, True,
                                x.dtype)
        else:
            x = torch.relu(self.bn1(self.conv1(x)))
        # 3×3/2 maxpool, pad 1 with -inf (torch's max_pool2d padding)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
        return x.permute(0, 2, 3, 1)


class Stage(nn.Sequential):
    """One stage's bottlenecks, run in order."""

    def apply_block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Block ``i`` alone: the cascaded windowed extractor
        (``engine/windowed.py``) runs single blocks on dirty-region windows."""
        return self[i](x)


def make_stage(block_count: int, in_channels: int, bottleneck_channels: int,
               out_channels: int, num_groups: int, first_stride: int,
               stride_in_1x1: bool, dtype: torch.dtype,
               precision: str = "bf16") -> Stage:
    """Blocks named ``block_{i}`` like the JAX parameter tree."""
    blocks = OrderedDict()
    for i in range(block_count):
        blocks[f"block_{i}"] = Bottleneck(
            in_channels if i == 0 else out_channels, bottleneck_channels,
            out_channels, num_groups, first_stride if i == 0 else 1,
            stride_in_1x1, dtype, precision)
    return Stage(blocks)


class ResNetC4(nn.Module):
    """Stem + layer1..layerN body; returns the C4 feature map (stride 16).

    ``up_to`` / ``from_stage`` split the body at a stage boundary for the
    two-level windowed extractor (``engine/windowed.py``): the early stages
    run per copy on a window, the later ones on the patched map.
    """

    def __init__(self, config: BackboneConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.stem = Stem(c.stem_out_channels, dtype, c.precision)
        cin = c.stem_out_channels
        self.stage_names = []
        for i, blocks in enumerate(c.stage_blocks):
            factor = 2 ** i
            name = f"layer{i + 1}"
            self.add_module(name, make_stage(
                blocks, cin, c.stage2_bottleneck_channels * factor,
                c.res2_out_channels * factor, c.num_groups,
                1 if i == 0 else 2, c.stride_in_1x1, dtype, c.precision))
            self.stage_names.append(name)
            cin = c.res2_out_channels * factor

    def stage(self, i: int) -> Stage:
        return getattr(self, self.stage_names[i])

    def up_to(self, x: torch.Tensor, n_stages: int) -> torch.Tensor:
        """Stem + the first ``n_stages`` stages (a stride 4·2^(n-1) map)."""
        x = self.stem(x)
        for name in self.stage_names[:n_stages]:
            x = getattr(self, name)(x)
        return x

    def from_stage(self, x: torch.Tensor, n_stages: int) -> torch.Tensor:
        """The stages after ``up_to(x, n_stages)``."""
        for name in self.stage_names[n_stages:]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.from_stage(self.up_to(x, 0), 0)


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
            dtype, c.precision))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.stage_name)(x)
