"""FBNet mobile backbones (port of ``cpt_tpu/models/detector/fbnet.py``).

The reference's FBNet builder (``modeling/backbone/fbnet.py``,
``fbnet_builder.py``, ``fbnet_modeldef.py``): inverted-residual (IRF)
blocks with expansion t, a depthwise k×k, optional squeeze-excite and mid
channel shuffle, built from an arch definition {block_op_type,
block_cfg: {first, stages: [t, c, n, s]}}. The op names parse as
``ir_k{K}[_e{E}|_s4][_se]`` or ``skip``. NHWC; the depthwise convs are
``groups = C`` convs, as XLA's ``feature_group_count`` is in the JAX
package; BatchNorm is a frozen scale and bias (``*_scale``, ``*_bias``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from cpt_tpu_torch.models.bert.model import Dense
from cpt_tpu_torch.models.detector.resnet import Conv

# the reference's "default" arch (fbnet_modeldef.py:12-45), trunk stages 0-3
DEFAULT_ARCH: Dict[str, Any] = {
    "block_op_type": [["ir_k3"], ["ir_k3"] * 2, ["ir_k3"] * 3,
                      ["ir_k3"] * 7],
    "block_cfg": {
        "first": [32, 2],
        "stages": [
            [[1, 16, 1, 1]],
            [[6, 24, 2, 2]],
            [[6, 32, 3, 2]],
            [[6, 64, 4, 2], [6, 96, 3, 1]],
        ],
    },
}

_OP_RE = re.compile(r"^ir_k(\d+)(?:_e(\d+)|_s(4))?(_se)?$")


def parse_op(op: str, default_expansion: int) -> Dict[str, Any]:
    """'ir_k5_e3_se' → {kernel, expansion, shuffle, se} (PRIMITIVES)."""
    if op == "skip":
        return {"skip": True}
    m = _OP_RE.match(op)
    if not m:
        raise ValueError(f"unknown FBNet op {op!r}")
    k, e, s4, se = m.groups()
    return {"skip": False, "kernel": int(k),
            "expansion": int(e) if e else (4 if s4 else default_expansion),
            "shuffle": bool(s4), "se": bool(se)}


def _bn(module: nn.Module, name: str, channels: int) -> None:
    """Registers the frozen-BN pair ``{name}_scale`` / ``{name}_bias``."""
    module.register_parameter(f"{name}_scale",
                              nn.Parameter(torch.ones(channels)))
    module.register_parameter(f"{name}_bias",
                              nn.Parameter(torch.zeros(channels)))


def _apply_bn(module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    scale = getattr(module, f"{name}_scale").to(x.dtype)
    return x * scale + getattr(module, f"{name}_bias").to(x.dtype)


class IRFBlock(nn.Module):
    """Inverted residual (``fbnet_builder.py:445-560``): 1×1 expand →
    depthwise k×k (stride) [→ SE] → 1×1 project; the residual when the
    stride is 1 and C_in == C_out."""

    def __init__(self, in_channels: int, out_channels: int,
                 expansion: int = 6, kernel: int = 3, stride: int = 1,
                 se: bool = False, shuffle: bool = False, pw_group: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_channels * expansion
        self.expansion, self.shuffle, self.se = expansion, shuffle, se
        self.pw_group = pw_group
        self.residual = stride == 1 and in_channels == out_channels
        groups = pw_group if shuffle else 1
        if expansion != 1:
            self.pw = Conv(in_channels, mid, 1, groups=groups, bias=False,
                           dtype=dtype)
            _bn(self, "pw_bn", mid)
        else:
            mid = in_channels
        pad = kernel // 2
        self.dw = Conv(mid, mid, kernel, stride, pad, groups=mid, bias=False,
                       dtype=dtype)
        _bn(self, "dw_bn", mid)
        if se:
            self.se_fc1 = Dense(mid, max(mid // 4, 1), dtype)
            self.se_fc2 = Dense(max(mid // 4, 1), mid, dtype)
        self.pwl = Conv(mid, out_channels, 1, groups=groups, bias=False,
                        dtype=dtype)
        _bn(self, "pwl_bn", out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expansion != 1:
            y = torch.relu(_apply_bn(self, "pw_bn", self.pw(y)))
        if self.shuffle:                       # mid channel shuffle
            b, h, w, c = y.shape
            y = y.reshape(b, h, w, self.pw_group, c // self.pw_group)
            y = y.transpose(3, 4).reshape(b, h, w, c)
        y = torch.relu(_apply_bn(self, "dw_bn", self.dw(y)))
        if self.se:
            s = torch.relu(self.se_fc1(y.mean(dim=(1, 2))))
            y = y * torch.sigmoid(self.se_fc2(s))[:, None, None, :]
        y = _apply_bn(self, "pwl_bn", self.pwl(y))
        return y + x if self.residual else y


class FBNetTrunk(nn.Module):
    """The first conv and the IRF stages of an arch def
    (``fbnet.py:26-70``) → the last stage's [B, H/s, W/s, C] map."""

    def __init__(self, arch: Dict[str, Any] = None, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        arch = arch or DEFAULT_ARCH
        first_c, first_s = arch["block_cfg"]["first"]
        self.first = Conv(in_channels, first_c, 3, first_s, 1, bias=False,
                          dtype=dtype)
        _bn(self, "first_bn", first_c)
        self.blocks: List[str] = []
        cin, idx = first_c, 0
        for si, (ops, cfgs) in enumerate(zip(arch["block_op_type"],
                                             arch["block_cfg"]["stages"])):
            blocks: List[Tuple[int, int, int]] = []
            for t, c, n, s in cfgs:
                for j in range(n):
                    blocks.append((t, c, s if j == 0 else 1))
            assert len(blocks) == len(ops), (
                f"stage {si}: {len(ops)} ops vs {len(blocks)} blocks")
            for op, (t, c, s) in zip(ops, blocks):
                p = parse_op(op, t)
                if p["skip"]:
                    if s != 1 or cin != c:
                        name = f"block{idx}_skip"
                        self.add_module(name, Conv(cin, c, 1, s, bias=False,
                                                   dtype=dtype))
                        self.blocks.append(name)
                else:
                    name = f"block{idx}"
                    self.add_module(name, IRFBlock(
                        cin, c, expansion=p["expansion"], kernel=p["kernel"],
                        stride=s, se=p["se"], shuffle=p["shuffle"],
                        dtype=dtype))
                    self.blocks.append(name)
                cin = c
                idx += 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(_apply_bn(self, "first_bn", self.first(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x
