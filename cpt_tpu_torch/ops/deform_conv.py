"""Deformable convolution (DCN v1 / v2) and deformable RoI pooling (port of
``cpt_tpu/ops/deform_conv.py``).

The reference's ``deform_conv_cuda.cu`` / ``deform_pool_cuda.cu`` kernels
and the ``DFConv2d`` wrapper (``layers/misc.py:114-200``): per output
position and kernel tap the sample point is ``p·stride − pad + tap·dilation
+ offset``, with the offsets interleaved ``(dy, dx)`` per tap and the
padding fixed at ``dilation·(k − 1) // 2``; it is interpolated bilinearly
with zeros outside the map, optionally modulated (DCN v2, a sigmoid mask),
then contracted with the kernel. Plain PyTorch, as in the JAX package,
where it is four gathers and an einsum: one dense ``[B, Ho, Wo, K², C]``
tensor of samples, then one contraction. Unused by the VinVL config
(``STAGE_WITH_DCN`` all False).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cpt_tpu_torch.models.bert.model import Dense
from cpt_tpu_torch.models.detector.resnet import Conv


def _bilinear_gather(take, h: int, w: int, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """The bilinear samples at float coordinates ys / xs [...] of an
    ``h × w`` map → [..., C], zero outside the map (the CUDA kernels'
    border rule). ``take(idx)`` reads the map's flattened pixels ``idx``
    [...] → [..., C]."""
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)

    def corner(yc, xc, wgt):
        inb = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        vals = take(yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1))
        return vals * (wgt * inb)[..., None]

    return (corner(y0i, x0i, (1 - fy) * (1 - fx))
            + corner(y0i, x0i + 1, (1 - fy) * fx)
            + corner(y0i + 1, x0i, fy * (1 - fx))
            + corner(y0i + 1, x0i + 1, fy * fx))


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                  stride: int = 1, dilation: int = 1,
                  deformable_groups: int = 1,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, H, W, C] · offsets [B, Ho, Wo, DG·K²·2] ((dy, dx) per tap) ·
    weight [kh, kw, C, Cout] · mask [B, Ho, Wo, DG·K²] (already a sigmoid)
    → [B, Ho, Wo, Cout]."""
    b, h, w, c = x.shape
    kh, kw, _, cout = weight.shape
    k2 = kh * kw
    pad = dilation * (kh - 1) // 2
    ho, wo = offsets.shape[1], offsets.shape[2]
    dg = deformable_groups
    assert c % dg == 0
    dev, f32 = x.device, torch.float32
    base_y = (torch.arange(ho, device=dev) * stride - pad).to(f32)
    base_x = (torch.arange(wo, device=dev) * stride - pad).to(f32)
    tap_y = (torch.arange(kh, device=dev) * dilation).to(f32)
    tap_x = (torch.arange(kw, device=dev) * dilation).to(f32)
    gy = (base_y[:, None, None] + tap_y.repeat_interleave(kw)[None, None, :]
          ) * torch.ones((1, wo, 1), device=dev)
    gx = (base_x[None, :, None] + tap_x.repeat(kh)[None, None, :]
          ) * torch.ones((ho, 1, 1), device=dev)
    off = offsets.reshape(b, ho, wo, dg, k2, 2)
    ys = gy[None, :, :, None, :] + off[..., 0]               # [B,Ho,Wo,DG,K2]
    xs = gx[None, :, :, None, :] + off[..., 1]
    flat = x.reshape(b, h * w, dg, c // dg)
    image = torch.arange(b, device=dev).view(b, 1, 1, 1, 1)
    group = torch.arange(dg, device=dev).view(1, 1, 1, dg, 1)
    sampled = _bilinear_gather(lambda idx: flat[image, idx, group], h, w,
                               ys, xs)                       # [B,Ho,Wo,DG,K2,C/DG]
    if mask is not None:
        sampled = sampled * mask.reshape(b, ho, wo, dg, k2)[..., None]
    # the JAX function's plain reshape of [DG, K², C/DG] to [K², C]: with
    # DG > 1 it pairs samples and weights in another order than the
    # reference's (kept, as the JAX package computes it)
    sampled = sampled.reshape(b, ho, wo, k2, c)
    # the samples are f32 (the sample weights are); the product promotes
    # the kernel to them, as jnp.einsum does
    out = torch.einsum("bhwkc,kco->bhwo", sampled,
                       weight.reshape(k2, c, cout).to(sampled.dtype))
    if bias is not None:
        out = out + bias
    return out


def deform_roi_pool(features: torch.Tensor, rois: torch.Tensor,
                    offsets: Optional[torch.Tensor], *, spatial_scale: float,
                    out_size: int, sample_per_part: int = 4,
                    trans_std: float = 0.1) -> torch.Tensor:
    """Deformable RoI pooling (``deform_pool_cuda.cu``;
    ``layers/dcn/deform_pool_module.py``): features [H, W, C] · rois [N, 4]
    xyxy · offsets [N, P, P, 2] (normalised (dy, dx) per bin, scaled by
    ``trans_std`` and the RoI's extent; None: no shift) → [N, P, P, C],
    each bin the mean of an S×S grid of bilinear samples."""
    n = rois.shape[0]
    p, s = out_size, sample_per_part
    dev = features.device
    rois = rois.float()
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    roi_w = torch.clamp((rois[:, 2] - rois[:, 0]) * spatial_scale, min=0.1)
    roi_h = torch.clamp((rois[:, 3] - rois[:, 1]) * spatial_scale, min=0.1)
    bin_w, bin_h = roi_w / p, roi_h / p
    bi = torch.arange(p, dtype=torch.float32, device=dev)
    si = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    ys = ((y1[:, None] + bi[None, :] * bin_h[:, None])[:, :, None, None, None]
          + (si[None, :] * bin_h[:, None])[:, None, None, :, None])
    xs = ((x1[:, None] + bi[None, :] * bin_w[:, None])[:, None, :, None, None]
          + (si[None, :] * bin_w[:, None])[:, None, None, None, :])
    ys = ys.expand(n, p, p, s, s)
    xs = xs.expand(n, p, p, s, s)
    if offsets is not None:
        dy = offsets[..., 0] * trans_std * roi_h[:, None, None]
        dx = offsets[..., 1] * trans_std * roi_w[:, None, None]
        ys = ys + dy[..., None, None]
        xs = xs + dx[..., None, None]
    h, w, c = features.shape
    flat = features.reshape(h * w, c)
    return _bilinear_gather(lambda idx: flat[idx], h, w, ys, xs).mean(dim=(3, 4))


class ModulatedDeformRoIPoolingPack(nn.Module):
    """``ModulatedDeformRoIPoolingPack`` (``deform_pool_module.py:89-150``):
    a pass without offsets feeds FC branches that predict each bin's
    offset and a sigmoid mask; the deformable pass applies both."""

    def __init__(self, channels: int, out_size: int = 7,
                 spatial_scale: float = 1.0 / 16, sample_per_part: int = 4,
                 trans_std: float = 0.1, deform_fc_channels: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_size, self.spatial_scale = out_size, spatial_scale
        self.sample_per_part, self.trans_std = sample_per_part, trans_std
        fin, d, p = out_size * out_size * channels, deform_fc_channels, out_size
        self.offset_fc1 = Dense(fin, d, dtype)
        self.offset_fc2 = Dense(d, d, dtype)
        self.offset_fc3 = Dense(d, p * p * 2, dtype)
        self.mask_fc1 = Dense(fin, d, dtype)
        self.mask_fc2 = Dense(d, p * p, dtype)

    def forward(self, features: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        p = self.out_size
        base = deform_roi_pool(features, rois, None,
                               spatial_scale=self.spatial_scale, out_size=p,
                               sample_per_part=self.sample_per_part)
        n = base.shape[0]
        flat = base.reshape(n, -1)
        hid = torch.relu(self.offset_fc2(torch.relu(self.offset_fc1(flat))))
        offsets = self.offset_fc3(hid).reshape(n, p, p, 2)
        mask = torch.sigmoid(self.mask_fc2(torch.relu(self.mask_fc1(flat))))
        out = deform_roi_pool(features, rois, offsets,
                              spatial_scale=self.spatial_scale, out_size=p,
                              sample_per_part=self.sample_per_part,
                              trans_std=self.trans_std)
        return out * mask.reshape(n, p, p, 1)


class DFConv2d(nn.Module):
    """Offset-predicting conv + deformable conv (``layers/misc.py:114-200``).
    ``with_modulated_dcn``: DCN v2 (the offset conv emits DG·K²·3 channels,
    2·K² offsets then K² mask logits), else v1 (DG·K²·2). ``kernel`` is the
    deformable conv's weight in the flax layout [k, k, C, features]; flax
    starts the offset conv at zero, so the layer starts as a plain conv."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, deformable_groups: int = 1,
                 with_modulated_dcn: bool = True, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k2 = kernel_size ** 2
        per = 3 if with_modulated_dcn else 2
        pad = dilation * (kernel_size - 1) // 2
        self.offset = Conv(in_channels, deformable_groups * k2 * per,
                           kernel_size, stride, pad, dilation, dtype=dtype)
        self.kernel = nn.Parameter(torch.empty(kernel_size, kernel_size,
                                               in_channels, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.stride, self.dilation = stride, dilation
        self.deformable_groups, self.modulated = deformable_groups, with_modulated_dcn
        self.n_off = deformable_groups * k2 * 2
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        om = self.offset(x)
        offsets = om[..., :self.n_off]
        mask = torch.sigmoid(om[..., self.n_off:]) if self.modulated else None
        return deform_conv2d(x, offsets, self.kernel.to(dt), mask,
                             stride=self.stride, dilation=self.dilation,
                             deformable_groups=self.deformable_groups,
                             bias=None if self.bias is None else self.bias.to(dt))
