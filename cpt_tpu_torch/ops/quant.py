"""W8A8 symmetric quantization for int8 inference (port of
``cpt_tpu/ops/quant.py``), and K7, the fused W8A8 BERT FFN (port of the
``ffn_int8`` Pallas kernel of ``bench_int8.py``'s FFN study).

The scheme is the JAX package's (post-training, inference only):

* weights: static, symmetric, per-output-channel scales ``amax/127`` over
  the reduction axes, quantized from the f32 parameters. The detector
  quantizes each conv weight once, from the f32 state dict it loads
  (``models/detector/resnet.py``), never from its bf16 copy;
* activations: a dynamic per-tensor scale (the abs-max of the whole
  tensor), or a pinned one (``precision="int8:<s>"``, :func:`static_scale`);
* int32 accumulation, then the f32 epilogue ``y·((s_x·s_w[c])·bn_scale[c])
  + bn_bias[c]``, ReLU, and a cast to the model dtype.

Where the int8 products run:

* on the CPU, the plain versions: exact integer arithmetic, a float64 conv
  or matmul of the int8 values (every product and partial sum is an
  integer below 2^53);
* on a Hopper card, the grouped 3×3 through kernel K1q
  (:func:`cpt_tpu_torch.ops.grouped_conv.grouped_conv3x3_int8`), and the
  dense convs (1×1; 1×1 with stride 2 after subsampling; the 7×7 stem as
  an im2col matrix with K padded from 147 to 152) and :func:`int8_matmul`
  through ``torch._int_mm`` (cuBLASLt, int8 × int8 → int32), where the JAX
  package leaves them to XLA. ``_int_mm`` takes M > 16 and K, N multiples
  of 8; any other shape raises.

Every quantization divides. A CUDA kernel that divides by a host scalar
multiplies by its reciprocal instead, which can move a scale by one ulp, so
the divisors here are tensors on the operand's device. (Under ``jax.jit``
XLA itself rewrites ``amax / 127`` into ``amax · (1/127)``; the port follows
the JAX source, which eager JAX computes.)
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from cpt_tpu_torch.kernels.build import (aligned16, check, lib, require,
                                         stream, uses_kernel)
from cpt_tpu_torch.ops.grouped_conv import exact_conv, grouped_conv3x3_int8

_EPS = 1e-8


def is_int8(precision: str) -> bool:
    """True for ``"int8"`` / ``"int8:<s>"``, False for ``"bf16"``; raises
    on anything else (the JAX package would quietly run bf16)."""
    if precision == "bf16":
        return False
    if precision == "int8" or precision.startswith("int8:"):
        return True
    raise ValueError(f"precision {precision!r}: expected bf16, int8 or "
                     f"int8:<scale>")


def static_scale(precision: str) -> Optional[float]:
    """``"int8:<s>"`` → the pinned activation scale s; ``"int8"`` → None
    (dynamic per-tensor scales)."""
    if ":" in precision:
        return float(precision.split(":", 1)[1])
    return None


class QuantTensor(NamedTuple):
    """int8 data and the f32 scale with ``data * scale ≈ original``."""

    data: torch.Tensor    # int8
    scale: torch.Tensor   # f32; 0-d (per tensor) or [C] (per channel)


def _over(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` as a true division on x's device."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quant_act(x: torch.Tensor,
              scale: Union[None, float, torch.Tensor] = None) -> QuantTensor:
    """Per-tensor symmetric int8 quantization: the dynamic abs-max scale,
    or a pinned one (a float or a 0-d tensor)."""
    xf = x.float()
    if scale is None:
        scale = _over(torch.clamp(xf.abs().amax(), min=_EPS), 127.0)
    elif not isinstance(scale, torch.Tensor):
        scale = torch.full((), scale, dtype=torch.float32, device=x.device)
    return QuantTensor(_quantize(xf, scale), scale)


def quant_weight(w: torch.Tensor, reduce_axes: Sequence[int]) -> QuantTensor:
    """Per-channel symmetric quantization; ``reduce_axes`` are the
    non-channel axes ((0, 1, 2) for an HWIO kernel: one scale per output
    channel)."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(reduce_axes), keepdim=True)
    scale = _over(torch.clamp(amax, min=_EPS), 127.0)
    return QuantTensor(_quantize(wf, scale), scale.reshape(-1))


def quant_ffn_weights(w: torch.Tensor) -> QuantTensor:
    """``bench_int8.py``'s ``qw``: per-column scales over axis 0 of a
    [K, N] matrix (what :func:`ffn_int8` takes)."""
    return quant_weight(w, (0,))


# --- integer products ---------------------------------------------------------

def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] · [K, N] → int32 through ``torch._int_mm``. ``a`` is
    taken row-major and ``b`` column-major (a transposed view of an [N, K]
    matrix, the layout cuBLASLt's int8 kernels take). Raises on the shapes
    ``_int_mm`` refuses; nothing falls back."""
    m, k = a.shape
    n = b.shape[1]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"torch._int_mm takes M > 16 and K, N multiples of "
                         f"8; got M={m}, K={k}, N={n}")
    if b.stride(0) != 1:
        b = b.t().contiguous().t()
    return torch._int_mm(a.contiguous(), b)


def _im2col(xq: torch.Tensor, k: int, stride: int, padding: int) -> torch.Tensor:
    """NHWC → [N, Ho, Wo, k·k·C], taps in HWIO order (ky, kx, c)."""
    n, h, w, c = xq.shape
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
    taps = [xp[:, i:i + stride * (ho - 1) + 1:stride,
               j:j + stride * (wo - 1) + 1:stride]
            for i in range(k) for j in range(k)]
    return torch.stack(taps, dim=3).reshape(n, ho, wo, k * k * c)


def int_mm_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                padding: int) -> torch.Tensor:
    """A dense int8 conv as one ``_int_mm``: a 1×1 on the (subsampled)
    input itself, any other kernel on its im2col matrix; K is zero-padded
    to a multiple of 8 (the 7×7 stem's 147 → 152). → f32 NHWC."""
    kh, _, cin, cout = wq.shape
    if kh == 1 and padding == 0:
        a = xq[:, ::stride, ::stride] if stride > 1 else xq
    else:
        a = _im2col(xq, kh, stride, padding)
    n, ho, wo, k = a.shape
    a = a.reshape(-1, k)
    b = wq.reshape(k, cout)
    pad = -k % 8
    if pad:
        a = F.pad(a, (0, pad))
        b = F.pad(b.t(), (0, pad)).t()
    return int_mm(a, b).float().reshape(n, ho, wo, cout)


def _epilogue(y: torch.Tensor, m: torch.Tensor, bias: Optional[torch.Tensor],
              relu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    y = y * m
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def int8_conv(qx: QuantTensor, w: Union[torch.Tensor, QuantTensor],
              stride: int = 1, padding: int = 0, groups: int = 1,
              bn_scale: Optional[torch.Tensor] = None,
              bn_bias: Optional[torch.Tensor] = None, relu: bool = False,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 NHWC conv with the dequant, frozen-BN affine and ReLU in one f32
    epilogue: ``y·((s_x·s_w[c])·bn_scale[c]) + bn_bias[c]``.

    ``qx`` is quantized once by the caller (a bottleneck's conv1 and its
    downsample share it). ``w`` is the f32 HWIO kernel, quantized here per
    output channel as the JAX function does, or an HWIO ``QuantTensor``
    quantized beforehand. Grouped convs (3×3, pad 1) run through K1q on the
    card; dense ones through ``_int_mm``; on the CPU both through
    :func:`exact_conv`."""
    qw = w if isinstance(w, QuantTensor) else quant_weight(w, (0, 1, 2))
    m = qx.scale * qw.scale
    if bn_scale is not None:
        m = m * bn_scale.float()
    if groups > 1:
        if tuple(qw.data.shape[:2]) != (3, 3) or padding != 1:
            raise ValueError("grouped int8 convs are 3×3 with padding 1")
        bias = (torch.zeros_like(m) if bn_bias is None else bn_bias.float())
        return grouped_conv3x3_int8(qx.data, qw.data, m, bias, groups, stride,
                                    relu, out_dtype)
    if uses_kernel(qx.data):
        y = int_mm_conv(qx.data, qw.data, stride, padding)
    else:
        y = exact_conv(qx.data, qw.data, stride, padding)
    return _epilogue(y, m, bn_bias, relu, out_dtype)


def int8_matmul(qx: QuantTensor, w: Union[torch.Tensor, QuantTensor],
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 [..., K] · [K, N] with per-column weight scales (``w`` the f32
    [K, N] matrix, or its ``quant_weight(w, (0,))``)."""
    qw = w if isinstance(w, QuantTensor) else quant_weight(w, (0,))
    a = qx.data.reshape(-1, qx.data.shape[-1])
    if uses_kernel(a):
        y = int_mm(a, qw.data).float()
    else:
        y = (a.double() @ qw.data.double()).float()
    y = y.reshape(qx.data.shape[:-1] + (qw.data.shape[1],))
    return _epilogue(y, qx.scale * qw.scale, bias, False, out_dtype)


# --- K7: the fused W8A8 FFN ----------------------------------------------------

def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """erf gelu with the Abramowitz-Stegun 7.1.26 erf polynomial
    (``cpt_tpu/ops/fused_ffn.py::_gelu(x, False)``), in x's dtype."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    z = x * 0.7071067811865476
    az = z.abs()
    t = 1.0 / (1.0 + p * az)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    erf = torch.sign(z) * (1.0 - poly * torch.exp(-az * az))
    return 0.5 * x * (1.0 + erf)


def _tile_quant(v: torch.Tensor) -> QuantTensor:
    """Per-tile dynamic quantization of v [T, tm, C] (one scale a tile)."""
    scale = _over(torch.clamp(v.abs().amax(dim=(1, 2), keepdim=True),
                              min=_EPS), 127.0)
    return QuantTensor(_quantize(v, scale), scale)


def ffn_int8_hidden(x, w1q, s1, b1, tm: int) -> torch.Tensor:
    """K7's first half, plain: each ``tm``-row tile of x quantized with one
    dynamic scale, an exact integer product, ``·(sx·s1) + b1``, polynomial
    gelu → h, f32 [M // tm, tm, F] (before h is quantized)."""
    m, h = x.shape
    if m % tm:
        raise ValueError(f"M={m} is not a multiple of tm={tm}")
    qx = _tile_quant(x.float().reshape(m // tm, tm, h))
    inter = (qx.data.double() @ w1q.double()).float()
    return gelu_poly(inter * (qx.scale * s1.float()) + b1.float())


def reference_ffn_int8(x, w1q, s1, b1, w2q, s2, b2, gamma, beta, tm: int,
                       eps: float = 1e-12) -> torch.Tensor:
    """Plain version of K7, ``bench_int8.py``'s ``kern`` on every ``tm``-row
    tile: :func:`ffn_int8_hidden`, the whole tile's h quantized with one
    scale, the second exact product, ``·(sh·s2) + b2 + x``, then LayerNorm
    ``E[(y−μ)²]`` and γ, β, all in f32; cast to x's dtype."""
    m, h = x.shape
    qh = _tile_quant(ffn_int8_hidden(x, w1q, s1, b1, tm))
    y = (qh.data.double() @ w2q.double()).float()
    y = y * (qh.scale * s2.float()) + b2.float() + x.float().reshape(m // tm, tm, h)
    mu = y.mean(-1, keepdim=True)
    var = torch.square(y - mu).mean(-1, keepdim=True)
    out = (y - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return out.reshape(m, h).to(x.dtype)


def ffn_int8(x: torch.Tensor, w1q: torch.Tensor, s1: torch.Tensor,
             b1: torch.Tensor, w2q: torch.Tensor, s2: torch.Tensor,
             b2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             tm: int, eps: float = 1e-12) -> torch.Tensor:
    """K7: ``LayerNorm(x + W8A8-FFN(x))`` with per-``tm``-row-tile dynamic
    activation scales. x [M, H] (bf16 on the card), w1q int8 [H, F], w2q
    int8 [F, H] (:func:`quant_ffn_weights`), s1, b1 f32 [F], s2, b2, gamma,
    beta f32 [H]; M % tm == 0. On the card: ``csrc/ffn_int8.cu``, which
    takes tm % 128 == 0, F % 128 == 0 and H a multiple of 128 up to 1024
    (its LayerNorm runs on a cluster of H / 128 blocks); the scratch it
    needs (x and h quantized, the weights made K-major, h in f32, the tile
    maxima) is allocated here."""
    if not uses_kernel(x):
        return reference_ffn_int8(x, w1q, s1, b1, w2q, s2, b2, gamma, beta,
                                  tm, eps)
    m, h = x.shape
    f = w1q.shape[1]
    if m % tm or tm % 128 or f % 128 or h % 128 or h > 1024:
        raise ValueError(f"ffn_int8 kernel: M={m}, tm={tm}, H={h}, F={f} "
                         f"outside M % tm, tm % 128, F % 128, H % 128 == 0 "
                         f"and H <= 1024")
    x = aligned16(require(x, "x", torch.bfloat16))
    w1q = aligned16(require(w1q, "w1q", torch.int8, (h, f)))
    w2q = aligned16(require(w2q, "w2q", torch.int8, (f, h)))
    vecs = [require(v.float(), name, torch.float32, (n,)) for v, name, n in (
        (s1, "s1", f), (b1, "b1", f), (s2, "s2", h), (b2, "b2", h),
        (gamma, "gamma", h), (beta, "beta", h))]

    def scratch(*shape, dtype=torch.int8):
        return torch.empty(shape, dtype=dtype, device=x.device)

    xq, w1t, w2t, hq = scratch(m, h), scratch(f, h), scratch(h, f), scratch(m, f)
    inter = scratch(m, f, dtype=torch.float32)
    amax = scratch(2, m // tm, dtype=torch.int32)
    out = torch.empty_like(x)
    check(lib().cpt_ffn_int8(x.data_ptr(), w1q.data_ptr(), vecs[0].data_ptr(),
                             vecs[1].data_ptr(), w2q.data_ptr(),
                             vecs[2].data_ptr(), vecs[3].data_ptr(),
                             vecs[4].data_ptr(), vecs[5].data_ptr(),
                             xq.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
                             inter.data_ptr(), hq.data_ptr(), amax.data_ptr(),
                             out.data_ptr(), m, h, f, tm, eps, stream(x)),
          "cpt_ffn_int8")
    ffn_int8.launches += 1
    return out


ffn_int8.launches = 0
