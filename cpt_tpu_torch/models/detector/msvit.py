"""MsViT backbone with 2-D sliding-chunk (Longformer2D) attention (port of
``cpt_tpu/models/detector/msvit.py``).

The reference's vision-longformer backbone (``modeling/backbone/msvit.py``,
``longformer2d.py``, ``slidingchunk_2d.py``; the ViL-C4 builders):

* the arch string ``"l1,h3,d96,n2,s1,g1,p4,f7,a0_l2,..."`` per stage
  (``msvit.py:313-318``): h heads, d width, n blocks, s=1 sliding-chunk
  attention, g global tokens, p patch stride, a=1 an absolute position
  embedding;
* Long2DSCSelfAttention (``longformer2d.py:12-200``): the [ny, nx] token
  grid falls into w×w chunks; a query attends to its chunk's 3×3
  neighbourhood and the global tokens, a global token to everything
  (with its own q / kv / proj);
* pre-norm blocks, a GELU MLP (ratio 4), a conv patch embedding a stage.

As in the JAX package the neighbourhood is a stack of 9 static shifted
views of the chunk grid padded by one chunk, with the padded keys masked,
and the attention is plain matmuls (JAX's einsums, no Pallas kernel). The
numerics follow flax: GELU is the tanh approximation, LayerNorm's eps is
1e-6, and each softmax runs in f32 and casts back.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cpt_tpu_torch.models.bert.model import Dense, LayerNorm
from cpt_tpu_torch.models.detector.resnet import Conv

NEG = -1e9


def parse_arch(arch: str) -> List[Dict[str, int]]:
    """``msvit.py:313-318``: '_'-separated stages of 'k<int>' attributes."""
    out = []
    for layer in arch.split("_"):
        cfg = {"l": 1, "h": 3, "d": 192, "n": 1, "s": 1, "g": 1,
               "p": 2, "f": 7, "a": 0}
        for attr in layer.split(","):
            cfg[attr[0]] = int(attr[1:])
        out.append(cfg)
    return out


def sliding_chunk_attention_2d(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, ny: int, nx: int,
                               w: int) -> torch.Tensor:
    """q / k / v [B, H, ny·nx, hd] over an [ny, nx] grid → [B, H, ny·nx, hd]:
    each query attends to the 3×3 neighbourhood of its w×w chunk
    (``slidingchunk_2d.py``, exact=0), the grid padded to whole chunks and
    the padded keys masked."""
    b, h, _, hd = q.shape
    empty = q.new_zeros((b, h, 0, hd))
    return _local_with_globals(q, k, v, empty, empty, ny, nx, w)


def relative_position_index(w: int) -> np.ndarray:
    """[w², 9w²] index into the (4w − 1)² bias table, for the 3×3 chunk
    neighbourhood in (dy, dx) raster order (``longformer2d.py:68-101``)."""
    coords = np.stack(np.meshgrid(np.arange(-w, 2 * w),
                                  np.arange(-w, 2 * w), indexing="ij"))
    cu = coords.reshape(2, 3, w, 3, w).transpose(0, 1, 3, 2, 4).reshape(
        2, 3, 3, w * w)
    q = cu[:, 1, 1, :]
    rel = np.concatenate([
        q[:, :, None] - cu[:, i, j, :][:, None, :]
        for i in (0, 1, 2) for j in (0, 1, 2)
    ], axis=-1)
    rel = rel.transpose(1, 2, 0) + (2 * w - 1)
    return (rel[..., 0] * (4 * w - 1) + rel[..., 1]).astype(np.int32)


def _softmax_f32(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1).to(dtype)


def _local_with_globals(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kg: torch.Tensor, vg: torch.Tensor, ny: int, nx: int,
                        w: int, local_bias: Optional[torch.Tensor] = None,
                        l2g_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sliding-chunk attention in which every local query also sees the
    global keys / values (one softmax over neighbourhood ∪ globals).
    ``local_bias`` [H, w², 9w²] / ``l2g_bias`` [g, H] are the rpe terms."""
    b, h, _, hd = q.shape
    g = kg.shape[2]
    py, px = (-ny) % w, (-nx) % w
    cy, cx = (ny + py) // w, (nx + px) // w

    def to_chunks(t, ch):
        t = F.pad(t.reshape(b, h, ny, nx, ch), (0, 0, 0, px, 0, py))
        t = t.reshape(b, h, cy, w, cx, w, ch)
        return t.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, h, cy, cx, w * w, ch)

    qc, kc, vc = to_chunks(q, hd), to_chunks(k, hd), to_chunks(v, hd)
    val = to_chunks(q.new_ones((b, h, ny * nx, 1)), 1)[..., 0]

    def neighborhood(t):
        pad = [0, 0] * (t.dim() - 4) + [1, 1, 1, 1]
        tp = F.pad(t, pad)
        views = [tp[:, :, 1 + dy:1 + dy + cy, 1 + dx:1 + dx + cx]
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        return torch.cat(views, dim=4)

    kn = torch.cat([neighborhood(kc),
                    kg[:, :, None, None].expand(b, h, cy, cx, g, hd)], dim=4)
    vn = torch.cat([neighborhood(vc),
                    vg[:, :, None, None].expand(b, h, cy, cx, g, hd)], dim=4)
    vmask = torch.cat([neighborhood(val), q.new_ones((b, h, cy, cx, g))],
                      dim=4)
    logits = torch.einsum("bhyxqd,bhyxkd->bhyxqk", qc, kn)
    if local_bias is not None:
        bias = local_bias
        if g > 0:
            l2g = (l2g_bias.T[:, None, :].expand(*bias.shape[:2], g)
                   if l2g_bias is not None else bias.new_zeros((*bias.shape[:2], g)))
            bias = torch.cat([bias, l2g], dim=-1)
        logits = logits + bias[None, :, None, None].to(logits.dtype)
    logits = torch.where(vmask[:, :, :, :, None, :] > 0, logits,
                         torch.full((), NEG, dtype=logits.dtype,
                                    device=logits.device))
    out = torch.einsum("bhyxqk,bhyxkd->bhyxqd", _softmax_f32(logits, q.dtype),
                       vn)
    out = out.reshape(b, h, cy, cx, w, w, hd).permute(0, 1, 2, 4, 3, 5, 6)
    out = out.reshape(b, h, cy * w, cx * w, hd)[:, :, :ny, :nx]
    return out.reshape(b, h, ny * nx, hd)


class Long2DSCAttention(nn.Module):
    """Sliding-chunk attention + global tokens (``longformer2d.py``) on
    [B, nglo + ny·nx, D], the globals first. ``rpe`` adds the Swin-style
    relative position biases: the local (4w − 1)² table a head and the
    global-to-local / global-to-global tables."""

    def __init__(self, dim: int, num_heads: int, window: int = 7,
                 nglo: int = 1, rpe: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.window, self.nglo = dim, num_heads, window, nglo
        self.rpe, self.dtype = rpe, dtype
        h, w, g = num_heads, window, nglo
        if rpe:
            self.local_relative_position_bias_table = nn.Parameter(
                torch.empty((4 * w - 1) ** 2, h))
            self.register_buffer("rel_index", torch.from_numpy(
                relative_position_index(w).reshape(-1).astype(np.int64)),
                persistent=False)
            if g >= 1:
                self.g2l_relative_position_bias = nn.Parameter(
                    torch.empty(2, h, g))
                self.g2g_relative_position_bias = nn.Parameter(
                    torch.empty(h, g, g))
        self.query = Dense(dim, dim, dtype)
        self.kv = Dense(dim, 2 * dim, dtype)
        if g > 0:
            self.query_global = Dense(dim, dim, dtype)
            self.kv_global = Dense(dim, 2 * dim, dtype)
            self.proj_global = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
        b, n, _ = x.shape
        h, hd = self.num_heads, self.dim // self.num_heads
        scale = hd ** -0.5
        g, w = self.nglo, self.window
        local_bias = l2g_bias = g_bias = None
        if self.rpe:
            table = self.local_relative_position_bias_table
            local_bias = table[self.rel_index].reshape(
                w * w, 9 * w * w, h).permute(2, 0, 1)
            if g >= 1:
                g2l = self.g2l_relative_position_bias
                l2g_bias = g2l[1].T
                g_bias = torch.cat([self.g2g_relative_position_bias,
                                    g2l[0][:, :, None].expand(h, g, ny * nx)],
                                   dim=-1)

        def heads(t):
            return t.reshape(b, -1, h, hd).transpose(1, 2)

        q = heads(self.query(x))
        kv = self.kv(x)
        k, v = heads(kv[..., :self.dim]), heads(kv[..., self.dim:])
        lq, lk, lv = q[:, :, g:] * scale, k[:, :, g:], v[:, :, g:]
        if g > 0:
            local = _local_with_globals(lq, lk, lv, k[:, :, :g], v[:, :, :g],
                                        ny, nx, w, local_bias=local_bias,
                                        l2g_bias=l2g_bias)
            qg = heads(self.query_global(x[:, :g])) * scale
            kvg = self.kv_global(x)
            kg, vg = heads(kvg[..., :self.dim]), heads(kvg[..., self.dim:])
            glogits = torch.einsum("bhqd,bhkd->bhqk", qg, kg)
            if g_bias is not None:
                glogits = glogits + g_bias[None].to(glogits.dtype)
            gout = torch.einsum("bhqk,bhkd->bhqd",
                                _softmax_f32(glogits, q.dtype), vg)
            out = torch.cat([gout, local], dim=2)
        else:
            empty = lq.new_zeros((lq.shape[0], lq.shape[1], 0, hd))
            out = _local_with_globals(lq, lk, lv, empty, empty, ny, nx, w,
                                      local_bias=local_bias)
        out = out.transpose(1, 2).reshape(b, n, self.dim)
        loc = self.proj(out[:, g:])
        if g == 0:
            return loc
        return torch.cat([self.proj_global(out[:, :g]), loc], dim=1)


class _FullAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
        b, n, _ = x.shape
        h, hd = self.num_heads, self.dim // self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        logits = torch.einsum("bhqd,bhkd->bhqk", q * hd ** -0.5, k)
        out = torch.einsum("bhqk,bhkd->bhqd", _softmax_f32(logits, q.dtype), v)
        return self.proj(out.transpose(1, 2).reshape(b, n, self.dim))


class _Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, sparse: bool, window: int,
                 nglo: int, rpe: bool = False, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = (Long2DSCAttention(dim, num_heads, window, nglo, rpe, dtype)
                     if sparse else _FullAttention(dim, num_heads, dtype))
        self.norm1 = LayerNorm(dim, 1e-6)
        self.norm2 = LayerNorm(dim, 1e-6)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, dtype)

    def forward(self, x: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), ny, nx)
        y = self.mlp_fc1(self.norm2(x))
        return x + self.mlp_fc2(F.gelu(y, approximate="tanh"))


class MsViT(nn.Module):
    """Multi-scale vision transformer backbone (``msvit.py:321-560``) →
    per-stage [B, Hs, Ws, Ds] maps, the global tokens dropped (the
    reference's detection forward). A stage with an absolute position
    embedding (``a1``) sizes it from ``image_hw``, the input's [H, W]."""

    def __init__(self, arch: str = "l1,h3,d96,n1,s1,g1,p4,f7,a0_l2,h3,d192,"
                 "n2,s1,g1,p2,f7,a0", window: int = 7, rpe: bool = False,
                 in_channels: int = 3, image_hw: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stages = parse_arch(arch)
        cin, hw = in_channels, image_hw
        for i, cfg in enumerate(self.stages):
            p, d, g = cfg["p"], cfg["d"], cfg["g"]
            self.add_module(f"patch_embed{i + 1}", Conv(cin, d, p, p,
                                                        dtype=dtype))
            if hw is not None:
                hw = (-(-hw[0] // p), -(-hw[1] // p))
            if cfg["a"]:
                if hw is None:
                    raise ValueError("an absolute position embedding needs "
                                     "image_hw")
                self.register_parameter(f"ape{i + 1}", nn.Parameter(
                    torch.empty(1, hw[0] * hw[1], d)))
            if g > 0:
                self.register_parameter(f"glo{i + 1}",
                                        nn.Parameter(torch.empty(1, g, d)))
            for blk in range(cfg["n"]):
                self.add_module(f"layer{i + 1}_block{blk}", _Block(
                    d, cfg["h"], cfg["s"] == 1, window, g, rpe, dtype=dtype))
            self.add_module(f"norm{i + 1}", LayerNorm(d, 1e-6))
            cin = d

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, cfg in enumerate(self.stages):
            d, g = cfg["d"], cfg["g"]
            x = getattr(self, f"patch_embed{i + 1}")(x)
            b, hgt, wid, _ = x.shape
            tokens = x.reshape(b, hgt * wid, d)
            if cfg["a"]:
                tokens = tokens + getattr(self, f"ape{i + 1}").to(tokens.dtype)
            if g > 0:
                glo = getattr(self, f"glo{i + 1}").to(tokens.dtype)
                tokens = torch.cat([glo.expand(b, g, d), tokens], dim=1)
            for blk in range(cfg["n"]):
                tokens = getattr(self, f"layer{i + 1}_block{blk}")(
                    tokens, hgt, wid)
            tokens = getattr(self, f"norm{i + 1}")(tokens)
            x = tokens[:, g:].reshape(b, hgt, wid, d)
            outs.append(x)
        return outs
