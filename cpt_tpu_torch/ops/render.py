"""Colorful-prompt rendering on the device (port of ``cpt_tpu/ops/render.py``).

Every colored copy is composited with integer math bit-identical to PIL's
``Image.paste(fg, box, fg)``:

    out = (fg·α + bg·(255−α) + 127) // 255

RefCOCO paints ``[x1, x2)`` of the inclusive box (``inclusive=False``);
GQA/VCR paint ``[x1, x2]`` (``inclusive=True``).

The functions broadcast: an image ``[H, W, 3]`` pasted with a batch of
rects ``[C, 4]`` and colors ``[C, 4]`` gives ``[C, H, W, 3]`` copies, which
is how the extractor renders all copies of a query at once.
"""
from __future__ import annotations

from typing import Sequence

import torch


def alpha_composite_u8(bg: torch.Tensor, fg_rgb, alpha: torch.Tensor
                       ) -> torch.Tensor:
    """PIL-exact integer alpha compositing.

    bg [..., H, W, 3] uint8 · fg_rgb broadcastable to bg · alpha [..., H, W]
    (0..255) → uint8.
    """
    bg_i = bg.to(torch.int32)
    fg_i = torch.as_tensor(fg_rgb, device=bg.device).to(torch.int32)
    a = alpha.to(torch.int32)[..., None]
    out = (fg_i * a + bg_i * (255 - a) + 127) // 255
    return out.to(torch.uint8)


def rect_alpha(h: int, w: int, rect: torch.Tensor, alpha_value: torch.Tensor,
               inclusive: bool = False) -> torch.Tensor:
    """Alpha map [..., H, W] for rects [..., 4] xyxy (float or int,
    truncated toward zero like the JAX ``astype(int32)``)."""
    x1, y1, x2, y2 = rect.to(torch.int32).unbind(-1)
    if inclusive:
        # GQA clamps degenerate boxes to at least 1px (max(x2-x1+1, 1))
        x2 = torch.maximum(x2 + 1, x1 + 1)
        y2 = torch.maximum(y2 + 1, y1 + 1)
    ys = torch.arange(h, device=rect.device, dtype=torch.int32)[:, None]
    xs = torch.arange(w, device=rect.device, dtype=torch.int32)[None, :]
    e = (..., None, None)
    inside = (ys >= y1[e]) & (ys < y2[e]) & (xs >= x1[e]) & (xs < x2[e])
    return torch.where(inside, alpha_value.to(torch.int32)[e],
                       torch.zeros((), dtype=torch.int32, device=rect.device))


def paste_rect(image: torch.Tensor, rect: torch.Tensor,
               color_rgba: torch.Tensor, inclusive: bool = False
               ) -> torch.Tensor:
    """Composite colored rectangles (rect [..., 4], color [..., 4])."""
    h, w = image.shape[-3:-1]
    alpha = rect_alpha(h, w, rect, color_rgba[..., 3], inclusive)
    return alpha_composite_u8(image, color_rgba[..., None, None, :3], alpha)


def paste_rects(image: torch.Tensor, rects: torch.Tensor,
                colors_rgba: torch.Tensor, valid: torch.Tensor,
                inclusive: bool = False) -> torch.Tensor:
    """Sequentially composite K rectangles, later over earlier (the
    reference's paste loop order): rects [..., K, 4] · colors [..., K, 4] ·
    valid [..., K]."""
    for k in range(rects.shape[-2]):
        pasted = paste_rect(image, rects[..., k, :], colors_rgba[..., k, :],
                            inclusive)
        image = torch.where(valid[..., k, None, None, None], pasted, image)
    return image


def paste_mask(image: torch.Tensor, mask: torch.Tensor,
               color_rgba: torch.Tensor) -> torch.Tensor:
    """Segmentation-mask paste: fg color with per-pixel alpha = α·mask
    (mask [..., H, W] binary, color [..., 4])."""
    alpha = mask.to(torch.int32) * color_rgba[..., 3, None, None].to(torch.int32)
    return alpha_composite_u8(image, color_rgba[..., None, None, :3], alpha)


def to_detector_input(image_u8_rgb: torch.Tensor,
                      pixel_mean_bgr: Sequence[float],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """RGB uint8 → BGR255 in ``dtype`` minus the per-channel BGR mean."""
    bgr = image_u8_rgb.flip(-1).to(dtype)
    return bgr - torch.tensor(pixel_mean_bgr, dtype=dtype,
                              device=image_u8_rgb.device)
