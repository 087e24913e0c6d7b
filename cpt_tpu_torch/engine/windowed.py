"""Windowed-recompute extraction (port of ``cpt_tpu/engine/windowed.py``).

The copies of one query differ only inside one painted rectangle, yet the
full path re-runs the backbone on every whole canvas. This path computes
the base image's feature map once per task, and per copy recomputes the
backbone only on a window around the painted rect, pasting the window's
interior into a copy of the base map; ``AttrRCNN.heads_from_feats`` then
pools the detections from the patched maps.

Exactness: a changed pixel moves features within the backbone's receptive
field RF. The paste trims RF from the window border (those cells carry
their whole RF inside the window), and a copy is eligible only when its
paint sits at least ``halo`` ≥ 2·RF from the window's edges, so every
dirty cell (paint ± RF) lands inside the pasted region. One-level
(:func:`make_windowed_extract_fn`) needs 2·RF of the whole body, which
only shallow nets meet; below it that mode is approximate
(:func:`feature_drift` measures it). The two-level mode
(:func:`make_two_level_extract_fn`) recomputes only the stem and the first
two stages per copy (2·RF = 154 px on X152) and runs the rest on the
patched stride-8 map: exact at halo 160.

The functions run under ``torch.inference_mode()`` on the model's device.
Window origins are host integers from :func:`window_origins` (numpy), so
cropping and pasting are plain slices with no device sync; where JAX's
``dynamic_slice`` / ``dynamic_update_slice`` clamp a start index, the
slices here clamp it the same way (:func:`_start`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN, region_features_2054
from cpt_tpu_torch.models.detector.config import DetectorConfig
from cpt_tpu_torch.ops.render import (paste_mask, paste_rects,
                                      to_detector_input)

STRIDE = 16
# the two-level mode splits the body after the stem and this many stages
# (``Extractor`` picks its mode from the receptive field up to here)
SPLIT_STAGE = 2
# the window ladder of ``extract_features --windows`` and ``cpt_predict
# --windowed``: each copy takes the smallest window its paint fits
WINDOW_LADDER = ((384, 512), (448, 576), (512, 640))


def backbone_receptive_field(cfg: DetectorConfig,
                             n_stages: Optional[int] = None) -> int:
    """Receptive-field radius (input pixels) of the C4 body, or of the stem
    and its first ``n_stages`` stages: stem 7×7/2, maxpool 3×3/2, then one
    3×3 conv a bottleneck, the first block of each stage after the first
    at stride 2 (carried by the 1×1 or the 3×3 per ``stride_in_1x1``).
    Tiny test config 21 px, X152-C4 645 px; X152 through stage 2 77 px."""
    b = cfg.backbone
    radius, jump = 0, 1
    radius += 3 * jump; jump *= 2      # stem conv 7×7 stride 2
    radius += 1 * jump; jump *= 2      # stem maxpool 3×3 stride 2
    for i, blocks in enumerate(b.stage_blocks[:n_stages]):
        for j in range(blocks):
            s = 2 if (i > 0 and j == 0) else 1
            if b.stride_in_1x1:
                jump *= s              # the leading 1×1 takes the stride
                radius += jump         # then the 3×3 conv
            else:
                radius += jump         # the 3×3 conv carries the stride
                jump *= s
    return radius


def window_origins(rects: np.ndarray, window: Tuple[int, int],
                   canvas_hw: Tuple[int, int], halo: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per copy, the stride-aligned window origin centred on the union of
    its painted rects, clamped into the canvas → (origins [C, 2] (y, x),
    fits [C] bool). ``fits`` is False where the rect plus the halo margin
    exceeds the window (that copy takes the full path). The margin is
    waived on window sides flush with the canvas edge: a flush edge sees
    the same zero padding as the full canvas, so features are exact up to
    it (the paste keeps those bands)."""
    wh, ww = window
    ch, cw = canvas_hw
    c = rects.shape[0]
    origins = np.zeros((c, 2), np.int32)
    fits = np.zeros((c,), bool)
    if wh > ch or ww > cw:
        return origins, fits           # the window exceeds the canvas
    for i in range(c):
        rs = rects[i].reshape(-1, 4)
        x1, y1 = rs[:, 0].min(), rs[:, 1].min()
        x2, y2 = rs[:, 2].max(), rs[:, 3].max()
        cy, cx = (y1 + y2) / 2, (x1 + x2) / 2
        oy = int(np.clip(cy - wh / 2, 0, max(ch - wh, 0))) // STRIDE * STRIDE
        ox = int(np.clip(cx - ww / 2, 0, max(cw - ww, 0))) // STRIDE * STRIDE
        origins[i] = (oy, ox)
        top = (y1 >= oy + halo) or (oy == 0 and y1 >= oy)
        bot = (y2 <= oy + wh - halo) or (oy + wh >= ch and y2 <= oy + wh)
        left = (x1 >= ox + halo) or (ox == 0 and x1 >= ox)
        right = (x2 <= ox + ww - halo) or (ox + ww >= cw and x2 <= ox + ww)
        fits[i] = top and bot and left and right
    return origins, fits


def mask_bboxes(masks: np.ndarray) -> np.ndarray:
    """Per-copy bounding boxes [C, 1, 4] of binary paint masks (an empty
    mask gives a degenerate box at the origin), for :func:`window_origins`."""
    c = masks.shape[0]
    out = np.zeros((c, 1, 4), np.float32)
    for i in range(c):
        ys, xs = np.nonzero(masks[i])
        if ys.size:
            out[i, 0] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return out


def feature_drift(exact, approx) -> dict:
    """Drift between exact and windowed outputs ((feats, labels, scores))."""
    ef, el, es = (np.asarray(a) for a in exact)
    af, al, asc = (np.asarray(a) for a in approx)
    denom = np.maximum(np.abs(ef).max(), 1e-9)
    return {
        "feat_max_rel": float(np.abs(ef - af).max() / denom),
        "feat_mean_rel": float(np.abs(ef - af).mean() / denom),
        "label_agreement": float((el == al).mean()),
        "score_max_abs": float(np.abs(es - asc).max()),
    }


def _start(start: int, size: int, dim: int) -> int:
    """A slice start clamped as ``dynamic_slice`` clamps it: into
    [0, dim − size]."""
    return int(min(max(start, 0), dim - size))


def _check_args(window: Tuple[int, int]) -> None:
    if window[0] % STRIDE or window[1] % STRIDE:
        raise ValueError(f"window {window} is not a multiple of {STRIDE}")


def crop_and_paint(image_u8: torch.Tensor, origins: np.ndarray,
                   window: Tuple[int, int], rects: torch.Tensor,
                   rect_valid: torch.Tensor, colors: torch.Tensor,
                   inclusive: bool = False,
                   masks: Optional[torch.Tensor] = None,
                   mask_colors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per copy, the window of the canvas at its origin with the copy's
    rects painted (``[x1, x2)``, or ``[x1, x2]`` with ``inclusive``), their
    offsets subtracted, then, given ``masks`` ([C, H, W] on the canvas), the
    same window of the copy's mask pasted in its ``mask_colors`` [C, 4] →
    [C, wh, ww, 3] uint8."""
    wh, ww = window
    h, w = image_u8.shape[:2]
    crops = torch.stack([
        image_u8[_start(oy, wh, h):_start(oy, wh, h) + wh,
                 _start(ox, ww, w):_start(ox, ww, w) + ww]
        for oy, ox in origins])
    off = torch.as_tensor(origins[:, [1, 0, 1, 0]], dtype=torch.float32,
                          device=rects.device)
    crops = paste_rects(crops, rects - off[:, None, :], colors, rect_valid,
                        inclusive=inclusive)
    if masks is None:
        return crops
    mh, mw = masks.shape[1:]
    mcrops = torch.stack([
        masks[i, _start(oy, wh, mh):_start(oy, wh, mh) + wh,
              _start(ox, ww, mw):_start(ox, ww, mw) + ww]
        for i, (oy, ox) in enumerate(origins)])
    return paste_mask(crops, mcrops, mask_colors)


def paste_windows(base: torch.Tensor, wfeats: torch.Tensor,
                  origins: np.ndarray, stride: int, trim: int,
                  window: Tuple[int, int], canvas_hw: Tuple[int, int]
                  ) -> torch.Tensor:
    """Per copy, a clone of the base map [h, w, ch] with its window's
    feature map (``wfeats`` [C, wh/stride, ww/stride, ch]) pasted at its
    origin → [C, h, w, ch] in the base map's dtype. ``trim`` cells are left
    off each window side, except on sides flush with the canvas edge,
    where the window's padding equals the full canvas's."""
    wh, ww = window
    h_img, w_img = canvas_hw
    _, whc, wwc, _ = wfeats.shape
    out = base.expand(len(origins), *base.shape).clone()
    for i, (oy0, ox0) in enumerate(origins):
        r0 = 0 if oy0 == 0 else trim
        r1 = whc if oy0 + wh >= h_img else whc - trim
        c0 = 0 if ox0 == 0 else trim
        c1 = wwc if ox0 + ww >= w_img else wwc - trim
        oy = _start(oy0 // stride, whc, base.shape[0])
        ox = _start(ox0 // stride, wwc, base.shape[1])
        out[i, oy + r0:oy + r1, ox + c0:ox + c1] = (
            wfeats[i, r0:r1, c0:c1].to(base.dtype))
    return out


def _heads(model: AttrRCNN, feats: torch.Tensor, copy_valid, dets,
           det_valid, hw):
    out = model.heads_from_feats(feats, dets, det_valid)
    f = region_features_2054(out["box_features"].float(), out["boxes"], hw)
    f = torch.where(copy_valid[:, None, None], f, torch.zeros_like(f))
    return f, out["labels"], out["scores"]


def make_base_features_fn(model: AttrRCNN, cfg: DetectorConfig):
    """uint8 canvas [H, W, 3] (or a batch [B, H, W, 3]) → C4 feature map,
    once per task."""

    @torch.inference_mode()
    def fn(image_u8):
        x = to_detector_input(image_u8, cfg.input.pixel_mean, dtype=model.dtype)
        if x.dim() == 3:
            return model.features(x)
        return model.backbone(x)

    return fn


def make_base_early_fn(model: AttrRCNN, cfg: DetectorConfig):
    """uint8 canvas [H, W, 3] (or a batch [B, H, W, 3]) → the early map
    (stem + the first ``SPLIT_STAGE`` stages; stride 4·2^(split−1)), once
    per task."""

    @torch.inference_mode()
    def fn(image_u8):
        x = to_detector_input(image_u8, cfg.input.pixel_mean, dtype=model.dtype)
        if x.dim() == 3:
            return model.backbone.up_to(x[None], SPLIT_STAGE)[0]
        return model.backbone.up_to(x, SPLIT_STAGE)

    return fn


def make_windowed_extract_fn(model: AttrRCNN, cfg: DetectorConfig, *,
                             window: Tuple[int, int] = (384, 512),
                             halo: int = 96):
    """One level: per copy, the whole backbone on its painted window, the
    trimmed window map pasted into the base C4 map, the heads on the
    patched maps. ``fn(image_u8, base_feat, origins, rects, rect_valid,
    colors, copy_valid, dets, det_valid, hw, masks=None, mask_colors=None,
    inclusive=False)`` → (feats [C, M, 2054], labels, scores), as
    ``engine/extract.make_extract_fn``; the masks ([C, H, W] on the canvas)
    are cropped to each copy's window. Exact when
    ``halo ≥ 2·RF`` of the whole body; below it the trim falls back to
    the halo itself (the approximate mode)."""
    _check_args(window)
    rf = backbone_receptive_field(cfg)
    t = min(-(-rf // STRIDE), halo // STRIDE)

    @torch.inference_mode()
    def fn(image_u8, base_feat, origins, rects, rect_valid, colors,
           copy_valid, dets, det_valid, hw, masks=None, mask_colors=None,
           inclusive=False):
        crops = crop_and_paint(image_u8, origins, window, rects, rect_valid,
                               colors, inclusive, masks, mask_colors)
        x = to_detector_input(crops, cfg.input.pixel_mean, dtype=model.dtype)
        patched = paste_windows(base_feat, model.backbone(x), origins, STRIDE,
                                t, window, tuple(image_u8.shape[:2]))
        return _heads(model, patched, copy_valid, dets, det_valid, hw)

    return fn


def make_two_level_extract_fn(model: AttrRCNN, cfg: DetectorConfig, *,
                              window: Tuple[int, int] = (512, 640),
                              halo: int = 160,
                              cascade: bool = False,
                              cascade_cap: int = 16):
    """Two-level exact windowed extraction: per copy, the stem and the
    first ``SPLIT_STAGE`` stages on the painted window; the trimmed
    interior pasted into the base early map (:func:`make_base_early_fn`);
    the remaining stages and the heads on the patched map. Exact at
    ``halo ≥ 2·backbone_receptive_field(cfg, SPLIT_STAGE)``.

    ``cascade=True`` also runs the first blocks of the deep stage on
    dirty-region windows: after the paste a copy differs from the base
    only inside the pasted region, and each 3×3 block dilates that region
    by one cell a side, so block k runs on a window of ``d0 + 2k + 2``
    cells whose trimmed interior pastes into the base's block-k output
    (computed once per call from ``base_feat``). It stops where the dirty
    region reaches a map dimension, or at ``cascade_cap``; the remaining
    blocks run on the whole per-copy map. Same signature and outputs as
    :func:`make_windowed_extract_fn`."""
    _check_args(window)
    wh, ww = window
    map_stride = 4 * 2 ** (SPLIT_STAGE - 1)
    rf = backbone_receptive_field(cfg, SPLIT_STAGE)
    t = -(-rf // map_stride)
    if halo < 2 * rf:
        raise ValueError(
            f"two-level windowed requires halo ({halo}) >= 2x early-stage RF "
            f"(2x{rf}) for exactness: pasted cells need RF inside the window "
            f"and dirty cells (paint + RF) must fall inside the pasted interior")
    body = model.backbone
    deep = body.stage(SPLIT_STAGE)
    n_deep = cfg.backbone.stage_blocks[SPLIT_STAGE]
    # the dirty region's size on the deep stage's stride-2 map: the whole
    # window (flush pastes may write into the halo bands)
    d0h, d0w = wh // map_stride // 2 + 3, ww // map_stride // 2 + 3

    def cascaded(patched, base_feat, origins):
        cur = deep.apply_block(patched, 0)               # [C, h16, w16, ch]
        del patched
        h16, w16 = cur.shape[1:3]
        k_max = max(min((h16 - d0h - 2) // 2, (w16 - d0w - 2) // 2,
                        n_deep - 1, cascade_cap), 0)
        base_k = deep.apply_block(base_feat[None], 0)
        o16 = np.maximum((origins // map_stride) // 2 - 1, 0)
        for k in range(1, k_max + 1):
            base_k = deep.apply_block(base_k, k)
            ukh, ukw = d0h + 2 * k, d0w + 2 * k
            skh, skw = ukh + 2, ukw + 2
            u0 = np.stack([np.clip(o16[:, 0] - k, 0, h16 - ukh),
                           np.clip(o16[:, 1] - k, 0, w16 - ukw)], 1)
            s0 = np.stack([np.clip(u0[:, 0] - 1, 0, h16 - skh),
                           np.clip(u0[:, 1] - 1, 0, w16 - skw)], 1)
            windows = torch.stack([
                cur[i, _start(sy, skh, h16):_start(sy, skh, h16) + skh,
                    _start(sx, skw, w16):_start(sx, skw, w16) + skw]
                for i, (sy, sx) in enumerate(s0)])
            outw = deep.apply_block(windows, k)
            cur = base_k.expand(len(origins), *base_k.shape[1:]).clone()
            for i, ((uy, ux), (sy, sx)) in enumerate(zip(u0, s0)):
                ry, rx = _start(uy - sy, ukh, skh), _start(ux - sx, ukw, skw)
                cy, cx = _start(uy, ukh, h16), _start(ux, ukw, w16)
                cur[i, cy:cy + ukh, cx:cx + ukw] = outw[i, ry:ry + ukh,
                                                        rx:rx + ukw]
        for k in range(k_max + 1, n_deep):
            cur = deep.apply_block(cur, k)
        return body.from_stage(cur, SPLIT_STAGE + 1)

    def late(patched, base_feat, origins):
        if cascade:
            return cascaded(patched, base_feat, origins)
        return body.from_stage(patched, SPLIT_STAGE)

    @torch.inference_mode()
    def fn(image_u8, base_feat, origins, rects, rect_valid, colors,
           copy_valid, dets, det_valid, hw, masks=None, mask_colors=None,
           inclusive=False):
        crops = crop_and_paint(image_u8, origins, window, rects, rect_valid,
                               colors, inclusive, masks, mask_colors)
        x = to_detector_input(crops, cfg.input.pixel_mean, dtype=model.dtype)
        early = body.up_to(x, SPLIT_STAGE)
        del crops, x
        # the patched maps are passed on, not held here, so each stage frees
        # its input
        c4 = late(paste_windows(base_feat, early, origins, map_stride, t,
                                window, tuple(image_u8.shape[:2])),
                  base_feat, origins)
        return _heads(model, c4, copy_valid, dets, det_valid, hw)

    return fn


def make_sharded_windowed_fn(model: AttrRCNN, cfg: DetectorConfig, mesh,
                             two_level: bool = False, **kw):
    """Windowed extraction over a mesh's ``dp`` axis
    (``cpt_tpu/engine/windowed.py:431-457``): each rank runs its slice of
    the copies (and their windows) over the shared base map, the outputs
    come back in copy order, the whole chunk's on every rank.
    ``two_level=True`` shards the exact two-level path; the signature is
    :func:`make_windowed_extract_fn`'s, the chunk a multiple of dp."""
    from cpt_tpu_torch.parallel.mesh import dp_call

    base = (make_two_level_extract_fn(model, cfg, **kw) if two_level
            else make_windowed_extract_fn(model, cfg, **kw))

    def fn(image_u8, base_feat, origins, rects, rect_valid, colors,
           copy_valid, dets, det_valid, hw, masks=None, mask_colors=None,
           inclusive=False):
        def local(o, r, rv, c, cv, m, mc):
            return base(image_u8, base_feat, o, r, rv, c, cv, dets, det_valid,
                        hw, m, mc, inclusive=inclusive)

        return dp_call(local, mesh, origins, rects, rect_valid, colors,
                       copy_valid, masks, mask_colors)

    return fn


def ladder(windows: Sequence) -> list:
    """One window (h, w) or a sequence of them → the windows sorted by
    area, smallest first."""
    if windows and isinstance(windows[0], (tuple, list)):
        return sorted((tuple(w) for w in windows), key=lambda w: w[0] * w[1])
    return [tuple(windows)]
