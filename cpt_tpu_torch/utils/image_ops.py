"""Host pixel operations without Pillow: bilinear and nearest resize, and
polygon fill (the port's counterparts of the ``Image.resize`` and
``ImageDraw.polygon`` calls the JAX package makes).

Each function reproduces Pillow 12.1's result bit for bit on ``uint8``
arrays, so the port's resize rule, ``extract_features --resize``, VCR's
polygon prompts and ``--bbox_aug_scales`` give the JAX package's pixels on a
machine without Pillow. The arithmetic is vectorised numpy: integer taps
with int64 accumulators for the resizes (Pillow's 22-bit fixed point),
float32 edge crossings for the fill (Pillow's scanline rasterizer). No
per-pixel Python loop.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_PRECISION_BITS = 22        # Pillow's 8-bit resample: 32 - 8 - 2


def _bilinear_taps(n_in: int, n_out: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter along one axis
    → (source index [n_out, k], fixed-point weight [n_out, k]); padded taps
    carry weight 0 and index 0. Downscaling widens the support by the scale
    (Pillow's antialias)."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = fs                          # the filter's support 1.0 × scale
    k = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    lo = np.maximum((center - support + 0.5).astype(np.int64), 0)
    hi = np.minimum((center + support + 0.5).astype(np.int64), n_in)
    j = lo[:, None] + np.arange(k)[None, :]
    inside = j < hi[:, None]
    wts = np.maximum(1.0 - np.abs((j - center[:, None] + 0.5) * (1.0 / fs)), 0.0)
    wts = np.where(inside, wts, 0.0)
    total = np.zeros(n_out)
    for t in range(k):                    # Pillow sums the taps in order
        total += wts[:, t]
    wts = wts / total[:, None]            # the tap nearest the centre is > 0
    fixed = (0.5 + wts * (1 << _PRECISION_BITS)).astype(np.int64)
    return np.where(inside, j, 0), fixed


def _bilinear_pass(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """Resample ``img`` along ``axis`` to ``n_out``: each output pixel is its
    taps' fixed-point weighted sum (int64), rounded and clipped to uint8."""
    idx, fixed = _bilinear_taps(img.shape[axis], n_out)
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0))
    fixed = fixed.reshape(fixed.shape + (1,) * (src.ndim - 1))
    acc = np.full((n_out,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    term = np.empty_like(acc)
    for t in range(idx.shape[1]):
        np.multiply(src[idx[:, t]], fixed[:, t], out=term)
        acc += term
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.BILINEAR)`` for a uint8
    ``[H, W]`` (mode L) or ``[H, W, 3]`` (RGB) array; ``size`` is (w, h),
    Pillow's order. An axis whose size is kept is not resampled; otherwise
    the horizontal pass runs first, each pass rounding to uint8."""
    w, h = int(size[0]), int(size[1])
    out = np.asarray(img, np.uint8)
    if w != out.shape[1]:
        out = _bilinear_pass(out, w, 1)
    if h != out.shape[0]:
        out = _bilinear_pass(out, h, 0)
    return np.array(out, np.uint8)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Pillow's affine-scale table: the source coordinate starts at half a
    step and grows by the step (accumulated in float64, not multiplied);
    the index is its integer part, clamped to the last pixel."""
    step = n_in / n_out
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(n_out - 1, step)]))
    return np.minimum(pos.astype(np.int64), n_in - 1)


def resize_nearest(mask: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(mask.astype(np.uint8)).resize(size, Image.NEAREST)``
    for a ``[H, W]`` array; ``size`` is (w, h)."""
    w, h = int(size[0]), int(size[1])
    src = np.asarray(mask).astype(np.uint8)
    return src[_nearest_index(src.shape[0], h)[:, None],
               _nearest_index(src.shape[1], w)[None, :]]


def _round_up(v: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_UP: halves away from zero."""
    return (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.int64)


def _round_down(v: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_DOWN: halves toward zero."""
    return (np.sign(v) * np.ceil(np.abs(v) - 0.5)).astype(np.int64)


def _roundf(v: np.ndarray) -> np.ndarray:
    """C's ``roundf`` on float32 values (exact in float64)."""
    v = v.astype(np.float64)
    return (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.float32)


def _fill_part(spans: np.ndarray, xy: np.ndarray, h: int, w: int) -> None:
    """Pillow's ``polygon_generic`` for one closed part with integer
    vertices ``xy`` [n, 2]; adds each span to the row difference table
    ``spans`` [h, w + 1]."""
    nxt = np.roll(xy, -1, axis=0)         # edge i: vertex i to vertex i + 1
    x0, y0, x1, y1 = xy[:, 0], xy[:, 1], nxt[:, 0], nxt[:, 1]
    emin, emax = np.minimum(y0, y1), np.maximum(y0, y1)
    ymin = max(min(h - 1, int(emin.min())), 0)
    ymax = min(max(0, int(emax.max())), h)

    def hline(xa, xb, y):
        ok = (y >= 0) & (y < h)
        xa, xb, y = np.maximum(xa[ok], 0), np.minimum(xb[ok], w - 1), y[ok]
        ok = xa <= xb
        np.add.at(spans, (y[ok], xa[ok]), 1)
        np.add.at(spans, (y[ok], xb[ok] + 1), -1)

    flat = y0 == y1                       # horizontal edges: drawn whole
    hline(np.minimum(x0, x1)[flat], np.maximum(x0, x1)[flat], y0[flat])
    e = ~flat
    x0, y0, x1, y1, emin, emax = x0[e], y0[e], x1[e], y1[e], emin[e], emax[e]
    if not len(x0) or ymin > min(ymax, h - 1):
        return
    f32 = np.float32
    dx = (x1 - x0).astype(f32) / (y1 - y0).astype(f32)
    fx0 = x0.astype(f32)

    def x_at(y, sel=slice(None)):
        """Crossing of the edges ``sel`` with rows ``y``, in float32 from
        each edge's first vertex, as Pillow computes it."""
        return (y - y0[sel]).astype(f32) * dx[sel] + fx0[sel]

    # Corners: at a slanted edge's first row (or, on the last row, its end),
    # where the first earlier slanted edge that also starts (ends) on that
    # row crosses at the same rounded x, the edge's crossing moves to one
    # pixel past the nearer of the two edges' next (previous) row crossings,
    # rounded, when it lies more than a pixel beyond both, so the corner's
    # pixels connect to that row's span.
    fixes = []
    for at_end in (False, True):
        ys = emax if at_end else emin
        xs = x_at(ys)
        joins = dx != 0
        if at_end:
            joins &= emax == ymax
        c = np.flatnonzero(joins)         # a corner's two edges are both here
        i, k = np.nonzero(np.tri(len(c), len(c), -1, bool))
        i, k = c[i], c[k]
        y = ys[i]
        ok = (ys[k] == y) & (_roundf(xs[k]) == _roundf(xs[i]))
        i, k, y = i[ok], k[ok], y[ok]
        if not len(i):
            continue
        first = np.unique(i, return_index=True)[1]      # the loop's break
        i, k, y = i[first], k[first], y[first]
        yn = y - 1 if at_end else y + 1
        a, b = x_at(yn, i), x_at(yn, k)
        xi = xs[i]
        new = np.where((xi > a + 1) & (xi > b + 1),
                       _roundf(np.maximum(a, b)) + f32(1),
                       np.where((xi < a - 1) & (xi < b - 1),
                                _roundf(np.minimum(a, b)) - f32(1), xi))
        fixes.append((i, y, new))

    rows = np.arange(ymin, min(ymax, h - 1) + 1)
    cross = x_at(rows[:, None])
    inside = (rows[:, None] >= emin) & (rows[:, None] <= emax)
    for i, y, new in fixes:
        on = (y >= ymin) & (y < ymin + len(rows))
        cross[y[on] - ymin, i[on]] = new[on]
    twice = inside & (rows[:, None] == emax) & (rows[:, None] < ymax)
    vals = np.concatenate([np.where(inside, cross, np.inf),
                           np.where(twice, cross, np.inf)], axis=1)
    vals = np.sort(vals, axis=1)
    left, right = vals[:, 0::2], vals[:, 1::2]
    pair = np.isfinite(right)
    r = np.broadcast_to(rows[:, None], pair.shape)[pair]
    hline(_round_up(left[pair]), _round_down(right[pair]), r)


def _parts(polygon) -> list:
    """One part ``[[x, y], ...]`` or a list of parts (the reference's
    multi-part segms, possibly with empty members) → the parts to draw."""
    if len(polygon) and (not len(polygon[0])
                         or hasattr(polygon[0][0], "__len__")):
        return list(polygon)
    return [polygon] if len(polygon) else []


def fill_polygon(polygon, h: int, w: int) -> np.ndarray:
    """Polygon(s) → uint8 mask [h, w]: what ``ImageDraw.Draw(img).polygon(
    part, fill=1)`` draws for each part in turn on a zeroed mode-L canvas
    of (w, h). Vertices are truncated to integers, as Pillow converts them;
    an empty part draws nothing and a one-point part is drawn as that
    point twice."""
    spans = np.zeros((h, w + 1), np.int32)
    for part in _parts(polygon):
        if not len(part):
            continue
        xy = np.asarray([[float(x), float(y)] for x, y in part], np.float64)
        if len(xy) < 2:
            xy = np.concatenate([xy, xy[:1]])
        _fill_part(spans, np.trunc(xy).astype(np.int64), h, w)
    return (np.cumsum(spans[:, :w], axis=1) > 0).astype(np.uint8)
