"""Stage-1 feature extraction: image → colored copies → detector →
``predictions.tsv`` (port of ``cpt_tpu/engine/extract.py``: the full path
and the windowed one, each on one card or split over a mesh's ``dp`` axis),
and RPN-mode detection (:func:`make_detect_fn`).

The base image is uploaded once per query; all candidate-region copies are
rendered on the device (``ops/render``) and run through the detector in
chunks of copies. The paint variants, one per reference dataset:

  * rects, one color a copy          — RefCOCO (``refcocodataset.py``)
  * K rects with their own colors    — GQA marks, VG subject/object pairs
  * one binary mask a copy           — RefCOCO SEG (RLE masks)

Output rows are bit-compatible with the reference TSV interchange
(``inference_ref.py:95-192``); each task's payload layout is its
``*_payload`` function below.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from cpt_tpu_torch.engine import windowed as wnd
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN, region_features_2054
from cpt_tpu_torch.models.detector.config import DetectorConfig
from cpt_tpu_torch.ops.render import paste_mask, paste_rects, to_detector_input
from cpt_tpu_torch.structures.boxes import pad_boxes
from cpt_tpu_torch.utils.tsv import encode_feature, tsv_writer

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ExtractTask:
    """One query: base image + candidate boxes + per-copy paint ops.

    Each copy paints up to K rects (``copy_rects [n_copies, K, 4]`` +
    ``copy_rect_valid [n_copies, K]``) and/or one binary mask
    (``copy_masks [n_copies, H, W]``) with per-op RGBA colors. Rects are
    painted ``[x1, x2)`` of the inclusive box (RefCOCO, VG), or ``[x1, x2]``
    with ``inclusive_paint`` (GQA).
    """

    key: str
    image_rgb: np.ndarray                  # [H, W, 3] uint8
    image_hw: Sequence[int]                # true (h, w)
    det_boxes: np.ndarray                  # [n_dets, 4] xyxy inclusive
    caption: str = ""
    copy_rects: Optional[np.ndarray] = None        # [n_copies, K, 4]
    copy_rect_valid: Optional[np.ndarray] = None   # [n_copies, K]
    copy_colors_rgba: Optional[np.ndarray] = None  # [n_copies, K, 4] uint8
    copy_masks: Optional[np.ndarray] = None        # [n_copies, H, W] uint8
    copy_mask_colors: Optional[np.ndarray] = None  # [n_copies, 4] uint8
    copy_color_names: Optional[List[List[str]]] = None
    meta: Optional[dict] = None            # task-specific payload fields
    inclusive_paint: bool = False

    @property
    def n_copies(self) -> int:
        if self.copy_rects is not None:
            return len(self.copy_rects)
        if self.copy_masks is not None:
            return len(self.copy_masks)
        return 1  # plain (uncolored) extraction


def make_extract_fn(model: AttrRCNN, cfg: DetectorConfig):
    """Chunk extractor over C copies with K rects each, painted ``[x1, x2)``
    or, with ``inclusive``, ``[x1, x2]``; given ``masks`` ([C, H, W]
    uint8, ``mask_colors`` [C, 4]) each copy then pastes its binary mask.
    Tensors live on the model's device; ``hw`` is the true (h, w)."""

    @torch.inference_mode()
    def fn(image_u8, rects, rect_valid, colors, copy_valid, dets, det_valid,
           hw, masks=None, mask_colors=None, inclusive=False):
        copies = paste_rects(image_u8, rects, colors, rect_valid,
                             inclusive=inclusive)
        if masks is not None:
            copies = paste_mask(copies, masks, mask_colors)
        x = to_detector_input(copies, cfg.input.pixel_mean, dtype=model.dtype)
        out = model.forward_batch_force(x, hw, dets, det_valid)
        feats = region_features_2054(out["box_features"].float(),
                                     out["boxes"], hw)
        feats = torch.where(copy_valid[:, None, None], feats,
                            torch.zeros_like(feats))
        return feats, out["labels"], out["scores"]

    return fn


def make_sharded_extract_fn(model: AttrRCNN, cfg: DetectorConfig, mesh):
    """Extraction over a mesh's ``dp`` axis
    (``cpt_tpu/engine/extract.py:687-720``): each rank renders and runs its
    slice of the chunk's copies with its replica of the weights; the
    outputs come back in copy order, the whole chunk's on every rank. No
    collective is on the path but that gather. The signature is
    :func:`make_extract_fn`'s; the chunk must be a multiple of dp."""
    from cpt_tpu_torch.parallel.mesh import dp_call

    base = make_extract_fn(model, cfg)

    def fn(image_u8, rects, rect_valid, colors, copy_valid, dets, det_valid,
           hw, masks=None, mask_colors=None, inclusive=False):
        def local(r, rv, c, cv, m, mc):
            return base(image_u8, r, rv, c, cv, dets, det_valid, hw, m, mc,
                        inclusive=inclusive)

        return dp_call(local, mesh, rects, rect_valid, colors, copy_valid,
                       masks, mask_colors)

    return fn


def make_detect_fn(model: AttrRCNN, cfg: DetectorConfig, *,
                   with_attributes: bool = True):
    """RPN-mode detection + region features on one canvas (the reference's
    generic ``engine/inference.py`` path): ``fn(image_u8 [H, W, 3],
    anchors, hw)`` → (feats [D, 2054], boxes, labels, scores, valid,
    attr_logits or None), ``D = detections_per_img`` slots."""

    @torch.inference_mode()
    def fn(image_u8, anchors, hw):
        x = to_detector_input(image_u8, cfg.input.pixel_mean, dtype=model.dtype)
        out = model(x, hw, anchors, with_attributes)
        feats = region_features_2054(out["box_features"].float(),
                                     out["boxes"], hw)
        return (feats, out["boxes"], out["labels"], out["scores"],
                out["valid"], out.get("attr_logits"))

    return fn


class Extractor:
    """Host-side driver: chunks copies, invokes the extractor, and assembles
    per-task TSV rows."""

    # largest chunk the JAX package measured to fit a 16 GB TPU v5e at
    # 640×1024 (128 copies); kept so both packages chunk alike
    AUTO_CHUNK_PIXEL_BUDGET = 128 * 640 * 1024
    # base passes of up to this many consecutive task groups run as one
    # batched backbone call on the windowed dataset path (``run``): on an
    # H100, 8 batched ran 1.09-1.34x faster in the extractor than 8 single
    # ones in every pairing (``chip_smoke.py`` phase 7, warmed up, both
    # orders; PERF.md §6)
    RUN_BASE_BATCH = 8

    def __init__(self, model: AttrRCNN, cfg: DetectorConfig,
                 copies_per_chunk: Optional[int] = 4,
                 windowed: bool = False, window=(512, 640), halo: int = 160,
                 allow_approximate: bool = False,
                 labelmap: Optional[Dict[int, str]] = None, mesh=None):
        """``copies_per_chunk=None`` → the largest power-of-two chunk whose
        canvas pixels fit ``AUTO_CHUNK_PIXEL_BUDGET``. Class names in the
        TSV are ``labelmap``'s names of the label ids, or the ids where it
        has none (no label map, as ``cpt_predict`` runs). Each task says
        how its copies are painted (``ExtractTask``).

        ``windowed=True`` reuses one base map per task (``engine/windowed``)
        for copies whose paint fits a window; ``window`` is one (h, w) or a
        ladder of them, each copy taking the smallest it fits, the others
        the full path. The mode follows the halo: one-level where
        ``halo ≥ 2·RF`` of the whole body, two-level where it covers only
        the first two stages (both exact); below both the extractor keeps
        the full path with a warning, unless ``allow_approximate``, which
        runs one-level anyway and measures ``feature_drift`` against the
        full path on the first windowed task (``last_drift``).

        ``mesh`` (``parallel/mesh.make_mesh``): each chunk's copies are
        split over its ``dp`` axis (:func:`make_sharded_extract_fn`,
        ``windowed.make_sharded_windowed_fn``), every rank running the
        same tasks and getting every output; a chunk holds at least dp
        copies and a multiple of dp (padding copies are dropped)."""
        self.model = model
        self.mesh = mesh
        self.dp = 1
        if mesh is not None:
            from cpt_tpu_torch.parallel.mesh import num_dp

            self.dp = num_dp(mesh)
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.chunk = copies_per_chunk
        self.labelmap = labelmap or {}
        self.fn = (make_extract_fn(model, cfg) if mesh is None
                   else make_sharded_extract_fn(model, cfg, mesh))
        self.windowed = windowed
        self.windowed_mode = None
        self._windowed_approx = False
        self._drift_logged = False
        if windowed:
            self.windowed_mode = self._select_mode(halo, allow_approximate)
            self.windowed = self.windowed_mode is not None
        if self.windowed:
            self.windows = wnd.ladder(window)
            self.halo = halo
            two = self.windowed_mode == "two_level"
            self.base_fn = (wnd.make_base_early_fn(model, cfg) if two
                            else wnd.make_base_features_fn(model, cfg))
            if mesh is not None:
                def make(model, cfg, **kw):
                    return wnd.make_sharded_windowed_fn(model, cfg, mesh,
                                                        two_level=two, **kw)
            else:
                make = (wnd.make_two_level_extract_fn if two
                        else wnd.make_windowed_extract_fn)
            self.wfns = [make(model, cfg, window=win, halo=halo)
                         for win in self.windows]
            # copies per route over the extractor's life: "HxW" per window,
            # "full" for the copies that fit none
            self.route_copies = {f"{h}x{w}": 0 for h, w in self.windows}
            self.route_copies["full"] = 0
        self.infer_seconds = 0.0
        self.n_copies = 0

    def _select_mode(self, halo: int, allow_approximate: bool
                     ) -> Optional[str]:
        """"one_level", "two_level", or None (the full path), as
        ``cpt_tpu/engine/extract.Extractor`` picks it."""
        split = wnd.SPLIT_STAGE
        rf_full = wnd.backbone_receptive_field(self.cfg)
        deep = len(self.cfg.backbone.stage_blocks) > split
        rf_early = (wnd.backbone_receptive_field(self.cfg, split) if deep
                    else rf_full)
        if halo >= 2 * rf_full:
            return "one_level"
        if deep and halo >= 2 * rf_early:
            logger.info("windowed extraction: two-level exact mode (halo %d "
                        ">= 2x early-stage RF %d; full RF %d would need "
                        "one-level)", halo, rf_early, rf_full)
            return "two_level"
        if allow_approximate:
            self._windowed_approx = True
            logger.warning("windowed extraction is APPROXIMATE for this "
                           "backbone (halo %d < 2x receptive-field radius %d "
                           "px); proceeding per allow_approximate=True - "
                           "feature_drift will be measured on the first task",
                           halo, rf_full)
            return "one_level"
        logger.warning("windowed extraction disabled: halo %d < 2x backbone "
                       "receptive-field radius %d px (and < 2x early-stage RF "
                       "%d for the exact two-level mode). Falling back to the "
                       "exact full-canvas path (pass allow_approximate=True "
                       "to override).", halo, rf_full, rf_early)
        return None

    def class_name(self, label: int) -> str:
        return self.labelmap.get(int(label), str(int(label)))

    def chunk_for(self, h: int, w: int, remaining: Optional[int] = None
                  ) -> int:
        """Fixed chunk if configured, else the largest power of two fitting
        the pixel budget (1..128), shrunk to the next power of two ≥
        ``remaining``; over a mesh at least dp copies, rounded up to a
        multiple of dp."""
        if self.chunk is not None:
            c = self.chunk
        else:
            c = self.budget_copies(h, w)
            c = 1 << (c.bit_length() - 1)
            if remaining is not None and remaining > 0:
                need = 1 << max(remaining - 1, 0).bit_length()
                c = min(c, max(need, 1))
        return -(-max(c, self.dp) // self.dp) * self.dp

    def budget_copies(self, h: int, w: int) -> int:
        """Copies of an (h, w) canvas that fit the pixel budget (1..128)."""
        return max(1, min(128, self.AUTO_CHUNK_PIXEL_BUDGET // (h * w)))

    def det_bucket_for(self, n_dets: int) -> int:
        """Det-slot count for a task: smallest power of two ≥ n_dets (min 8),
        capped at max_force_boxes."""
        cap = self.cfg.max_force_boxes
        n = max(min(n_dets, cap), 1)
        b = 1 << max(n - 1, 0).bit_length()
        return min(max(b, min(8, cap)), cap)

    def pick_bucket(self, h: int, w: int):
        """Smallest configured canvas bucket containing (h, w)."""
        candidates = [b for b in self.cfg.input.buckets
                      if b[0] >= h and b[1] >= w]
        if not candidates:
            return (max(h, self.cfg.input.pad_h), max(w, self.cfg.input.pad_w))
        return min(candidates, key=lambda b: b[0] * b[1])

    def _canvas(self, task: ExtractTask):
        """Task image on its canvas bucket → (device uint8 image, (h, w))."""
        ih, iw = task.image_rgb.shape[:2]
        h, w = self.pick_bucket(ih, iw)
        canvas = task.image_rgb
        if (h, w) != (ih, iw):
            canvas = np.zeros((h, w, 3), np.uint8)
            canvas[: min(ih, h), : min(iw, w)] = task.image_rgb[: h, : w]
        return torch.from_numpy(np.ascontiguousarray(canvas)).to(self.device), (h, w)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _masks(self, task: ExtractTask, sel, n: int, hw) -> tuple:
        """The masks and mask colors of the copies ``sel`` of ``task`` on
        the (h, w) canvas, ``n`` slots (padding slots paint nothing), on
        the device → (masks [n, h, w], colors [n, 4]); (None, None) for a
        task without masks."""
        if task.copy_masks is None:
            return None, None
        h, w = hw
        masks = np.zeros((n, h, w), np.uint8)
        colors = np.zeros((n, 4), np.uint8)
        tm = task.copy_masks[sel][:, :h, :w]
        masks[: len(tm), : tm.shape[1], : tm.shape[2]] = tm
        colors[: len(tm)] = task.copy_mask_colors[sel]
        return self._dev(masks), self._dev(colors)

    def base_maps(self, tasks: Sequence[ExtractTask]) -> list:
        """The windowed base maps of several tasks, one batched backbone
        call per canvas size; feed each back through ``extract_task(task,
        base=...)``. → a list aligned with ``tasks`` (Nones when not
        windowed)."""
        if not self.windowed:
            return [None] * len(tasks)
        bases: list = [None] * len(tasks)
        images, groups = [], {}
        for i, t in enumerate(tasks):
            img, hw = self._canvas(t)
            images.append(img)
            groups.setdefault(hw, []).append(i)
        t0 = time.time()
        for idxs in groups.values():
            if len(idxs) == 1:
                bases[idxs[0]] = self.base_fn(images[idxs[0]])
                continue
            out = self.base_fn(torch.stack([images[i] for i in idxs]))
            for j, i in enumerate(idxs):
                bases[i] = out[j]
        self.infer_seconds += time.time() - t0
        return bases

    def extract_task(self, task: ExtractTask, base=None):
        """→ (feats [n_copies, M, 2054], labels, scores) numpy.

        ``base``: the task's windowed base map from :meth:`base_maps`, or
        None to compute it here; the full path ignores it."""
        if self.windowed and (task.copy_rects is not None
                              or task.copy_masks is not None):
            return self._extract_task_windowed(task, base)
        m = self.det_bucket_for(len(task.det_boxes))
        dets, det_valid = pad_boxes(task.det_boxes, m)
        dets_d, det_valid_d = self._dev(dets), self._dev(det_valid)
        hw = tuple(int(v) for v in task.image_hw)
        image, (h, w) = self._canvas(task)

        n_copies = task.n_copies
        k = task.copy_rects.shape[1] if task.copy_rects is not None else 1
        all_out = ([], [], [])
        t0 = time.time()
        start = 0
        while start < n_copies:
            chunk = self.chunk_for(h, w, n_copies - start)
            end = min(start + chunk, n_copies)
            rects = np.zeros((chunk, k, 4), np.float32)
            rect_valid = np.zeros((chunk, k), bool)
            colors = np.zeros((chunk, k, 4), np.uint8)
            valid = np.zeros((chunk,), bool)
            valid[: end - start] = True
            if task.copy_rects is not None:
                rects[: end - start] = task.copy_rects[start:end]
                rect_valid[: end - start] = (
                    task.copy_rect_valid[start:end]
                    if task.copy_rect_valid is not None else True)
                colors[: end - start] = task.copy_colors_rgba[start:end]
            out = self.fn(image, self._dev(rects), self._dev(rect_valid),
                          self._dev(colors), self._dev(valid), dets_d,
                          det_valid_d, hw,
                          *self._masks(task, slice(start, end), chunk, (h, w)),
                          inclusive=task.inclusive_paint)
            # keep device tensors: the next chunk's launches queue behind
            # this one's; the host copies happen once at the end
            for buf, arr in zip(all_out, out):
                buf.append((arr, end - start))
            start = end
        gathered = tuple(
            np.concatenate([a[:n].cpu().numpy() for a, n in buf])
            for buf in all_out)
        self.infer_seconds += time.time() - t0
        self.n_copies += n_copies
        return gathered

    def _extract_task_windowed(self, task: ExtractTask, base=None):
        """The windowed path: each copy runs on the smallest window its
        paint fits, over the task's base map; copies that fit none run the
        full path. A route's chunks hold at most the pixel budget's copies
        (or ``copies_per_chunk``) and are not padded: eager PyTorch compiles
        nothing per shape, so a padding copy would be pure work. On the
        first task of an approximate run the full path runs too, and the
        drift between them is logged (``last_drift``)."""
        if self._windowed_approx and not self._drift_logged:
            self._drift_logged = True
            approx = self._extract_task_windowed(task)
            self.windowed = False
            try:
                exact = self.extract_task(task)
            finally:
                self.windowed = True
            drift = wnd.feature_drift(exact, approx)
            logger.warning("windowed feature_drift (first task, vs exact): %s",
                           drift)
            self.last_drift = drift
            return approx

        m = self.det_bucket_for(len(task.det_boxes))
        dets, det_valid = pad_boxes(task.det_boxes, m)
        dets_d, det_valid_d = self._dev(dets), self._dev(det_valid)
        hw = tuple(int(v) for v in task.image_hw)
        image, (h, w) = self._canvas(task)

        n = task.n_copies
        has_rects = task.copy_rects is not None
        k = task.copy_rects.shape[1] if has_rects else 1
        rects_all = (task.copy_rects if has_rects
                     else np.zeros((n, k, 4), np.float32))
        colors_all = (task.copy_colors_rgba
                      if task.copy_colors_rgba is not None
                      else np.zeros((n, k, 4), np.uint8))
        rv_all = (task.copy_rect_valid if task.copy_rect_valid is not None
                  else np.full((n, k), has_rects))
        # the window's target: the union of the rects and the mask's extent
        target = rects_all
        if task.copy_masks is not None:
            mb = wnd.mask_bboxes(task.copy_masks)
            target = np.concatenate([target, mb], 1) if has_rects else mb
        # route each copy to the smallest window its paint fits
        n_win = len(self.windows)
        assign = np.full(n, n_win, np.int32)
        origins_per = []
        for wi, win in enumerate(self.windows):
            org, fits = wnd.window_origins(target, win, (h, w), self.halo)
            origins_per.append(org)
            assign[(assign == n_win) & fits] = wi
        routes = [(np.nonzero(assign == wi)[0], wi) for wi in range(n_win + 1)]
        for (idx, wi), key in zip(routes, self.route_copies):
            self.route_copies[key] += len(idx)

        t0 = time.time()
        if base is None and (assign < n_win).any():
            base = self.base_fn(image)
        parts = []
        for idx, wi in routes:
            win = self.windows[wi] if wi < n_win else (h, w)
            at = 0
            while at < len(idx):
                chunk = min(self.chunk or self.budget_copies(*win),
                            len(idx) - at)
                sel = idx[at:at + chunk]
                # over a mesh, repeats of the last copy (not valid) fill
                # the chunk to a multiple of dp
                pad = np.concatenate([sel, np.repeat(sel[-1:],
                                                     -len(sel) % self.dp)])
                valid = np.arange(len(pad)) < len(sel)
                args = (self._dev(rects_all[pad]), self._dev(rv_all[pad]),
                        self._dev(colors_all[pad]), self._dev(valid), dets_d,
                        det_valid_d, hw,
                        *self._masks(task, pad, len(pad), (h, w)))
                if wi < n_win:
                    out = self.wfns[wi](image, base, origins_per[wi][pad],
                                        *args, inclusive=task.inclusive_paint)
                else:
                    out = self.fn(image, *args, inclusive=task.inclusive_paint)
                parts.append((sel, tuple(o[:len(sel)] for o in out)))
                at += chunk
        # the device outputs are read once all chunks are queued
        feats = np.zeros((n, m, parts[0][1][0].shape[2]), np.float32)
        labels = np.zeros((n, m), np.int64)
        scores = np.zeros((n, m), np.float32)
        for sel, (f, lab, sc) in parts:
            feats[sel] = f.cpu().numpy()
            labels[sel] = lab.cpu().numpy()
            scores[sel] = sc.cpu().numpy()
        self.infer_seconds += time.time() - t0
        self.n_copies += n
        return feats, labels, scores

    def boxlists_for(self, task: ExtractTask, feats, labels, scores
                     ) -> List[List[dict]]:
        n_dets = min(len(task.det_boxes), self.cfg.max_force_boxes)
        objs = []
        for c in range(task.n_copies):
            objs.append([{
                "rect": [float(v) for v in task.det_boxes[b]],
                "class": self.class_name(labels[c, b]),
                "conf": float(scores[c, b]),
                "feature": encode_feature(feats[c, b]),
            } for b in range(n_dets)])
        return objs

    def run(self, tasks: Iterable[ExtractTask], out_tsv: str,
            base_batch: Optional[int] = None,
            payload_fn: Optional[Callable] = None) -> None:
        """Write one TSV row per task, its payload laid out by
        ``payload_fn(task, boxlists)`` (default :func:`refcoco_payload`;
        the ``*_payload`` function of the task otherwise); consecutive
        queries over the same image and boxes share one device batch. On the windowed path the
        base passes of up to ``base_batch`` (default ``RUN_BASE_BATCH``)
        consecutive groups run as one batched call (:meth:`base_maps`); 1
        keeps one pass a task."""
        payload_fn = payload_fn or refcoco_payload
        max_copies = self.chunk or 64
        if base_batch is None:
            base_batch = self.RUN_BASE_BATCH if self.windowed else 1
        base_batch = max(base_batch, 1)

        def blocks(groups):
            block = []
            for g in groups:
                block.append(g)
                if len(block) >= base_batch:
                    yield block
                    block = []
            if block:
                yield block

        def rows():
            for block in blocks(_group_consecutive(tasks, max_copies)):
                merged = [merge_tasks(g) for g in block]
                bases = (self.base_maps(merged) if len(merged) > 1
                         else [None])
                for group, task_m, base in zip(block, merged, bases):
                    feats, labels, scores = self.extract_task(task_m, base)
                    at = 0
                    for task in group:
                        n = task.n_copies
                        objs = self.boxlists_for(task, feats[at:at + n],
                                                 labels[at:at + n],
                                                 scores[at:at + n])
                        yield [task.key, json.dumps(payload_fn(task, objs))]
                        at += n

        if self.mesh is None:
            tsv_writer(rows(), out_tsv)
            return
        from cpt_tpu_torch.parallel.distributed import is_main_process

        if is_main_process():
            tsv_writer(rows(), out_tsv)
        else:   # the other ranks run the same chunks and write nothing
            for _ in rows():
                pass


def refcoco_payload(task: ExtractTask, objs) -> dict:
    rect_lists = [[r.tolist() for r, v in zip(rs, vs) if v]
                  for rs, vs in zip(task.copy_rects, task.copy_rect_valid)]
    return {"objects": [objs, task.caption, task.copy_color_names,
                        rect_lists]}


def gqa_payload(task: ExtractTask, objs) -> dict:
    """GQA's row: the one copy's boxes, then [positions_and_colors] for the
    question rewrite (what ``data/gqa.GQACPTData`` reads)."""
    return {"objects": [objs[0], [task.meta["positions_and_colors"]]]}


def vcr_payload(task: ExtractTask, objs) -> dict:
    """VCR's row: the one copy's boxes, then [obj_colors, obj_names]
    (what ``data/vcr.VCRCPTData.load_features`` reads)."""
    return {"objects": [objs[0], [task.meta["obj_colors"],
                                  task.meta["obj_names"]]]}


def vg_payload(task: ExtractTask, objs) -> dict:
    """VG's row, the reference layout [[boxlist], color names, [subject,
    object] names, relation] (``inference_vg.py:179-181``, read by
    ``vg_cpt_dataset.py:103-121`` and ``data/vg.VGCPTData``)."""
    return {"objects": [[objs[0]], task.meta["colors"],
                        task.meta["subj_obj_names"],
                        task.meta["rel_label"]]}


def plain_payload(task: ExtractTask, objs) -> dict:
    """The uncolored row: the boxes alone."""
    return {"objects": objs[0]}


def refcoco_task(key: str, image_rgb: np.ndarray, image_hw, det_boxes,
                 caption: str, color=("red", (240, 0, 30, 127))) -> ExtractTask:
    """RefCOCO scheme: one copy per candidate det, single color
    (``refcocodataset.py:216,260-288``)."""
    name, rgba = color
    n = len(det_boxes)
    det_boxes = np.asarray(det_boxes, np.float32)
    return ExtractTask(
        key=key, image_rgb=image_rgb, image_hw=image_hw,
        det_boxes=det_boxes, caption=caption,
        copy_rects=det_boxes[:, None, :],
        copy_rect_valid=np.ones((n, 1), bool),
        copy_colors_rgba=np.tile(np.asarray(rgba, np.uint8), (n, 1, 1)),
        copy_color_names=[[name]] * n,
    )


def refcoco_mask_task(key: str, image_rgb: np.ndarray, image_hw, det_boxes,
                      det_masks, caption: str,
                      color=("red", (240, 0, 30, 127))) -> ExtractTask:
    """RefCOCO SEG: the candidates carry segmentation masks and each copy
    paints its mask instead of its rect (``refcocodataset.py:241-247``,
    ``"rle" in rawdets[0]``, and the ``draw_rectangles`` mask branch
    :294-300). ``copy_rects`` keep the boxes for the payload and the
    windowed routing, painted at alpha 0: an exact no-op under the integer
    blend ((img·255 + 127) // 255 == img). ``det_masks``: [n, H, W] binary
    masks (RLE decoded on the host)."""
    name, rgba = color
    n = len(det_boxes)
    det_boxes = np.asarray(det_boxes, np.float32)
    no_paint = np.asarray((rgba[0], rgba[1], rgba[2], 0), np.uint8)
    return ExtractTask(
        key=key, image_rgb=image_rgb, image_hw=image_hw,
        det_boxes=det_boxes, caption=caption,
        copy_rects=det_boxes[:, None, :],
        copy_rect_valid=np.ones((n, 1), bool),
        copy_colors_rgba=np.tile(no_paint, (n, 1, 1)),
        copy_color_names=[[name]] * n,
        copy_masks=np.asarray(det_masks, np.uint8),
        copy_mask_colors=np.tile(np.asarray(rgba, np.uint8), (n, 1)),
    )


def merge_tasks(tasks: List[ExtractTask]) -> ExtractTask:
    """Concatenate the copies of several queries over the same image and
    det boxes into one task."""
    t0 = tasks[0]
    if len(tasks) == 1:
        return t0
    for t in tasks[1:]:
        if not (t.image_rgb is t0.image_rgb
                or np.array_equal(t.image_rgb, t0.image_rgb)):
            raise ValueError("grouped tasks must share the image")
        if not np.array_equal(t.det_boxes, t0.det_boxes):
            raise ValueError("grouped tasks must share det boxes")
        if t.inclusive_paint != t0.inclusive_paint:
            raise ValueError("grouped tasks must share the paint convention")

    def cat(field):
        vals = [getattr(t, field) for t in tasks]
        if any(v is None for v in vals):
            if not all(v is None for v in vals):
                raise ValueError(f"mixed {field} in group")
            return None
        return np.concatenate(vals)

    return dataclasses.replace(
        t0, key="|".join(t.key for t in tasks),
        copy_rects=cat("copy_rects"),
        copy_rect_valid=cat("copy_rect_valid"),
        copy_colors_rgba=cat("copy_colors_rgba"),
        copy_masks=cat("copy_masks"),
        copy_mask_colors=cat("copy_mask_colors"))


def _group_consecutive(tasks: Iterable[ExtractTask], max_copies: int):
    """Yield lists of consecutive tasks sharing an image (identity check)
    and det boxes, capped at max_copies."""
    group: List[ExtractTask] = []
    n = 0
    for task in tasks:
        same = (group and task.image_rgb is group[0].image_rgb
                and np.array_equal(task.det_boxes, group[0].det_boxes))
        if same and n + task.n_copies <= max_copies:
            group.append(task)
            n += task.n_copies
        else:
            if group:
                yield group
            group = [task]
            n = task.n_copies
    if group:
        yield group
