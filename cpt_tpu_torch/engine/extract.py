"""Stage-1 feature extraction: image → colored copies → detector →
``predictions.tsv`` (port of the full, single-device path of
``cpt_tpu/engine/extract.py``), and RPN-mode detection
(:func:`make_detect_fn`).

The base image is uploaded once per query; all candidate-region copies are
rendered on the device (``ops/render``) and run through the detector in
chunks of copies. Output rows are bit-compatible with the reference TSV
interchange (``inference_ref.py:95-192``).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN, region_features_2054
from cpt_tpu_torch.models.detector.config import DetectorConfig
from cpt_tpu_torch.ops.render import paste_rects, to_detector_input
from cpt_tpu_torch.structures.boxes import pad_boxes
from cpt_tpu_torch.utils.tsv import encode_feature, tsv_writer


@dataclasses.dataclass
class ExtractTask:
    """One query: base image + candidate boxes + per-copy paint ops.

    Each copy paints up to K rects (``copy_rects [n_copies, K, 4]`` +
    ``copy_rect_valid [n_copies, K]``) and/or one binary mask
    (``copy_masks [n_copies, H, W]``) with per-op RGBA colors.
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

    @property
    def n_copies(self) -> int:
        if self.copy_rects is not None:
            return len(self.copy_rects)
        if self.copy_masks is not None:
            return len(self.copy_masks)
        return 1  # plain (uncolored) extraction


def make_extract_fn(model: AttrRCNN, cfg: DetectorConfig):
    """Chunk extractor over C copies with K rects each, painted ``[x1, x2)``
    (the RefCOCO convention). Tensors live on the model's device; ``hw`` is
    the true (h, w)."""

    @torch.inference_mode()
    def fn(image_u8, rects, rect_valid, colors, copy_valid, dets, det_valid,
           hw):
        copies = paste_rects(image_u8, rects, colors, rect_valid)
        x = to_detector_input(copies, cfg.input.pixel_mean, dtype=model.dtype)
        out = model.forward_batch_force(x, hw, dets, det_valid)
        feats = region_features_2054(out["box_features"].float(),
                                     out["boxes"], hw)
        feats = torch.where(copy_valid[:, None, None], feats,
                            torch.zeros_like(feats))
        return feats, out["labels"], out["scores"]

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

    def __init__(self, model: AttrRCNN, cfg: DetectorConfig,
                 copies_per_chunk: Optional[int] = 4):
        """``copies_per_chunk=None`` → the largest power-of-two chunk whose
        canvas pixels fit ``AUTO_CHUNK_PIXEL_BUDGET``. Class names in the
        TSV are the label ids (no label map, as ``cpt_predict`` runs)."""
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.chunk = copies_per_chunk
        self.fn = make_extract_fn(model, cfg)
        self.infer_seconds = 0.0
        self.n_copies = 0

    def chunk_for(self, h: int, w: int, remaining: Optional[int] = None
                  ) -> int:
        """Fixed chunk if configured, else the largest power of two fitting
        the pixel budget (1..128), shrunk to the next power of two ≥
        ``remaining``."""
        if self.chunk is not None:
            return self.chunk
        c = self.AUTO_CHUNK_PIXEL_BUDGET // (h * w)
        c = max(1, min(128, c))
        c = 1 << (c.bit_length() - 1)
        if remaining is not None and remaining > 0:
            need = 1 << max(remaining - 1, 0).bit_length()
            c = min(c, max(need, 1))
        return c

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

    def extract_task(self, task: ExtractTask):
        """→ (feats [n_copies, M, 2054], labels, scores) numpy."""
        if task.copy_masks is not None:
            raise NotImplementedError(
                "mask-painted copies (the RefCOCO SEG task) are not ported")
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
                          det_valid_d, hw)
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

    def boxlists_for(self, task: ExtractTask, feats, labels, scores
                     ) -> List[List[dict]]:
        n_dets = min(len(task.det_boxes), self.cfg.max_force_boxes)
        objs = []
        for c in range(task.n_copies):
            objs.append([{
                "rect": [float(v) for v in task.det_boxes[b]],
                "class": str(int(labels[c, b])),
                "conf": float(scores[c, b]),
                "feature": encode_feature(feats[c, b]),
            } for b in range(n_dets)])
        return objs

    def run(self, tasks: Iterable[ExtractTask], out_tsv: str) -> None:
        """Write one RefCOCO-layout TSV row per task; consecutive queries
        over the same image and boxes share one device batch."""
        max_copies = self.chunk or 64

        def rows():
            for group in _group_consecutive(tasks, max_copies):
                feats, labels, scores = self.extract_task(merge_tasks(group))
                at = 0
                for task in group:
                    n = task.n_copies
                    objs = self.boxlists_for(task, feats[at:at + n],
                                             labels[at:at + n],
                                             scores[at:at + n])
                    yield [task.key, json.dumps(refcoco_payload(task, objs))]
                    at += n

        tsv_writer(rows(), out_tsv)


def refcoco_payload(task: ExtractTask, objs) -> dict:
    rect_lists = [[r.tolist() for r, v in zip(rs, vs) if v]
                  for rs, vs in zip(task.copy_rects, task.copy_rect_valid)]
    return {"objects": [objs, task.caption, task.copy_color_names,
                        rect_lists]}


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
