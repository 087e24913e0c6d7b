"""Stage-1 task builders: each task's colored-prompt ``ExtractTask`` (port
of ``cpt_tpu/data/stage1_tasks.py``).

* ``gqa_mark_task`` paints the parsed question entities' boxes in the
  6-color palette, one copy a question; its meta carries the rewrite
  positions (``gqadataset.py:107-179``; painted with inclusive extents
  ``max(x2-x1+1, 1)``, ``Image.new('RGBA', (x2-x1+1, y2-y1+1))`` at
  gqadataset.py:153, so its tasks set ``inclusive_paint``).
* ``vg_pair_task`` paints the subject red and the object blue, one copy a
  pair (``vgdataset.py:93,134-158``).
* ``plain_task`` paints nothing (GQA's plain features, ImgDataset).
* ``parse_gqa_marks`` grounds question words to detection boxes by class
  name (the functional stand-in of ``other/parse_gqa/myparse.py``'s
  output, ``to_mark.json``).

VCR: ``vcr_color_task`` paints the segmentation masks of the entities a VCR
question refers to with up to ``color_d`` palette colors, and its meta
carries the obj_colors / obj_names dicts keyed by sorted entity lists
(``vcrdataset.py:120-288``). It is two steps: :func:`rasterize_polygon`
turns each member's polygon into a mask (with Pillow, as the reference
draws it), then :func:`vcr_color_task_from_masks` assigns the colors,
names the groups and composites the paint on the host. The second step
needs no Pillow, so a caller that already holds masks calls it directly.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cpt_tpu_torch.data.prompts import (CROSS_TASK_COLORS, VG_PAIR_COLORS,
                                        VG_PAIR_COLOR_NAMES, vcr_entity_key)
from cpt_tpu_torch.engine.extract import ExtractTask


def gqa_mark_task(q_id: str, image_rgb: np.ndarray, image_hw, det_boxes,
                  to_mark: Sequence[Tuple[Sequence[float], Sequence[int]]],
                  n_color: int = 1,
                  palette=CROSS_TASK_COLORS) -> ExtractTask:
    """``to_mark``: [[box xyxy, char_positions], ...] from the question
    parser; up to ``n_color`` entities painted (one copy per question)."""
    marks = list(to_mark)[:n_color]
    k = max(len(marks), 1)
    rects = np.zeros((1, k, 4), np.float32)
    valid = np.zeros((1, k), bool)
    colors = np.zeros((1, k, 4), np.uint8)
    positions_and_colors = []
    for i, (box, char_pos) in enumerate(marks):
        rects[0, i] = box
        valid[0, i] = True
        colors[0, i] = palette[i][1]
        positions_and_colors.append([list(np.atleast_1d(char_pos).tolist()),
                                     palette[i][0]])
    return ExtractTask(
        key=str(q_id), image_rgb=image_rgb, image_hw=image_hw,
        det_boxes=np.asarray(det_boxes, np.float32),
        copy_rects=rects, copy_rect_valid=valid, copy_colors_rgba=colors,
        meta={"positions_and_colors": positions_and_colors},
        inclusive_paint=True,
    )


def vg_pair_task(img_name: str, image_rgb: np.ndarray, image_hw, det_boxes,
                 subj_idx: int, obj_idx: int, subj_name: str, obj_name: str,
                 rel_label: str, pair_colors=VG_PAIR_COLORS,
                 color_names=VG_PAIR_COLOR_NAMES) -> ExtractTask:
    """One copy per (subject, object) pair: subject red, object blue
    (``vgdataset.py:134-158``); key ``<img>_<s>_<o>``."""
    det_boxes = np.asarray(det_boxes, np.float32)
    rects = np.stack([det_boxes[subj_idx], det_boxes[obj_idx]])[None]
    colors = np.asarray(pair_colors, np.uint8)[None]
    return ExtractTask(
        key=f"{img_name}_{subj_idx}_{obj_idx}",
        image_rgb=image_rgb, image_hw=image_hw, det_boxes=det_boxes,
        copy_rects=rects, copy_rect_valid=np.ones((1, 2), bool),
        copy_colors_rgba=colors,
        meta={"subj_obj_names": [subj_name, obj_name],
              "colors": list(color_names), "rel_label": rel_label},
    )


def plain_task(img_key: str, image_rgb: np.ndarray, image_hw, det_boxes
               ) -> ExtractTask:
    """Uncolored extraction (GQA's plain features, ImgDataset): one copy,
    no paint."""
    return ExtractTask(
        key=str(img_key), image_rgb=image_rgb, image_hw=image_hw,
        det_boxes=np.asarray(det_boxes, np.float32),
        copy_rects=np.zeros((1, 1, 4), np.float32),
        copy_rect_valid=np.zeros((1, 1), bool),
        copy_colors_rgba=np.zeros((1, 1, 4), np.uint8),
    )


STOPWORDS = {
    "is", "are", "the", "a", "an", "what", "which", "who", "where", "how",
    "there", "that", "this", "of", "on", "in", "to", "and", "or", "do",
    "does", "you", "see", "any", "color", "kind", "type",
}


def parse_gqa_marks(question: str, det_boxes: Sequence[Sequence[float]],
                    det_names: Sequence[str], max_marks: int = 1
                    ) -> List[Tuple[List[float], List[int]]]:
    """Ground question words to detection boxes by word / class-name match
    (a word, or the word less a plural "s", equal to a class name; stop
    words skipped; each box once) → [[box, [end char position]], ...], the
    layout of the reference parser's ``to_mark.json``."""
    marks = []
    words = question.lower().split()
    char_pos = 0
    positions = []
    for wt in words:
        positions.append(char_pos)
        char_pos += len(wt) + 1
    used = set()
    for wi, word in enumerate(words):
        stripped = word.strip("?.,")
        if stripped in STOPWORDS:
            continue
        for di, name in enumerate(det_names):
            if di in used:
                continue
            if stripped == name.lower() or stripped == name.lower() + "s":
                end = positions[wi] + len(stripped)
                marks.append(([float(v) for v in det_boxes[di]], [end]))
                used.add(di)
                break
        if len(marks) >= max_marks:
            break
    return marks


def rasterize_polygon(polygon, h: int, w: int) -> np.ndarray:
    """Polygon(s) → binary mask [h, w]. Accepts one part [[x, y], ...] or
    a list of parts (the reference's multi-part segms). Fill-only Pillow
    rasterization, as the reference draws ``polygon(..., fill=color)`` with
    no outline (vcrdataset.py:277-283): Pillow's rule for float vertices is
    its own, so no other rasterizer gives the same pixels."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    if len(polygon) and (not len(polygon[0])
                         or hasattr(polygon[0][0], "__len__")):
        parts = polygon          # list of parts (possibly with empty members)
    else:
        parts = [polygon] if len(polygon) else []
    for part in parts:
        if not len(part):
            continue
        if len(part) < 2:
            part = list(part) + [part[0]]
        draw.polygon([(float(x), float(y)) for x, y in part], fill=1)
    return np.asarray(img, np.uint8)


def vcr_entity_groups(ann: dict) -> Tuple[List[List[int]], List[List[int]]]:
    """First-appearance entity groups of the reference's mixed-token VCR
    sentences → (vis_groups, txt_groups): vis from question+answers (color
    assignment, ``vcrdataset.py:184-188``), txt adds the rationale-only
    groups (``:181-183``). Groups carry sorted member ids (the reference's
    ``lst2str(sorted(x))`` identity); first appearance is the
    deterministic stand-in for the reference's set order."""
    def collect(sents, seen, out):
        for sent in sents:
            for tok in sent:
                if isinstance(tok, list):
                    key = tuple(sorted(tok))
                    if key not in seen:
                        seen.add(key)
                        out.append(sorted(tok))

    seen: set = set()
    vis: List[List[int]] = []
    collect([ann["question"]] + list(ann["answers"]), seen, vis)
    txt = list(vis)
    collect(list(ann.get("rationales", [])), seen, txt)
    return vis, txt


def vcr_color_task(q_id: str, image_rgb: np.ndarray, image_hw, det_boxes,
                   entity_ids: Sequence[Sequence[int]],
                   entity_polygons: Dict[int, Sequence[Sequence[float]]],
                   entity_names: Dict[int, str],
                   color_d: int = 6, palette=CROSS_TASK_COLORS,
                   txt_entity_ids: Optional[Sequence[Sequence[int]]] = None
                   ) -> ExtractTask:
    """The reference's ``construct_to_mark_and_color``
    (``vcrdataset.py:173-255``) from polygons: each member of
    ``entity_ids`` rasterized (a member without a polygon paints nothing),
    then :func:`vcr_color_task_from_masks`."""
    h, w = image_rgb.shape[:2]
    masks = {i: rasterize_polygon(entity_polygons.get(i, []), h, w)
             for ids in entity_ids for i in ids}
    return vcr_color_task_from_masks(q_id, image_rgb, image_hw, det_boxes,
                                     entity_ids, masks, entity_names, color_d,
                                     palette, txt_entity_ids)


def vcr_color_task_from_masks(q_id: str, image_rgb: np.ndarray, image_hw,
                              det_boxes, entity_ids: Sequence[Sequence[int]],
                              entity_masks: Dict[int, np.ndarray],
                              entity_names: Dict[int, str],
                              color_d: int = 6, palette=CROSS_TASK_COLORS,
                              txt_entity_ids: Optional[Sequence[Sequence[int]]]
                              = None) -> ExtractTask:
    """Colors, names and the composited image from one binary mask
    [h, w] per member of ``entity_ids``:

    * vis sweep over ``entity_ids`` (the question+answers groups): each
      member whose det box value is not yet painted gets the group's
      palette color. The reference dedups by the box, not the member id
      (``d not in ret_to_mark_dets``, :226-231), so a member sharing a box
      with an earlier-painted member is skipped and carries no color. The
      color counter advances only when a group painted someone, and stops
      at ``color_d``.
    * txt sweep over ``txt_entity_ids`` (default ``entity_ids``; the
      reference also includes rationale-only groups): names follow the
      person/people/<cls>s/objects rule (:237-249); a group carries a color
      word only when every member wears the same paint (:250-253).
    * the masks are alpha-blended one after another on the host, the
      reference's per-member overlay pastes in the same order, so the task
      is one copy with no rect to paint (``copy_rect_valid`` False).

    Callers supply the groups in first-appearance order
    (:func:`vcr_entity_groups`)."""
    painted: Dict[int, str] = {}   # member id → color name (vis sweep)
    painted_boxes: List[Tuple[float, ...]] = []
    det_boxes_arr = np.asarray(det_boxes, np.float32)
    color_cnt = 0
    masks, mask_colors = [], []
    for ids in entity_ids:
        if color_cnt >= color_d:
            continue
        painted_any = False
        for i in ids:
            box = tuple(float(v) for v in det_boxes_arr[i][:4])
            if box in painted_boxes:
                continue
            masks.append(entity_masks[i])
            mask_colors.append(palette[color_cnt][1])
            painted_boxes.append(box)
            painted[i] = palette[color_cnt][0]
            painted_any = True
        if painted_any:
            color_cnt += 1

    obj_colors: Dict[str, str] = {}
    obj_names: Dict[str, str] = {}
    for ids in (entity_ids if txt_entity_ids is None else txt_entity_ids):
        key = vcr_entity_key(ids)
        if key in obj_names:
            continue
        clses = [entity_names[i] for i in ids]
        if len(set(clses)) == 1:
            if clses[0] == "person":
                obj_names[key] = "person" if len(clses) == 1 else "people"
            else:
                obj_names[key] = (clses[0] if len(clses) == 1
                                  else clses[0] + "s")
        else:
            obj_names[key] = "objects"
        member_colors = {painted.get(i, "none") for i in ids}
        if len(member_colors) == 1 and "none" not in member_colors:
            obj_colors[key] = next(iter(member_colors))

    image = image_rgb.copy()
    for m, c in zip(masks, mask_colors):
        alpha = np.asarray(m).astype(np.int32) * c[3]
        fg = np.asarray(c[:3], np.int32)
        image = ((fg[None, None] * alpha[..., None]
                  + image.astype(np.int32) * (255 - alpha[..., None]) + 127)
                 // 255).astype(np.uint8)

    return ExtractTask(
        key=str(q_id), image_rgb=image, image_hw=image_hw,
        det_boxes=det_boxes_arr,
        copy_rects=np.zeros((1, 1, 4), np.float32),
        copy_rect_valid=np.zeros((1, 1), bool),
        copy_colors_rgba=np.zeros((1, 1, 4), np.uint8),
        meta={"obj_colors": obj_colors, "obj_names": obj_names},
    )
