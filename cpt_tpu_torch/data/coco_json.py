"""COCO-instance-json and VOC-XML detection datasets → vg-TSV bridge (the
port's copy of ``cpt_tpu/data/coco_json.py``).

The reference loads plain COCO/VOC formats through torchvision +
maskrcnn_benchmark dataset classes
(``prompt_feat/maskrcnn_benchmark/data/datasets/coco.py:1-104``,
``voc.py:1-214``).  The detector tools consume the od/vg-TSV
format natively (``data/vg_tsv.py``), so the standard benchmarks are
bridged by converting once: annotation semantics below replicate the
reference loaders exactly —

* COCO: ids sorted, images without valid annotations dropped
  (``has_valid_annotation``: empty, or all boxes with w/h ≤ 1), crowd
  annotations filtered, category ids mapped to contiguous 1-based ids in
  ``getCatIds`` (ascending id) order, xywh → inclusive xyxy
  (``BoxList.convert``: x2 = x + max(w − 1, 0)), clip to image;
* VOC: one xml per image, class list fixed to the 20 PASCAL classes,
  ``difficult`` objects kept but flagged (the evaluator ignores them),
  1-based pixel coords → 0-based inclusive xyxy (``voc.py:86-92``).

No pycocotools/torchvision dependency — plain json / ElementTree.
"""
from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

PASCAL_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


def _has_valid_annotation(anno: List[dict]) -> bool:
    """Reference ``coco.py:18-36`` (keypoint branch not applicable to the
    detection TSVs)."""
    if len(anno) == 0:
        return False
    if all(any(o <= 1 for o in obj["bbox"][2:]) for obj in anno):
        return False
    return True


def load_coco_json(ann_file: str,
                   remove_images_without_annotations: bool = True):
    """Parse a COCO instances json → (images, targets, labelmap).

    Returns ``images``: [{id, file_name, width, height}] in sorted-id
    order; ``targets``: {image_id: {"objects": [{"rect", "class"}]}} in
    the vg-TSV label schema; ``labelmap``: {"label_to_idx": {name: 1-based
    contiguous id in ascending COCO-category-id order}}.
    """
    coco = json.load(open(ann_file))
    cats = sorted(coco["categories"], key=lambda c: c["id"])
    cat_name = {c["id"]: c["name"] for c in cats}
    label_to_idx = {c["name"]: i + 1 for i, c in enumerate(cats)}

    by_img: Dict[int, List[dict]] = {}
    for ann in coco.get("annotations", []):
        by_img.setdefault(ann["image_id"], []).append(ann)

    images = sorted(coco["images"], key=lambda im: im["id"])
    kept, targets = [], {}
    for im in images:
        anno = by_img.get(im["id"], [])
        if remove_images_without_annotations and not _has_valid_annotation(
                anno):
            continue
        objects = []
        for obj in anno:
            if obj.get("iscrowd", 0):
                continue
            x, y, bw, bh = obj["bbox"]
            # xywh → inclusive xyxy (BoxList.convert, TO_REMOVE=1), then
            # clip_to_image
            x2 = x + max(bw - 1, 0)
            y2 = y + max(bh - 1, 0)
            rect = [max(0.0, float(x)), max(0.0, float(y)),
                    min(float(im["width"]) - 1, float(x2)),
                    min(float(im["height"]) - 1, float(y2))]
            if rect[2] <= rect[0] or rect[3] <= rect[1]:
                continue  # remove_empty=True
            objects.append({"rect": rect, "class": cat_name[obj["category_id"]]})
        kept.append(im)
        targets[im["id"]] = {"objects": objects}
    return kept, targets, {"label_to_idx": label_to_idx}


def coco_to_tsv(ann_file: str, img_dir: str, out_root: str,
                name: str = "coco") -> str:
    """COCO instances json + image dir → vg-TSV dataset directory
    (yaml returned); consumable by ``train_detector/test_detector --tsv``.
    """
    from PIL import Image

    from cpt_tpu_torch.data.vg_tsv import write_detection_tsv

    images, targets, labelmap = load_coco_json(ann_file)
    arrays, labels = {}, {}
    for im in images:
        key = str(im["id"])
        arr = np.asarray(
            Image.open(os.path.join(img_dir, im["file_name"])).convert("RGB"))
        arrays[key] = arr
        labels[key] = targets[im["id"]]
    # insertion order = sorted numeric image ids (string sort would put
    # "11" before "3")
    return write_detection_tsv(out_root, name, arrays, labels, labelmap,
                               sort_keys=False)


def load_voc_xml(xml_file: str) -> List[dict]:
    """One VOC annotation xml → vg-TSV objects (reference ``voc.py:74-95``:
    1-based pixel coords → 0-based inclusive xyxy; difficult kept,
    flagged)."""
    root = ET.parse(xml_file).getroot()
    objects = []
    for obj in root.iter("object"):
        bb = obj.find("bndbox")
        rect = [float(bb.find("xmin").text) - 1,
                float(bb.find("ymin").text) - 1,
                float(bb.find("xmax").text) - 1,
                float(bb.find("ymax").text) - 1]
        objects.append({
            "rect": rect,
            "class": obj.find("name").text.lower().strip(),
            "difficult": int((obj.find("difficult").text or "0")
                             if obj.find("difficult") is not None else 0),
        })
    return objects


def voc_to_tsv(voc_root: str, split: str, out_root: str,
               name: Optional[str] = None) -> str:
    """A PASCAL-VOC year directory (Annotations/ JPEGImages/
    ImageSets/Main/{split}.txt) → vg-TSV dataset directory."""
    from PIL import Image

    from cpt_tpu_torch.data.vg_tsv import write_detection_tsv

    name = name or f"voc_{split}"
    with open(os.path.join(voc_root, "ImageSets", "Main",
                           f"{split}.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    arrays, labels = {}, {}
    for k in ids:
        arrays[k] = np.asarray(Image.open(
            os.path.join(voc_root, "JPEGImages", f"{k}.jpg")).convert("RGB"))
        labels[k] = {"objects": load_voc_xml(
            os.path.join(voc_root, "Annotations", f"{k}.xml"))}
    labelmap = {"label_to_idx": {c: i + 1
                                 for i, c in enumerate(PASCAL_CLASSES)}}
    return write_detection_tsv(out_root, name, arrays, labels, labelmap)
