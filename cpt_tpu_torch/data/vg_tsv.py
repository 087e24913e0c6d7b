"""VG-TSV / od-TSV detection datasets, the VinVL detector's native format
(the port's copy of ``cpt_tpu/data/vg_tsv.py``).

Bit-compatible loaders for the reference's TSV dataset family
(``prompt_feat/maskrcnn_benchmark/data/datasets/tsv_dataset.py``,
``od_tsv.py``, ``vg_tsv.py:1-118``, ``utils/label_loader.py``): an image
TSV (rows ``[key, ..., base64 jpg]``), a label TSV (rows ``[key, json]``
with ``{"objects": [{"rect", "class", "attributes"?}], "relations":
[{"subj_id", "obj_id", "class"}]}``), optional hw TSV and linelist file,
bound together by a yaml descriptor with a ``labelmap`` jsondict
(``label_to_idx`` / ``attribute_to_idx`` / ``predicate_to_idx``;
background/no_attribute/no_relation inserted at index 0, reference
``relation_tsv.py:40-59``).

Targets are numpy dicts (the padded-static equivalent of BoxList):
``boxes`` xyxy float32, ``labels``, optional ``attributes`` [N, 16],
``relation_triplets`` [R, 3] and ``pred_labels`` [N, N]
(``label_loader.py:93-116``). ``clip_to_image`` uses the inclusive-xyxy
TO_REMOVE=1 convention like everything else in this repo.

Also ships the VG relation frequency-prior computation
(``vg_tsv.py:72-108``) used by MOTIF/IMP variants.
"""
from __future__ import annotations

import base64
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from cpt_tpu_torch.utils.tsv import TSVFile

MAX_ATTRIBUTES = 16  # label_loader.py:69 ("maximal number of attributes")


def img_from_base64(b64: str) -> np.ndarray:
    """Base64 jpg/png → RGB uint8 array (reference uses cv2 BGR; the
    port's input pipeline is RGB end-to-end, conversion handled by
    ``ops.render.to_detector_input``). Decoded by ``utils/image_codec``
    (Pillow's pixels, without Pillow)."""
    from cpt_tpu_torch.utils.image_codec import decode

    return decode(base64.b64decode(b64))


def load_linelist_file(path: Optional[str]) -> Optional[List[int]]:
    if path is None:
        return None
    with open(path) as f:
        return [int(line) for line in f if line.strip()]


def find_file_path_in_yaml(name, root):
    if name is None:
        return None
    if os.path.isfile(name):
        return name
    return os.path.join(root, name)


def clip_boxes_to_image(boxes: np.ndarray, w: int, h: int,
                        to_remove: int = 1) -> np.ndarray:
    out = boxes.copy()
    out[:, 0::2] = np.clip(out[:, 0::2], 0, w - to_remove)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, h - to_remove)
    return out


class DetectionTSVDataset:
    """od-TSV: generic TSV object-detection dataset (``od_tsv.py:9-52``)."""

    def __init__(self, yaml_file: str, attribute_on: bool = False,
                 is_load_label: bool = True):
        import yaml as _yaml

        self.root = os.path.dirname(os.path.abspath(yaml_file))
        self.cfg = _yaml.safe_load(open(yaml_file)) or {}
        self.attribute_on = attribute_on
        self.is_load_label = is_load_label

        self.img_tsv = TSVFile(find_file_path_in_yaml(self.cfg["img"],
                                                      self.root))
        label = find_file_path_in_yaml(self.cfg.get("label"), self.root)
        self.label_tsv = TSVFile(label) if label else None
        hw = find_file_path_in_yaml(self.cfg.get("hw"), self.root)
        self.hw_tsv = TSVFile(hw) if hw else None
        self.line_list = load_linelist_file(
            find_file_path_in_yaml(self.cfg.get("linelist"), self.root))
        self.linelist_file = self.cfg.get("linelist") or ""

        self.class_to_ind: Dict[str, int] = {}
        if is_load_label:
            jd_path = find_file_path_in_yaml(
                self.cfg.get("labelmap", self.cfg.get("jsondict")), self.root)
            jd = json.load(open(jd_path))
            self.class_to_ind = dict(jd["label_to_idx"])
            self.class_to_ind["__background__"] = 0
            self.ind_to_class = {v: k for k, v in self.class_to_ind.items()}
            if attribute_on:
                self.attribute_to_ind = dict(jd["attribute_to_idx"])
                self.attribute_to_ind["__no_attribute__"] = 0
                self.ind_to_attribute = {
                    v: k for k, v in self.attribute_to_ind.items()}
            self._jsondict = jd

    def __len__(self) -> int:
        return (len(self.line_list) if self.line_list is not None
                else len(self.img_tsv))

    def get_line_no(self, idx: int) -> int:
        return idx if self.line_list is None else self.line_list[idx]

    def get_img_key(self, idx: int) -> str:
        return self.img_tsv.seek(self.get_line_no(idx))[0]

    def get_image(self, idx: int) -> np.ndarray:
        row = self.img_tsv.seek(self.get_line_no(idx))
        return img_from_base64(row[-1])

    def get_annotations(self, idx: int) -> dict:
        if self.label_tsv is None:
            return {}
        return json.loads(self.label_tsv.seek(self.get_line_no(idx))[1])

    def get_img_info(self, idx: int) -> Dict[str, int]:
        if self.hw_tsv is not None:
            row = self.hw_tsv.seek(self.get_line_no(idx))
            try:
                data = json.loads(row[1])
                return data[0] if isinstance(data, list) else data
            except ValueError:
                h, w = row[1].split(" ")
                return {"height": int(h), "width": int(w)}
        img = self.get_image(idx)
        return {"height": img.shape[0], "width": img.shape[1]}

    def load_objects(self, objects: Sequence[dict], img_size,
                     remove_empty: bool = False) -> Dict[str, np.ndarray]:
        """LabelLoader.__call__ equivalent (``label_loader.py:20-50``)."""
        w, h = img_size
        boxes = np.asarray([o["rect"] for o in objects],
                           np.float32).reshape(-1, 4)
        boxes = clip_boxes_to_image(boxes, w, h)
        labels = np.asarray([self.class_to_ind[o["class"]] for o in objects],
                            np.int32)
        target = {"boxes": boxes, "labels": labels}
        if self.attribute_on:
            attrs = np.zeros((len(objects), MAX_ATTRIBUTES), np.int32)
            for i, o in enumerate(objects):
                for j, a in enumerate(o.get("attributes", [])[:MAX_ATTRIBUTES]):
                    attrs[i, j] = self.attribute_to_ind[a]
            target["attributes"] = attrs
        if remove_empty:
            keep = ((boxes[:, 2] > boxes[:, 0])
                    & (boxes[:, 3] > boxes[:, 1]))
            target = {k: v[keep] for k, v in target.items()}
        return target

    def get_target(self, idx: int, remove_empty: bool = False):
        ann = self.get_annotations(idx)
        info = self.get_img_info(idx)
        objects = ann.get("objects", ann if isinstance(ann, list) else [])
        return self.load_objects(objects, (info["width"], info["height"]),
                                 remove_empty)

    def __getitem__(self, idx: int):
        img = self.get_image(idx)
        target = (self.get_target(idx) if self.is_load_label
                  and self.label_tsv is not None else None)
        return img, target, idx


class VGTSVDataset(DetectionTSVDataset):
    """Scene-graph VG-TSV (``vg_tsv.py:36-118``): adds relations, the
    left/right predicate ignore list, and the frequency prior."""

    IGNORE_REL = ("to the left of", "to the right of")

    def __init__(self, yaml_file: str, attribute_on: bool = True,
                 relation_on: bool = True, is_load_label: bool = True):
        super().__init__(yaml_file, attribute_on=attribute_on,
                         is_load_label=is_load_label)
        self.relation_on = relation_on
        if is_load_label and relation_on:
            self.relation_to_ind = dict(self._jsondict["predicate_to_idx"])
            self.relation_to_ind["__no_relation__"] = 0
            self.ind_to_relation = {
                v: k for k, v in self.relation_to_ind.items()}
        base = os.path.basename(self.linelist_file or yaml_file)
        self.split = "train" if "train" in base else "test"

    def load_relations(self, relations: Sequence[dict], n_boxes: int):
        """relation_loader equivalent (``label_loader.py:93-116``)."""
        triplets = []
        pred = np.zeros((n_boxes, n_boxes), np.int64)
        for r in relations:
            if r["class"] in self.IGNORE_REL:
                continue
            s, o = int(r["subj_id"]), int(r["obj_id"])
            p = self.relation_to_ind[r["class"]]
            pred[s, o] = p
            triplets.append([s, o, p])
        return (np.asarray(triplets, np.int64).reshape(-1, 3), pred)

    def get_target(self, idx: int, remove_empty: bool = False):
        ann = self.get_annotations(idx)
        info = self.get_img_info(idx)
        target = self.load_objects(ann.get("objects", []),
                                   (info["width"], info["height"]),
                                   remove_empty=False)
        if self.relation_on:
            trip, pred = self.load_relations(ann.get("relations", []),
                                             len(target["boxes"]))
            target["relation_triplets"] = trip
            target["pred_labels"] = pred
        return target

    def compute_freq_prior(self, must_overlap: bool = False) -> np.ndarray:
        """VG relation frequency prior (``vg_tsv.py:72-108``): P(predicate |
        subj class, obj class), background from co-occurring pairs."""
        n_cls = len(self.class_to_ind)
        n_rel = len(self.relation_to_ind)
        fg = np.zeros((n_cls, n_cls, n_rel), np.int64)
        bg = np.zeros((n_cls, n_cls), np.int64)
        for i in range(len(self)):
            t = self.get_target(i)
            classes, trip = t["labels"], t["relation_triplets"]
            for s, o, p in trip:
                fg[classes[s], classes[o], p] += 1
            pairs = _box_filter(t["boxes"], must_overlap)
            for s, o in pairs:
                bg[classes[s], classes[o]] += 1
        prob = fg.astype(np.float32)
        prob[:, :, 0] = bg
        prob[:, :, 0] += 1
        prob /= prob.sum(2)[:, :, None]
        return prob


def _box_filter(boxes: np.ndarray, must_overlap: bool = False) -> np.ndarray:
    """Candidate relation pairs (``vg_tsv.py:17-33``): overlapping boxes,
    else all ordered pairs."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 2), np.int64)
    x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    overlaps = inter > 0
    np.fill_diagonal(overlaps, False)
    all_possib = ~np.eye(n, dtype=bool)
    if must_overlap:
        pairs = np.column_stack(np.nonzero(overlaps))
        if pairs.size == 0:
            pairs = np.column_stack(np.nonzero(all_possib))
    else:
        pairs = np.column_stack(np.nonzero(all_possib))
    return pairs


def write_detection_tsv(root: str, name: str, images: Dict[str, np.ndarray],
                        labels: Dict[str, dict],
                        labelmap: Dict[str, dict],
                        sort_keys: bool = True) -> str:
    """Author a complete od/vg-TSV dataset directory (images b64-encoded,
    label/hw TSVs, labelmap jsondict, yaml descriptor) — the writer side of
    the format, used for fixtures and data prep. Images are JPEG at
    quality 95 (Pillow's bytes, through ``utils/image_codec``)."""
    from cpt_tpu_torch.utils.image_codec import encode_jpeg
    from cpt_tpu_torch.utils.tsv import tsv_writer

    os.makedirs(root, exist_ok=True)
    keys = sorted(images) if sort_keys else list(images)
    img_rows, label_rows, hw_rows = [], [], []
    for k in keys:
        jpeg = encode_jpeg(images[k], quality=95)
        img_rows.append([k, base64.b64encode(jpeg).decode()])
        label_rows.append([k, json.dumps(labels[k])])
        hw_rows.append([k, json.dumps([{"height": images[k].shape[0],
                                        "width": images[k].shape[1]}])])
    tsv_writer(img_rows, os.path.join(root, f"{name}.img.tsv"))
    tsv_writer(label_rows, os.path.join(root, f"{name}.label.tsv"))
    tsv_writer(hw_rows, os.path.join(root, f"{name}.hw.tsv"))
    json.dump(labelmap, open(os.path.join(root, f"{name}.labelmap.json"),
                             "w"))
    yaml_path = os.path.join(root, f"{name}.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"img: {name}.img.tsv\n"
                f"label: {name}.label.tsv\n"
                f"hw: {name}.hw.tsv\n"
                f"labelmap: {name}.labelmap.json\n")
    return yaml_path


class ConcatDetectionDataset:
    """Concatenation of several detection TSV datasets — the reference's
    ``DATASETS.TRAIN`` tuple → ``torch ConcatDataset`` path
    (``data/build.py:46-70``). Exposes the same per-index surface as one
    ``DetectionTSVDataset``."""

    def __init__(self, datasets: Sequence):
        assert datasets, "need at least one dataset"
        self.datasets = list(datasets)
        self.offsets = []
        total = 0
        for d in self.datasets:
            self.offsets.append(total)
            total += len(d)
        self.total = total

    def __len__(self) -> int:
        return self.total

    def _locate(self, idx: int):
        if idx < 0 or idx >= self.total:
            raise IndexError(idx)
        for d, off in zip(reversed(self.datasets), reversed(self.offsets)):
            if idx >= off:
                return d, idx - off
        raise IndexError(idx)

    def __getitem__(self, idx: int):
        d, i = self._locate(idx)
        return d[i]

    def get_img_key(self, idx: int):
        d, i = self._locate(idx)
        return d.get_img_key(i)

    def get_img_info(self, idx: int):
        d, i = self._locate(idx)
        return d.get_img_info(i)

    def get_target(self, idx: int, **kw):
        d, i = self._locate(idx)
        return d.get_target(i, **kw)
