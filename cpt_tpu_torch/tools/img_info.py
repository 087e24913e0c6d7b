"""Image-info / shard-count / small data-prep+analysis utilities (port of
``cpt_tpu/tools/img_info.py``; the image scan reads sizes from the file
headers and the color probes write JPEGs through ``utils/image_codec``,
without Pillow).

Parity with the reference's one-off helper scripts:

  * ``prompt_feat/tools/create_img_info.py`` — scan an image directory and
    write ``img_info.json`` ({basename: {width, height}}), consumed by the
    extraction datasets' yaml descriptors.
  * ``prompt_feat/tools/cnt.py`` — persist the shard count for the
    extraction driver scripts (``tmp/cnt.pk``).
  * ``prompt_feat/tools/create_img_bbox.py`` — dump ``bbox.pk``
    ({img_key: float32 [N,4] det rects}) from a predictions TSV.
  * ``prompt_feat/other/create_all_color_imgs.py`` — the solid-color
    probe images (+ full-image bbox.pk) behind the color-recognition
    exploration.
  * ``prompt_feat/other/upper_bound_of_refcoco.py`` — detection-recall
    ceiling of a grounding split: fraction of annotations whose best
    candidate-det IoU exceeds 0.5.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
from typing import List, Optional


def create_img_info(image_dir: str, output: Optional[str] = None,
                    exts: tuple = ("*.jpg", "*.jpeg", "*.png")) -> dict:
    from cpt_tpu_torch.utils.image_codec import image_size

    infos = {}
    for pat in exts:
        for fname in sorted(glob.glob(os.path.join(image_dir, pat))):
            w, h = image_size(fname)
            infos[os.path.basename(fname)] = {"width": w, "height": h}
    if output is None:
        output = os.path.join(os.path.dirname(image_dir.rstrip("/")),
                              "img_info.json")
    with open(output, "w") as f:
        json.dump(infos, f)
    return infos


def write_shard_count(count: int, path: str = "tmp/cnt.pk") -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(int(count), f)


def create_img_bbox(predictions_tsv: str, output: Optional[str] = None) -> dict:
    """``create_img_bbox.py:12-23``: {img_key: [N,4] float32 rects} →
    ``bbox.pk`` next to ``output`` (or the TSV when output is None)."""
    import numpy as np

    from cpt_tpu_torch.utils.tsv import TSVFile

    tsv = TSVFile(predictions_tsv)
    img_infos = {}
    for i in range(len(tsv)):
        key, payload = tsv.seek(i)[:2]
        objs = json.loads(payload)["objects"]
        img_infos[key] = np.asarray([o["rect"] for o in objs],
                                    dtype=np.float32).reshape(-1, 4)
    out_dir = os.path.dirname(output if output is not None
                              else predictions_tsv)
    path = os.path.join(out_dir or ".", "bbox.pk")
    with open(path, "wb") as f:
        pickle.dump(img_infos, f)
    return img_infos


def create_all_color_imgs(out_dir: str, step: int = 5,
                          size: int = 128) -> dict:
    """``other/create_all_color_imgs.py``: one solid-color ``size``×``size``
    jpg per RGB on a ``step`` grid, plus a full-image ``bbox.pk``."""
    import numpy as np

    from cpt_tpu_torch.utils.image_codec import write_image

    os.makedirs(out_dir, exist_ok=True)
    bbox = {}
    for r in range(0, 256, step):
        for g in range(0, 256, step):
            for b in range(0, 256, step):
                im = np.empty((size, size, 3), np.uint8)
                im[..., 0], im[..., 1], im[..., 2] = r, g, b
                name = f"{r}_{g}_{b}.jpg"
                write_image(os.path.join(out_dir, name), im)
                bbox[name] = np.asarray([[0., 0, size, size]], np.float32)
    with open(os.path.join(out_dir, "bbox.pk"), "wb") as f:
        pickle.dump(bbox, f)
    return bbox


def refcoco_upper_bound(ann_file: str, det_file: str,
                        iou_thresh: float = 0.5) -> float:
    """``other/upper_bound_of_refcoco.py:27-37``: detection-recall ceiling —
    fraction of annotations whose best candidate det (xywh, same
    inclusive-IoU convention) clears ``iou_thresh``. The reference script
    gates the count on ``len(dets) == 1`` (a transcription slip that would
    skip nearly every image); the ceiling it describes is the
    unconditional max-IoU recall computed here."""
    from cpt_tpu_torch.structures.boxes import xywh_iou

    anns = json.load(open(ann_file))
    dets = json.load(open(det_file))
    correct = 0
    for ann in anns:
        img_id = str(int(ann["file_name"].replace(".jpg", "")
                         .split("_")[-1]))
        cand = dets.get(img_id, [])
        best = max((xywh_iou(d["box"], ann["bbox"]) for d in cand),
                   default=0.0)
        correct += best > iou_thresh
    frac = correct / max(len(anns), 1)
    print(f"{correct} {len(anns)} {frac}")
    return frac


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image_dir", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--shard_count", type=int, default=None,
                   help="also persist the shard count (cnt.py parity)")
    p.add_argument("--cnt_path", default="tmp/cnt.pk")
    p.add_argument("--bbox_from", default=None,
                   help="predictions.tsv → bbox.pk (create_img_bbox parity)")
    p.add_argument("--all_color_imgs", default=None,
                   help="directory to fill with solid-color probe images")
    p.add_argument("--color_step", type=int, default=5)
    p.add_argument("--upper_bound", nargs=2, metavar=("ANN", "DETS"),
                   default=None,
                   help="grounding annotation json + per-image dets json → "
                        "detection-recall ceiling")
    args = p.parse_args(argv)
    infos: dict = {}
    if args.image_dir:
        infos = create_img_info(args.image_dir, args.output)
        print(f"wrote info for {len(infos)} images")
    if args.shard_count is not None:
        write_shard_count(args.shard_count, args.cnt_path)
    if args.bbox_from:
        boxes = create_img_bbox(args.bbox_from, args.output)
        print(f"wrote bbox.pk for {len(boxes)} images")
    if args.all_color_imgs:
        create_all_color_imgs(args.all_color_imgs, args.color_step)
    if args.upper_bound:
        refcoco_upper_bound(*args.upper_bound)
    return infos


if __name__ == "__main__":
    main()
