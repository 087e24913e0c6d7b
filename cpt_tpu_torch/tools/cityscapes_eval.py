"""Cityscapes-protocol instance AP from prediction / ground-truth JSON files
(port of ``cpt_tpu/tools/cityscapes_eval.py``).

One-command front end for ``engine/cityscapes_eval.py`` (the reference wires
the protocol through its dataset-evaluate dispatch,
``data/datasets/evaluation/cityscapes/cityscapes_eval.py:22-103``; the
Cityscapes dataset loader is not ported, as in the JAX package, but the
evaluator runs on any instance predictions). It runs on the host alone:

  python -m cpt_tpu_torch.tools.cityscapes_eval --gt gt.json \\
      --pred pred.json --classes person,car [--iou_types bbox,segm] \\
      [--output_json results.json]

File format (both ``--gt`` and ``--pred``): a JSON list, one record per
image::

    {"boxes": [[x0,y0,x1,y1], ...], "labels": [int, ...],
     "scores": [float, ...],              # predictions only
     "masks":  [RLE, ...]}                # optional; COCO RLE dicts

RLE masks use the COCO codec (``utils/rle.py``). ``--classes`` names the
label indices.
"""
import argparse
import json

import numpy as np

from cpt_tpu_torch.engine.cityscapes_eval import cityscapes_instance_eval
from cpt_tpu_torch.utils import rle as rle_codec


def _load_records(path):
    with open(path) as f:
        records = json.load(f)
    out = []
    for rec in records:
        r = {"boxes": np.asarray(rec.get("boxes", []),
                                 np.float64).reshape(-1, 4),
             "labels": np.asarray(rec.get("labels", []), np.int64)}
        if "scores" in rec:
            r["scores"] = np.asarray(rec["scores"], np.float64)
        if rec.get("masks"):
            r["masks"] = np.stack([rle_codec.decode(m).astype(bool)
                                   for m in rec["masks"]])
        out.append(r)
    return out


def main(argv=None):
    """Evaluate ``--pred`` against ``--gt`` → {iou type: results}, each
    type's table printed."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gt", required=True, help="ground-truth JSON")
    ap.add_argument("--pred", required=True, help="predictions JSON")
    ap.add_argument("--classes", required=True,
                    help="comma-separated class names (label index order)")
    ap.add_argument("--iou_types", default="bbox,segm")
    ap.add_argument("--output_json", default=None)
    args = ap.parse_args(argv)

    gts = _load_records(args.gt)
    preds = _load_records(args.pred)
    classes = args.classes.split(",")
    results = cityscapes_instance_eval(
        gts, preds, classes, iou_types=tuple(args.iou_types.split(",")),
        output_json=args.output_json)
    for iou_type, res in results.items():
        print(f"\n[{iou_type}]")
        print(res["table"])
    return results


if __name__ == "__main__":
    main()
