"""Convert standard detection datasets (COCO instances json, PASCAL VOC)
to the od/vg-TSV format the detector tools consume (port of
``cpt_tpu/tools/convert_dataset.py``; needs Pillow).

Usage:
  python -m cpt_tpu_torch.tools.convert_dataset coco --ann instances.json \\
      --img_dir images/ --out data/coco_tsv [--name coco]
  python -m cpt_tpu_torch.tools.convert_dataset voc --voc_root VOC2007 \\
      --split test --out data/voc_tsv

Then: ``python -m cpt_tpu_torch.tools.test_detector --tsv <printed yaml> ...``.
Reference loaders bridged: ``maskrcnn_benchmark/data/datasets/coco.py``,
``voc.py``; semantics documented in ``data/coco_json.py``.
"""
from __future__ import annotations

import argparse

from cpt_tpu_torch.data.coco_json import coco_to_tsv, voc_to_tsv


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="fmt", required=True)
    pc = sub.add_parser("coco")
    pc.add_argument("--ann", required=True)
    pc.add_argument("--img_dir", required=True)
    pc.add_argument("--out", required=True)
    pc.add_argument("--name", default="coco")
    pv = sub.add_parser("voc")
    pv.add_argument("--voc_root", required=True)
    pv.add_argument("--split", default="test")
    pv.add_argument("--out", required=True)
    pv.add_argument("--name", default=None)
    args = p.parse_args(argv)
    if args.fmt == "coco":
        yaml_path = coco_to_tsv(args.ann, args.img_dir, args.out, args.name)
    else:
        yaml_path = voc_to_tsv(args.voc_root, args.split, args.out,
                               args.name)
    print(yaml_path)
    return yaml_path


if __name__ == "__main__":
    main()
