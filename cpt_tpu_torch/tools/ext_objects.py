"""Extract per-image object lists from a predictions TSV → objects.json
(port of ``cpt_tpu/tools/ext_objects.py``).

Mirrors reference ``prompt_feat/tools/ext_objects.py``: reads extraction
rows and emits {img_key: [{"rect", "class", "conf"}, ...]} (features
stripped) — the det-file format the stage-2 datasets consume.
"""
from __future__ import annotations

import argparse
import json

from cpt_tpu_torch.utils.tsv import TSVFile


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tsv", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--classes_only", action="store_true",
                   help="emit {img_key: [class names]} (refcoco det format)")
    args = p.parse_args(argv)

    tsv = TSVFile(args.tsv)
    out = {}
    for i in range(len(tsv)):
        key, payload = tsv.seek(i)
        info = json.loads(payload)
        objs = info["objects"]
        if isinstance(objs, list) and objs and isinstance(objs[0], list):
            boxlist = objs[0][0] if isinstance(objs[0][0], list) else objs[0]
        else:
            boxlist = objs
        if args.classes_only:
            out[key] = [o["class"] for o in boxlist]
        else:
            out[key] = [{"rect": o["rect"], "class": o["class"],
                         "conf": o.get("conf", 0.0)} for o in boxlist]
    json.dump(out, open(args.output, "w"))
    print(f"wrote {args.output}: {len(out)} images")


if __name__ == "__main__":
    main()
