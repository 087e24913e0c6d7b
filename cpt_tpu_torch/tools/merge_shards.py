"""Merge per-shard extraction TSVs into one predictions.tsv (port of
``cpt_tpu/tools/merge_shards.py``).

Replaces the reference's 15-shard ``tmp/cnt.pk`` loop
(``prompt_feat/tools/cnt.py``, ``cmds/gqa/ext.sh:1-12``) with an explicit,
stateless merge. Shards come from ``extract_features.py --total_step N
--cur_step i`` runs (sequential resumable runs, or one per machine).
"""
from __future__ import annotations

import argparse
import glob

from cpt_tpu_torch.utils.tsv import merge_tsv_shards


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--shards", nargs="+", required=True,
                   help="shard TSV paths or globs, in order")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    paths = []
    for s in args.shards:
        expanded = sorted(glob.glob(s))
        paths.extend(expanded if expanded else [s])
    merge_tsv_shards(paths, args.output)
    print(f"merged {len(paths)} shards -> {args.output}")


if __name__ == "__main__":
    main()
