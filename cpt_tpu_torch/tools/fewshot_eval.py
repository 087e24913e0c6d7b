"""Few-shot protocol report: mean ± std over seeds per shot count (port of
``cpt_tpu/tools/fewshot_eval.py``).

Mirrors reference ``Oscar/eval/refcoco/fewshot_eval.py`` (and the
``eval/{gqa,vcr}/show*.py`` family): collects per-run result files named
``<tag>_shot{N}_seed{S}.pk`` (or explicit --runs entries "shot:seed:path")
and prints the 5-seed mean±std table.
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle
import re
from collections import defaultdict

from cpt_tpu_torch.engine.evaluate import seed_sweep_report


def build_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results_dir", default=None,
                   help="directory of *_shot{N}_seed{S}.pk result pickles")
    p.add_argument("--runs", nargs="*", default=[],
                   help='explicit "shot:seed:path" entries')
    p.add_argument("--metric", default="accuracy")
    return p


def main(argv=None):
    args = build_args().parse_args(argv)
    results = defaultdict(dict)
    entries = []
    if args.results_dir:
        for path in glob.glob(os.path.join(args.results_dir, "*.pk")):
            m = re.search(r"shot(\d+)_seed(\d+)", os.path.basename(path))
            if m:
                entries.append((int(m.group(1)), int(m.group(2)), path))
    for spec in args.runs:
        shot, seed, path = spec.split(":", 2)
        entries.append((int(shot), int(seed), path))
    for shot, seed, path in entries:
        blob = pickle.load(open(path, "rb"))
        results[shot][seed] = float(blob[args.metric])
    report = seed_sweep_report(results)
    print(report)
    return results


if __name__ == "__main__":
    main()
