"""pt+cpt logit-ensemble report for GQA and VCR (port of
``cpt_tpu/tools/show_ensemble.py``).

Mirrors reference ``Oscar/eval/gqa/show_ensemble_results.py`` (+ the 3:1
weights from ``show.sh``) and ``eval/vcr/show_ensemble_results.py``:
loads two results pickles (prompt-tuning and CPT runs), ensembles
per-question score vectors as ``pt·w_pt + cpt·w_cpt``, and reports the
ensembled accuracy.

``--task gqa`` scores against a labels json (the reference's gqa flow);
``--task vcr`` uses the gt stored in the pickles; ``--task vcr_qar``
ensembles BOTH heads of a q→ar run ({"qa": ..., "qar": ...} pickles from
``vcr_nsp_cpt --task qar``) and counts an example correct only when the
answer AND rationale ensembles are both right (the reference's
``"vcr_qar" in path`` branch, eval/vcr/show_ensemble_results.py:17-22).
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

from cpt_tpu_torch.engine.evaluate import ensemble_logits


def build_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pt_results", required=True)
    p.add_argument("--cpt_results", required=True)
    p.add_argument("--labels", default=None,
                   help="json {q_id: answer label index} (gqa; vcr tasks "
                        "read the gt stored in the pickles)")
    p.add_argument("--task", default="gqa",
                   choices=["gqa", "vcr", "vcr_qar"])
    p.add_argument("--pt_weight", type=float, default=3.0)
    p.add_argument("--cpt_weight", type=float, default=1.0)
    return p


def _ensemble_correct(pt, cpt, qid, w_pt, w_cpt):
    """→ (ensembled argmax == gt) for one results-dict entry, or None
    when the qid is missing on either side / carries no gt."""
    if qid not in pt or qid not in cpt:
        return None
    gt = cpt[qid].get("gt")
    if gt is None:
        return None
    ens = ensemble_logits(np.asarray(pt[qid]["scores"]),
                          np.asarray(cpt[qid]["scores"]), w_pt, w_cpt)
    return int(np.argmax(ens)) == gt


def main(argv=None):
    import json

    args = build_args().parse_args(argv)
    pt = pickle.load(open(args.pt_results, "rb"))["results"]
    cpt = pickle.load(open(args.cpt_results, "rb"))["results"]

    n_correct, n_total = 0, 0
    if args.task == "vcr_qar":
        # two heads, both must be right (reference :17-22)
        for qid in cpt["qar"]:
            oks = [_ensemble_correct(pt[h], cpt[h], qid, args.pt_weight,
                                     args.cpt_weight)
                   for h in ("qa", "qar")]
            if None in oks:
                continue
            n_correct += int(all(oks))
            n_total += 1
    elif args.task == "vcr":
        for qid in cpt:
            ok = _ensemble_correct(pt, cpt, qid, args.pt_weight,
                                   args.cpt_weight)
            if ok is None:
                continue
            n_correct += int(ok)
            n_total += 1
    else:  # gqa: labels come from the answer-vocab json
        if not args.labels:
            raise SystemExit("--task gqa needs --labels")
        labels = {str(k): int(v)
                  for k, v in json.load(open(args.labels)).items()}
        for qid, lab in labels.items():
            if qid not in pt or qid not in cpt:
                continue
            ens = ensemble_logits(np.asarray(pt[qid]["scores"]),
                                  np.asarray(cpt[qid]["scores"]),
                                  args.pt_weight, args.cpt_weight)
            n_correct += int(int(np.argmax(ens)) == lab)
            n_total += 1
    acc = 100.0 * n_correct / max(n_total, 1)
    print(f"ensemble accuracy: {acc:.2f} ({n_total} questions)")
    return acc


if __name__ == "__main__":
    main()
