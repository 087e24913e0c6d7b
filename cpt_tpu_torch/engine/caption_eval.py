"""COCO caption evaluation protocol — ``evaluate_on_coco_caption`` parity.

Reference ``Oscar/oscar/utils/caption_evaluate.py:59-90``: predictions TSV
(rows ``[image_key, json list of {"caption", "conf"}]``) + COCO-format
ground-truth json → pycocoevalcap metric dict. This module reproduces the
protocol in pure Python:

* **Bleu_1..4** — corpus-level, clipped n-gram counts accumulated over all
  images, brevity penalty with the closest-reference length (pycocoevalcap
  Bleu 'corpus' semantics).
* **METEOR** — mean per-image ``utils.meteor.meteor`` (multi-stage
  alignment; see that module for the WordNet/paraphrase-table caveat).
* **ROUGE_L** — mean per-image LCS F-measure with β=1.2 (pycocoevalcap
  Rouge defaults), max over references.
* **CIDEr** — ``utils.cider.CiderD`` corpus score (same algorithm family
  the reference vendors under ``oscar/utils/cider/``).
* **SPICE** — the exact Java pipeline is NOT implemented (descoped;
  requires the Stanford scene-graph parser + JVM; documented in
  PARITY.md). An explicitly-approximate pure-Python stand-in,
  ``utils/spice_lite.py``, is available opt-in: pass
  ``spice_lite=True`` to get a ``SPICE_lite`` key (tuple-F1 over a
  rule-parsed scene graph; numbers NOT comparable to Java SPICE).

Tokenization: ``utils.ptb_tokenizer.ptb_tokenize`` — pure-Python PTB
parity with the Stanford jar pipeline the reference shells out to
(contraction splits, punctuation-token removal).

The port's copy of ``cpt_tpu/engine/caption_eval.py``: the same code,
importing the port's modules (``tests/test_torch_isolation.py`` holds it to
the original).
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List, Sequence

from cpt_tpu_torch.utils.cider import CiderD, ngrams
from cpt_tpu_torch.utils.meteor import meteor
from cpt_tpu_torch.utils.ptb_tokenizer import ptb_tokenize as tokenize


def corpus_bleu(hyps: Dict[str, Sequence[str]],
                refs: Dict[str, List[Sequence[str]]], n_max: int = 4
                ) -> List[float]:
    """Corpus-level BLEU-1..n (clipped counts summed over images, closest
    reference length for the brevity penalty)."""
    import math

    clipped = [0] * n_max
    totals = [0] * n_max
    hyp_len = ref_len = 0
    for key, hyp in hyps.items():
        hyp = list(hyp)
        rlist = [list(r) for r in refs[key]]
        hyp_len += len(hyp)
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in rlist)[1]
        for n in range(1, n_max + 1):
            hc = Counter(tuple(hyp[i:i + n])
                         for i in range(len(hyp) - n + 1))
            max_rc: Counter = Counter()
            for r in rlist:
                rc = Counter(tuple(r[i:i + n]) for i in range(len(r) - n + 1))
                for g, c in rc.items():
                    max_rc[g] = max(max_rc[g], c)
            clipped[n - 1] += sum(min(c, max_rc[g]) for g, c in hc.items())
            totals[n - 1] += max(sum(hc.values()), 0)
    bp = 1.0 if hyp_len > ref_len else (
        math.exp(1 - ref_len / max(hyp_len, 1)))
    out = []
    logp = 0.0
    for n in range(n_max):
        p = clipped[n] / max(totals[n], 1)
        # pycocoevalcap smooths nothing at corpus level; guard log(0)
        logp += math.log(max(p, 1e-12))
        out.append(bp * math.exp(logp / (n + 1)))
    return out


def rouge_l(hyp: Sequence[str], refs: List[Sequence[str]],
            beta: float = 1.2) -> float:
    """LCS F-measure, max over references (pycocoevalcap Rouge)."""
    def lcs(a, b):
        dp = [0] * (len(b) + 1)
        for x in a:
            prev = 0
            for j, y in enumerate(b, 1):
                cur = dp[j]
                dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
                prev = cur
        return dp[-1]

    best = 0.0
    for ref in refs:
        ll = lcs(list(hyp), list(ref))
        if ll == 0:
            continue
        prec = ll / max(len(hyp), 1)
        rec = ll / max(len(ref), 1)
        score = (1 + beta ** 2) * prec * rec / (rec + beta ** 2 * prec)
        best = max(best, score)
    return best


def load_coco_labels(label_file: str) -> Dict[str, List[List[str]]]:
    """COCO-format gt json → {image_key: [ref token lists]}."""
    blob = json.load(open(label_file))
    id_to_key = {}
    for img in blob.get("images", []):
        id_to_key[img["id"]] = str(img.get("file_name", img["id"]))
    refs: Dict[str, List[List[str]]] = {}
    for ann in blob["annotations"]:
        key = str(ann["image_id"])
        refs.setdefault(key, []).append(tokenize(ann["caption"]))
    return refs


def load_res_tsv(res_file: str) -> Dict[str, List[str]]:
    """Predictions TSV rows [image_key, json [{caption, conf}]] →
    {key: tokens} (reference convert_tsv_to_coco_format,
    ``caption_evaluate.py:93-112``)."""
    hyps = {}
    with open(res_file) as fp:
        for line in fp:
            parts = line.rstrip("\n").split("\t")
            key = parts[0]
            caps = json.loads(parts[1]) if len(parts) > 1 else []
            cap = caps[0].get("caption", "") if caps else ""
            hyps[str(key)] = tokenize(cap)
    return hyps


def convert_tsv_to_coco_format(res_tsv: str, outfile: str,
                               sep: str = "\t", key_col: int = 0,
                               cap_col: int = 1) -> None:
    """Predictions TSV → COCO-format results json
    (``caption_evaluate.py:93-112``): ``[{"image_id", "caption"}]`` rows,
    empty caption for empty prediction lists — the submission format the
    coco/nocaps servers take."""
    results = []
    with open(res_tsv) as fp:
        for line in fp:
            parts = line.strip().split(sep)
            key = parts[key_col]
            if cap_col < len(parts):
                caps = json.loads(parts[cap_col])
                assert len(caps) == 1, \
                    "cannot evaluate multiple captions per image"
                cap = caps[0].get("caption", "")
            else:
                cap = ""
            results.append({"image_id": key, "caption": cap})
    with open(outfile, "w") as fp:
        json.dump(results, fp)


def evaluate_on_coco_caption(res_file: str, label_file: str,
                             outfile: str = None,
                             spice_lite: bool = False) -> Dict[str, float]:
    """Reference-compatible entry (``caption_evaluate.py:59``): TSV
    predictions + COCO gt json → metric dict (written to ``outfile`` when
    given). ``spice_lite=True`` adds the approximate ``SPICE_lite``
    tuple-F1 (see ``utils/spice_lite.py`` — not Java-SPICE-comparable)."""
    hyps = load_res_tsv(res_file)
    refs = load_coco_labels(label_file)
    common = [k for k in hyps if k in refs]
    hyps = {k: hyps[k] for k in common}
    sub_refs = {k: refs[k] for k in common}

    bleu = corpus_bleu(hyps, sub_refs)
    met = sum(meteor(h, sub_refs[k]) for k, h in hyps.items()) / max(
        len(hyps), 1)
    rouge = sum(rouge_l(h, sub_refs[k]) for k, h in hyps.items()) / max(
        len(hyps), 1)
    cider = CiderD(sub_refs).corpus_score(hyps)
    result = {f"Bleu_{i + 1}": bleu[i] for i in range(4)}
    result.update({"METEOR": met, "ROUGE_L": rouge, "CIDEr": cider})
    if spice_lite:
        from cpt_tpu_torch.utils.spice_lite import spice_lite_corpus

        result["SPICE_lite"] = spice_lite_corpus(
            {k: " ".join(h) for k, h in hyps.items()},
            {k: [" ".join(r) for r in sub_refs[k]] for k in hyps})
    if outfile:
        with open(outfile, "w") as fp:
            json.dump(result, fp, indent=4)
    else:
        print(result)
    return result
