"""CIDEr-D scorer — pure-python port.

Replaces the reference's vendored ``coco-caption``/``pycocoevalcap`` CIDEr-D
(``Oscar/oscar/utils/cider/``, cloned by install.sh): tf-idf weighted 1-4
gram cosine similarity with count clipping and the Gaussian length penalty
(σ=6), scaled ×10. Used for evaluation and as the SCST reward.

The port's copy of ``cpt_tpu/utils/cider.py``: the same code, importing the
port's modules (``tests/test_torch_isolation.py`` holds it to the original).
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def ngrams(tokens: Sequence[str], n_max: int = 4) -> Counter:
    counts: Counter = Counter()
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i:i + n])] += 1
    return counts


def bleu4(hyp: Sequence[str], refs: List[Sequence[str]],
          n_max: int = 4) -> float:
    """Corpus-style BLEU-4 for one hypothesis against multiple references
    (clipped n-gram precision, geometric mean, brevity penalty) — the
    ``caption_evaluate.py`` BLEU component (pure-python; METEOR/SPICE need
    external jars and remain documented gaps)."""
    hyp = list(hyp)
    if not hyp:
        return 0.0
    n_eff = min(n_max, len(hyp))   # short hyps score over available orders
    log_p = 0.0
    for n in range(1, n_eff + 1):
        h_counts = Counter(tuple(hyp[i:i + n])
                           for i in range(len(hyp) - n + 1))
        max_ref: Counter = Counter()
        for ref in refs:
            r_counts = Counter(tuple(ref[i:i + n])
                               for i in range(len(ref) - n + 1))
            for g, c in r_counts.items():
                max_ref[g] = max(max_ref[g], c)
        clipped = sum(min(c, max_ref.get(g, 0)) for g, c in h_counts.items())
        total = sum(h_counts.values())
        p = clipped / total if total else 0.0
        if p == 0.0:
            p = 1e-9  # smoothed
        log_p += math.log(p) / n_eff
    ref_len = min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
    bp = 1.0 if len(hyp) > ref_len else math.exp(1 - ref_len / max(len(hyp), 1))
    return bp * math.exp(log_p)


def meteor_exact(hyp: Sequence[str], refs: List[Sequence[str]], *,
                 alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5
                 ) -> float:
    """METEOR with the exact-match stage only (pycocoevalcap's METEOR core
    scoring: unigram alignment → weighted harmonic mean P/R →
    fragmentation penalty γ·(chunks/matches)^β; best ref wins). The
    synonym/stem/paraphrase stages need WordNet + paraphrase tables
    (external data) — documented limitation; exact-stage METEOR is a lower
    bound on full METEOR."""
    hyp = list(hyp)
    if not hyp:
        return 0.0

    def score_one(ref: List[str]) -> float:
        # leftmost greedy alignment (one-to-one)
        used = [False] * len(ref)
        align = []                               # hyp idx -> ref idx
        for i, w in enumerate(hyp):
            for j, r in enumerate(ref):
                if not used[j] and r == w:
                    used[j] = True
                    align.append((i, j))
                    break
        m = len(align)
        if m == 0:
            return 0.0
        p = m / len(hyp)
        r = m / len(ref)
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        # chunks: maximal runs contiguous in both hyp and ref
        chunks = 1
        for (i0, j0), (i1, j1) in zip(align, align[1:]):
            if i1 != i0 + 1 or j1 != j0 + 1:
                chunks += 1
        penalty = gamma * (chunks / m) ** beta
        return fmean * (1 - penalty)

    return max(score_one(list(r)) for r in refs)


class CiderD:
    def __init__(self, refs: Dict[str, List[Sequence[str]]], n_max: int = 4,
                 sigma: float = 6.0):
        """refs: {image_id: [tokenized reference captions]} — the corpus
        that defines the idf statistics (train/eval reference set)."""
        self.n_max = n_max
        self.sigma = sigma
        self.refs = {k: [list(r) for r in v] for k, v in refs.items()}
        self.doc_freq: Counter = Counter()
        for caps in self.refs.values():
            seen = set()
            for cap in caps:
                seen.update(ngrams(cap, n_max).keys())
            for g in seen:
                self.doc_freq[g] += 1
        self.log_num_docs = math.log(max(len(self.refs), 1))

    def _vec(self, counts: Counter):
        """→ (per-n tf-idf vec dicts, per-n norms, length)."""
        vecs = [defaultdict(float) for _ in range(self.n_max)]
        norms = [0.0] * self.n_max
        length = 0
        for g, c in counts.items():
            idf = self.log_num_docs - math.log(max(self.doc_freq.get(g, 0), 1))
            n = len(g) - 1
            vecs[n][g] = c * idf
            norms[n] += (c * idf) ** 2
            if n == 0:
                length += c
        return vecs, [math.sqrt(x) for x in norms], length

    def _sim(self, hv, hn, hl, rv, rn, rl) -> float:
        delta = hl - rl
        score = 0.0
        for n in range(self.n_max):
            s = 0.0
            for g, c in hv[n].items():
                # CIDEr-D count clipping: min(hyp, ref) tf-idf
                s += min(c, rv[n].get(g, 0.0)) * rv[n].get(g, 0.0)
            if hn[n] > 0 and rn[n] > 0:
                s /= hn[n] * rn[n]
            s *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
            score += s
        return score / self.n_max

    def score(self, image_id: str, hyp_tokens: Sequence[str]) -> float:
        refs = self.refs[image_id]
        hv, hn, hl = self._vec(ngrams(list(hyp_tokens), self.n_max))
        total = 0.0
        for ref in refs:
            rv, rn, rl = self._vec(ngrams(ref, self.n_max))
            total += self._sim(hv, hn, hl, rv, rn, rl)
        return 10.0 * total / max(len(refs), 1)

    def corpus_score(self, hyps: Dict[str, Sequence[str]]) -> float:
        scores = [self.score(k, h) for k, h in hyps.items()]
        return sum(scores) / max(len(scores), 1)
