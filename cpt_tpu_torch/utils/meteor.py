"""METEOR 1.5-style caption metric — pure Python, no external data needed.

Reference semantics: ``Oscar/oscar/utils/caption_evaluate.py:83`` scores
captions through pycocoevalcap's METEOR (the meteor-1.5 jar, English
defaults). This implementation reproduces its scoring model:

* multi-stage unigram alignment — exact (weight 1.0), Porter-stem (0.6),
  synonym (0.8). The jar's synonym stage uses WordNet synsets; WordNet is
  external data this environment cannot ship, so the synonym stage runs
  only when a synonym table is supplied (``synonyms={word: {aliases}}``,
  e.g. exported from WordNet); otherwise it is skipped. The paraphrase
  stage (meteor's 4th, requiring the paraphrase-en.gz table) is likewise
  table-gated. Both omissions lower recall of matches slightly — scores
  are a lower bound on jar METEOR, exact in the common case where
  captions share surface/stem forms.
* content/function word weighting (δ): function words (closed-class
  English list, meteor-1.5's function.words equivalent) contribute
  (1−δ), content words δ, to weighted precision/recall.
* fragmentation penalty γ·(chunks/matches)^β over the combined alignment,
  score = fmean·(1−penalty), fmean = P·R/(α·P+(1−α)·R).
* English parameters α=0.85, β=0.2, γ=0.6, δ=0.75.

Alignment is resolved greedily per stage in priority order (exact first),
leftmost-first — the jar beam-searches the chunk-minimizing alignment;
greedy differs only on pathological repeated-word cases.

The port's copy of ``cpt_tpu/utils/meteor.py``: the same code, importing the
port's modules (``tests/test_torch_isolation.py`` holds it to the original).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["PorterStemmer", "meteor", "FUNCTION_WORDS"]


class PorterStemmer:
    """The classic Porter (1980) stemming algorithm."""

    _VOWELS = "aeiou"

    def _cons(self, w: str, i: int) -> bool:
        c = w[i]
        if c in self._VOWELS:
            return False
        if c == "y":
            return i == 0 or not self._cons(w, i - 1)
        return True

    def _measure(self, stem: str) -> int:
        """Number of VC sequences in [C](VC)^m[V]."""
        forms = ""
        for i in range(len(stem)):
            forms += "c" if self._cons(stem, i) else "v"
        # collapse runs
        collapsed = ""
        for ch in forms:
            if not collapsed or collapsed[-1] != ch:
                collapsed += ch
        return collapsed.count("vc")

    def _has_vowel(self, stem: str) -> bool:
        return any(not self._cons(stem, i) for i in range(len(stem)))

    def _ends_double_cons(self, w: str) -> bool:
        return (len(w) >= 2 and w[-1] == w[-2] and self._cons(w, len(w) - 1))

    def _cvc(self, w: str) -> bool:
        if len(w) < 3:
            return False
        if (self._cons(w, len(w) - 3) and not self._cons(w, len(w) - 2)
                and self._cons(w, len(w) - 1)):
            return w[-1] not in "wxy"
        return False

    def _replace(self, w: str, suffix: str, repl: str, m_min: int) -> Optional[str]:
        if w.endswith(suffix):
            stem = w[: len(w) - len(suffix)]
            if self._measure(stem) > m_min:
                return stem + repl
            return w
        return None

    def stem(self, word: str) -> str:
        w = word.lower()
        if len(w) <= 2:
            return w

        # step 1a
        if w.endswith("sses"):
            w = w[:-2]
        elif w.endswith("ies"):
            w = w[:-2]
        elif w.endswith("ss"):
            pass
        elif w.endswith("s"):
            w = w[:-1]

        # step 1b
        flag = False
        if w.endswith("eed"):
            if self._measure(w[:-3]) > 0:
                w = w[:-1]
        elif w.endswith("ed") and self._has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
        elif w.endswith("ing") and self._has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif self._ends_double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif self._measure(w) == 1 and self._cvc(w):
                w += "e"

        # step 1c
        if w.endswith("y") and self._has_vowel(w[:-1]):
            w = w[:-1] + "i"

        # step 2
        for suf, repl in (("ational", "ate"), ("tional", "tion"),
                          ("enci", "ence"), ("anci", "ance"),
                          ("izer", "ize"), ("abli", "able"), ("alli", "al"),
                          ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
                          ("ization", "ize"), ("ation", "ate"),
                          ("ator", "ate"), ("alism", "al"),
                          ("iveness", "ive"), ("fulness", "ful"),
                          ("ousness", "ous"), ("aliti", "al"),
                          ("iviti", "ive"), ("biliti", "ble")):
            out = self._replace(w, suf, repl, 0)
            if out is not None:
                w = out
                break

        # step 3
        for suf, repl in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                          ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                          ("ness", "")):
            out = self._replace(w, suf, repl, 0)
            if out is not None:
                w = out
                break

        # step 4
        for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                    "ement", "ment", "ent", "ou", "ism", "ate", "iti",
                    "ous", "ive", "ize"):
            if w.endswith(suf):
                if self._measure(w[: len(w) - len(suf)]) > 1:
                    w = w[: len(w) - len(suf)]
                break
        else:
            if w.endswith("ion") and len(w) > 3 and w[-4] in "st":
                if self._measure(w[:-3]) > 1:
                    w = w[:-3]

        # step 5a
        if w.endswith("e"):
            stem = w[:-1]
            m = self._measure(stem)
            if m > 1 or (m == 1 and not self._cvc(stem)):
                w = stem
        # step 5b
        if self._ends_double_cons(w) and w.endswith("l") and self._measure(w) > 1:
            w = w[:-1]
        return w


# Closed-class English words (meteor-1.5 function.words equivalent):
# determiners, prepositions, conjunctions, pronouns, auxiliaries, particles.
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
of in on at by for with about against between into through during before
after above below to from up down out off over under again further
and or but nor so yet if then than as because while although though
is am are was were be been being do does did doing have has had having
will would shall should may might must can could
not only own same too very just there here when where why how all both
what which who whom whose
""".split())

_STEMMER = PorterStemmer()


def _align(hyp: List[str], ref: List[str],
           synonyms: Optional[Dict[str, Set[str]]]
           ) -> List[Tuple[int, int, int]]:
    """Greedy stage-priority unigram alignment → [(hyp_i, ref_j, stage)].
    Stages: 0 exact, 1 stem, 2 synonym (skipped without a table)."""
    hs = [_STEMMER.stem(w) for w in hyp]
    rs = [_STEMMER.stem(w) for w in ref]

    def syn_match(a: str, b: str) -> bool:
        if synonyms is None:
            return False
        return (b in synonyms.get(a, ()) or a in synonyms.get(b, ())
                or a == b)

    stages = [
        lambda i, j: hyp[i] == ref[j],
        lambda i, j: hs[i] == rs[j],
        lambda i, j: syn_match(hyp[i], ref[j]),
    ]
    used_h = [False] * len(hyp)
    used_r = [False] * len(ref)
    matches: List[Tuple[int, int, int]] = []
    for s, pred in enumerate(stages):
        if s == 2 and synonyms is None:
            continue
        for i in range(len(hyp)):
            if used_h[i]:
                continue
            for j in range(len(ref)):
                if not used_r[j] and pred(i, j):
                    used_h[i] = used_r[j] = True
                    matches.append((i, j, s))
                    break
    matches.sort()
    return matches


def _weighted_count(words: Sequence[str], idxs, delta: float) -> float:
    return sum(delta if words[i] not in FUNCTION_WORDS else (1 - delta)
               for i in idxs)


def meteor(hyp: Sequence[str], refs: List[Sequence[str]], *,
           synonyms: Optional[Dict[str, Set[str]]] = None,
           alpha: float = 0.85, beta: float = 0.2, gamma: float = 0.6,
           delta: float = 0.75,
           stage_weights: Sequence[float] = (1.0, 0.6, 0.8)) -> float:
    """Multi-stage METEOR; best score over the reference set."""
    hyp = [w.lower() for w in hyp]
    if not hyp or not refs:
        return 0.0

    def score_one(ref: List[str]) -> float:
        ref = [w.lower() for w in ref]
        matches = _align(hyp, ref, synonyms)
        m = len(matches)
        if m == 0:
            return 0.0
        wm_h = sum(stage_weights[s] * (delta if hyp[i] not in FUNCTION_WORDS
                                       else 1 - delta)
                   for i, _, s in matches)
        wm_r = sum(stage_weights[s] * (delta if ref[j] not in FUNCTION_WORDS
                                       else 1 - delta)
                   for _, j, s in matches)
        h_tot = _weighted_count(hyp, range(len(hyp)), delta)
        r_tot = _weighted_count(ref, range(len(ref)), delta)
        p = wm_h / max(h_tot, 1e-9)
        r = wm_r / max(r_tot, 1e-9)
        if p + r == 0:
            return 0.0
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        chunks = 1
        for (i0, j0, _), (i1, j1, _) in zip(matches, matches[1:]):
            if i1 != i0 + 1 or j1 != j0 + 1:
                chunks += 1
        # Denkowski & Lavie 2014 ("Meteor Universal") eq. 3:
        # Pen = γ·(ch/m)^β, Score = (1 − Pen)·F_mean
        penalty = gamma * (chunks / m) ** beta
        return fmean * (1 - penalty)

    return max(score_one(list(r)) for r in refs)
