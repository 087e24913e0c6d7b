"""SPICE-lite: a pure-Python approximation of the SPICE caption metric.

The reference evaluates SPICE through pycocoevalcap's Java pipeline
(Stanford scene-graph parser; ``Oscar/oscar/utils/caption_evaluate.py:82``,
nocaps leaderboard keys at ``:260,320``). That pipeline cannot run here
(no JVM, zero egress), so cpt_tpu ships an explicitly-approximate
stand-in rather than silently omitting the semantic-propositional axis:

  * captions are PTB-tokenized (``utils/ptb_tokenizer.py``) and chunked
    with a small rule grammar (closed-class word lists + suffix
    heuristics — no external POS models are available offline);
  * each caption becomes a bag of semantic tuples, SPICE's universe:
    objects ``(head,)``, attributes ``(head, attr)``, and relations
    ``(head1, rel, head2)`` where a relation word is a
    preposition/copula/verb chain between two noun phrases;
  * score = F1 between the candidate tuple bag and the union of the
    reference tuple bags (binary tuple matching, lemma-exact — SPICE's
    WordNet-synset matching needs WordNet, absent offline).

Numbers are NOT comparable to Java SPICE; the metric is reported as
``SPICE_lite`` (never ``SPICE``) and is opt-in at the eval surface.

The port's copy of ``cpt_tpu/utils/spice_lite.py``: the same code, importing
the port's modules (``tests/test_torch_isolation.py`` holds it to the
original).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set, Tuple

from cpt_tpu_torch.utils.ptb_tokenizer import ptb_tokenize

DETERMINERS = {
    "a", "an", "the", "this", "that", "these", "those", "some", "any",
    "each", "every", "no", "both", "few", "several", "many", "most",
    "all", "another", "other", "its", "his", "her", "their", "our", "my",
    "your", "one", "two", "three", "four", "five", "six", "seven",
    "eight", "nine", "ten",
}
PREPOSITIONS = {
    "in", "on", "at", "by", "with", "near", "under", "over", "above",
    "below", "behind", "beside", "between", "against", "across", "around",
    "along", "inside", "outside", "onto", "into", "through", "atop",
    "beneath", "next", "of", "from", "to", "off", "up", "down", "upon",
    "underneath", "among", "amongst", "towards", "toward", "past",
}
COPULAS = {"is", "are", "was", "were", "be", "been", "being"}
AUXILIARIES = {"has", "have", "had", "does", "do", "did", "can", "could",
               "will", "would", "may", "might", "shall", "should"}
CONJUNCTIONS = {"and", "or", "but", "while", "as", "that", "which", "who"}
PRONOUNS = {"it", "he", "she", "they", "there", "here", "him", "them",
            "itself", "himself", "herself", "themselves", "something",
            "someone"}
ADVERBS = {"very", "also", "just", "not", "too", "so", "quite", "really"}
# common caption verbs whose surface form lacks a verbal suffix
BARE_VERBS = {
    "sit", "sits", "stand", "stands", "hold", "holds", "ride", "rides",
    "wear", "wears", "walk", "walks", "run", "runs", "play", "plays",
    "eat", "eats", "look", "looks", "fly", "flies", "jump", "jumps",
    "hang", "hangs", "lie", "lies", "lay", "lays", "rest", "rests",
    "graze", "grazes", "swim", "swims", "drive", "drives", "carry",
    "carries", "catch", "catches", "watch", "watches", "face", "faces",
}

_IRREGULAR_PLURALS = {
    "men": "man", "women": "woman", "children": "child", "people":
    "person", "feet": "foot", "teeth": "tooth", "geese": "goose",
    "mice": "mouse", "sheep": "sheep", "scissors": "scissors",
    "glasses": "glasses", "jeans": "jeans", "pants": "pants",
    "shorts": "shorts", "buses": "bus", "dishes": "dish",
    "benches": "bench", "sandwiches": "sandwich", "skis": "ski",
}


def lemma(word: str) -> str:
    """Cheap noun lemmatizer (plural stripping + a small irregular table)."""
    w = word.lower()
    if w in _IRREGULAR_PLURALS:
        return _IRREGULAR_PLURALS[w]
    if w.endswith("ies") and len(w) > 4:
        return w[:-3] + "y"
    if w.endswith(("ches", "shes", "sses", "xes", "zes")) and len(w) > 4:
        return w[:-2]
    if w.endswith("s") and not w.endswith(("ss", "us", "is")) and len(w) > 3:
        return w[:-1]
    return w


def _is_verbish(w: str) -> bool:
    return (w in COPULAS or w in BARE_VERBS
            or w.endswith(("ing", "ed")) and len(w) > 4)


_VERB_ING = {
    "sitting": "sit", "riding": "ride", "driving": "drive",
    "grazing": "graze", "lying": "lie", "having": "have",
    "taking": "take", "making": "make", "coming": "come",
    "writing": "write", "racing": "race", "serving": "serve",
    "smiling": "smile", "waving": "wave", "diving": "dive",
    "skating": "skate", "surfing": "surf", "biking": "bike",
    "hiding": "hide", "leaving": "leave", "moving": "move",
    "using": "use", "giving": "give", "placing": "place",
    "facing": "face", "sliding": "slide", "gliding": "glide",
    "dining": "dine", "posing": "pose", "staring": "stare",
}


def verb_lemma(w: str) -> str:
    """Normalize verb surface forms so 'sits'/'sitting'/'sit' (and
    'rides'/'riding'/'ride') produce the same relation label on both the
    candidate and reference side."""
    if w in COPULAS:
        return "be"
    if w in _VERB_ING:
        return _VERB_ING[w]
    if w.endswith("ing") and len(w) > 4:
        base = w[:-3]
        if len(base) > 2 and base[-1] == base[-2] and base[-1] not in "aeilosu":
            base = base[:-1]                     # running → run
        return base
    if w.endswith("ed") and len(w) > 3:
        base = w[:-2]
        if len(base) > 2 and base[-1] == base[-2] and base[-1] not in "aeilosu":
            base = base[:-1]
        return base
    return lemma(w)                              # third-person -s


Tuple3 = Tuple[str, ...]


def parse_tuples(caption: str) -> Set[Tuple3]:
    """caption → set of semantic tuples: ``(obj,)``, ``(obj, attr)``,
    ``(subj, rel, obj)``.

    Grammar: NPs are maximal runs of content words not interrupted by
    closed-class words or verbish tokens; the last word of an NP is its
    head object, preceding non-determiner words its attributes (SPICE
    counts adjective and noun-compound modifiers alike). A
    preposition/copula/verb chain linking two NPs yields a relation
    tuple labelled by the chain's content words.
    """
    toks = [t.lower() for t in ptb_tokenize(caption)]
    nps: List[List[str]] = []          # list of [attr..., head]
    links: List[Tuple[int, str]] = []  # (np index before link, relation)

    cur: List[str] = []

    def flush_np():
        nonlocal cur
        if cur:
            nps.append(cur)
            cur = []

    for w in toks:
        if not w.isalpha():
            flush_np()
            continue
        if w in DETERMINERS or w in ADVERBS or w in AUXILIARIES:
            flush_np()
            continue
        if w in PRONOUNS:
            flush_np()
            continue
        if w in CONJUNCTIONS:
            flush_np()
            continue
        if w in PREPOSITIONS or _is_verbish(w):
            flush_np()
            if nps:                     # a relation must have a left NP
                rel = w if w in PREPOSITIONS else verb_lemma(w)
                links.append((len(nps) - 1, rel))
            continue
        cur.append(lemma(w))
    flush_np()

    tuples: Set[Tuple3] = set()
    for np_words in nps:
        head = np_words[-1]
        tuples.add((head,))
        for attr in np_words[:-1]:
            tuples.add((head, attr))
    # relations: link (i, rel) connects NP i to NP i+1 when both exist;
    # chains like "is sitting on" produce the LAST link word only for
    # copula+verb ("sit") and the preposition for verb+prep ("sit on" →
    # prefer the most specific: verb_prep composite)
    by_pair: Dict[Tuple[int, int], List[str]] = {}
    for i, rel in links:
        if i + 1 < len(nps):
            by_pair.setdefault((i, i + 1), []).append(rel)
    for (i, j), rels in by_pair.items():
        content = [r for r in rels if r != "be"]
        rel = "_".join(content) if content else "be"
        subj = nps[i][-1]
        obj = nps[j][-1]
        tuples.add((subj, rel, obj))
    return tuples


def spice_lite_score(candidate: str, references: Sequence[str]
                     ) -> Dict[str, float]:
    """Binary-matching tuple F1 of one candidate against the union of the
    references' tuples (SPICE's corpus protocol scores per image then
    averages F-scores)."""
    cand = parse_tuples(candidate)
    ref: Set[Tuple3] = set()
    for r in references:
        ref |= parse_tuples(r)
    matched = len(cand & ref)
    p = matched / len(cand) if cand else 0.0
    r_ = matched / len(ref) if ref else 0.0
    f = 2 * p * r_ / (p + r_) if p + r_ > 0 else 0.0
    return {"precision": p, "recall": r_, "f": f}


def spice_lite_corpus(candidates: Dict[str, str],
                      references: Dict[str, Sequence[str]]) -> float:
    """Mean per-image tuple F1 over the shared keys."""
    keys = [k for k in candidates if k in references]
    if not keys:
        return 0.0
    return sum(spice_lite_score(candidates[k], references[k])["f"]
               for k in keys) / len(keys)
