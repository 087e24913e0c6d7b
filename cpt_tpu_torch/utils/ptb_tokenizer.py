"""Pure-Python PTBTokenizer parity for caption evaluation.

The reference's ``evaluate_on_coco_caption`` (``Oscar/oscar/utils/
caption_evaluate.py:59-90``) delegates to pycocoevalcap, whose
``PTBTokenizer`` shells out to the Stanford CoreNLP jar::

    java ... edu.stanford.nlp.process.PTBTokenizer -preserveLines -lowerCase

and then drops a fixed punctuation-token list from the jar's output.
This module reproduces that pipeline without Java:

* tokenization — NLTK's ``TreebankWordTokenizer`` (a faithful pure-Python
  port of the PTB sed script; same contraction splits ``'s / n't / 'll``,
  punctuation separation, quote conversion ```` `` '' ````) with
  ``convert_parentheses=True`` (CoreNLP's default ptb3Escaping emits
  ``-LRB-``/``-RRB-``);
* ``-lowerCase`` — tokens lowercased after tokenization (so ``-LRB-``
  becomes ``-lrb-`` and — replicating a quirk of the pycocoevalcap
  filter, which compares against the uppercase forms — is then KEPT);
* punctuation removal — pycocoevalcap's exact ``PUNCTUATIONS`` list.

Falls back to the round-2 lowercase+strip approximation if NLTK is
absent.

The port's copy of ``cpt_tpu/utils/ptb_tokenizer.py``: the same code,
importing the port's modules (``tests/test_torch_isolation.py`` holds it to
the original).
"""
from __future__ import annotations

import re
from typing import List

# pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS, verbatim
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]

_PUNCT_FALLBACK = re.compile(r"[^\w\s]")

try:
    from nltk.tokenize import TreebankWordTokenizer

    _TREEBANK = TreebankWordTokenizer()
except Exception:  # pragma: no cover - nltk is in the image
    _TREEBANK = None


def ptb_tokenize(text: str) -> List[str]:
    """One caption → PTB tokens, lowercased, punctuation tokens removed
    (the pycocoevalcap jar pipeline)."""
    if _TREEBANK is None:
        return _PUNCT_FALLBACK.sub(" ", text.lower()).split()
    toks = _TREEBANK.tokenize(text.replace("\n", " "),
                              convert_parentheses=True)
    # lowercase BEFORE the filter, as the jar does — "-lrb-" no longer
    # matches the uppercase list entry and is kept, like the reference
    return [t for t in (t.lower() for t in toks) if t not in PUNCTUATIONS]
