"""GQA question simplification from GQA annotations, the rule parser (the
port's copy of ``cpt_tpu/data/gqa_parse.py``).

Behavioral parity with ``prompt_feat/other/parse_gqa/myparse.py``: GQA
questions carry (a) char-span → object annotations and (b) the semantic
construction program. The parser simplifies relational clauses so the
colored-mark prompt refers to the head entity:

  * ``simple_parse`` (``myparse.py:6-40``): keeps only the first annotated
    entity span per chain — "the man that is wearing a black shirt" →
    "the man" — using span ordering and the that/and/or rules.
  * ``gt_parse`` (``myparse.py:110-151``): walks the semantic program's
    ``relate`` operations backwards, matches subject/predicate/object
    words, and eliminates the span between them (``_eliminate``).

Both return the simplified question string ending in "?". The output feeds
``to_mark.json`` consumed by the GQA mark dataset (``gqadataset.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional


def _spans_from_annotations(ann: Dict[str, str]) -> List[slice]:
    spans = []
    for k in ann:
        if ":" in k:
            a, b = k.split(":")
            spans.append(slice(int(a), int(b)))
        else:
            spans.append(slice(int(k), int(k) + 1))
    return sorted(spans, key=lambda s: s.start)


def simple_parse(entry: Dict) -> str:
    """Span-rule simplification (``myparse.py:6-40``)."""
    q = entry["question"]
    spans = _spans_from_annotations(entry["annotations"]["question"])
    words = q.replace("?", "").split()
    if len(spans) <= 1:
        return " ".join(words) + "?"
    keep = [True] * len(words)
    for i in range(len(spans) - 1, 0, -1):
        now, prev = spans[i], spans[i - 1]
        if prev.stop < len(words) and words[prev.stop] == "that":
            for j in range(prev.stop, now.stop):
                keep[j] = False
        elif ("and" in words[prev.stop:now.start]
              or "or" in words[prev.stop:now.start]):
            continue
        elif len(words) != now.stop:
            for j in range(prev.stop, now.stop):
                keep[j] = False
    return " ".join(w for w, f in zip(words, keep) if f) + "?"


def _match_predicate(words: List[str], key: str) -> int:
    sentence = " ".join(words)
    idx = sentence.rfind(key)
    if idx == -1:
        return -1
    begins = []
    ptr = 0
    for w in words:
        begins.append(ptr)
        ptr += len(w) + 1
    begins.append(10 ** 6)
    end = idx + len(key) - 1
    for i in range(len(words)):
        if begins[i] < end < begins[i + 1]:
            return i
    return -1


def _match(words: List[str], key: str) -> int:
    best = _match_predicate(words, key)
    if best != -1:
        return best
    max_len = 0
    for i, w in enumerate(words):
        matched = -1
        if key in w:
            matched = len(key)
        if w in key:
            matched = len(w)
        if matched >= max_len:
            best = i
            max_len = matched
    return best


def _another_name(proc: Dict, question: str, program: List[Dict]
                  ) -> Optional[str]:
    op = proc["operation"]
    if op == "select":
        return proc["argument"].split("(")[0].strip()
    if op == "relate":
        subj, _pred, obj = proc["argument"].split(",")
        if "(" in subj:
            return obj
        if "(" in obj:
            return subj
    if "filter" in op:
        deps = proc.get("dependencies", [])
        if deps:
            prev = program[deps[0]]
            pre_word = prev["argument"].split("(")[0].strip()
            if question.rfind(pre_word) > question.rfind(proc["argument"]):
                return pre_word
        return proc["argument"]
    return None


def gt_parse(entry: Dict) -> str:
    """Semantic-program simplification (``myparse.py:110-151``)."""
    q = entry["question"]
    words = q.replace("?", "").split()
    program = entry["semantic"]
    keep = [True] * len(words)
    for proc in program[::-1]:
        if proc["operation"] != "relate":
            continue
        subj, pred, obj = proc["argument"].split(",")
        if subj == "_" or obj == "_":
            continue
        deps = proc.get("dependencies", [])
        another = (_another_name(program[deps[0]], q, program)
                   if deps else None)
        if "(" in subj:
            subj = another
        elif "(" in obj:
            obj = another
        if subj is None or obj is None:
            continue
        obj_idx = _match(words, obj)
        subj_idx = _match(words, subj)
        pred_idx = _match_predicate(words, pred)
        lo = min(obj_idx, subj_idx, pred_idx)
        hi = max(obj_idx, subj_idx, pred_idx)
        if obj_idx == subj_idx or lo == -1:
            continue
        for j in range(lo + 1, hi + 1):
            if j < len(keep):
                keep[j] = False
    return " ".join(w for w, f in zip(words, keep) if f) + "?"


def build_to_mark(entries: Dict[str, Dict], use_semantic: bool = True
                  ) -> Dict[str, str]:
    """{qid: simplified question} — the ``to_mark.json`` payload."""
    parse = gt_parse if use_semantic else simple_parse
    return {qid: parse(v) for qid, v in entries.items()}
