"""Self-contained BERT WordPiece tokenizer (the port's copy of
``cpt_tpu/utils/tokenization.py``).

The reference relies on a pinned external HuggingFace ``pytorch_transformers``
clone (reference ``Oscar/install.sh:33-36``) for ``BertTokenizer``. We
implement the identical, well-documented uncased BERT tokenization algorithm
(basic tokenization: lowercase + accent strip + punctuation/CJK split, then
greedy longest-match-first WordPiece) natively so the framework has zero
network/vendored dependencies. The vocab file is the standard one-token-per-
line ``vocab.txt``; with bert-base-uncased's vocab this reproduces the
reference's token ids exactly (mask id 103, hard-coded at reference
``Oscar/oscar/datasets/refcoco_fsl_cpt_dataset.py:75``).
"""
from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Union


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            vocab[token] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True, never_split: Sequence[str] = ()):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if tok in self.never_split:
                tokens.append(tok)
                continue
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return tokens

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    def _split_punct(self, token: str) -> List[str]:
        if token in self.never_split:
            return [token]
        out: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]


class WordpieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, token: str) -> List[str]:
        if len(token) > self.max_chars_per_word:
            return [self.unk_token]
        sub_tokens: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                piece = token[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            sub_tokens.append(cur)
            start = end
        return sub_tokens


class BertTokenizer:
    """Uncased BERT tokenizer over a vocab.txt, HF-compatible token ids."""

    SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

    def __init__(self, vocab: Union[str, Dict[str, int]], do_lower_case: bool = True):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case=do_lower_case,
                                    never_split=self.SPECIALS)
        self.wordpiece = WordpieceTokenizer(vocab)

    # --- core API (mirrors the reference tokenizer surface used by CPT) ----
    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic.tokenize(text):
            if tok in self.SPECIALS:
                out.append(tok)
            else:
                out.extend(self.wordpiece.tokenize(tok))
        return out

    def add_special_tokens(self, tokens: Sequence[str]) -> None:
        """Reference ``tokenizer.add_special_tokens({'additional_special_
        tokens': [...]})`` analogue (sgd_to_explore_template.py:390):
        never split these during basic tokenization. They must already
        exist in the vocab (e.g. BERT's ``[unusedN]`` rows) — WordPiece
        then matches the whole token."""
        self.basic.never_split.update(tokens)

    def convert_tokens_to_ids(
        self, tokens: Union[str, Sequence[str]]
    ) -> Union[int, List[int]]:
        unk = self.vocab.get("[UNK]", 0)
        if isinstance(tokens, str):
            return self.vocab.get(tokens, unk)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_tokens.get(i, "[UNK]") for i in ids]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # string token attributes (reference tokenizer surface: used by e.g.
    # run_retrieval.py tensorize_example via tokenizer.cls_token)
    cls_token = "[CLS]"
    sep_token = "[SEP]"
    pad_token = "[PAD]"
    mask_token = "[MASK]"
    unk_token = "[UNK]"

    @property
    def mask_token_id(self) -> int:
        return self.vocab["[MASK]"]

    @property
    def pad_token_id(self) -> int:
        return self.vocab["[PAD]"]

    @property
    def cls_token_id(self) -> int:
        return self.vocab["[CLS]"]

    @property
    def sep_token_id(self) -> int:
        return self.vocab["[SEP]"]


def toy_vocab(extra_words: Sequence[str] = ()) -> Dict[str, int]:
    """Deterministic small vocab for tests: specials at the canonical
    bert-base-uncased positions ([PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102,
    [MASK]=103) so hard-coded-id code paths are exercised faithfully."""
    vocab = {f"[unused{i}]": i for i in range(104)}
    vocab["[PAD]"] = 0
    vocab["[UNK]"] = 100
    vocab["[CLS]"] = 101
    vocab["[SEP]"] = 102
    vocab["[MASK]"] = 103
    words = [
        "red", "blue", "green", "yellow", "purple", "pink", "gray", "brown",
        "none", "color", "is", "in", "the", "a", "man", "woman", "dog", "cat",
        "person", "people", "left", "right", "on", "of", "and", "what", "##s",
        ".", ",", "?",
    ]
    for w in list(words) + list(extra_words):
        if w not in vocab:
            vocab[w] = len(vocab)
    return vocab
