"""Offline BERT WordPiece tokenizer (``bert-base-uncased`` semantics): the
port's copy of the JAX package's ``data/tokenizer.py``.

The reference tokenizes every comment with
``AutoTokenizer.from_pretrained("bert-base-uncased")``
(mDT/experiments/hateful_discussions/datasets/hateful_discussions.py:47)
and calls it with ``padding="max_length", truncation=True, max_length=100``
(hateful_discussions.py:160-166). WordPiece needs only the ``vocab.txt``
file: this module is the slow tokenizer's pipeline (``BasicTokenizer`` +
``WordpieceTokenizer``, the semantics of ``transformers.BertTokenizer``:
lower case, accents stripped, CJK characters spaced, punctuation split,
greedy longest-match subwords), so one local vocab file gives the
reference's ids without the HF hub.

The vocab is the ``vocab_path`` argument, else ``$MDT_BERT_VOCAB``.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

VOCAB_ENV = "MDT_BERT_VOCAB"

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def load_vocab(path: str) -> Dict[str, int]:
    """vocab.txt: one token per line, id = line number."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
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
    # ASCII non-alphanumeric ranges count as punctuation (HF behavior: "$"
    # or "^" split even though Unicode classes them as symbols)
    if (
        33 <= cp <= 47
        or 58 <= cp <= 64
        or 91 <= cp <= 96
        or 123 <= cp <= 126
    ):
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
    """Whitespace/punctuation pre-tokenizer with lowercasing and accent
    stripping (transformers BertTokenizer BasicTokenizer semantics)."""

    def __init__(
        self,
        do_lower_case: bool = True,
        never_split: Sequence[str] = (PAD, UNK, CLS, SEP, MASK),
    ):
        self.do_lower_case = do_lower_case
        self.never_split = frozenset(never_split)

    def tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        # HF normalizes to NFC before splitting
        text = unicodedata.normalize("NFC", text)
        out: List[str] = []
        for tok in text.split():
            if tok in self.never_split:
                out.append(tok)
                continue
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_on_punc(tok))
        return out

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _tokenize_chinese_chars(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_on_punc(text: str) -> List[str]:
        pieces: List[str] = []
        word: List[str] = []
        for ch in text:
            if _is_punctuation(ch):
                if word:
                    pieces.append("".join(word))
                    word = []
                pieces.append(ch)
            else:
                word.append(ch)
        if word:
            pieces.append("".join(word))
        return pieces


class WordpieceTokenizer:
    """Greedy longest-match-first subword splitter."""

    def __init__(
        self,
        vocab: Dict[str, int],
        unk_token: str = UNK,
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens


class BertWordPieceTokenizer:
    """End-to-end offline ``bert-base-uncased``-style tokenizer.

    ``__call__`` mirrors the HF fast-tokenizer call the reference makes
    (hateful_discussions.py:160-166): a list of strings -> dict of
    (n, max_length) int32 arrays ``input_ids`` / ``token_type_ids`` /
    ``attention_mask`` with [CLS] ... [SEP] framing, truncation, and
    [PAD] (id 0) right-padding.
    """

    def __init__(
        self,
        vocab_path: Optional[str] = None,
        do_lower_case: bool = True,
    ):
        path = vocab_path or os.environ.get(VOCAB_ENV)
        if not path:
            raise FileNotFoundError(
                f"no BERT vocab: pass vocab_path or set ${VOCAB_ENV}"
            )
        self.vocab = load_vocab(path)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece = WordpieceTokenizer(self.vocab)
        for tok in (PAD, UNK, CLS, SEP):
            if tok not in self.vocab:
                raise ValueError(f"vocab at {path} lacks {tok}")
        self.pad_id = self.vocab[PAD]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            if word in self.basic.never_split:
                out.append(word)
            else:
                out.extend(self.wordpiece.tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[UNK]
        return [self.vocab.get(t, unk) for t in tokens]

    def encode(
        self, text: str, max_length: int = 100
    ) -> Dict[str, np.ndarray]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        ids = ids[: max_length - 2]  # truncation=True reserves [CLS]/[SEP]
        ids = [self.cls_id] + ids + [self.sep_id]
        n = len(ids)
        input_ids = np.full(max_length, self.pad_id, np.int32)
        input_ids[:n] = ids
        attention_mask = np.zeros(max_length, np.int32)
        attention_mask[:n] = 1
        token_type_ids = np.zeros(max_length, np.int32)
        return {
            "input_ids": input_ids,
            "token_type_ids": token_type_ids,
            "attention_mask": attention_mask,
        }

    def __call__(
        self, texts: Sequence[str], max_length: int = 100
    ) -> Dict[str, np.ndarray]:
        encs = [self.encode(t, max_length) for t in texts]
        return {
            k: np.stack([e[k] for e in encs])
            for k in ("input_ids", "token_type_ids", "attention_mask")
        }


def find_vocab(vocab_path: Optional[str] = None) -> Optional[str]:
    """Resolve a usable vocab file path, or None if unavailable."""
    path = vocab_path or os.environ.get(VOCAB_ENV)
    return path if path and os.path.exists(path) else None
