"""Text tokenization for report/prompt encoding (the port's own copy of
vit_exp_tpu/data/tokenizer.py: the same ids for the same text).

The reference tokenizes with HF BertTokenizer('microsoft/BiomedVLP-CXR-
BERT-specialized', do_lower_case=True), padding='max_length', truncation,
max_length=512 (CTCLIPTrainer.py:553-581, ct_clip.py:650).  Weights/vocabs
cannot be downloaded here, so:

- WordPieceTokenizer: a self-contained BERT-style WordPiece implementation
  that loads any HF-format vocab.txt (one token per line).  Matches the
  BertTokenizer pipeline: basic cleanup → lowercase → punctuation split →
  greedy longest-match WordPiece with '##' continuations → [CLS] x [SEP] →
  pad/truncate to max_length.
- HashTokenizer: deterministic hashing fallback for tests and synthetic
  data (no vocab file needed).

Both return {"input_ids", "attention_mask"} numpy int32 arrays.
"""

from __future__ import annotations

import hashlib
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

MAX_LEN = 512


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch) in ("Cc", "Cf")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _strip_accents(text: str) -> str:
    return "".join(ch for ch in unicodedata.normalize("NFD", text)
                   if unicodedata.category(ch) != "Mn")


def _basic_tokens(text: str, lower: bool = True) -> List[str]:
    """HF BertTokenizer BasicTokenizer pipeline, byte-for-byte: clean text
    (drop NUL/U+FFFD/control chars, fold whitespace), space out CJK chars,
    whitespace-split, then per token lowercase → strip accents (NFD, drop
    Mn — HF default when do_lower_case=True) → split on punctuation.
    Differential-tested against transformers.BertTokenizerFast in
    tests/test_tokenizer_hf.py."""
    cleaned: List[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            cleaned.append(" " + ch + " ")
        elif _is_whitespace(ch):
            cleaned.append(" ")
        else:
            cleaned.append(ch)
    out: List[str] = []
    for token in "".join(cleaned).split():
        if lower:
            token = _strip_accents(token.lower())
        word: List[str] = []
        for ch in token:
            if _is_punct(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
    return out


class WordPieceTokenizer:
    def __init__(
        self,
        vocab_path: str,
        *,
        lower_case: bool = True,
        max_length: int = MAX_LEN,
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        unk_token: str = "[UNK]",
    ):
        with open(vocab_path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab = {t: i for i, t in enumerate(tokens)}
        self.lower_case = lower_case
        self.max_length = max_length
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.pad_id = self.vocab[pad_token]
        self.unk_id = self.vocab[unk_token]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def __call__(
        self, texts: Sequence[str] | str, max_length: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        ids = np.full((len(texts), max_length), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for row, text in enumerate(texts):
            toks: List[int] = [self.cls_id]
            for word in _basic_tokens(text, self.lower_case):
                toks.extend(self._wordpiece(word))
                if len(toks) >= max_length - 1:
                    break
            toks = toks[: max_length - 1] + [self.sep_id]
            ids[row, : len(toks)] = toks
            mask[row, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class HashTokenizer:
    """Deterministic test/synthetic tokenizer: word → stable hash id."""

    def __init__(self, vocab_size: int = 30522, max_length: int = MAX_LEN):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.cls_id, self.sep_id, self.pad_id = 101, 102, 0

    def _hash(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return 1000 + h % (self.vocab_size - 1000)

    def __call__(self, texts, max_length=None):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        ids = np.full((len(texts), max_length), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for row, text in enumerate(texts):
            toks = [self.cls_id] + [
                self._hash(w) for w in _basic_tokens(text)
            ]
            toks = toks[: max_length - 1] + [self.sep_id]
            ids[row, : len(toks)] = toks
            mask[row, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_tokenizer(vocab_path: Optional[str] = None, vocab_size: int = 30522):
    """vocab.txt path → WordPieceTokenizer, else HashTokenizer fallback."""
    if vocab_path:
        return WordPieceTokenizer(vocab_path)
    return HashTokenizer(vocab_size=vocab_size)
