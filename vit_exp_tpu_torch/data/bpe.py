"""Byte-pair-encoding tokenizers (counterpart of vit_exp_tpu/data/bpe.py;
pure Python, the port's own copy): the CLIP SimpleTokenizer slot (BERT
tokenization is what production uses, but the BPE capability is part of
the surface), and RoBERTa's byte-level BPE.

Loads an OpenAI-CLIP-format merges file (one merge pair per line, first
line a version header) and tokenizes with byte-level pre-encoding,
end-of-word '</w>' markers, greedy lowest-rank merging, and
<|startoftext|>/<|endoftext|> framing.
"""

from __future__ import annotations

import gzip
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# CLIP SimpleTokenizer pre-split (ct_clip/tokenizer.py:77-79):
# letter runs \p{L}+ -> [^\W\d_]+ ; SINGLE digits \p{N} -> \d ;
# punctuation runs [^\s\p{L}\p{N}]+ (underscore included, digits split
# out) -> (?:[^\w\s]|_)+.  "covid19!!" -> covid, 1, 9, !! like the
# reference, not covid19, !, !.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\w\s]|_)+",
    re.IGNORECASE,
)


def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(33, 127)) + list(range(161, 173))
          + list(range(174, 256)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class BPETokenizer:
    def __init__(self, merges_path: str, max_length: int = 77):
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines[1:] if line and
                  len(line.split()) == 2]
        self.ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)
        }
        self.byte_encoder = _bytes_to_unicode()

        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.max_length = max_length
        self.vocab_size = len(vocab)
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1
                        and (word[i], word[i + 1]) == best):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        text = re.sub(r"\s+", " ", text.strip().lower())
        for tok in _PAT.findall(text):
            btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            out += [self.encoder.get(p, 0) for p in self._bpe(btok)]
        return out

    def __call__(self, texts: Sequence[str] | str,
                 max_length: Optional[int] = None) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for row, text in enumerate(texts):
            toks = [self.sot] + self.encode(text)
            toks = toks[: max_length - 1] + [self.eot]
            ids[row, : len(toks)] = toks
            mask[row, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class ByteLevelBPETokenizer:
    """RoBERTa/GPT-2 byte-level BPE — the RadBERT tokenizer family
    (text_classifier/classifier.py:22 loads 'zzxslp/RadBERT-RoBERTa-4m',
    a RoBERTa checkpoint whose tokenizer is HF's byte-level BPE).

    Loads HF-format vocab.json + merges.txt.  Pipeline matches
    RobertaTokenizerFast: GPT-2 regex pre-split (contractions, ' ?\\p{L}+',
    ' ?\\p{N}+', punctuation runs, trailing-space handling), byte→unicode
    encoding with the Ġ space marker, greedy lowest-rank merging (no
    end-of-word marker, unlike the CLIP variant above), and <s> x </s>
    framing with <pad> fill.  ``regex`` is imported when one is built.
    """

    def __init__(self, vocab_path: str, merges_path: str,
                 max_length: int = 512, *,
                 bos_token: str = "<s>", eos_token: str = "</s>",
                 pad_token: str = "<pad>", unk_token: str = "<unk>"):
        import regex

        with open(vocab_path, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines
                  if line and not line.startswith("#version")
                  and len(line.split()) == 2]
        self.ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_id = self.encoder[bos_token]
        self.eos_id = self.encoder[eos_token]
        self.pad_id = self.encoder[pad_token]
        self.unk_id = self.encoder[unk_token]
        self.max_length = max_length
        self.vocab_size = len(self.encoder)
        self._pat = regex.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
            r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for tok in self._pat.findall(text):
            btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            out += [self.encoder.get(p, self.unk_id)
                    for p in self._bpe(btok)]
        return out

    def __call__(self, texts: Sequence[str] | str,
                 max_length: Optional[int] = None) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for row, text in enumerate(texts):
            toks = ([self.bos_id] + self.encode(text)[: max_length - 2]
                    + [self.eos_id])
            ids[row, : len(toks)] = toks
            mask[row, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}
