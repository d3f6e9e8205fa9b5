"""Sentence-shuffle augmentation (counterpart of
vit_exp_tpu/text_classifier/augmentation.py): with probability p, split the
report into sentences (a light regex) and shuffle them.  The same numpy
Generator calls in the same order, so a generator in the same state gives
the same text as the JAX package's."""

from __future__ import annotations

import re

import numpy as np

_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str):
    return [s for s in _SENT_RE.split(text.strip()) if s]


def shuffle_sentences_augment(text: str, p: float = 0.5, rng=None) -> str:
    if not 0 <= p <= 1:
        raise ValueError("p must be a fraction between 0 and 1")
    if not text.strip():
        return text
    rng = rng or np.random.default_rng()
    if rng.uniform() < p:
        sentences = split_sentences(text)
        rng.shuffle(sentences)
        return " ".join(sentences)
    return text
