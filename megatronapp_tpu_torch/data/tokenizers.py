"""Tokenizers the serving slice uses.

A copy of the JAX package's ``NullTokenizer`` (data/tokenizers.py): the
integer-string passthrough that serves random weights without tokenizer
files. The Hugging Face wrappers come with the data slice.
"""

from __future__ import annotations

from typing import List


class NullTokenizer:
    """Integer-string passthrough (reference NullTokenizer) — for synthetic
    and pre-tokenized data."""

    def __init__(self, vocab_size: int):
        self._vocab_size = vocab_size
        self.eod = vocab_size - 1

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def tokenize(self, text: str) -> List[int]:
        return [int(t) for t in text.split()]

    def detokenize(self, ids: List[int]) -> str:
        return " ".join(str(i) for i in ids)

