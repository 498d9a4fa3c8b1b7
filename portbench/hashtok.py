"""A frozen copy of the port's offline hashing tokenizer (XLM-R special ids,
one murmur3 hash a word or punctuation mark), for the reference and for the
token ids the benchmark feeds the training step.

It is copied, not imported, so a later change to the program's tokenizer
shows as a difference from the reference rather than moving the reference.
"""

from __future__ import annotations

import re

BOS_ID, PAD_ID, EOS_ID = 0, 1, 2
_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n_blocks = len(data) // 4
    for i in range(n_blocks):
        k = int.from_bytes(data[i * 4:i * 4 + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[n_blocks * 4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


class HashTokenizer:
    """Lower-cases, splits into words and punctuation marks, hashes each into
    [4, vocab_size), frames the ids with BOS and EOS and cuts at
    ``max_length`` ids. ``prefix`` is prepended to the text (the e5
    convention: "passage " for documents)."""

    def __init__(self, vocab_size: int, prefix: str = ""):
        self.vocab_size = vocab_size
        self.prefix = prefix
        self._memo: dict[str, int] = {}

    def _id(self, tok: str) -> int:
        got = self._memo.get(tok)
        if got is None:
            got = 4 + murmur3_32(tok.encode("utf-8")) % (self.vocab_size - 4)
            self._memo[tok] = got
        return got

    def encode(self, text: str, max_length: int = 512) -> list[int]:
        ids = [BOS_ID]
        for tok in _WORD_RE.findall((self.prefix + text).lower()):
            ids.append(self._id(tok))
            if len(ids) >= max_length - 1:
                break
        ids.append(EOS_ID)
        return ids
