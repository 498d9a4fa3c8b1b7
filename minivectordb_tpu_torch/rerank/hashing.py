"""Char n-gram hashing vectorizer (sklearn HashingVectorizer equivalent).

Replaces the reference's sklearn dependency
(``HashingVectorizer(ngram_range=(1, 6), analyzer='char', n_features=64)``,
reference vector_database.py:9, 388-393): lowercased character 1..6-grams,
signed murmur3 feature hashing into 64 buckets, L2-normalized.

The n-grams are hashed by the C++ fast path (native/fastops) when its
library is built, else by the pure-Python murmur3 below, with the same
result, as the JAX package does.
Exact sklearn bit-parity is not required by the reference's tests (only the
cosine-similarity *behavior* matters for reranking), but the algorithm —
including murmur3 seed 0 over UTF-8 bytes and alternate-sign hashing — is
the same, so scores are equivalent.
"""

from __future__ import annotations

import numpy as np

from minivectordb_tpu_torch.native import fastops

N_FEATURES = 64
NGRAM_MIN, NGRAM_MAX = 1, 6


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit (Austin Appleby's algorithm), returns uint32."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    length = len(data)
    n_blocks = length // 4
    for i in range(n_blocks):
        k = int.from_bytes(data[i * 4 : i * 4 + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[n_blocks * 4 :]
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
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _char_ngrams(text: str):
    text = text.lower()
    n = len(text)
    for size in range(NGRAM_MIN, min(NGRAM_MAX, n) + 1):
        for i in range(n - size + 1):
            yield text[i : i + size]


def hash_text_features(text: str) -> np.ndarray:
    """64-dim signed-hash char-ngram feature vector, L2-normalized.

    Mirrors reference ``_fetch_hash_text_features`` (vector_database.py:388-393).
    """
    vec = fastops.hash_ngrams(text.lower(), N_FEATURES, NGRAM_MIN, NGRAM_MAX)
    if vec is None:  # no native library: the same hashing in Python
        vec = np.zeros(N_FEATURES, dtype=np.float64)
        for gram in _char_ngrams(text):
            h = murmur3_32(gram.encode("utf-8"))
            signed = h - 0x100000000 if h >= 0x80000000 else h  # int32 view
            idx = abs(signed) % N_FEATURES
            vec[idx] += 1.0 if signed >= 0 else -1.0
    norm = np.linalg.norm(vec)
    return vec / norm if norm > 0 else vec


def text_hash_scores(query: str, documents: list[str]) -> list[float]:
    """Cosine similarity of hashed query vs each document
    (reference ``_calculate_text_hash_scores``, vector_database.py:395-408)."""
    if len(documents) == 0:
        return []
    qv = hash_text_features(query)
    scores = []
    for doc in documents:
        dv = hash_text_features(doc)
        scores.append(float(np.dot(qv, dv)))
    return scores
