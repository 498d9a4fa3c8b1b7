"""Fuzzy partial-ratio string similarity (thefuzz / python-Levenshtein
equivalent, reference vector_database.py:5, 410-411).

``partial_ratio(a, b)`` slides the shorter string along the longer and takes
the best local similarity, scaled to 0..100 — the classic fuzzywuzzy
algorithm. The similarity kernel is Indel similarity (Levenshtein with
insertions/deletions only), computed by the C++ fast path (native/fastops)
when its library is built, else by the pure-Python bit-parallel code below at
every needle length; both return the same values.
"""

from __future__ import annotations

from minivectordb_tpu_torch.native import fastops


def _indel_ratio(s1: str, s2: str) -> float:
    """Normalized Indel similarity in [0, 1] (rapidfuzz-style ratio)."""
    if not s1 and not s2:
        return 1.0
    lensum = len(s1) + len(s2)
    if lensum == 0:
        return 1.0
    dist = _indel_distance(s1, s2)
    return (lensum - dist) / lensum


def _peq_of(s: str) -> dict:
    """Hyyro's Peq table: for each char, the bit set of its positions in s."""
    peq: dict = {}
    for i, ch in enumerate(s):
        peq[ch] = peq.get(ch, 0) | (1 << i)
    return peq


def _lcs(peq: dict, m: int, text: str) -> int:
    """LCS length of ``text`` and the m-char string whose Peq table is
    ``peq``, by Hyyro's bit-parallel algorithm. Python ints hold any width,
    so needles past 64 chars take the same path (the JAX package runs a
    quadratic DP there, with the same result: both are exact)."""
    full = (1 << m) - 1
    v = full
    for ch in text:
        u = v & peq.get(ch, 0)
        # fixed-width (mod 2^m) arithmetic: discard the carry-out
        v = ((v + u) | (v - u)) & full
    return m - v.bit_count()


def _indel_distance(s1: str, s2: str) -> int:
    """Indel (LCS-based) edit distance: len1 + len2 - 2*LCS."""
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    if not s2:
        return len(s1)
    return len(s1) + len(s2) - 2 * _lcs(_peq_of(s2), len(s2), s1)


def ratio(s1: str, s2: str) -> int:
    """Full-string similarity 0..100 (thefuzz.fuzz.ratio equivalent).
    Rounds half-up to match the C++ fast path exactly."""
    return int(100 * _indel_ratio(s1, s2) + 0.5)


def partial_ratio(s1: str, s2: str) -> int:
    """Best-window similarity 0..100 (thefuzz.fuzz.partial_ratio equivalent)."""
    r = fastops.partial_ratio(s1, s2)
    if r is not None:
        return r
    if s1 == s2:
        return 100
    if not s1 or not s2:
        return 0
    shorter, longer = (s1, s2) if len(s1) <= len(s2) else (s2, s1)
    m = len(shorter)
    # Exhaustive window slide (same as the C++ fast path, so results are
    # identical with or without the native library; strictly better than
    # fuzzywuzzy's matching-blocks heuristic at rerank-scale inputs).
    # The needle's Peq table is built once. Each window's
    # _indel_ratio(shorter, window) is (2m - dist) / 2m = LCS / m, the same
    # float (both are the correctly rounded quotient of one rational).
    peq = _peq_of(shorter)
    best = 0.0
    for start in range(0, len(longer) - m + 1):
        r = _lcs(peq, m, longer[start : start + m]) / m
        if r > 0.995:
            return 100
        best = max(best, r)
    return int(100 * best + 0.5)


def fuzzy_ratios(query: str, documents: list[str]) -> list[int]:
    """Reference ``_calculate_fuzzy_ratios`` (vector_database.py:410-411)."""
    return [partial_ratio(query, doc) for doc in documents]
