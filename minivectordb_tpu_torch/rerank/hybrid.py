"""Hybrid reranking: search score + char-ngram hash cosine + fuzzy ratio.

One shared implementation of the reference's ``hybrid_rerank_results``
(vector_database.py:413-441, duplicated into all three database classes).

Semantics preserved:
- combined = 0.80*search + 0.15*text_hash_cosine + 0.05*fuzzy_partial_ratio,
  with the fuzzy term UNNORMALIZED 0..100 exactly as in the reference
  (vector_database.py:424) — so absolute score magnitudes match (README
  examples show scores ~3-4.4).
- any exception degrades gracefully to the truncated inputs
  (vector_database.py:439-441).

Deliberate fix vs. the reference (SURVEY.md C5): the reference stacks
sentences and scores into one numpy string array, so its sort is
LEXICOGRAPHIC on stringified floats and it returns numpy strings
(vector_database.py:427-438). Here the sort is numeric and scores come back
as floats. Orderings agree on the reference's own tests.

Port note: the JAX package routes candidate sets of 32 or more to a batched
device program (rerank/device.py). That module is not ported yet (ROADMAP
queue 1, item "rerank/device.py"), so ``device=True`` raises
``NotImplementedError`` and ``device=None`` / ``device=False`` take the host
path at every candidate count. Both paths compute the same scores.
"""

from __future__ import annotations

import numpy as np

from minivectordb_tpu_torch.rerank.fuzzy import fuzzy_ratios
from minivectordb_tpu_torch.rerank.hashing import text_hash_scores

DEFAULT_WEIGHTS = (0.80, 0.15, 0.05)


def hybrid_rerank_results(
    sentences, search_scores, query, k=5, weights=DEFAULT_WEIGHTS,
    device: bool | None = None,
):
    """device=None or False: host path. device=True: not ported yet."""
    if device:
        raise NotImplementedError(
            "hybrid_rerank_results(device=True) needs rerank/device.py, "
            "which is not ported yet (ROADMAP.md, queue 1: rerank/device.py)"
        )
    try:
        hash_scores = text_hash_scores(query, sentences)
        fuzz_scores = fuzzy_ratios(query, sentences)

        if len(hash_scores) == 0:
            return sentences[:k], search_scores[:k]

        w_search, w_hash, w_fuzzy = weights
        combined = (
            w_search * np.asarray(search_scores, dtype=np.float64)
            + w_hash * np.asarray(hash_scores, dtype=np.float64)
            + w_fuzzy * np.asarray(fuzz_scores, dtype=np.float64)
        )

        order = np.argsort(-combined, kind="stable")
        ranked_sentences = tuple(sentences[i] for i in order)
        ranked_scores = tuple(float(combined[i]) for i in order)
        return ranked_sentences[:k], ranked_scores[:k]
    except Exception:
        return sentences[:k], search_scores[:k]
