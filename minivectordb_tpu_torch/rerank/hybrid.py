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

Candidate sets of 32 or more route to the batched device rerank
(rerank/device.py), as in the JAX package. Deliberate difference: an error
on the device path reaches the caller, under ``device=None`` too — the JAX
package swallows it there and carries on on the host, which would hide the
device. The host path keeps the reference's graceful degrade.
"""

from __future__ import annotations

import numpy as np

from minivectordb_tpu_torch.rerank.fuzzy import fuzzy_ratios
from minivectordb_tpu_torch.rerank.hashing import text_hash_scores

DEFAULT_WEIGHTS = (0.80, 0.15, 0.05)

# Candidate counts at or above this route to the batched device rerank
# (rerank/device.py) — at reference scale (k=6) host Python wins on latency;
# at candidate-set scale the batched device path wins.
DEVICE_RERANK_THRESHOLD = 32


def hybrid_rerank_results(
    sentences, search_scores, query, k=5, weights=DEFAULT_WEIGHTS,
    device: bool | None = None, *, torch_device=None,
):
    """device=True runs the batched device rerank, False the host path;
    None (default) routes by candidate count. torch_device: where the device
    rerank runs; ``None`` means the CUDA card and raises when there is none
    (the database classes pass their own device)."""
    use_device = (
        device
        if device is not None
        else len(sentences) >= DEVICE_RERANK_THRESHOLD
    )
    if use_device:
        from minivectordb_tpu_torch.rerank.device import hybrid_rerank_device

        return hybrid_rerank_device(
            sentences, search_scores, query, k=k, weights=weights,
            device=torch_device,
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
