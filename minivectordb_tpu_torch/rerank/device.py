"""Device-side hybrid rerank: hash-feature cosine + fuzzy partial-ratio over
the whole candidate batch, as PyTorch integer ops on one device.

Counterpart of ``minivectordb_tpu/rerank/device.py`` (there ``jnp`` fused by
XLA, not a Pallas kernel). It is the batched path for large candidate sets
(32 and more, rerank/hybrid.py); the host path stays the default at small k,
and the two produce identical rankings.

What runs on the device:
- murmur3-32 of every char 1..6-gram of every candidate (the sklearn
  HashingVectorizer equivalence, reference vector_database.py:388-393),
  signed-bucketed into 64 features, L2-normalized, cosine vs the query row;
- fuzzy partial_ratio via Hyyro's bit-parallel LCS over every length-m
  window of every candidate at once (m = query length; each 64-bit word is
  two 32-bit halves with the carry and borrow between them, as in the JAX
  package; the LCS length from a SWAR population count);
- the weighted combine (0.80/0.15/0.05, fuzzy unnormalized 0..100 exactly
  like the reference, vector_database.py:424).

PyTorch has no shift or add for ``uint32``, and no population count. So
every 32-bit value lives in an ``int64`` lane and is masked with
``& 0xFFFFFFFF`` after each step that can leave 32 bits, and murmur3's
32 x 32-bit products are split into 16-bit halves of the constant, so no
product passes 2^48 (a full product can pass 2^63).

Host involvement: lowercasing + UTF-8 byte packing (O(total chars)), and a
per-candidate recompute for the shapes the bit-parallel form cannot host
exactly (query longer than 64 bytes or than the candidate, non-ASCII text)
with rerank/fuzzy.py and rerank/hashing.py, merged before the final sort —
the JAX package's exactness contract, not a fallback: the device result is
always computed and used for every other candidate.
"""

from __future__ import annotations

import numpy as np
import torch

from minivectordb_tpu_torch.ops.scan import resolve_device
from minivectordb_tpu_torch.rerank.fuzzy import partial_ratio as _host_partial_ratio
from minivectordb_tpu_torch.rerank.hashing import N_FEATURES, hash_text_features

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_MADD = 0xE6546B64

MAX_QUERY_BYTES = 64  # bit-parallel word width (two 32-bit halves)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 32-bit values x in int64 lanes and a 32-bit
    constant c: x * c_lo + ((x * c_hi) mod 2^16) << 16, each product < 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mm3_fixed(b, s: int):
    """murmur3_32 of an s-byte message (s static, 1..6), vectorized.
    b: (..., 6) int64 tensor of byte values (entries >= s are ignored).
    Returns the hash in an int64 tensor, 0 <= h < 2^32."""
    h = torch.zeros(b.shape[:-1], dtype=torch.int64, device=b.device)
    if s >= 4:
        k = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
        k = _mul32(k, _C1)
        k = _rotl(k, 15)
        k = _mul32(k, _C2)
        h = h ^ k
        h = _rotl(h, 13)
        h = (h * 5 + _MADD) & _M32
        tail0 = 4
        tl = s - 4
    else:
        tail0 = 0
        tl = s
    if tl >= 1:
        k = b[..., tail0]
        if tl >= 2:
            k = k ^ (b[..., tail0 + 1] << 8)
        if tl >= 3:
            k = k ^ (b[..., tail0 + 2] << 16)
        k = _mul32(k, _C1)
        k = _rotl(k, 15)
        k = _mul32(k, _C2)
        h = h ^ k
    h = h ^ s
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    h = h ^ (h >> 16)
    return h


def _popcount32(x):
    """Set bits of 32-bit values in int64 lanes (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _hash_features_device(byte_arr, lengths):
    """Signed-hash char-ngram features for a byte batch.
    byte_arr: (B, L) uint8 tensor (lowercased UTF-8, zero-padded); lengths:
    (B,) integer tensor. Returns (B, 64) float32, L2-normalized —
    bit-identical buckets/signs to rerank/hashing.py:hash_text_features."""
    B, L = byte_arr.shape
    dev = byte_arr.device
    padded = torch.nn.functional.pad(byte_arr.to(torch.int64), (0, 6))
    # (B, L, 6): the 6 bytes starting at each position
    windows = torch.stack([padded[:, i : i + L] for i in range(6)], dim=-1)
    pos = torch.arange(L, device=dev)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    feats = torch.zeros((B, N_FEATURES), dtype=torch.float32, device=dev)
    for s in range(1, 7):
        h = _mm3_fixed(windows, s)  # (B, L)
        neg = h >= 0x80000000
        # abs(int32 view) % 64 == (two's-complement negation) & 63 for
        # negatives (incl. INT32_MIN), h & 63 otherwise
        idx = torch.where(neg, -h, h) & (N_FEATURES - 1)
        sign = torch.where(neg, -1.0, 1.0).to(torch.float32)
        contrib = torch.where((pos + s) <= lens, sign, 0.0)
        # sums of +-1: exact in float32 in any order
        feats.scatter_add_(1, idx, contrib)
    norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    return feats / torch.clamp(norm, min=1e-30)


def _hyyro_words(cand_bytes, q_len: int, peq_lo, peq_hi):
    """Hyyro's bit-parallel LCS state after the query, for every window
    ``cand[w : w + q_len]`` of every candidate at once.

    cand_bytes: (B, L) uint8 tensor; q_len: 0..64; peq_lo / peq_hi: (256,)
    int64 tensors, the query's char bitmasks (Peq) split into 32-bit halves.
    Returns (v_lo, v_hi), (B, L) int64 tensors holding the two 32-bit halves
    of each window's 64-bit word V; its zero bits (of the low q_len) count
    the LCS."""
    B, L = cand_bytes.shape
    padded = torch.nn.functional.pad(cand_bytes.to(torch.int64), (0, MAX_QUERY_BYTES))
    full_lo = _M32 if q_len >= 32 else (1 << q_len) - 1
    full_hi = _M32 if q_len >= 64 else ((1 << (q_len - 32)) - 1 if q_len >= 32 else 0)
    v_lo = torch.full((B, L), full_lo, dtype=torch.int64, device=cand_bytes.device)
    v_hi = torch.full((B, L), full_hi, dtype=torch.int64, device=cand_bytes.device)
    # steps past the query length are no-ops in the JAX form; skip them
    for j in range(q_len):
        ch = padded[:, j : j + L]  # window w's j-th byte
        u_lo = v_lo & peq_lo[ch]
        u_hi = v_hi & peq_hi[ch]
        # 64-bit (v + u) with the carry across the halves
        a_lo = v_lo + u_lo
        a_hi = (v_hi + u_hi + (a_lo >> 32)) & _M32
        a_lo = a_lo & _M32
        # 64-bit (v - u) with the borrow
        s_lo = v_lo - u_lo
        s_hi = (v_hi - u_hi - (s_lo < 0).to(torch.int64)) & _M32
        s_lo = s_lo & _M32
        v_lo = (a_lo | s_lo) & full_lo
        v_hi = (a_hi | s_hi) & full_hi
    return v_lo, v_hi


def _fuzzy_partial_device(cand_bytes, cand_lens, q_len: int, peq_lo, peq_hi):
    """partial_ratio(query, candidate) for every candidate, bit-parallel.

    cand_bytes: (B, L) uint8 tensor; cand_lens: (B,) integer tensor;
    q_len: 0..64; peq_lo / peq_hi as in _hyyro_words. Only candidates with
    len >= q_len produce valid results (the returned validity mask flags the
    rest for the host recompute).
    Returns (ratio_0_100 (B,) int32, valid (B,) bool).
    """
    B, L = cand_bytes.shape
    v_lo, v_hi = _hyyro_words(cand_bytes, q_len, peq_lo, peq_hi)
    lcs = q_len - (_popcount32(v_lo) + _popcount32(v_hi))  # (B, W)
    # window w is real iff w + q_len <= candidate length
    lens = cand_lens.to(torch.int64)
    w_idx = torch.arange(L, device=cand_bytes.device)[None, :]
    w_valid = (w_idx + q_len) <= lens[:, None]
    best_lcs = torch.where(w_valid, lcs, -1).amax(dim=1)  # (B,)
    # exact round-half-up in integer math: floor((100*lcs + m/2) / m)
    m_safe = max(q_len, 1)
    ratio = torch.div(200 * torch.clamp(best_lcs, min=0) + m_safe, 2 * m_safe,
                      rounding_mode="floor")
    # empty queries go to the host recompute (thefuzz: "" vs "" is 100,
    # "" vs anything else is 0 — not expressible as a window max)
    valid = (lens >= q_len) & (q_len > 0)
    return torch.where(valid, ratio, 0).to(torch.int32), valid


def _rerank_device(cand_lower, cand_raw, cand_lens, q_lower, q_len_hash,
                   q_len_fuzzy, peq_lo, peq_hi, search_scores, weights):
    """Features + cosine + fuzzy + combine, every operand on one device.

    Hashing consumes LOWERCASED bytes (sklearn HashingVectorizer lowercases,
    reference vector_database.py:388-393); the fuzzy ratio consumes RAW bytes
    (thefuzz.partial_ratio does no preprocessing, vector_database.py:410-411).
    """
    all_bytes = torch.cat([q_lower[None, :], cand_lower], dim=0)
    all_lens = torch.cat([q_len_hash.reshape(1), cand_lens])
    feats = _hash_features_device(all_bytes, all_lens)
    qv, cv = feats[0], feats[1:]
    hash_scores = cv @ qv  # (B,)
    fuzzy, fuzzy_valid = _fuzzy_partial_device(
        cand_raw, cand_lens, q_len_fuzzy, peq_lo, peq_hi
    )
    combined = (
        weights[0] * search_scores
        + weights[1] * hash_scores
        + weights[2] * fuzzy.to(torch.float32)
    )
    return combined, hash_scores, fuzzy, fuzzy_valid


def _pack(texts: list[str], max_len: int,
          lower: bool = True) -> tuple[np.ndarray, np.ndarray]:
    arr = np.zeros((len(texts), max_len), dtype=np.uint8)
    lens = np.zeros(len(texts), dtype=np.int32)
    for i, t in enumerate(texts):
        raw = (t.lower() if lower else t).encode("utf-8")[:max_len]
        arr[i, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        lens[i] = len(raw)
    return arr, lens


def _peq(q_bytes: np.ndarray, q_len: int) -> tuple[np.ndarray, np.ndarray]:
    lo = np.zeros(256, dtype=np.int64)
    hi = np.zeros(256, dtype=np.int64)
    for i in range(int(q_len)):
        ch = int(q_bytes[i])
        if i < 32:
            lo[ch] |= 1 << i
        else:
            hi[ch] |= 1 << (i - 32)
    return lo, hi


def hybrid_rerank_device(sentences, search_scores, query, k=5,
                         weights=(0.80, 0.15, 0.05), *, device=None):
    """Device-batched hybrid rerank; same contract as
    rerank/hybrid.py:hybrid_rerank_results. ``device``: the torch device to
    compute on; ``None`` means the CUDA card and raises when there is none."""
    dev = resolve_device(device)
    sentences = list(sentences)
    n = len(sentences)
    if n == 0:
        return tuple(), tuple()
    q_bytes_raw = query.encode("utf-8")
    # no shape buckets: PyTorch compiles nothing, and bytes past a row's
    # length are masked out of both the n-grams and the windows
    max_len = max(max(len(s.encode("utf-8")) for s in sentences),
                  len(q_bytes_raw), 1)
    cand_lower, _ = _pack(sentences, max_len, lower=True)
    cand_raw, cand_lens = _pack(sentences, max_len, lower=False)
    q_low, _ = _pack([query], max_len, lower=True)
    q_arr, q_lens = _pack([query], max_len, lower=False)
    q_len = int(q_lens[0])
    q_len_fuzzy = min(q_len, MAX_QUERY_BYTES)
    peq_lo, peq_hi = _peq(q_arr[0], q_len_fuzzy)

    def put(a):
        return torch.from_numpy(a).to(dev)

    combined, hash_scores, fuzzy, fuzzy_valid = _rerank_device(
        put(cand_lower), put(cand_raw), put(cand_lens), put(q_low[0]),
        put(q_lens), q_len_fuzzy, put(peq_lo), put(peq_hi),
        put(np.asarray(search_scores, dtype=np.float32)),
        [float(np.float32(w)) for w in weights],
    )
    combined = combined.cpu().numpy().astype(np.float64)
    fuzzy_valid = fuzzy_valid.cpu().numpy()
    # Shapes the device form cannot host exactly are recomputed PER
    # CANDIDATE on the host:
    # - query > 64 bytes or longer than the candidate (bit-parallel width);
    # - non-ASCII text (the device n-grams/windows BYTES; the host contract
    #   n-grams CHARACTERS, reference vector_database.py:388-393 — they
    #   coincide exactly iff every char is one byte).
    q_ascii = q_len == len(query)
    cand_ascii = np.fromiter(
        (cand_lens[i] == len(sentences[i]) for i in range(n)),
        dtype=bool,
        count=n,
    )
    if q_len > MAX_QUERY_BYTES or not q_ascii:
        fuzzy_valid = np.zeros(n, dtype=bool)
    exact = fuzzy_valid & cand_ascii if q_ascii else np.zeros(n, dtype=bool)
    if not exact.all():
        fuzzy_np = fuzzy.cpu().numpy().astype(np.float64)
        hash_np = hash_scores.cpu().numpy().astype(np.float64)
        qv_host = None
        for i in np.nonzero(~exact)[0]:
            host_f = _host_partial_ratio(query, sentences[i])
            combined[i] += weights[2] * (host_f - fuzzy_np[i])
            if not (q_ascii and cand_ascii[i]):
                if qv_host is None:
                    qv_host = hash_text_features(query)
                host_h = float(qv_host @ hash_text_features(sentences[i]))
                combined[i] += weights[1] * (host_h - hash_np[i])
    order = np.argsort(-combined, kind="stable")
    ranked_sentences = tuple(sentences[i] for i in order)
    ranked_scores = tuple(float(combined[i]) for i in order)
    return ranked_sentences[:k], ranked_scores[:k]
