"""The port's device rerank (minivectordb_tpu_torch/rerank/device.py) on the
CPU against the JAX package's (minivectordb_tpu/rerank/device.py) on the CPU,
on the texts of tests/test_device_rerank.py and a seeded fuzz set with
non-ASCII text and queries over 64 bytes.

Tolerances: hash features 1e-6 (both sum +-1 counts exactly and take one
float32 norm; within 1e-6 leaves room for another sqrt/divide rounding);
fuzzy ratios and the Hyyro words exactly (integer work); ranked scores 1e-4
(the JAX tests' tolerance: float32 combines in another order, a 64-term dot);
orders equal."""

import random
import string

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from minivectordb_tpu.rerank import device as jdevice
from minivectordb_tpu.rerank.hybrid import hybrid_rerank_results as jhybrid
from minivectordb_tpu_torch.rerank import device as tdevice
from minivectordb_tpu_torch.rerank import hashing as thashing
from minivectordb_tpu_torch.rerank.hybrid import hybrid_rerank_results as thybrid

CPU = torch.device("cpu")

DOCS = [
    "the quick brown fox jumps",
    "a lazy dog sleeps all day",
    "quantum flux capacitors hum",
    "brown foxes are quick animals",
    "the stock market fell sharply",
    "she plays violin beautifully",
    "i like animals",
    "i like cars",
    "i like programming",
    "technology is the future",
]
ALPHABET = string.ascii_letters + string.digits + "  ,.!Ü é"


def _rand_text(rng, lo=1, hi=60, alphabet=ALPHABET):
    return "".join(rng.choice(alphabet) for _ in range(rng.randint(lo, hi)))


def _fuzz_set(seed, n=40):
    rng = random.Random(seed)
    cands = [_rand_text(rng, 0, 150) for _ in range(n)] + DOCS
    queries = [_rand_text(rng, 1, 64, string.ascii_lowercase + " ")
               for _ in range(3)]
    queries += ["q" * 100, "naïve café query", "x" * 64, "y" * 33,
                _rand_text(rng, 65, 90, string.ascii_lowercase)]
    return rng, cands, queries


def test_hash_features_match_jax():
    rng = random.Random(3)
    texts = DOCS + ["", "a", "UPPER lower 123 !?", "x" * 200,
                    "\xff\xfe" * 3] + [_rand_text(rng, 0, 120) for _ in range(30)]
    arr, lens = tdevice._pack(texts, 256)
    want = np.asarray(jdevice._hash_features_device(jnp.asarray(arr), jnp.asarray(lens)))
    got = tdevice._hash_features_device(torch.from_numpy(arr), torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == (len(texts), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # and the host contract on ASCII texts
    for i, t in enumerate(texts[:14]):
        np.testing.assert_allclose(got[i].numpy(), thashing.hash_text_features(t),
                                   rtol=0, atol=1e-6, err_msg=t)


@pytest.mark.parametrize("s", range(1, 7))
def test_murmur3_products_past_2_63(s):
    """Every byte 0xFF makes k = 0xFFFFFFFF, whose product with C1 passes
    2^63; random bytes cover the rest. The int64-lane murmur3 must equal the
    JAX package's uint32 form and the host hash bit for bit."""
    nprng = np.random.default_rng(s)
    b = nprng.integers(0, 256, size=(512, 6), dtype=np.int64)
    b[:8] = 0xFF
    b[8:16] = 0x80
    assert 0xFFFFFFFF * 0xCC9E2D51 >= 2 ** 63
    got = tdevice._mm3_fixed(torch.from_numpy(b), s).numpy()
    want = np.asarray(jdevice._mm3_fixed(jnp.asarray(b.astype(np.uint32)), s))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for row in range(24):
        host = thashing.murmur3_32(bytes(int(x) for x in b[row, :s]))
        assert int(got[row]) == host


def test_popcount_swar():
    x = np.random.default_rng(0).integers(0, 2 ** 32, size=4096, dtype=np.int64)
    x[:3] = [0, 0xFFFFFFFF, 0x80000001]
    got = tdevice._popcount32(torch.from_numpy(x)).numpy()
    assert got.tolist() == [bin(int(v)).count("1") for v in x]


def _hyyro_reference(query: bytes, window: bytes) -> int:
    """The 64-bit Hyyro word V after the query, in Python integers."""
    m = len(query)
    peq = {}
    for i, ch in enumerate(query):
        peq[ch] = peq.get(ch, 0) | (1 << i)
    full = (1 << m) - 1
    v = full
    for ch in window[:m]:
        u = v & peq.get(ch, 0)
        v = ((v + u) | (v - u)) & full
    return v


@pytest.mark.parametrize("q_len", [1, 5, 31, 32, 33, 47, 63, 64])
def test_hyyro_words_half_by_half(q_len):
    """Both 32-bit halves of every window's word equal the 64-bit word of a
    Python-integer Hyyro run, carries between the halves included."""
    rng = random.Random(q_len)
    query = "".join(rng.choice("abcab ") for _ in range(q_len))
    cands = ["".join(rng.choice("abcd ") for _ in range(rng.randint(q_len, 90)))
             for _ in range(6)]
    arr, lens = tdevice._pack(cands, 96 + 64, lower=False)
    q_arr, _ = tdevice._pack([query], 64, lower=False)
    lo, hi = tdevice._peq(q_arr[0], q_len)
    v_lo, v_hi = tdevice._hyyro_words(torch.from_numpy(arr), q_len,
                                      torch.from_numpy(lo), torch.from_numpy(hi))
    qb = query.encode()
    for b, c in enumerate(cands):
        cb = c.encode()
        for w in range(len(cb) - q_len + 1):
            want = _hyyro_reference(qb, cb[w:])
            assert int(v_lo[b, w]) == want & 0xFFFFFFFF, (b, w)
            assert int(v_hi[b, w]) == want >> 32, (b, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzzy_ratios_equal_jax(seed):
    _rng, cands, queries = _fuzz_set(seed)
    for query in queries:
        q_len = min(len(query.encode()), 64)
        L = 256
        arr, lens = tdevice._pack(cands, L, lower=False)
        q_arr, _ = tdevice._pack([query], L, lower=False)
        lo, hi = tdevice._peq(q_arr[0], q_len)
        got, got_valid = tdevice._fuzzy_partial_device(
            torch.from_numpy(arr), torch.from_numpy(lens), q_len,
            torch.from_numpy(lo), torch.from_numpy(hi))
        jlo, jhi = jdevice._peq(q_arr[0], q_len)
        want, want_valid = jdevice._fuzzy_partial_device(
            jnp.asarray(arr), jnp.asarray(lens), jnp.int32(q_len),
            jnp.asarray(jlo), jnp.asarray(jhi))
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(want).tolist(), query
        assert got_valid.tolist() == np.asarray(want_valid).tolist(), query


def _same_ranking(got, want, atol=1e-4):
    assert list(got[0]) == list(want[0])
    np.testing.assert_allclose(np.asarray(got[1], np.float64),
                               np.asarray(want[1], np.float64), rtol=0, atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hybrid_rerank_device_equals_jax(seed):
    rng, cands, queries = _fuzz_set(seed)
    scores = [rng.random() for _ in cands]
    for query in queries + ["quick brown fox", "dog", "", "cars and animals"]:
        want = jdevice.hybrid_rerank_device(cands, scores, query, k=len(cands))
        got = tdevice.hybrid_rerank_device(cands, scores, query, k=len(cands),
                                           device=CPU)
        _same_ranking(got, want)
        host = thybrid(cands, scores, query, k=len(cands), device=False)
        _same_ranking(got, host)


def test_reference_flow_and_k128():
    sentences = ["i like animals", "i like cars", "i like programming"]
    got = tdevice.hybrid_rerank_device(sentences, [0.9, 0.85, 0.8],
                                       "cars and animals", k=2, device="cpu")
    _same_ranking(got, jdevice.hybrid_rerank_device(
        sentences, [0.9, 0.85, 0.8], "cars and animals", k=2))
    assert got[1][0] > 1.0
    rng = random.Random(1)
    cands = [_rand_text(rng, 5, 120) for _ in range(128)]
    scores = list(np.random.default_rng(0).random(128))
    _same_ranking(
        tdevice.hybrid_rerank_device(cands, scores, "brown fox", k=128, device="cpu"),
        jdevice.hybrid_rerank_device(cands, scores, "brown fox", k=128))
    assert tdevice.hybrid_rerank_device([], [], "q", device="cpu") == ((), ())


def test_results_do_not_depend_on_padding():
    """The JAX form pads rows and lengths to buckets; the port packs to the
    longest text. A wider packing changes nothing."""
    rng, cands, queries = _fuzz_set(9, n=20)
    arr, lens = tdevice._pack(cands, 160)
    wide, _ = tdevice._pack(cands, 512)
    a = tdevice._hash_features_device(torch.from_numpy(arr), torch.from_numpy(lens))
    b = tdevice._hash_features_device(torch.from_numpy(wide), torch.from_numpy(lens))
    assert torch.equal(a, b)
    raw, _ = tdevice._pack(cands, 160, lower=False)
    raw_wide, _ = tdevice._pack(cands, 512, lower=False)
    q = "brown fox"
    lo, hi = (torch.from_numpy(x) for x in tdevice._peq(np.frombuffer(q.encode(), np.uint8), len(q)))
    ra = tdevice._fuzzy_partial_device(torch.from_numpy(raw), torch.from_numpy(lens), len(q), lo, hi)
    rb = tdevice._fuzzy_partial_device(torch.from_numpy(raw_wide), torch.from_numpy(lens), len(q), lo, hi)
    assert torch.equal(ra[0], rb[0]) and torch.equal(ra[1], rb[1])


def test_hybrid_router_threshold_and_errors():
    rng, cands, _ = _fuzz_set(4)
    scores = [rng.random() for _ in cands]
    n = len(cands)
    assert n >= 32
    # device=None at 32+ candidates takes the device path, as JAX's does
    _same_ranking(thybrid(cands, scores, "brown fox", k=n, torch_device="cpu"),
                  jhybrid(cands, scores, "brown fox", k=n))
    # below the threshold: the host path, bit for bit
    small = thybrid(cands[:31], scores[:31], "brown fox", k=31)
    want = jhybrid(cands[:31], scores[:31], "brown fox", k=31, device=False)
    assert small == want
    if not torch.cuda.is_available():
        # the device path means the CUDA card unless asked for another
        with pytest.raises(RuntimeError, match="CUDA"):
            thybrid(cands, scores, "brown fox", k=3)
        with pytest.raises(RuntimeError, match="CUDA"):
            thybrid(cands[:2], scores[:2], "brown fox", k=3, device=True)
    # an error on the device path reaches the caller under device=None too
    bad = list(scores)
    bad[3] = "x"
    with pytest.raises(ValueError):
        thybrid(cands, bad, "brown fox", k=3, torch_device="cpu")
    with pytest.raises(ValueError):
        thybrid(cands, bad, "brown fox", k=3, device=True, torch_device="cpu")
    # the host path keeps the reference's graceful degrade
    few = (cands[:3], [0.3, "x", 0.1], "a")
    assert thybrid(*few, k=2) == jhybrid(*few, k=2, device=False) == (cands[:2], [0.3, "x"])


def test_host_fuzzy_past_64_chars_equals_jax_dp():
    """The port's host partial_ratio runs Hyyro's bit-parallel LCS on Python
    integers at every needle length; the JAX module runs a DP past 64 chars.
    Both are exact: the ratios must be equal."""
    from minivectordb_tpu.rerank import fuzzy as jfuzzy
    from minivectordb_tpu_torch.rerank import fuzzy as tfuzzy

    rng = random.Random(5)
    for _ in range(60):
        a = _rand_text(rng, 60, 130, "abcé x")
        b = _rand_text(rng, 60, 200, "abcé x")
        assert tfuzzy.partial_ratio(a, b) == jfuzzy.partial_ratio(a, b), (a, b)
        assert tfuzzy._indel_distance(a, b) == jfuzzy._indel_distance(a, b)
