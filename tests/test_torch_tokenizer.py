"""The port's tokenizers give the same ids and masks as the JAX package's:
HashTokenizer, and WordVocabTokenizer with each bundled vocab.json (closed and
open vocabulary), on fixed multilingual samples and on hypothesis text."""

import json
import os

import pytest
from hypothesis import given, settings, strategies as st

from minivectordb_tpu.models import tokenizer as jtok
from minivectordb_tpu_torch.models import tokenizer as ttok

RESOURCES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "minivectordb_tpu", "resources")
SLOTS = ("builtin", "trained_small", "trained_large", "trained_bgem3")

SAMPLES = [
    "",
    "i like animals",
    "Dogs are running; the friendliest cats' owners walked quickly!",
    "skyblue racecars and thunderstorms, re-engineered",
    "passage the stock market fell 3.5% on Tuesday...",
    "El rápido zorro marrón salta sobre el perro perezoso.",
    "Größe, naïve café — déjà vu",
    "Быстрая коричневая лиса прыгает через ленивую собаку",
    "素早い茶色の狐が怠け者の犬を飛び越える",
    "السلام عليكم ورحمة الله",
    "emoji 🙂🙃 and\ttabs\nnewlines  double  spaces",
    "x" * 700,
    " ".join(f"word{i}" for i in range(700)),
    " ".join(["dog cat house car tree running jumped"] * 90),
]


def _vocab(slot):
    with open(os.path.join(RESOURCES, slot, "vocab.json")) as f:
        return json.load(f)


def _same(a, b, texts, max_length=512):
    for t in texts:
        assert a.encode(t, max_length) == b.encode(t, max_length), t[:60]
    out_a, out_b = a(texts, max_length=max_length), b(texts, max_length=max_length)
    assert out_a == out_b
    assert len({len(r) for r in out_a["input_ids"]}) == 1


def test_special_ids_are_xlmr():
    assert (ttok.BOS_ID, ttok.PAD_ID, ttok.EOS_ID, ttok.UNK_ID) == (
        jtok.BOS_ID, jtok.PAD_ID, jtok.EOS_ID, jtok.UNK_ID) == (0, 1, 2, 3)


@pytest.mark.parametrize("vocab_size", [64, 32768, 250037])
def test_hash_tokenizer(vocab_size):
    _same(ttok.HashTokenizer(vocab_size), jtok.HashTokenizer(vocab_size), SAMPLES)
    _same(ttok.HashTokenizer(vocab_size), jtok.HashTokenizer(vocab_size), SAMPLES, 16)


@pytest.mark.parametrize("drop_oov", [False, True])
@pytest.mark.parametrize("slot", SLOTS)
def test_word_vocab_tokenizer_on_bundled_vocabularies(slot, drop_oov):
    vocab = _vocab(slot)
    assert vocab["format"] == "word-vocab-v1"
    with open(os.path.join(RESOURCES, slot, "config.json")) as f:
        size = json.load(f)["vocab_size"]
    a = ttok.WordVocabTokenizer(vocab["words"], size, drop_oov=drop_oov)
    b = jtok.WordVocabTokenizer(vocab["words"], size, drop_oov=drop_oov)
    # inflections, compounds and unknown words of the vocabulary itself
    words = vocab["words"][:: max(1, len(vocab["words"]) // 40)]
    derived = [w + s for w in words for s in ("s", "ing", "ed", "ly", "'s")]
    compounds = [x + y for x, y in zip(words, words[1:])]
    _same(a, b, SAMPLES + [" ".join(derived), " ".join(compounds), "zzqx vvkj"])
    _same(a, b, SAMPLES[:6], max_length=8)


def test_word_vocab_tokenizer_rejects_a_vocabulary_that_fills_the_ids():
    with pytest.raises(ValueError):
        ttok.WordVocabTokenizer(["a", "b"], 6)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.text(max_size=80), min_size=1, max_size=4))
def test_tokenizers_agree_on_arbitrary_text(texts):
    vocab = _vocab("builtin")
    for drop in (False, True):
        a = ttok.WordVocabTokenizer(vocab["words"], 4096, drop_oov=drop)
        b = jtok.WordVocabTokenizer(vocab["words"], 4096, drop_oov=drop)
        assert a(texts, max_length=32) == b(texts, max_length=32)
    assert ttok.HashTokenizer(999)(texts) == jtok.HashTokenizer(999)(texts)


def test_load_tokenizer_falls_back_to_hashing(tmp_path):
    tok, is_hf = ttok.load_tokenizer(None, 1000)
    assert isinstance(tok, ttok.HashTokenizer) and not is_hf and tok.vocab_size == 1000
    # a directory without tokenizer files (or no transformers at all): hashing
    tok, is_hf = ttok.load_tokenizer(str(tmp_path), 1000)
    assert isinstance(tok, ttok.HashTokenizer) and not is_hf
    jt, j_hf = jtok.load_tokenizer(str(tmp_path), 1000)
    assert type(jt).__name__ == "HashTokenizer" and not j_hf
