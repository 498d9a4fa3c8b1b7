"""Host-side tokenization.

Counterpart of ``minivectordb_tpu/models/tokenizer.py`` (the port keeps its
own copy; ids and masks are equal for equal text). Preferred path: the HF fast
tokenizer for the exact checkpoint. When ``transformers`` or the tokenizer
files are unavailable (offline), a deterministic hashing tokenizer with XLM-R
special-token conventions keeps every shape/API contract working. The bundled
trained artifacts use ``WordVocabTokenizer``.
"""

from __future__ import annotations

import re

from minivectordb_tpu_torch.rerank.hashing import murmur3_32

# XLM-R special ids
BOS_ID, PAD_ID, EOS_ID, UNK_ID = 0, 1, 2, 3
_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


class HashTokenizer:
    """Deterministic whitespace/punct word hashing into a fixed vocab."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str, max_length: int = 512) -> list[int]:
        ids = [BOS_ID]
        for tok in _WORD_RE.findall(text.lower()):
            h = murmur3_32(tok.encode("utf-8"))
            ids.append(4 + (h % (self.vocab_size - 4)))
            if len(ids) >= max_length - 1:
                break
        ids.append(EOS_ID)
        return ids

    def __call__(self, texts, max_length: int = 512):
        encoded = [self.encode(t, max_length) for t in texts]
        longest = max(len(e) for e in encoded)
        input_ids = [e + [PAD_ID] * (longest - len(e)) for e in encoded]
        attention_mask = [[1] * len(e) + [0] * (longest - len(e)) for e in encoded]
        return {"input_ids": input_ids, "attention_mask": attention_mask}


class WordVocabTokenizer:
    """Exact word vocabulary + hashed OOV buckets.

    The bundled trained builtin encoder uses this:
    every word it was trained on gets a DEDICATED id (no hash collisions
    between trained concepts), and unknown words spread over the remaining
    id range via murmur3 so arbitrary user text still embeds. Layout:
    [0..3] specials, [4 .. 4+len(words)) the vocabulary in list order,
    [4+len(words) .. vocab_size) OOV buckets.
    """

    def __init__(self, words: list[str], vocab_size: int,
                 drop_oov: bool = False):
        """drop_oov=True makes the vocabulary CLOSED: unknown words are
        dropped instead of hashed into OOV buckets. The bundled trained
        encoder ships this way — an unknown word's random (or collided)
        embedding only injects noise into the mean pool, whereas dropping it
        leaves the known words' clean representation. A text with no known
        words at all keeps its hashed ids (degraded but distinct)."""
        self.vocab_size = vocab_size
        self.words = list(words)
        self.drop_oov = drop_oov
        self._index = {w: 4 + i for i, w in enumerate(self.words)}
        self._oov_base = 4 + len(self.words)
        self._oov_range = vocab_size - self._oov_base
        if self._oov_range <= 0:
            raise ValueError("vocab_size too small for word list")

    # (suffix, replacement) morphology rules, tried in order: plural/verb/
    # adverb inflections reduce to a vocabulary base form, so unseen
    # inflections of TRAINED words keep their trained semantics instead of
    # being dropped/hashed.
    _SUFFIX_RULES = (
        ("'s", ""), ("ies", "y"), ("ves", "f"), ("es", ""), ("s", ""),
        ("ing", ""), ("ing", "e"), ("ed", ""), ("ed", "e"),
        ("er", ""), ("est", ""), ("ly", ""),
    )

    def _id(self, tok: str) -> int:
        known = self._index.get(tok)
        if known is not None:
            return known
        h = murmur3_32(tok.encode("utf-8"))
        return self._oov_base + (h % self._oov_range)

    def _morph(self, tok: str) -> int | None:
        """Vocabulary id for a morphological base form of ``tok``, if any."""
        for suf, repl in self._SUFFIX_RULES:
            if tok.endswith(suf) and len(tok) - len(suf) >= 3:
                base = tok[: len(tok) - len(suf)] + repl
                tid = self._index.get(base)
                if tid is not None:
                    return tid
                # consonant doubling: "running" -> "runn" -> "run"
                if len(base) >= 4 and base[-1] == base[-2]:
                    tid = self._index.get(base[:-1])
                    if tid is not None:
                        return tid
        return None

    def _segment(self, tok: str) -> list[int] | None:
        """Greedy longest-match split into known pieces ("skyblue" ->
        sky + blue). All-or-nothing: a partial cover returns None."""
        if len(tok) < 6:
            return None
        out: list[int] = []
        pos = 0
        while pos < len(tok):
            best = None
            for end in range(len(tok), pos + 2, -1):  # pieces of >=3 chars
                tid = self._index.get(tok[pos:end])
                if tid is not None:
                    best = (end, tid)
                    break
            if best is None:
                return None
            pos, tid = best
            out.append(tid)
            if len(out) > 4:
                return None
        return out

    def _resolve(self, tok: str) -> list[int]:
        """Token -> ids: exact, else morphology, else segmentation, else a
        hashed OOV bucket ([] under drop_oov — a trained embedding is never
        diluted by an untrained one)."""
        tid = self._index.get(tok)
        if tid is not None:
            return [tid]
        tid = self._morph(tok)
        if tid is not None:
            return [tid]
        seg = self._segment(tok)
        if seg is not None:
            return seg
        return [] if self.drop_oov else [self._id(tok)]

    def encode(self, text: str, max_length: int = 512) -> list[int]:
        toks = _WORD_RE.findall(text.lower())
        ids = [BOS_ID]
        for tok in toks:
            for tid in self._resolve(tok):
                ids.append(tid)
                if len(ids) >= max_length - 1:
                    break
            if len(ids) >= max_length - 1:
                break
        if self.drop_oov and len(ids) == 1 and toks:
            # nothing resolvable at all: fall back to hashed ids so distinct
            # fully-unknown texts still embed deterministically + distinctly
            for tok in toks:
                ids.append(self._id(tok))
                if len(ids) >= max_length - 1:
                    break
        ids.append(EOS_ID)
        return ids

    __call__ = HashTokenizer.__call__


class HFTokenizer:
    """Thin adapter over a transformers fast tokenizer, from a local
    directory or the local HF cache (nothing is downloaded)."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)

    def __call__(self, texts, max_length: int = 512):
        out = self._tok(
            list(texts), max_length=max_length, padding=True, truncation=True
        )
        return {
            "input_ids": out["input_ids"],
            "attention_mask": out["attention_mask"],
        }


def load_tokenizer(name_or_path: str | None, vocab_size: int):
    """HF tokenizer when reachable, hashing fallback otherwise."""
    if name_or_path is not None:
        try:
            return HFTokenizer(name_or_path), True
        except Exception:
            pass
    return HashTokenizer(vocab_size), False
