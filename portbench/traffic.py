"""The one generator of the benchmark's inputs: corpora, queries, texts,
training batches and encoder weights, all from the run's seed.

Everything is drawn from the seed alone, so the same seed gives the same
inputs, and from parameters that a configuration or traffic file states.
Where the amount of work could depend on the seed (how many chunks of a pool
are full, how long the tails are), every seed gets the same multiset of
sizes in another order, so runs on different seeds do the same work.

Corpora, queries and weights are made on the device with a
``torch.Generator`` there, in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import families

# what each stream of a run is drawn for; a stream's seed is (run seed, tag)
_TAGS = {"corpus": 1, "order": 2, "texts": 3, "weights": 4, "sample": 5}


def stream_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one stream of a run (``what`` in _TAGS), so the
    streams of one run are independent and any whole ``seed`` (negative or
    past 32 bits too) is taken."""
    state = np.random.SeedSequence([seed % (1 << 64), _TAGS[what]])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, what: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, what))


def device_generator(seed: int, what: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, what))
    return gen


# -- vectors -----------------------------------------------------------------


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def mixture(spec: dict, rows: int, queries: int, seed: int, device):
    """(corpus (rows, dim), queries (queries, dim)) float32 tensors on
    ``device`` from one seeded two-level mixture, so that cosine structure
    resembles embeddings: ``families`` unit directions; ``centres`` unit
    centres, each its family's direction plus ``sibling`` times a unit
    offset (siblings of one family lie at cosine about 0.8); a row is a
    centre plus isotropic noise of ``noise`` times the centre's length.
    Queries are drawn from the same mixture, after the corpus, so they are
    no rows of it. Rewritten from the port's profiler, whose IVF corpus it
    is; the same seed gives the same vectors bit for bit on one device."""
    dim = int(spec["dim"])
    gen = device_generator(seed, "corpus", device)

    def normal(*shape):
        return torch.randn(shape, device=device, generator=gen)

    fam = _unit(normal(int(spec["families"]), dim))
    member = torch.randint(0, int(spec["families"]), (int(spec["centres"]),),
                           device=device, generator=gen)
    centres = _unit(fam[member] + float(spec["sibling"]) * _unit(
        normal(int(spec["centres"]), dim)))
    del fam, member
    scale = float(spec["noise"]) / math.sqrt(dim)

    def draw(m):
        which = torch.randint(0, centres.shape[0], (m,), device=device, generator=gen)
        out = torch.randn((m, dim), device=device, generator=gen)
        out.mul_(scale).add_(centres[which])
        return out

    corpus = draw(rows)
    qs = draw(queries)
    return corpus, qs


# -- texts -------------------------------------------------------------------

# 50,000 seeded words, each one token of the hashing tokenizer
VOCAB = tuple(f"w{i}" for i in range(50_000))


def fixed_lengths(n: int, spec: dict) -> list[int]:
    """``n`` token counts of one pool, as a fixed multiset: round(n x
    ``full_share``) chunks of ``max_tokens``, the rest tails spread evenly
    over [``tail_min``, ``tail_max``] (the last chunk of a document). The
    caller shuffles them."""
    full = round(n * float(spec.get("full_share", 0.0)))
    tails = n - full
    lo, hi = int(spec["tail_min"]), int(spec["tail_max"])
    out = [int(spec["max_tokens"])] * full
    out += [lo + int((i + 0.5) * (hi - lo + 1) / tails) for i in range(tails)]
    return out


def texts_of(lengths: list[int], specials: int, gen: np.random.Generator) -> list[str]:
    """One text per token count: ``length - specials`` seeded words (the
    tokenizer adds ``specials`` tokens: BOS, EOS and any prefix)."""
    words = gen.integers(0, len(VOCAB), size=sum(n - specials for n in lengths))
    out, at = [], 0
    for n in lengths:
        m = n - specials
        out.append(" ".join(VOCAB[w] for w in words[at:at + m]))
        at += m
    return out


def text_pool(spec: dict, n: int, specials: int, seed: int):
    """(texts, token counts) of a pool of ``n`` chunks in seeded order."""
    gen = rng(seed, "texts")
    lengths = fixed_lengths(n, spec)
    gen.shuffle(lengths)
    return texts_of(lengths, specials, gen), lengths


def train_pool(traffic: dict, tokenize, seed: int) -> list[dict]:
    """A pool of training batches: each ``pairs`` (query, passage) pairs,
    queries of ``query.min``-``query.max`` tokens padded to ``query.seq``,
    passages of the ``passage`` chunk mix padded to ``passage.seq``. Token
    counts are a fixed multiset over the pool, in seeded order. ``tokenize``
    (text, max_tokens) -> ids. Each batch: q_ids, q_mask, p_ids, p_mask
    (int32 numpy) and the real lengths q_len, p_len."""
    pairs, nb = int(traffic["pairs"]), int(traffic["pool_batches"])
    gen = rng(seed, "texts")
    qs, ps = traffic["query"], traffic["passage"]
    q_lengths = fixed_lengths(pairs * nb, {"full_share": 0, "tail_min": qs["min"],
                                           "tail_max": qs["max"], "max_tokens": qs["max"]})
    p_lengths = fixed_lengths(pairs * nb, ps)
    gen.shuffle(q_lengths)
    gen.shuffle(p_lengths)
    q_texts = texts_of(q_lengths, 2, gen)
    p_texts = texts_of(p_lengths, 2, gen)

    def pad(texts, seq):
        ids = np.full((len(texts), seq), 1, np.int32)   # XLM-R pad id
        mask = np.zeros((len(texts), seq), np.int32)
        for i, t in enumerate(texts):
            tok = tokenize(t, seq)
            ids[i, :len(tok)] = tok
            mask[i, :len(tok)] = 1
        return ids, mask

    batches = []
    for b in range(nb):
        cut = slice(b * pairs, (b + 1) * pairs)
        q_ids, q_mask = pad(q_texts[cut], int(qs["seq"]))
        p_ids, p_mask = pad(p_texts[cut], int(ps["seq"]))
        batches.append({"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids,
                        "p_mask": p_mask, "q_len": q_lengths[cut],
                        "p_len": p_lengths[cut]})
    return batches


# -- encoder weights ---------------------------------------------------------


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every leaf of the encoder (its family's ``weight_shapes``, in their
    order) from the seed, as views of one buffer drawn in a single call on
    ``device``: embeddings normal x 0.02, dense weights normal /
    sqrt(fan-in), biases and layer-norm shifts normal x 0.02, layer-norm
    gains 1 + normal x 0.05. Returns {path: float32 tensor}."""
    shapes = families.of(cfg).weight_shapes(cfg)
    total = sum(math.prod(s) for _p, s, _k in shapes)
    buf = torch.randn(total, device=device, generator=device_generator(seed, "weights", device))
    out, at = {}, 0
    with torch.no_grad():
        for path, shape, kind in shapes:
            n = math.prod(shape)
            leaf = buf[at:at + n].view(shape)
            at += n
            if kind == "dense":
                leaf.mul_(1.0 / math.sqrt(shape[0]))
            elif kind == "gain":
                leaf.mul_(0.05).add_(1.0)
            else:
                leaf.mul_(0.02)
            out[path] = leaf
    return out
