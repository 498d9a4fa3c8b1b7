"""Today's cells, cut to the CPU's size, read what they read before model
families and drivers were found by name: their cut configurations and
mixes, the weights and inputs drawn from the seed, and the reference's
outputs on them, each pinned as a digest taken on the harness as it was
before. A later change to the harness that moves any of them by one bit
fails here.

The reference's digests are of float32 arithmetic on one CPU thread; they
hold on the torch build and processor kind they were taken on."""

import hashlib
import json

import numpy as np
import pytest
import torch

from portbench import hashtok, reference, traffic
from portbench.drivers import common
from portbench.tests.tiny import tiny_cell

SEED = 2 ** 40 + 17

PINNED = {
    "cohere-1m-768.b256-k100": {
        "cell": "ae0d7f0e1b9f82a2",
        "inputs": "defed493d87db0dc",
        "reference": "e2a54c646b6f12c0",
    },
    "cohere-1m-768.serial-k100": {
        "cell": "60d350c4ac244c55",
        "inputs": "defed493d87db0dc",
        "reference": "e2a54c646b6f12c0",
    },
    "me5-large.ingest-f32": {
        "cell": "a4a3ad5f75633df0",
        "inputs": "d263f5bc51405ada",
        "reference": "ec4d318919c1c9ad",
        "weights": "d092b01719cc64da",
    },
    "me5-large.train-f32": {
        "cell": "2bd602003dc54d8f",
        "inputs": "7cff8191e8af3417",
        "reference": "f56211c3c8eeae40",
        "weights": "d092b01719cc64da",
    },
}


def digest(*parts) -> str:
    """sha256 (first 16 hex digits) of arrays (dtype, shape and bytes) and
    JSON values (floats at full precision), in order."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, torch.Tensor):
            p = p.detach().cpu().contiguous().numpy()
        if isinstance(p, np.ndarray):
            h.update(repr((p.dtype.str, p.shape)).encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(json.dumps(p, sort_keys=True).encode())
    return h.hexdigest()[:16]


def _search(cell) -> dict:
    from portbench.drivers.search import inputs
    cfg, mix = cell.config, cell.traffic
    corpus, queries = inputs(cfg, int(mix["query_pool"]), SEED, "cpu")
    order = traffic.rng(SEED, "order").permutation(queries.shape[0])
    v, i = reference.cosine_topk(corpus, queries[:64], int(mix["k"]))
    return {"inputs": digest(corpus, queries, order), "reference": digest(v, i)}


def _embed(cell) -> dict:
    cfg, mix = cell.config, cell.traffic
    mc = cfg["model"]
    w = traffic.make_weights(mc, SEED, "cpu")
    n = int(mix["batch"]) * int(mix["pool_batches"])
    specials = len(hashtok.HashTokenizer(1 << 20, cfg["document_prefix"]).encode(""))
    texts, lengths = traffic.text_pool(mix["chunk"], n, specials, SEED)
    picked = common.sample(n, int(mix["check_texts"]), traffic.rng(SEED, "sample"),
                           must=[int(np.argmax(lengths))])
    tok = hashtok.HashTokenizer(int(mc["vocab_size"]), cfg["document_prefix"])
    seq = int(mix["chunk"]["max_tokens"])
    ids = np.full((len(picked), seq), hashtok.PAD_ID, np.int64)
    mask = np.zeros((len(picked), seq), np.int64)
    for r, i in enumerate(picked):
        t = tok.encode(texts[i], seq)
        ids[r, :len(t)] = t
        mask[r, :len(t)] = 1
    with torch.no_grad():
        out = torch.cat([reference.embed(w, torch.as_tensor(ids[lo:lo + 16]),
                                         torch.as_tensor(mask[lo:lo + 16]), mc)
                         for lo in range(0, len(picked), 16)])
    return {"weights": digest(list(w), *w.values()),
            "inputs": digest(texts, lengths, picked, ids, mask),
            "reference": digest(out)}


def _train(cell) -> dict:
    from portbench.drivers import train
    cfg, mix = cell.config, cell.traffic
    mc = cfg["model"]
    w = traffic.make_weights(mc, SEED, "cpu")
    batches = traffic.train_pool(mix, hashtok.HashTokenizer(int(mc["vocab_size"])).encode, SEED)
    parts = []
    for b in batches:
        for k in sorted(b):
            parts += [k, b[k] if isinstance(b[k], np.ndarray) else list(b[k])]
    want = train.reference_run(cfg, mix, batches, SEED, "cpu")
    return {"weights": digest(list(w), *w.values()), "inputs": digest(*parts),
            "reference": digest(want)}


def digests(root: str, name: str) -> dict:
    """The digests of one cell cut to the CPU's size, on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = tiny_cell(root, name)
        kind = cell.traffic["driver"]
        out = {"cell": digest(cell.config, cell.traffic)}
        out.update({"search": _search, "embed": _embed, "train": _train}[kind](cell))
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_cell_reads_what_it_read_before(root, name):
    assert digests(root, name) == PINNED[name]
