"""Train the bundled builtin-512 encoder (or a slot's stand-in) and emit its
artifact.

Counterpart of ``minivectordb_tpu/models/train_builtin.py``: InfoNCE over the
concept-graph corpus (models/builtin_data.py) with the port's training stack
(models/train.py), then the probe gate of the reference's semantic
assertions plus held-out generalisation checks; the artifact is written only
when every probe passes (or with ``--force``).

Usage (on the card; ``--device cpu`` runs on the host explicitly):
    python -m minivectordb_tpu_torch.models.train_builtin --out DIR \
        [--slot builtin] [--steps 4000] [--batch 256] [--seq 16] [--device cuda]

The artifact directory holds params.npz (float16) + config.json (the
converted-artifact format, models/convert.py) + vocab.json (the
WordVocabTokenizer word list) + probes.json: the JAX package's format, so
either package loads it. ``EmbeddingModel`` reads the slots' artifacts from
``MINIVECTORDB_TORCH_RESOURCES`` when it is set (``<dir>/builtin``,
``<dir>/trained_<slot>``).

Deliberate differences from the JAX module: ``--device`` (default: the CUDA
card, raising without one); ``--out`` is required for training, and
``--probe-only`` writes probes.json only to ``--out``, because the bundled
artifacts belong to the JAX package (``minivectordb_tpu/resources/``), which
the port reads and never rewrites. ``--seq 256`` and longer (multiples of
128) on the card train through the flash-attention kernels K6, K7 and K8.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch.models import builtin_data
from minivectordb_tpu_torch.models import configs as model_configs
from minivectordb_tpu_torch.models.configs import TRAINED_BUILTIN
from minivectordb_tpu_torch.models.convert import load_converted, save_converted
from minivectordb_tpu_torch.models.encoder import (
    apply_cos_floor,
    encode,
    init_params,
    mean_pool_normalize,
)
from minivectordb_tpu_torch.models.quality_probes import (
    STRESSOR_FLOORS,
    STRESSORS,
    score_cases,
)
from minivectordb_tpu_torch.models.tokenizer import WordVocabTokenizer
from minivectordb_tpu_torch.ops import scan as scan_ops


def make_tokenizer(cfg=None) -> WordVocabTokenizer:
    # closed vocabulary: every trained word (concepts + template function
    # words) has a dedicated id; unknown words are dropped at inference so
    # they can never alias a trained embedding
    cfg = TRAINED_BUILTIN if cfg is None else cfg
    return WordVocabTokenizer(
        builtin_data.word_list(), cfg.vocab_size, drop_oov=True
    )


def _embed(params, tok, texts: list[str], seq: int = 32, cfg=None) -> np.ndarray:
    """Embeddings of ``texts`` by the ``Encoder`` ``params`` with ``cfg``'s
    pooling and cosine floor (the encoder's own config by default)."""
    cfg = params.cfg if cfg is None else cfg
    enc = tok(texts, max_length=seq)
    ids = np.asarray(
        [e + [1] * (seq - len(e)) for e in enc["input_ids"]], dtype=np.int32
    )[:, :seq]
    mask = np.asarray(
        [m + [0] * (seq - len(m)) for m in enc["attention_mask"]],
        dtype=np.int32,
    )[:, :seq]
    dev = params.device
    ids_t, mask_t = scan_ops.to_device(ids, dev), scan_ops.to_device(mask, dev)
    with torch.inference_mode():
        hidden = encode(params, ids_t, mask_t)
        out = apply_cos_floor(mean_pool_normalize(hidden, mask_t, cfg.token_norm_pool), cfg)
    return out.cpu().numpy()


def trained_token_ids(tok) -> np.ndarray:
    """Every token id the training distribution can produce: specials, the
    corpus vocabulary, and the template words (which land in OOV buckets)."""
    ids = {0, 1, 2, 3}
    for w in builtin_data.word_list():
        ids.update(tok.encode(w)[1:-1])
    for t in builtin_data.TEMPLATES:
        ids.update(tok.encode(t.format("x"))[1:-1])
    for t in builtin_data.MULTI_TEMPLATES:
        ids.update(tok.encode(t.format(*["x"] * t.count("{}")))[1:-1])
    return np.asarray(sorted(ids), dtype=np.int64)


def shrink_untrained_rows(params, tok, scale: float = 0.1) -> dict:
    """Scale down word-embedding rows the training data never touched (on the
    numpy parameter pytree).

    Untouched rows keep their random init, and an unknown word's random
    vector injects pure noise into the mean pool of an otherwise-known
    sentence; shrinking (not zeroing — unknown-only texts still embed
    distinctly) makes unseen words near-neutral."""
    seen = trained_token_ids(tok)
    emb = np.asarray(params["word_emb"]).copy()
    mask = np.ones(emb.shape[0], dtype=bool)
    mask[seen] = False
    emb[mask] *= scale
    out = dict(params)
    out["word_emb"] = emb
    return out


def _autocut_keep(scores_desc: list[float]) -> int:
    """How many results autocut keeps (a > 20% sharpest relative drop)."""
    drops = [
        (scores_desc[i - 1] - scores_desc[i]) / scores_desc[i - 1]
        for i in range(1, len(scores_desc))
    ]
    mx = max(drops)
    return (drops.index(mx) + 1) if mx > 0.2 else len(scores_desc)


def scenario_probes(params, tok, cfg=None) -> dict:
    """The semantic/autocut scenario assertions (the only probes the
    cos_floor affects — pure rankings are floor-invariant)."""
    res: dict = {}
    corpus = [
        "i like animals",
        "i like cars",
        "i like programming",
        "technology is the future",
    ]
    emb = _embed(params, tok, corpus, cfg=cfg)

    def scores(q: str) -> np.ndarray:
        qv = _embed(params, tok, [q], cfg=cfg)[0]
        return emb @ qv

    # "dogs" -> "animals"
    s = scores("i like dogs")[:3]
    res["dogs_top1_animals"] = bool(np.argmax(s) == 0)

    # "cars and animals" retrieves both in the top-2 of 4
    s = scores("cars and animals")
    res["cars_animals_top2"] = set(np.argsort(-s)[:2].tolist()) == {0, 1}

    # autocut keeps ONLY "technology is the future"
    s = scores("technology rocks")
    order = np.argsort(-s)
    kept = _autocut_keep(s[order].tolist())
    res["autocut_tech_only"] = bool(order[0] == 3 and kept == 1)
    res["autocut_tech_margin"] = float(
        (s[order[0]] - s[order[1]]) / max(s[order[0]], 1e-9)
    )

    # a multi-topic query keeps all four
    s = scores("animals, cars, programming, technology")
    kept = _autocut_keep(np.sort(s)[::-1].tolist())
    res["autocut_keeps_all"] = bool(kept == 4)
    res["autocut_min_score_ratio"] = float(np.min(s) / np.max(s))

    # the usearch engine's variant works in DISTANCE space: it cuts after a
    # >20% relative distance INCREASE, and relative distance ratios are
    # invariant to the cos_floor — the embeddings themselves must keep
    # adjacent multi-topic distances within 1.2x (gated at 1.17 for
    # quantization margin; int8 perturbs ratios by ~1%)
    d = np.sort(1.0 - s)
    res["usearch_dist_max_ratio"] = float(np.max(d[1:] / d[:-1]))
    res["usearch_autocut_keeps_all"] = bool(res["usearch_dist_max_ratio"] < 1.17)
    return res


def _embed_many(params, tok, texts, cfg=None, chunk: int = 256) -> np.ndarray:
    out = []
    for i in range(0, len(texts), chunk):
        out.append(_embed(params, tok, texts[i : i + chunk], cfg=cfg))
    return np.vstack(out)


def run_probes(params, tok, log=print, cfg=None) -> dict:
    """Scenario probes + generalisation metrics (batched — one forward per
    256 texts, not one per text)."""
    res = scenario_probes(params, tok, cfg=cfg)

    # generalization: held-out templates, member -> same-group synonym
    # ranked against distractors from other categories
    rng = np.random.default_rng(123)
    cats = list(builtin_data.CONCEPTS)
    et = builtin_data.EVAL_TEMPLATES
    n_trials = 200
    texts: list[str] = []
    starts: list[int] = []
    for _ in range(n_trials):
        cat = cats[rng.integers(len(cats))]
        _, groups = builtin_data.CONCEPTS[cat]
        g = groups[rng.integers(len(groups))]
        a = g[rng.integers(len(g))]
        b = g[rng.integers(len(g))]
        q = et[rng.integers(len(et))].format(a)
        pos = et[rng.integers(len(et))].format(b)
        distractors = []
        while len(distractors) < 15:
            c2 = cats[rng.integers(len(cats))]
            if c2 == cat:
                continue
            _, g2s = builtin_data.CONCEPTS[c2]
            g2 = g2s[rng.integers(len(g2s))]
            w2 = g2[rng.integers(len(g2))]
            distractors.append(et[rng.integers(len(et))].format(w2))
        starts.append(len(texts))
        texts.extend([q, pos] + distractors)
    emb = _embed_many(params, tok, texts, cfg=cfg)
    hits = sum(
        int(np.argmax(emb[s + 1 : s + 17] @ emb[s]) == 0) for s in starts
    )
    res["heldout_synonym_acc"] = hits / n_trials

    # hypernym sweep: "i like {member}" must pick its own category sentence
    cat_sents = ["i like " + builtin_data.CONCEPTS[c][0][1] for c in cats]
    cat_emb = _embed_many(params, tok, cat_sents, cfg=cfg)
    member_qs, owners = [], []
    for ci, cat in enumerate(cats):
        for g in builtin_data.CONCEPTS[cat][1]:
            member_qs.append("i like " + g[0])
            owners.append(ci)
    mq = _embed_many(params, tok, member_qs, cfg=cfg)
    pred = np.argmax(mq @ cat_emb.T, axis=1)
    res["hypernym_acc"] = float(np.mean(pred == np.asarray(owners)))

    # cross-lingual dog -> animals: each language's "i like dogs" must rank
    # the English animals sentence first against the scenario corpus
    xl_queries = [
        "me gustan los perros",      # es
        "j'aime les chiens",         # fr
        "ich mag hunde",             # de
        "mi piacciono i cani",       # it
        "eu gosto de cachorros",     # pt
    ]
    corpus4 = ["i like animals", "i like cars", "i like programming",
               "technology is the future"]
    ce = _embed_many(params, tok, corpus4, cfg=cfg)
    qe = _embed_many(params, tok, xl_queries, cfg=cfg)
    res["xlingual_dog_acc"] = float(
        np.mean(np.argmax(qe @ ce.T, axis=1) == 0)
    )

    # wide scenario: dog queries in en + the five trained languages must rank
    # "i like animals" first against a 7-sentence corpus with
    # template-heavy distractors
    wide_corpus = [
        "i like animals", "i like cars", "i like programming",
        "technology is the future", "the stock market fell sharply",
        "my favorite food is pasta", "she plays the violin beautifully",
    ]
    wide_queries = ["i like dogs"] + xl_queries
    we = _embed_many(params, tok, wide_corpus, cfg=cfg)
    wq = _embed_many(params, tok, wide_queries, cfg=cfg)
    res["wide_dogs_acc"] = float(np.mean(np.argmax(wq @ we.T, axis=1) == 0))

    # OOD stressor floors: the probe families of models/quality_probes.py gate
    # the artifact at training time
    for fam, cases in STRESSORS.items():
        res[f"stressor_{fam}"] = score_cases(
            lambda texts: _embed_many(params, tok, list(texts), cfg=cfg), cases)

    for k, v in res.items():
        log(f"  probe {k}: {v}")
    return res


GATES = {
    "dogs_top1_animals": True,
    "cars_animals_top2": True,
    "autocut_tech_only": True,
    "autocut_keeps_all": True,
    "usearch_autocut_keeps_all": True,
}
THRESHOLDS = {
    "heldout_synonym_acc": 0.85,
    "hypernym_acc": 0.80,
    "xlingual_dog_acc": 0.80,
    "wide_dogs_acc": 0.80,
}


def probes_pass(res: dict) -> bool:
    return (
        all(res[k] == v for k, v in GATES.items())
        and all(res[k] >= t for k, t in THRESHOLDS.items())
        and all(
            res[f"stressor_{fam}"] >= floor
            for fam, floor in STRESSOR_FLOORS.items()
        )
    )


def _bundled(slot: str, device):
    """(encoder, tokenizer) of a slot's bundled artifact, read by path from
    the JAX package's resources (or MINIVECTORDB_TORCH_RESOURCES), or None."""
    from minivectordb_tpu_torch.embedding_model import _bundled_dir

    bundle = _bundled_dir(slot)
    if not os.path.exists(os.path.join(bundle, "params.npz")):
        return None
    params, cfg = load_converted(bundle)
    with open(os.path.join(bundle, "vocab.json")) as f:
        vocab = json.load(f)
    tok = WordVocabTokenizer(vocab["words"], cfg.vocab_size,
                             drop_oov=bool(vocab.get("drop_oov", False)))
    return convert.encoder_from_numpy(params, cfg, device), tok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--slot", default="builtin",
                    choices=("builtin", "small", "large", "bgem3"),
                    help="which EmbeddingModel slot to train an artifact "
                    "for: 'builtin' (512-d) or a trained stand-in for "
                    "e5-small (384-d) / e5-large / bge-m3 (1024-d)")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--temperature", type=float, default=0.05,
                    help="InfoNCE temperature; higher -> smoother similarity "
                    "landscape (the autocut contract needs moderate, not "
                    "razor-sharp, similarity spreads)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="the artifact directory (required to train; with "
                    "--probe-only, where probes.json goes)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--force", action="store_true",
                    help="write the artifact even if probes fail")
    ap.add_argument("--probe-only", action="store_true",
                    help="skip training: load the slot's bundled artifact, "
                    "run the probe suite (probes.json to --out if given) — "
                    "exits 1 if the gate fails")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on "
                    "the host explicitly)")
    args = ap.parse_args(argv)
    device = scan_ops.resolve_device(args.device)

    if args.probe_only:
        loaded = _bundled(args.slot, device)
        if loaded is None:
            print(f"no bundled artifact for slot '{args.slot}'")
            return 1
        enc, tok = loaded
        res = run_probes(enc, tok)
        ok = probes_pass(res)
        print(f"probe gate: {'PASS' if ok else 'FAIL'}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "probes.json"), "w") as f:
                json.dump(res, f, indent=2)
        return 0 if ok else 1

    if args.out is None:
        ap.error("--out is required: the port writes its artifact to a directory "
                 "of your choice, never into the JAX package's resources")
    from minivectordb_tpu_torch.models.train import train_loop

    base_cfg = model_configs.TRAINED_CONFIGS[args.slot]
    if args.seed is None:
        args.seed = model_configs.TRAINED_SEEDS[args.slot]
    tok = make_tokenizer(base_cfg)
    generator = torch.Generator(device="cpu")
    generator.manual_seed(args.seed)
    params = init_params(base_cfg, generator, device)
    batches = builtin_data.batch_iterator(
        tok, args.batch, args.seq, seed=args.seed
    )
    print(
        f"training {args.slot}-{base_cfg.hidden} ({base_cfg.layers}L/"
        f"{base_cfg.hidden}H, vocab {base_cfg.vocab_size}) "
        f"for {args.steps} steps on {device}"
    )
    params, _opt, _hist = train_loop(
        base_cfg,
        params,
        batches,
        steps=args.steps,
        learning_rate=args.lr,
        temperature=args.temperature,
        checkpoint_path=args.checkpoint,
        log_every=200,
        device=device,
    )
    params = shrink_untrained_rows(convert.encoder_to_numpy(params), tok)
    encoder = convert.encoder_from_numpy(params, base_cfg, device)

    # cos_floor sweep: the floor rescales every cosine affinely (rankings
    # unchanged) to the high-anisotropy regime real sentence encoders have;
    # pick the smallest floor whose autocut scenario probes pass.
    cfg = base_cfg
    for f in (0.0, 0.25, 0.35, 0.45, 0.55, 0.65):
        trial = dataclasses.replace(base_cfg, cos_floor=f)
        sres = scenario_probes(encoder, tok, cfg=trial)
        print(f"  floor {f}: {sres}")
        if (
            sres["autocut_tech_only"]
            and sres["autocut_keeps_all"]
            and sres["usearch_autocut_keeps_all"]
        ):
            cfg = trial
            break

    print(f"probes (cos_floor={cfg.cos_floor}):")
    res = run_probes(encoder, tok, cfg=cfg)
    ok = probes_pass(res)
    print(f"probe gate: {'PASS' if ok else 'FAIL'}")
    if not ok and not args.force:
        return 1

    out = os.path.abspath(args.out)
    params_f16 = _map_leaves(params, lambda x: np.asarray(x).astype(np.float16))
    save_converted(params_f16, cfg, out)
    with open(os.path.join(out, "vocab.json"), "w") as f:
        json.dump(
            {
                "format": "word-vocab-v1",
                "drop_oov": tok.drop_oov,
                "words": tok.words,
            },
            f,
        )
    with open(os.path.join(out, "probes.json"), "w") as f:
        json.dump(res, f, indent=2)
    size = sum(
        os.path.getsize(os.path.join(out, f)) for f in os.listdir(out)
    )
    print(f"artifact written to {out} ({size / 1e6:.1f} MB)")
    return 0


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    raise SystemExit(main())
