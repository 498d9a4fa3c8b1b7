"""Document ingest through ``EmbeddingModel.extract_embeddings_batch``, in a
closed loop.

Set-up draws the encoder's weights on the device from the seed
(``traffic.make_weights``) and hands them to
``EmbeddingModel(use_quantized_onnx_model=False, alternative_model=...)``
the way a converted checkpoint is loaded: an artifact directory (the
port's ``models.convert.save_converted``) under the run's TMPDIR, named by
``MINIVECTORDB_TORCH_WEIGHTS``, deleted once the model has loaded. It makes
a pool of texts from seeded words (the mix's chunk lengths) and warms the
one shape with two calls. The window embeds ``batch`` texts a call, cycling
through the pool.

The window keeps the embeddings of a sample of the pool drawn from the seed,
the longest chunk among them. After the window the program is freed, the
weights are made again from the seed, the sampled texts are tokenized by
the frozen tokenizer and embedded by the reference encoder of the
configuration's model family, ``check_batch`` texts at a time (16 unless
the mix says otherwise).
"""

from __future__ import annotations

import os
import shutil
import time
import types

import numpy as np
import torch

from portbench import families, hashtok, reference, traffic
from portbench.drivers import common


def port_config(config: dict):
    """The port's EncoderConfig of a published config.json's keys, as its
    checkpoint converter reads them."""
    from minivectordb_tpu_torch.models.convert import config_from_hf
    return config_from_hf(types.SimpleNamespace(**config["model"]))


def load_model(run, config: dict, mix: dict, seed: int, tmp: str, device: str):
    from minivectordb_tpu_torch import EmbeddingModel
    from minivectordb_tpu_torch.models.convert import save_converted
    weights = traffic.make_weights(config["model"], seed, device)
    tree = families.of(config["model"]).to_pytree(
        {p: v.cpu().numpy() for p, v in weights.items()})
    del weights
    common.free(device)
    run.mark("weights")
    slot = config["slot"]
    save_converted(tree, port_config(config), os.path.join(tmp, "weights", slot))
    del tree
    run.mark("artifact")
    os.environ["MINIVECTORDB_TORCH_WEIGHTS"] = os.path.join(tmp, "weights")
    try:
        model = EmbeddingModel(use_quantized_onnx_model=False, alternative_model=slot,
                               compute_dtype=mix.get("compute_dtype"), device=device)
    finally:
        del os.environ["MINIVECTORDB_TORCH_WEIGHTS"]
        shutil.rmtree(os.path.join(tmp, "weights"), ignore_errors=True)
    if model.weights_source != "pretrained":
        raise RuntimeError(f"the seeded weights did not load: {model.weights_source}")
    run.mark("model load")
    return model


def run(run, tmp: str, t_start: float) -> None:
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    run.mark("imports")
    model = load_model(run, cfg, mix, run.seed, tmp, dev)
    batch = int(mix["batch"])
    n = batch * int(mix["pool_batches"])
    # tokens the tokenizer adds to a text's words: BOS, EOS and the prefix
    specials = len(hashtok.HashTokenizer(1 << 20, cfg["document_prefix"]).encode(""))
    texts, lengths = traffic.text_pool(mix["chunk"], n, specials, run.seed)
    longest = int(np.argmax(lengths))
    wanted = set(common.sample(n, int(mix["check_texts"]), traffic.rng(run.seed, "sample"),
                               must=[longest]))
    run.mark("texts")
    for b in range(2):
        model.extract_embeddings_batch(texts[b * batch:(b + 1) * batch])
    run.mark("warm-up")
    from portbench import trace
    kept, calls = {}, []
    j = 0
    with trace.profiled(run):
        end = common.start_window(run, dev, t_start) + run.seconds
        while time.perf_counter() < end:
            lo = (j % int(mix["pool_batches"])) * batch
            j += 1
            run.attempted += batch
            a = time.time_ns()
            ts = time.perf_counter()
            try:
                out = model.extract_embeddings_batch(texts[lo:lo + batch])
            except Exception as exc:
                run.fail(batch, exc)
                continue
            finally:
                run.span("embed", a, time.time_ns())
            common.done(run, ts, time.perf_counter(), batch, sum(lengths[lo:lo + batch]))
            calls.append(lengths[lo:lo + batch])
            for i in range(lo, lo + batch):
                if i in wanted and i not in kept:
                    kept[i] = np.array(out[i - lo], dtype=np.float32)
    common.close_window(run, dev)
    run.facts.update(calls=calls, dtype=mix.get("compute_dtype") or "float32")
    del model
    common.free(dev)
    check(run, texts, kept)


def reference_embeddings(run, texts: list, order: list, tf32: bool = False):
    """Yield (indices, the reference's embeddings of their texts) for the
    texts ``order`` lists, ``check_batch`` at a time (the mix's, default
    16): tokenized by the frozen tokenizer and embedded by the family's
    reference from the seed's weights, with TF32 off (the reference) or on
    (the control). The weights are freed once the last block is taken."""
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    mc = cfg["model"]
    tok = hashtok.HashTokenizer(int(mc["vocab_size"]), cfg["document_prefix"])
    seq = int(mix["chunk"]["max_tokens"])
    block = int(mix.get("check_batch", 16))
    w = traffic.make_weights(mc, run.seed, dev)
    with reference.precision(tf32=tf32), torch.no_grad():
        for lo in range(0, len(order), block):
            part = order[lo:lo + block]
            ids = np.full((len(part), seq), hashtok.PAD_ID, np.int64)
            mask = np.zeros((len(part), seq), np.int64)
            for r, i in enumerate(part):
                t = tok.encode(texts[i], seq)
                ids[r, :len(t)] = t
                mask[r, :len(t)] = 1
            yield part, reference.embed(w, torch.as_tensor(ids, device=dev),
                                        torch.as_tensor(mask, device=dev), mc)
    del w
    common.free(dev)


def check(run, texts: list, kept: dict) -> None:
    """``embed_gap``: the largest Euclidean distance between a kept
    embedding and the reference's embedding of the same text (both unit
    vectors); ``bad_answers``: kept embeddings of the wrong width or not
    finite."""
    mix, dev = run.cell.traffic, run.device
    width = int(run.cell.config["model"]["hidden_size"])
    bad = 0
    good = {}
    for i, e in kept.items():
        if e.shape != (width,) or not np.isfinite(e).all():
            bad += 1
        else:
            good[i] = e
    gap = float("inf")
    if good:
        gap = 0.0
        for part, want in reference_embeddings(run, texts, sorted(good)):
            got = torch.as_tensor(np.stack([good[i] for i in part]), device=dev)
            gap = max(gap, float(torch.linalg.vector_norm(
                got.double() - want.double(), dim=1).max()))
    run.notes["answers_checked"] = len(kept)
    run.checks = {"bad_answers": (float(bad), float(mix["limits"]["bad_answers"])),
                  "embed_gap": (gap, float(mix["limits"]["embed_gap"]))}


def control_answers(mix: dict) -> int:
    """Texts a control compares a seed: as many as a run checks."""
    return int(mix.get("check_texts", 0))


def control(run, answers: int) -> dict:
    """The reference computed in TF32 in the program's place: the
    embeddings of ``answers`` texts of the pool drawn from the seed (the
    longest among them), held to the run's check."""
    cfg, mix = run.cell.config, run.cell.traffic
    n = int(mix["batch"]) * int(mix["pool_batches"])
    specials = len(hashtok.HashTokenizer(1 << 20, cfg["document_prefix"]).encode(""))
    texts, lengths = traffic.text_pool(mix["chunk"], n, specials, run.seed)
    picked = common.sample(n, answers, traffic.rng(run.seed, "sample"),
                           must=[int(np.argmax(lengths))])
    kept = {}
    for part, out in reference_embeddings(run, texts, picked, tf32=True):
        for i, e in zip(part, out.float().cpu().numpy()):
            kept[i] = e
    check(run, texts, kept)
    return {}


def tiny(config: dict, mix: dict) -> None:
    """The mix cut, in place, to a size the CPU runs in seconds."""
    mix.update(batch=4, pool_batches=3, check_texts=6,
               chunk={"full_share": 0.75, "tail_min": 8, "tail_max": 60, "max_tokens": 64})
