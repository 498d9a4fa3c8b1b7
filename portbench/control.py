#!/usr/bin/env python3
"""The controls of the comparison that decides ``correct``, read on the
card at a cell's own size. The benchmark's runs never run this.

    python3 portbench/control.py --workload <name> --seeds 11 12 13 [--answers N]

For each seed it makes the cell's inputs as a run does, puts the reference
computed in TF32 (the nearest precision below the float32 the
configurations state) in the program's place, and prints the numbers the
cell compares, each beside its limit, as one JSON line. For a training cell
it also reads the fault "half of the batch left out, the mean taken over
the rest", planted in the reference put in the program's place. A state
left unchanged reads 1 on ``change_gap`` by its definition and needs no run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def search_control(run, answers: int) -> dict:
    from portbench import reference, traffic
    from portbench.drivers import common, search
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    corpus, queries = search.inputs(cfg, int(mix["query_pool"]), run.seed, dev)
    rows = traffic.rng(run.seed, "sample").integers(0, queries.shape[0], size=answers)
    kept = []
    for lo in range(0, answers, 512):
        part = torch.as_tensor(rows[lo:lo + 512], device=dev)
        v, i = reference.cosine_topk(corpus, queries[part], int(mix["k"]),
                                     dtype=torch.float32, tf32=True)
        for r, vv, ii in zip(rows[lo:lo + 512], v.tolist(), i.tolist()):
            kept.append((int(r), (ii, vv, [{"id": x} for x in ii])))
    del corpus, queries
    common.free(dev)
    search.check(run, kept)
    return {}


def embed_control(run, answers: int) -> dict:
    from portbench import hashtok, reference, traffic
    from portbench.drivers import common, embed
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    mc = cfg["model"]
    n = int(mix["batch"]) * int(mix["pool_batches"])
    specials = len(hashtok.HashTokenizer(1 << 20, cfg["document_prefix"]).encode(""))
    texts, lengths = traffic.text_pool(mix["chunk"], n, specials, run.seed)
    picked = common.sample(n, answers, traffic.rng(run.seed, "sample"),
                           must=[int(np.argmax(lengths))])
    tok = hashtok.HashTokenizer(int(mc["vocab_size"]), cfg["document_prefix"])
    seq = int(mix["chunk"]["max_tokens"])
    w = traffic.make_weights(mc, run.seed, dev)
    kept = {}
    with reference.precision(tf32=True), torch.no_grad():
        for lo in range(0, len(picked), 16):
            part = picked[lo:lo + 16]
            ids = np.full((len(part), seq), hashtok.PAD_ID, np.int64)
            mask = np.zeros((len(part), seq), np.int64)
            for r, i in enumerate(part):
                t = tok.encode(texts[i], seq)
                ids[r, :len(t)] = t
                mask[r, :len(t)] = 1
            out = reference.embed(w, torch.as_tensor(ids, device=dev),
                                  torch.as_tensor(mask, device=dev), mc)
            for i, e in zip(part, out.float().cpu().numpy()):
                kept[i] = e
    del w
    common.free(dev)
    embed.check(run, texts, kept)
    return {}


def train_control(run, answers: int) -> dict:
    from portbench import hashtok, traffic
    from portbench.drivers import train
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    tok = hashtok.HashTokenizer(int(cfg["model"]["vocab_size"]))
    batches = traffic.train_pool(mix, tok.encode, run.seed)
    want = train.reference_run(cfg, mix, batches, run.seed, dev)
    control = train.reference_run(cfg, mix, batches, run.seed, dev, tf32=True)
    half = [{k: (v[:len(v) // 2] if k in train.FEED else v) for k, v in b.items()}
            for b in batches]
    fault = train.reference_run(cfg, mix, half, run.seed, dev)
    lim = mix["limits"]
    out = {}
    for name, got in (("control", control), ("half_batch", fault)):
        g = train.gaps(got, want)
        out[name] = {k: {"value": g[k], "limit": float(lim[k])}
                     for k in ("loss_gap", "grad_gap", "change_gap")}
        out[name]["leaves"] = [g["grad_gap_leaf"], g["change_gap_leaf"]]
        out[name]["loss_gap_by_step"] = g["loss_gap_by_step"]
    run.checks = {k: (v["value"], v["limit"]) for k, v in out["control"].items()
                  if k in ("loss_gap", "grad_gap", "change_gap")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--answers", type=int, default=None,
                    help="answers compared a seed (default: about as many as a run compares)")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    from portbench import harness
    cell = harness.load_cell(root, args.workload)
    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    kind = cell.traffic["driver"]
    answers = args.answers or {"search": 2048, "embed": int(cell.traffic.get("check_texts", 0)),
                               "train": 0}[kind]
    fn = {"search": search_control, "embed": embed_control, "train": train_control}[kind]
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, 0.0, False, "cuda")
        extra = fn(run, answers)
        line = {"workload": cell.name, "seed": seed, "control": "tf32",
                "correct": harness.is_correct(run), "seconds": time.perf_counter() - t0,
                "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}}
        line.update(extra)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
