"""Exact top-k search through ``VectorDatabase``, in a closed loop.

Set-up makes the corpus and a pool of queries on the device from the seed
(``traffic.mixture``), stores the corpus with one metadata dict a row
(``{"id": row}``) through ``store_embeddings_batch`` and warms the cell's
one shape. The window then drives one of two loops (the mix's ``loop``):

- ``async``: batches of ``batch`` queries through
  ``find_most_similar_batch_async``, ``in_flight`` of them queued; each is
  drained with ``.result()`` and replaced at once. A call's time runs from
  its submit to its result in the caller's hands.
- ``serial``: one query a call through ``find_most_similar``.

From every call the loop keeps a sample of answers drawn from the seed
(hits, scores, metadata). After the window the program is freed, the
corpus and queries are made again from the seed, and each kept answer is
held against the exact float64 top-k (``reference.cosine_topk``).
"""

from __future__ import annotations

import collections
import os
import time

import numpy as np
import torch

from portbench import reference, traffic
from portbench.drivers import common


def inputs(config: dict, pool: int, seed: int, device):
    spec = dict(config["mixture"], dim=config["dim"])
    return traffic.mixture(spec, int(config["rows"]), pool, seed, device)


def run(run, tmp: str, t_start: float) -> None:
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    run.mark("imports")
    corpus, queries = inputs(cfg, int(mix["query_pool"]), run.seed, dev)
    corpus_np, queries_np = corpus.cpu().numpy(), queries.cpu().numpy()
    del corpus, queries
    common.free(dev)
    run.mark("inputs")

    from minivectordb_tpu_torch import VectorDatabase
    db = VectorDatabase(storage_file=os.path.join(tmp, "db.pkl"),
                        device_dtype=cfg["device_dtype"], search_mode=cfg["search_mode"],
                        index=cfg["index"], device=dev)
    rows = list(range(int(cfg["rows"])))
    db.store_embeddings_batch(rows, corpus_np, [{"id": i} for i in rows])
    del corpus_np
    run.mark("store")
    loop = {"async": _async_loop, "serial": _serial_loop}[mix["loop"]]
    kept = loop(run, db, queries_np, mix, t_start)
    common.close_window(run, dev)
    run.facts.update(rows=int(cfg["rows"]), dim=int(cfg["dim"]), k=int(mix["k"]),
                     batch=int(mix["batch"]))
    del db
    common.free(dev)
    check(run, kept)


def _async_loop(run, db, pool: np.ndarray, mix: dict, t_start: float) -> list:
    from portbench import trace
    batch, k, depth = int(mix["batch"]), int(mix["k"]), int(mix["in_flight"])
    starts = np.arange(0, pool.shape[0] - batch + 1, batch)
    order = traffic.rng(run.seed, "order")
    pick = traffic.rng(run.seed, "sample")
    calls = iter(range(1 << 62))

    def rows_of(j):
        if j % len(starts) == 0:
            order.shuffle(starts)
        return int(starts[j % len(starts)])

    for _ in range(2):  # warm the one shape: kernels, handles, the upload
        handles = [db.find_most_similar_batch_async(pool[rows_of(next(calls)):][:batch], k=k)
                   for _ in range(depth)]
        for h in handles:
            h.result()
    run.mark("warm-up")
    kept = []
    pending = collections.deque()
    with trace.profiled(run):
        end = common.start_window(run, run.device, t_start) + run.seconds

        def submit():
            lo = rows_of(next(calls))
            a = time.time_ns()
            ts = time.perf_counter()
            run.attempted += batch
            try:
                h = db.find_most_similar_batch_async(pool[lo:lo + batch], k=k)
            except Exception as exc:  # a failed call counts and the loop goes on
                run.fail(batch, exc)
                return
            finally:
                run.span("dispatch", a, time.time_ns())
            pending.append((lo, ts, h))

        for _ in range(depth):
            submit()
        while pending:
            lo, ts, h = pending.popleft()
            a = time.time_ns()
            try:
                res = h.result()
            except Exception as exc:
                run.fail(batch, exc)
                res = None
            finished = time.perf_counter()
            run.span("result", a, time.time_ns())
            if res is not None:
                common.done(run, ts, finished, batch)
                r = int(pick.integers(batch))
                kept.append((lo + r, res[r]))
            if time.perf_counter() < end:
                submit()
    return kept


def _serial_loop(run, db, pool: np.ndarray, mix: dict, t_start: float) -> list:
    from portbench import trace
    k, share = int(mix["k"]), float(mix["check_share"])
    order = traffic.rng(run.seed, "order")
    pick = traffic.rng(run.seed, "sample")
    perm = order.permutation(pool.shape[0])
    for j in range(3):
        db.find_most_similar(pool[perm[-1 - j]], k=k)
    run.mark("warm-up")
    kept = []
    j = 0
    with trace.profiled(run):
        end = common.start_window(run, run.device, t_start) + run.seconds
        while time.perf_counter() < end:
            row = int(perm[j % len(perm)])
            j += 1
            run.attempted += 1
            a = time.time_ns()
            ts = time.perf_counter()
            try:
                res = db.find_most_similar(pool[row], k=k)
            except Exception as exc:
                run.fail(1, exc)
                continue
            finally:
                run.span("call", a, time.time_ns())
            common.done(run, ts, time.perf_counter(), 1)
            if pick.random() < share:
                kept.append((row, res))
    return kept


def check(run, kept: list) -> None:
    """Hold every kept answer against the exact top-k: ``bad_answers``
    counts answers with another number of hits than k, a repeated or
    unknown id, or a hit whose metadata is not its row's; over the rest,
    ``score_gap`` is the largest distance of a returned score from the
    float64 cosine of its id, and ``rank_gap`` the most by which the
    cosine of the j-th hit falls below the true j-th best."""
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    k, rows = int(mix["k"]), int(cfg["rows"])
    limits = mix["limits"]
    bad, good_rows, ids, scores = 0, [], [], []
    for row, (hit_ids, hit_scores, metas) in kept:
        hit_ids = [int(h) for h in hit_ids]
        if (len(hit_ids) != k or len(set(hit_ids)) != k
                or not all(0 <= h < rows for h in hit_ids)
                or any(m != {"id": h} for h, m in zip(hit_ids, metas))):
            bad += 1
            continue
        good_rows.append(row)
        ids.append(hit_ids)
        scores.append([float(s) for s in hit_scores])
    score_gap = rank_gap = float("inf")
    if good_rows:
        corpus, queries = inputs(cfg, int(mix["query_pool"]), run.seed, dev)
        ids_t = torch.as_tensor(ids, device=dev)
        got = torch.as_tensor(scores, dtype=torch.float64, device=dev)
        q_rows = torch.as_tensor(good_rows, device=dev)
        score_gap = rank_gap = 0.0
        for lo in range(0, len(good_rows), 512):
            q = queries[q_rows[lo:lo + 512]]
            true_of_hits = reference.cosine_of(corpus, q, ids_t[lo:lo + 512])
            best, _ = reference.cosine_topk(corpus, q, k)
            score_gap = max(score_gap, float((got[lo:lo + 512] - true_of_hits).abs().max()))
            rank_gap = max(rank_gap, float((best - true_of_hits).max()))
        del corpus, queries
        common.free(dev)
    run.notes["answers_checked"] = len(kept)
    run.checks = {"bad_answers": (float(bad), float(limits["bad_answers"])),
                  "score_gap": (score_gap, float(limits["score_gap"])),
                  "rank_gap": (rank_gap, float(limits["rank_gap"]))}


def control_answers(mix: dict) -> int:
    """Answers a control compares a seed."""
    return 2048


def control(run, answers: int) -> dict:
    """The top-k computed in float32 with TF32 in the program's place, for
    ``answers`` queries of the pool drawn from the seed, held to the run's
    check."""
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    corpus, queries = inputs(cfg, int(mix["query_pool"]), run.seed, dev)
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
    check(run, kept)
    return {}


def tiny(config: dict, mix: dict) -> None:
    """The corpus and the mix cut, in place, to a size the CPU runs in
    seconds."""
    config.update(rows=6000, dim=32)
    mix.update(query_pool=512)
    if mix["loop"] == "async":
        mix.update(batch=32, in_flight=2)
