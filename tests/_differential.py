"""Lockstep differential driver for the public classes: one seeded op
sequence applied to a JAX-package database and a port database side by side.

Every op runs on both; each result is compared as it comes (ids equal where
the scores are not tied within the tolerance, scores within it, metadata
equal), and an op that raises must raise the same exception type in both.
The metadata and filters come from tests/test_filter_fuzz.py's generators
(mixed ints, floats, strings, bools, naive datetimes, lists, missing keys),
plus a nested dict under "nested" and the reference's spellings of $and (a
list of filter dicts), $or (``or_filters``) and $eq (plain equality; the
operator "$eq" itself is unknown to both packages and must raise).

``Lockstep`` is also a database: tests/test_durability_fuzz.py's ``_run_ops``
and ``_check_matches_oracle`` drive it unchanged.

Left out on purpose, as deliberate differences of the port (ROADMAP.md):
``stats()`` and the routers' state (the port times its first device search
in line on the caller's thread and lets a device error reach the caller; the
JAX package probes on a background thread), and the engine's ``reset()`` /
a second ``load()`` (the JAX mesh engine keeps its mesh index across it; the
port drops it). The sequence reads neither and never reloads an engine in
place: a reopen builds new instances.
"""

from __future__ import annotations

import copy
import gc
import random

import numpy as np

from minivectordb_tpu.vector_database import VectorDatabase as JaxDB
from minivectordb_tpu_torch import VectorDatabase as TorchDB

from test_filter_fuzz import KEYS, _oracle, _rand_filter_dict, _rand_meta

D = 16


class Lockstep:
    """``jax`` and ``port`` databases driven in lockstep (see the module
    docstring). ``tol`` is the score tolerance. ``reopen(swap)`` must return
    fresh (jax, port) instances; ``swap=True`` opens each package on the
    other's files. ``lower_is_better`` names the methods whose scores are
    distances (ascending)."""

    def __init__(self, jax_db, port_db, tol: float, reopen=None, lower_is_better=(),
                 oracle=False):
        self.jax, self.port = jax_db, port_db
        self.tol = tol
        self._reopen = reopen
        self.lower_is_better = lower_is_better
        # oracle: the port is held to the exact numpy oracle over ``state``
        # at every search, and where the packages diverge the oracle decides
        # (a JAX answer that misses it is the reference's fault and passes).
        # Off where scores are quantized or are distances.
        self.oracle = oracle
        self.state = None  # (live {uid: vector}, metas {uid: metadata}), the driver's
        self.ops = []  # (name, summary) of every op, for failure messages

    def call(self, name, *args, **kw):
        """Both packages' results of one call (inputs deep-copied for each),
        or, where either raised, the same exception type re-raised from the
        JAX side."""
        self.ops.append((name, _summary(args, kw)))
        outs, errs = [], []
        for db in (self.jax, self.port):
            a, k = copy.deepcopy(args), copy.deepcopy(kw)
            try:
                outs.append(getattr(db, name)(*a, **k))
                errs.append(None)
            except Exception as exc:  # compared below
                outs.append(None)
                errs.append(exc)
        if errs[0] is not None or errs[1] is not None:
            assert type(errs[0]) is type(errs[1]), self._where(
                f"{name} raised {type(errs[0]).__name__}: {errs[0]} in the JAX package "
                f"and {type(errs[1]).__name__}: {errs[1]} in the port")
            raise errs[0]
        return outs

    # database surface, so the JAX tests' op generators drive both
    def store_embedding(self, uid, vec, meta=None):
        self.call("store_embedding", uid, vec, meta)

    def store_embeddings_batch(self, uids, vecs, metas=None):
        self.call("store_embeddings_batch", uids, vecs, metas)

    def delete_embedding(self, uid):
        self.call("delete_embedding", uid)

    def delete_embeddings_batch(self, uids):
        self.call("delete_embeddings_batch", uids)

    def get_vector(self, uid):
        j, t = self.call("get_vector", uid)
        j, t = np.asarray(j), np.asarray(t)
        assert j.dtype == t.dtype and j.tobytes() == t.tobytes(), self._where("get_vector")
        return j

    def find_most_similar(self, q, **kw):
        j, t = self.call("find_most_similar", q, **kw)
        self.judge("find_most_similar", [j], [t], np.asarray(q)[None, :], kw)
        return j

    def find_most_similar_batch(self, qs, **kw):
        j, t = self.call("find_most_similar_batch", qs, **kw)
        self.judge("find_most_similar_batch", j, t, qs, kw)
        return j

    def find_most_similar_batch_async(self, qs, **kw):
        jh, th = self.call("find_most_similar_batch_async", qs, **kw)
        j, t = jh.result(), th.result()
        self.judge("find_most_similar_batch_async", j, t, qs, kw)
        return j

    @property
    def unique_ids(self):
        j, t = list(self.jax.unique_ids), list(self.port.unique_ids)
        assert j == t, self._where("unique_ids")
        return j

    def reopen(self, swap: bool) -> None:
        """Persist (where the class has persist_to_disk), drop both
        instances and open new ones: each package on its own files, or
        (swap) on the other's."""
        for db in (self.jax, self.port):
            if hasattr(db, "persist_to_disk"):
                db.persist_to_disk()
        self.jax = self.port = None
        gc.collect()
        self.jax, self.port = self._reopen(swap)
        self.ops.append(("reopen", "swapped" if swap else "own files"))

    # comparison
    def judge(self, what, j_rows, t_rows, queries, kw):
        """Each query's hits of the two packages, and with ``oracle`` the
        port's against the oracle's, which decides a divergence."""
        checked = self.oracle and self.state is not None
        if checked:
            want = self.oracle_hits(queries, kw)
            self.same_ranking(want, t_rows, what, ("oracle", "port"))
        try:
            assert len(j_rows) == len(t_rows), self._where(what)
            for jr, tr in zip(j_rows, t_rows):
                self.same_hits(jr, tr, what)
        except AssertionError:
            if not checked:
                raise
            # the port matched the oracle, so the JAX answer must miss it (a
            # fault of the reference, which passes); if it does not, the
            # comparison itself is at fault
            try:
                self.same_ranking(want, j_rows, what, ("oracle", "JAX"))
            except AssertionError:
                return
            raise

    def oracle_hits(self, queries, kw):
        """(ids, scores, metadatas) of each query over ``state``: float64
        cosine over the live rows that test_filter_fuzz's filter oracle
        passes (``metadata_filters``: one filter a query)."""
        live, metas = self.state
        uids = list(live)
        mat = np.stack([live[u] for u in uids]).astype(np.float64)
        mat /= np.maximum(np.linalg.norm(mat, axis=1), 1e-30)[:, None]
        md = [metas[u] for u in uids]
        per_query = kw.get("metadata_filters")
        shared = (kw.get("metadata_filter"), kw.get("exclude_filter"), kw.get("or_filters"))
        rows_of = {}

        def passing(mf, exc, orf):
            key = repr((mf, exc, orf))
            if key not in rows_of:
                rows = _oracle(md, mf, None, orf) if mf or orf else set(range(len(uids)))
                # exclude is equality only, a dict value compared as a value
                for f in [exc] if isinstance(exc, dict) else exc or []:
                    for name, val in f.items():
                        rows = {r for r in rows if not (name in md[r] and md[r][name] == val)}
                rows_of[key] = np.asarray(sorted(rows), np.int64)
            return rows_of[key]

        out = []
        for i, q in enumerate(np.asarray(queries, np.float64)):
            rows = passing(*((per_query[i], None, None) if per_query is not None else shared))
            s = mat[rows] @ (q / np.linalg.norm(q))
            top = np.argsort(-s, kind="stable")[:kw.get("k", 5)]
            out.append(([uids[r] for r in rows[top]], s[top], [md[r] for r in rows[top]]))
        return out

    def same_ranking(self, want_rows, got_rows, what, names):
        """Ids, scores and metadata of ``got_rows`` against ``want_rows``
        (query by query), ties as same_hits allows them."""
        assert len(want_rows) == len(got_rows), self._where(what)
        for w, g in zip(want_rows, got_rows):
            self.same_hits(w, g, what, types=False, names=names)

    def same_hits(self, j, t, what, types=True, names=("JAX", "port")):
        kinds = ([type(x) for x in j], [type(x) for x in t])
        j_ids, j_s, j_md = (list(x) for x in j)
        t_ids, t_s, t_md = (list(x) for x in t)
        where = self._where(
            f"{what}: {names[0]} {j_ids[:12]} {np.round(j_s[:12], 6).tolist()}, "
            f"{names[1]} {t_ids[:12]} {np.round(t_s[:12], 6).tolist()}")
        if types:
            assert kinds[0] == kinds[1], (where, kinds)
        assert len(j_ids) == len(t_ids) == len(j_s) == len(t_s) == len(j_md) == len(t_md), where
        if not j_ids:
            return
        if types:
            assert [type(x) for x in j_ids] == [type(x) for x in t_ids], (where, "id types")
        js, ts = np.asarray(j_s, np.float64), np.asarray(t_s, np.float64)
        assert np.abs(js - ts).max() <= self.tol, where
        order = np.diff(js) if what in self.lower_is_better else -np.diff(js)
        assert (order >= -self.tol).all(), where  # sorted best first
        md_of = dict(zip(j_ids, j_md))
        for pos, (a, b) in enumerate(zip(j_ids, t_ids)):
            if a != b:
                # only where the scores tie within the tolerance: the JAX side
                # holds b at a tied score, or the tie runs past the list's
                # end (b tied with the k-th hit, beyond k on the JAX side)
                tied_here = abs(js[j_ids.index(b)] - js[pos]) <= 2 * self.tol \
                    if b in j_ids else abs(js[-1] - js[pos]) <= 2 * self.tol
                assert tied_here, where
        for uid, md in zip(t_ids, t_md):
            if uid in md_of:
                assert md == md_of[uid], where

    def _where(self, msg):
        tail = "; ".join(f"{n}({s})" for n, s in self.ops[-4:])
        return f"{msg} [after {len(self.ops)} ops; last: {tail}]"


def count_calls(monkeypatch, targets: dict) -> dict:
    """{route: calls from here on} of the functions ``targets`` names,
    {route: [(module or class, attribute name), ...]}."""
    counts = dict.fromkeys(targets, 0)

    def counted(route, fn):
        def wrapper(*args, **kw):
            counts[route] += 1
            return fn(*args, **kw)
        return wrapper

    for route, places in targets.items():
        for obj, name in places:
            monkeypatch.setattr(obj, name, counted(route, getattr(obj, name)))
    return counts


def flat_lockstep(tmp_path, tol, oracle=False, **kw) -> Lockstep:
    """Both packages' VectorDatabase(**kw) (the port's on the CPU) on files of
    their own, with a reopen that persists and swaps the files between the
    packages."""
    paths = [str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")]

    def reopen(swap):
        if swap:
            paths.reverse()
        return (JaxDB(storage_file=paths[0], **kw),
                TorchDB(storage_file=paths[1], device="cpu", **kw))

    return Lockstep(*reopen(False), tol=tol, reopen=reopen, oracle=oracle)


def _summary(args, kw) -> str:
    parts = []
    for a in args:
        if isinstance(a, np.ndarray):
            parts.append(f"array{a.shape}")
        elif isinstance(a, list) and len(a) > 6:
            parts.append(f"list[{len(a)}]")
        else:
            parts.append(repr(a)[:60])
    parts += [f"{k}={repr(v)[:80]}" for k, v in kw.items()]
    return ", ".join(parts)


# ---------------------------------------------------------------------------
# the op sequence
# ---------------------------------------------------------------------------


def rand_meta(rng, uid) -> dict:
    """test_filter_fuzz's metadata, plus an int id and a nested dict."""
    meta = _rand_meta(rng)
    meta["n"] = uid if isinstance(uid, int) else int(str(uid)[1:])
    if rng.random() < 0.5:
        meta["nested"] = {"x": rng.randint(0, 2), "tag": rng.choice(["a", "b"])}
    return meta


def filter_kwargs(rng, pool) -> dict:
    """One search's filter arguments: none; test_filter_fuzz's dicts as
    metadata_filter; a list of them ($and); or_filters ($or); an equality
    exclude; a range on the id; the nested dict by equality; or a probe that
    both packages must answer alike (an unknown "$eq" / "$bogus" operator, a
    nested key, the literal "$and" / "$or" keys)."""
    r = rng.random()
    if r < 0.25:
        return {}
    if r < 0.43:
        return {"metadata_filter": _rand_filter_dict(rng, pool)}
    if r < 0.5:
        return {"metadata_filter": [_rand_filter_dict(rng, pool), _rand_filter_dict(rng, pool)]}
    if r < 0.57:
        return {"or_filters": [_rand_filter_dict(rng, pool) for _ in range(rng.choice([1, 2]))]}
    if r < 0.62:
        return {"metadata_filter": _rand_filter_dict(rng, pool),
                "or_filters": _rand_filter_dict(rng, pool),
                "exclude_filter": {rng.choice(KEYS): rng.choice(pool)}}
    if r < 0.67:
        return {"exclude_filter": {rng.choice(KEYS): rng.choice(pool)}}
    if r < 0.74:
        lo = rng.randint(0, 3000)
        return {"metadata_filter": {"n": {"$gte": lo, "$lte": lo + rng.choice([5, 50, 500])}}}
    if r < 0.8:
        # $in is the reference's "the filter value is a member of the stored
        # value": a scalar finds the stored lists that hold it, a list of
        # scalars finds no scalar row
        scalar = rng.choice([v for v in pool if not isinstance(v, list)] or [1])
        value = scalar if rng.random() < 0.5 else [scalar, rng.choice(pool)]
        return {"metadata_filter": {rng.choice(KEYS): {"$in": value}}}
    if r < 0.86:
        nested = {"x": rng.randint(0, 2), "tag": rng.choice(["a", "b"])}
        return {rng.choice(["metadata_filter", "exclude_filter"]): {"nested": nested}}
    probes = [{"metadata_filter": {"a": {"$eq": rng.choice(pool)}}},
              {"metadata_filter": {"b": {"$bogus": 1}}},
              {"metadata_filter": {"nested.x": 1}},
              {"metadata_filter": {"nested": {"x": 1}}},
              {"metadata_filter": {"$and": [{"a": 1}, {"b": 2}]}},
              {"metadata_filter": {"$or": [{"a": 1}]}}]
    return rng.choice(probes)


def run_sequence(db: Lockstep, seed: int, n_ops: int, *, sharded: bool,
                 bulk: int = 2200, reopen_at=(), batch_sizes=(2, 5, 8, 12, 16, 24)) -> dict:
    """One seeded op sequence on ``db``: stores, batch stores, deletes,
    get_vector, searches (single, batches of ``batch_sizes``, per-query
    filters, async), error probes, and a bulk load of ``bulk`` rows after the
    first third of the ops (so the capacity reaches 4,096 and batches of 16
    and more take the fused route; before it, k exceeds the live count).
    ``reopen_at``: op indices where both reopen, swapped files first, then
    alternating with their own. Returns counters of what ran."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    live = {}
    metas = {}
    db.state = (live, metas)
    next_id = [1]
    count = {"store": 0, "batch_store": 0, "delete": 0, "get": 0, "search": 0,
             "batch": 0, "fused_batch": 0, "async": 0, "per_query": 0, "raised": 0,
             "reopen": 0}

    def uid_of(i):
        return f"u{i}" if sharded else i

    def fresh(n):
        ids = [uid_of(next_id[0] + i) for i in range(n)]
        next_id[0] += n
        return ids

    def pool():
        vals = [v for m in list(metas.values())[-200:] for v in m.values()
                if v is not None and not isinstance(v, dict)]
        return vals[:40] or [1]

    def queries(b):
        q = nprng.standard_normal((b, D)).astype(np.float32)
        if live and rng.random() < 0.3:  # a stored row as a query: exact ties
            keys = sorted(live, key=str)
            q[0] = live[keys[rng.randrange(len(keys))]]
        return q

    def expect_raise(fn, *args, **kw):
        """Runs one op that may raise (the same type in both packages, which
        Lockstep checks); a divergence (AssertionError) is not swallowed."""
        try:
            fn(*args, **kw)
        except AssertionError:
            raise
        except Exception:
            count["raised"] += 1
            return True
        return False

    reopen_at = set(reopen_at)
    swap = True
    for step in range(n_ops):
        if step in reopen_at:
            db.reopen(swap)
            swap = not swap
            count["reopen"] += 1
        if step == n_ops // 3 and bulk:
            ids = fresh(bulk)
            vecs = nprng.standard_normal((bulk, D)).astype(np.float32)
            mds = [rand_meta(rng, u) for u in ids]
            db.store_embeddings_batch(ids, vecs, mds)
            live.update(zip(ids, vecs))
            metas.update(zip(ids, mds))
            # one batch of each route's size, whatever the draws below
            for b in (max(batch_sizes), sorted(batch_sizes)[len(batch_sizes) // 2]):
                db.find_most_similar_batch(queries(b), k=10)
                count["batch"] += 1
                count["fused_batch"] += int(b >= 16)
        op = rng.random()
        if op < 0.16 or len(live) < 4:
            (u,) = fresh(1)
            v = nprng.standard_normal(D).astype(np.float32)
            md = rand_meta(rng, u)
            db.store_embedding(u, v, md)
            live[u], metas[u] = v, md
            count["store"] += 1
        elif op < 0.24:
            n = rng.choice([2, 7, 33])
            ids = fresh(n)
            vecs = nprng.standard_normal((n, D)).astype(np.float32)
            mds = [rand_meta(rng, u) for u in ids]
            db.store_embeddings_batch(ids, vecs, mds)
            live.update(zip(ids, vecs))
            metas.update(zip(ids, mds))
            count["batch_store"] += 1
        elif op < 0.34:
            doomed = rng.sample(sorted(live, key=str), min(len(live) - 3, rng.choice([1, 3, 9])))
            if sharded:
                db.delete_embeddings_batch(doomed)
            else:
                for u in doomed:
                    db.delete_embedding(u)
            for u in doomed:
                del live[u], metas[u]
            count["delete"] += 1
        elif op < 0.40:
            u = rng.choice(sorted(live, key=str))
            got = db.get_vector(u)
            assert np.asarray(got, np.float32).tobytes() == live[u].tobytes()
            count["get"] += 1
        elif op < 0.46:
            # error probes: duplicate id (alone and inside a batch), deleting
            # and getting a missing id, an unknown operator
            u = rng.choice(sorted(live, key=str))
            missing = uid_of(10 ** 7 + step)
            v = nprng.standard_normal(D).astype(np.float32)
            probes = [(db.store_embedding, (u, v, {})),
                      (db.store_embeddings_batch, (fresh(1) + [u], np.stack([v, v]), [{}, {}])),
                      (db.delete_embeddings_batch if sharded else db.delete_embedding,
                       ([missing],) if sharded else (missing,)),
                      (db.get_vector, (missing,)),
                      (db.find_most_similar, (v,), {"metadata_filter": {"a": {"$bogus": 0}}})]
            fn, args, *kw = rng.choice(probes)
            assert expect_raise(fn, *args, **(kw[0] if kw else {})), fn
        elif op < 0.66:
            k = rng.choice([1, 5, 10, 64])
            expect_raise(db.find_most_similar, queries(1)[0], k=k,
                         **filter_kwargs(rng, pool()))
            count["search"] += 1
        elif op < 0.84:
            b = rng.choice(batch_sizes)
            k = rng.choice([3, 10])
            raised = expect_raise(db.find_most_similar_batch, queries(b), k=k,
                                  **filter_kwargs(rng, pool()))
            count["batch"] += 1
            count["fused_batch"] += int(b >= 16 and step >= n_ops // 3 and not raised)
        elif op < 0.92:
            b = rng.choice([4, 16])
            flts = [filter_kwargs(rng, pool()).get("metadata_filter") for _ in range(b)]
            expect_raise(db.find_most_similar_batch, queries(b), k=5, metadata_filters=flts)
            count["per_query"] += 1
        else:
            b = rng.choice([3, 16])
            expect_raise(db.find_most_similar_batch_async, queries(b), k=rng.choice([4, 10]),
                         **filter_kwargs(rng, pool()))
            count["async"] += 1
    db.find_most_similar_batch(queries(max(batch_sizes)), k=10)  # the final state
    return {"live": len(live), **count}
