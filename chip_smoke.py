#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Needs a CUDA device, PyTorch built for CUDA and nvcc; exits non-zero, and
prints no result, without them. It imports ``minivectordb_tpu_torch`` and
nothing of the JAX package. Every phase must pass; any failure raises.

Phases (one JSON object per output line):
  env        card, versions, seconds the kernel build took; the next line is
             nvidia-smi's "name, power.limit" as it prints them
  main_path  VectorDatabase(device_dtype="float32") with 1,000,000 x 384
             seeded vectors: batch, filtered, single, async and
             after-delete searches, held against an oracle computed here
             (chunked float32 matmul + topk over the raw corpus)
  dtypes     the same search at 262,144 x 384 for "mixed", "bfloat16" and
             "int8", and persist_to_disk + reload
  kernels    every phase-1 kernel instantiation (float32, bfloat16, int8;
             with and without a mask) at C = 1,048,576, d = 384, B = 256,
             count = 1,000,000, held against its plain PyTorch version and
             timed beside it, beside one library product, and beside the
             card's bound; "launches" are the counts of the two phases
             above, which are driven with every count at 0 and read just
             after (the comparison launches of this phase run later and do
             not count)
The last line is {"ok": true, "device": {...}}.

Tolerances. Kernel against plain version, scores of magnitude <= 1: float32
and bfloat16-input 2e-5 (another summation order over 384 float32 terms;
bf16 products are exact in float32), int8 exactly 0 (integer dots, the same
two float32 multiplies in the same order); masked and past-count subtiles
must equal -3.0e38 exactly. Database against oracle: ids equal, scores 2e-5.

bound_ms is the larger of (bytes that must move) / 3.35 TB/s and
(operations) / peak, with the H100 SXM data-sheet peaks: 67 TFLOP/s float32
on the CUDA cores, 989 TFLOP/s bf16, 1979 TOP/s int8. Only the `count` live
rows need reading or multiplying, so both terms count those rows, not the
padded capacity; every output value is written.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

from minivectordb_tpu_torch import VectorDatabase  # noqa: E402
from minivectordb_tpu_torch.kernels import build  # noqa: E402
from minivectordb_tpu_torch.ops import fused_scan, scan as scan_ops  # noqa: E402

DEV = torch.device("cuda", 0)
SEED = 0
D = 384
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "i8": 1979e12}
TOL = {"f32": 2e-5, "bf16": 2e-5, "i8": 0.0}
MASKED = float(np.float32(-3.0e38))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# env
# ---------------------------------------------------------------------------


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [build.find_nvcc(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-2:]
    build.load_library("phase1")  # builds csrc/phase1.cu from the checkout
    info = build.build_info["phase1"]
    # ptxas prints "Compiling entry function '<name>'" and, two lines on,
    # "Used N registers, ... bytes smem": keep those per kernel
    log = info["log"].splitlines()
    resources = {}
    for i, line in enumerate(log):
        if "Compiling entry function" in line:
            used = next((u for u in log[i + 1:i + 4] if "Used" in u), "")
            spills = next((u for u in log[i + 1:i + 4] if "spill" in u), "")
            resources[line.split("'")[1]] = (
                used.split(":", 1)[-1].strip() + "; " + spills.strip())
    emit({
        "phase": "env",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": " | ".join(nvcc),
        "kernel_build_s": info["seconds"],
        "kernel_library": os.path.relpath(info["path"]),
        "kernel_resources": resources,
    })
    print(smi, flush=True)
    return smi


# ---------------------------------------------------------------------------
# oracle: independent of the port's scan code
# ---------------------------------------------------------------------------


def oracle_topk(corpus: np.ndarray, queries: np.ndarray, k: int,
                keep: np.ndarray | None = None):
    """Exact cosine top-k of raw numpy data: chunked float32 matmul + topk on
    the card, merged across chunks. keep: optional bool per row."""
    assert not torch.backends.cuda.matmul.allow_tf32
    q = torch.from_numpy(queries).to(DEV)
    q = q / q.norm(dim=1, keepdim=True)
    best_v = torch.full((q.shape[0], k), -float("inf"), device=DEV)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=DEV)
    step = 1 << 17
    for lo in range(0, corpus.shape[0], step):
        rows = torch.from_numpy(corpus[lo:lo + step]).to(DEV)
        s = (q @ rows.T) / rows.norm(dim=1)[None, :]
        if keep is not None:
            kp = torch.from_numpy(keep[lo:lo + step]).to(DEV)
            s = s.masked_fill(~kp[None, :], -float("inf"))
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        v = torch.cat([best_v, v], dim=1)
        i = torch.cat([best_i, i + lo], dim=1)
        best_v, pos = torch.topk(v, k, dim=1)
        best_i = torch.gather(i, 1, pos)
    return best_v.cpu().numpy(), best_i.cpu().numpy()


def check_hits(results, want_v, want_i, what: str, atol: float = 2e-5) -> None:
    assert len(results) == want_i.shape[0], what
    for b, (ids, scores, _md) in enumerate(results):
        assert list(ids) == want_i[b].tolist(), (what, b, ids, want_i[b])
        err = np.abs(np.asarray(scores, np.float32) - want_v[b]).max()
        assert np.isfinite(err) and err <= atol, (what, b, float(err))


def recall_at_k(results, want_i) -> float:
    hit = sum(len(set(ids) & set(want_i[b].tolist()))
              for b, (ids, _s, _m) in enumerate(results))
    return hit / want_i.size


# ---------------------------------------------------------------------------
# main path: float32, 1M x 384
# ---------------------------------------------------------------------------


def load_db(db, corpus: np.ndarray, pieces: int) -> float:
    n = corpus.shape[0]
    t0 = time.perf_counter()
    step = -(-n // pieces)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        db.store_embeddings_batch(
            list(range(lo, hi)), corpus[lo:hi],
            [{"bucket": i % 16} for i in range(lo, hi)],
        )
    return time.perf_counter() - t0


def phase_main_path(tmp: str) -> dict:
    n, b, k = 1_000_000, 256, 10
    rng = np.random.default_rng(SEED)
    corpus = rng.standard_normal((n, D), dtype=np.float32)
    queries = rng.standard_normal((b, D), dtype=np.float32)
    buckets = np.arange(n) % 16

    db = VectorDatabase(storage_file=os.path.join(tmp, "main.pkl"),
                        device_dtype="float32")
    load_s = load_db(db, corpus, pieces=4)

    t0 = time.perf_counter()
    first = db.find_most_similar_batch(queries, k=k)  # uploads the corpus
    first_search_s = time.perf_counter() - t0
    want_v, want_i = oracle_topk(corpus, queries, k)
    check_hits(first, want_v, want_i, "batch")

    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = db.find_most_similar_batch(queries, k=k)
        times.append((time.perf_counter() - t0) * 1e3)
    check_hits(res, want_v, want_i, "batch, repeated")

    filt = db.find_most_similar_batch(queries, k=k, metadata_filter={"bucket": 3})
    fv, fi = oracle_topk(corpus, queries, k, keep=buckets == 3)
    check_hits(filt, fv, fi, "filtered batch")
    assert all(md["bucket"] == 3 for _i, _s, mds in filt for md in mds)

    ids, scores, _ = db.find_most_similar(queries[0], k=k)
    check_hits([(ids, scores, None)], want_v[:1], want_i[:1], "single query")

    handles = [
        db.find_most_similar_batch_async(queries[j * 64:(j + 1) * 64], k=k)
        for j in range(4)
    ]
    for j, h in enumerate(handles):
        check_hits(h.result(), want_v[j * 64:(j + 1) * 64],
                   want_i[j * 64:(j + 1) * 64], f"async handle {j}")

    # delete the best hit of the first 1000... of distinct rows
    doomed = np.unique(want_i[:, 0])
    doomed = np.concatenate(
        [doomed, np.setdiff1d(np.arange(5000), doomed)[: 1000 - doomed.size]]
    )
    assert doomed.size == 1000
    for uid in doomed.tolist():
        db.delete_embedding(uid)
    keep = np.ones(n, dtype=bool)
    keep[doomed] = False
    after = db.find_most_similar_batch(queries, k=k)
    dv, di = oracle_topk(corpus, queries, k, keep=keep)
    check_hits(after, dv, di, "after delete")
    gone = set(doomed.tolist())
    assert not any(i in gone for ids, _s, _m in after for i in ids)

    routing = db.stats()["routing"]
    assert routing["device"].startswith("cuda"), routing
    out = {
        "phase": "main_path",
        "rows": n, "dim": D, "batch": b, "k": k,
        "load_s": load_s,
        "first_search_s": first_search_s,
        "batch_search_ms_median": statistics.median(times),
        "batch_search_ms_all": times,
        "routing": routing,
        "checked": ["batch", "filtered", "single", "async x4", "after delete"],
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# dtypes: mixed / bfloat16 / int8, 262,144 x 384
# ---------------------------------------------------------------------------


def phase_dtypes(tmp: str) -> dict:
    n, b, k = 262_144, 256, 10
    rng = np.random.default_rng(SEED + 1)
    corpus = rng.standard_normal((n, D), dtype=np.float32)
    queries = rng.standard_normal((b, D), dtype=np.float32)
    buckets = np.arange(n) % 16
    want_v, want_i = oracle_topk(corpus, queries, k)
    fv, fi = oracle_topk(corpus, queries, k, keep=buckets == 3)
    out = {"phase": "dtypes", "rows": n, "dim": D, "batch": b, "k": k}
    for dtype in ("mixed", "bfloat16", "int8"):
        path = os.path.join(tmp, f"{dtype}.pkl")
        db = VectorDatabase(storage_file=path, device_dtype=dtype)
        load_s = load_db(db, corpus, pieces=2)
        res = db.find_most_similar_batch(queries, k=k)
        filt = db.find_most_similar_batch(queries, k=k,
                                          metadata_filter={"bucket": 3})
        assert all(md["bucket"] == 3 for _i, _s, mds in filt for md in mds)
        if dtype == "mixed":
            check_hits(res, want_v, want_i, "mixed batch")
            check_hits(filt, fv, fi, "mixed filtered batch")
        recall = recall_at_k(res, want_i)
        recall_f = recall_at_k(filt, fi)
        assert recall >= 0.9 and recall_f >= 0.9, (dtype, recall, recall_f)
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            db.find_most_similar_batch(queries, k=k)
            times.append((time.perf_counter() - t0) * 1e3)
        entry = {"load_s": load_s, "recall_at_10": recall,
                 "recall_at_10_filtered": recall_f,
                 "batch_search_ms_median": statistics.median(times)}
        if dtype == "int8":
            t0 = time.perf_counter()
            db.persist_to_disk()
            again = VectorDatabase(storage_file=path, device_dtype=dtype)
            entry["persist_reload_s"] = time.perf_counter() - t0
            res2 = again.find_most_similar_batch(queries, k=k)
            assert [r[0] for r in res2] == [r[0] for r in res], "reload ids"
            assert len(again.id_map) == n
        out[dtype] = entry
        del db
    emit(out)
    return out


# ---------------------------------------------------------------------------
# kernels: each against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------


def kernel_cases(c: int, d: int, b: int, seed: int):
    """Operands for the three element types from one seeded corpus."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    buf = torch.randn((c, d), device=DEV, generator=g)
    q = scan_ops._normalize(torch.randn((b, d), device=DEV, generator=g))
    mask = torch.rand((c,), device=DEV, generator=g) < 0.5
    bf = buf.to(torch.bfloat16)
    i8, inv8 = scan_ops.update_rows_int8(
        torch.zeros((c, d), dtype=torch.int8, device=DEV),
        torch.zeros((c,), device=DEV), buf, 0, in_place=True,
    )
    qi, qinv = scan_ops.quantize_queries_int8(q)
    return mask, {
        "f32": (buf, scan_ops.row_inv_norms(buf), q, None),
        "bf16": (bf, scan_ops.row_inv_norms(bf), q.to(torch.bfloat16), None),
        "i8": (i8, inv8, qi, qinv),
    }


def run_kernel(kind, ops, count, mask):
    buf, inv, q, qinv = ops
    if kind == "i8":
        return fused_scan.subtile_maxima_int8(buf, inv, q, qinv, count, mask)
    return fused_scan.subtile_maxima(buf, inv, q, count, mask)


def run_plain(kind, ops, count, mask):
    buf, inv, q, qinv = ops
    if kind == "i8":
        return fused_scan.subtile_maxima_int8_plain(buf, inv, q, qinv, count, mask)
    return fused_scan.subtile_maxima_plain(buf, inv, q, count, mask)


def run_library(kind, ops, count, mask):
    """One library product into the whole (B, C) matrix, then the same
    scale / mask / 32-row max. The port never calls this on the fused route."""
    buf, inv, q, qinv = ops
    if kind == "i8":
        s = torch._int_mm(q, buf.T).to(torch.float32) * inv[None, :] * qinv[:, None]
    else:
        s = torch.matmul(q, buf.T).to(torch.float32) * inv[None, :]
    valid = torch.arange(buf.shape[0], device=DEV) < count
    if mask is not None:
        valid = valid & mask
    s = s.masked_fill(~valid[None, :], MASKED)
    return s.reshape(q.shape[0], -1, 32).amax(dim=-1)


def compare(kind, ops, count, mask, what):
    got = run_kernel(kind, ops, count, mask)
    torch.cuda.synchronize()
    want = run_plain(kind, ops, count, mask)
    assert got.shape == want.shape and got.dtype == torch.float32, what
    dead = want == MASKED
    assert torch.equal(got == MASKED, dead), (what, "masked subtiles differ")
    live = ~dead
    assert torch.isfinite(got).all(), what
    err = float((got[live] - want[live]).abs().max()) if live.any() else 0.0
    assert err <= TOL[kind], (what, err)
    return err, int(dead.sum()), float(got[live].mean())


def phase_kernels(launches: dict) -> dict:
    # small ragged case first: d not a multiple of the chunk, B below a block
    mask_s, cases_s = kernel_cases(4096, 24, 8, SEED + 2)
    ragged = {}
    for kind, ops in cases_s.items():
        for m in (None, mask_s):
            err, _, _ = compare(kind, ops, 4000, m, f"ragged {kind}")
            ragged[kind + ("_mask" if m is not None else "")] = err

    c, b, count = 1 << 20, 256, 1_000_000
    mask, cases = kernel_cases(c, D, b, SEED + 3)
    names = {"f32": "K1-f32", "bf16": "K1-bf16", "i8": "K2-int8"}
    replaces = {
        "f32": "minivectordb_tpu/ops/pallas_scan.py:164",
        "bf16": "minivectordb_tpu/ops/pallas_scan.py:164",
        "i8": "minivectordb_tpu/ops/pallas_scan.py:209",
    }
    kernels = []
    for kind, ops in cases.items():
        buf, _inv, q, _qinv = ops
        item = buf.element_size()
        for m in (None, mask):
            suffix = "_mask" if m is not None else ""
            what = names[kind] + suffix.replace("_", "-")
            err, n_dead, live_mean = compare(kind, ops, count, m, what)
            # plain, kernel, kernel, plain: both versions inside one run
            plain_a = event_ms(lambda: run_plain(kind, ops, count, m), 5)
            ms_a = event_ms(lambda: run_kernel(kind, ops, count, m), 20)
            ms_b = event_ms(lambda: run_kernel(kind, ops, count, m), 20)
            plain_b = event_ms(lambda: run_plain(kind, ops, count, m), 5)
            lib = event_ms(lambda: run_library(kind, ops, count, m), 5)
            n_bytes = (count * D * item + b * D * item + count * 4
                       + (count if m is not None else 0)
                       + (b * 4 if kind == "i8" else 0)
                       + b * (c // 32) * 4)
            t_bytes = n_bytes / PEAK_BYTES_S * 1e3
            t_ops = 2 * b * count * D / PEAK_OPS_S[kind] * 1e3
            kernels.append({
                "name": what,
                "route": "cuda",
                "source": "minivectordb_tpu_torch/csrc/phase1.cu",
                "replaces": replaces[kind],
                "launches": launches["phase1_" + kind + suffix],
                "max_abs_err": err,
                "tolerance": TOL[kind],
                "ms": statistics.median([ms_a, ms_b]),
                "plain_ms": statistics.median([plain_a, plain_b]),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib,
                "shape": {"C": c, "d": D, "B": b, "count": count},
                "masked_subtiles": n_dead,
                "mean_live_maximum": live_mean,
                "ragged_max_abs_err": ragged[kind + suffix],
            })
    return {"kernels": kernels}


def main() -> None:
    smi = phase_env()
    with tempfile.TemporaryDirectory() as tmp:
        fused_scan.reset_launches()
        phase_main_path(tmp)
        phase_dtypes(tmp)
        launches = dict(fused_scan.LAUNCHES)
    missing = [name for name, n in launches.items() if n == 0]
    assert not missing, f"the main path never launched: {missing}"
    torch.cuda.empty_cache()
    emit(phase_kernels(launches))
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })


if __name__ == "__main__":
    main()
