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
  ivf_path   VectorDatabase(index="ivf") with its default options over
             1,000,000 x 384 vectors of a seeded two-level mixture (1,024
             centres in 32 families, plus noise): build, a 256-query batch (K4-bf16), a single query and a
             batch of 8 (K3-bf16), a broad filter, async handles, deletes and
             appended rows (overflow scan + merge), calibrate_nprobe, save ->
             load -> search; then the same, shorter, at 262,144 x 384 with
             float32 lists (K4-f32, K3-f32) and int8 lists (K5). With
             nprobe = nlist the hits must equal the oracle; at the default
             nprobe the kernel route must equal the plain probe
             (ops/ivf.py:_ivf_search) on the same snapshot; recall@10 is
             printed, not asserted
  encoder_path  EmbeddingModel() (the bundled builtin artifact) on texts long
             enough for sequences of 256 and 512 (K6-f32, 2 launches a call)
             and on short ones (no launch), and batches of 1 and of 8 through
             its host/device router, eight calls each for long and for short
             texts, every result equal to the card's whichever route served
             it; then the e5-large architecture at
             its published widths (24 layers, hidden 1024, 16 heads of 64,
             intermediate 4096, vocabulary 250,037) with weights from a
             seeded torch.Generator, written as an artifact directory and
             loaded through EmbeddingModel(use_quantized_onnx_model=False,
             alternative_model="large"): 32 texts of about 500 tokens in
             float32 (K6-f32) and with compute_dtype="bfloat16" (K6-bf16), 24
             launches a call; each result held against the same module with
             the plain attention in the kernel's place
  pipeline_path  TextSearchPipeline.search over a VectorDatabase of 262,144 x
             1,024 (256 texts embedded by that model, the rest random unit
             rows): 32 long queries, with and without a metadata filter, and
             on an index="ivf" copy, against find_most_similar_batch of the
             model's embeddings; every stored text finds itself first
  train_path contrastive training (models/train.py) at the e5-large widths,
             weights from a seeded torch.Generator: batches of 8 (query,
             passage) pairs of 200-505 seeded words through the slot's hashing
             tokenizer, padded to S = 512 (ragged), so every encode takes the
             flash route: K6 with its row log-sum-exp forward, K7 and K8
             backward, 48 launches each per step (asserted). train_loop takes
             2 steps and writes its checkpoint (step 2), then step 3; the
             checkpoint is loaded and step 3 taken again from it, which must
             repeat the uninterrupted step (loss 1e-5, every parameter 1e-5).
             Prints ms per step and real tokens per second on the host clock
             (the loss is read after every step), checkpoint save / load /
             resume seconds. Then models/train_builtin.py's main (20 steps,
             batch 64, S = 256: TRAINED_BUILTIN's 8 heads of 64 through
             K6/K7/K8, 80 launches each, asserted) writes an artifact that
             EmbeddingModel() must load from its directory. Last, after the
             counts are read, step 1's loss and gradients are held against the
             same module with flash_attention_plain in K6's place,
             differentiated by autograd
  kernels    every kernel instantiation held against its plain PyTorch
             version over its whole output and timed beside it, beside one
             library call, and beside the card's bound: the phase-1 kernels
             (float32, bfloat16, int8; with and without a mask) at
             C = 1,048,576, d = 384, B = 256, count = 1,000,000, after a
             ragged case (d = 24: int8 takes the narrow-row kernel, which the
             library's phase1_route reports and its own counter shows) and
             the bf16 / int8 Hopper kernel's tiling edges at C = 65,536
             (TILING_CASES, emitted on a line of their own; at every case
             each subtile past `count` must be the sentinel); the narrow-row
             kernel must not have run on the flat paths or the 1M-row case;
             and the IVF
             probe kernels (K3 f32/bf16, K4 f32/bf16, K5) at the shapes the
             1,000,000-row IVF path produced (its lists, its step table for
             256 queries, its probe ids for 8), after a small ragged case
             for each (P = 130, d = 6 / 12 / 100, G = 8, padding steps); and
             the flash-attention kernel K6 (f32, bf16) at B = 32, nh = 16,
             S = 512, hd = 64 with seeded ragged lengths, in the encoder's
             (B, S, nh, hd) memory layout, after S = 256 at every other head
             width (16 ... 128), ragged cases (S = 200 and S = 1, a row with
             one real token, key tiles that hold pads only; S = 129 and 384,
             not whole tiles) and segment ids that are not "ones, then
             zeros" (three packed sequences and pads; the cyclic
             (i // 37) % 3), beside scaled_dot_product_attention with a
             boolean segment mask; its rows also give the operations the
             kernel multiplied (whole tiles it visits) beside those counted,
             and the TFLOP/s of each; and K6-f32 with its log-sum-exp, K7 and
             K8 at the training step's shape (B = 16, nh = 16, S = 512,
             hd = 64, ragged lengths), after S = 256 at every head width, S =
             200 / 129 / 1 and the packed and cyclic ids (there the bf16
             forward's log-sum-exp is held too), beside SDPA's forward and
             its autograd backward (dq, dk, dv in one call: compare it with
             K7 + K8).
             "launches" are the counts of the path phases above: the flat
             phases, and each database of the ivf phase, are driven through
             the public class with every count at 0 and read just after;
             every launch made to compare a kernel or a route with its plain
             version runs after that read and does not count
The last line is {"ok": true, "device": {...}}.

Tolerances. Kernel against plain version, scores of magnitude <= 1: float32
and bfloat16-input 2e-5 (another summation order over 384 float32 terms;
bf16 products are exact in float32), int8 exactly 0 (integer dots, the same
two float32 multiplies in the same order); masked and past-count subtiles
must equal -3.0e38 exactly. Database against oracle: ids equal, scores 2e-5.
K6 against its plain version, inputs standard normal, at every position, pads
included: float32 2e-5 (another summation order, expf against torch's exp);
bfloat16 2e-2 (the kernel rounds the probabilities to bf16 before P V, as the
TPU kernel does, the plain version keeps them float32; both round the output
once) and, since a one-token row's outputs near 1 set that maximum while a
long row's are near 0.1, for each output row |kernel - plain| <= 2^-7 *
max|plain| over the row + 2e-3 (one bf16 step of the row's largest value,
plus the P rounding). Embeddings (unit vectors) with the kernel against the plain attention
in the same module: float32 2e-5; bfloat16 2e-2 and a cosine of 0.999.
K6's log-sum-exp, K7 and K8 against their plain versions, inputs and dO standard
normal, every position: 2e-5 (float32 sums of at most S products in another order,
expf / ex2.approx against torch's exp; gradients reach about 3). Step 1 of the
e5-large training against the plain-attention module (autograd through
flash_attention_plain), per parameter tensor, |g - g_plain| <= 1e-4 |g_plain|
(Frobenius norms): both are float32 through 24 layers, where each layer's kernels
sum in another order than the plain version (a rounding of 2^-24 a sum, grown by
the chained Jacobians of 24 layers and by sums over up to 8,192 tokens into each
weight gradient); 1e-4 is 1,600 roundings of float32 and far below any change of
the step. The loss within 1e-5, relative. The q and k projections are held to
|g - g_plain| <= 1e-4 |g_plain of that layer's v weight| instead: their gradient
reaches them only through dS = P * (dP - delta), whose rows sum to zero, and at
these random weights it nearly cancels in the deep layers (a k bias's exactly: q_i .
b_k is constant along row i, which softmax ignores; layer 23's q and k weights have
gradient norms near 1e-6 of v's), so what float32 leaves of it is rounding: the
TPU kernel's formulation, which the kernels keep (delta = rowsum(dO * O), P
recomputed from the log-sum-exp), differs there from autograd's softmax backward
by its residual of sum_j dS_ij, which v's gradient (x^T P^T dO, from the same P and
dO) sets the scale of. The run also reports every route's distance to the float64
gradient (materialised attention, float64 weights) and to the kernels' formulation
in plain PyTorch, for the record.

bound_ms is the larger of (bytes that must move) / 3.35 TB/s and
(operations) / peak, with the H100 SXM data-sheet peaks: 67 TFLOP/s float32
on the CUDA cores, 989 TFLOP/s bf16, 1979 TOP/s int8. Only the `count` live
rows need reading or multiplying, so both terms count those rows, not the
padded capacity; every output value is written. For the grouped probe the
work depends on the data: bytes are the DISTINCT touched list blocks read
once plus the live steps' operands and outputs, operations those of the live
steps; padding steps count nothing. For K6 the operations are those of the
(query, key) pairs of one segment, 4 * nh * hd * sum_b(n_b^2 + (S - n_b)^2)
for n_b real tokens in row b; q, k, v and the output move once each. K7
multiplies 8 * nh * hd and K8 6 * nh * hd per pair of one segment (S and dP
again, then dV and dK, or dQ); K7 moves q, k, v, dO in and dK, dV out, K8 q, k,
v, dO in and dQ out, with lse and delta (float32 per row) and the ids.
"multiplied_operations" are 4 * nh * hd * (rows x keys of a tile) * the
tiles the kernel visits (ops/flash_attention.py:visited_tiles).
"""

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

import torch.nn.functional as F  # noqa: E402

from minivectordb_tpu_torch import EmbeddingModel, VectorDatabase  # noqa: E402
from minivectordb_tpu_torch import convert as port_convert  # noqa: E402
from minivectordb_tpu_torch.core.pipeline import TextSearchPipeline  # noqa: E402
from minivectordb_tpu_torch.kernels import build  # noqa: E402
from minivectordb_tpu_torch.models import configs as model_configs  # noqa: E402
from minivectordb_tpu_torch.models import convert as model_convert  # noqa: E402
from minivectordb_tpu_torch.models import encoder as encoder_mod  # noqa: E402
from minivectordb_tpu_torch.models import train as train_mod  # noqa: E402
from minivectordb_tpu_torch.models import train_builtin  # noqa: E402
from minivectordb_tpu_torch.models.checkpoint import load_checkpoint  # noqa: E402
from minivectordb_tpu_torch.models.tokenizer import HashTokenizer  # noqa: E402
from minivectordb_tpu_torch.ops import flash_attention as flash_ops  # noqa: E402
from minivectordb_tpu_torch.ops import fused_scan, ivf as ivf_ops  # noqa: E402
from minivectordb_tpu_torch.ops import ivf_probe, scan as scan_ops  # noqa: E402
from minivectordb_tpu_torch.profile_search import clustered_corpus  # noqa: E402
from minivectordb_tpu_torch.profile_search import phase1_operands  # noqa: E402

DEV = torch.device("cuda", 0)
SEED = 0
D = 384
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "i8": 1979e12}
TOL = {"f32": 2e-5, "bf16": 2e-5, "i8": 0.0}
MASKED = float(np.float32(-3.0e38))
TOL_K6 = {"f32": 2e-5, "bf16": 2e-2}
# bfloat16 only, per output row (the hd values of one query and head):
# |kernel - plain| <= ROW_REL * max|plain| over the row + ROW_ABS
TOL_K6_ROW_REL = 2.0 ** -7
TOL_K6_ROW_ABS = 2e-3
TOL_EMBED = {"f32": 2e-5, "bf16": 2e-2}
TOL_LSE = 2e-5  # K6's row log-sum-exp against the plain version's
TOL_BWD = 2e-5  # K7 / K8 against the plain backward, every position
TOL_GRAD = 1e-4  # per parameter tensor: |g - g_plain| / |g_plain| (Frobenius; q, k: below)
SOURCES = build.SOURCES
# the text path's K6 entry points and the training path's
TEXT_ENTRY_POINTS = ("flash_attention_f32", "flash_attention_bf16")
TRAIN_ENTRY_POINTS = ("flash_attention_lse_f32", "flash_attention_bwd_dkv_f32",
                      "flash_attention_bwd_dq_f32")


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
    # builds every source of csrc/ from the checkout, one nvcc each, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.load_library, SOURCES))
    build_wall_s = time.perf_counter() - t0
    # ptxas prints "Compiling entry function '<name>'" and, two lines on,
    # "Used N registers, ... bytes smem": keep those per kernel
    resources = {}
    for name in SOURCES:
        log = build.build_info[name]["log"].splitlines()
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
        "kernel_build_s": build_wall_s,
        "kernel_build_s_each": {n: build.build_info[n]["seconds"] for n in SOURCES},
        "kernel_libraries": [os.path.relpath(build.build_info[n]["path"])
                             for n in SOURCES],
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
    # every subtile wholly past count is the sentinel (out comes from torch.empty)
    assert bool((got[:, -(-count // 32):] == MASKED).all()), (what, "past count")
    return err, int(dead.sum()), float(got[live].mean())


# The Hopper kernel's edges (csrc/phase1.cu, phase1_wgmma_kernel), each held
# against the plain version for bf16 and int8, with and without a mask, at a
# small C: B below one warpgroup's 64, not a multiple of 64, and eight query
# blocks (bf16) / four (int8); wide rows (queries per block shrink, 128-row
# tiles; bf16 at 1,536 streams its queries); C not a multiple of the tile;
# `count` inside the last live tile in every case.
TILING_CASES = [  # (C, d, B, count)
    (65_536, D, 16, 65_536 - 100),
    (65_536, D, 200, 60_000 + 17),
    (65_536, D, 1_024, 50_001),
    (65_536, 768, 256, 64_000 + 33),
    (65_536, 1_024, 256, 40_000 + 70),
    (65_536, 1_536, 256, 30_000 + 5),
    (4_096 + 96, D, 256, 4_096 + 40),
]


def tiling_cases() -> list:
    out = []
    for c, d, b, count in TILING_CASES:
        mask, cases = phase1_operands(c, d, b, SEED + 4 + d + b)
        for kind in ("bf16", "i8"):
            for m in (None, mask):
                what = f"tiling {kind} C={c} d={d} B={b} count={count}" + (
                    " mask" if m is not None else "")
                err, _, _ = compare(kind, cases[kind], count, m, what)
                out.append({"case": [c, d, b, count], "kind": kind, "mask": m is not None,
                            "max_abs_err": err, "tolerance": TOL[kind]})
        del cases, mask
    return out


def phase_kernels(launches: dict, ivf_shapes: dict, ivf_launches: dict,
                  k6_launches: dict, train_launches: dict) -> dict:
    # small ragged case first: d not a multiple of the chunk, B below a block;
    # int8 rows of 24 bytes take the narrow-row kernel, bf16 rows of 48 the
    # Hopper one
    fused_scan.reset_launches()
    mask_s, cases_s = phase1_operands(4096, 24, 8, SEED + 2)
    ragged = {}
    for kind, ops in cases_s.items():
        for m in (None, mask_s):
            err, _, _ = compare(kind, ops, 4000, m, f"ragged {kind}")
            ragged[kind + ("_mask" if m is not None else "")] = err
    narrow = dict(fused_scan.NARROW_LAUNCHES)
    assert narrow["phase1_i8"] > 0 and narrow["phase1_i8_mask"] > 0, narrow
    assert narrow["phase1_bf16"] == 0 and narrow["phase1_bf16_mask"] == 0, narrow
    tiling = tiling_cases()
    assert fused_scan.NARROW_LAUNCHES == narrow, "a wide row reached the narrow kernel"
    emit({"phase": "phase1_tiling", "cases": tiling, "narrow_launches_ragged": narrow})

    c, b, count = 1 << 20, 256, 1_000_000
    mask, cases = phase1_operands(c, D, b, SEED + 3)
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
    # the 1M-row launches, like the flat paths' (main), took the Hopper kernel
    assert fused_scan.NARROW_LAUNCHES == narrow, "the 1M-row case reached the narrow kernel"
    del cases, mask
    torch.cuda.empty_cache()
    kernels += ivf_kernel_rows(ivf_shapes, ivf_launches)
    kernels += encoder_kernel_rows(k6_launches)
    kernels += train_kernel_rows(train_launches)
    return {"kernels": kernels}


# ---------------------------------------------------------------------------
# ivf_path: index="ivf" through the public class
# ---------------------------------------------------------------------------


def mixture(n: int, b: int, seed: int):
    """n corpus rows and b queries from the profiler's seeded two-level
    mixture: 1,024 centres in 32 families, plus noise."""
    return clustered_corpus(n, b, D, 1024, seed)


def check_hits_tied(results, want_v, want_i, what: str, atol: float = 2e-5) -> None:
    """check_hits, but two ids may swap where their oracle scores are tied
    (closer than 2 * atol)."""
    assert len(results) == want_i.shape[0], what
    for b, (ids, scores, _md) in enumerate(results):
        got = np.asarray(scores, np.float32)
        assert len(ids) == want_i.shape[1], (what, b, len(ids))
        err = np.abs(got - want_v[b]).max()
        assert np.isfinite(err) and err <= atol, (what, b, float(err))
        for j, (a, w) in enumerate(zip(ids, want_i[b].tolist())):
            if a != w:
                near = [abs(want_v[b][j] - want_v[b][i]) for i in (j - 1, j + 1)
                        if 0 <= i < want_v.shape[1]]
                assert min(near) <= 2 * atol, (what, b, j, ids, want_i[b])


def same_candidates(got_v, got_i, want_v, want_i, what, atol) -> float:
    """Kernel route against the plain probe on one snapshot: scores within
    atol, ids equal where scores are not tied. Returns the max score error."""
    assert got_v.shape == want_v.shape and got_i.shape == want_i.shape, what
    live = want_v > MASKED / 2
    assert torch.equal(got_v > MASKED / 2, live), (what, "sentinel slots differ")
    err = float((got_v[live] - want_v[live]).abs().max())
    assert err <= atol, (what, err)
    differ = (got_i != want_i) & live
    if differ.any():
        wv = want_v.cpu().numpy()
        gap = np.minimum(np.abs(np.diff(wv, axis=1, prepend=np.inf)),
                         np.abs(np.diff(wv, axis=1, append=-np.inf)))
        assert (gap[differ.cpu().numpy()] <= max(2 * atol, 1e-7)).all(), what
    return err


def route_against_plain_probe(db, queries, lists_dtype: str) -> dict:
    """At the database's own nprobe: ivf_search_grouped (batch 32) and
    ivf_search_paged (batch 8; int8 has no paged route) against
    ops/ivf.py:_ivf_search on the same snapshot."""
    snap = db._engine._ivf.snapshot()
    lists, list_ids, list_valid = snap.tables
    nlist_eff = int(snap.centroids.shape[0])
    nprobe = min(-(-db.nprobe * nlist_eff // max(1, nlist_eff - snap.n_dup)), nlist_eff)
    atol = 0.0 if lists_dtype == "int8" else 2e-5
    out = {}
    for batch in (32, 8):
        q = torch.from_numpy(queries[:batch]).to(DEV)
        xv, xi = ivf_ops._ivf_search(snap.centroids, lists, list_ids, list_valid,
                                     q, nprobe, 40, list_inv=snap.list_inv)
        if batch >= 16 or lists_dtype == "int8":
            kv, ki = ivf_probe.ivf_search_grouped(
                snap.centroids, lists, list_ids, list_valid, q, nprobe, 40,
                list_inv=snap.list_inv)
        else:
            kv, ki = ivf_probe.ivf_search_paged(
                snap.centroids, lists, list_ids, list_valid, q, nprobe, 40)
        out[f"batch_{batch}_max_abs_err"] = same_candidates(
            kv, ki, xv, xi, f"{lists_dtype} route vs plain probe, batch {batch}", atol)
    return out


def timed_batches(db, queries, k, reps=10, **kw):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = db.find_most_similar_batch(queries, k=k, **kw)
        times.append((time.perf_counter() - t0) * 1e3)
    return res, statistics.median(times)


def ivf_database(tmp, name, corpus, lists_dtype):
    db = VectorDatabase(storage_file=os.path.join(tmp, name + ".pkl"), index="ivf",
                        ivf_opts={"lists_dtype": lists_dtype})
    load_s = load_db(db, corpus, pieces=4)
    return db, load_s


def ivf_common_checks(db, corpus, queries, k, lists_dtype, keep=None) -> dict:
    """First search (upload + build), the default-nprobe batch, single query,
    batch of 8, exactness at nprobe = nlist: all through the public class.
    Returns what it measured."""
    t0 = time.perf_counter()
    db.find_most_similar_batch(queries, k=k)  # uploads the corpus, builds the index
    first_search_s = time.perf_counter() - t0
    st = db.stats()
    ivf = db._engine._ivf
    lists = ivf._lists
    want_v, want_i = oracle_topk(corpus, queries, k, keep=keep)

    res, batch_ms = timed_batches(db, queries, k)
    single = db.find_most_similar(queries[0], k=k)
    eight, eight_ms = timed_batches(db, queries[:8], k)
    assert len(single[0]) == k and all(len(r[0]) == k for r in res + eight)
    # the documented contract: probing every list is exact
    nlist_all = st["ivf"]["nlist_effective"]
    exact32 = db.find_most_similar_batch(queries[:32], k=k, nprobe=nlist_all)
    check_hits_tied(exact32, want_v[:32], want_i[:32], f"{lists_dtype} nprobe = nlist")
    return {
        "lists_dtype": lists_dtype,
        "rows": int(corpus.shape[0]),
        "first_search_s": first_search_s,
        "build_s": st["ops"]["ivf_build"]["total_s"],
        "corpus_sync_s": st["ops"]["corpus_sync"]["total_s"],
        "L": int(lists.shape[0]), "P": int(lists.shape[1]),
        "n_dup": int(ivf.n_dup),
        "list_tensor_bytes": lists.numel() * lists.element_size(),
        "nprobe": db.nprobe,
        "batch_256_ms_median": batch_ms,
        "batch_8_ms_median": eight_ms,
        "recall_at_10_batch_256": recall_at_k(res, want_i),
        "recall_at_10_batch_8": recall_at_k(eight, want_i[:8]),
        "recall_at_10_single": recall_at_k([single], want_i[:1]),
        "checked": ["nprobe = nlist equals the oracle (batch 32)"],
    }


# the kernel entry points a database of each lists_dtype must reach through
# the public class, and the only ones it may reach
IVF_ENTRY_POINTS = {
    "bfloat16": {"ivf_grouped_bf16", "ivf_probe_bf16"},
    "float32": {"ivf_grouped_f32", "ivf_probe_f32"},
    "int8": {"ivf_grouped_i8"},
}


def read_path_launches(total: dict, lists_dtype: str) -> dict:
    """The counts since the last reset, all made by the public class on one
    database: exactly the entry points of its lists_dtype must have been
    launched. Adds them to ``total``."""
    got = dict(ivf_probe.LAUNCHES)
    hit = {name for name, count in got.items() if count > 0}
    assert hit == IVF_ENTRY_POINTS[lists_dtype], (lists_dtype, got)
    for name, count in got.items():
        total[name] = total.get(name, 0) + count
    return got


def phase_ivf_path(tmp: str):
    """Returns the kernels phase's operands and the launch counts of the
    public class's searches. Every count is set to 0 before each database is
    driven and read just after its last call through the class; the direct
    calls that compare the routes with the plain probe come after the read."""
    n, b, k = 1_000_000, 256, 10
    corpus, queries = mixture(n, b, SEED + 10)
    buckets = np.arange(n) % 16
    path_launches = {}
    ivf_probe.reset_launches()
    db, load_s = ivf_database(tmp, "ivf_bf16", corpus, "bfloat16")
    assert db._engine.ivf_opts["nlist"] == 1024 and db.nprobe == 32
    out = {"phase": "ivf_path", "dim": D, "batch": b, "k": k, "load_s": load_s}
    main = ivf_common_checks(db, corpus, queries, k, "bfloat16")
    want_v, want_i = oracle_topk(corpus, queries, k)

    # a broad filter (10 of 16 buckets pass) rides the probe: overfetch +
    # device mask + the count guarantee
    flt = {"bucket": {"$lte": 9}}
    before = db.stats()["ops"]["ivf_scan"]["count"]
    filt, filt_ms = timed_batches(db, queries, k, reps=3, metadata_filter=flt)
    assert db.stats()["ops"]["ivf_scan"]["count"] == before + 3
    assert all(len(r[0]) == k for r in filt)
    assert all(md["bucket"] <= 9 for _i, _s, mds in filt for md in mds)
    fv, fi = oracle_topk(corpus, queries, k, keep=buckets <= 9)
    main["filtered_batch_ms_median"] = filt_ms
    main["recall_at_10_filtered"] = recall_at_k(filt, fi)
    filt_all = db.find_most_similar_batch(
        queries[:32], k=k, metadata_filter=flt, nprobe=main["L"])
    check_hits_tied(filt_all, fv[:32], fi[:32], "filtered, nprobe = nlist")

    sync = db.find_most_similar_batch(queries, k=k)
    handles = [db.find_most_similar_batch_async(queries[j * 64:(j + 1) * 64], k=k)
               for j in range(4)]
    for j, h in enumerate(handles):
        got = h.result()
        assert [r[0] for r in got] == [r[0] for r in sync[j * 64:(j + 1) * 64]], j

    # 1,000 deletes (every query's best hit among them), then 2,000 appended
    # rows: the first 256 are the queries themselves
    doomed = np.unique(want_i[:, 0])
    doomed = np.concatenate(
        [doomed, np.setdiff1d(np.arange(5000), doomed)[: 1000 - doomed.size]])
    assert doomed.size == 1000
    for uid in doomed.tolist():
        db.delete_embedding(uid)
    extra, _ = mixture(2000, 1, SEED + 11)
    extra[:b] = queries
    db.store_embeddings_batch(list(range(n, n + 2000)), extra,
                              [{"bucket": i % 16} for i in range(2000)])
    after = db.find_most_similar_batch(queries, k=k)
    st = db.stats()["ivf"]
    assert st["overflow_rows"] == 2000 and st["dead_slots"] == 1000, st
    assert db.stats()["ops"]["ivf_build"]["count"] == 1
    gone = set(doomed.tolist())
    assert not any(i in gone for ids, _s, _m in after for i in ids)
    assert [r[0][0] for r in after] == list(range(n, n + b)), "overflow rows not found"
    full = np.concatenate([corpus, extra])
    keep = np.ones(n + 2000, dtype=bool)
    keep[doomed] = False
    dv, di = oracle_topk(full, queries, k, keep=keep)
    after_all = db.find_most_similar_batch(queries[:32], k=k, nprobe=main["L"])
    check_hits_tied(after_all, dv[:32], di[:32], "after deletes + appends, nprobe = nlist")
    main["recall_at_10_after_deletes_and_appends"] = recall_at_k(after, di)
    handle = db.find_most_similar_batch_async(queries, k=k)  # device-side merge
    assert [r[0] for r in handle.result()] == [r[0] for r in after]

    t0 = time.perf_counter()
    cal = db.calibrate_nprobe(0.95)
    main["calibrate_nprobe_s"] = time.perf_counter() - t0
    main["calibrate_nprobe"] = cal
    assert cal["recall"] >= 0.95 or cal["nprobe"] == main["L"]
    assert db.nprobe == cal["nprobe"] and db.stats()["ivf"]["nprobe_calibrated"]

    want = db.find_most_similar_batch(queries, k=k)
    t0 = time.perf_counter()
    db.persist_to_disk()
    again = VectorDatabase(storage_file=db.storage_file, index="ivf")
    assert again.stats()["ivf"]["pending_attach"]
    got = again.find_most_similar_batch(queries, k=k)
    main["persist_reload_first_search_s"] = time.perf_counter() - t0
    assert [r[0] for r in got] == [r[0] for r in want], "reload ids"
    ops = again.stats()["ops"]
    assert "ivf_build" not in ops and ops["ivf_attach"]["count"] == 1
    assert again.nprobe == cal["nprobe"] and len(again.id_map) == n + 1000
    del again
    main["launches"] = read_path_launches(path_launches, "bfloat16")
    main["route_vs_plain_probe"] = route_against_plain_probe(db, queries, "bfloat16")
    main["checked"] += ["kernel route equals _ivf_search (batch 32, batch 8)",
                        "broad filter", "async x4", "1000 deletes + 2000 appends",
                        "async with overflow", "calibrate_nprobe", "save -> load -> search"]
    out["bfloat16_1m"] = main

    # operands for the kernels phase, at the shapes this path produced
    snap = db._engine._ivf.snapshot()
    lists, _ids, list_valid = snap.tables
    qdev = torch.from_numpy(queries).to(DEV)
    nlist_eff = int(snap.centroids.shape[0])
    nprobe = min(-(-32 * nlist_eff // max(1, nlist_eff - snap.n_dup)), nlist_eff)
    qn, probe = ivf_probe.probe_lists(snap.centroids, qdev, nprobe)
    shapes = {"lists": lists, "valid": list_valid, "qn": qn, "probe": probe}
    del db

    m, corpus_m, queries_m = 262_144, corpus[:262_144], queries
    for lists_dtype in ("float32", "int8"):
        ivf_probe.reset_launches()
        dbm, load_s = ivf_database(tmp, "ivf_" + lists_dtype, corpus_m, lists_dtype)
        entry = ivf_common_checks(dbm, corpus_m, queries_m, k, lists_dtype)
        entry["launches"] = read_path_launches(path_launches, lists_dtype)
        entry["route_vs_plain_probe"] = route_against_plain_probe(
            dbm, queries_m, lists_dtype)
        entry["checked"].append("kernel route equals _ivf_search (batch 32, batch 8)")
        entry["load_s"] = load_s
        out[f"{lists_dtype}_{m}"] = entry
        del dbm
        torch.cuda.empty_cache()
    emit(out)
    return shapes, path_launches


def compare_ivf(name, kind, got, want) -> tuple:
    """Whole output of an IVF kernel against its plain version: sentinels in
    the same places, the rest within TOL[kind]. Returns (max error, live mask,
    number of sentinels)."""
    assert got.shape == want.shape and got.dtype == torch.float32, name
    dead = want == MASKED
    assert torch.equal(got == MASKED, dead), (name, "sentinel values differ")
    assert torch.isfinite(got).all(), name
    alive = ~dead
    err = float((got[alive] - want[alive]).abs().max())
    assert err <= TOL[kind], (name, err)
    return err, alive, int(dead.sum())


def ivf_ragged_errors() -> dict:
    """The five IVF entry points on small ragged shapes, each against its
    plain version: L = 7 lists of P = 130 slots (not a multiple of the slot
    tiles), rows that are not a whole number of 16-byte pieces (d = 6, or 12
    for int8: the 4-byte-load instantiations) and d = 100 (a ragged last
    chunk), groups of G = 8 (half an A tile) with padding steps, a third of
    the slots invalid. Returns the larger error of the two widths per kernel."""
    l, p, b, nprobe = 7, 130, 5, 3
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 20)
    valid = torch.rand((l, p), device=DEV, generator=gen) < 0.67
    probe = torch.stack([torch.randperm(l, device=DEV, generator=gen)[:nprobe]
                         for _ in range(b)])
    step_list, step_q, _ps, _pl = ivf_probe.group_pairs(probe, l, 8)
    assert step_q.shape[1] == 8 and bool((step_list < 0).any())
    assert bool((step_list >= 0).any())
    probe32 = probe.to(torch.int32).contiguous()
    widths = {"f32": (6, 100), "bf16": (6, 100), "i8": (12, 100)}
    errs = {}
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for d in widths[kind]:
            rows = torch.randn((l * p, d), device=DEV, generator=gen)
            lists = scan_ops._normalize(rows).reshape(l, p, d).to(dtype)
            qd = scan_ops._normalize(
                torch.randn((b, d), device=DEV, generator=gen)).to(dtype)
            pairs = (
                (f"K3-{kind}", ivf_probe.probe_scores(lists, qd, probe32),
                 ivf_probe.probe_scores_plain(lists, qd, probe32)),
                (f"K4-{kind}", ivf_probe.grouped_scores(lists, qd[step_q], step_list, valid),
                 ivf_probe.grouped_scores_plain(lists, qd[step_q], step_list, valid)),
            )
            for name, got, want in pairs:
                err, _, _ = compare_ivf(f"ragged {name} d={d}", kind, got, want)
                errs[name] = max(errs.get(name, 0.0), err)
    for d in widths["i8"]:
        rows = scan_ops._normalize(torch.randn((l * p, d), device=DEV, generator=gen))
        lists = torch.clamp(torch.round(rows * 127.0), -127, 127).to(torch.int8)
        list_inv = (ivf_ops._slot_inv_norms(lists).reshape(l, p) * valid).contiguous()
        lists = lists.reshape(l, p, d)
        qi, qinv = ivf_probe.quantize_queries_ivf(
            scan_ops._normalize(torch.randn((b, d), device=DEV, generator=gen)))
        args = (lists, qi.to(torch.int8)[step_q], step_list, valid, list_inv, qinv[step_q])
        err, _, _ = compare_ivf(f"ragged K5-int8 d={d}", "i8",
                                ivf_probe.grouped_scores_q(*args),
                                ivf_probe.grouped_scores_q_plain(*args))
        errs["K5-int8"] = max(errs.get("K5-int8", 0.0), err)
    return errs


def ivf_kernel_rows(shapes: dict, launches: dict) -> list:
    """K3, K4, K5 at the shapes of the 1,000,000-row IVF path: its bf16 lists
    (and their float32 and int8 renderings), its validity table, the step
    table its 256 queries produce and the probe ids of its first 8."""
    ragged = ivf_ragged_errors()  # small shapes first: a fault shows early
    lists_bf = shapes["lists"]
    valid, qn, probe = shapes["valid"], shapes["qn"], shapes["probe"]
    l, p, d = lists_bf.shape
    b, nprobe = probe.shape
    step_list, step_q, _ps, _pl = ivf_probe.group_pairs(probe, l, 16)
    live = int((step_list >= 0).sum())
    touched = int(torch.unique(probe).numel())
    s_all, g = int(step_q.shape[0]), int(step_q.shape[1])
    lists_f = lists_bf.to(torch.float32)
    lists_i8 = torch.clamp(torch.round(lists_f * 127.0), -127, 127).to(torch.int8)
    list_inv = ivf_ops._slot_inv_norms(lists_i8.reshape(l * p, d)).reshape(l, p)
    qi, qinv = ivf_probe.quantize_queries_ivf(qn)
    probe8 = probe[:8].to(torch.int32).contiguous()
    lst = step_list.long().clamp(min=0)
    dead_step = (step_list < 0)[:, None, None]

    def k3_library(lists, q):
        blocks = lists[probe8.reshape(-1).long()]  # (8 * nprobe, P, d)
        qq = q[:8].repeat_interleave(nprobe, dim=0)[:, :, None]
        return torch.bmm(blocks, qq).reshape(8, nprobe * p).to(torch.float32)

    def k4_library(lists, gq):
        sc = torch.bmm(gq, lists[lst].transpose(1, 2)).to(torch.float32)
        return sc.masked_fill(~valid[lst][:, None, :] | dead_step, MASKED)

    def k5_library(gq, gqinv):
        # through float32: PyTorch has no batched int8 product
        sc = torch.bmm(gq.to(torch.float32), lists_i8[lst].to(torch.float32).transpose(1, 2))
        sc = sc * list_inv[lst][:, None, :] * gqinv[:, :, None]
        return sc.masked_fill(~valid[lst][:, None, :] | dead_step, MASKED)

    cases = []
    for kind, lists in (("f32", lists_f), ("bf16", lists_bf)):
        qd = qn.to(lists.dtype).contiguous()
        gq = qd[step_q]
        cases.append((
            f"K3-{kind}", kind, "minivectordb_tpu/ops/pallas_ivf.py:72", f"ivf_probe_{kind}",
            lambda lists=lists, qd=qd: ivf_probe.probe_scores(lists, qd[:8].contiguous(), probe8),
            lambda lists=lists, qd=qd: ivf_probe.probe_scores_plain(lists, qd[:8].contiguous(), probe8),
            lambda lists=lists, qd=qd: k3_library(lists, qd),
            8 * nprobe * p * d * lists.element_size() + 8 * d * lists.element_size()
            + 8 * nprobe * 4 + 8 * nprobe * p * 4,
            2 * 8 * nprobe * p * d,
            {"L": l, "P": p, "d": d, "B": 8, "nprobe": nprobe},
        ))
        cases.append((
            f"K4-{kind}", kind, "minivectordb_tpu/ops/pallas_ivf.py:249", f"ivf_grouped_{kind}",
            lambda lists=lists, gq=gq: ivf_probe.grouped_scores(lists, gq, step_list, valid),
            lambda lists=lists, gq=gq: ivf_probe.grouped_scores_plain(lists, gq, step_list, valid),
            lambda lists=lists, gq=gq: k4_library(lists, gq),
            touched * p * (d * lists.element_size() + 1)
            + live * g * (d * lists.element_size() + p * 4) + s_all * 4,
            2 * live * g * p * d,
            {"L": l, "P": p, "d": d, "B": b, "nprobe": nprobe, "S": s_all, "G": g,
             "live_steps": live, "touched_lists": touched},
        ))
    gq8, gqinv = qi.to(torch.int8)[step_q], qinv[step_q]
    cases.append((
        "K5-int8", "i8", "minivectordb_tpu/ops/pallas_ivf.py:208", "ivf_grouped_i8",
        lambda: ivf_probe.grouped_scores_q(lists_i8, gq8, step_list, valid, list_inv, gqinv),
        lambda: ivf_probe.grouped_scores_q_plain(lists_i8, gq8, step_list, valid, list_inv, gqinv),
        lambda: k5_library(gq8, gqinv),
        touched * p * (d + 1 + 4) + live * g * (d + 4 + p * 4) + s_all * 4,
        2 * live * g * p * d,
        {"L": l, "P": p, "d": d, "B": b, "nprobe": nprobe, "S": s_all, "G": g,
         "live_steps": live, "touched_lists": touched},
    ))

    rows = []
    for name, kind, replaces, entry, run, plain, library, n_bytes, n_ops, shape in cases:
        got = run()
        torch.cuda.synchronize()
        want = plain()
        err, alive, n_dead = compare_ivf(name, kind, got, want)
        lib = library()
        lib_err = float((lib[alive] - want[alive]).abs().max())
        del lib, want
        # plain, kernel, kernel, plain: both versions inside one run
        plain_a = event_ms(plain, 3, warmup=1)
        ms_a = event_ms(run, 20)
        ms_b = event_ms(run, 20)
        plain_b = event_ms(plain, 3, warmup=1)
        lib_ms = event_ms(library, 5, warmup=1)
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n_ops / PEAK_OPS_S[kind] * 1e3
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "minivectordb_tpu_torch/csrc/ivf_probe.cu",
            "replaces": replaces,
            "launches": launches[entry],
            "max_abs_err": err,
            "tolerance": TOL[kind],
            "ms": statistics.median([ms_a, ms_b]),
            "plain_ms": statistics.median([plain_a, plain_b]),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "library": ("gather + torch.bmm" if name.startswith("K3")
                        else "torch.bmm over lists[step_list]"
                        + (" through float32" if kind == "i8" else "")),
            "library_max_abs_err_vs_plain": lib_err,
            "bound_bytes": n_bytes,
            "bound_operations": n_ops,
            "masked_values": n_dead,
            "shape": shape,
            "ragged_max_abs_err": ragged[name],
        })
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# K6: flash attention against its plain version
# ---------------------------------------------------------------------------


def attention_case(b, nh, s, hd, dtype, ids, seed):
    """q, k, v as the encoder hands them over: (B, nh, S, hd) views of
    (B, S, nh*hd) projections. ``ids`` is a list of lengths (segment id 1 for
    the first lengths[i] tokens of row i, 0 for the pads) or a (B, S) array
    of segment ids."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    q, k, v = (
        torch.randn((b, s, nh * hd), device=DEV, generator=gen).to(dtype)
        .view(b, s, nh, hd).transpose(1, 2)
        for _ in range(3)
    )
    if isinstance(ids, np.ndarray):
        seg = torch.as_tensor(ids, dtype=torch.int32, device=DEV)
    else:
        lens = torch.as_tensor(ids, device=DEV)
        seg = (torch.arange(s, device=DEV)[None, :] < lens[:, None]).to(torch.int32)
    return q, k, v, seg.contiguous()


def segment_patterns(b, s, seed):
    """Ids other than "real tokens, then pads": "packed" holds three sequences
    back to back and pads after them (ids 1, 2, 3, then 0; other cut points
    in every row); "cyclic" the non-monotone (i // 37) % 3."""
    rng = np.random.default_rng(seed)
    i = np.arange(s)
    packed = np.zeros((b, s), np.int32)
    for row in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
        packed[row] = np.searchsorted(cuts, i, side="right") + 1
        packed[row][i >= cuts[2]] = 0
    cyclic = np.broadcast_to(((i // 37) % 3).astype(np.int32), (b, s)).copy()
    return {"packed": packed, "cyclic": cyclic}


def compare_attention(kind, case, what) -> tuple:
    """(max |kernel - plain| over every position, pads included; the largest
    share of its row's limit that an error reached, None for float32)."""
    q, k, v, seg = case
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    got = flash_ops.flash_attention(q, k, v, seg, scale)
    torch.cuda.synchronize()
    want = flash_ops.flash_attention_plain(q, k, v, seg, scale)
    assert got.shape == want.shape and got.dtype == q.dtype, what
    assert got.stride() == q.stride(), (what, "the output must have q's strides")
    assert torch.isfinite(got.to(torch.float32)).all(), what
    diff = (got.to(torch.float32) - want.to(torch.float32)).abs()
    err = float(diff.max())
    assert err <= TOL_K6[kind], (what, err)
    if kind != "bf16":
        return err, None
    limit = (TOL_K6_ROW_REL * want.to(torch.float32).abs().amax(dim=-1, keepdim=True)
             + TOL_K6_ROW_ABS)
    share = float((diff / limit).max())
    assert share <= 1.0, (what, "a row's error is above its limit", share)
    return err, share


def seeded_lengths(b, s, lo, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, s + 1, size=b)
    lens[0] = s  # one row without pads
    return lens.tolist()


def encoder_kernel_rows(launches: dict) -> list:
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    # small and ragged shapes first: a fault shows early
    small = {}
    for kind, dtype in dtypes.items():
        errs, shares = {}, []

        def held(name, case, what):
            errs[name], share = compare_attention(kind, case, what)
            shares.append(share)

        # every head width the kernel is built for (64 is the path's shape)
        for hd in (16, 32, 48, 80, 96, 112, 128):
            case = attention_case(4, 8, 256, hd, dtype, [256, 200, 64, 1], SEED + 30 + hd)
            held(f"S256_hd{hd}", case, f"K6-{kind} S=256 hd={hd}")
        # S = 200: a ragged last tile; 70 real tokens leave the key tile
        # 128..191 with pads only for real queries, and the tiles 0..63 with
        # nothing a pad query may see; rows with one real token and with none
        # padded
        case = attention_case(4, 4, 200, 64, dtype, [70, 1, 200, 130], SEED + 40)
        held("S200", case, f"K6-{kind} S=200")
        case = attention_case(3, 2, 1, 64, dtype, [1, 1, 0], SEED + 41)
        held("S1", case, f"K6-{kind} S=1")
        # sequences that are not whole tiles of 64 keys or 128 queries
        for s_odd in (129, 384):
            case = attention_case(4, 4, s_odd, 64, dtype, seeded_lengths(4, s_odd, 1, SEED + 44),
                                  SEED + 44 + s_odd)
            held(f"S{s_odd}", case, f"K6-{kind} S={s_odd}")
        # segment ids that are not "ones, then zeros": tiles with several ids
        # and id ranges that meet without one pair of equal ids
        for name, ids in segment_patterns(4, 512, SEED + 45).items():
            case = attention_case(4, 4, 512, 64, dtype, ids, SEED + 46)
            held(name, case, f"K6-{kind} {name} ids")
        small[kind] = (errs, None if kind == "f32" else max(shares))

    b, nh, s, hd = 32, 16, 512, 64
    lengths = seeded_lengths(b, s, 200, SEED + 42)
    scale = 1.0 / float(np.sqrt(hd))
    pairs = sum(n * n + (s - n) * (s - n) for n in lengths)
    rows = []
    for kind, dtype in dtypes.items():
        case = attention_case(b, nh, s, hd, dtype, lengths, SEED + 43)
        q, k, v, seg = case
        err, share = compare_attention(kind, case, f"K6-{kind}")
        same = (seg[:, None, :, None] == seg[:, None, None, :])  # (B, 1, S, S)

        def run():
            return flash_ops.flash_attention(q, k, v, seg, scale)

        def plain():
            return flash_ops.flash_attention_plain(q, k, v, seg, scale)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=scale)

        want = plain().to(torch.float32)
        lib_err = float((library().to(torch.float32) - want).abs().max())
        del want
        # plain, kernel, kernel, plain: both versions inside one run
        plain_a = event_ms(plain, 3, warmup=1)
        ms_a = event_ms(run, 20)
        ms_b = event_ms(run, 20)
        plain_b = event_ms(plain, 3, warmup=1)
        lib_ms = event_ms(library, 10)
        item = q.element_size()
        n_bytes = 4 * b * nh * s * hd * item + b * s * 4
        n_ops = 4 * nh * hd * pairs
        # what the kernel multiplies: whole (query rows x keys) tiles whose
        # segment ids meet (ops/flash_attention.py:visited_tiles)
        tile_rows, tile_keys = flash_ops.tile_shape(dtype, hd)
        tiles = flash_ops.visited_tiles(seg, tile_rows, tile_keys)
        n_mult = 4 * nh * hd * tiles * tile_rows * tile_keys
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n_ops / PEAK_OPS_S[kind] * 1e3
        ms = statistics.median([ms_a, ms_b])
        rows.append({
            "name": f"K6-{kind}",
            "route": "cuda",
            "source": "minivectordb_tpu_torch/csrc/flash_attention.cu",
            "replaces": "minivectordb_tpu/models/encoder.py:138",
            "launches": launches[f"flash_attention_{kind}"],
            "max_abs_err": err,
            "tolerance": TOL_K6[kind],
            "row_tolerance": None if kind == "f32" else
            f"{TOL_K6_ROW_REL} * max|plain| over the row + {TOL_K6_ROW_ABS}",
            "max_err_over_row_tolerance": share,
            "ms": ms,
            "plain_ms": statistics.median([plain_a, plain_b]),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "library": "scaled_dot_product_attention, boolean (B, 1, S, S) segment mask",
            "library_max_abs_err_vs_plain": lib_err,
            "bound_bytes": n_bytes,
            "bound_operations": n_ops,
            "multiplied_operations": n_mult,
            "multiplied_tiles_per_head": tiles,
            "tile": [tile_rows, tile_keys],
            "tflops_counted": n_ops / (ms * 1e-3) / 1e12,
            "tflops_multiplied": n_mult / (ms * 1e-3) / 1e12,
            "dense_operations": 4 * b * nh * s * s * hd,
            "dense_tflops": 4 * b * nh * s * s * hd / (ms * 1e-3) / 1e12,
            "shape": {"B": b, "nh": nh, "S": s, "hd": hd, "lengths_min": min(lengths),
                      "lengths_mean": float(np.mean(lengths))},
            "small_max_abs_err": small[kind][0],
            "small_max_err_over_row_tolerance": small[kind][1],
        })
        del case, q, k, v, seg, same
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# encoder_path and pipeline_path: text -> embedding -> search
# ---------------------------------------------------------------------------


def plain_attention():
    """Inside the block the encoder's flash route calls the plain version of
    K6: the same module with the plain attention in the kernel's place."""
    return patched(flash_ops, flash_attention=flash_ops.flash_attention_plain)


def flash_counts(**nonzero) -> dict:
    """Every entry point of ops/flash_attention.py: the given counts, 0 for the
    rest."""
    return {name: nonzero.get(name, 0) for name in flash_ops.LAUNCHES}


def read_k6_launches(total: dict, want: dict, what: str) -> dict:
    """The counts since the last reset, all made through the public classes;
    they must equal ``want`` (every other entry point 0). Adds them to
    ``total``."""
    got = dict(flash_ops.LAUNCHES)
    want = flash_counts(**want)
    assert got == want, (what, got, want)
    for name, count in got.items():
        total[name] = total.get(name, 0) + count
    return got


def seeded_texts(words, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def embed_error(kind, got, want, what) -> dict:
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    cos = float(np.sum(got * want, axis=1).min())
    assert err <= TOL_EMBED[kind], (what, err)
    assert cos >= 0.999, (what, cos)
    assert np.abs(np.linalg.norm(got, axis=1) - 1.0).max() <= 1e-3, what
    return {"max_abs_err": err, "min_cosine": cos}


def timed_embeds(model, texts, reps=5):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.extract_embeddings_batch(texts)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def drive_router(one: list, eight: list, want: np.ndarray, launches_per_device_call: int):
    """A new EmbeddingModel() takes batches of 1 and of 8 in turn, eight calls
    in all, so its host/device router primes on the host, times the card and
    settles. Every result must equal ``want`` (the card's embeddings of the
    same texts in a batch of 16, which bypasses the router) within 2e-5,
    whichever route served it; K6 must have been launched by the device calls
    and by nothing else."""
    model = EmbeddingModel()
    assert model.model.routing_stats()["host_capable"]
    flash_ops.reset_launches()
    routes, errs = [], {"host": 0.0, "device": 0.0}
    for i in range(8):
        texts = eight if i % 2 else one
        before = model.model.routing_stats()["host_calls"]
        got = model.extract_embeddings(texts[0]) if len(texts) == 1 else \
            model.extract_embeddings_batch(texts)
        got = np.asarray(got, np.float32).reshape(len(texts), -1)
        route = "host" if model.model.routing_stats()["host_calls"] > before else "device"
        err = float(np.abs(got - want[:len(texts)]).max())
        assert err <= TOL_EMBED["f32"], ("router", i, route, err)
        routes.append(route)
        errs[route] = max(errs[route], err)
    stats = model.model.routing_stats()
    assert stats["host_calls"] >= 4 and stats["device_calls"] >= 2, stats
    assert stats["host_ema_s"] is not None and stats["device_ema_s"] is not None, stats
    got = dict(flash_ops.LAUNCHES)
    assert got == flash_counts(
        flash_attention_f32=stats["device_calls"] * launches_per_device_call), (got, stats)
    return {"routes": routes, "max_abs_err_vs_batch_of_16_on_the_card": errs,
            "routing": stats, "launches": got}


def phase_encoder_path(tmp: str):
    """Returns (the float32 e5-large-width model, its texts, the K6 launch
    counts of the public calls). Every count is set to 0 before a model is
    driven and read just after its last public call; the runs with the plain
    attention come after the read."""
    path_launches = {}
    out = {"phase": "encoder_path"}

    # (a) the bundled builtin artifact
    flash_ops.reset_launches()
    builtin = EmbeddingModel()
    assert builtin.weights_source == "bundled-trained" and builtin.device == DEV
    cfg = builtin.model.cfg
    words = builtin.model.tokenizer.words
    t256 = seeded_texts(words, 16, 150, 200, SEED + 50)
    t512 = seeded_texts(words, 16, 300, 400, SEED + 51)
    short = seeded_texts(words, 16, 3, 12, SEED + 52)
    e_short = builtin.extract_embeddings_batch(short)
    assert flash_ops.LAUNCHES["flash_attention_f32"] == 0, "short texts must not reach K6"
    e256 = builtin.extract_embeddings_batch(t256)
    e512 = builtin.extract_embeddings_batch(t512)
    shapes = [builtin.model._tokenize_padded(t, 512)[0].shape for t in (short, t256, t512)]
    assert shapes[1] == (16, 256) and shapes[2] == (16, 512) and shapes[0][1] < 256, shapes
    got = read_k6_launches(
        path_launches,
        {"flash_attention_f32": 2 * cfg.layers, "flash_attention_bf16": 0}, "builtin")
    with plain_attention():
        p256 = builtin.extract_embeddings_batch(t256)
        p512 = builtin.extract_embeddings_batch(t512)
    assert e_short.shape == (16, cfg.hidden)
    out["builtin"] = {
        "config": {"layers": cfg.layers, "hidden": cfg.hidden, "heads": cfg.heads},
        "token_shapes": [list(x) for x in shapes],
        "launches": got,
        "S256_vs_plain_attention": embed_error("f32", e256, p256, "builtin S=256"),
        "S512_vs_plain_attention": embed_error("f32", e512, p512, "builtin S=512"),
        "routing": builtin.model.routing_stats(),
        # batches of at most 8 go through the host/device router: long texts
        # (S = 512, every device call launches K6 once a layer) and short ones
        "router_long_texts": drive_router(t512[:1], t512[:8], e512, cfg.layers),
        "router_short_texts": drive_router(short[:1], short[:8], e_short, 0),
    }
    del builtin

    # (b) e5-large at its published widths, weights from a seeded generator,
    # through the artifact directory a converted checkpoint would live in
    cfg = model_configs.E5_LARGE
    assert (cfg.layers, cfg.hidden, cfg.heads, cfg.intermediate, cfg.vocab_size) == (
        24, 1024, 16, 4096, 250037)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 53)
    t0 = time.perf_counter()
    seeded = encoder_mod.init_params(cfg, gen, DEV)
    weights = os.path.join(tmp, "weights")
    model_convert.save_converted(
        port_convert.encoder_to_numpy(seeded), cfg, os.path.join(weights, "large"))
    write_s = time.perf_counter() - t0
    del seeded
    torch.cuda.empty_cache()
    os.environ["MINIVECTORDB_TORCH_WEIGHTS"] = weights
    vocab = [f"w{i}" for i in range(50_000)]
    texts = seeded_texts(vocab, 32, 380, 505, SEED + 54)
    texts[0] = " ".join(vocab[:600])  # one text that is cut at 512 tokens
    large = {}
    models = {}
    for kind, compute_dtype in (("f32", None), ("bf16", "bfloat16")):
        flash_ops.reset_launches()
        t0 = time.perf_counter()
        model = EmbeddingModel(use_quantized_onnx_model=False, alternative_model="large",
                               compute_dtype=compute_dtype)
        load_s = time.perf_counter() - t0
        assert model.weights_source == "pretrained" and model.model.cfg == cfg
        t0 = time.perf_counter()
        ids, mask = model.model._tokenize_padded(texts, 512)
        tokenize_ms = (time.perf_counter() - t0) * 1e3
        assert ids.shape == (32, 512) and int(mask[0].sum()) == 512, ids.shape
        first = model.extract_embeddings_batch(texts)
        entry = f"flash_attention_{kind}"
        other = "flash_attention_bf16" if kind == "f32" else "flash_attention_f32"
        assert flash_ops.LAUNCHES == flash_counts(**{entry: cfg.layers}), flash_ops.LAUNCHES
        emb, ms = timed_embeds(model, texts)
        assert np.array_equal(first, emb), "an embed call must repeat itself"
        got = read_k6_launches(path_launches, {entry: 6 * cfg.layers, other: 0}, kind)
        with plain_attention():
            want = model.extract_embeddings_batch(texts)
        large[kind] = {
            "load_s": load_s,
            "tokens_per_text_mean": float(mask.sum(axis=1).mean()),
            "embed_ms_per_batch_median": ms,
            "of_which_host_tokenize_ms": tokenize_ms,
            "texts_per_s": 32 / (ms * 1e-3),
            "launches": got,
            "launches_per_call": cfg.layers,
            "vs_plain_attention": embed_error(kind, emb, want, f"e5-large widths {kind}"),
        }
        models[kind] = (model, emb)
    # bfloat16 against float32, for the record (no assertion beyond a cosine)
    cos = float(np.sum(models["f32"][1] * models["bf16"][1], axis=1).min())
    assert cos >= 0.99, cos
    large["bf16_vs_f32_min_cosine"] = cos
    large["artifact_write_s"] = write_s
    large["config"] = {"layers": cfg.layers, "hidden": cfg.hidden, "heads": cfg.heads,
                       "intermediate": cfg.intermediate, "vocab_size": cfg.vocab_size}
    out["e5_large_widths"] = large
    emit(out)
    model = models["f32"][0]
    del models
    torch.cuda.empty_cache()
    return model, texts, path_launches


def phase_pipeline_path(tmp: str, model, texts, path_launches: dict) -> None:
    n, d, k = 262_144, 1024, 10
    stored = seeded_texts([f"w{i}" for i in range(50_000)], 256 - len(texts), 380, 505,
                          SEED + 60)
    stored = texts + stored  # the 32 query texts are rows 0..31
    layers = model.model.cfg.layers
    flash_ops.reset_launches()
    t0 = time.perf_counter()
    vecs = np.concatenate([model.extract_embeddings_batch(stored[i:i + 32])
                           for i in range(0, len(stored), 32)])
    embed_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 61)
    rest = scan_ops._normalize(torch.randn((n - len(stored), d), device=DEV, generator=gen))
    corpus = np.concatenate([vecs, rest.cpu().numpy()])
    del rest
    out = {"phase": "pipeline_path", "rows": n, "dim": d, "batch": len(texts), "k": k,
           "embed_256_texts_s": embed_s}
    flt = {"bucket": {"$lte": 9}}
    n_calls = len(stored) // 32
    for index in ("flat", "ivf"):
        db = VectorDatabase(storage_file=os.path.join(tmp, f"pipe_{index}.pkl"), index=index)
        load_s = load_db(db, corpus, pieces=2)
        pipe = TextSearchPipeline(model, db)
        t0 = time.perf_counter()
        first = pipe.search(texts, k=k)  # uploads the corpus (and builds the index)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pipe.search(texts, k=k)
            times.append((time.perf_counter() - t0) * 1e3)
        filt = pipe.search(texts, k=k, metadata_filter=flt)
        one = pipe.search(texts[3], k=k)
        n_calls += 8
        q = model.extract_embeddings_batch(texts)
        n_calls += 1
        want = db.find_most_similar_batch(q, k=k)
        want_f = db.find_most_similar_batch(q, k=k, metadata_filter=flt)
        errs = []
        for what, got_r, want_r in (("search", res, want), ("first search", first, want),
                                    ("filtered", filt, want_f), ("single", [one], want[3:4])):
            want_v = np.asarray([r[1] for r in want_r], np.float32)
            want_i = np.asarray([r[0] for r in want_r])
            # ids equal (two may swap where their scores are tied), scores 2e-5
            check_hits_tied(got_r, want_v, want_i, f"pipeline {index} {what}")
            errs += [float(np.abs(np.asarray(g[1], np.float32) - w).max())
                     for g, w in zip(got_r, want_v)]
        assert [r[0][0] for r in res] == list(range(len(texts))), "a text must find itself"
        assert all(abs(float(r[1][0]) - 1.0) <= 1e-4 for r in res)
        assert all(md["bucket"] <= 9 for _i, _s, mds in filt for md in mds)
        if index == "ivf":
            assert db.stats()["ivf"]["built"], db.stats()["ivf"]
        out[index] = {
            "load_s": load_s,
            "first_search_s": first_s,
            "search_ms_median": statistics.median(times),
            "max_abs_score_err_vs_embed_then_search": max(errs),
            "checked": ["batch of 32", "filtered", "single text", "self first"],
        }
        del db, pipe
        torch.cuda.empty_cache()
    out["launches"] = read_k6_launches(
        path_launches,
        {"flash_attention_f32": n_calls * layers, "flash_attention_bf16": 0}, "pipeline")
    emit(out)


# ---------------------------------------------------------------------------
# train_path: contrastive training of the encoder (K6 with lse, K7, K8)
# ---------------------------------------------------------------------------


def train_batches(steps: int, pairs: int, seed: int) -> list:
    """``steps`` batches of ``pairs`` (query, passage) texts of 200-505 seeded
    words through the e5-large slot's hashing tokenizer, padded to S = 512
    with ragged lengths: every encode takes the flash route."""
    cfg = model_configs.E5_LARGE
    tok = HashTokenizer(cfg.vocab_size)
    vocab = [f"w{i}" for i in range(50_000)]

    def tokenize(texts):
        enc = tok(texts, max_length=512)
        ids = np.full((len(texts), 512), cfg.pad_id, np.int32)
        mask = np.zeros((len(texts), 512), np.int32)
        for row, (e, m) in enumerate(zip(enc["input_ids"], enc["attention_mask"])):
            ids[row, :len(e)] = e
            mask[row, :len(m)] = m
        return ids, mask

    out = []
    for step in range(steps):
        q_ids, q_mask = tokenize(seeded_texts(vocab, pairs, 200, 505, seed + 2 * step))
        p_ids, p_mask = tokenize(seeded_texts(vocab, pairs, 200, 505, seed + 2 * step + 1))
        out.append({"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids, "p_mask": p_mask})
    return out


def seeded_encoder(cfg, seed: int):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return encoder_mod.init_params(cfg, gen, DEV)


@contextlib.contextmanager
def patched(module, **attrs):
    """Inside the block ``module``'s attributes are ``attrs``."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


# How step_gradients computes attention: the kernels (K6 with lse, K7, K8);
# the plain attention differentiated by autograd (the reference); the
# kernels' own formulation in plain PyTorch (FlashAttention over
# flash_attention_lse_plain / flash_attention_bwd_plain); float64 weights
# through the materialised attention (pooling and loss stay float32)
GRAD_ROUTES = {
    "kernels": contextlib.nullcontext,
    "plain": plain_attention,
    "plain_flash": lambda: patched(flash_ops, flash_attention_lse=flash_ops.flash_attention_lse_plain,
                                   flash_attention_bwd=flash_ops.flash_attention_bwd_plain),
    "float64": lambda: patched(encoder_mod, _use_flash_attention=lambda *_a: False),
}


def step_gradients(cfg, batch, seed: int, route: str):
    """Loss and every parameter's gradient of one InfoNCE step from the
    seeded weights, with attention computed by ``route`` (GRAD_ROUTES)."""
    enc = seeded_encoder(cfg, seed)
    if route == "float64":
        enc = enc.to(torch.float64)
    enc.requires_grad_(True)
    with GRAD_ROUTES[route]():
        loss, acc = train_mod.info_nce_loss(enc, cfg, train_mod.batch_to(batch, DEV))
        loss.backward()
    grads = {name: p.grad for name, p in enc.named_parameters()}
    return float(loss.detach()), float(acc), grads


def logit_path(name: str) -> bool:
    """The q and k projections: their gradient reaches them through dS alone."""
    parts = name.split(".")
    return len(parts) > 2 and parts[-2] in ("q", "k")


def compare_gradients(cfg, batch, seed: int) -> dict:
    """Step 1 through K6/K7/K8 against the plain-attention module (see the
    tolerances in the module docstring): the loss, and every parameter's
    gradient, |g - g_plain| / |g_plain| <= TOL_GRAD, except the q and k
    projections', held to |g - g_plain| <= TOL_GRAD * |g_plain of that
    layer's v weight|. Also reported, not asserted: each route's distance to
    the float64 gradient, and to the kernels' formulation in plain PyTorch."""
    runs = {}
    for route in GRAD_ROUTES:
        loss, acc, grads = step_gradients(cfg, batch, seed, route)
        runs[route] = (loss, acc, {n: g.detach().cpu() for n, g in grads.items()})
        del grads
        torch.cuda.empty_cache()
    (loss_k, acc_k, g_k), (loss_p, acc_p, g_p) = runs["kernels"], runs["plain"]
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5 * max(1.0, abs(loss_p)), (
        loss_k, loss_p)
    assert acc_k == acc_p, (acc_k, acc_p)
    g_f, g_w = runs["plain_flash"][2], runs["float64"][2]

    def dist(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    rows = {}
    for name, want in g_p.items():
        got, want = g_k[name].double(), want.double()
        assert torch.isfinite(got).all(), name
        err = float((got - want).norm())
        if logit_path(name):
            scale = float(g_p[name.rsplit(".", 2)[0] + ".v.weight"].double().norm())
            assert err <= TOL_GRAD * scale, (name, err, scale)
        else:
            assert err <= TOL_GRAD * float(want.norm()), (name, err / float(want.norm()))
        rows[name] = {"vs_plain": err / float(want.norm()),
                      "vs_plain_over_v_weight": err / scale if logit_path(name) else None,
                      "norm": float(want.norm()),
                      "kernels_vs_float64": dist(got, g_w[name]),
                      "plain_vs_float64": dist(want, g_w[name]),
                      "plain_flash_vs_float64": dist(g_f[name], g_w[name]),
                      "kernels_vs_plain_flash": dist(got, g_f[name])}
    strict = {n: r["vs_plain"] for n, r in rows.items() if not logit_path(n)}
    logit = {n: r["vs_plain_over_v_weight"] for n, r in rows.items() if logit_path(n)}
    worst = sorted(rows, key=lambda n: -rows[n]["vs_plain"])[:6]
    worst_qk = sorted((n for n in rows if logit_path(n) and not n.endswith("k.bias")),
                      key=lambda n: -rows[n]["vs_plain"])[:4]
    return {"losses": {route: run[0] for route, run in runs.items()}, "accuracy": acc_k,
            "tolerance": TOL_GRAD, "params_compared": len(rows),
            "max_rel_grad_err": max(strict.values()),
            "max_rel_grad_err_param": max(strict, key=strict.get),
            "median_rel_grad_err": statistics.median(strict.values()),
            "q_k_max_err_over_v_weight_grad": max(logit.values()),
            "q_k_max_err_param": max(logit, key=logit.get),
            "largest_vs_plain": {n: rows[n] for n in worst},
            "largest_vs_plain_q_k_but_k_bias": {n: rows[n] for n in worst_qk},
            "median_kernels_vs_float64": statistics.median(
                r["kernels_vs_float64"] for r in rows.values()),
            "median_plain_vs_float64": statistics.median(
                r["plain_vs_float64"] for r in rows.values())}


def params_max_diff(a, b) -> float:
    with torch.no_grad():
        return max(float((x - y).abs().max()) for x, y in zip(a.parameters(), b.parameters()))


def drive_e5_large_training(tmp: str, batches: list, seed: int) -> dict:
    """The e5-large widths through train_loop: 2 steps (the loop's checkpoint
    at step 2), step 3, then the checkpoint loaded and step 3 again from it.
    Host-clock times of each step (the loss is read every step)."""
    cfg = model_configs.E5_LARGE
    ck = os.path.join(tmp, "train_ck.pkl")
    marks = []

    def log(_line):
        marks.append(time.perf_counter())

    enc = seeded_encoder(cfg, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, hist = train_mod.train_loop(
        cfg, enc, iter(batches[:2]), steps=2, learning_rate=1e-4, checkpoint_path=ck,
        log_every=1, log_fn=log, device=DEV)
    t_end = time.perf_counter()
    # from the call (or the last loss read) to each step's loss read: the
    # first and third include train_loop's set-up, the second is one step
    step_s = [marks[0] - t0, marks[1] - marks[0]]
    save_s = t_end - marks[1]
    marks.clear()
    t0 = time.perf_counter()
    params, _opt, hist3 = train_mod.train_loop(
        cfg, params, iter(batches[2:3]), steps=1, start_step=2, opt_state=opt,
        learning_rate=1e-4, log_every=1, log_fn=log, device=DEV)
    step_s.append(marks[0] - t0)
    hist += hist3
    del opt, _opt
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ck_params, ck_opt, ck_step, _extra = load_checkpoint(ck)
    load_s = time.perf_counter() - t0
    assert ck_step == 2, ck_step
    t0 = time.perf_counter()
    resumed, _ropt, hist_r = train_mod.train_loop(
        cfg, ck_params, iter(batches[2:3]), steps=1, start_step=2, opt_state=ck_opt,
        learning_rate=1e-4, log_every=1, log_fn=lambda _l: None, device=DEV)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    del ck_params, ck_opt, _ropt
    loss3, loss3_r = hist3[0]["loss"], hist_r[0]["loss"]
    assert all(np.isfinite(h["loss"]) for h in hist), hist
    assert abs(loss3 - loss3_r) <= 1e-5 * max(1.0, abs(loss3)), (loss3, loss3_r)
    resume_diff = params_max_diff(params, resumed)
    assert resume_diff <= 1e-5, resume_diff
    del params, resumed
    torch.cuda.empty_cache()
    return {
        "history": hist,
        "step_s": step_s,
        "ms_per_step": step_s[1] * 1e3,
        "real_tokens_per_s": int(batches[1]["q_mask"].sum() + batches[1]["p_mask"].sum())
        / step_s[1],
        "checkpoint_save_s": save_s,
        "checkpoint_bytes": os.path.getsize(ck),
        "checkpoint_load_s": load_s,
        "resume_step_s": resume_s,
        "resumed_step_3_loss": loss3_r,
        "resumed_vs_uninterrupted_max_param_diff": resume_diff,
        "disk_free_bytes_after": shutil.disk_usage(tmp).free,
    }


def drive_train_builtin(tmp: str) -> dict:
    """models/train_builtin.py's main on the card: TRAINED_BUILTIN's 8 heads
    of 64 at S = 256 train through K6/K7/K8 (20 steps x 2 layers x 2
    encodes). The artifact it writes must load through EmbeddingModel."""
    res_dir = os.path.join(tmp, "resources")
    out_dir = os.path.join(res_dir, "builtin")
    argv = ["--steps", "20", "--batch", "64", "--seq", "256", "--force", "--out", out_dir]
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = train_builtin.main(argv)
    main_s = time.perf_counter() - t0
    assert rc == 0, printed.getvalue()[-2000:]
    with open(os.path.join(out_dir, "probes.json")) as f:
        probes = json.load(f)
    return {"argv": argv, "main_s": main_s, "probes": probes,
            "log_tail": printed.getvalue().splitlines()[-3:]}


def load_trained_artifact(tmp: str) -> dict:
    """EmbeddingModel() reads the artifact train_builtin wrote (its directory
    as MINIVECTORDB_TORCH_RESOURCES): unit embeddings equal to the artifact's
    own encoder's."""
    res_dir = os.path.join(tmp, "resources")
    os.environ["MINIVECTORDB_TORCH_RESOURCES"] = res_dir
    try:
        model = EmbeddingModel()
    finally:
        del os.environ["MINIVECTORDB_TORCH_RESOURCES"]
    assert model.weights_source == "bundled-trained", model.weights_source
    texts = ["i like dogs", "the stock market fell sharply", "technology is the future"] * 4
    got = model.extract_embeddings_batch(texts)
    params, cfg = model_convert.load_converted(os.path.join(res_dir, "builtin"))
    enc = port_convert.encoder_from_numpy(params, cfg, DEV)
    tok = model.model.tokenizer
    want = train_builtin._embed(enc, tok, texts, seq=16)
    err = embed_error("f32", got, want, "train_builtin artifact")
    return {"weights_source": model.weights_source, "embed_vs_artifact": err}


def phase_train_path(tmp: str) -> dict:
    """Returns the kernel launches of the training paths. Every count is set
    to 0 before each path is driven and read just after; the gradient
    comparison with the plain attention comes after the reads."""
    cfg = model_configs.E5_LARGE
    seed = SEED + 70
    batches = train_batches(3, 8, SEED + 71)
    layers = cfg.layers
    out = {"phase": "train_path", "config": {
        "layers": layers, "hidden": cfg.hidden, "heads": cfg.heads,
        "intermediate": cfg.intermediate, "vocab_size": cfg.vocab_size},
        "batch_pairs": 8, "seq": 512,
        "real_tokens_per_step": [int(b["q_mask"].sum() + b["p_mask"].sum()) for b in batches],
        "lengths_min": int(min(b[m].sum(axis=1).min() for b in batches
                               for m in ("q_mask", "p_mask")))}
    total = {}
    flash_ops.reset_launches()
    out["e5_large"] = drive_e5_large_training(tmp, batches, seed)
    per_step = 2 * layers  # two encodes a step, one K6 / K7 / K8 launch a layer each
    out["e5_large"]["launches"] = read_k6_launches(
        total, {name: 4 * per_step for name in TRAIN_ENTRY_POINTS}, "e5-large training")
    out["e5_large"]["launches_per_step"] = per_step
    out["e5_large"]["steps_run"] = 4

    flash_ops.reset_launches()
    out["train_builtin"] = drive_train_builtin(tmp)
    per_step_b = 2 * model_configs.TRAINED_BUILTIN.layers
    out["train_builtin"]["launches"] = read_k6_launches(
        total, {name: 20 * per_step_b for name in TRAIN_ENTRY_POINTS}, "train_builtin")
    out["train_builtin"]["artifact"] = load_trained_artifact(tmp)

    t0 = time.perf_counter()
    out["step1_vs_plain_attention"] = compare_gradients(cfg, batches[0], seed)
    out["step1_vs_plain_attention"]["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    emit(out)
    return {"e5_large": out["e5_large"]["launches"],
            "train_builtin": out["train_builtin"]["launches"], "total": total}


# ---------------------------------------------------------------------------
# K6 with lse, K7, K8: against their plain versions
# ---------------------------------------------------------------------------


def compare_backward(case, what) -> dict:
    """K6 with lse, K7 and K8 on one case against the plain versions, over
    every output position, pads included. Returns the largest errors."""
    q, k, v, seg = case
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(q.shape[2] * 131 + q.shape[3])
    dout = torch.randn(q.shape, device=DEV, generator=gen)
    out, lse = flash_ops.flash_attention_lse(q, k, v, seg, scale)
    torch.cuda.synchronize()
    pout, plse = flash_ops.flash_attention_lse_plain(q, k, v, seg, scale)
    ops = flash_ops._bwd_operands(q, k, v, seg, out, dout, lse)
    dk, dv = flash_ops._bwd_dkv(*ops, scale)
    dq = flash_ops._bwd_dq(*ops, scale)
    torch.cuda.synchronize()
    pdq, pdk, pdv = flash_ops.flash_attention_bwd_plain(q, k, v, seg, pout, dout, plse, scale)
    errs = {"K6-f32-lse": max(float((out - pout).abs().max()), float((lse - plse).abs().max())),
            "K7-f32": max(float((dk - pdk).abs().max()), float((dv - pdv).abs().max())),
            "K8-f32": float((dq - pdq).abs().max())}
    for t in (lse, dq, dk, dv):
        assert torch.isfinite(t).all(), what
    assert dq.stride() == dk.stride() == dv.stride() == q.stride(), what
    assert errs["K6-f32-lse"] <= TOL_LSE, (what, errs)
    assert errs["K7-f32"] <= TOL_BWD and errs["K8-f32"] <= TOL_BWD, (what, errs)
    # the bf16 forward writes its row statistic from the same epilogue
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    _ob, lse_b = flash_ops.flash_attention_lse(qb, kb, vb, seg, scale)
    torch.cuda.synchronize()
    _pb, plse_b = flash_ops.flash_attention_lse_plain(qb, kb, vb, seg, scale)
    errs["K6-bf16-lse_lse_only"] = float((lse_b - plse_b).abs().max())
    assert errs["K6-bf16-lse_lse_only"] <= TOL_LSE, (what, errs)
    return errs


def train_kernel_rows(launches: dict) -> list:
    """K6-f32 with lse, K7 and K8 at the training step's shape (B = 16, nh =
    16, S = 512, hd = 64, ragged lengths; the encoder's (B, S, nh, hd) memory),
    after S = 256 at every head width, S = 200 / 129 / 1 and the packed and
    cyclic ids. ``launches`` are the e5-large training path's."""
    small = {}

    def held(case, what):
        for name, err in compare_backward(case, what).items():
            small[name] = max(small.get(name, 0.0), err)

    for hd in (16, 32, 48, 64, 80, 96, 112, 128):
        held(attention_case(4, 4, 256, hd, torch.float32, [256, 200, 64, 1], SEED + 80 + hd),
             f"bwd S=256 hd={hd}")
    held(attention_case(4, 4, 200, 64, torch.float32, [70, 1, 200, 130], SEED + 81), "bwd S=200")
    held(attention_case(4, 4, 129, 64, torch.float32, seeded_lengths(4, 129, 1, SEED + 82),
                        SEED + 83), "bwd S=129")
    held(attention_case(3, 2, 1, 64, torch.float32, [1, 1, 0], SEED + 84), "bwd S=1")
    for name, ids in segment_patterns(4, 512, SEED + 85).items():
        held(attention_case(4, 4, 512, 64, torch.float32, ids, SEED + 86), f"bwd {name} ids")

    b, nh, s, hd = 16, 16, 512, 64
    lengths = seeded_lengths(b, s, 200, SEED + 87)
    case = attention_case(b, nh, s, hd, torch.float32, lengths, SEED + 88)
    q, k, v, seg = case
    errs = compare_backward(case, "training shape")
    scale = 1.0 / float(np.sqrt(hd))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 89)
    dout = torch.randn(q.shape, device=DEV, generator=gen)
    out, lse = flash_ops.flash_attention_lse(q, k, v, seg, scale)
    ops = flash_ops._bwd_operands(q, k, v, seg, out, dout, lse)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=same, scale=scale)

    def sdpa_backward():
        return torch.autograd.grad(lib_out, (ql, kl, vl), dout, retain_graph=True)

    lib_err = max(float((a - w).abs().max()) for a, w in zip(
        sdpa_backward(), flash_ops.flash_attention_bwd_plain(q, k, v, seg, out, dout, lse, scale)))
    pairs = sum(n * n + (s - n) * (s - n) for n in lengths)
    tensor = b * nh * s * hd * 4
    stats = b * nh * s * 4
    kinds = {
        "K6-f32-lse": (lambda: flash_ops.flash_attention_lse(q, k, v, seg, scale),
                       lambda: flash_ops.flash_attention_lse_plain(q, k, v, seg, scale),
                       lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=scale),
                       4 * tensor + stats + b * s * 4, 4 * nh * hd * pairs,
                       "minivectordb_tpu/models/encoder.py:138",
                       "minivectordb_tpu_torch/csrc/flash_attention.cu",
                       "flash_attention_lse_f32",
                       "scaled_dot_product_attention forward, boolean (B, 1, S, S) segment mask"),
        "K7-f32": (lambda: flash_ops._bwd_dkv(*ops, scale),
                   lambda: flash_ops.flash_attention_bwd_plain(q, k, v, seg, out, dout, lse, scale),
                   sdpa_backward, 6 * tensor + 2 * stats + b * s * 4, 8 * nh * hd * pairs,
                   "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                   "(_flash_attention_bwd_dkv, from models/train.py:105 via encoder.py:138)",
                   "minivectordb_tpu_torch/csrc/flash_attention_bwd.cu",
                   "flash_attention_bwd_dkv_f32",
                   "autograd backward of scaled_dot_product_attention (dq, dk, dv in one call)"),
        "K8-f32": (lambda: flash_ops._bwd_dq(*ops, scale),
                   lambda: flash_ops.flash_attention_bwd_plain(q, k, v, seg, out, dout, lse, scale),
                   sdpa_backward, 5 * tensor + 2 * stats + b * s * 4, 6 * nh * hd * pairs,
                   "jax/experimental/pallas/ops/tpu/flash_attention.py:1456 "
                   "(_flash_attention_bwd_dq, from models/train.py:105 via encoder.py:138)",
                   "minivectordb_tpu_torch/csrc/flash_attention_bwd.cu",
                   "flash_attention_bwd_dq_f32",
                   "autograd backward of scaled_dot_product_attention (dq, dk, dv in one call)"),
    }
    rows = []
    for name, (run, plain, library, n_bytes, n_ops, replaces, source, entry,
               lib_what) in kinds.items():
        # plain, kernel, kernel, plain: both versions inside one run
        plain_a = event_ms(plain, 3, warmup=1)
        ms_a = event_ms(run, 20)
        ms_b = event_ms(run, 20)
        plain_b = event_ms(plain, 3, warmup=1)
        lib_ms = event_ms(library, 10)
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n_ops / PEAK_OPS_S["f32"] * 1e3
        ms = statistics.median([ms_a, ms_b])
        rows.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[entry],
            "max_abs_err": errs[name],
            "tolerance": TOL_LSE if name == "K6-f32-lse" else TOL_BWD,
            "ms": ms,
            "plain_ms": statistics.median([plain_a, plain_b]),
            "plain": ("flash_attention_lse_plain" if name == "K6-f32-lse" else
                      "flash_attention_bwd_plain (dq, dk and dv together)"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "library": lib_what,
            "library_max_abs_err_vs_plain": lib_err if name != "K6-f32-lse" else None,
            "bound_bytes": n_bytes,
            "bound_operations": n_ops,
            "tflops_counted": n_ops / (ms * 1e-3) / 1e12,
            "shape": {"B": b, "nh": nh, "S": s, "hd": hd, "lengths_min": min(lengths),
                      "lengths_mean": float(np.mean(lengths))},
            "small_max_abs_err": small[name],
        })
    rows[0]["bf16_lse_max_abs_err"] = max(small["K6-bf16-lse_lse_only"],
                                          errs["K6-bf16-lse_lse_only"])
    del case, q, k, v, seg, ops, lib_out, ql, kl, vl, same
    torch.cuda.empty_cache()
    return rows


def main() -> None:
    smi = phase_env()
    with tempfile.TemporaryDirectory() as tmp:
        fused_scan.reset_launches()
        phase_main_path(tmp)
        phase_dtypes(tmp)
        launches = dict(fused_scan.LAUNCHES)
        narrow = dict(fused_scan.NARROW_LAUNCHES)
        # bf16 / int8 rows of 384 take the Hopper kernel, never the narrow one
        assert not any(narrow.values()), f"the flat paths reached the narrow kernel: {narrow}"
        torch.cuda.empty_cache()
        ivf_shapes, ivf_launches = phase_ivf_path(tmp)
        torch.cuda.empty_cache()
        model, texts, k6_launches = phase_encoder_path(tmp)
        phase_pipeline_path(tmp, model, texts, k6_launches)
        del model
        torch.cuda.empty_cache()
        train_launches = phase_train_path(tmp)
    emit({"phase": "launches", "flat_path": launches, "flat_path_narrow": narrow,
          "ivf_path": ivf_launches, "text_path": k6_launches, "train_path": train_launches})
    path_counts = {**launches, **ivf_launches,
                   **{n: k6_launches[n] for n in TEXT_ENTRY_POINTS},
                   **{n: train_launches["e5_large"][n] for n in TRAIN_ENTRY_POINTS}}
    missing = [name for name, n in path_counts.items() if n == 0]
    assert not missing, f"the main path never launched: {missing}"
    torch.cuda.empty_cache()
    emit(phase_kernels(launches, ivf_shapes, ivf_launches, k6_launches,
                       train_launches["e5_large"]))
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
