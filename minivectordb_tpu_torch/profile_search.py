"""Where a batched search spends its time, stage by stage, on the CUDA card.

    python -m minivectordb_tpu_torch.profile_search [--rows N] [--dim D]
        [--batch B] [--k K] [--dtypes float32,mixed,bfloat16,int8]
    python -m minivectordb_tpu_torch.profile_search --index ivf [--rows N]
        [--batch B] [--lists-dtypes bfloat16,float32,int8] [--nprobe 32]
    python -m minivectordb_tpu_torch.profile_search --embed [--batch 32]
        [--seq 512] [--compute-dtypes float32,bfloat16]
    python -m minivectordb_tpu_torch.profile_search --attention
        [--hd 64] [--heads 16] [--seq 512] [--batch 32] [--against OTHER/flash_attention.cu]
    python -m minivectordb_tpu_torch.profile_search --phase1
        [--against OTHER/phase1.cu]
    python -m minivectordb_tpu_torch.profile_search --backward
        [--dtype float32|bfloat16] [--batch 16] [--hd 64] [--heads 16] [--seq 512]
        [--against OTHER/flash_attention_bwd.cu | OTHER/flash_attention_bwd_bf16.cu]
    python -m minivectordb_tpu_torch.profile_search --train [--batch 8]
        [--seq 512] [--dtype float32|bfloat16]
        [--against OTHER/flash_attention_bwd.cu | OTHER/flash_attention_bwd_bf16.cu]
    python -m minivectordb_tpu_torch.profile_search --mesh 4 [--rows N]
        [--batch B] [--dtypes float32,bfloat16,int8]
    python -m minivectordb_tpu_torch.profile_search --train-mesh [--tp 2]
        [--dtype float32|bfloat16] [--batch 8] [--seq 512] [--processes N]

Builds a seeded corpus straight into a ``VectorStore`` (no metadata), then
times the stages of ``StoreSnapshot._device_search``'s fused route one by one
with CUDA events (median of ``--reps`` runs after a warm-up): query upload,
phase 1 (the kernel), phase 2, phase 3, the result copy to the host; and the
whole ``snapshot().search`` call on the host clock. Prints one JSON object per
device_dtype, with the card's name and power limit. Needs a CUDA device.

With ``--api`` it also loads the corpus into a ``VectorDatabase`` with one
small metadata dict per row and times ``find_most_similar_batch`` on the host
clock twice: as it is, and after ``gc.freeze()`` has moved the loaded objects
out of the garbage collector's reach — the difference is what the cyclic
collector costs a search when millions of metadata dicts are alive.

With ``--index ivf`` the corpus is a seeded two-level mixture (``--centres``
unit centres in 32 families, plus noise), an ``IVFIndex`` is built over the store's device buffer
for each of ``--lists-dtypes``, and one ``IVFSnapshot.search`` is timed stage
by stage: centroid scores + probe top-k, the grouping bookkeeping (or nothing,
on the paged route), the probe kernel, the gather into (B, nprobe, P) + the
wide top-k + id lookup, the exact rescore; then the whole search by CUDA
events and on the host clock. Batches under 16 over float32/bfloat16 lists
time the paged route.

With ``--embed`` it times one embed call at the e5-large widths (24 layers,
hidden 1024, 16 heads of 64, intermediate 4096, vocabulary 250,037; weights
from a seeded ``torch.Generator``) on a seeded token batch of ragged lengths,
stage by stage with CUDA events, each stage summed over the layers: embedding
lookup + layer norm, the q/k/v projections, the attention kernel (K6), the
output projection, the residual layer norms, the two FFN products with GELU,
and the pooling; then the whole ``embed_program`` by events.

With ``--attention`` it times the attention kernel K6 alone, float32 and
bfloat16, each without and with its row log-sum-exp (the training forward),
at the embed call's shape (B = 32, 16 heads of 64, S = 512, in the encoder's
(B, S, nh, hd) memory, ragged lengths seeded as chip_smoke.py seeds them;
``--heads``, ``--hd``, ``--seq`` and ``--batch`` change it, e.g. ``--hd 128
--heads 8`` for the bundled ``large`` and ``bgem3`` slots' embed call, and
``--seq 256 --batch 64`` for their training shape): the median of single launches
and the mean of 20 back-to-back launches, by CUDA events, each entry point
called straight through its C function, with its largest difference from the
plain version and what ptxas said of the kernel at that width. ``--against``
builds another source with the same C interface (an earlier version of
``csrc/flash_attention.cu``, e.g. the parent commit's) and times each of its
four entry points in turns with this one's (other, this, this, other), both
called the same way; without it, K6 with lse is timed in turns with the
inference launch.

With ``--phase1`` it times the phase-1 kernels K1-f32, K1-bf16 and K2-int8
alone at the flat search's shape (C = 1,048,576, d = 384, B = 256,
count = 1,000,000; ``--rows``/``--dim``/``--batch`` change it), without and
with a mask, the same way: each entry point through its C function, held
against its plain version (K1-f32 also against its 3xTF32 arithmetic in plain
PyTorch), and with ``--against`` another phase1.cu (same C interface, e.g.
the parent commit's) in turns with this one.

With ``--backward`` it times the backward kernels K7 (dK, dV) and K8 (dQ)
alone, in ``--dtype``, at the training step's shape (16 heads of 64, S = 512,
the encoder's (B, S, nh, hd) memory; ragged lengths, q, k, v and dO seeded as
chip_smoke.py seeds its training rows) for B = 16 and B = 8 (a step's
launch), or ``--batch`` alone; ``--hd``, ``--heads`` and ``--seq`` change the
shape (``--hd 128 --heads 8 --seq 256 --batch 64``: the large slots'
train_builtin launch, lengths from 100 up). Each is held against the plain
backward, then timed: the median of single launches and the mean of 20
back-to-back launches, by CUDA
events; each row also gives what ptxas said of the kernel at that width
(registers, spills; the other source's too, when this call built it) and,
in bfloat16, the blocks an SM holds. Both this source and ``--against`` (another csrc/flash_attention_bwd.cu,
or flash_attention_bwd_bf16.cu for bfloat16, with the same C interface) are
called the same way, straight through their C entry points, in turns (other,
this, this, other).

With ``--mesh N`` it loads the corpus into a ``DistributedScanIndex`` over N
logical shards of the card (parallel/) for each of ``--dtypes`` and times one
mesh search stage by stage with CUDA events: each shard's phase-1 kernel and
its whole local top-k (phases 1-3), the merge, the whole
``DistSnapshot.search(fetch=False)``, and the search on the host clock;
beside it the same corpus in one ``VectorStore`` (the unsharded fused scan).
Then ``torch.profiler`` over ``--reps`` mesh searches gives the device's busy
time by kernel name and its idle share of the window.

With ``--train`` it times one contrastive training step (models/train.py) at
the e5-large widths, in ``--dtype`` (float32, or bfloat16: weights,
activations, gradients and AdamW's moments, K6-bf16 with its log-sum-exp and
the bfloat16 K7/K8), on ``--batch`` seeded (query, passage) pairs of
token ids with ragged lengths of at most ``--seq`` (default 8 pairs, S = 512),
stage by stage with CUDA events: the forward (InfoNCE loss through both
encodes), of which the K6 launches (with the row log-sum-exp); the backward
(``loss.backward()``), of which K7 and K8, the rest being the dense layers'
and layer norms' backward, the embedding's and delta = rowsum(dO * O); and
the AdamW step. The kernels' spans come from an event pair around each
launch. Medians over ``--reps`` steps (at most 10) after a warm-up step, and
the whole step on the host clock. With ``--against`` (another
flash_attention_bwd.cu, or flash_attention_bwd_bf16.cu for bfloat16) the
steps of one process alternate between this source's K7 / K8 and the other's
(other, this, this, other, ...; ``--reps`` steps each), and the other's
medians are given as ``other_*``: the same host, weights and data for both.

With ``--train-mesh`` it times the training step at the e5-large widths in
``--dtype`` on a (dp, tp) mesh over every visible card in this process
(``train_mesh(tp=--tp)``, parallel/tensor_parallel.py), beside the
single-device step on the first card, from the same seeded weights (drawn on
the CPU) and batches: host-clock ms per step (each ends in reading the loss),
the median over ``--reps`` steps (at most 10) after a first step, and each
step's loss. With ``--processes N`` (N cards at least) N more processes join
an NCCL group through a TCP store on localhost, one card each, and run the
same steps on ``train_mesh(tp=--tp, pod=True)`` over the group; their losses and each
position's parameter checksum (the float64 sum of its piece) after the steps
are compared with the in-process mesh's.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import hashlib
import json
import os
import statistics
import subprocess
import threading
import time

import numpy as np
import torch

from minivectordb_tpu_torch import convert as port_convert
from minivectordb_tpu_torch.core.store import VectorStore
from minivectordb_tpu_torch.kernels import build
from minivectordb_tpu_torch.models import configs as model_configs
from minivectordb_tpu_torch.models import encoder as encoder_mod
from minivectordb_tpu_torch.models import train as train_mod
from minivectordb_tpu_torch.ops import flash_attention as flash_ops
from minivectordb_tpu_torch.ops import fused_scan
from minivectordb_tpu_torch.ops import ivf as ivf_ops
from minivectordb_tpu_torch.ops import ivf_probe
from minivectordb_tpu_torch.ops import scan as scan_ops


def _event_ms(fn, reps: int) -> float:
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


def profile(dtype: str, corpus: np.ndarray, queries: np.ndarray, k: int,
            reps: int) -> dict:
    store = VectorStore(corpus.shape[1], dtype)
    store.append(corpus)
    t0 = time.perf_counter()
    snap = store.snapshot()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    dev = snap.device
    c = snap.dev_capacity
    kb = scan_ops.k_bucket(k, c)
    int8 = dtype == "int8"
    margin = 16 if snap.scan_buf is None else 8
    n_sub = min(kb + margin, c // fused_scan.SUBTILE)

    q = scan_ops.to_device(queries, dev)
    if int8:
        qi, qinv = scan_ops.quantize_queries_int8(q)

        def phase1():
            return fused_scan.subtile_maxima_int8(
                snap.buf, snap.inv_norms, qi, qinv, snap.count)

        def whole_scan():
            return fused_scan.fused_scan_topk_int8(
                snap.buf, snap.inv_norms, q, snap.count, kb)
    else:
        p1 = snap.buf if snap.scan_buf is None else snap.scan_buf
        qn = scan_ops._normalize(q).to(p1.dtype).contiguous()

        def phase1():
            return fused_scan.subtile_maxima(p1, snap.inv_norms, qn, snap.count)

        def whole_scan():
            return fused_scan.fused_scan_topk(
                snap.buf, snap.inv_norms, q, snap.count, kb,
                scan_buf=snap.scan_buf)

    maxima = phase1()
    vals, idx = whole_scan()
    out = {
        "device_dtype": dtype,
        "rows": int(corpus.shape[0]), "dim": int(corpus.shape[1]),
        "batch": int(queries.shape[0]), "k": k, "n_sub": n_sub,
        "corpus_upload_s": upload_s,
        "query_upload_ms": _event_ms(lambda: scan_ops.to_device(queries, dev), reps),
        "phase1_kernel_ms": _event_ms(phase1, reps),
        "phase2_ms": _event_ms(
            lambda: fused_scan._phase2_topk_subtiles(maxima, n_sub), reps),
        "fused_scan_total_ms": _event_ms(whole_scan, reps),
        "result_fetch_ms": _event_ms(
            lambda: scan_ops.fetch_results(vals[:, :k], idx[:, :k]), reps),
    }
    out["phase3_and_rest_ms"] = (
        out["fused_scan_total_ms"] - out["phase1_kernel_ms"] - out["phase2_ms"])
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap.search(queries, k)
        wall.append((time.perf_counter() - t0) * 1e3)
    out["snapshot_search_wall_ms"] = statistics.median(wall)
    return out


def _wall_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _device_busy(fn, reps: int) -> dict:
    """torch.profiler over ``reps`` calls: device time by kernel name and
    the idle share of the window (1 - device busy / host wall)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): an operator's own row
        # repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            by_name[ev.key] = dev_us
    busy_us = sum(by_name.values())
    if busy_us == 0:
        return {"device_busy": "not measured: the trace holds no device time"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"window_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "top_kernels_ms": {name: us / 1e3 for name, us in top}}


def profile_mesh(dtype: str, shards: int, corpus: np.ndarray, queries: np.ndarray,
                 k: int, reps: int) -> dict:
    from minivectordb_tpu_torch.parallel import dist_scan
    from minivectordb_tpu_torch.parallel.mesh import search_mesh

    mesh = search_mesh(shards, device=torch.device("cuda", torch.cuda.current_device()))
    index = dist_scan.DistributedScanIndex(mesh, corpus.shape[1], device_dtype=dtype)
    t0 = time.perf_counter()
    index.load(corpus)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    snap = index.snapshot()
    dev, lr = snap.device, snap.local_rows
    b = queries.shape[0]
    kb = scan_ops.k_bucket(k, lr)
    q = scan_ops.to_device(queries, dev)
    qn = scan_ops._normalize(q)
    qi, qinv = scan_ops.quantize_queries_int8(q)
    fused = snap.use_fused(b)
    kernel_ms, local_ms, pairs = [], [], {}
    for j, (s, _d) in enumerate(snap.shards):
        buf, inv = snap.bufs[j], snap.inv_norms[j]
        count = min(max(snap.count - s * lr, 0), lr)
        if dtype == "int8":
            kernel_ms.append(_event_ms(
                lambda: fused_scan.subtile_maxima_int8(buf, inv, qi, qinv, count), reps))
        else:
            qd = qn.to(buf.dtype).contiguous()
            kernel_ms.append(_event_ms(
                lambda: fused_scan.subtile_maxima(buf, inv, qd, count), reps))

        def local(buf=buf, inv=inv, count=count, s=s):
            return dist_scan._local_topk(buf, inv, q, count, None, kb, s * lr, fused)

        local_ms.append(_event_ms(local, reps))
        pairs[s] = local()
    k_final = min(kb, shards * kb)
    out = {
        "device_dtype": dtype, "shards": shards, "rows": int(corpus.shape[0]),
        "shard_rows": lr, "batch": b, "k": k, "fused_route": fused,
        "load_s": load_s,
        "phase1_kernel_ms_per_shard": kernel_ms,
        "local_topk_ms_per_shard": local_ms,
        "merge_ms": _event_ms(
            lambda: dist_scan.mesh_merge(mesh, pairs, k_final, dev), reps),
        "mesh_search_device_ms": _event_ms(
            lambda: snap.search(q, k, fetch=False), reps),
        "mesh_search_wall_ms": _wall_ms(lambda: snap.search(queries, k), reps),
        "mesh_profiler": _device_busy(lambda: snap.search(queries, k), reps),
    }
    del snap, index, pairs
    torch.cuda.empty_cache()
    store = VectorStore(corpus.shape[1], dtype)
    store.append(corpus)
    flat = store.snapshot()
    out["unsharded_search_device_ms"] = _event_ms(
        lambda: flat.search(q, k, fetch=False), reps)
    out["unsharded_search_wall_ms"] = _wall_ms(lambda: flat.search(queries, k), reps)
    out["unsharded_profiler"] = _device_busy(lambda: flat.search(queries, k), reps)
    return out


def profile_api(dtype: str, corpus: np.ndarray, queries: np.ndarray, k: int,
                reps: int) -> dict:
    import os
    import tempfile

    from minivectordb_tpu_torch import VectorDatabase

    n = corpus.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        db = VectorDatabase(storage_file=os.path.join(tmp, "db.pkl"),
                            device_dtype=dtype)
        t0 = time.perf_counter()
        db.store_embeddings_batch(
            list(range(n)), corpus, [{"bucket": i % 16} for i in range(n)])
        load_s = time.perf_counter() - t0
        db.find_most_similar_batch(queries, k=k)  # upload + warm-up

        def wall_ms():
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                db.find_most_similar_batch(queries, k=k)
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times), max(times)

        med, worst = wall_ms()
        gc.collect()
        gc.freeze()
        med_frozen, worst_frozen = wall_ms()
        gc.unfreeze()
        ops = db.stats()["ops"]
    return {
        "public_api": "find_most_similar_batch", "device_dtype": dtype,
        "rows": int(n), "batch": int(queries.shape[0]), "k": k,
        "load_s": load_s,
        "wall_ms_median": med, "wall_ms_max": worst,
        "wall_ms_median_gc_frozen": med_frozen, "wall_ms_max_gc_frozen": worst_frozen,
        "engine_device_scan_mean_ms": ops["device_scan"]["mean_ms"],
    }


def profile_ivf(lists_dtype: str, store: VectorStore, queries: np.ndarray,
                k: int, nprobe: int, nlist: int, reps: int) -> dict:
    """One IVFSnapshot.search over ``store``'s device buffer, stage by stage."""
    buf, inv, count = store.sync()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_ops.IVFIndex(nlist=nlist, nprobe=nprobe, device_dtype=lists_dtype)
    index.build(buf, count=count, inv_norms=inv)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    snap = index.snapshot()
    lists, list_ids, list_valid = snap.tables
    l, p, _d = lists.shape
    b = int(queries.shape[0])
    q = scan_ops.to_device(queries, lists.device)
    nlist_eff = l
    npb = min(-(-nprobe * nlist_eff // max(1, nlist_eff - snap.n_dup)), nlist_eff)
    rescore = snap.data is not None
    kwide = min(ivf_ops._rescore_kwide(k, lists.dtype), npb * p) if rescore else k
    grouped = b >= 16 or snap.list_inv is not None
    out = {
        "index": "ivf", "lists_dtype": lists_dtype, "rows": count,
        "dim": int(lists.shape[2]), "batch": b, "k": k, "kwide": kwide,
        "nprobe": nprobe, "nprobe_slots": npb, "L": l, "P": p,
        "n_dup": int(snap.n_dup), "build_s": build_s,
        "route": "grouped" if grouped else "paged",
        "list_tensor_bytes": lists.numel() * lists.element_size(),
    }
    qn, probe = ivf_probe.probe_lists(snap.centroids, q, npb)
    out["centroid_scores_probe_topk_ms"] = _event_ms(
        lambda: ivf_probe.probe_lists(snap.centroids, q, npb), reps)
    if grouped:
        g = int(min(ivf_probe.GROUP_MAX, max(8, b * npb)))

        def bookkeeping():
            step_list, step_q, pair_step, pair_slot = ivf_probe.group_pairs(probe, l, g)
            if snap.list_inv is not None:
                qi, qinv = ivf_probe.quantize_queries_ivf(qn)
                return (step_list, qi.to(torch.int8)[step_q], qinv[step_q],
                        pair_step, pair_slot)
            return step_list, qn.to(lists.dtype)[step_q], None, pair_step, pair_slot

        step_list, gq, gqinv, pair_step, pair_slot = bookkeeping()
        out["steps"] = int(step_list.shape[0])
        out["live_steps"] = int((step_list >= 0).sum())
        out["touched_lists"] = int(torch.unique(probe).numel())
        out["bookkeeping_ms"] = _event_ms(bookkeeping, reps)

        def kernel():
            if gqinv is not None:
                return ivf_probe.grouped_scores_q(
                    lists, gq, step_list, list_valid, snap.list_inv, gqinv)
            return ivf_probe.grouped_scores(lists, gq, step_list, list_valid)

        scores = kernel()

        def select():
            flat = scores[pair_step, pair_slot].reshape(b, npb * p)
            vals, pos = scan_ops.topk_last_axis(flat, min(kwide, npb * p))
            win = torch.gather(probe, -1, pos // p)
            return vals, list_ids[win, pos % p]
    else:
        out["bookkeeping_ms"] = 0.0
        qd = qn.to(lists.dtype).contiguous()
        p32 = probe.to(torch.int32)

        def kernel():
            return ivf_probe.probe_scores(lists, qd, p32)

        scores = kernel()

        def select():
            valid = list_valid[probe].reshape(b, npb * p)
            gids = list_ids[probe].reshape(b, npb * p)
            flat = torch.where(valid, scores, ivf_probe._MASKED_SCORE)
            vals, pos = scan_ops.topk_last_axis(flat, min(kwide, npb * p))
            return vals, torch.gather(gids, -1, pos)

    out["probe_kernel_ms"] = _event_ms(kernel, reps)
    vals, ids = select()
    out["gather_topk_ids_ms"] = _event_ms(select, reps)
    out["rescore_ms"] = (
        _event_ms(lambda: ivf_ops._exact_rescore(
            snap.data, snap.inv_norms, q, vals, ids, k), reps)
        if rescore else 0.0
    )
    out["search_device_total_ms"] = _event_ms(
        lambda: snap.search(q, k, nprobe=nprobe, fetch=False), reps)
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap.search(queries, k, nprobe=nprobe)
        wall.append((time.perf_counter() - t0) * 1e3)
    out["snapshot_search_wall_ms"] = statistics.median(wall)
    return out


def profile_embed(compute_dtype: str, batch: int, seq: int, seed: int, reps: int) -> dict:
    """One embed call at the e5-large widths, stage by stage. The staged pass
    repeats ``models/encoder.py:encode`` with an event pair around every
    stage; its result must equal ``embed_program``'s."""
    cfg = model_configs.E5_LARGE
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    enc = encoder_mod.init_params(cfg, gen, dev, dtype)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(int(seq * 0.75), seq + 1, size=batch)
    lengths[0] = seq
    mask_np = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int64)
    ids_np = rng.integers(4, cfg.vocab_size, (batch, seq))
    ids_np[mask_np == 0] = cfg.pad_id
    ids = scan_ops.to_device(ids_np, dev)
    mask = scan_ops.to_device(mask_np, dev)
    nh, hd = cfg.heads, cfg.hidden // cfg.heads
    flash = encoder_mod._use_flash_attention(seq, hd, dev)
    stages = ("embedding_lookup_ln", "qkv_projections", "attention", "output_projection",
              "residual_layer_norms", "ffn_in_gelu", "ffn_out", "pooling")

    def staged():
        spans = {name: [] for name in stages}

        def timed(name, fn):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn()
            e1.record()
            spans[name].append((e0, e1))
            return out

        dense, norm = encoder_mod._dense, encoder_mod._layer_norm
        with torch.inference_mode():
            bmask = mask.to(torch.bool)
            seg = mask.to(torch.int32)

            def embed():
                positions = torch.cumsum(mask, dim=-1) * mask + cfg.pad_id
                x = enc.word_emb[ids] + enc.pos_emb[positions] + enc.type_emb[0]
                return norm(x, enc.emb_ln.g, enc.emb_ln.b, cfg.layer_norm_eps)

            x = timed("embedding_lookup_ln", embed)
            for layer in enc.layers:
                q, k, v = timed("qkv_projections", lambda: [
                    dense(x, p).view(batch, seq, nh, hd).transpose(1, 2)
                    for p in (layer.q, layer.k, layer.v)])
                if flash:
                    ctx = timed("attention", lambda: flash_ops.flash_attention(
                        q, k, v, seg, 1.0 / float(np.sqrt(hd))))
                    ctx = ctx.transpose(1, 2).reshape(batch, seq, cfg.hidden)
                else:
                    def materialised():
                        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
                        logits = (logits / float(np.sqrt(hd))).masked_fill(
                            ~bmask[:, None, None, :], torch.finfo(torch.float32).min)
                        probs = torch.softmax(logits, dim=-1).to(x.dtype)
                        return torch.matmul(probs, v).transpose(1, 2).reshape(
                            batch, seq, cfg.hidden)
                    ctx = timed("attention", materialised)
                attn = timed("output_projection", lambda: dense(ctx, layer.attn_out))
                x = timed("residual_layer_norms", lambda: norm(
                    x + attn, layer.attn_ln.g, layer.attn_ln.b, cfg.layer_norm_eps))
                hmid = timed("ffn_in_gelu", lambda: torch.nn.functional.gelu(
                    dense(x, layer.ffn_in)))
                ff = timed("ffn_out", lambda: dense(hmid, layer.ffn_out))
                x = timed("residual_layer_norms", lambda: norm(
                    x + ff, layer.ffn_ln.g, layer.ffn_ln.b, cfg.layer_norm_eps))
            out = timed("pooling", lambda: encoder_mod.apply_cos_floor(
                encoder_mod.mean_pool_normalize(x, mask, cfg.token_norm_pool), cfg))
        torch.cuda.synchronize()
        return out, {name: sum(a.elapsed_time(b) for a, b in pairs)
                     for name, pairs in spans.items()}

    flash_ops.reset_launches()
    want = encoder_mod.embed_program(enc, ids, mask)
    launches = dict(flash_ops.LAUNCHES)
    got, _ = staged()
    if not torch.equal(got, want):
        raise AssertionError("the staged pass does not repeat embed_program")
    runs = [staged()[1] for _ in range(reps)]
    out = {
        "embed": "e5-large widths", "compute_dtype": compute_dtype,
        "batch": batch, "seq": seq, "layers": cfg.layers,
        "tokens_real": int(lengths.sum()),
        "attention_route": "flash_attention kernel" if flash else "materialised",
        "kernel_launches_per_call": launches,
    }
    for name in stages:
        out[name + "_ms"] = statistics.median(r[name] for r in runs)
    out["stages_sum_ms"] = sum(out[name + "_ms"] for name in stages)
    out["embed_program_ms"] = _event_ms(
        lambda: encoder_mod.embed_program(enc, ids, mask), reps)
    return out


def profile_train(batch: int, seq: int, seed: int, reps: int,
                  dtype: str = "float32", against: str | None = None) -> dict:
    """One training step at the e5-large widths, stage by stage (see the
    module docstring); with ``against``, steps alternate between this
    source's K7 / K8 and those of another backward source."""
    cfg = model_configs.E5_LARGE
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    enc, _state, optimizer = train_mod.init_training(
        cfg, encoder_mod.init_params(cfg, gen, dev, getattr(torch, dtype)), device=dev)
    kind = "f32" if dtype == "float32" else "bf16"
    rng = np.random.default_rng(seed)

    def tokens():
        lengths = rng.integers(200, seq + 1, size=batch)
        mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(4, cfg.vocab_size, (batch, seq)).astype(np.int32)
        ids[mask == 0] = cfg.pad_id
        return ids, mask

    (q_ids, q_mask), (p_ids, p_mask) = tokens(), tokens()
    data = train_mod.batch_to({"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids,
                          "p_mask": p_mask}, dev)
    spans: dict = {}
    launch = flash_ops._launch

    def timed_launch(name, *args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        launch(name, *args)
        e1.record()
        spans.setdefault(name, []).append((e0, e1))

    def step():
        spans.clear()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        optimizer.zero_grad(set_to_none=True)
        loss, _acc = train_mod.info_nce_loss(enc, cfg, data)
        ev[1].record()
        loss.backward()
        ev[2].record()
        optimizer.step()
        ev[3].record()
        ev[3].synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        k = {name: sum(a.elapsed_time(b) for a, b in pairs) for name, pairs in spans.items()}
        counts = {name: len(pairs) for name, pairs in spans.items()}
        fwd, bwd = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        k7 = k.get(f"flash_attention_bwd_dkv_{kind}", 0.0)
        k8 = k.get(f"flash_attention_bwd_dq_{kind}", 0.0)
        return {
            "forward_ms": fwd,
            "of_which_k6_lse_ms": k.get(f"flash_attention_lse_{kind}", 0.0),
            "backward_ms": bwd,
            "of_which_k7_ms": k7,
            "of_which_k8_ms": k8,
            "backward_rest_ms": bwd - k7 - k8,
            "optimizer_ms": ev[2].elapsed_time(ev[3]),
            "step_device_ms": ev[0].elapsed_time(ev[3]),
            "step_wall_ms": wall,
        }, counts, float(loss)

    bwd = [f"flash_attention_bwd_dkv_{kind}", f"flash_attention_bwd_dq_{kind}"]
    sides = {"this": {n: flash_ops._kernel_fn(n) for n in bwd}}
    order = ["this"]
    if against:
        other = _load_other(against, flash_ops._SOURCE[bwd[0]],
                            {n: flash_ops._ARGTYPES[n] for n in bwd})
        sides["other"] = {n: getattr(other, n) for n in bwd}
        order = ["other", "this", "this", "other"]
    by_side: dict = {side: [] for side in sides}
    flash_ops._launch = timed_launch
    try:
        for side in sides:  # warm-up: library handles, the kernels' first launches
            flash_ops._fns.update(sides[side])
            step()
        for i in range(reps * len(sides)):
            side = order[i % len(order)]
            flash_ops._fns.update(sides[side])
            by_side[side].append(step())
    finally:
        flash_ops._launch = launch
        flash_ops._fns.update(sides["this"])
    runs = by_side["this"]
    out = {"train": "e5-large widths", "dtype": dtype, "pairs": batch, "seq": seq,
           "layers": cfg.layers,
           "real_tokens_per_step": int(q_mask.sum() + p_mask.sum()),
           "kernel_launches_per_step": runs[0][1],
           "loss_first_last": [runs[0][2], runs[-1][2]],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    for name in runs[0][0]:
        out[name] = statistics.median(r[0][name] for r in runs)
    out["real_tokens_per_s_device"] = out["real_tokens_per_step"] / (out["step_device_ms"] * 1e-3)
    if against:
        out["other"] = against
        for name in runs[0][0]:
            out["other_" + name] = statistics.median(r[0][name] for r in by_side["other"])
    return out


_OTHER_LOGS: dict = {}  # source path -> its compiler output (ptxas -v), when built here


def _mesh_weights(cfg, seed: int, dtype: str) -> dict:
    """Seeded weights as the JAX pytree, drawn on the CPU so that every
    process draws the same values."""
    gen = torch.Generator().manual_seed(seed)
    enc = encoder_mod.init_params(cfg, gen, "cpu", getattr(torch, dtype))
    return port_convert.encoder_to_numpy(enc)


def _mesh_batches(cfg, batch: int, seq: int, seed: int, steps: int) -> list:
    """``steps`` batches of ``batch`` seeded (query, passage) pairs of token
    ids, ragged lengths of 200 ... ``seq``."""
    rng = np.random.default_rng(seed)

    def tokens():
        lengths = rng.integers(min(200, seq), seq + 1, size=batch)
        mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(4, cfg.vocab_size, (batch, seq)).astype(np.int32)
        ids[mask == 0] = cfg.pad_id
        return ids, mask

    out = []
    for _ in range(steps):
        (q_ids, q_mask), (p_ids, p_mask) = tokens(), tokens()
        out.append({"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids, "p_mask": p_mask})
    return out


def _timed_steps(step, params, state, batches) -> tuple:
    """Host-clock ms of each step, which ends in reading its loss, and the
    losses."""
    ms, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return params, ms, losses


def _checksums(menc) -> dict:
    """Position -> the float64 sum of every parameter of its piece."""
    with torch.no_grad():
        return {pos: sum(float(p.double().sum()) for p in piece.parameters())
                for pos, piece in menc.pieces.items()}


def _train_mesh_worker(rank: int, n: int, addr: str, tp: int, cfg, dtype: str,
                       batch: int, seq: int, seed: int, steps: int, device: str,
                       out_dir: str) -> None:
    """One process of --train-mesh --processes: joins the group, trains the
    steps on train_mesh(tp=tp, pod=True) over it, writes its times, losses and
    checksums to out_dir/<rank>.json."""
    from minivectordb_tpu_torch.parallel.mesh import init_pod, train_mesh
    import torch.distributed as dist

    init_pod(addr, n, rank, device=device)
    try:
        mesh = train_mesh(tp=tp, device=device, pod=True)
        menc, state, opt = train_mod.init_training(cfg, _mesh_weights(cfg, seed, dtype),
                                                   mesh=mesh)
        step = train_mod.make_train_step(cfg, opt, mesh=mesh)
        menc, ms, losses = _timed_steps(step, menc, state,
                                        _mesh_batches(cfg, batch, seq, seed, steps))
        res = {"rank": rank, "mesh": list(mesh.devices.shape), "ms": ms, "losses": losses,
               "checksums": _checksums(menc)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(res, f)


def profile_train_mesh(tp: int, dtype: str, batch: int, seq: int, seed: int, reps: int,
                       processes: int = 0, cfg=None, device=None) -> dict:
    """The training step on a (dp, tp) mesh over every visible card (or, with
    ``device``, ``processes`` logical positions of it), beside the
    single-device step; with ``processes``, the same steps on a mesh over
    that many processes (see the module docstring)."""
    import socket
    import tempfile

    from minivectordb_tpu_torch.parallel.mesh import train_mesh

    cfg = cfg or model_configs.E5_LARGE
    steps = reps + 1
    weights = _mesh_weights(cfg, seed, dtype)
    batches = _mesh_batches(cfg, batch, seq, seed, steps)
    first = torch.device(device) if device else torch.device("cuda", 0)
    out = {"train_mesh": "e5-large widths" if cfg is model_configs.E5_LARGE else str(cfg),
           "dtype": dtype, "pairs": batch, "seq": seq, "steps": steps}
    enc, state, opt = train_mod.init_training(cfg, weights, device=first)
    _enc, ms, losses = _timed_steps(train_mod.make_train_step(cfg, opt), enc, state, batches)
    out["single_device"] = {"ms": ms, "ms_per_step": statistics.median(ms[1:]),
                            "losses": losses}
    del enc, _enc, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    mesh = train_mesh(processes or None, tp=tp, device=device)
    menc, state, opt = train_mod.init_training(cfg, weights, mesh=mesh)
    menc, ms, losses = _timed_steps(train_mod.make_train_step(cfg, opt, mesh=mesh),
                                    menc, state, batches)
    sums = _checksums(menc)
    out["in_process"] = {"mesh": list(mesh.devices.shape),
                         "devices": sorted({str(d) for d in mesh.devices.reshape(-1)}),
                         "ms": ms, "ms_per_step": statistics.median(ms[1:]),
                         "losses": losses}
    del menc, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    if not processes:
        return out
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_train_mesh_worker, args=(
            rank, processes, addr, tp, cfg, dtype, batch, seq, seed, steps,
            device or f"cuda:{rank}", out_dir)) for rank in range(processes)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=1200)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
        if codes != [0] * processes:
            raise RuntimeError(f"--train-mesh workers exited with {codes}")
        ranks = []
        for rank in range(processes):
            with open(os.path.join(out_dir, f"{rank}.json")) as f:
                ranks.append(json.load(f))
    got = {int(pos): v for r in ranks for pos, v in r["checksums"].items()}
    out["processes"] = {
        "world": processes, "mesh": ranks[0]["mesh"], "backend": "nccl" if not device else "gloo",
        "ms_rank0": ranks[0]["ms"], "ms_per_step_rank0": statistics.median(ranks[0]["ms"][1:]),
        "losses_rank0": ranks[0]["losses"],
        "losses_equal_in_process": all(r["losses"] == losses for r in ranks),
        "max_loss_diff_in_process": max(abs(a - b) for r in ranks
                                        for a, b in zip(r["losses"], losses)),
        "checksums_equal_in_process": got == sums,
        "max_checksum_diff": max(abs(got[pos] - sums[pos]) for pos in sums),
    }
    return out


def _load_other(src: str, name: str, argtypes: dict):
    """Builds another csrc/<name>.cu (same C interface) with the package's
    flags into the build directory, the compiler's report beside it, and
    loads it (a library built earlier, by another process too, is reused
    with its report)."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(build.build_dir(), f"lib{name}_other_{digest}.so")
    os.makedirs(build.build_dir(), exist_ok=True)
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", tmp, src],
                              check=True, capture_output=True, text=True)
        with open(tmp + ".log", "w", encoding="utf-8") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp + ".log", path + ".log")
        os.replace(tmp, path)
    with open(path + ".log", encoding="utf-8") as f:
        _OTHER_LOGS[src] = f.read()
    lib = ctypes.CDLL(path)
    for fn, types in argtypes.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _ptxas(log: str, *kernels: str) -> str | None:
    """What ptxas -v said of the kernel whose mangled name holds the first
    of ``kernels`` that the log names: "Used N registers, ...; ... bytes
    spill stores, ... bytes spill loads" (None if the log holds none of them,
    e.g. a library built earlier)."""
    lines = log.splitlines()
    for kernel in kernels:
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and kernel in line:
                near = lines[i + 1:i + 4]
                used = next((u for u in near if "Used" in u), "")
                spills = next((u for u in near if "spill" in u), "")
                return used.split(":", 1)[-1].strip() + "; " + spills.strip()
    return None


def _times(fn, reps: int):
    """(median of single launches, mean of 20 back-to-back launches), ms."""
    single = _event_ms(fn, reps)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        fn()
    e1.record()
    e1.synchronize()
    return single, e0.elapsed_time(e1) / 20


def _in_turns(row: dict, this, that, reps: int) -> None:
    """Times this alone, or that, this, this, that into row."""
    if that is None:
        row["ms_single"], row["ms_back_to_back"] = _times(this, reps)
        return
    first = _times(that, reps)
    mine = [_times(this, reps), _times(this, reps)]
    last = _times(that, reps)
    row["ms_single"] = [mine[0][0], mine[1][0]]
    row["ms_back_to_back"] = [mine[0][1], mine[1][1]]
    row["other_ms_single"] = [first[0], last[0]]
    row["other_ms_back_to_back"] = [first[1], last[1]]


def profile_attention(against: str | None, seed: int, reps: int, heads: int = 16,
                      seq: int = 512, hd: int = 64, batch: int = 32) -> list:
    dev = torch.device("cuda", torch.cuda.current_device())
    b, nh, s = batch, heads, seq
    rng = np.random.default_rng(seed + 42)  # chip_smoke.py's lengths
    lengths = rng.integers(min(200, s), s + 1, size=b)
    lengths[0] = s
    seg = torch.as_tensor((np.arange(s)[None, :] < lengths[:, None]).astype(np.int32),
                          device=dev)
    scale = 1.0 / float(np.sqrt(hd))
    entries = {n: flash_ops._ARGTYPES[n] for n in flash_ops.LAUNCHES if "_bwd_" not in n}
    other = _load_other(against, "flash_attention", entries) if against else None
    rows = []
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 43)
        q, k, v = (torch.randn((b, s, nh * hd), device=dev, generator=gen).to(dtype)
                   .view(b, s, nh, hd).transpose(1, 2) for _ in range(3))
        mangled = f"flash_{kind}_kernelILi{hd}E"

        def bare(fns, name, source):
            """Entry point ``name`` of one source, straight through its C
            function (both sides the same way; the wrapper's host work is
            left out)."""
            def call():
                out = torch.empty_like(q)
                lse = torch.empty((b, nh, s), device=dev)
                ptrs = [out.data_ptr()] + ([lse.data_ptr()] if "_lse_" in name else [])
                err = fns(name)(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), *ptrs,
                    b, nh, s, hd, *q.stride()[:3], *out.stride()[:3], scale,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} of {source}: cudaError {err}")
                return out, lse
            return call

        want, want_lse = flash_ops.flash_attention_lse_plain(q, k, v, seg, scale)
        want = want.float()

        def errs(got, lse):
            out = {"max_abs_err_vs_plain": float((got[0].float() - want).abs().max())}
            if lse:
                out["lse_max_abs_err_vs_plain"] = float((got[1] - want_lse).abs().max())
            return out

        for lse in (False, True):
            name = f"flash_attention_{'lse_' if lse else ''}{kind}"
            this = bare(flash_ops._kernel_fn, name, "this source")
            row = {"kernel": f"K6-{kind}{'-lse' if lse else ''}", "shape": [b, nh, s, hd],
                   **errs(this(), lse),
                   "ptxas": _ptxas(build.build_info["flash_attention"]["log"], mangled)}
            that = None
            if other is not None:
                that = bare(lambda n: getattr(other, n), name, against)
                row["other"] = against
                row.update({"other_" + key: x for key, x in errs(that(), lse).items()})
                row["other_ptxas"] = _ptxas(_OTHER_LOGS.get(against, ""), mangled)
            elif lse:
                # without another source, the training forward in turns with
                # the inference launch of this one
                that = bare(flash_ops._kernel_fn, f"flash_attention_{kind}", "this source")
                row["other"] = f"K6-{kind} without lse (flash_attention_{kind})"
            _in_turns(row, this, that, reps)
            rows.append(row)
        del q, k, v, want, want_lse
        torch.cuda.empty_cache()
    return rows


def profile_backward(against: str | None, dtype: str, batches: list, seed: int,
                     reps: int, hd: int = 64, heads: int = 16, seq: int = 512) -> list:
    dev = torch.device("cuda", torch.cuda.current_device())
    nh, s = heads, seq
    kind = "f32" if dtype == "float32" else "bf16"
    names = {"K7": f"flash_attention_bwd_dkv_{kind}", "K8": f"flash_attention_bwd_dq_{kind}"}
    other = None
    if against:
        other = _load_other(against, flash_ops._SOURCE[names["K7"]],
                            {n: flash_ops._ARGTYPES[n] for n in names.values()})
    scale = 1.0 / float(np.sqrt(hd))
    rows = []
    for b in batches:
        # chip_smoke.py's training rows: seeded_lengths(b, s, 200, SEED + 87),
        # attention_case(..., SEED + 88), dO from SEED + 89 (lengths from
        # 200 / 512 of S up: 100 at the slots' S = 256)
        rng = np.random.default_rng(seed + 87)
        lengths = rng.integers(s * 200 // 512, s + 1, size=b)
        lengths[0] = s
        seg = torch.as_tensor((np.arange(s)[None, :] < lengths[:, None]).astype(np.int32),
                              device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 88)
        q, k, v = (torch.randn((b, s, nh * hd), device=dev, generator=gen)
                   .to(getattr(torch, dtype)).view(b, s, nh, hd).transpose(1, 2)
                   for _ in range(3))
        gen.manual_seed(seed + 89)
        dout = torch.randn(q.shape, device=dev, generator=gen).to(q.dtype)
        out, lse = flash_ops.flash_attention_lse(q, k, v, seg, scale)
        ops = flash_ops._bwd_operands(q, k, v, seg, out, dout, lse)
        want = flash_ops.flash_attention_bwd_plain(q, k, v, seg, out, dout, lse, scale)
        want = {"K7": want[1:], "K8": want[:1]}
        qo, ko, vo, sego, doo, lseo, deltao = ops

        def bare(fn, name, n_out):
            def call():
                grads = [torch.empty_like(qo) for _ in range(n_out)]
                err = fn(qo.data_ptr(), ko.data_ptr(), vo.data_ptr(), doo.data_ptr(),
                         lseo.data_ptr(), deltao.data_ptr(), sego.data_ptr(),
                         *(g.data_ptr() for g in grads), b, nh, s, hd, *qo.stride()[:3],
                         *doo.stride()[:3], *grads[0].stride()[:3], scale,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
                return grads
            return call

        def err_vs_plain(fn, kernel):
            return max(float((g.float() - w.float()).abs().max())
                       for g, w in zip(fn(), want[kernel]))

        for kernel, name in names.items():
            n_out = 2 if kernel == "K7" else 1
            this = bare(flash_ops._kernel_fn(name), name, n_out)
            # the float32 kernels are bwd_dkv_tf32_kernel and bwd_dq_tf32_kernel
            # (bwd_dkv_kernel and bwd_dq_kernel in sources before their 3xTF32
            # forms)
            stem = "bwd_dkv" if kernel == "K7" else "bwd_dq"
            infixes = ["_bf16"] if kind == "bf16" else ["_tf32", ""]
            mangled = [f"{stem}{infix}_kernelILi{hd}E" for infix in infixes]
            row = {"kernel": f"{kernel}-{kind}", "shape": [b, nh, s, hd],
                   "lengths_min": int(lengths.min()),
                   "lengths_mean": float(lengths.mean()),
                   "max_abs_err_vs_plain": err_vs_plain(this, kernel),
                   "ptxas": _ptxas(build.build_info[flash_ops._SOURCE[name]]["log"], *mangled)}
            if kind == "bf16":
                row["blocks_per_sm"] = flash_ops.bwd_bf16_blocks_per_sm(
                    hd, "dkv" if kernel == "K7" else "dq")
            that = None
            if other is not None:
                that = bare(getattr(other, name), name, n_out)
                row["other"] = against
                row["other_max_abs_err_vs_plain"] = err_vs_plain(that, kernel)
                row["other_ptxas"] = _ptxas(_OTHER_LOGS.get(against, ""), *mangled)
            _in_turns(row, this, that, reps)
            rows.append(row)
        del q, k, v, dout, out, lse, ops, want, qo, ko, vo, doo, lseo, deltao
        torch.cuda.empty_cache()
    return rows


def phase1_operands(c: int, d: int, b: int, seed: int):
    """Seeded operands of the phase-1 kernels on the card, as a search makes
    them: a standard normal corpus in float32, as a bf16 shadow and as int8
    rows, each with its inv norms (int8: its scales); unit queries in the same
    three forms (int8: quantized, with 1/norm); and a mask passing half the
    rows. Returns (mask, {kind: (buf, inv, q, qinv or None)})."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    buf = torch.randn((c, d), device="cuda", generator=g)
    q = scan_ops._normalize(torch.randn((b, d), device="cuda", generator=g))
    mask = torch.rand((c,), device="cuda", generator=g) < 0.5
    bf = buf.to(torch.bfloat16)
    i8, inv8 = scan_ops.update_rows_int8(
        torch.zeros((c, d), dtype=torch.int8, device="cuda"),
        torch.zeros((c,), device="cuda"), buf, 0, in_place=True)
    qi, qinv = scan_ops.quantize_queries_int8(q)
    return mask, {
        "f32": (buf, scan_ops.row_inv_norms(buf), q, None),
        "bf16": (bf, scan_ops.row_inv_norms(bf), q.to(torch.bfloat16), None),
        "i8": (i8, inv8, qi, qinv),
    }


def profile_phase1(against: str | None, rows: int, dim: int, batch: int, seed: int,
                   reps: int) -> list:
    c = scan_ops.capacity_bucket(rows)
    count = rows
    other = _load_other(against, "phase1", fused_scan._ARGTYPES) if against else None
    mask, cases = phase1_operands(c, dim, batch, seed)
    names = {"f32": ("phase1_f32", "K1-f32"), "bf16": ("phase1_bf16", "K1-bf16"),
             "i8": ("phase1_i8", "K2-int8")}
    out_rows = []
    for kind, (buf, inv, q, qinv) in cases.items():
        name, label = names[kind]
        ptrs = [buf, q, inv] + ([qinv] if kind == "i8" else [])
        for m in (None, mask):
            if kind == "i8":
                want = fused_scan.subtile_maxima_int8_plain(buf, inv, q, qinv, count, m)
            else:
                want = fused_scan.subtile_maxima_plain(buf, inv, q, count, m)

            def launcher(fn, source):
                def call():
                    out = torch.empty_like(want)
                    err = fn(*[t.data_ptr() for t in ptrs], None if m is None else m.data_ptr(),
                             out.data_ptr(), c, dim, batch, count,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name} of {source}: cudaError {err}")
                    return out
                return call

            # both sources through their C functions, the same way
            this = launcher(fused_scan._kernel_fn(name), "this source")
            that = launcher(getattr(other, name), against) if other is not None else None
            row = {"kernel": label + ("-mask" if m is not None else ""),
                   "shape": {"C": c, "d": dim, "B": batch, "count": count},
                   "max_abs_err_vs_plain": float((this() - want).abs().max())}
            if kind == "f32":
                emulated = fused_scan.subtile_maxima_3xtf32_plain(buf, inv, q, count, m)
                row["max_abs_err_vs_3xtf32_plain"] = float((this() - emulated).abs().max())
                del emulated
            if other is not None:
                row["other"] = against
                row["other_max_abs_err_vs_plain"] = float((that() - want).abs().max())
            _in_turns(row, this, that, reps)
            out_rows.append(row)
            del want
    return out_rows


def clustered_corpus(rows: int, batch: int, dim: int, centres: int, seed: int,
                     families: int = 32):
    """(rows, batch) numpy arrays: corpus rows and queries from one seeded
    two-level mixture, made on the card. Unit family directions; unit centres
    27 degrees off their family's direction (so a centre has its family's
    other centres as siblings at cosine 0.8); a row is a centre plus isotropic
    noise 1.18 times the centre's length. Neighbours then spill into sibling
    lists and recall depends on nprobe, as it does on real embeddings."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def unit(*shape):
        return scan_ops._normalize(torch.randn(shape, device="cuda", generator=g))

    fam = unit(families, dim)
    member = torch.randint(0, families, (centres,), device="cuda", generator=g)
    c = scan_ops._normalize(fam[member] + 0.5 * unit(centres, dim))
    noise = 1.18 / float(np.sqrt(dim))

    def draw(m):
        which = torch.randint(0, centres, (m,), device="cuda", generator=g)
        return c[which] + noise * torch.randn((m, dim), device="cuda", generator=g)

    return draw(rows).cpu().numpy(), draw(batch).cpu().numpy()


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, checked before any CUDA call: a head width the
    attention kernels are not built for is refused here."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--batch", type=int, default=None,
                    help="queries per search (default 256) or texts per embed call "
                         "with --embed / sequences with --attention (default 32)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtypes", default="float32,mixed,bfloat16,int8")
    ap.add_argument("--api", action="store_true",
                    help="also time the public class, with and without gc.freeze()")
    ap.add_argument("--index", choices=("flat", "ivf"), default="flat")
    ap.add_argument("--lists-dtypes", default="bfloat16,float32,int8")
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--centres", type=int, default=1024)
    ap.add_argument("--embed", action="store_true",
                    help="time one embed call at the e5-large widths, stage by stage")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--compute-dtypes", default="float32,bfloat16")
    ap.add_argument("--attention", action="store_true",
                    help="time the attention kernel K6 alone at the embed call's shape")
    ap.add_argument("--hd", type=int, default=64,
                    help=f"with --attention / --backward: the head width, one of "
                         f"{flash_ops.HEAD_DIMS}")
    ap.add_argument("--heads", type=int, default=16,
                    help="with --attention / --backward: the heads")
    ap.add_argument("--phase1", action="store_true",
                    help="time the phase-1 kernels K1-f32, K1-bf16 and K2 alone at the "
                         "search's shape")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernels K7 and K8 alone at the training shape")
    ap.add_argument("--train", action="store_true",
                    help="time one training step at the e5-large widths, stage by stage")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="with --train / --backward: the encoder's type")
    ap.add_argument("--mesh", type=int, default=0,
                    help="time one search over this many logical shards of the card")
    ap.add_argument("--train-mesh", action="store_true",
                    help="time the training step on a (dp, tp) mesh over the visible cards")
    ap.add_argument("--tp", type=int, default=2, help="with --train-mesh: the tp width")
    ap.add_argument("--processes", type=int, default=0,
                    help="with --train-mesh: also run the mesh over this many NCCL processes")
    ap.add_argument("--against", default=None,
                    help="with --attention / --phase1 / --backward / --train: another "
                         "flash_attention.cu / phase1.cu / flash_attention_bwd[_bf16].cu "
                         "to time in turns")
    args = ap.parse_args(argv)
    if args.hd not in flash_ops.HEAD_DIMS:
        ap.error(f"--hd {args.hd}: the kernels are built for {flash_ops.HEAD_DIMS}")
    if args.heads < 1 or args.seq < 1:
        ap.error("--heads and --seq must be at least 1")
    return args


def main() -> None:
    args = parse_args()
    batch_given = args.batch is not None
    if args.batch is None:
        args.batch = 32 if args.embed else 8 if args.train or args.train_mesh else 256
    if not torch.cuda.is_available():
        raise SystemExit("profile_search needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if args.attention:
        for res in profile_attention(args.against, args.seed, args.reps, args.heads,
                                     args.seq, args.hd, args.batch if batch_given else 32):
            res["card"] = smi
            print(json.dumps(res), flush=True)
        return
    if args.phase1:
        for res in profile_phase1(args.against, args.rows, args.dim, args.batch,
                                  args.seed, args.reps):
            res["card"] = smi
            print(json.dumps(res), flush=True)
        return
    if args.backward:
        batches = [args.batch] if batch_given else [16, 8]
        for res in profile_backward(args.against, args.dtype, batches, args.seed, args.reps,
                                    args.hd, args.heads, args.seq):
            res["card"] = smi
            print(json.dumps(res), flush=True)
        return
    if args.train_mesh:
        res = profile_train_mesh(args.tp, args.dtype, args.batch, args.seq, args.seed,
                                 min(args.reps, 10), args.processes)
        res["card"] = smi
        res["cards"] = torch.cuda.device_count()
        print(json.dumps(res), flush=True)
        return
    if args.train:
        res = profile_train(args.batch, args.seq, args.seed, min(args.reps, 10), args.dtype,
                            args.against)
        res["card"] = smi
        print(json.dumps(res), flush=True)
        return
    if args.embed:
        for compute_dtype in args.compute_dtypes.split(","):
            res = profile_embed(compute_dtype, args.batch, args.seq, args.seed,
                                min(args.reps, 10))
            res["card"] = smi
            print(json.dumps(res), flush=True)
            torch.cuda.empty_cache()
        return
    if args.index == "ivf":
        corpus, queries = clustered_corpus(args.rows, args.batch, args.dim, args.centres,
                                   args.seed)
        store = VectorStore(args.dim, "float32")
        store.append(corpus)
        for lists_dtype in args.lists_dtypes.split(","):
            res = profile_ivf(lists_dtype, store, queries, args.k, args.nprobe,
                              args.nlist, args.reps)
            res["card"] = smi
            print(json.dumps(res), flush=True)
            torch.cuda.empty_cache()
        return
    rng = np.random.default_rng(args.seed)
    corpus = rng.standard_normal((args.rows, args.dim), dtype=np.float32)
    queries = rng.standard_normal((args.batch, args.dim), dtype=np.float32)
    if args.mesh:
        for dtype in args.dtypes.split(","):
            res = profile_mesh(dtype, args.mesh, corpus, queries, args.k, args.reps)
            res["card"] = smi
            print(json.dumps(res), flush=True)
            torch.cuda.empty_cache()
        return
    for dtype in args.dtypes.split(","):
        res = profile(dtype, corpus, queries, args.k, args.reps)
        res["card"] = smi
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    for dtype in args.dtypes.split(",") if args.api else ():
        res = profile_api(dtype, corpus, queries, args.k, args.reps)
        res["card"] = smi
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
