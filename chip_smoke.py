#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Needs a CUDA device, PyTorch built for CUDA and nvcc; exits non-zero, and
prints no result, without them. It imports ``minivectordb_tpu_torch`` and
nothing of the JAX package. Every phase must pass; any failure raises.

Phases (one JSON object per output line):
  env        card, versions, seconds the kernel build took; the next line is
             nvidia-smi's "name, power.limit" as it prints them. Fails if
             ptxas spilled in K6-bf16 at hd = 128 or ignored its setmaxnreg,
             or spilled in K6-f32 at any width, or reported a K6-f32 wgmma
             pipeline serialized or a setmaxnreg ignored (C7508 / C7512 /
             C7515); the same for K1-f32's 3xTF32 kernel
             (phase1_tf32_kernel) in each of its three instantiations, and for
             K7-f32's (bwd_dkv_tf32_kernel) and K8-f32's (bwd_dq_tf32_kernel)
             at every head width (C7520 too)
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
  sharded_path  ShardedVectorDatabase() (shard_size 5000, durability
             "shard") with the main path's corpus, queries and oracle, stored
             in pieces of 50,000: 200 shard files (count and one file's
             schema and rows asserted), batch, filtered, single and async
             searches and get_vector spot checks against the oracle, a
             reopen, 1,000 deletes across the corpus; then on the same
             directory 20,000 single-row appends with durability "wal" and
             500 with "wal_fsync", each replayed by a reopen without
             compact() (wal.log gone, hits equal to the oracle over the grown
             corpus); ShardedVectorDatabaseUsearch() over the same corpus
             (distances ascend, top-1 within 0.05 of 1 - cosine, recall@10
             >= 0.9 against the float32 oracle, a reopen gives the same ids);
             ShardedVectorDatabase(index="ivf") over 131,072 rows of the
             mixture (ivf_path's checks, then a reopen that reattaches
             ivf_layout.bin without k-means and gives the same hits); and
             hybrid_rerank_results(device=True) on the card over 1,024
             seeded candidates, some non-ASCII, for a query under 64 bytes
             and one over, against device=False (order equal where the
             host's scores are not tied within 1e-5, scores within 1e-4).
             Prints load, reopen, delete, append and rerank times. Each
             database's searches are counted from 0 (K1-f32 and its masked
             entry, K2, K4-bf16 and K3-bf16 must be launched, and no other).
             The native host fast path (native/fastops.cpp, g++ at first use)
             must build, and by its counters every one of the 20,500 WAL
             appends and the host rerank's hashing and fuzzy ratios (1,025
             and 1,024 calls a query) must go through it
  mesh_path  mesh= (parallel/) through the public classes, with 4 logical
             shards of the card (search_mesh(4, device="cuda:0"), 262,144
             rows each) over the main path's corpus, queries and oracle:
             float32 (ids equal to the oracle's where scores are not tied,
             scores 2e-5) for a 256-query batch, a filtered batch, a batch
             of 8, async handles and 256 appended rows (the incremental sync
             ships one slab, not the corpus); bfloat16 and int8 by recall@10
             against the float32 oracle; each 256-query search launches K1-f32
             (K1-bf16, K2) exactly 4 times; index="ivf" on the mesh over
             131,072 rows of the mixture with bfloat16 and int8 lists and the
             row-sharded rescore (K3-bf16, K5; nprobe = nlist equals the
             oracle); ShardedVectorDatabase(mesh=search_mesh()) over the
             card's devices; init_pod over NCCL as a one-rank world through a
             file:// store and PodScanIndex on a (1, 4) pod mesh against the
             oracle. Prints ms per 256-query batch on the mesh beside the
             same corpus unsharded in this run (logical shards on one card
             run one after the other: no speed-up can show), load and IVF
             build seconds
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
  slots_path  the bundled trained slots, which run heads of 48 (small) and
             128 (large, bgem3): EmbeddingModel(use_quantized_onnx_model=False,
             alternative_model=slot) in float32 and with
             compute_dtype="bfloat16" (MINIVECTORDB_TORCH_WEIGHTS unset for
             the phase: the bundled artifact must serve) on 32 texts of the
             slot's own words for each of the buckets S = 256 and S = 512 (one
             text cut at 512 tokens): K6 of the call's type cfg.layers times a
             call and nothing else; the embeddings against the same module
             with the plain attention and against the class built on the CPU
             (float32 2e-5; bfloat16 2e-2 and a cosine of 0.999); ms per call
             and texts/s on the host clock (median of 5). Then
             models/train_builtin.py's main with --slot small and --slot large
             (4 steps, batch 64, S = 256, float32, --force, into the run's
             temporary directory): K6-f32-lse, K7-f32 and K8-f32 2 x layers
             launches a step each, no bfloat16 launch (asserted); the artifact
             loads through EmbeddingModel; step 1's loss and gradients at the
             slot's config against the plain-attention module
             (train_path's tolerances) on 8 pairs of hashed ids below the
             slot's vocabulary of 4,096, ragged and padded to S = 256
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
  train_path_bf16  the same e5-large training in bfloat16: seeded bfloat16
             weights, bfloat16 activations, gradients and AdamW moments, so
             every encode takes K6-bf16 with its log-sum-exp and the bfloat16
             K7/K8, 48 launches each a step, and no float32 entry point
             (asserted); train_loop's 2 steps with a checkpoint whose leaves
             must all be bfloat16, step 3, then step 3 again from the
             checkpoint, which must repeat it bit for bit (the kernels use no
             atomics). Last, after the counts are read, step 1's gradients
             against a float32 run of the same weights (below)
  train_mesh_path  training on a (dp, tp) = (2, 2) mesh of logical
             positions on the card (train_mesh(4, tp=2, device="cuda:0");
             parallel/tensor_parallel.py) at the e5-large widths, float32
             then bfloat16, from seeded weights and train_batches(3, 8, .):
             the single-device train_loop's 3 steps first (the reference),
             then on the mesh train_loop's 2 steps with the checkpoint
             (gathered into the JAX pytree) at step 2, step 3, and step 3
             again from load_checkpoint(shardings=param_shardings(...)),
             which must repeat it (float32 1e-5, bfloat16 bit for bit); each
             step's loss within 1e-4 of the single-device step's (bfloat16:
             2e-3), every parameter after 3 steps within 2 * lr * steps (+ 4
             bfloat16 ulps), in float32 each leaf's mean within lr / 4 (the
             k bias exempt), step 1's gradients of every leaf within 1e-3
             (bfloat16: 0.25) of the single-device step's, relative (q and
             k: to their layer's v gradient), the dp replicas equal bit for
             bit; K6-lse, K7 and K8 of the run's type 192 launches a step (2
             encodes x 24 layers x 4 positions, each at nh = 8 heads), none
             of the other type (asserted). Then one bfloat16 step on
             train_mesh(pod=True) over a one-rank NCCL group (init_pod through a
             file:// store), equal bit for bit to the single-device step;
             and K6-lse, K7, K8 of both types at one tp shard's shape (4
             sequences, nh = 8, S = 512, hd = 64) against their plain
             versions, timed beside them; the bfloat16 row-parallel partial
             products (tensor cores, float32 out) against the same products
             upcast to float32, both timed. Prints host-clock ms per mesh step
             beside the single-device step (logical positions run one after
             the other: no speed-up can show), checkpoint times, peak memory
  kernels    every kernel instantiation held against its plain PyTorch
             version over its whole output and timed beside it, beside one
             library call, and beside the card's bound: the phase-1 kernels
             (float32, bfloat16, int8; with and without a mask) at
             C = 1,048,576, d = 384, B = 256, count = 1,000,000, after a
             ragged case (d = 24: int8 takes the narrow-row kernel, which the
             library's phase1_route reports and its own counter shows; so
             does float32 at d = 25, on the CUDA-core kernel) and
             the float32 / bf16 / int8 Hopper kernels' tiling edges at
             C = 65,536 (TILING_CASES, emitted on a line of their own; at
             every case each subtile past `count` must be the sentinel); the
             narrow-row kernels must not have run on the flat paths or the
             1M-row case; the K1-f32 rows also give the kernel's, the IEEE
             plain version's and the 3xTF32 emulation's distance to float64
             subtile maxima, the kernel's distance to both plain forms, and
             its registers and spills; the small-batch scan
             (small_scan_f32, csrc/small_scan.cu: the scan with its top-k and
             the merge) at the serial benchmark cell's shape, C = 1,048,576,
             d = 768, count = 1,000,000, kb = 128, B = 1 (and B = 8), against
             its plain version and float64 dots, beside torch.matmul +
             topk_last_axis, the route it replaced;
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
             200 / 129 / 1, S = 333 and 384 at hd = 16, 48, 80 and 128 with
             ragged lengths (K8's ragged last tile and partial column
             groups) and the packed and cyclic ids (there the bf16
             forward's log-sum-exp is held too), beside SDPA's forward and
             its autograd backward (dq, dk, dv in one call: compare it with
             K7 + K8); and K6-bf16 with its log-sum-exp and the bfloat16 K7
             and K8 at the same shape and cases (the backward given
             K6-bf16's output and log-sum-exp; S = 333 and 384 leave tails
             past a 64-row wgmma tile, and are held at hd = 32 and 96 too,
             K8's 64-byte swizzle), beside SDPA's bfloat16 forward and
             backward with the same mask; the bfloat16 K7 / K8 rows also
             give each kernel's registers, spills and blocks an SM at
             hd = 64. Then, report only, the same kernels at the bundled
             slots' head widths, hd = 48 and hd = 128 ("<kernel> hd<hd>"
             rows, each held against its plain version): K6-f32 and K6-bf16
             at the embed call's B = 32, nh = 8, S = 512; K6-lse, K7 and K8 of
             both types at train_builtin's B = 64, nh = 8, S = 256, with
             registers and spills (and blocks an SM for the bfloat16
             backward) at that width; their launches are slots_path's.
             "launches" are the counts of the path phases above: the flat
             phases, and each database of the ivf, sharded and mesh phases, are
             driven through the public class with every count at 0 and read
             just after;
             every launch made to compare a kernel or a route with its plain
             version runs after that read and does not count; each kernel row
             also gives its launches on the mesh path ("mesh_launches") and
             on the training mesh path ("train_mesh_launches")
The last line is {"ok": true, "device": {...}}.

Tolerances. Kernel against plain version, scores of magnitude <= 1: float32
and bfloat16-input 2e-5 (another summation order over 384 float32 terms; the
float32 kernel's 3xTF32 products keep each word to 2^-20 of itself, at most
3 * 2^-20 = 2.9e-6 of a cosine; bf16 products are exact in float32), int8 exactly 0 (integer dots, the same
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

bfloat16 K7 / K8 against the plain backward given the same forward output and
log-sum-exp, per gradient tensor: |kernel - plain| <= 2^-7 * max|plain| + 2e-3.
Both round P and dS * scale to bfloat16 where the TPU kernels do and sum in
float32, but the kernel's P (ex2.approx) and its float32 sums differ from the
plain version's in the last float32 bits, so a value that lies near a bfloat16
rounding boundary can round the other way; an output element moves by at most
about one of its own bfloat16 ulps (2^-7 of the largest value bounds that),
and where a row of dS is pure rounding (a query that sees one key: dP - delta
cancels) both are noise of about 1e-6. Step 1 of the bfloat16 e5-large
training against a float32 run from the same weights (cast: the same values),
distance |g - g_32| / |g_32| per tensor (Frobenius): the kernels' must be at
most 4x the bfloat16 plain-attention module's for every tensor outside the q
and k projections, and the median of those at most 2x. Both bfloat16 routes
share every rounding outside attention (dense layers, layer norms, GELU,
residuals, through 24 layers), which dominates their distance to float32;
inside attention the kernels round P and dS before their sums, the plain
module rounds the attention's outputs and gradients after them, errors of one
size. The q and k projections are measured on the scale of their layer's v
weight's gradient (as above) and held to 4x the distance of the kernels' own
formulation in plain PyTorch and to 2^-4: their gradient reaches them through
dS alone, the TPU kernels round dS to bfloat16 before dQ = dS K and
dK = dS^T Q, and where the deep layers' keys nearly coincide (these random
weights) that rounding leaves a residual of about 2^-9 |dS| |k| against a
cancellation the plain module keeps in float32 (about 1.6e-2 of the v
gradient's scale), so the plain module is no yardstick there.

bound_ms is the larger of (bytes that must move) / 3.35 TB/s and
(operations) / peak, with the H100 SXM data-sheet peaks: 67 TFLOP/s float32
on the CUDA cores, 989 TFLOP/s bf16, 1979 TOP/s int8, 495 TFLOP/s TF32. K6-f32
(with lse or not) forms its products on the tensor cores in 3xTF32, three TF32
products a float32 product: its bound_ms counts 3x its operations at the TF32
peak, and bound_ms_ieee beside it the operations at the float32 peak. Its rows
also give max_abs_err_vs_float64 of the kernel, of the IEEE plain version and
of SDPA against a float64 attention of the same inputs, and the kernel's
distance to flash_attention_3xtf32_plain (its arithmetic in plain PyTorch).
K7-f32 and K8-f32 form theirs in 3xTF32 as well: the same two bounds, and
max_abs_err_vs_float64 (dK and dV, or dQ, against float64_attention_bwd) of
the kernel, the IEEE plain backward, flash_attention_bwd_3xtf32_plain and
SDPA's autograd backward.
K1-f32 and K1-f32-mask run 3xTF32 too (the words as they lie are their TF32
hi, truncated): the same two bounds, and max_abs_err_vs_float64 of the
kernel, the IEEE plain version and subtile_maxima_3xtf32_plain over the first
65,536 rows.
Only the `count` live
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
"multiplied_operations" are 4 * nh * hd (K6; K7 8, K8 6) * (rows x keys of
a tile) * the tiles the kernel visits (ops/flash_attention.py:visited_tiles,
the tiles from tile_shape and bwd_tile_shapes).
"""

import contextlib
import gc
import io
import json
import os
import pickle
import random
import re
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
from minivectordb_tpu_torch import ShardedVectorDatabase  # noqa: E402
from minivectordb_tpu_torch import ShardedVectorDatabaseUsearch  # noqa: E402
from minivectordb_tpu_torch import convert as port_convert  # noqa: E402
from minivectordb_tpu_torch import embedding_model  # noqa: E402
from minivectordb_tpu_torch.core.pipeline import TextSearchPipeline  # noqa: E402
from minivectordb_tpu_torch.kernels import build  # noqa: E402
from minivectordb_tpu_torch.models import configs as model_configs  # noqa: E402
from minivectordb_tpu_torch.models import convert as model_convert  # noqa: E402
from minivectordb_tpu_torch.models import encoder as encoder_mod  # noqa: E402
from minivectordb_tpu_torch.models import train as train_mod  # noqa: E402
from minivectordb_tpu_torch.models import train_builtin  # noqa: E402
from minivectordb_tpu_torch.models.checkpoint import load_checkpoint  # noqa: E402
from minivectordb_tpu_torch.models.tokenizer import HashTokenizer  # noqa: E402
from minivectordb_tpu_torch.native import fastops  # noqa: E402
from minivectordb_tpu_torch.ops import flash_attention as flash_ops  # noqa: E402
from minivectordb_tpu_torch.ops import fused_scan, ivf as ivf_ops  # noqa: E402
from minivectordb_tpu_torch.ops import ivf_probe, scan as scan_ops  # noqa: E402
from minivectordb_tpu_torch.ops import small_scan  # noqa: E402
from minivectordb_tpu_torch.parallel import dist_ivf, multihost  # noqa: E402
from minivectordb_tpu_torch.parallel import tensor_parallel  # noqa: E402
from minivectordb_tpu_torch.parallel.mesh import search_mesh, train_mesh  # noqa: E402
from minivectordb_tpu_torch.profile_search import clustered_corpus  # noqa: E402
from minivectordb_tpu_torch.profile_search import phase1_operands  # noqa: E402

DEV = torch.device("cuda", 0)
SEED = 0
D = 384
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "i8": 1979e12}
# tensor cores, dense TF32: K6-f32 issues three TF32 products a product (3xTF32)
PEAK_TF32_S = 495e12
TOL = {"f32": 2e-5, "bf16": 2e-5, "i8": 0.0}
SHARDED_IVF_ROWS = 131_072  # the sharded phase's index="ivf" corpus
MESH_SHARDS = 4  # mesh_path's logical shards on the one card
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
# bfloat16 K7 / K8 against the plain backward, per gradient tensor:
# |kernel - plain| <= BWD_BF16_REL * max|plain| + BWD_BF16_ABS
TOL_BWD_BF16_REL = 2.0 ** -7
TOL_BWD_BF16_ABS = 2e-3
# bfloat16 step 1 against a float32 run of the same weights (see below): the
# kernels' distance <= GRAD_BF16_FACTOR x the reference route's, per tensor,
# and the median's <= GRAD_BF16_MEDIAN_FACTOR x; the q and k projections'
# distance (over the v weight's gradient) also <= GRAD_BF16_QK_CAP
GRAD_BF16_FACTOR = 4.0
GRAD_BF16_MEDIAN_FACTOR = 2.0
GRAD_BF16_QK_CAP = 2.0 ** -4
SOURCES = build.SOURCES
# what the sharded classes must launch: K1-f32, K2, K4-bf16 and K3-bf16
SHARDED_ENTRY_POINTS = {"phase1_f32", "phase1_i8", "ivf_grouped_bf16", "ivf_probe_bf16"}
# the text path's K6 entry points and the training paths'
TEXT_ENTRY_POINTS = ("flash_attention_f32", "flash_attention_bf16")
TRAIN_ENTRY_POINTS = ("flash_attention_lse_f32", "flash_attention_bwd_dkv_f32",
                      "flash_attention_bwd_dq_f32")
TRAIN_BF16_ENTRY_POINTS = ("flash_attention_lse_bf16", "flash_attention_bwd_dkv_bf16",
                           "flash_attention_bwd_dq_bf16")


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


def kernel_resources() -> dict:
    """{mangled kernel name: "Used N registers, ...; 0 bytes stack frame, S
    bytes spill stores, L bytes spill loads"} from the builds' ptxas -v
    output: ptxas prints "Compiling entry function '<name>'" and, within
    three lines, the spill and register lines."""
    resources = {}
    for name in SOURCES:
        log = build.build_info[name]["log"].splitlines()
        for i, line in enumerate(log):
            if "Compiling entry function" in line:
                used = next((u for u in log[i + 1:i + 4] if "Used" in u), "")
                spills = next((u for u in log[i + 1:i + 4] if "spill" in u), "")
                resources[line.split("'")[1]] = (
                    used.split(":", 1)[-1].strip() + "; " + spills.strip())
    return resources


def ptxas_numbers(text: str) -> dict:
    """Registers a thread and spilled bytes in one of kernel_resources()'s
    texts."""
    nums = {}
    for key, pattern in (("registers", r"Used (\d+) registers"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads")):
        m = re.search(pattern, text)
        assert m, text
        nums[key] = int(m.group(1))
    return nums


def ptxas_of(kernel: str, hd: int) -> dict:
    """Registers a thread and spilled bytes of template kernel ``kernel`` at
    head width ``hd`` (its mangled name holds "<kernel>ILi<hd>E")."""
    want = f"{kernel}ILi{hd}E"
    found = [text for mangled, text in kernel_resources().items() if want in mangled]
    assert len(found) == 1, (want, found)
    return ptxas_numbers(found[0])


def k1_f32_ptxas() -> dict:
    """{"<WG>x<MT>": registers and spills} of each instantiation of K1-f32's
    3xTF32 kernel, phase1_tf32_kernel<WG consumer warpgroups, MT m-tiles>
    (2x2 serves B > 128, 2x1 B <= 128, 1x1 B <= 64)."""
    out = {}
    for mangled, text in kernel_resources().items():
        m = re.search(r"phase1_tf32_kernelILi(\d+)ELi(\d+)E", mangled)
        if m:
            out[f"{m.group(1)}x{m.group(2)}"] = ptxas_numbers(text)
    return out


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
    resources = kernel_resources()
    # K6-bf16 at the large slots' hd = 128 holds o, S and P in registers: its
    # consumer warpgroups take the producer warpgroup's registers
    # (setmaxnreg), which ptxas must not have ignored (C7508), and nothing spills
    k6_hd128 = ptxas_of("flash_bf16_kernel", 128)
    assert k6_hd128["spill_store_bytes"] == 0 and k6_hd128["spill_load_bytes"] == 0, (
        "K6-bf16 spills at hd = 128", k6_hd128)
    assert "C7508" not in build.build_info["flash_attention"]["log"], "ptxas ignored setmaxnreg"
    # K6-f32 (3xTF32 on wgmma, the same register split) spills nothing at any
    # width, and ptxas neither serialized its wgmma pipeline nor ignored its
    # setmaxnreg
    k6_f32 = {hd: ptxas_of("flash_f32_kernel", hd) for hd in flash_ops.HEAD_DIMS}
    spilled = {hd: r for hd, r in k6_f32.items()
               if r["spill_store_bytes"] or r["spill_load_bytes"]}
    assert not spilled, ("K6-f32 spills", spilled)
    pipeline = [line for line in build.build_info["flash_attention"]["log"].splitlines()
                if any(code in line for code in ("C7508", "C7512", "C7515"))
                and ("flash_f32_kernel" in line or "'" not in line)]
    assert not pipeline, ("ptxas serialized K6-f32's wgmma or ignored its setmaxnreg", pipeline)
    # K1-f32 (3xTF32 on wgmma, the producer warpgroup's registers handed to
    # the consumers) spills nothing in any instantiation, and ptxas neither
    # serialized its wgmma pipeline nor ignored its setmaxnreg
    k1_f32 = k1_f32_ptxas()
    assert set(k1_f32) == {"1x1", "2x1", "2x2"}, k1_f32
    spilled = {k: r for k, r in k1_f32.items() if r["spill_store_bytes"] or r["spill_load_bytes"]}
    assert not spilled, ("K1-f32 spills", spilled)
    pipeline = [line for line in build.build_info["phase1"]["log"].splitlines()
                if any(code in line for code in ("C7508", "C7512", "C7515"))
                and ("phase1_tf32_kernel" in line or "'" not in line)]
    assert not pipeline, ("ptxas serialized K1-f32's wgmma or ignored its setmaxnreg", pipeline)
    # K7-f32 and K8-f32 (3xTF32 on wgmma) spill nothing at any width, and
    # ptxas did not serialize their wgmma pipelines (C7512, C7515; C7520:
    # around a warpgroup.arrive it inserted in a divergent path)
    bwd_f32 = {}
    for name, kernel in (("K7-f32", "bwd_dkv_tf32_kernel"), ("K8-f32", "bwd_dq_tf32_kernel")):
        found = bwd_f32[name] = {hd: ptxas_of(kernel, hd) for hd in flash_ops.HEAD_DIMS}
        spilled = {hd: r for hd, r in found.items()
                   if r["spill_store_bytes"] or r["spill_load_bytes"]}
        assert not spilled, (f"{name} spills", spilled)
        pipeline = [line for line in build.build_info["flash_attention_bwd"]["log"].splitlines()
                    if any(code in line for code in ("C7508", "C7512", "C7515", "C7520"))
                    and (kernel in line or "'" not in line)]
        assert not pipeline, (f"ptxas serialized {name}'s wgmma", pipeline)
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
        "k6_bf16_hd128_ptxas": k6_hd128,
        "k6_f32_ptxas": k6_f32,
        "k1_f32_ptxas": k1_f32,
        "k7_f32_ptxas": bwd_f32["K7-f32"],
        "k8_f32_ptxas": bwd_f32["K8-f32"],
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


def phase_main_path(tmp: str) -> tuple:
    """Returns the corpus, the queries and the oracle's top-10, which the
    sharded phase drives again."""
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
    return corpus, queries, want_v, want_i


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


def k1_f32_accuracy(ops, count, mask, rows: int = 65_536) -> dict:
    """K1-f32's subtile maxima beside the IEEE plain version's, each against
    float64 dots of the same inputs over the first ``rows`` rows (every
    query; the same float32 1/norm), and the kernel's distance, over the
    whole output, to the IEEE plain version and to its own arithmetic in
    plain PyTorch (fused_scan.subtile_maxima_3xtf32_plain); and, over a
    copy of those rows whose first B are the queries themselves, the
    kernel's distance to the IEEE plain version on their subtiles."""
    buf, inv, q, _ = ops
    got = run_kernel("f32", ops, count, mask)
    plain = run_plain("f32", ops, count, mask)
    emulated = fused_scan.subtile_maxima_3xtf32_plain(buf, inv, q, count, mask)
    torch.cuda.synchronize()
    live = plain != MASKED
    s64 = (q.double() @ buf[:rows].double().T) * inv[:rows].double()[None, :]
    valid = torch.arange(rows, device=DEV) < count
    if mask is not None:
        valid = valid & mask[:rows]
    want = s64.masked_fill(~valid[None, :], MASKED).reshape(q.shape[0], -1, 32).amax(dim=-1)
    near = want != MASKED
    sub = rows // 32

    def dist(a):
        return float((a[:, :sub][near].double() - want[near]).abs().max())

    res = {"max_abs_err_vs_float64": {"kernel": dist(got), "plain": dist(plain),
                                      "3xtf32_plain": dist(emulated)},
           "max_abs_err_vs_3xtf32_plain": float((got[live] - emulated[live]).abs().max()),
           "max_abs_err_vs_ieee_plain": float((got[live] - plain[live]).abs().max())}
    del got, plain, emulated, s64, want
    # rows equal to the queries (cosine 1; each row keeps its norm): the
    # largest dots, where the tensor cores' accumulation errs the most
    own = buf[:rows].clone()
    own[:q.shape[0]] = q * own[:q.shape[0]].norm(dim=1, keepdim=True)
    own_ops = (own, scan_ops.row_inv_norms(own), q, None)
    sub_own = -(-q.shape[0] // 32)
    got = run_kernel("f32", own_ops, rows, None)[:, :sub_own]
    plain = run_plain("f32", own_ops, rows, None)[:, :sub_own]
    res["self_match_max_abs_err_vs_ieee_plain"] = float((got - plain).abs().max())
    assert res["self_match_max_abs_err_vs_ieee_plain"] <= TOL["f32"], res
    del own, own_ops, got, plain
    torch.cuda.empty_cache()
    return res


# The Hopper kernels' edges (csrc/phase1.cu, phase1_wgmma_kernel for bf16 and
# int8, phase1_tf32_kernel for float32), each held against the plain version,
# with and without a mask, at a small C: B below one warpgroup's 64 (float32:
# one warpgroup of one m-tile), not a multiple of 64 (float32: two warpgroups
# of two m-tiles, 56 queries past B), and eight query blocks (bf16) / four
# (int8, float32); wide rows (queries per block shrink, 128-row tiles; bf16 at
# 1,536 streams its queries; float32 streams its queries at every width); C
# not a multiple of the tile; `count` inside the last live tile in every case.
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
        for kind in ("f32", "bf16", "i8"):
            for m in (None, mask):
                what = f"tiling {kind} C={c} d={d} B={b} count={count}" + (
                    " mask" if m is not None else "")
                err, _, _ = compare(kind, cases[kind], count, m, what)
                out.append({"case": [c, d, b, count], "kind": kind, "mask": m is not None,
                            "max_abs_err": err, "tolerance": TOL[kind]})
        del cases, mask
    return out


def small_scan_library(buf, inv, q, count, kb):
    """The route the port took before csrc/small_scan.cu: one library product
    into the whole (B, C) score matrix, the scale and mask, topk_last_axis.
    The port never calls this on a CUDA float32 buffer."""
    s = torch.matmul(scan_ops._normalize(q), buf.T) * inv[None, :]
    valid = torch.arange(buf.shape[0], device=DEV) < count
    vals, idx = scan_ops.topk_last_axis(s.masked_fill(~valid[None, :], MASKED), kb)
    return vals, idx.to(torch.int32)


def small_scan_kernel_rows(launches: dict) -> list:
    """The small-batch scan (csrc/small_scan.cu: the scan and its merge) at
    the serial benchmark cell's shape, C = 1,048,576, d = 768, count =
    1,000,000, kb = 128, B = 1 (and B = 8 beside it), held against its plain
    version and float64 dots over the whole output; its bound is the live
    rows, their scales and the queries read once, the (value, id) pairs
    written once."""
    c, d, count, kb = 1 << 20, 768, 1_000_000, 128
    g = torch.Generator(device=DEV).manual_seed(SEED + 25)
    buf = torch.randn((c, d), device=DEV, generator=g)
    buf[count:] = 0.0
    inv = scan_ops.row_inv_norms(buf)
    q8 = torch.randn((8, d), device=DEV, generator=g)
    rows = []
    for b in (1, 8):
        q = q8[:b].contiguous()
        got = small_scan.small_scan_topk(buf, inv, q, count, kb)
        want = small_scan.small_scan_plain(buf, inv, q, count, kb)
        torch.cuda.synchronize()
        err = float((got[0] - want[0]).abs().max())
        assert err <= TOL["f32"], ("small_scan_f32", b, err)
        s64 = (scan_ops._normalize(q).double() @ buf[:count].double().T) * inv[:count].double()
        own = torch.gather(s64, 1, got[1].long())
        err64 = float((own - got[0].double()).abs().max())
        rank64 = float((torch.topk(s64, kb, dim=1).values - own).max())
        assert err64 <= TOL["f32"] and rank64 <= TOL["f32"], (b, err64, rank64)
        del s64, own
        same_ids = float((got[1] == want[1]).double().mean())
        plain_a = event_ms(lambda: small_scan.small_scan_plain(buf, inv, q, count, kb), 5)
        ms_a = event_ms(lambda: small_scan.small_scan_topk(buf, inv, q, count, kb), 20)
        ms_b = event_ms(lambda: small_scan.small_scan_topk(buf, inv, q, count, kb), 20)
        plain_b = event_ms(lambda: small_scan.small_scan_plain(buf, inv, q, count, kb), 5)
        lib = event_ms(lambda: small_scan_library(buf, inv, q, count, kb), 5)
        n_bytes = count * d * 4 + count * 4 + b * d * 4 + b * kb * 8
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = 2 * b * count * d / PEAK_OPS_S["f32"] * 1e3
        rows.append({
            "name": "small_scan_f32" + ("" if b == 1 else f" B{b}"),
            "route": "cuda",
            "source": "minivectordb_tpu_torch/csrc/small_scan.cu",
            "replaces": "none (minivectordb_tpu/ops/scan.py:scan_topk is left to XLA)",
            "launches": launches["small_scan_f32"] if b == 1 else 0,
            "max_abs_err": err,
            "tolerance": TOL["f32"],
            "max_abs_err_vs_float64": err64,
            "rank_gap_vs_float64": rank64,
            "same_ids_as_plain": same_ids,
            "ms": statistics.median([ms_a, ms_b]),
            "plain_ms": statistics.median([plain_a, plain_b]),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib,
            "library": "torch.matmul + topk_last_axis",
            "shape": {"C": c, "d": d, "B": b, "count": count, "kb": kb},
        })
    del buf, inv, q8
    torch.cuda.empty_cache()
    return rows


def phase_kernels(launches: dict, small_launches: dict, ivf_shapes: dict, ivf_launches: dict,
                  k6_launches: dict, train_launches: dict, train_bf16_launches: dict,
                  slot_launches: dict) -> dict:
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
    assert narrow["phase1_f32"] == 0 and narrow["phase1_f32_mask"] == 0, narrow
    # float32 rows TMA cannot describe (d = 25, 100 bytes) take the CUDA-core
    # kernel, which phase1_route reports and NARROW_LAUNCHES counts
    mask_n, cases_n = phase1_operands(4096, 25, 8, SEED + 5)
    for m in (None, mask_n):
        err, _, _ = compare("f32", cases_n["f32"], 4000, m, "ragged f32 d=25")
        ragged["f32_narrow" + ("_mask" if m is not None else "")] = err
    del cases_n, mask_n
    narrow = dict(fused_scan.NARROW_LAUNCHES)
    assert narrow["phase1_f32"] == 1 and narrow["phase1_f32_mask"] == 1, narrow
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
            extra = {}
            if kind == "f32":  # 3xTF32: three TF32 products a product, at the TF32 peak
                extra = {"bound_ms_ieee": max(t_bytes, t_ops),
                         **k1_f32_accuracy(ops, count, m),
                         "ptxas_2x2": k1_f32_ptxas()["2x2"],
                         "ragged_narrow_max_abs_err": ragged["f32_narrow" + suffix]}
                t_ops = 3 * 2 * b * count * D / PEAK_TF32_S * 1e3
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
                **extra,
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
    kernels += small_scan_kernel_rows(small_launches)
    kernels += ivf_kernel_rows(ivf_shapes, ivf_launches)
    kernels += encoder_kernel_rows(k6_launches)
    kernels += train_kernel_rows(train_launches)
    kernels += train_bf16_kernel_rows(train_bf16_launches)
    kernels += slot_kernel_rows(slot_launches)
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


# ---------------------------------------------------------------------------
# sharded path: the sharded classes (shard files, WAL, IVF sidecar) and the
# device rerank
# ---------------------------------------------------------------------------

SHARD_SCHEMA = {"embeddings", "metadata", "unique_ids", "inverted_index"}


def shard_files(folder: str) -> list:
    return sorted(f for f in os.listdir(folder) if re.fullmatch(r"shard_\d+\.pkl", f))


def read_fused_launches(want: set, what: str) -> dict:
    """The phase-1 counts since the last reset: exactly the entry points in
    ``want`` launched, and never the narrow-row kernel."""
    got = dict(fused_scan.LAUNCHES)
    assert {n for n, c in got.items() if c > 0} == want, (what, got)
    assert not any(fused_scan.NARROW_LAUNCHES.values()), (what, fused_scan.NARROW_LAUNCHES)
    return got


def fresh(cls, **kw):
    """A sharded database through its public constructor; the int8 class
    prints a banner, kept off the result lines."""
    with contextlib.redirect_stdout(io.StringIO()):
        return cls(**kw)


def free_card() -> None:
    """After the caller dropped its database: its buffers go back to the card."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def append_rows(db, first_uid: int, rows: np.ndarray) -> float:
    """One store_embedding a row (the WAL's per-record path); seconds."""
    t0 = time.perf_counter()
    for i in range(rows.shape[0]):
        db.store_embedding(first_uid + i, rows[i], {"bucket": (first_uid + i) % 16})
    return time.perf_counter() - t0


def sharded_f32_and_wal(tmp: str, corpus, queries, want_v, want_i, k: int) -> dict:
    """(a) write-through float32 at the main path's corpus; (b) the WAL."""
    n, b = corpus.shape[0], queries.shape[0]
    buckets = np.arange(n) % 16
    folder = os.path.join(tmp, "shards_f32")
    out = {}
    fused_scan.reset_launches()
    db = ShardedVectorDatabase(storage_dir=folder)
    assert db.shard_size == 5000 and db.durability == "shard"
    out["load_s"] = load_db(db, corpus, pieces=n // 50_000)
    files = shard_files(folder)
    assert len(files) == n // 5000 and sorted(os.listdir(folder)) == files, len(files)
    with open(os.path.join(folder, "shard_7.pkl"), "rb") as f:
        data = pickle.load(f)
    assert set(data) == SHARD_SCHEMA and data["embeddings"].dtype == np.float32
    assert data["unique_ids"] == list(range(35_000, 40_000))
    assert np.array_equal(data["embeddings"], corpus[35_000:40_000])
    assert data["metadata"] == [{"bucket": i % 16} for i in range(35_000, 40_000)]
    assert data["inverted_index"] == {"bucket": set(range(35_000, 40_000))}
    del data

    t0 = time.perf_counter()
    first = db.find_most_similar_batch(queries, k=k)  # uploads the corpus
    out["first_search_s"] = time.perf_counter() - t0
    check_hits(first, want_v, want_i, "sharded batch")
    res, out["batch_256_ms_median"] = timed_batches(db, queries, k)
    check_hits(res, want_v, want_i, "sharded batch, repeated")
    filt = db.find_most_similar_batch(queries, k=k, metadata_filter={"bucket": 3})
    fv, fi = oracle_topk(corpus, queries, k, keep=buckets == 3)
    check_hits(filt, fv, fi, "sharded filtered batch")
    assert all(md["bucket"] == 3 for _i, _s, mds in filt for md in mds)
    ids, scores, _ = db.find_most_similar(queries[0], k=k)
    check_hits([(ids, scores, None)], want_v[:1], want_i[:1], "sharded single query")
    handles = [db.find_most_similar_batch_async(queries[j * 64:(j + 1) * 64], k=k)
               for j in range(4)]
    for j, h in enumerate(handles):
        check_hits(h.result(), want_v[j * 64:(j + 1) * 64],
                   want_i[j * 64:(j + 1) * 64], f"sharded async handle {j}")
    for uid in (0, 4_999, 5_000, n // 2 + 7, n - 1):  # read from its shard file
        assert np.array_equal(db.get_vector(uid), corpus[uid]), uid
    st = db.stats()
    assert st["shards"] == n // 5000 and st["count"] == n, st
    del db
    free_card()

    t0 = time.perf_counter()
    db = ShardedVectorDatabase(storage_dir=folder)
    out["reopen_s"] = time.perf_counter() - t0
    check_hits(db.find_most_similar_batch(queries, k=k), want_v, want_i, "after reopen")

    # 1,000 ids across the corpus, every query's best hit among them
    doomed = np.unique(want_i[:, 0])
    others = np.setdiff1d(np.random.default_rng(SEED + 21).choice(n, 4000, replace=False),
                          doomed)
    doomed = np.concatenate([doomed, others[: 1000 - doomed.size]])
    assert doomed.size == 1000
    t0 = time.perf_counter()
    db.delete_embeddings_batch(doomed.tolist())
    out["delete_1000_s"] = time.perf_counter() - t0
    out["delete_shards_rewritten"] = int(np.unique(doomed // 5000).size)
    keep = np.ones(n, dtype=bool)
    keep[doomed] = False
    dv, di = oracle_topk(corpus, queries, k, keep=keep)
    after = db.find_most_similar_batch(queries, k=k)
    check_hits(after, dv, di, "sharded after delete")
    gone = set(doomed.tolist())
    assert not any(i in gone for ids, _s, _m in after for i in ids)
    del db
    free_card()

    # (b) the WAL: 20,000 appends (the queries first), reopen without
    # compact(): replayed, wal.log gone, the oracle over the grown corpus
    wal_path = os.path.join(folder, "wal.log")
    extra = np.random.default_rng(SEED + 22).standard_normal((20_500, D), dtype=np.float32)
    extra[:b] = queries
    db = ShardedVectorDatabase(storage_dir=folder, durability="wal")
    wal_s = append_rows(db, n, extra[:20_000])
    # the shard files wait for the replay: 200 of them, the 4 new ones unwritten
    assert os.path.getsize(wal_path) > 0 and len(shard_files(folder)) == n // 5000
    del db
    free_card()
    t0 = time.perf_counter()
    db = ShardedVectorDatabase(storage_dir=folder, durability="wal")
    out["wal_reopen_replay_s"] = time.perf_counter() - t0
    assert not os.path.exists(wal_path) and len(shard_files(folder)) == n // 5000 + 4
    assert db.stats()["count"] == n - 1000 + 20_000
    full = np.concatenate([corpus, extra[:20_000]])
    keep = np.concatenate([keep, np.ones(20_000, dtype=bool)])
    gv, gi = oracle_topk(full, queries, k, keep=keep)
    grown = db.find_most_similar_batch(queries, k=k)
    check_hits(grown, gv, gi, "after WAL replay")
    assert [r[0][0] for r in grown] == list(range(n, n + b)), "replayed rows not found"

    # 500 rows with an fsync a record, the same check
    del db
    free_card()
    db = ShardedVectorDatabase(storage_dir=folder, durability="wal_fsync")
    fsync_s = append_rows(db, n + 20_000, extra[20_000:])
    del db
    free_card()
    t0 = time.perf_counter()
    db = ShardedVectorDatabase(storage_dir=folder, durability="wal_fsync")
    out["wal_fsync_reopen_replay_s"] = time.perf_counter() - t0
    assert not os.path.exists(wal_path)
    full = np.concatenate([full, extra[20_000:]])
    keep = np.concatenate([keep, np.ones(500, dtype=bool)])
    gv, gi = oracle_topk(full, queries, k, keep=keep)
    check_hits(db.find_most_similar_batch(queries, k=k), gv, gi, "after WAL fsync replay")
    assert np.array_equal(db.get_vector(n + 20_499), extra[20_499])
    out["wal_s_per_1000_appends"] = wal_s / 20
    out["wal_fsync_s_per_1000_appends"] = fsync_s / 0.5
    out["launches"] = read_fused_launches({"phase1_f32", "phase1_f32_mask"}, "float32 sharded")
    del db
    free_card()
    shutil.rmtree(folder)
    out["checked"] = [f"{n // 5000} shard files, shard_7.pkl's schema and rows", "batch",
                      "filtered", "single", "async x4", "get_vector from shard files",
                      "reopen", "1000 deletes", "WAL replay of 20000 appends",
                      "wal_fsync replay of 500 appends"]
    return out


def sharded_int8(tmp: str, corpus, queries, want_v, want_i, k: int) -> dict:
    """(c) ShardedVectorDatabaseUsearch at the main path's corpus."""
    folder = os.path.join(tmp, "shards_i8")
    fused_scan.reset_launches()
    db = fresh(ShardedVectorDatabaseUsearch, storage_dir=folder)
    out = {"load_s": load_db(db, corpus, pieces=corpus.shape[0] // 50_000)}
    t0 = time.perf_counter()
    res = db.find_most_similar_batch(queries, k=k)
    out["first_search_s"] = time.perf_counter() - t0
    top1_err = 0.0
    for b, (ids, dists, _md) in enumerate(res):
        assert len(ids) == k and all(dists[i] <= dists[i + 1] + 1e-6 for i in range(k - 1)), b
        top1_err = max(top1_err, abs(dists[0] - (1.0 - float(want_v[b, 0]))))
    assert top1_err < 0.05, top1_err
    out["top1_distance_max_abs_err"] = top1_err
    out["recall_at_10"] = recall_at_k(res, want_i)
    assert out["recall_at_10"] >= 0.9, out["recall_at_10"]
    _again, out["batch_256_ms_median"] = timed_batches(db, queries, k)
    single = db.find_most_similar(queries[0], k=k)
    assert single[0][0] == res[0][0][0] and list(single[1]) == sorted(single[1])
    del db
    free_card()
    t0 = time.perf_counter()
    db = fresh(ShardedVectorDatabaseUsearch, storage_dir=folder)
    out["reopen_s"] = time.perf_counter() - t0
    assert [r[0] for r in db.find_most_similar_batch(queries, k=k)] == [r[0] for r in res]
    out["launches"] = read_fused_launches({"phase1_i8"}, "int8 sharded")
    del db
    free_card()
    shutil.rmtree(folder)
    return out


def sharded_ivf(tmp: str, k: int, path_launches: dict) -> dict:
    """(d) index="ivf": build, batches of 256 (K4-bf16) and 8 (K3-bf16),
    then reopen: the layout comes back from ivf_layout.bin, no k-means."""
    corpus, queries = mixture(SHARDED_IVF_ROWS, 256, SEED + 23)
    folder = os.path.join(tmp, "shards_ivf")
    ivf_probe.reset_launches()
    db = ShardedVectorDatabase(storage_dir=folder, index="ivf")
    assert db._engine.ivf_opts["nlist"] == 1024 and db.nprobe == 32
    load_s = load_db(db, corpus, pieces=8)
    out = ivf_common_checks(db, corpus, queries, k, "bfloat16")
    out["load_s"] = load_s
    assert os.path.exists(os.path.join(folder, "ivf_layout.bin"))
    want = db.find_most_similar_batch(queries, k=k)
    want8 = db.find_most_similar_batch(queries[:8], k=k)
    del db
    free_card()
    t0 = time.perf_counter()
    db = ShardedVectorDatabase(storage_dir=folder, index="ivf")
    out["reopen_s"] = time.perf_counter() - t0
    assert db.stats()["ivf"]["pending_attach"]
    t0 = time.perf_counter()
    got = db.find_most_similar_batch(queries, k=k)
    out["reopen_first_search_s"] = time.perf_counter() - t0
    assert [r[0] for r in got] == [r[0] for r in want], "reopen ids"
    assert [r[0] for r in db.find_most_similar_batch(queries[:8], k=k)] == [r[0] for r in want8]
    ops = db.stats()["ops"]
    assert "ivf_build" not in ops and ops["ivf_attach"]["count"] == 1, ops
    out["launches"] = read_path_launches(path_launches, "bfloat16")
    out["checked"] += ["ivf_layout.bin written", "reopen reattaches without k-means",
                       "same hits after reopen (batch 256, batch 8)"]
    del db
    free_card()
    shutil.rmtree(folder)
    return out


def rerank_texts(n: int, seed: int) -> list:
    """n seeded texts of 20-300 characters; one in eight holds non-ASCII
    characters."""
    rng = random.Random(seed)
    words = ["vector", "search", "shard", "index", "query", "kernel", "device",
             "ranking", "fuzzy", "hash", "the", "of", "and", "a", "database"]
    odd = ["naïve", "café", "Größe", "résumé", "über", "日本"]
    texts = []
    for i in range(n):
        pool = words + odd if i % 8 == 0 else words
        t = ""
        target = rng.randint(20, 300)
        while len(t) < target:
            t += rng.choice(pool) + " "
        texts.append(t[:target])
    return texts


def sharded_rerank(db) -> dict:
    """(e) hybrid_rerank_results(device=True) on the card against the host
    path (device=False): the same order where the host's scores are not
    tied within 1e-5, scores within 1e-4. Each route is timed once, on the
    host clock (the device route ends in its copy back); the host's pure
    Python hashing and fuzzy ratios make repeats costly."""
    texts = rerank_texts(1024, SEED + 24)
    scores = np.random.default_rng(SEED + 25).random(1024).tolist()
    out = {"candidates": len(texts), "non_ascii": sum(not t.isascii() for t in texts)}
    db.hybrid_rerank_results(texts[:32], scores[:32], "warm up", k=1, device=True)
    for name, query in (("query_short", "fuzzy vector search"),
                        ("query_long", "a ranking of shard index queries by the "
                                       "device kernel and the fuzzy hash of a database")):
        qb = len(query.encode())
        assert (qb < 64) == (name == "query_short"), qb
        ranked, ms = {}, {}
        for route, flag in (("device", True), ("host", False)):
            fastops.reset_calls()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ranked[route] = db.hybrid_rerank_results(texts, scores, query, k=len(texts),
                                                     device=flag)
            ms[route] = (time.perf_counter() - t0) * 1e3
        # the host route hashed the query and every text, and took every
        # fuzzy ratio, through the native library (its counters)
        native = dict(fastops.CALLS)
        assert native["hash_ngrams"] == len(texts) + 1, native
        assert native["partial_ratio"] == len(texts), native
        dev, host = ranked["device"], ranked["host"]
        dv, hv = np.asarray(dev[1]), np.asarray(host[1])
        err = float(np.abs(dv - hv).max())
        assert len(dev[0]) == len(texts) and err <= 1e-4, (name, err)
        swaps = [j for j, (a, w) in enumerate(zip(dev[0], host[0])) if a != w]
        for j in swaps:  # only between host scores tied within 1e-5
            near = [abs(hv[j] - hv[i]) for i in (j - 1, j + 1) if 0 <= i < hv.size]
            assert min(near) <= 1e-5, (name, j)
        out[name] = {"query_bytes": qb, "max_abs_err": err, "order_swaps_within_ties": len(swaps),
                     "device_ms": ms["device"], "host_ms": ms["host"],
                     "host_native_calls": native}
    return out


def phase_sharded_path(tmp: str, main_data: tuple) -> dict:
    """ShardedVectorDatabase and ShardedVectorDatabaseUsearch through their
    public methods at the main path's corpus, index="ivf" on a mixture, and
    the device rerank. Returns the launch counts of the classes' searches:
    every count is set to 0 before each database and read after its last
    call."""
    t_phase = time.perf_counter()
    corpus, queries, want_v, want_i = main_data
    (n, _d), b, k = corpus.shape, queries.shape[0], want_i.shape[1]
    out = {"phase": "sharded_path", "rows": n, "dim": D, "batch": b, "k": k,
           "shard_size": 5000}
    # the native host fast path (native/fastops.cpp) builds with g++ at
    # first use; the WAL appends and the host rerank must go through it
    t0 = time.perf_counter()
    native = fastops.available()
    assert native, native.detail
    out["native"] = {"library": os.path.relpath(native.detail),
                     "first_use_build_s": time.perf_counter() - t0}
    fastops.reset_calls()
    out["float32"] = sharded_f32_and_wal(tmp, corpus, queries, want_v, want_i, k)
    out["native"]["wal_appends"] = fastops.CALLS["wal_append"]
    assert fastops.CALLS["wal_append"] == 20_500, fastops.CALLS  # 20,000 "wal", 500 "wal_fsync"
    out["int8"] = sharded_int8(tmp, corpus, queries, want_v, want_i, k)
    del corpus
    ivf_launches = {}
    out["ivf_bfloat16"] = sharded_ivf(tmp, k, ivf_launches)
    rerank_db = ShardedVectorDatabase(storage_dir=os.path.join(tmp, "shards_rerank"))
    out["rerank"] = sharded_rerank(rerank_db)
    launches = {}
    for counts in (out["float32"]["launches"], out["int8"]["launches"], ivf_launches):
        for name, count in counts.items():
            if count:
                launches[name] = launches.get(name, 0) + count
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


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
# mesh path: mesh= through the public classes (parallel/), logical shards
# on the one card, and a one-rank NCCL pod
# ---------------------------------------------------------------------------

# the entry points each mesh database must launch, and the only ones
MESH_ENTRY_POINTS = {
    "float32": {"phase1_f32"}, "bfloat16": {"phase1_bf16"}, "int8": {"phase1_i8"},
    "ivf_bfloat16": {"ivf_probe_bf16"}, "ivf_int8": {"ivf_grouped_i8"},
}
# kernel row name -> the entry point whose mesh launches it reports
MESH_ROW_ENTRY = {
    "K1-f32": "phase1_f32", "K1-f32-mask": "phase1_f32_mask",
    "K1-bf16": "phase1_bf16", "K1-bf16-mask": "phase1_bf16_mask",
    "K2-int8": "phase1_i8", "K2-int8-mask": "phase1_i8_mask",
    "K3-f32": "ivf_probe_f32", "K3-bf16": "ivf_probe_bf16",
    "K4-f32": "ivf_grouped_f32", "K4-bf16": "ivf_grouped_bf16",
    "K5-int8": "ivf_grouped_i8",
}


def reset_all_launches() -> None:
    fused_scan.reset_launches()
    ivf_probe.reset_launches()


def read_mesh_launches(total: dict, want: set, what: str) -> dict:
    """The phase-1 and probe counts since the last reset: exactly the entry
    points in ``want`` launched, the narrow-row kernel never. Adds them to
    ``total``."""
    got = {n: c for n, c in {**fused_scan.LAUNCHES, **ivf_probe.LAUNCHES}.items() if c}
    assert set(got) == want, (what, got)
    assert not any(fused_scan.NARROW_LAUNCHES.values()), (what, fused_scan.NARROW_LAUNCHES)
    for name, count in got.items():
        total[name] = total.get(name, 0) + count
    return got


def one_search_launches(db, queries, k, entry: str) -> int:
    """Launches of ``entry`` by one 256-query search, counted from 0 (the
    caller reads its path's counts before and resets after)."""
    reset_all_launches()
    db.find_most_similar_batch(queries, k=k)
    return {**fused_scan.LAUNCHES, **ivf_probe.LAUNCHES}[entry]


def hits_arrays(results) -> tuple:
    """(scores (B, k) float32, ids (B, k) int64) of a class's results."""
    return (np.asarray([r[1] for r in results], np.float32),
            np.asarray([r[0] for r in results], np.int64))


def unsharded_hits(tmp, dtype, corpus, queries, k) -> dict:
    """The same corpus in the same device_dtype without a mesh, in this run:
    its batch, filtered batch and batch of 8 (the hits the mesh must give,
    since it stores the same bytes and its per-shard candidates cover the
    flat store's), and its ms per 256-query batch."""
    db = VectorDatabase(storage_file=os.path.join(tmp, f"unsharded_{dtype}.pkl"),
                        device_dtype=dtype)
    load_db(db, corpus, pieces=4)
    db.find_most_similar_batch(queries, k=k)
    res, ms = timed_batches(db, queries, k)
    out = {"batch": hits_arrays(res), "ms": ms,
           "filtered": hits_arrays(db.find_most_similar_batch(
               queries, k=k, metadata_filter={"bucket": 3})),
           "eight": hits_arrays(db.find_most_similar_batch(queries[:8], k=k))}
    del db, res
    free_card()
    return out


def hold_scan_shards(snap, queries, what: str) -> dict:
    """Every shard's row block of a mesh snapshot through the phase-1 kernel
    its searches launch (K1-f32, K1-bf16 or K2), at the shapes the mesh gives
    it, against the plain version at TOL: unmasked, and with the shard's
    slice of the filtered batch's mask (bucket 3; row r has bucket r % 16).
    Returns the largest error of each shard."""
    kind = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}[snap.dtype]
    lr = snap.local_rows
    q = torch.from_numpy(queries).to(DEV)
    if kind == "i8":
        qk, qinv = scan_ops.quantize_queries_int8(q)
    else:
        qk, qinv = scan_ops._normalize(q).to(snap.dtype).contiguous(), None
    keep = np.zeros(snap.capacity, dtype=bool)
    keep[: snap.count] = np.arange(snap.count) % 16 == 3
    errs = {}
    for j, (s, dev) in enumerate(snap.shards):
        count = min(max(snap.count - s * lr, 0), lr)
        if count == 0:
            continue  # its search scans nothing and launches no kernel
        ops = (snap.bufs[j], snap.inv_norms[j], qk.to(dev),
               None if qinv is None else qinv.to(dev))
        mask = scan_ops.to_device(keep[s * lr:(s + 1) * lr], dev)
        errs[str(s)] = max(
            compare(kind, ops, count, m, f"{what} shard {s}" + (" mask" if m is not None else ""))[0]
            for m in (None, mask))
    return errs


def hold_ivf_shards(snap, queries, what: str) -> dict:
    """Every shard's lists of a mesh IVF snapshot, probed as its search
    probes them at the index's default nprobe, through K3 (float32 /
    bfloat16 lists) or K5 (int8 lists, on group_pairs' groups) against the
    plain version at TOL. Returns the error of each shard."""
    q = scan_ops._normalize(torch.from_numpy(queries).to(DEV))
    p = snap.probe_width()
    errs = {}
    for j, (s, dev) in enumerate(snap.shards):
        lists, _ids, valid = (t[j] for t in snap.tables)
        qn = q.to(dev)
        probe = snap.shard_probe(j, qn, p)
        if lists.dtype == torch.int8:
            kind = "i8"
            qi, qinv = ivf_probe.quantize_queries_ivf(qn)
            g = int(min(ivf_probe.GROUP_MAX, max(8, probe.numel())))
            step_list, step_q, _ps, _pl = ivf_probe.group_pairs(probe, int(lists.shape[0]), g)
            args = (lists, qi.to(torch.int8)[step_q], step_list, valid,
                    snap.list_inv[j], qinv[step_q])
            got = ivf_probe.grouped_scores_q(*args)
            torch.cuda.synchronize()
            want = ivf_probe.grouped_scores_q_plain(*args)
        else:
            kind = "bf16" if lists.dtype == torch.bfloat16 else "f32"
            args = (lists, qn.to(lists.dtype).contiguous(), probe.to(torch.int32))
            got = ivf_probe.probe_scores(*args)
            torch.cuda.synchronize()
            want = ivf_probe.probe_scores_plain(*args)
        errs[str(s)] = compare_ivf(f"{what} shard {s}", kind, got, want)[0]
    return errs


def mesh_flat(tmp, dtype, corpus, queries, want_v, want_i, k, total, flat) -> dict:
    """(a) float32 / (b) bfloat16, int8: VectorDatabase(mesh=4 logical shards
    of the card) over the main path's corpus. ``flat`` holds the unsharded
    store's hits in the same dtype (unsharded_hits)."""
    n, b = corpus.shape[0], queries.shape[0]
    buckets = np.arange(n) % 16
    reset_all_launches()
    db = VectorDatabase(storage_file=os.path.join(tmp, f"mesh_{dtype}.pkl"),
                        device_dtype=dtype, mesh=search_mesh(MESH_SHARDS, device=DEV))
    assert db._engine.device == DEV
    out = {"unsharded_batch_256_ms_median": flat["ms"], "load_s": load_db(db, corpus, pieces=4)}
    t0 = time.perf_counter()
    first = db.find_most_similar_batch(queries, k=k)  # ships the row blocks
    out["first_search_s"] = time.perf_counter() - t0
    dist = db._engine._dist
    assert dist.capacity == MESH_SHARDS * dist.local_rows >= n, dist.capacity
    out["shard_rows"] = dist.local_rows
    res, out["batch_256_ms_median"] = timed_batches(db, queries, k)
    assert [r[0] for r in res] == [r[0] for r in first]
    filt = db.find_most_similar_batch(queries, k=k, metadata_filter={"bucket": 3})
    assert all(md["bucket"] == 3 for _i, _s, mds in filt for md in mds)
    fv, fi = oracle_topk(corpus, queries, k, keep=buckets == 3)
    eight, out["batch_8_ms_median"] = timed_batches(db, queries[:8], k)
    handles = [db.find_most_similar_batch_async(queries[j * 64:(j + 1) * 64], k=k)
               for j in range(4)]
    pending = [h.result() for h in handles]
    # the same bytes as the unsharded store: its hits, in every dtype
    check_hits_tied(first, *flat["batch"], f"mesh {dtype} batch vs unsharded")
    check_hits_tied(res, *flat["batch"], f"mesh {dtype} timed batch vs unsharded")
    check_hits_tied(filt, *flat["filtered"], f"mesh {dtype} filtered vs unsharded")
    check_hits_tied(eight, *flat["eight"], f"mesh {dtype} batch of 8 vs unsharded")
    check_hits_tied([r for h in pending for r in h], *flat["batch"],
                    f"mesh {dtype} async vs unsharded")
    if dtype == "float32":
        check_hits_tied(first, want_v, want_i, "mesh batch")
        check_hits_tied(filt, fv, fi, "mesh filtered batch")
        check_hits_tied(eight, want_v[:8], want_i[:8], "mesh batch of 8")
        for j, got in enumerate(pending):
            check_hits_tied(got, want_v[j * 64:(j + 1) * 64],
                            want_i[j * 64:(j + 1) * 64], f"mesh async handle {j}")
        # append the queries themselves: the incremental sync ships one
        # 256-row slab, not the corpus, and each query finds its own row
        before = dist.bytes_uploaded
        db.store_embeddings_batch(list(range(n, n + b)), queries,
                                  [{"bucket": i % 16} for i in range(n, n + b)])
        grown = db.find_most_similar_batch(queries, k=k)
        out["append_256_bytes_uploaded"] = dist.bytes_uploaded - before
        assert 0 < out["append_256_bytes_uploaded"] <= b * D * 4, out
        assert [r[0][0] for r in grown] == list(range(n, n + b)), "appended rows not found"
        assert dist.bytes_uploaded - before < n * D * 4
    else:
        out["recall_at_10_async"] = recall_at_k([r for h in pending for r in h], want_i)
        out["recall_at_10"] = recall_at_k(res, want_i)
        out["recall_at_10_filtered"] = recall_at_k(filt, fi)
        out["recall_at_10_batch_8"] = recall_at_k(eight, want_i[:8])
        assert min(out["recall_at_10"], out["recall_at_10_filtered"],
                   out["recall_at_10_async"]) >= 0.9, out
    entry = {"float32": "phase1_f32", "bfloat16": "phase1_bf16", "int8": "phase1_i8"}[dtype]
    want_entries = MESH_ENTRY_POINTS[dtype] | {entry + "_mask"}
    out["launches"] = read_mesh_launches(total, want_entries, f"mesh {dtype}")
    out["launches_one_256_search"] = one_search_launches(db, queries, k, entry)
    assert out["launches_one_256_search"] == MESH_SHARDS, out
    out["shard_max_abs_err"] = hold_scan_shards(dist.snapshot(), queries, f"mesh {dtype}")
    reset_all_launches()
    del db, dist
    free_card()
    return out


def mesh_ivf(tmp, lists_dtype, k, total) -> dict:
    """(c) index="ivf" on the mesh: f32 engine, quantized lists, so the
    rescore runs row-sharded against the mesh's exact-scan blocks."""
    corpus, queries = mixture(SHARDED_IVF_ROWS, 256, SEED + 23)
    reset_all_launches()
    db = VectorDatabase(storage_file=os.path.join(tmp, f"mesh_ivf_{lists_dtype}.pkl"),
                        index="ivf", ivf_opts={"lists_dtype": lists_dtype},
                        mesh=search_mesh(MESH_SHARDS, device=DEV))
    out = {"load_s": load_db(db, corpus, pieces=2)}
    t0 = time.perf_counter()
    db.find_most_similar_batch(queries, k=k)  # builds, reshards
    out["first_search_s"] = time.perf_counter() - t0
    eng = db._engine
    ivf = eng._ivf
    assert isinstance(ivf, dist_ivf.DistributedIVFIndex) and ivf._data is None
    assert eng.store._buf is None  # the build buffer went back to the card
    out["build_s"] = db.stats()["ops"]["ivf_build"]["total_s"]
    out.update(nlist_effective=ivf.nlist, lists_per_shard=ivf._local_lists,
               P=ivf.pad_len, nprobe=db.nprobe)
    want_v, want_i = oracle_topk(corpus, queries, k)
    res, out["batch_256_ms_median"] = timed_batches(db, queries, k)
    eight, out["batch_8_ms_median"] = timed_batches(db, queries[:8], k)
    out["recall_at_10_batch_256"] = recall_at_k(res, want_i)
    out["recall_at_10_batch_8"] = recall_at_k(eight, want_i[:8])
    # the single-device path's calibration target
    assert min(out["recall_at_10_batch_256"], out["recall_at_10_batch_8"]) >= 0.95, out
    exact = db.find_most_similar_batch(queries[:32], k=k, nprobe=ivf.nlist)
    check_hits_tied(exact, want_v[:32], want_i[:32], f"mesh ivf {lists_dtype} nprobe = nlist")
    out["launches"] = read_mesh_launches(total, MESH_ENTRY_POINTS["ivf_" + lists_dtype],
                                         f"mesh ivf {lists_dtype}")
    out["shard_max_abs_err"] = hold_ivf_shards(ivf.snapshot(), queries,
                                               f"mesh ivf {lists_dtype}")
    reset_all_launches()
    out["checked"] = ["recall@10 >= 0.95 at the default nprobe (batch 256, batch 8)",
                      "nprobe = nlist equals the oracle (batch 32)",
                      "each shard's probe kernel against its plain version",
                      "build buffer released, rescore row-sharded"]
    del db, eng, ivf
    free_card()
    return out


def mesh_sharded_class(tmp, corpus, queries, k, total) -> dict:
    """(d) ShardedVectorDatabase(mesh=search_mesh()): the card's real
    devices (one), over the first 131,072 rows of the main corpus."""
    rows = corpus[:SHARDED_IVF_ROWS]
    folder = os.path.join(tmp, "mesh_shards")
    reset_all_launches()
    mesh = search_mesh()
    assert mesh.devices.size == torch.cuda.device_count()
    db = ShardedVectorDatabase(storage_dir=folder, mesh=mesh)
    out = {"devices": mesh.devices.size, "load_s": load_db(db, rows, pieces=2)}
    want_v, want_i = oracle_topk(rows, queries, k)
    res, out["batch_256_ms_median"] = timed_batches(db, queries, k)
    check_hits_tied(res, want_v, want_i, "sharded class on search_mesh()")
    ids, scores, _ = db.find_most_similar(queries[0], k=k)
    check_hits_tied([(ids, scores, None)], want_v[:1], want_i[:1], "sharded class, one query")
    assert len(shard_files(folder)) == -(-SHARDED_IVF_ROWS // 5000)
    out["launches"] = read_mesh_launches(total, {"phase1_f32"}, "sharded class on a mesh")
    out["shard_max_abs_err"] = hold_scan_shards(db._engine._dist.snapshot(), queries,
                                                "sharded class on a mesh")
    reset_all_launches()
    del db
    free_card()
    shutil.rmtree(folder)
    return out


def mesh_pod(tmp, corpus, queries, want_v, want_i, k, total) -> dict:
    """(e) init_pod over NCCL as a one-rank world through a file:// store;
    PodScanIndex on a (1, 4) pod mesh: each search ends in an NCCL
    all-gather of the host's merged list."""
    import torch.distributed as dist

    n = corpus.shape[0]
    reset_all_launches()
    t0 = time.perf_counter()
    multihost.init_pod("file://" + os.path.join(tmp, "pod_store"), 1, 0, device=DEV)
    out = {"init_pod_s": time.perf_counter() - t0, "backend": dist.get_backend()}
    assert out["backend"] == "nccl"
    try:
        mesh = multihost.pod_mesh(1, MESH_SHARDS, device=DEV)
        assert mesh.distributed and mesh.devices.shape == (1, MESH_SHARDS)
        pod = multihost.PodScanIndex(mesh, D)
        t0 = time.perf_counter()
        pod.load_local(corpus, 0, n)
        torch.cuda.synchronize()
        out["load_local_s"] = time.perf_counter() - t0
        vals, gids = pod.search(queries, k)
        check_hits_tied([(gids[b].tolist(), vals[b].tolist(), None) for b in range(len(gids))],
                        want_v, want_i, "pod search")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pod.search(queries, k)
            times.append((time.perf_counter() - t0) * 1e3)
        out["batch_256_ms_median"] = statistics.median(times)
        out["launches"] = read_mesh_launches(total, {"phase1_f32"}, "pod")
        assert out["launches"]["phase1_f32"] == 6 * MESH_SHARDS, out
    finally:
        dist.destroy_process_group()
    del pod
    free_card()
    return out


def phase_mesh_path(tmp: str, main_data: tuple) -> dict:
    """mesh= through VectorDatabase and ShardedVectorDatabase: 4 logical
    shards of the card (search_mesh(4, device="cuda:0")) over the main
    path's corpus, float32 against its oracle, bfloat16 and int8 by recall;
    index="ivf" on the mesh; search_mesh() over the card's devices; a
    one-rank NCCL pod. Returns the launch counts of the classes' searches
    (every count set to 0 before each database, read after its last call)."""
    t_phase = time.perf_counter()
    corpus, queries, want_v, want_i = main_data
    (n, _d), b, k = corpus.shape, queries.shape[0], want_i.shape[1]
    out = {"phase": "mesh_path", "rows": n, "dim": D, "batch": b, "k": k,
           "shards": MESH_SHARDS}
    launches = {}
    for dtype in ("float32", "bfloat16", "int8"):
        # the same corpus unsharded in this run, before the mesh's counts
        flat = unsharded_hits(tmp, dtype, corpus, queries, k)
        out[dtype] = mesh_flat(tmp, dtype, corpus, queries, want_v, want_i, k, launches, flat)
    for lists_dtype in ("bfloat16", "int8"):
        out["ivf_" + lists_dtype] = mesh_ivf(tmp, lists_dtype, k, launches)
    out["sharded_class"] = mesh_sharded_class(tmp, corpus, queries, k, launches)
    out["pod"] = mesh_pod(tmp, corpus, queries, want_v, want_i, k, launches)
    reset_all_launches()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


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


def multiplied_work(seg, tile, per_pair, nh, hd, n_ops, ms) -> dict:
    """What an attention kernel multiplied beside what the data needs:
    per_pair * nh * hd operations for every (query, key) pair of each (rows x
    keys) tile it visits (ops/flash_attention.py:visited_tiles), the rate on
    them and the counted operations' share of them."""
    rows, keys = tile
    tiles = flash_ops.visited_tiles(seg, rows, keys)
    n_mult = per_pair * nh * hd * tiles * rows * keys
    return {"tile": [rows, keys], "multiplied_tiles_per_head": tiles,
            "multiplied_operations": n_mult,
            "tflops_multiplied": n_mult / (ms * 1e-3) / 1e12,
            "counted_share_of_multiplied": n_ops / n_mult}


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
    rows = []
    for kind in dtypes:
        row = k6_row(kind, (b, nh, s, hd), lengths, SEED + 43,
                     launches[f"flash_attention_{kind}"], f"K6-{kind}")
        row["small_max_abs_err"] = small[kind][0]
        row["small_max_err_over_row_tolerance"] = small[kind][1]
        rows.append(row)
    return rows


def float64_attention(q, k, v, seg, scale):
    """(out, lse) of attention within segments in float64, a batch row at a
    time: the yardstick of the float32 rows' max_abs_err_vs_float64."""
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float64, device=q.device)
    mask = torch.tensor(flash_ops.MASK_VALUE, dtype=torch.float64, device=q.device)
    for i in range(q.shape[0]):
        qd, kd, vd = (t[i:i + 1].double() for t in (q, k, v))
        same = seg[i:i + 1, None, :, None] == seg[i:i + 1, None, None, :]
        logits = torch.where(same, (qd @ kd.transpose(-1, -2)) * scale, mask)
        lse[i:i + 1] = torch.logsumexp(logits, dim=-1)
        out[i:i + 1] = torch.softmax(logits, dim=-1) @ vd
    return out, lse


def f32_accuracy(q, k, v, seg, scale, out, lse=None) -> dict:
    """K6-f32's output (and row log-sum-exp) beside the IEEE plain version's
    and SDPA's, each against float64_attention, and the kernel's distance to
    its own arithmetic in plain PyTorch (flash_attention_lse_3xtf32_plain)."""
    o64, l64 = float64_attention(q, k, v, seg, scale)
    pout, plse = flash_ops.flash_attention_lse_plain(q, k, v, seg, scale)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    lib = F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=scale)
    eout, else_ = flash_ops.flash_attention_lse_3xtf32_plain(q, k, v, seg, scale)

    def dist(a, b):
        return float((a.to(torch.float64) - b).abs().max())

    res = {"max_abs_err_vs_float64": {"kernel": dist(out, o64), "plain": dist(pout, o64),
                                      "library": dist(lib, o64)},
           "max_abs_err_vs_3xtf32_plain": float((out - eout).abs().max())}
    if lse is not None:
        res["lse_max_abs_err_vs_float64"] = {"kernel": dist(lse, l64), "plain": dist(plse, l64)}
        res["lse_max_abs_err_vs_3xtf32_plain"] = float((lse - else_).abs().max())
    del o64, l64, pout, plse, same, lib, eout, else_
    torch.cuda.empty_cache()
    return res


def float64_attention_bwd(q, k, v, seg, dout, scale):
    """(dq, dk, dv) of attention within segments in float64, a batch row at a
    time (delta = rowsum(dP * P), equal to rowsum(dO * O) in exact
    arithmetic): the yardstick of the K7-f32 and K8-f32 rows'
    max_abs_err_vs_float64."""
    grads = [torch.empty(q.shape, dtype=torch.float64, device=q.device) for _ in range(3)]
    mask = torch.tensor(flash_ops.MASK_VALUE, dtype=torch.float64, device=q.device)
    for i in range(q.shape[0]):
        qd, kd, vd, dod = (t[i:i + 1].double() for t in (q, k, v, dout))
        same = seg[i:i + 1, None, :, None] == seg[i:i + 1, None, None, :]
        p = torch.softmax(torch.where(same, (qd @ kd.transpose(-1, -2)) * scale, mask), dim=-1)
        dp = dod @ vd.transpose(-1, -2)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        grads[0][i:i + 1] = (ds @ kd) * scale
        grads[1][i:i + 1] = (ds.transpose(-1, -2) @ qd) * scale
        grads[2][i:i + 1] = p.transpose(-1, -2) @ dod
    return grads


def f32_bwd_accuracy(q, k, v, seg, scale, out, dout, lse, got, which, library) -> dict:
    """A float32 backward kernel's gradients ``got`` (K7-f32: dk, dv, which =
    (1, 2); K8-f32: dq, which = (0,)) beside the IEEE plain backward's, the
    3xTF32 arithmetic in plain PyTorch (flash_attention_bwd_3xtf32_plain) and
    SDPA's autograd backward (``library``: dq, dk, dv), each against
    float64_attention_bwd (the largest distance over the kernel's gradients),
    and the kernel's distance to the 3xTF32 plain version; the plain versions
    take the same forward output and log-sum-exp as the kernel."""
    want = float64_attention_bwd(q, k, v, seg, dout, scale)
    plain = flash_ops.flash_attention_bwd_plain(q, k, v, seg, out, dout, lse, scale)
    emul = flash_ops.flash_attention_bwd_3xtf32_plain(q, k, v, seg, out, dout, lse, scale)

    def dist(grads):
        return max(float((g.to(torch.float64) - want[i]).abs().max())
                   for g, i in zip(grads, which))

    def pick(grads):
        return [grads[i] for i in which]

    res = {"max_abs_err_vs_float64": {"kernel": dist(got), "plain": dist(pick(plain)),
                                      "3xtf32_plain": dist(pick(emul)),
                                      "library": dist(pick(library))},
           "max_abs_err_vs_3xtf32_plain": max(float((g - e).abs().max())
                                              for g, e in zip(got, pick(emul)))}
    del want, plain, emul
    torch.cuda.empty_cache()
    return res


def k6_row(kind, shape, lengths, seed, launches: int, name: str) -> dict:
    """K6 of ``kind`` at ``shape`` = (B, nh, S, hd) with the given lengths,
    held against its plain version (compare_attention), timed beside it,
    beside SDPA with a boolean segment mask and beside the bound; with the
    kernel's registers and spills at that hd."""
    b, nh, s, hd = shape
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
    scale = 1.0 / float(np.sqrt(hd))
    pairs = sum(n * n + (s - n) * (s - n) for n in lengths)
    case = attention_case(b, nh, s, hd, dtype, lengths, seed)
    q, k, v, seg = case
    err, share = compare_attention(kind, case, name)
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
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[kind] * 1e3
    extra = {}
    if kind == "f32":  # 3xTF32: three TF32 products a product, at the TF32 peak
        extra = {"bound_ms_ieee": max(t_bytes, t_ops),
                 **f32_accuracy(q, k, v, seg, scale, run())}
        t_ops = 3 * n_ops / PEAK_TF32_S * 1e3
    ms = statistics.median([ms_a, ms_b])
    row = {
        "name": name,
        "route": "cuda",
        "source": "minivectordb_tpu_torch/csrc/flash_attention.cu",
        "replaces": "minivectordb_tpu/models/encoder.py:138",
        "launches": launches,
        "max_abs_err": err,
        "tolerance": TOL_K6[kind],
        "row_tolerance": None if kind == "f32" else
        f"{TOL_K6_ROW_REL} * max|plain| over the row + {TOL_K6_ROW_ABS}",
        "max_err_over_row_tolerance": share,
        "ms": ms,
        "plain_ms": statistics.median([plain_a, plain_b]),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        **extra,
        "library_ms": lib_ms,
        "library": "scaled_dot_product_attention, boolean (B, 1, S, S) segment mask",
        "library_max_abs_err_vs_plain": lib_err,
        "bound_bytes": n_bytes,
        "bound_operations": n_ops,
        "tflops_counted": n_ops / (ms * 1e-3) / 1e12,
        **multiplied_work(seg, flash_ops.tile_shape(dtype, hd), 4, nh, hd, n_ops, ms),
        "dense_operations": 4 * b * nh * s * s * hd,
        "dense_tflops": 4 * b * nh * s * s * hd / (ms * 1e-3) / 1e12,
        "shape": {"B": b, "nh": nh, "S": s, "hd": hd, "lengths_min": min(lengths),
                  "lengths_mean": float(np.mean(lengths))},
        f"ptxas_hd{hd}": ptxas_of(f"flash_{kind}_kernel", hd),
    }
    del case, q, k, v, seg, same
    torch.cuda.empty_cache()
    return row


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
# slots_path: the bundled trained slots, heads of 48 and 128, on K6 / K7 / K8
# ---------------------------------------------------------------------------

SLOTS = ("small", "large", "bgem3")
SLOT_TRAIN = ("small", "large")  # train_builtin --slot runs
SLOT_HEAD_DIMS = (48, 128)


def slot_head_dim(kind: str) -> int:
    cfg = model_configs.TRAINED_CONFIGS[kind]
    return cfg.hidden // cfg.heads


def slot_texts(words: list, seed: int) -> dict:
    """32 seeded texts of the slot's own words for each sequence bucket:
    150-220 words (S = 256) and 300-480 (S = 512, the first text 600 words,
    cut at 512 tokens)."""
    t512 = seeded_texts(words, 32, 300, 480, seed + 1)
    t512[0] = " ".join(words[:600])
    return {"S256": seeded_texts(words, 32, 150, 220, seed), "S512": t512}


def drive_slot_embed(kind: str, compute_dtype, texts: dict) -> dict:
    """EmbeddingModel(use_quantized_onnx_model=False, alternative_model=kind)
    on the card: the bundled artifact, K6 of the call's type launched
    cfg.layers times a call and nothing else; each bucket's embeddings held
    against the same module with the plain attention and against the class
    built on the CPU. Host-clock ms per call (median of 5)."""
    tag = "f32" if compute_dtype is None else "bf16"
    entry = f"flash_attention_{tag}"
    cfg = model_configs.TRAINED_CONFIGS[kind]
    args = dict(use_quantized_onnx_model=False, alternative_model=kind,
                compute_dtype=compute_dtype)
    flash_ops.reset_launches()
    t0 = time.perf_counter()
    model = EmbeddingModel(**args)
    load_s = time.perf_counter() - t0
    assert model.weights_source == "bundled-trained", (kind, model.weights_source)
    assert model.model.cfg == cfg and model.device == DEV, (kind, model.model.cfg)
    for name, want_s in (("S256", 256), ("S512", 512)):
        shape = model.model._tokenize_padded(texts[name], 512)[0].shape
        assert shape == (32, want_s), (kind, name, shape)
    first, ms = {}, {}
    for name, batch in texts.items():
        before = dict(flash_ops.LAUNCHES)
        first[name] = model.extract_embeddings_batch(batch)
        got = {n: c - before[n] for n, c in flash_ops.LAUNCHES.items()}
        assert got == flash_counts(**{entry: cfg.layers}), (kind, tag, name, got)
    for name, batch in texts.items():
        emb, ms[name] = timed_embeds(model, batch)
        assert np.array_equal(emb, first[name]), (kind, tag, "an embed call must repeat itself")
    launches = read_k6_launches({}, {entry: 12 * cfg.layers}, f"slot {kind} {tag}")
    with plain_attention():
        plain = {name: model.extract_embeddings_batch(batch) for name, batch in texts.items()}
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = EmbeddingModel(**args, device="cpu")
    on_cpu = {name: cpu.extract_embeddings_batch(batch) for name, batch in texts.items()}
    cpu_s = time.perf_counter() - t0
    assert cpu.weights_source == "bundled-trained"
    del cpu
    return {
        "load_s": load_s,
        "launches": launches,
        "launches_per_call": cfg.layers,
        **{f"{name}_ms_per_call_median": ms[name] for name in texts},
        **{f"{name}_texts_per_s": 32 / (ms[name] * 1e-3) for name in texts},
        **{f"{name}_vs_plain_attention": embed_error(
            tag, first[name], plain[name], f"slot {kind} {tag} {name} plain")
           for name in texts},
        **{f"{name}_vs_cpu_class": embed_error(
            tag, first[name], on_cpu[name], f"slot {kind} {tag} {name} cpu")
           for name in texts},
        "cpu_class_s": cpu_s,
    }


def drive_slot_training(tmp: str, kind: str) -> dict:
    """models/train_builtin.py's main with --slot ``kind`` (4 steps, batch
    64, S = 256, float32) into a directory under ``tmp``: K6-f32-lse, K7-f32
    and K8-f32 launched 2 encodes x layers a step each, and no other entry
    point; the artifact loads through EmbeddingModel from that directory.
    Then step 1's loss and gradients at the slot's config against the
    plain-attention module (compare_gradients) on a batch of 8 pairs of
    hashed ids below the slot's vocabulary, ragged and padded to S = 256."""
    cfg = model_configs.TRAINED_CONFIGS[kind]
    res_dir = os.path.join(tmp, "slots")
    steps = 4
    argv = ["--slot", kind, "--steps", str(steps), "--batch", "64", "--seq", "256",
            "--force", "--out", os.path.join(res_dir, f"trained_{kind}")]
    printed = io.StringIO()
    flash_ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = train_builtin.main(argv)
    main_s = time.perf_counter() - t0
    assert rc == 0, printed.getvalue()[-2000:]
    per_step = 2 * cfg.layers  # two encodes a step, one launch a layer each
    launches = read_k6_launches(
        {}, {name: steps * per_step for name in TRAIN_ENTRY_POINTS}, f"train_builtin {kind}")
    os.environ["MINIVECTORDB_TORCH_RESOURCES"] = res_dir
    try:
        served = EmbeddingModel(use_quantized_onnx_model=False, alternative_model=kind)
    finally:
        del os.environ["MINIVECTORDB_TORCH_RESOURCES"]
    assert served.weights_source == "bundled-trained" and served.model.cfg.hidden == cfg.hidden
    emb = served.extract_embeddings_batch(["i like dogs", "the stock market fell"])
    assert np.isfinite(emb).all() and np.abs(np.linalg.norm(emb, axis=1) - 1).max() <= 1e-3
    del served
    batch = train_batches(1, 8, SEED + 120 + slot_head_dim(kind), cfg, 256)[0]
    assert int(batch["q_ids"].max()) < cfg.vocab_size and batch["q_ids"].shape == (8, 256)
    t0 = time.perf_counter()
    grads = compare_gradients(cfg, batch, SEED + 130 + slot_head_dim(kind))
    grads["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return {"argv": argv, "main_s": main_s, "launches": launches,
            "launches_per_step": per_step, "steps_run": steps,
            "log_tail": printed.getvalue().splitlines()[-2:],
            "step1_vs_plain_attention": grads}


def phase_slots_path(tmp: str) -> dict:
    """The bundled trained slots (TRAINED_SMALL: 8 heads of 48;
    TRAINED_LARGE, TRAINED_BGEM3: 8 heads of 128) through the public class in
    float32 and bfloat16, then train_builtin --slot small and large. A
    converted checkpoint under MINIVECTORDB_TORCH_WEIGHTS would take the
    slot's place (encoder_path set it), so the variable is unset for the
    phase and restored after. Returns each run's K6 / K7 / K8 launches,
    {"embed": {slot: {entry: n}}, "train": {slot: {entry: n}}}."""
    t_phase = time.perf_counter()
    saved = os.environ.pop("MINIVECTORDB_TORCH_WEIGHTS", None)
    out = {"phase": "slots_path", "embed": {}, "train": {}}
    launches = {"embed": {}, "train": {}}
    try:
        for i, kind in enumerate(SLOTS):
            cfg = model_configs.TRAINED_CONFIGS[kind]
            with open(os.path.join(embedding_model._bundled_dir(kind), "vocab.json")) as f:
                words = json.load(f)["words"]
            texts = slot_texts(words, SEED + 100 + 2 * i)
            runs = {tag: drive_slot_embed(kind, dtype, texts)
                    for tag, dtype in (("f32", None), ("bf16", "bfloat16"))}
            out["embed"][kind] = {"config": {"layers": cfg.layers, "hidden": cfg.hidden,
                                             "heads": cfg.heads, "head_dim": slot_head_dim(kind)},
                                  **runs}
            launches["embed"][kind] = {n: sum(r["launches"][n] for r in runs.values())
                                       for n in flash_ops.LAUNCHES}
        for kind in SLOT_TRAIN:
            out["train"][kind] = drive_slot_training(tmp, kind)
            launches["train"][kind] = out["train"][kind]["launches"]
    finally:
        if saved is not None:
            os.environ["MINIVECTORDB_TORCH_WEIGHTS"] = saved
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


def slot_launches_at(slot_launches: dict, hd: int) -> dict:
    """Each entry point's launches by the slots of head width ``hd``."""
    total = {}
    for runs in slot_launches.values():
        for kind, counts in runs.items():
            if slot_head_dim(kind) == hd:
                for name, n in counts.items():
                    total[name] = total.get(name, 0) + n
    return total


def slot_kernel_rows(slot_launches: dict) -> list:
    """K6, K6-lse, K7 and K8 of both types at the slots' head widths, report
    only (their agreement with the plain versions is asserted): K6 at the
    embed calls' B = 32, nh = 8, S = 512 (lengths 200-512), the training
    kernels at train_builtin's B = 64, nh = 8, S = 256 (ragged lengths of
    100-256). Rows are named "<kernel> hd<hd>"; their launches are the
    slots_path runs' at that width (0 where the path runs no such kernel:
    train_builtin trains in float32)."""
    rows = []
    for hd in SLOT_HEAD_DIMS:
        counts = slot_launches_at(slot_launches, hd)
        lengths = seeded_lengths(32, 512, 200, SEED + 500 + hd)
        for kind in ("f32", "bf16"):
            rows.append(k6_row(kind, (32, 8, 512, hd), lengths, SEED + 501 + hd,
                               counts.get(f"flash_attention_{kind}", 0), f"K6-{kind} hd{hd}"))
        lengths = seeded_lengths(64, 256, 100, SEED + 510 + hd)
        rows += train_rows_at((64, 8, 256, hd), lengths, SEED + 511 + hd, counts, f" hd{hd}")
        rows += train_bf16_rows_at((64, 8, 256, hd), lengths, SEED + 513 + hd, counts, f" hd{hd}")
    return rows


# ---------------------------------------------------------------------------
# train_path: contrastive training of the encoder (K6 with lse, K7, K8)
# ---------------------------------------------------------------------------


def train_batches(steps: int, pairs: int, seed: int, cfg=model_configs.E5_LARGE,
                  seq: int = 512) -> list:
    """``steps`` batches of ``pairs`` (query, passage) texts of seeded words
    (200-505 for S = 512, 100-250 for S = 256) through a hashing tokenizer
    over ``cfg``'s vocabulary, padded to S = ``seq`` with ragged lengths:
    every encode takes the flash route."""
    tok = HashTokenizer(cfg.vocab_size)
    vocab = [f"w{i}" for i in range(50_000)]
    lo, hi = (200, 505) if seq == 512 else (100, 250)

    def tokenize(texts):
        enc = tok(texts, max_length=seq)
        ids = np.full((len(texts), seq), cfg.pad_id, np.int32)
        mask = np.zeros((len(texts), seq), np.int32)
        for row, (e, m) in enumerate(zip(enc["input_ids"], enc["attention_mask"])):
            ids[row, :len(e)] = e
            mask[row, :len(m)] = m
        return ids, mask

    out = []
    for step in range(steps):
        q_ids, q_mask = tokenize(seeded_texts(vocab, pairs, lo, hi, seed + 2 * step))
        p_ids, p_mask = tokenize(seeded_texts(vocab, pairs, lo, hi, seed + 2 * step + 1))
        out.append({"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids, "p_mask": p_mask})
    return out


def seeded_encoder(cfg, seed: int, dtype=torch.float32):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return encoder_mod.init_params(cfg, gen, DEV, dtype)


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


def step_gradients(cfg, batch, seed: int, route: str, dtype=torch.float32, run_in=None):
    """Loss and every parameter's gradient of one InfoNCE step from the
    weights seeded in ``dtype`` (cast to ``run_in`` when given), with
    attention computed by ``route`` (GRAD_ROUTES)."""
    enc = seeded_encoder(cfg, seed, dtype)
    if run_in is not None:
        enc = enc.to(run_in)
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


def compare_gradients_bf16(cfg, batch, seed: int) -> dict:
    """Step 1 in bfloat16 from seeded bfloat16 weights, against a float32 run
    of the same step from the same weights (cast, so exactly the same
    values; float32 kernels K6/K7/K8). Each route's distance to it per
    parameter tensor, |g - g_32| / |g_32| (Frobenius), or for the q and k
    projections |g - g_32| / |g_32 of that layer's v weight| (as
    compare_gradients scales them): "kernels" (K6-bf16 with lse, K7/K8-bf16), "plain" (the
    bfloat16 module with flash_attention_plain in the kernel's place,
    differentiated by autograd) and "plain_flash" (the kernels' formulation
    in plain PyTorch, rounding where they round). Asserted: every tensor but
    the q and k projections, kernels <= GRAD_BF16_FACTOR x plain, and the
    median of those <= GRAD_BF16_MEDIAN_FACTOR x plain's; the q and k
    projections, kernels <= GRAD_BF16_FACTOR x plain_flash and <=
    GRAD_BF16_QK_CAP (see the module docstring)."""
    runs = {}
    for route, dtype, run_in, how in (("float32", torch.bfloat16, torch.float32, "kernels"),
                                      ("kernels", torch.bfloat16, None, "kernels"),
                                      ("plain", torch.bfloat16, None, "plain"),
                                      ("plain_flash", torch.bfloat16, None, "plain_flash")):
        loss, acc, grads = step_gradients(cfg, batch, seed, how, dtype, run_in)
        runs[route] = (loss, acc, {n: g.detach().to("cpu", torch.float64)
                                   for n, g in grads.items()})
        del grads
        torch.cuda.empty_cache()
    ref = runs["float32"][2]
    for route, (loss, _acc, grads) in runs.items():
        assert np.isfinite(loss), (route, loss)
        for name, g in grads.items():
            assert torch.isfinite(g).all(), (route, name)
    rows = {}
    for name, want in ref.items():
        qk = logit_path(name)
        scale = float((ref[name.rsplit(".", 2)[0] + ".v.weight"] if qk else want).norm())
        d = {route: float((runs[route][2][name] - want).norm()) / scale
             for route in ("kernels", "plain", "plain_flash")}
        if qk:
            assert d["kernels"] <= GRAD_BF16_FACTOR * d["plain_flash"], (name, d)
            assert d["kernels"] <= GRAD_BF16_QK_CAP, (name, d)
        else:
            assert d["kernels"] <= GRAD_BF16_FACTOR * d["plain"], (name, d)
        rows[name] = d
    others = [n for n in rows if not logit_path(n)]
    qks = [n for n in rows if logit_path(n)]
    med_k = statistics.median(rows[n]["kernels"] for n in others)
    med_p = statistics.median(rows[n]["plain"] for n in others)
    assert med_k <= GRAD_BF16_MEDIAN_FACTOR * med_p, (med_k, med_p)
    ratio = {n: rows[n]["kernels"] / max(rows[n]["plain"], 1e-30) for n in others}
    worst = sorted(others, key=lambda n: -ratio[n])[:4]
    worst_qk = sorted(qks, key=lambda n: -rows[n]["kernels"])[:4]
    return {"losses": {route: run[0] for route, run in runs.items()},
            "accuracy": {route: run[1] for route, run in runs.items()},
            "factor": GRAD_BF16_FACTOR, "median_factor": GRAD_BF16_MEDIAN_FACTOR,
            "q_k_cap": GRAD_BF16_QK_CAP, "params_compared": len(rows),
            "median_kernels_vs_float32": med_k, "median_plain_vs_float32": med_p,
            "median_plain_flash_vs_float32": statistics.median(
                rows[n]["plain_flash"] for n in others),
            "max_ratio_kernels_over_plain": ratio[worst[0]],
            "median_ratio_kernels_over_plain": statistics.median(ratio.values()),
            "largest_ratio": {n: rows[n] for n in worst},
            "q_k_max_kernels_over_v_weight": rows[worst_qk[0]]["kernels"],
            "q_k_median_kernels_over_v_weight": statistics.median(
                rows[n]["kernels"] for n in qks),
            "q_k_median_plain_over_v_weight": statistics.median(rows[n]["plain"] for n in qks),
            "q_k_max_ratio_kernels_over_plain_flash": max(
                rows[n]["kernels"] / max(rows[n]["plain_flash"], 1e-30) for n in qks),
            "q_k_largest": {n: rows[n] for n in worst_qk}}


def leaves(tree):
    """The arrays of a numpy pytree (dicts and lists)."""
    if isinstance(tree, dict):
        for val in tree.values():
            yield from leaves(val)
    elif isinstance(tree, list):
        for val in tree:
            yield from leaves(val)
    else:
        yield tree


def params_max_diff(a, b) -> float:
    with torch.no_grad():
        return max(float((x - y).abs().max()) for x, y in zip(a.parameters(), b.parameters()))


def drive_e5_large_training(tmp: str, batches: list, seed: int,
                            dtype=torch.float32) -> dict:
    """The e5-large widths through train_loop in ``dtype``: 2 steps (the
    loop's checkpoint at step 2), step 3, then the checkpoint loaded and step
    3 again from it. Host-clock times of each step (the loss is read every
    step). bfloat16: the checkpoint's leaves must be bfloat16, and the
    resumed step must repeat the uninterrupted one bit for bit."""
    cfg = model_configs.E5_LARGE
    bf16 = dtype == torch.bfloat16
    ck = os.path.join(tmp, "train_ck_bf16.pkl" if bf16 else "train_ck.pkl")
    marks = []

    def log(_line):
        marks.append(time.perf_counter())

    enc = seeded_encoder(cfg, seed, dtype)
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
    leaf_types = sorted({np.asarray(x).dtype.name for x in leaves(ck_params)}
                        | {np.asarray(x).dtype.name
                           for key in ("mu", "nu") for x in leaves(ck_opt[key])})
    if bf16:
        assert leaf_types == ["bfloat16"], leaf_types
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
    if bf16:
        assert params.dtype == resumed.dtype == torch.bfloat16
        assert loss3 == loss3_r and resume_diff == 0.0, (loss3, loss3_r, resume_diff)
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
        "checkpoint_leaf_types": leaf_types,
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


def phase_train_path_bf16(tmp: str) -> dict:
    """The e5-large widths in bfloat16 (seeded bfloat16 weights, bfloat16
    activations, gradients and AdamW moments) through train_loop, as
    phase_train_path drives float32: K6-bf16 with its log-sum-exp and the
    bfloat16 K7/K8, 48 launches each a step, and no float32 launch. Then step
    1's gradients against a float32 run of the same weights. Returns the
    path's launches."""
    cfg = model_configs.E5_LARGE
    seed = SEED + 90
    batches = train_batches(3, 8, SEED + 91)
    out = {"phase": "train_path_bf16", "dtype": "bfloat16", "config": {
        "layers": cfg.layers, "hidden": cfg.hidden, "heads": cfg.heads,
        "intermediate": cfg.intermediate, "vocab_size": cfg.vocab_size},
        "batch_pairs": 8, "seq": 512,
        "real_tokens_per_step": [int(b["q_mask"].sum() + b["p_mask"].sum()) for b in batches]}
    flash_ops.reset_launches()
    out["e5_large"] = drive_e5_large_training(tmp, batches, seed, torch.bfloat16)
    per_step = 2 * cfg.layers
    out["e5_large"]["launches"] = read_k6_launches(
        {}, {name: 4 * per_step for name in TRAIN_BF16_ENTRY_POINTS}, "e5-large bf16 training")
    out["e5_large"]["launches_per_step"] = per_step
    out["e5_large"]["steps_run"] = 4
    t0 = time.perf_counter()
    out["step1_vs_float32"] = compare_gradients_bf16(cfg, batches[0], seed)
    out["step1_vs_float32"]["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    emit(out)
    return out["e5_large"]["launches"]


# ---------------------------------------------------------------------------
# train_mesh_path: training on a (dp, tp) = (2, 2) mesh of the card
# ---------------------------------------------------------------------------

TRAIN_MESH_SHAPE = (2, 2)  # train_mesh_path's logical (dp, tp) positions on the card
# kernel row name -> its entry point, for the rows' "train_mesh_launches"
TRAIN_ROW_ENTRY = dict(zip(("K6-f32-lse", "K7-f32", "K8-f32"), TRAIN_ENTRY_POINTS)) | dict(
    zip(("K6-bf16-lse", "K7-bf16", "K8-bf16"), TRAIN_BF16_ENTRY_POINTS))


def bf16_ulp(x: np.ndarray) -> float:
    """One bfloat16 ulp at the largest magnitude of x."""
    big = float(np.abs(x.astype(np.float32)).max())
    return float(2.0 ** (np.floor(np.log2(max(big, 2.0 ** -126))) - 7))


MESH_BF16_LOSS_TOL = 2e-3  # the bfloat16 mesh loss against one device's
MESH_MEAN_LR = 0.25  # float32; tests/test_torch_train.py's BF16_MEAN_LR
# step 1's gradients, mesh against one device: |g_mesh - g| / |g| a leaf
MESH_GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.25}


def loss_tolerance(bf16: bool) -> float:
    """The mesh step's loss against the single-device step's: 1e-4 in float32
    (tests/test_train.py's bound for JAX's sharded step); in bfloat16
    MESH_BF16_LOSS_TOL, the predicted difference: the tp partial sums and the
    dp gradient sums round to bfloat16 at other points than the
    single-device step's products, and 24 layers carry the difference. Both
    are well under the loss's own movement from step to step (about 0.03)."""
    return MESH_BF16_LOSS_TOL if bf16 else 1e-4


def mesh_vs_single(mesh_tree, single_tree, steps: int, lr: float, bf16: bool) -> dict:
    """Every parameter leaf of the mesh run against the single-device run
    after ``steps`` AdamW steps from the same weights. Each element within
    2 * lr * steps (+ 4 bfloat16 ulps of the leaf's largest value in
    bfloat16): Adam moves an element by about lr a step whatever its
    gradient's size (m_hat / sqrt(v_hat) is +-1 at step 1), so an element
    whose gradient is rounding noise (near zero, its sign set by the
    summation order: the tp partial sums, the dp gradient sum) can move by lr
    one way in one run and the other way in the other; a bfloat16 parameter
    also rounds each update to its ulp. That envelope holds whatever the
    gradient is. In float32 each leaf's mean error is held to MESH_MEAN_LR *
    lr too, the k bias exempt (its gradient is zero but for rounding:
    softmax ignores a shift of a query's logits), as tests/test_torch_train.py
    holds the port against JAX. In bfloat16 that rule fails for a right
    gradient at these widths: the last layers' biases and the q and k
    projections have rounding-bound gradients (PERF.md section 6), which
    Adam turns into moves of lr either way; the means are reported, and
    mesh_gradients_vs_single holds the gradients themselves."""
    worst = (0.0, "")
    means = {}
    over_lr = total = 0
    sum_err = 0.0
    for (path, got), (_p, want) in zip(leaf_items(mesh_tree), leaf_items(single_tree)):
        g, w = got.astype(np.float32), want.astype(np.float32)
        err = np.abs(g - w)
        limit = 2 * lr * steps + (4 * bf16_ulp(w) if bf16 else 0.0)
        assert float(err.max()) <= limit, (path, float(err.max()), limit)
        if not path.endswith(".k.b"):
            means[path] = float(err.mean(dtype=np.float64))
        if float(err.max()) > worst[0]:
            worst = (float(err.max()), path)
        over_lr += int((err > lr).sum())
        total += err.size
        sum_err += float(err.sum(dtype=np.float64))
    top = sorted(means, key=lambda p: -means[p])[:3]
    out = {"max_abs_diff": worst[0], "max_abs_diff_leaf": worst[1],
           "mean_abs_diff": sum_err / total,
           "largest_leaf_means": {p: means[p] for p in top},
           "bound": f"2 * lr * steps = {2 * lr * steps}"
           + (" + 4 bfloat16 ulps of the leaf's largest value" if bf16 else
              f"; each leaf's mean but the k biases' {MESH_MEAN_LR} * lr = {MESH_MEAN_LR * lr}"),
           "share_of_elements_over_lr": over_lr / total}
    assert bf16 or means[top[0]] <= MESH_MEAN_LR * lr, out
    return out


def gradients_numpy(model, to_numpy) -> dict:
    """The gradients of a run's last step as the JAX pytree: every parameter
    of ``model`` overwritten by its gradient, then ``to_numpy(model)``."""
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    return to_numpy(model)


def mesh_gradients_vs_single(cfg, batch: dict, seed: int, dtype, mesh) -> dict:
    """Step 1's gradients on the mesh (summed over dp, gathered from replica
    0's pieces) against the single-device step's, from the same seeded
    weights: per parameter leaf |g_mesh - g| / |g| (Frobenius), for the q and
    k projections over the norm of their layer's v-weight gradient (their own
    is rounding-bound at random weights, PERF.md section 6). Asserted
    <= MESH_GRAD_TOL: between the rounding level (a bfloat16 step's
    gradients lie a median 0.045 from a float32 run's in
    compare_gradients_bf16) and what a wrong gradient gives (a gradient
    counted twice is 1.0 away, one of two dp replicas' gradients missing
    about 0.5)."""
    enc, state, opt = train_mod.init_training(cfg, seeded_encoder(cfg, seed, dtype), device=DEV)
    enc, state, m = train_mod.make_train_step(cfg, opt)(enc, state, batch)
    loss = float(m["loss"])
    want = dict(leaf_items(gradients_numpy(enc, port_convert.encoder_to_numpy)))
    del enc, state, opt, m
    free_card()
    weights = port_convert.encoder_to_numpy(seeded_encoder(cfg, seed, dtype))
    menc, mstate, mopt = train_mod.init_training(cfg, weights, mesh=mesh)
    menc, mstate, mm = train_mod.make_train_step(cfg, mopt, mesh=mesh)(menc, mstate, batch)
    mesh_loss = float(mm["loss"])
    got = dict(leaf_items(gradients_numpy(menc, tensor_parallel.gather)))
    del menc, mstate, mopt, mm, weights
    free_card()
    rel = {}
    for path, w in want.items():
        scale_of = path.rsplit(".", 2)[0] + ".v.w" if logit_path(path) else path
        scale = float(np.linalg.norm(want[scale_of].astype(np.float32)))
        diff = got[path].astype(np.float32) - w.astype(np.float32)
        rel[path] = float(np.linalg.norm(diff)) / max(scale, 1e-30)
    top = sorted(rel, key=lambda p: -rel[p])[:4]
    out = {"loss": mesh_loss, "single_device_loss": loss, "leaves": len(rel),
           "median_rel": statistics.median(rel.values()),
           "largest_rel": {p: rel[p] for p in top}, "tolerance": MESH_GRAD_TOL[dtype]}
    assert all(np.isfinite(v) for v in rel.values()) and rel[top[0]] <= MESH_GRAD_TOL[dtype], out
    return out


def leaf_items(tree, path=""):
    """(path, array) of a numpy pytree, in the JAX package's key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaf_items(tree[key], f"{path}.{key}" if path else key)
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            yield from leaf_items(val, f"{path}.{i}")
    else:
        yield path, np.asarray(tree)


def replicas_equal(menc) -> bool:
    """Every position's parameters equal, bit for bit, to its tp shard's in
    replica 0, and every replicated parameter to position 0's."""
    tp = menc.tp
    named = {pos: dict(p.named_parameters()) for pos, p in menc.pieces.items()}
    with torch.no_grad():
        for pos, params in named.items():
            for name, param in params.items():
                if not torch.equal(param, named[pos % tp][name]):
                    return False
                if not tensor_parallel._is_split(name) and not torch.equal(param, named[0][name]):
                    return False
    return True


def drive_mesh_training(tmp: str, batches: list, seed: int, dtype) -> dict:
    """The e5-large widths in ``dtype`` on train_mesh(4, tp=2, device=DEV):
    step 1's gradients against the single-device step's
    (mesh_gradients_vs_single), the single-device train_loop's 3 steps (the
    reference; neither counted), then on the mesh train_loop's 2 steps with the checkpoint at
    step 2, step 3, and step 3 again from the checkpoint loaded with
    shardings=param_shardings(...). Every count is set to 0 just before the
    mesh runs and read just after: 4 steps of 2 encodes x 24 layers x 4
    positions of K6-lse, K7 and K8 of the run's type."""
    cfg = model_configs.E5_LARGE
    bf16 = dtype == torch.bfloat16
    lr = 1e-4
    ck = os.path.join(tmp, "train_mesh_ck_bf16.pkl" if bf16 else "train_mesh_ck.pkl")
    marks = []

    def log(_line):
        marks.append(time.perf_counter())

    mesh = train_mesh(TRAIN_MESH_SHAPE[0] * TRAIN_MESH_SHAPE[1], tp=TRAIN_MESH_SHAPE[1],
                      device=DEV)
    assert mesh.devices.shape == TRAIN_MESH_SHAPE and not mesh.distributed
    t0 = time.perf_counter()
    grads = mesh_gradients_vs_single(cfg, batches[0], seed, dtype, mesh)
    grads["s"] = time.perf_counter() - t0
    enc = seeded_encoder(cfg, seed, dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single, _o, hist_single = train_mod.train_loop(
        cfg, enc, iter(batches), steps=3, learning_rate=lr, log_every=1, log_fn=log, device=DEV)
    single_step_s = [marks[0] - t0, marks[1] - marks[0], marks[2] - marks[1]]
    single_tree = port_convert.encoder_to_numpy(single)
    del enc, single, _o
    free_card()
    weights = port_convert.encoder_to_numpy(seeded_encoder(cfg, seed, dtype))  # the same seed

    flash_ops.reset_launches()
    marks.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    menc, mo, hist = train_mod.train_loop(
        cfg, weights, iter(batches[:2]), steps=2, mesh=mesh, learning_rate=lr,
        checkpoint_path=ck, log_every=1, log_fn=log)
    t_end = time.perf_counter()
    step_s = [marks[0] - t0, marks[1] - marks[0]]
    save_s = t_end - marks[1]
    marks.clear()
    t0 = time.perf_counter()
    menc, mo, hist3 = train_mod.train_loop(
        cfg, menc, iter(batches[2:3]), steps=1, mesh=mesh, start_step=2, opt_state=mo,
        learning_rate=lr, log_every=1, log_fn=log)
    step_s.append(marks[0] - t0)
    hist += hist3
    replicas_bit_equal = replicas_equal(menc)
    assert replicas_bit_equal, "the dp replicas of a tp shard differ"
    del mo, weights
    free_card()

    t0 = time.perf_counter()
    ck_params, ck_opt, ck_step, _extra = load_checkpoint(
        ck, shardings=train_mod.param_shardings(mesh, menc))
    load_s = time.perf_counter() - t0
    assert ck_step == 2, ck_step
    q_w = ck_params["layers"][0]["q"]["w"]
    assert isinstance(q_w, tensor_parallel.ShardedArray)
    assert tuple(q_w.shards[3].shape) == (cfg.hidden, cfg.hidden // 2), q_w.shards[3].shape
    assert q_w.shards[3].device == DEV
    t0 = time.perf_counter()
    resumed, _ro, hist_r = train_mod.train_loop(
        cfg, ck_params, iter(batches[2:3]), steps=1, mesh=mesh, start_step=2, opt_state=ck_opt,
        learning_rate=lr, log_every=1, log_fn=lambda _l: None)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    per_step = 2 * cfg.layers * mesh.devices.size
    entries = TRAIN_BF16_ENTRY_POINTS if bf16 else TRAIN_ENTRY_POINTS
    launches = read_k6_launches({}, {name: 4 * per_step for name in entries},
                                f"e5-large mesh training, {dtype}")
    del ck_params, ck_opt, _ro
    loss3, loss3_r = hist3[0]["loss"], hist_r[0]["loss"]
    with torch.no_grad():
        resume_diff = max(float((a - b).abs().max())
                          for a, b in zip(menc.parameters(), resumed.parameters()))
    assert abs(loss3 - loss3_r) <= 1e-5 * max(1.0, abs(loss3)), (loss3, loss3_r)
    assert resume_diff <= 1e-5, resume_diff
    if bf16:
        assert menc.dtype == resumed.dtype == torch.bfloat16
        assert loss3 == loss3_r and resume_diff == 0.0, (loss3, loss3_r, resume_diff)
    del resumed
    mesh_tree = tensor_parallel.gather(menc)
    del menc
    free_card()
    loss_diffs = [abs(m["loss"] - s["loss"]) for m, s in zip(hist, hist_single)]
    assert all(np.isfinite(h["loss"]) for h in hist), hist
    assert max(loss_diffs) <= loss_tolerance(bf16), (hist, hist_single)
    return {
        "dtype": str(dtype).replace("torch.", ""),
        "mesh": list(mesh.devices.shape),
        "history": hist,
        "single_device_history": hist_single,
        "loss_vs_single_max_abs": max(loss_diffs),
        "loss_tolerance": loss_tolerance(bf16),
        "params_vs_single_after_3_steps": mesh_vs_single(mesh_tree, single_tree, 3, lr, bf16),
        "step1_gradients_vs_single": grads,
        "dp_replicas_bit_equal": replicas_bit_equal,
        "mesh_step_s": step_s,
        "mesh_ms_per_step": step_s[1] * 1e3,
        "single_step_s": single_step_s,
        "single_ms_per_step": single_step_s[1] * 1e3,
        "checkpoint_save_s": save_s,
        "checkpoint_bytes": os.path.getsize(ck),
        "checkpoint_load_placed_s": load_s,
        "resume_step_s": resume_s,
        "resumed_vs_uninterrupted_max_param_diff": resume_diff,
        "peak_memory_bytes_mesh_runs": peak_bytes,
        "launches": launches,
        "launches_per_step": per_step,
        "steps_run": 4,
    }


def train_mesh_pod(tmp: str, batch: dict, seed: int) -> dict:
    """One bfloat16 step on train_mesh(pod=True) over a one-rank NCCL process group
    (init_pod through a file:// store, as mesh_path's pod): the collectives'
    torch.distributed backend on the card. It must repeat the single-device
    step from the same weights bit for bit (a (1, 1) mesh reduces nothing)."""
    import torch.distributed as dist

    cfg = model_configs.E5_LARGE
    quiet = {"learning_rate": 1e-4, "log_every": 1, "log_fn": lambda _l: None}
    single, _o, hist_s = train_mod.train_loop(
        cfg, seeded_encoder(cfg, seed, torch.bfloat16), iter([batch]), 1, device=DEV, **quiet)
    del _o
    weights = port_convert.encoder_to_numpy(seeded_encoder(cfg, seed, torch.bfloat16))
    multihost.init_pod("file://" + os.path.join(tmp, "train_pod_store"), 1, 0, device=DEV)
    try:
        assert dist.get_backend() == "nccl"
        mesh = train_mesh(pod=True)
        assert mesh.distributed and mesh.devices.shape == (1, 1), mesh.devices.shape
        menc, _mo, hist = train_mod.train_loop(cfg, weights, iter([batch]), 1, mesh=mesh,
                                               **quiet)
        with torch.no_grad():
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(menc.pieces[0].parameters(), single.parameters()))
        assert hist[0]["loss"] == hist_s[0]["loss"] and diff == 0.0, (hist, hist_s, diff)
    finally:
        dist.destroy_process_group()
    del menc, _mo, single
    free_card()
    return {"backend": "nccl", "world_size": 1, "mesh": [1, 1], "loss": hist[0]["loss"],
            "single_device_loss": hist_s[0]["loss"], "max_param_diff": diff}


def hold_shard_kernels(lengths: list) -> dict:
    """K6-lse, K7 and K8 of both types at one tp shard's shape (a dp
    replica's 4 sequences, nh = 8 of the 16 heads, S = 512, hd = 64, the
    replica's lengths) against their plain versions (compare_backward[_bf16]'s
    tolerances), timed beside them by CUDA events."""
    cfg = model_configs.E5_LARGE
    b, nh = len(lengths), cfg.heads // TRAIN_MESH_SHAPE[1]
    s, hd = 512, cfg.hidden // cfg.heads
    out = {"shape": {"B": b, "nh": nh, "S": s, "hd": hd, "lengths": lengths}}
    for dtype, compare in ((torch.float32, compare_backward),
                           (torch.bfloat16, compare_backward_bf16)):
        case = attention_case(b, nh, s, hd, dtype, lengths, SEED + 120)
        errs = compare(case, f"tp shard {dtype}")
        q, k, v, seg = case
        scale = 1.0 / float(np.sqrt(hd))
        gen = torch.Generator(device=DEV)
        gen.manual_seed(SEED + 121)
        dout = torch.randn(q.shape, device=DEV, generator=gen).to(dtype)
        o, lse = flash_ops.flash_attention_lse(q, k, v, seg, scale)
        ops = flash_ops._bwd_operands(q, k, v, seg, o, dout, lse)
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        times = {f"K6-{kind}-lse": (lambda: flash_ops.flash_attention_lse(q, k, v, seg, scale),
                                    lambda: flash_ops.flash_attention_lse_plain(q, k, v, seg,
                                                                                scale)),
                 f"K7-{kind}": (lambda: flash_ops._bwd_dkv(*ops, scale), None),
                 f"K8-{kind}": (lambda: flash_ops._bwd_dq(*ops, scale), None)}
        plain_bwd = event_ms(lambda: flash_ops.flash_attention_bwd_plain(
            q, k, v, seg, o, dout, lse, scale), 3, warmup=1)
        for name, (run, plain) in times.items():
            out[name] = {"max_abs_err": errs[name], "ms": event_ms(run, 20),
                         "plain_ms": event_ms(plain, 3, warmup=1) if plain else plain_bwd}
            if name + "_share" in errs:
                out[name]["max_share_of_tolerance"] = errs[name + "_share"]
        del case, q, k, v, seg, dout, o, lse, ops
    free_card()
    return out


def hold_partials(rows: int) -> dict:
    """The bfloat16 row-parallel partial products of one tp position
    (tensor_parallel._partial: attn_out's 512 and ffn_out's 2,048 input
    rows of the 1,024 outputs, over a dp replica's ``rows`` tokens), forward
    and backward, against the same products of the operands upcast to
    float32 (the CPU's formulation): the forward within 1e-5 of the largest
    output (float32 summation order), dh and dw within one bfloat16 ulp of
    their largest value. Both timed by CUDA events."""
    cfg = model_configs.E5_LARGE
    tp = TRAIN_MESH_SHAPE[1]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 122)
    out = {"rows": rows}
    for name, width in (("attn_out", cfg.hidden // tp), ("ffn_out", cfg.intermediate // tp)):
        h = torch.randn((rows, width), device=DEV, generator=gen).to(torch.bfloat16)
        lin = torch.nn.Linear(width, cfg.hidden, device=DEV, dtype=torch.bfloat16)
        g = torch.randn((rows, cfg.hidden), device=DEV, generator=gen).to(torch.bfloat16).float()
        h.requires_grad_(True)

        def card():
            y = tensor_parallel._partial(h, lin)
            return (y, *torch.autograd.grad(y, (h, lin.weight), g))

        def upcast():
            y = F.linear(h.float(), lin.weight.float())
            return (y, *torch.autograd.grad(y, (h, lin.weight), g))

        got, want = card(), upcast()
        errs = [float((a.detach().float() - b.float()).abs().max()) for a, b in zip(got, want)]
        limits = [1e-5 * float(want[0].abs().max())] + [
            bf16_ulp(b.float().cpu().numpy()) for b in want[1:]]
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16, got
        assert all(e <= lim for e, lim in zip(errs, limits)), (name, errs, limits)
        w = lin.weight.detach()
        x = h.detach()
        # the forward product alone, 50 calls between two events: the card's
        # time where the host keeps ahead of it
        fwd = {"tensor_cores_f32_out": lambda: torch.mm(x, w.T, out_dtype=torch.float32),
               "upcast_f32": lambda: F.linear(x.float(), w.float()),
               "bf16_out_library": lambda: F.linear(x, w)}
        out[name] = {"in": width, "out": cfg.hidden, "max_abs_err_y_dh_dw": errs,
                     "tolerance": limits, "ms_fwd_bwd": event_ms(card, 20),
                     "upcast_ms_fwd_bwd": event_ms(upcast, 5, warmup=1),
                     "gflop_fwd_bwd": 3 * 2 * rows * width * cfg.hidden / 1e9,
                     "forward_ms_per_call": {
                         k: event_ms(lambda f=f: [f() for _ in range(50)], 3, warmup=1) / 50
                         for k, f in fwd.items()}}
        del h, lin, g, got, want, w, x, fwd
    free_card()
    return out


def phase_train_mesh_path(tmp: str) -> dict:
    """Training on a (dp, tp) = (2, 2) mesh of logical positions on the card
    at the e5-large widths, float32 then bfloat16 (drive_mesh_training), one
    step over a one-rank NCCL group, and the kernels at one tp shard's
    shape. Returns the mesh runs' launches (both types summed)."""
    t_phase = time.perf_counter()
    batches = train_batches(3, 8, SEED + 111)
    out = {"phase": "train_mesh_path", "mesh": list(TRAIN_MESH_SHAPE),
           "config": "e5-large widths (24 layers, hidden 1024, 16 heads of 64, "
                     "intermediate 4096, vocab 250037), seeded weights",
           "batch_pairs": 8, "seq": 512, "learning_rate": 1e-4}
    launches = {}
    for key, dtype, seed in (("float32", torch.float32, SEED + 110),
                             ("bfloat16", torch.bfloat16, SEED + 112)):
        out[key] = drive_mesh_training(tmp, batches, seed, dtype)
        for name, count in out[key]["launches"].items():
            launches[name] = launches.get(name, 0) + count
    # each float32 entry point launched only by the float32 run, and so on
    for name in TRAIN_BF16_ENTRY_POINTS:
        assert out["float32"]["launches"][name] == 0, out["float32"]["launches"]
    for name in TRAIN_ENTRY_POINTS:
        assert out["bfloat16"]["launches"][name] == 0, out["bfloat16"]["launches"]
    out["process_group"] = train_mesh_pod(tmp, batches[0], SEED + 113)
    first = batches[0]["q_mask"][: 8 // TRAIN_MESH_SHAPE[0]].sum(axis=1)
    out["tp_shard_kernels"] = hold_shard_kernels([int(n) for n in first])
    out["tp_partials"] = hold_partials(int(first.size) * 512)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


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
    after S = 256 at every head width, S = 200 / 129 / 1, S = 333 and 384 at
    hd = 16, 48, 80 and 128 (ragged last tiles; hd = 48 and 80 leave a
    thread's float4 column groups partly idle) and the packed and cyclic ids
    at hd = 64, 48 and 128.
    ``launches`` are the e5-large training path's."""
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
    for s in (333, 384):
        for hd in (16, 48, 80, 128):
            held(attention_case(4, 4, s, hd, torch.float32,
                                seeded_lengths(4, s, 1, SEED + 300 + s + hd), SEED + 301 + s + hd),
                 f"bwd S={s} hd={hd}")
    for name, ids in segment_patterns(4, 512, SEED + 85).items():
        held(attention_case(4, 4, 512, 64, torch.float32, ids, SEED + 86), f"bwd {name} ids")
        # the slots' widths: K7-f32's and K8-f32's other tiles (32 keys or
        # queries a block above hd = 64)
        for hd in (48, 128):
            held(attention_case(4, 4, 512, hd, torch.float32, ids, SEED + 86 + hd),
                 f"bwd {name} ids hd={hd}")

    b, nh, s, hd = 16, 16, 512, 64
    lengths = seeded_lengths(b, s, 200, SEED + 87)
    rows = train_rows_at((b, nh, s, hd), lengths, SEED + 88, launches, "")
    for row in rows:
        row["small_max_abs_err"] = small[row["name"]]
    rows[0]["bf16_lse_max_abs_err"] = max(small["K6-bf16-lse_lse_only"],
                                          rows[0].pop("bf16_lse_max_abs_err"))
    return rows


def train_rows_at(shape, lengths, seed, launches: dict, suffix: str) -> list:
    """K6-f32 with lse, K7 and K8 at ``shape`` = (B, nh, S, hd) with the given
    lengths (the case from ``seed``, dO from ``seed + 1``), held against their
    plain versions (compare_backward), timed beside them, beside SDPA's
    forward and autograd backward and beside the bound (for K6-f32-lse, K7-f32
    and K8-f32, whose products are 3xTF32, three TF32 products at the TF32 peak,
    the IEEE bound beside it, and their outputs' distances to float64 beside
    the plain versions' and SDPA's); with each kernel's registers and spills
    at that hd. Rows are named "<kernel><suffix>". ``launches`` maps entry
    points to the path's counts."""
    b, nh, s, hd = shape
    case = attention_case(b, nh, s, hd, torch.float32, lengths, seed)
    q, k, v, seg = case
    errs = compare_backward(case, f"training rows{suffix}")
    scale = 1.0 / float(np.sqrt(hd))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 1)
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
    bwd_tiles = flash_ops.bwd_tile_shapes(torch.float32, hd)
    tiles = {"K6-f32-lse": flash_ops.tile_shape(torch.float32, hd),
             "K7-f32": bwd_tiles["dkv"], "K8-f32": bwd_tiles["dq"]}
    per_pair = {"K6-f32-lse": 4, "K7-f32": 8, "K8-f32": 6}
    ptxas = {"K6-f32-lse": "flash_f32_kernel", "K7-f32": "bwd_dkv_tf32_kernel",
             "K8-f32": "bwd_dq_tf32_kernel"}
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
        extra = {}
        if name == "K6-f32-lse":  # 3xTF32: three TF32 products a product, at the TF32 peak
            extra = {"bound_ms_ieee": max(t_bytes, t_ops),
                     **f32_accuracy(q, k, v, seg, scale, out, lse)}
            t_ops = 3 * n_ops / PEAK_TF32_S * 1e3
        elif name == "K7-f32":  # the same, and the gradients beside float64's
            dk, dv = run()
            extra = {"bound_ms_ieee": max(t_bytes, t_ops),
                     **f32_bwd_accuracy(q, k, v, seg, scale, out, dout, lse, (dk, dv), (1, 2),
                                        sdpa_backward())}
            t_ops = 3 * n_ops / PEAK_TF32_S * 1e3
            del dk, dv
        elif name == "K8-f32":
            dq = run()
            extra = {"bound_ms_ieee": max(t_bytes, t_ops),
                     **f32_bwd_accuracy(q, k, v, seg, scale, out, dout, lse, (dq,), (0,),
                                        sdpa_backward())}
            t_ops = 3 * n_ops / PEAK_TF32_S * 1e3
            del dq
        ms = statistics.median([ms_a, ms_b])
        rows.append({
            "name": name + suffix,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches.get(entry, 0),
            "max_abs_err": errs[name],
            "tolerance": TOL_LSE if name == "K6-f32-lse" else TOL_BWD,
            "ms": ms,
            "plain_ms": statistics.median([plain_a, plain_b]),
            "plain": ("flash_attention_lse_plain" if name == "K6-f32-lse" else
                      "flash_attention_bwd_plain (dq, dk and dv together)"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **extra,
            "library_ms": lib_ms,
            "library": lib_what,
            "library_max_abs_err_vs_plain": lib_err if name != "K6-f32-lse" else None,
            "bound_bytes": n_bytes,
            "bound_operations": n_ops,
            "tflops_counted": n_ops / (ms * 1e-3) / 1e12,
            **multiplied_work(seg, tiles[name], per_pair[name], nh, hd, n_ops, ms),
            "shape": {"B": b, "nh": nh, "S": s, "hd": hd, "lengths_min": min(lengths),
                      "lengths_mean": float(np.mean(lengths))},
            f"ptxas_hd{hd}": ptxas_of(ptxas[name], hd),
        })
    rows[0]["bf16_lse_max_abs_err"] = errs["K6-bf16-lse_lse_only"]
    del case, q, k, v, seg, ops, lib_out, ql, kl, vl, same
    torch.cuda.empty_cache()
    return rows


def compare_backward_bf16(case, what) -> dict:
    """K6-bf16 with its log-sum-exp against flash_attention_lse_plain (the
    output per row as compare_attention holds K6-bf16, the log-sum-exp to
    TOL_LSE), then the bfloat16 K7 and K8 on one case against the plain
    backward given the same forward output and log-sum-exp (K6-bf16's), over
    every output position, pads included: the largest error and the largest
    share of its tensor's limit (TOL_BWD_BF16_REL * max|plain| +
    TOL_BWD_BF16_ABS)."""
    q, k, v, seg = case
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(q.shape[2] * 137 + q.shape[3])
    dout = torch.randn(q.shape, device=DEV, generator=gen).to(torch.bfloat16)
    out, lse = flash_ops.flash_attention_lse(q, k, v, seg, scale)
    ops = flash_ops._bwd_operands(q, k, v, seg, out, dout, lse)
    dk, dv = flash_ops._bwd_dkv(*ops, scale)
    dq = flash_ops._bwd_dq(*ops, scale)
    torch.cuda.synchronize()
    pout, plse = flash_ops.flash_attention_lse_plain(q, k, v, seg, scale)
    lse_err = float((lse - plse).abs().max())
    diff = (out.float() - pout.float()).abs()
    limit = TOL_K6_ROW_REL * pout.float().abs().amax(dim=-1, keepdim=True) + TOL_K6_ROW_ABS
    out_share = float((diff / limit).max())
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all(), what
    assert lse_err <= TOL_LSE and out_share <= 1.0, (what, lse_err, out_share)
    errs = {"K6-bf16-lse": max(lse_err, float(diff.max())), "K6-bf16-lse_share": out_share,
            "K6-bf16-lse_lse": lse_err}
    pdq, pdk, pdv = flash_ops.flash_attention_bwd_plain(q, k, v, seg, out, dout, lse, scale)
    for name, pairs in (("K7-bf16", ((dk, pdk), (dv, pdv))), ("K8-bf16", ((dq, pdq),))):
        err = share = 0.0
        for got, want in pairs:
            assert got.dtype == torch.bfloat16 and got.stride() == q.stride(), what
            assert torch.isfinite(got.float()).all(), what
            diff = float((got.float() - want.float()).abs().max())
            limit = TOL_BWD_BF16_REL * float(want.float().abs().max()) + TOL_BWD_BF16_ABS
            err, share = max(err, diff), max(share, diff / limit)
        assert share <= 1.0, (what, name, err, share)
        errs[name], errs[name + "_share"] = err, share
    return errs


def bf16_backward_cases():
    """(case, what) of every small bfloat16 backward case: S = 256 at every
    head width, S = 200 / 129 / 1, S = 333 and 384 at hd = 16, 32, 48, 80, 96
    and 128 with ragged lengths (tails past a 64-row wgmma tile and a 32- or
    64-row step, in each of K8's 32-, 64- and 128-byte swizzles) and the
    packed and cyclic ids. Made one at a time."""
    bf16 = torch.bfloat16
    for hd in (16, 32, 48, 64, 80, 96, 112, 128):
        yield (attention_case(4, 4, 256, hd, bf16, [256, 200, 64, 1], SEED + 180 + hd),
               f"bwd-bf16 S=256 hd={hd}")
    yield (attention_case(4, 4, 200, 64, bf16, [70, 1, 200, 130], SEED + 181), "bwd-bf16 S=200")
    yield (attention_case(4, 4, 129, 64, bf16, seeded_lengths(4, 129, 1, SEED + 182),
                          SEED + 183), "bwd-bf16 S=129")
    yield attention_case(3, 2, 1, 64, bf16, [1, 1, 0], SEED + 184), "bwd-bf16 S=1"
    for s in (333, 384):
        for hd in (16, 32, 48, 80, 96, 128):
            yield (attention_case(4, 4, s, hd, bf16, seeded_lengths(4, s, 1, SEED + 400 + s + hd),
                                  SEED + 401 + s + hd), f"bwd-bf16 S={s} hd={hd}")
    for name, ids in segment_patterns(4, 512, SEED + 185).items():
        yield attention_case(4, 4, 512, 64, bf16, ids, SEED + 186), f"bwd-bf16 {name} ids"


def train_bf16_kernel_rows(launches: dict) -> list:
    """The bfloat16 K7 and K8 at the training step's shape (the float32 rows'
    B = 16, nh = 16, S = 512, hd = 64 and lengths), after every case of
    bf16_backward_cases; with each backward kernel's registers, spills and
    blocks an SM at hd = 64. ``launches`` are the bfloat16 training path's."""
    small = {}
    for case, what in bf16_backward_cases():
        for name, err in compare_backward_bf16(case, what).items():
            small[name] = max(small.get(name, 0.0), err)
        del case

    b, nh, s, hd = 16, 16, 512, 64
    lengths = seeded_lengths(b, s, 200, SEED + 87)
    rows = train_bf16_rows_at((b, nh, s, hd), lengths, SEED + 88, launches, "")
    for row in rows:
        row["launches_per_step"] = row["launches"] // 4
        row["small_max_abs_err"] = small[row["name"]]
        row["small_max_share_of_tolerance"] = small[row["name"] + "_share"]
    return rows


def train_bf16_rows_at(shape, lengths, seed, launches: dict, suffix: str) -> list:
    """K6-bf16 with lse and the bfloat16 K7 and K8 at ``shape`` = (B, nh, S,
    hd), as train_rows_at does for float32 (compare_backward_bf16); with each
    kernel's registers and spills, and the backward kernels' blocks an SM, at
    that hd."""
    bf16 = torch.bfloat16
    b, nh, s, hd = shape
    case = attention_case(b, nh, s, hd, bf16, lengths, seed)
    q, k, v, seg = case
    errs = compare_backward_bf16(case, f"bf16 training rows{suffix}")
    scale = 1.0 / float(np.sqrt(hd))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 1)
    dout = torch.randn(q.shape, device=DEV, generator=gen).to(bf16)
    out, lse = flash_ops.flash_attention_lse(q, k, v, seg, scale)
    ops = flash_ops._bwd_operands(q, k, v, seg, out, dout, lse)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=same, scale=scale)

    def sdpa_backward():
        return torch.autograd.grad(lib_out, (ql, kl, vl), dout, retain_graph=True)

    def plain():
        return flash_ops.flash_attention_bwd_plain(q, k, v, seg, out, dout, lse, scale)

    lib_err = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(sdpa_backward(), plain()))
    pairs = sum(n * n + (s - n) * (s - n) for n in lengths)
    tensor = b * nh * s * hd * 2
    stats = b * nh * s * 4
    lib_what = ("autograd backward of scaled_dot_product_attention in bfloat16 "
                "(dq, dk, dv in one call), boolean (B, 1, S, S) segment mask")
    kinds = {
        "K6-bf16-lse": (lambda: flash_ops.flash_attention_lse(q, k, v, seg, scale),
                        4 * tensor + stats + b * s * 4, 4 * nh * hd * pairs,
                        "minivectordb_tpu/models/encoder.py:138 (bf16 operands, under "
                        "jax.value_and_grad: save_residuals)", "flash_attention_lse_bf16"),
        "K7-bf16": (lambda: flash_ops._bwd_dkv(*ops, scale),
                    6 * tensor + 2 * stats + b * s * 4, 8 * nh * hd * pairs,
                    "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                    "(_flash_attention_bwd_dkv, bf16 operands, from models/train.py:105 via "
                    "encoder.py:138)", "flash_attention_bwd_dkv_bf16"),
        "K8-bf16": (lambda: flash_ops._bwd_dq(*ops, scale),
                    5 * tensor + 2 * stats + b * s * 4, 6 * nh * hd * pairs,
                    "jax/experimental/pallas/ops/tpu/flash_attention.py:1456 "
                    "(_flash_attention_bwd_dq, bf16 operands, from models/train.py:105 via "
                    "encoder.py:138)", "flash_attention_bwd_dq_bf16"),
    }
    def plain_forward():
        return flash_ops.flash_attention_lse_plain(q, k, v, seg, scale)

    def sdpa_forward():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=scale)

    bwd_tiles = flash_ops.bwd_tile_shapes(bf16, hd)
    tiles = {"K6-bf16-lse": flash_ops.tile_shape(bf16, hd),
             "K7-bf16": bwd_tiles["dkv"], "K8-bf16": bwd_tiles["dq"]}
    per_pair = {"K6-bf16-lse": 4, "K7-bf16": 8, "K8-bf16": 6}
    rows = []
    for name, (run, n_bytes, n_ops, replaces, entry) in kinds.items():
        fwd = name == "K6-bf16-lse"
        plain_fn, lib_fn = (plain_forward, sdpa_forward) if fwd else (plain, sdpa_backward)
        # plain, kernel, kernel, plain: both versions inside one run
        plain_a = event_ms(plain_fn, 3, warmup=1)
        ms_a = event_ms(run, 20)
        ms_b = event_ms(run, 20)
        plain_b = event_ms(plain_fn, 3, warmup=1)
        lib_ms = event_ms(lib_fn, 10)
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n_ops / PEAK_OPS_S["bf16"] * 1e3
        ms = statistics.median([ms_a, ms_b])
        rows.append({
            "name": name + suffix,
            "route": "cuda",
            "source": ("minivectordb_tpu_torch/csrc/flash_attention.cu" if fwd else
                       "minivectordb_tpu_torch/csrc/flash_attention_bwd_bf16.cu"),
            "replaces": replaces,
            "launches": launches.get(entry, 0),
            "max_abs_err": errs[name],
            "max_share_of_tolerance": errs[name + "_share"],
            "tolerance": (f"output {TOL_K6_ROW_REL} * max|plain| over the row + "
                          f"{TOL_K6_ROW_ABS}, log-sum-exp {TOL_LSE}" if fwd else
                          f"{TOL_BWD_BF16_REL} * max|plain| + {TOL_BWD_BF16_ABS}, per tensor"),
            "ms": ms,
            "plain_ms": statistics.median([plain_a, plain_b]),
            "plain": ("flash_attention_lse_plain in bfloat16" if fwd else
                      "flash_attention_bwd_plain in bfloat16 (dq, dk and dv together)"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "library": ("scaled_dot_product_attention forward in bfloat16, boolean (B, 1, S, "
                        "S) segment mask" if fwd else lib_what),
            "library_max_abs_err_vs_plain": None if fwd else lib_err,
            "bound_bytes": n_bytes,
            "bound_operations": n_ops,
            "tflops_counted": n_ops / (ms * 1e-3) / 1e12,
            **multiplied_work(seg, tiles[name], per_pair[name], nh, hd, n_ops, ms),
            "shape": {"B": b, "nh": nh, "S": s, "hd": hd, "lengths_min": min(lengths),
                      "lengths_mean": float(np.mean(lengths))},
            f"ptxas_hd{hd}": ptxas_of(
                "flash_bf16_kernel" if fwd else
                "bwd_dkv_bf16_kernel" if name == "K7-bf16" else "bwd_dq_bf16_kernel", hd),
            **({} if fwd else {
                f"blocks_per_sm_hd{hd}": flash_ops.bwd_bf16_blocks_per_sm(
                    hd, "dkv" if name == "K7-bf16" else "dq")}),
        })
    del case, q, k, v, seg, ops, lib_out, ql, kl, vl, same
    torch.cuda.empty_cache()
    return rows


def main() -> None:
    smi = phase_env()
    with tempfile.TemporaryDirectory() as tmp:
        fused_scan.reset_launches()
        small_scan.reset_launches()
        main_data = phase_main_path(tmp)
        phase_dtypes(tmp)
        launches = dict(fused_scan.LAUNCHES)
        narrow = dict(fused_scan.NARROW_LAUNCHES)
        small_launches = dict(small_scan.LAUNCHES)
        # bf16 / int8 rows of 384 take the Hopper kernel, never the narrow one
        assert not any(narrow.values()), f"the flat paths reached the narrow kernel: {narrow}"
        torch.cuda.empty_cache()
        ivf_shapes, ivf_launches = phase_ivf_path(tmp)
        torch.cuda.empty_cache()
        sharded_launches = phase_sharded_path(tmp, main_data)
        torch.cuda.empty_cache()
        mesh_launches = phase_mesh_path(tmp, main_data)
        del main_data
        torch.cuda.empty_cache()
        model, texts, k6_launches = phase_encoder_path(tmp)
        phase_pipeline_path(tmp, model, texts, k6_launches)
        del model
        torch.cuda.empty_cache()
        slot_launches = phase_slots_path(tmp)
        torch.cuda.empty_cache()
        train_launches = phase_train_path(tmp)
        train_bf16_launches = phase_train_path_bf16(tmp)
        train_mesh_launches = phase_train_mesh_path(tmp)
    emit({"phase": "launches", "flat_path": launches, "flat_path_narrow": narrow,
          "flat_path_small_scan": small_launches,
          "ivf_path": ivf_launches, "sharded_path": sharded_launches,
          "mesh_path": mesh_launches,
          "text_path": k6_launches, "slots_path": slot_launches,
          "train_path": train_launches,
          "train_path_bf16": train_bf16_launches,
          "train_mesh_path": train_mesh_launches})
    path_counts = {**launches, **ivf_launches, "small_scan_f32": small_launches["small_scan_f32"],
                   **{n: k6_launches[n] for n in TEXT_ENTRY_POINTS},
                   **{n: train_launches["e5_large"][n] for n in TRAIN_ENTRY_POINTS},
                   **{n: train_bf16_launches[n] for n in TRAIN_BF16_ENTRY_POINTS}}
    missing = [name for name, n in path_counts.items() if n == 0]
    assert not missing, f"the main path never launched: {missing}"
    missing = SHARDED_ENTRY_POINTS - {n for n, c in sharded_launches.items() if c}
    assert not missing, f"the sharded path never launched: {missing}"
    missing = set().union(*MESH_ENTRY_POINTS.values()) - {
        n for n, c in mesh_launches.items() if c}
    assert not missing, f"the mesh path never launched: {missing}"
    missing = [n for n in TRAIN_ENTRY_POINTS + TRAIN_BF16_ENTRY_POINTS
               if not train_mesh_launches.get(n)]
    assert not missing, f"the training mesh path never launched: {missing}"
    torch.cuda.empty_cache()
    missing = [(hd, n) for hd in SLOT_HEAD_DIMS for n in TEXT_ENTRY_POINTS + TRAIN_ENTRY_POINTS
               if not slot_launches_at(slot_launches, hd).get(n)]
    assert not missing, f"the slots path never launched: {missing}"
    kernels = phase_kernels(launches, small_launches, ivf_shapes, ivf_launches, k6_launches,
                            train_launches["e5_large"], train_bf16_launches, slot_launches)
    for row in kernels["kernels"]:
        row["mesh_launches"] = mesh_launches.get(MESH_ROW_ENTRY.get(row["name"]), 0)
        row["train_mesh_launches"] = train_mesh_launches.get(TRAIN_ROW_ENTRY.get(row["name"]), 0)
    emit(kernels)
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
