"""Exact-scan search functions (plain PyTorch path).

Counterpart of ``minivectordb_tpu/ops/scan.py``. It replaces the reference's
FAISS usage:

- ``faiss.IndexFlatIP`` + ``normalize_L2`` + ``index.search``
  (reference vector_database.py:42-47, 495-507) -> normalize query -> masked
  cosine matmul -> top-k on the tensor's device.
- the reference's "filtered slow path" that builds a throwaway index per query
  (reference vector_database.py:508-523) -> the same function with a boolean
  row mask (masked rows score ``_MASKED_SCORE``), no index rebuild ever.
- the usearch int8 cosine index (reference
  sharded_vector_database_usearch.py:616-637) -> the int8-quantized variant.

Everything here is a plain function on tensors: it runs wherever its
arguments live (CUDA or CPU), holds no global device and compiles nothing.
The corpus lives in a padded buffer whose capacity takes bucketed values
(``capacity_bucket``) so that both packages run the same shapes; the live row
count is an ordinary integer and rows past it are masked.

Numerics, where this module differs from a naive PyTorch rendering:

- float32 products are IEEE float32. TF32 is switched off for matmul when
  this module is imported and asserted at every scan (the exact path must
  agree with a CPU float32 scan; the JAX package asks XLA for
  ``Precision.HIGHEST`` for the same reason).
- bfloat16 buffers give float32 scores: the operands are upcast, so products
  of bf16 values are exact and the sum is taken in float32
  (``torch.matmul(bf16, bf16)`` would round the result to bf16).
- int8 dots are exact integers: int8 values are exact in float32 and a sum of
  ``d`` products stays below 2^24 while ``d <= 1024``; longer rows are cut
  into 1024-wide pieces that are added in int32. CUDA ``torch.matmul`` has no
  int8 -> int32 form, so this is the one route on either device.
- top-k is deterministic: among equal scores the lower row comes first,
  also across the k-th boundary (``lax.top_k``'s order; ``torch.topk``
  promises none). See ``topk_last_axis``.
- ``mode="approx"``: the JAX package calls ``lax.approx_max_k`` for wide
  score matrices; PyTorch has no counterpart, so this route serves
  ``approx`` with the exact top-k. Results can only be better.

The row-update helpers may write IN PLACE (``in_place=True``); with
``in_place=False`` they clone first and leave their inputs untouched, which
is what a caller must ask for while a search snapshot still reads the old
tensors (see core/store.py:VectorStore.sync).
"""

from __future__ import annotations

import numpy as np
import torch

# The exact float32 path must not drop to TF32 (about three decimal digits):
# it would break exact-recall parity with a float32 scan on the CPU.
torch.backends.cuda.matmul.allow_tf32 = False

# Scores are cosine similarities in [-1, 1]; any value far below is an
# effective -inf that can never win top-k but avoids NaN propagation. The
# engine trims result slots on ``score < -1e38``.
_MASKED_SCORE = np.float32(-3.0e38)

# Rows of a low-precision buffer upcast to float32 at once (bounds the
# temporary: 65536 x 384 float32 is 100 MB).
_UPCAST_ROWS = 1 << 16
# Longest int8 row piece whose dot is exact in float32: d * 127^2 < 2^24.
_INT8_EXACT_D = 1024


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card and raises when there is none: the port
    does not carry on on the CPU unless the caller asks for ``"cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "minivectordb_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the host explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def is_device_array(x) -> bool:
    """True for a ``torch.Tensor`` query batch, which the public search APIs
    pass through without a host round trip (the JAX package's predicate for a
    device-resident ``jax.Array``). numpy arrays are not tensors. This is THE
    shared passthrough predicate — engine and store both route through it."""
    return isinstance(x, torch.Tensor)


def as_device_queries(x: torch.Tensor, device=None) -> torch.Tensor:
    """Normalize a tensor query batch where it lives: float32 dtype, 2-D
    (batch, dim) shape. With ``device`` it is moved there if it is elsewhere
    (a no-op for a tensor already on the store's device)."""
    q = x.detach()
    if device is not None and q.device != torch.device(device):
        q = q.to(device)
    if q.dtype != torch.float32:
        q = q.to(torch.float32)
    return q[None, :] if q.ndim == 1 else q


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Upload a numpy array. To a CUDA device the bytes go through a pinned
    staging tensor with a non-blocking copy (ordered on the current stream,
    so later work on that stream sees the data); PyTorch's pinned-memory
    allocator keeps the staging block alive until the copy has run."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch.from_numpy refuses read-only views
        arr = arr.copy()
    return _tensor_to_device(torch.from_numpy(arr), device)


def _tensor_to_device(t: torch.Tensor, device) -> torch.Tensor:
    device = torch.device(device)
    if device.type != "cuda":
        return t.clone()  # never alias the caller's (mutable) host memory
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)
    return staged.to(device, non_blocking=True)


class ResultFetch:
    """A (scores, indices) pair on its way to the host: constructing one
    starts the copy NOW (it queues behind the work that produces the pair).

    For CUDA tensors the pair is packed into ONE int32 tensor and copied with
    ``non_blocking=True`` into pinned host memory, followed by a CUDA event.
    ``get()`` waits on that event before it reads the pinned buffer: reading
    it earlier would silently return stale bytes. numpy pairs and CPU tensors
    pass through."""

    __slots__ = ("_pair", "_host", "_event")

    def __init__(self, vals, idx):
        self._pair = None
        self._host = None
        self._event = None
        if isinstance(vals, np.ndarray) and isinstance(idx, np.ndarray):
            self._pair = (vals, idx)
        elif vals.device.type != "cuda":
            self._pair = (vals.numpy(), idx.to(torch.int32).numpy())
        else:
            packed = torch.stack(
                [vals.contiguous().view(torch.int32), idx.to(torch.int32)]
            )
            self._host = torch.empty(
                packed.shape, dtype=torch.int32, pin_memory=True
            )
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(vals.device))

    def get(self) -> tuple[np.ndarray, np.ndarray]:
        if self._pair is None:
            self._event.synchronize()
            host = self._host.numpy()
            self._pair = (host[0].view(np.float32), host[1])
            self._host = self._event = None
        return self._pair


def fetch_results(vals, idx) -> tuple[np.ndarray, np.ndarray]:
    """Materialize a (scores, indices) result pair in ONE host transfer.
    Host-routed results (already numpy) pass through untouched."""
    return ResultFetch(vals, idx).get()


def k_bucket(search_k: int, capacity: int) -> int:
    """Round k up to a power of two (the JAX package bounds its compile cache
    this way; kept so both packages run the same shapes)."""
    b = 1
    while b < search_k:
        b <<= 1
    return min(b, capacity)


# Above this row count, capacity buckets step linearly instead of doubling:
# pow2 doubling wastes up to half of device memory exactly where it is scarce
# (a 10M-row corpus would pad to 16.8M rows).
_LINEAR_BUCKET_STEP = 1 << 21


def capacity_bucket(n: int, minimum: int = 1024) -> int:
    """Round a row count up to a device buffer capacity bucket.

    Power-of-two up to 2^21 rows, then multiples of 2^21: the overshoot is
    capped at 2^21 rows. Every bucket from 4096 up is a multiple of 4096, so
    32-row subtiles and the phase-1 kernel's row tiles always divide it, and
    the function stays monotone (callers rely on bucket(a) <= bucket(b) for
    a <= b when clamping padded writes to the buffer)."""
    c = minimum
    while c < n and c < _LINEAR_BUCKET_STEP:
        c <<= 1
    if c < n:
        c = -(-n // _LINEAR_BUCKET_STEP) * _LINEAR_BUCKET_STEP
    return c


def _normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=1e-30)


def _assert_ieee_f32(t: torch.Tensor) -> None:
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 was switched on after "
            "minivectordb_tpu_torch was imported; the exact scan needs IEEE "
            "float32 products"
        )


def topk_last_axis(
    scores: torch.Tensor, k: int, mode: str = "exact"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, deterministic under ties.

    scores: (..., C) float32. Returns (values, indices) each (..., k),
    descending; among equal scores the LOWER index comes first, and when the
    k-th score is tied the lower indices are the ones kept — ``lax.top_k``'s
    order, which ``torch.topk`` does not promise. Each score is mapped to an
    order-preserving int32, widened to int64 and joined with ``C-1-index`` in
    the low word, so every key is distinct and one ``torch.topk`` decides.
    -0.0 counts as +0.0; NaN is not expected (scores are finite by
    construction).

    ``mode="approx"`` is served exactly (see the module docstring)."""
    c = scores.shape[-1]
    bits = (scores + 0.0).contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    pos = torch.arange(c - 1, -1, -1, device=scores.device, dtype=torch.int64)
    keys = (ordered.to(torch.int64) << 32) | pos
    top = torch.topk(keys, k, dim=-1).values
    idx = (c - 1) - (top & 0xFFFFFFFF)
    return torch.gather(scores, -1, idx), idx


def dots_f32(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, d) x (N, d) -> (B, N) float32 dot products. float32 operands
    multiply in IEEE float32; lower-precision floating operands (both of the
    same type) are upcast in row pieces, so their products are exact and the
    sum is taken in float32."""
    _assert_ieee_f32(rows)
    if rows.dtype == torch.float32:
        return q @ rows.T
    n = rows.shape[0]
    qf = q.to(torch.float32)
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=rows.device)
    for lo in range(0, n, _UPCAST_ROWS):
        hi = min(lo + _UPCAST_ROWS, n)
        out[:, lo:hi] = qf @ rows[lo:hi].to(torch.float32).T
    return out


def dots_int8(qi: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, d) int8 x (N, d) int8 -> (B, N) int32, exact (see the module
    docstring for the route)."""
    _assert_ieee_f32(rows)
    n, d = rows.shape
    out = torch.empty((qi.shape[0], n), dtype=torch.int32, device=rows.device)
    qf = qi.to(torch.float32)
    for lo in range(0, n, _UPCAST_ROWS):
        hi = min(lo + _UPCAST_ROWS, n)
        blk = rows[lo:hi].to(torch.float32)
        acc = None
        for k0 in range(0, d, _INT8_EXACT_D):
            part = (qf[:, k0:k0 + _INT8_EXACT_D]
                    @ blk[:, k0:k0 + _INT8_EXACT_D].T).to(torch.int32)
            acc = part if acc is None else acc + part
        out[:, lo:hi] = acc
    return out


def quantize_queries_int8(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric 127-scale quantization: round half to even, clip
    to +-127 (never -128). Returns (int8 (B, d), float32 (B,) 1/||int8 q||)."""
    qf = q.to(torch.float32)
    qmax = qf.abs().amax(dim=-1, keepdim=True)
    qscale = torch.clamp(qmax, min=1e-30) / 127.0
    qi = torch.clamp(torch.round(qf / qscale), -127, 127).to(torch.int8)
    q_inv = 1.0 / torch.clamp(
        torch.linalg.vector_norm(qi.to(torch.float32), dim=-1), min=1e-30
    )
    return qi, q_inv


def _valid_rows(c: int, count: int, mask, device) -> torch.Tensor:
    valid = torch.arange(c, device=device) < count
    if mask is not None:
        valid = valid & mask
    return valid


# ---------------------------------------------------------------------------
# float32 / bfloat16 cosine scan
# ---------------------------------------------------------------------------


def scan_topk(buf, inv_norms, q, count, k, mask=None, mode="exact"):
    """Cosine scan + top-k for a batch of queries.

    buf:       (C, d) float32 or bfloat16 — padded corpus, raw (unnormalized)
    inv_norms: (C,)   float32 — 1/||row||  (0 for zero rows)
    q:         (B, d) float32 — raw queries
    count:     int — number of live rows (<= C)
    mask:      optional (C,) bool — candidate rows (filtered search)

    Returns (values (B, k) float32, indices (B, k) int32), descending cosine,
    lower row first among equal scores. Materializes the (B, C) score matrix:
    this is the small-batch route (core/store.py sends batches of 16 and more
    over 4096-row buffers to ops/fused_scan.py instead).
    """
    c = buf.shape[0]
    qn = _normalize(q.to(torch.float32)).to(buf.dtype)
    scores = dots_f32(qn, buf) * inv_norms[None, :]
    valid = _valid_rows(c, count, mask, buf.device)
    scores = scores.masked_fill(~valid[None, :], float(_MASKED_SCORE))
    vals, idx = topk_last_axis(scores, k, mode)
    return vals, idx.to(torch.int32)


# ---------------------------------------------------------------------------
# int8 cosine scan (usearch-equivalent)
# ---------------------------------------------------------------------------


def scan_topk_int8(buf_i8, inv_norms_i8, q, count, k, mask=None, mode="exact"):
    """Int8 symmetric-quantized cosine scan + top-k.

    buf_i8:       (C, d) int8 — per-row symmetric-quantized corpus
    inv_norms_i8: (C,) float32 — 1/||int8 row||  (0 for zero rows)
    q:            (B, d) float32

    Cosine of the quantized vectors: (qi . ri) / (||qi|| ||ri||), matching the
    usearch `metric='cos', dtype='i8'` behavior the reference relies on
    (sharded_vector_database_usearch.py:621-627). Returns similarities.
    The multiply order is ``dots * q_inv_norm * inv_norms`` (the fused route
    scales by the row norm first; each route keeps its own order).
    """
    c = buf_i8.shape[0]
    qi, q_inv = quantize_queries_int8(q)
    dots = dots_int8(qi, buf_i8).to(torch.float32)
    scores = dots * q_inv[:, None] * inv_norms_i8[None, :]
    valid = _valid_rows(c, count, mask, buf_i8.device)
    scores = scores.masked_fill(~valid[None, :], float(_MASKED_SCORE))
    vals, idx = topk_last_axis(scores, k, mode)
    return vals, idx.to(torch.int32)


# ---------------------------------------------------------------------------
# Incremental device-buffer maintenance
# ---------------------------------------------------------------------------


def row_inv_norms(rows: torch.Tensor) -> torch.Tensor:
    """1/||row|| per row, 0 for all-zero rows. rows: (n, d) -> (n,) f32."""
    sq = torch.sum(rows.to(torch.float32) ** 2, dim=-1)
    return torch.where(
        sq > 0, torch.rsqrt(torch.clamp(sq, min=1e-38)), torch.zeros_like(sq)
    )


def _check_window(buf, n: int, start: int) -> None:
    if start < 0 or start + n > buf.shape[0]:
        raise ValueError(
            f"row window [{start}, {start + n}) outside buffer of "
            f"{buf.shape[0]} rows"
        )


def update_rows(buf, inv_norms, rows, start, in_place: bool):
    """Write ``rows`` into buf[start:start+n] and their inverse norms into
    inv_norms — replaces the reference's full-index rebuild on every mutation
    (vector_database.py:42-47): only the changed row range is touched.
    ``in_place=True`` mutates the given tensors; ``in_place=False`` clones
    them first (callers must ask for that whenever a live search snapshot
    still references them). Returns (buf, inv_norms)."""
    n = rows.shape[0]
    _check_window(buf, n, start)
    rows = rows.to(buf.dtype)
    if not in_place:
        buf, inv_norms = buf.clone(), inv_norms.clone()
    buf[start:start + n] = rows
    inv_norms[start:start + n] = row_inv_norms(rows)
    return buf, inv_norms


# Large host->device transfers go up in bounded slabs, which bounds the
# pinned staging memory and the host-side cast temporaries.
_UPLOAD_SLAB_BYTES = 256 << 20


def upload_slab_rows(d: int, itemsize: int = 4) -> int:
    """Power-of-two rows per bulk-upload slab, sized so one slab transfers
    ~<= _UPLOAD_SLAB_BYTES of the UPLOADED dtype (pass its itemsize:
    quantized uploads move 4x/2x more rows per slab for the same bytes)."""
    slab = max(8, _UPLOAD_SLAB_BYTES // max(d * itemsize, 1))
    return max(8, capacity_bucket(slab, 8) >> 1)


def update_rows_cast(buf_lowp, rows, start, in_place: bool):
    """Write f32 ``rows`` into a lower-precision shadow buffer (the 'mixed'
    mode's bfloat16 phase-1 shadow). Same ``in_place`` rule as update_rows."""
    n = rows.shape[0]
    _check_window(buf_lowp, n, start)
    if not in_place:
        buf_lowp = buf_lowp.clone()
    buf_lowp[start:start + n] = rows.to(buf_lowp.dtype)
    return buf_lowp


def update_rows_int8(buf_i8, inv_norms_i8, rows, start, in_place: bool):
    """Quantize ``rows`` (f32) to int8 (per-row symmetric, round half to
    even, clip to +-127) and write them at ``start``. Same ``in_place`` rule
    as update_rows."""
    n = rows.shape[0]
    _check_window(buf_i8, n, start)
    rmax = rows.abs().amax(dim=-1, keepdim=True)
    rscale = torch.clamp(rmax, min=1e-30) / 127.0
    ri = torch.clamp(torch.round(rows / rscale), -127, 127).to(torch.int8)
    if not in_place:
        buf_i8, inv_norms_i8 = buf_i8.clone(), inv_norms_i8.clone()
    buf_i8[start:start + n] = ri
    inv_norms_i8[start:start + n] = row_inv_norms(ri)
    return buf_i8, inv_norms_i8


def _host_inv_norms_of(vals_f32: np.ndarray) -> np.ndarray:
    sq = np.sum(np.square(vals_f32, dtype=np.float32), axis=-1, dtype=np.float32)
    return np.where(
        sq > 0, 1.0 / np.sqrt(np.maximum(sq, np.float32(1e-38))), 0.0
    ).astype(np.float32)


def quantize_rows_int8_host(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side mirror of ``update_rows_int8``'s per-row symmetric 127-scale
    quantization (numpy round is the same round-half-to-even), so bulk
    uploads can send the STORED int8 bytes over the link instead of the f32
    originals — 4x fewer bytes host->device. Returns (int8 rows,
    f32 1/||int8 row|| inverse norms, 0 for all-zero rows)."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    rmax = np.max(np.abs(rows), axis=-1, keepdims=True)
    rscale = np.maximum(rmax, np.float32(1e-30)) / np.float32(127.0)
    ri = np.clip(np.round(rows / rscale), -127, 127).astype(np.int8)
    return ri, _host_inv_norms_of(ri)


def cast_rows_bf16_host(rows: np.ndarray) -> tuple[torch.Tensor, np.ndarray]:
    """Host-side mirror of ``update_rows`` for a bfloat16 buffer: cast the
    rows to bf16 (round to nearest even, halving the link bytes) and compute
    the inverse norms from the bf16-ROUNDED values, exactly as the device
    update path does (it casts first, then norms the cast rows). Returns
    (CPU bfloat16 tensor, f32 inverse norms as numpy)."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    rb = torch.from_numpy(rows).to(torch.bfloat16)
    return rb, _host_inv_norms_of(rb.to(torch.float32).numpy())


def write_rows_pre(buf, inv_norms, rows, inorm, start, in_place: bool):
    """Write PRE-quantized rows (dtype already == buf.dtype) and their
    host-computed inverse norms — the device does no cast work, so the
    transfer carries exactly the stored bytes. Same ``in_place`` rule as
    update_rows."""
    n = rows.shape[0]
    _check_window(buf, n, start)
    if rows.dtype != buf.dtype:
        raise TypeError(f"rows are {rows.dtype}, buffer is {buf.dtype}")
    if not in_place:
        buf, inv_norms = buf.clone(), inv_norms.clone()
    buf[start:start + n] = rows
    inv_norms[start:start + n] = inorm
    return buf, inv_norms


# -- tombstone-delete support (deferred compaction) ---------------------------
# Deletes mark rows dead instead of compacting the packed matrix eagerly
# (the reference's np.delete, vector_database.py:126, moves the whole tail
# per call). On device the alive mask updates by an O(deleted) index
# scatter; physical compaction is deferred and, when it runs, rearranges the
# device buffer with a gather there instead of re-streaming the tail
# through the host link.


def clear_mask_rows(mask: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    """A copy of ``mask`` with ``rows`` set False. NEVER in place: snapshots
    captured before the delete hold the previous alive mask and must keep
    reading it (a capacity-wide bool tensor is 1 MB at 1M rows).

    Rows at or past ``mask.shape[0]`` are dropped, as JAX's
    ``.at[rows].set(False)`` drops them: a row appended since the last sync
    lies past the device capacity, and that sync rebuilds the mask at the new
    capacity anyway."""
    out = mask.clone()
    rows = np.asarray(rows, dtype=np.int64)
    idx = to_device(rows[rows < mask.shape[0]], mask.device)
    out[idx] = False
    return out


def compact_gather(buf, inv_norms, perm):
    """(buf[perm], inv_norms[perm]). A gather always produces fresh tensors,
    so there is no in-place form: snapshots that hold the old ones stay
    valid, and the old ones are freed when nothing references them."""
    return buf.index_select(0, perm), inv_norms.index_select(0, perm)


def compact_gather_one(buf, perm):
    return buf.index_select(0, perm)
