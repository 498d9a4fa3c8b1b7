"""Device-resident packed vector store with a host-canonical mirror.

Counterpart of ``minivectordb_tpu/core/store.py``. Replaces the reference's
storage layer (numpy vstack-per-insert + faiss index rebuild-on-dirty,
vector_database.py:42-47, 57-81, 477-479):

- Host side: a preallocated numpy matrix with bucketed capacity growth, so
  appends are O(1) amortized (the reference's np.vstack is O(N*d) per
  insert). The host mirror is canonical — it is what gets pickled and what
  the public ``db.embeddings`` view exposes.
- Device side: a padded tensor on ``device`` (same capacity buckets) plus
  precomputed per-row 1/norms, synced lazily: only the dirty row range is
  re-uploaded and re-normalized (ops/scan.py:update_rows), never the whole
  corpus. Searches consume the device buffer directly; there is no "index"
  object to rebuild.

In-place writes. Unlike the JAX package, whose arrays are immutable, this
store WRITES ITS DEVICE TENSORS IN PLACE when it may: ``sync`` and
``compact_dead`` mutate the current buffer only while no live snapshot
references it (``_may_donate``, the condition under which the JAX package
donates its buffer); otherwise they clone, write the clone and swap, so a
search running outside the lock over an older snapshot keeps reading the
rows it was given. The alive mask is never written in place.

Routing. Small exact searches may run as a host BLAS scan instead of a
device launch; an adaptive router times both and keeps the faster. That is
a route of the package, with the same answers, not a fall-back: a device
error always reaches the caller. The router's first device timing is taken
in line on the caller's thread (eager PyTorch has no long compile to hide).
Batches of 16 and more over buffers of 4096 rows and more take the fused
route (ops/fused_scan.py: the phase-1 kernel on a CUDA device, its plain
version on the CPU); the rest take ops/scan.py.
"""

from __future__ import annotations

import os
import time
import weakref

import numpy as np
import torch

from minivectordb_tpu_torch.ops import fused_scan
from minivectordb_tpu_torch.ops import scan as scan_ops
from minivectordb_tpu_torch.utils.telemetry import span

_MIN_CAPACITY = 1024
# Beyond this dirty fraction of capacity, a full re-upload is cheaper than
# streaming the range.
_FULL_SYNC_FRACTION = 0.5

# Small-batch searches over small corpora may run as a host BLAS scan instead
# of a device launch. Eligibility is bounded by corpus bytes; an adaptive
# router then times both paths and keeps whichever actually wins on this
# machine, re-probing periodically. Above the bound a single-query host scan
# is seconds-class everywhere.
_HOST_SCAN_MAX_BYTES = int(
    os.environ.get("MINIVECTORDB_TORCH_HOST_SCAN_BYTES", 1024 << 20)
)
_HOST_SCAN_MAX_BATCH = 8
# Below this corpus size the host always serves and the device path is never
# timed.
_HOST_ALWAYS_BYTES = 8 << 20
_ROUTER_REFRESH_EVERY = 256
_ROUTER_FIRST_PROBE = 4  # host calls before the first device timing
# Pow2 batch padding applies only up to this size; larger explicit batches
# pad to a multiple of it — see _device_search.
_POW2_PAD_MAX_BATCH = 256
# The fused route (ops/fused_scan.py) serves batches and buffers from these
# sizes up.
_FUSED_MIN_BATCH = 16
_FUSED_MIN_CAPACITY = 4096

_TORCH_DTYPES = {
    "float32": torch.float32,
    "mixed": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


class _ScanRouter:
    """Adaptive host-vs-device routing for eligible (small) scans.

    Keeps a wall-time EMA per path. The host path primes first; after
    ``_ROUTER_FIRST_PROBE`` host calls the device path is timed in line, on a
    real query (once to warm, once timed). After both EMAs exist the faster
    path serves and the slower one is re-timed every
    ``_ROUTER_REFRESH_EVERY`` calls so the decision tracks corpus growth."""

    __slots__ = ("host_ema", "dev_ema", "n")

    def __init__(self):
        self.host_ema = None
        self.dev_ema = None
        self.n = 0

    def choose(self) -> str:
        self.n += 1
        if self.host_ema is None:
            return "host"
        if self.dev_ema is None:
            return "device" if self.n > _ROUTER_FIRST_PROBE else "host"
        fast = "host" if self.host_ema <= self.dev_ema else "device"
        if self.n % _ROUTER_REFRESH_EVERY == 0:
            return "device" if fast == "host" else "host"
        return fast

    def record(self, which: str, dt: float) -> None:
        attr = "host_ema" if which == "host" else "dev_ema"
        ema = getattr(self, attr)
        setattr(self, attr, dt if ema is None else 0.7 * ema + 0.3 * dt)


def _host_inv_norms(rows: np.ndarray) -> np.ndarray:
    """numpy mirror of ops/scan.py:row_inv_norms (0 for all-zero rows)."""
    sq = np.einsum("nd,nd->n", rows, rows, dtype=np.float32)
    out = np.zeros(rows.shape[0], dtype=np.float32)
    nz = sq > 0
    out[nz] = 1.0 / np.sqrt(sq[nz])
    return out


class VectorStore:
    """Packed (N, d) float32 corpus: host-canonical, device-cached.

    ``device=None`` means the CUDA card (an error when there is none);
    ``device="cpu"`` keeps the device cache in host memory (the tests).
    Not thread-safe by itself; the owning database serializes access.
    """

    def __init__(self, dim: int, device_dtype: str = "float32", device=None):
        if device_dtype not in ("float32", "bfloat16", "int8", "mixed"):
            raise ValueError(f"Unsupported device dtype: {device_dtype}")
        # 'mixed': float32 buffer (authoritative rescoring) + bfloat16 shadow
        # used only for phase-1 selection.
        self.dim = int(dim)
        self.device_dtype = device_dtype
        self.device = scan_ops.resolve_device(device)
        self.count = 0
        self._data = np.zeros((_MIN_CAPACITY, self.dim), dtype=np.float32)
        # Host 1/||row|| mirror (kept in lockstep with _data) + the adaptive
        # host/device scan router; weakrefs to snapshots holding the CURRENT
        # host arrays force copy-on-write on in-place host mutations (delete
        # compaction, row replacement) so a host scan outside the lock never
        # sees shifted rows.
        self._norms_host = np.zeros(_MIN_CAPACITY, dtype=np.float32)
        self._host_snap_refs: list[weakref.ref] = []
        self.router = _ScanRouter()
        # Tombstoned rows (deferred compaction): deletes mark rows dead in
        # O(deleted) instead of moving the O(N*d) tail per call like the
        # reference's np.delete (vector_database.py:126). Dead rows are
        # masked at search time (host: score sentinel; device: alive-mask
        # scatter, O(deleted) link bytes); compact_dead() folds them out when
        # the owner decides.
        self._dead_host: np.ndarray | None = None  # bool, host-capacity
        self.dead_count = 0
        self._alive_dev = None  # (dev_capacity,) bool on device; True=alive
        self._alive_cache: tuple | None = None  # ((count, dead), host alive)
        # Device cache state
        self._buf = None
        self._scan_buf = None  # bf16 shadow ('mixed' mode only)
        self._inv_norms = None
        self._dev_capacity = 0
        self._dirty_from = 0  # lowest host row not reflected on device
        # weakrefs to snapshots created against the CURRENT device buffer.
        # sync() may write that buffer in place only while none is alive —
        # otherwise a search running outside the lock would see rows change
        # under it.
        self._snap_refs: list[weakref.ref] = []

    # -- host-side API -----------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._data.shape[0]

    def view(self) -> np.ndarray:
        """Zero-copy view of the live rows (the public ``embeddings``)."""
        return self._data[: self.count]

    def row(self, i: int) -> np.ndarray:
        return self._data[i]

    def _ensure_host_capacity(self, need: int) -> None:
        cap = self.capacity
        if need <= cap:
            return
        new_cap = scan_ops.capacity_bucket(need, _MIN_CAPACITY)
        grown = np.zeros((new_cap, self.dim), dtype=np.float32)
        grown[: self.count] = self._data[: self.count]
        self._data = grown
        norms = np.zeros(new_cap, dtype=np.float32)
        norms[: self.count] = self._norms_host[: self.count]
        self._norms_host = norms
        if self._dead_host is not None:
            dead = np.zeros(new_cap, dtype=bool)
            dead[: self.count] = self._dead_host[: self.count]
            self._dead_host = dead
        self._host_snap_refs = []  # snapshots hold the OLD arrays — fine

    def _host_cow(self) -> None:
        """Copy-on-write before an in-place mutation of live host rows, so a
        snapshot search running outside the lock keeps a consistent view."""
        self._host_snap_refs = [r for r in self._host_snap_refs if r() is not None]
        if self._host_snap_refs:
            self._data = self._data.copy()
            self._norms_host = self._norms_host.copy()
            self._host_snap_refs = []

    def append(self, rows: np.ndarray) -> range:
        """Append rows (n, d) float32; returns the assigned row range."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        n = rows.shape[0]
        start = self.count
        self._ensure_host_capacity(start + n)
        self._data[start : start + n] = rows
        self._norms_host[start : start + n] = _host_inv_norms(rows)
        self._dirty_from = min(self._dirty_from, start)
        self.count = start + n
        return range(start, start + n)

    def delete_rows(self, rows: list[int] | np.ndarray) -> None:
        """Compact away the given row indices (keeps relative order).

        Mirrors the reference's eager np.delete compaction
        (vector_database.py:126) so row numbers stay dense; only the suffix
        from the first deleted row becomes device-dirty.
        """
        if len(rows) == 0:
            return
        rows = np.asarray(sorted(set(int(r) for r in rows)), dtype=np.int64)
        first = int(rows[0])
        keep = np.ones(self.count, dtype=bool)
        keep[rows] = False
        self._host_cow()
        kept_tail = self._data[first : self.count][keep[first:]]
        self._data[first : first + kept_tail.shape[0]] = kept_tail
        norm_tail = self._norms_host[first : self.count][keep[first:]]
        self._norms_host[first : first + norm_tail.shape[0]] = norm_tail
        self.count = first + kept_tail.shape[0]
        self._dirty_from = min(self._dirty_from, first)

    # -- tombstoned (deferred-compaction) deletes ----------------------------

    @property
    def live_count(self) -> int:
        return self.count - self.dead_count

    @property
    def alive_host(self) -> np.ndarray | None:
        """(count,) bool, True = live row; None when nothing is tombstoned.
        Cached per (count, dead_count) — both are monotone between compactions,
        so the key is unique per mutation state. Returned arrays are never
        mutated (recomputes allocate fresh), so snapshots may hold them."""
        if not self.dead_count:
            return None
        key = (self.count, self.dead_count)
        if self._alive_cache is None or self._alive_cache[0] != key:
            self._alive_cache = (key, ~self._dead_host[: self.count])
        return self._alive_cache[1]

    def dead_rows(self) -> np.ndarray:
        """Sorted physical indices of tombstoned rows (int64)."""
        if not self.dead_count:
            return np.zeros(0, dtype=np.int64)
        return np.flatnonzero(self._dead_host[: self.count]).astype(np.int64)

    def tombstone_rows(self, rows) -> int:
        """Mark rows dead without moving any matrix bytes: O(deleted) host
        work + an O(deleted) index scatter into (a copy of) the device alive
        mask. Returns the number of newly-dead rows."""
        rows = np.asarray(sorted({int(r) for r in rows}), dtype=np.int64)
        rows = rows[(rows >= 0) & (rows < self.count)]
        if rows.size == 0:
            return 0
        if self._dead_host is None:
            self._dead_host = np.zeros(self.capacity, dtype=bool)
        else:
            # copy-on-write: snapshots capture the dead array too
            self._host_snap_refs = [
                r for r in self._host_snap_refs if r() is not None
            ]
            if self._host_snap_refs:
                self._dead_host = self._dead_host.copy()
        n_new = int((~self._dead_host[rows]).sum())
        self._dead_host[rows] = True
        self.dead_count += n_new
        if (
            self._alive_dev is not None
            and self._alive_dev.shape[0] == self._dev_capacity
        ):
            self._alive_dev = scan_ops.clear_mask_rows(self._alive_dev, rows)
        else:
            self._alive_dev = None  # rebuilt on next sync()
        return n_new

    def compact_dead(self) -> np.ndarray:
        """Physically fold out tombstoned rows (host memmove + on-device
        gather). The device buffer — when current — is rearranged by a
        permutation gather on the device (an index upload, a few bytes per
        row) instead of re-streaming the compacted f32 tail through the link
        (~4*d B/row). The gather writes fresh tensors, so older snapshots
        keep theirs. Returns the sorted dead indices removed (callers remap
        their own row-aligned state with them)."""
        dead = self.dead_rows()
        if dead.size == 0:
            return dead
        old_count = self.count
        keep = ~self._dead_host[: old_count]
        first = int(dead[0])
        self._host_cow()
        kept_tail = self._data[first:old_count][keep[first:]]
        self._data[first : first + kept_tail.shape[0]] = kept_tail
        norm_tail = self._norms_host[first:old_count][keep[first:]]
        self._norms_host[first : first + norm_tail.shape[0]] = norm_tail
        self.count = first + kept_tail.shape[0]
        device_current = (
            self._buf is not None
            and self._dirty_from >= old_count
            and scan_ops.capacity_bucket(max(self.count, 1), _MIN_CAPACITY)
            == self._dev_capacity
        )
        if device_current:
            perm = np.zeros(self._dev_capacity, dtype=np.int64)
            kept_idx = np.flatnonzero(keep)
            perm[: kept_idx.shape[0]] = kept_idx
            # rows past the live prefix keep index 0 (stale data in the
            # dead zone beyond `count`, masked at search time like padding)
            permd = scan_ops.to_device(perm, self.device)
            self._buf, self._inv_norms = scan_ops.compact_gather(
                self._buf, self._inv_norms, permd
            )
            if self._scan_buf is not None:
                self._scan_buf = scan_ops.compact_gather_one(
                    self._scan_buf, permd
                )
            self._snap_refs = []
            self._dirty_from = self.count
        else:
            self._dirty_from = min(self._dirty_from, first)
        self._dead_host = None
        self.dead_count = 0
        self._alive_dev = None
        self._alive_cache = None
        return dead

    def replace_row(self, i: int, row: np.ndarray) -> None:
        self._host_cow()
        row = np.asarray(row, dtype=np.float32)
        self._data[i] = row
        self._norms_host[i] = _host_inv_norms(row[None, :])[0]
        self._dirty_from = min(self._dirty_from, i)

    def load(self, matrix: np.ndarray) -> None:
        """Reset contents from a dense (N, d) matrix (pickle load path)."""
        matrix = np.ascontiguousarray(matrix, dtype=np.float32)
        self.count = 0
        self._dirty_from = 0
        self._buf = None
        self._scan_buf = None
        self._inv_norms = None
        self._dev_capacity = 0
        # fresh host arrays: snapshots of the old corpus stay untouched
        self._data = np.zeros((_MIN_CAPACITY, self.dim), dtype=np.float32)
        self._norms_host = np.zeros(_MIN_CAPACITY, dtype=np.float32)
        self._dead_host = None
        self.dead_count = 0
        self._alive_dev = None
        self._alive_cache = None
        self._host_snap_refs = []
        if matrix.shape[0]:
            self.append(matrix)

    # -- device-side API ---------------------------------------------------

    def _full_upload(self, dev_cap: int) -> None:
        """Stream host slabs straight into a fresh target-dtype buffer with
        in-place writes (no full-size f32 intermediate on the device).
        Quantized modes cast HOST-side, so the link carries exactly the
        stored bytes (4x fewer for int8, 2x for bf16), not the f32
        originals. Slab rows beyond `count` may carry stale host-mirror
        data; like the incremental-sync padding they land in the dead zone
        beyond `count`, masked at search time."""
        dtype = _TORCH_DTYPES[self.device_dtype]
        n, d = self.count, self.dim
        buf = torch.zeros((dev_cap, d), dtype=dtype, device=self.device)
        inv = torch.zeros((dev_cap,), dtype=torch.float32, device=self.device)
        scan_buf = (
            torch.zeros((dev_cap, d), dtype=torch.bfloat16, device=self.device)
            if self.device_dtype == "mixed"
            else None
        )
        buf, inv, scan_buf = self._stream_rows(
            buf, inv, scan_buf, 0, n, dev_cap, in_place=True
        )
        self._buf = buf
        self._inv_norms = inv
        if self.device_dtype == "mixed":
            self._scan_buf = scan_buf
        self._dev_capacity = dev_cap
        self._dirty_from = self.count
        self._alive_dev = None  # capacity may have moved; rebuilt in sync()
        self._snap_refs = []

    def _stream_rows(self, buf, inv, scan_buf, lo, hi, dev_cap, in_place):
        """Write host rows [lo, hi) into the device buffers in bounded
        power-of-two slabs (each padded window shifted left at the buffer
        edge; rewriting already-clean rows is harmless). `in_place` applies
        to the FIRST write only — every later write receives the fresh
        tensors the previous one produced, which nothing else can
        reference."""
        itemsize = {"int8": 1, "bfloat16": 2}.get(self.device_dtype, 4)
        slab = scan_ops.upload_slab_rows(self.dim, itemsize)
        start = lo
        while start < hi:
            p = min(slab, scan_ops.capacity_bucket(hi - start, 8))
            w = min(start, dev_cap - p)
            piece = self._data[w : w + p]
            if self.device_dtype in ("int8", "bfloat16"):
                # quantize/cast HOST-side: the link carries the stored
                # bytes (4x/2x fewer than f32), same math as the device
                # update functions (scan_ops.quantize_rows_int8_host /
                # cast_rows_bf16_host mirror them)
                if self.device_dtype == "int8":
                    qr, inorm = scan_ops.quantize_rows_int8_host(piece)
                    qr = scan_ops.to_device(qr, self.device)
                else:
                    qr, inorm = scan_ops.cast_rows_bf16_host(piece)
                    qr = scan_ops._tensor_to_device(qr, self.device)
                buf, inv = scan_ops.write_rows_pre(
                    buf, inv, qr, scan_ops.to_device(inorm, self.device), w,
                    in_place,
                )
            else:
                rows = scan_ops.to_device(piece, self.device)
                buf, inv = scan_ops.update_rows(buf, inv, rows, w, in_place)
                if scan_buf is not None:
                    scan_buf = scan_ops.update_rows_cast(
                        scan_buf, rows, w, in_place
                    )
            in_place = True
            start = w + p
        return buf, inv, scan_buf

    def _may_donate(self) -> bool:
        """True when no live snapshot references the current device buffer
        (only then may an update write it in place)."""
        self._snap_refs = [r for r in self._snap_refs if r() is not None]
        return not self._snap_refs

    def sync(self) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Bring the device cache up to date; returns (buf, inv_norms, count)."""
        dev_cap = scan_ops.capacity_bucket(max(self.count, 1), _MIN_CAPACITY)
        if self._buf is None or dev_cap != self._dev_capacity:
            self._full_upload(dev_cap)
        elif self._dirty_from < self.count:
            start = self._dirty_from
            n = self.count - start
            if n > _FULL_SYNC_FRACTION * dev_cap:
                self._full_upload(dev_cap)
            else:
                # Stream the dirty range up in padded power-of-two slabs;
                # padding rows land in the dead zone beyond `count` (masked
                # at search time) unless they would run off the buffer, in
                # which case the window shifts left (re-writing clean rows
                # is harmless).
                buf, inv, scan_buf = self._stream_rows(
                    self._buf,
                    self._inv_norms,
                    self._scan_buf if self.device_dtype == "mixed" else None,
                    start,
                    self.count,
                    dev_cap,
                    in_place=self._may_donate(),
                )
                self._buf, self._inv_norms = buf, inv
                if self.device_dtype == "mixed":
                    self._scan_buf = scan_buf
                # after a copying update previously-registered snapshots no
                # longer reference the current buffer; after an in-place one
                # there were none
                self._snap_refs = []
                self._dirty_from = self.count
        if self.dead_count:
            if (
                self._alive_dev is None
                or self._alive_dev.shape[0] != self._dev_capacity
            ):
                padded = np.ones(self._dev_capacity, dtype=bool)
                padded[: self.count] = ~self._dead_host[: self.count]
                self._alive_dev = scan_ops.to_device(padded, self.device)
        else:
            self._alive_dev = None
        return self._buf, self._inv_norms, self.count

    def pending_upload_rows(self) -> int:
        """Rows the next sync() would transfer host->device (0 = the device
        cache is already current)."""
        dev_cap = scan_ops.capacity_bucket(max(self.count, 1), _MIN_CAPACITY)
        if self._buf is None or dev_cap != self._dev_capacity:
            return self.count
        return max(0, self.count - self._dirty_from)

    def next_device_capacity(self) -> int:
        """Device-buffer row capacity the next sync() will use."""
        return scan_ops.capacity_bucket(max(self.count, 1), _MIN_CAPACITY)

    def release_device(self) -> None:
        """Drop the device cache (host mirror stays canonical). The next
        sync() re-uploads from the host mirror. Outstanding snapshots/pins
        keep their tensors alive independently; only the store's own
        references drop."""
        self._buf = None
        self._scan_buf = None
        self._inv_norms = None
        self._dev_capacity = 0
        self._alive_dev = None
        self._snap_refs = []

    def pin(self, holder) -> None:
        """Suppress in-place writes to the CURRENT device buffer while
        ``holder`` is alive (weakref-tracked, like snapshots), for an owner
        that retains the buffer itself. The pin expires naturally the first
        time sync() replaces the buffer."""
        self._snap_refs.append(weakref.ref(holder))

    def snapshot(self) -> "StoreSnapshot":
        """Frozen search snapshot (caller holds the database lock).

        Syncs the device cache, then captures the tensor references plus the
        live count. While the snapshot is alive ``sync`` only ever
        *replaces* those tensors (see the module docstring), so a search
        over the snapshot is race-free even while other threads mutate the
        store — the key to running the device scan outside the lock (the
        reference likewise searches outside its lock,
        vector_database.py:495-523)."""
        buf, inv_norms, count = self.sync()
        snap = StoreSnapshot(
            buf=buf,
            inv_norms=inv_norms,
            scan_buf=self._scan_buf if self.device_dtype == "mixed" else None,
            count=count,
            dev_capacity=self._dev_capacity,
            device_dtype=self.device_dtype,
            host_data=self._data,
            host_norms=self._norms_host,
            router=self.router,
            host_alive=self.alive_host,
            alive_dev=self._alive_dev,
        )
        # Track liveness so sync() won't write the buffer under a scan
        # running outside the lock (plain weakref: GC just nulls it, no
        # cross-thread container mutation). The host-side twin forces
        # copy-on-write on in-place host mutations for the same reason.
        # Prune dead refs here too: mutation-free read-heavy workloads never
        # reach the prunes in _may_donate/_host_cow, and one dead weakref per
        # search would otherwise accumulate without bound.
        self._snap_refs = [r for r in self._snap_refs if r() is not None]
        self._host_snap_refs = [
            r for r in self._host_snap_refs if r() is not None
        ]
        self._snap_refs.append(weakref.ref(snap))
        self._host_snap_refs.append(weakref.ref(snap))
        return snap

    def search(
        self,
        queries,
        k: int,
        mask: np.ndarray | None = None,
        mode: str = "exact",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k cosine search (snapshot + scan in one call; hot paths should
        snapshot under the lock and search outside it)."""
        return self.snapshot().search(queries, k, mask, mode)


class StoreSnapshot:
    """Frozen device-side view of a VectorStore at one version.

    queries: (B, d); returns (scores, indices) (B, k). ``mask`` restricts
    candidates (True = eligible); invalid/padded positions carry scores below
    -1e38 and index arbitrary rows; callers drop them via the score check.
    """

    __slots__ = ("buf", "inv_norms", "scan_buf", "count", "dev_capacity",
                 "device_dtype", "host_data", "host_norms", "router",
                 "host_alive", "alive_dev", "__weakref__")

    def __init__(self, buf, inv_norms, scan_buf, count, dev_capacity,
                 device_dtype, host_data=None, host_norms=None, router=None,
                 host_alive=None, alive_dev=None):
        self.buf = buf
        self.inv_norms = inv_norms
        self.scan_buf = scan_buf
        self.count = count
        self.dev_capacity = dev_capacity
        self.device_dtype = device_dtype
        self.host_data = host_data
        self.host_norms = host_norms
        self.router = router
        # tombstoned rows (None when the store had none at snapshot time):
        # injected as the candidate mask on unfiltered searches; filtered
        # masks already exclude dead rows (the engine builds them from
        # structures that drop deleted uids immediately)
        self.host_alive = host_alive
        self.alive_dev = alive_dev

    @property
    def device(self) -> torch.device:
        return self.buf.device

    def _host_eligible(self, mode: str, batch: int) -> bool:
        """Small-batch scans over corpora under the byte bound may run on the
        host (exact f32 only — 'mixed' rescoring is f32-authoritative too, so
        the host answer is identical-or-better there)."""
        return (
            _HOST_SCAN_MAX_BYTES > 0
            and self.host_data is not None
            and self.router is not None
            and mode == "exact"
            and self.device_dtype in ("float32", "mixed")
            and batch <= _HOST_SCAN_MAX_BATCH
            and self.count * self.dim_bytes <= _HOST_SCAN_MAX_BYTES
        )

    @property
    def dim_bytes(self) -> int:
        return int(self.host_data.shape[1]) * 4 if self.host_data is not None else 0

    def _host_search(self, queries: np.ndarray, k: int,
                     mask: np.ndarray | None,
                     host_sub=None) -> tuple[np.ndarray, np.ndarray]:
        """numpy/BLAS mirror of the exact device scan (same normalization,
        same masked-score sentinel the callers filter on).

        host_sub: optional callable(host_data, host_norms) -> (rows, sub,
        subn) | None — a gathered submatrix of the filter's passing rows
        (engine-cached per filter key). Scanning only the passing rows costs
        selectivity x the full-corpus scan, which is the host analog of the
        reference's candidate-subset FAISS path (vector_database.py:508-514)
        without the throwaway index build."""
        n = self.count
        data = self.host_data[:n]
        row_map = None
        if mask is not None and host_sub is not None:
            gathered = host_sub(self.host_data, self.host_norms)
            if gathered is not None:
                row_map, data, norms = gathered
                n = data.shape[0]
                mask = None  # the gather already applied it
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        qn = np.linalg.norm(q, axis=-1, keepdims=True)
        qn = q / np.maximum(qn, 1e-30)
        # (data @ qn.T).T, norms folded in pre-transpose: the row-major
        # orientation streams the corpus contiguously
        if row_map is None:
            norms = self.host_norms[:n]
        scores = (data @ qn.T * norms[:, None]).T
        if mask is not None:
            scores[:, ~mask[:n]] = scan_ops._MASKED_SCORE
        kk = min(k, n)
        if kk < n:
            part = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
            pvals = np.take_along_axis(scores, part, axis=1)
            order = np.argsort(-pvals, axis=1)
            idx = np.take_along_axis(part, order, axis=1)
        else:
            idx = np.argsort(-scores, axis=1)
        vals = np.take_along_axis(scores, idx, axis=1).astype(np.float32)
        if row_map is not None:
            idx = row_map[idx]  # submatrix positions -> corpus row ids
        if kk < k:  # parity with the device path's padded invalid slots
            pad_v = np.full((q.shape[0], k - kk), scan_ops._MASKED_SCORE, np.float32)
            pad_i = np.zeros((q.shape[0], k - kk), np.int32)
            vals = np.concatenate([vals, pad_v], axis=1)
            idx = np.concatenate([idx, pad_i], axis=1)
        return vals[:, :k], idx[:, :k].astype(np.int32)

    def _timed_device_search(self, queries, k, mask, mode, mask_dev):
        """Device search on the caller's thread, timed for the router. The
        very first one runs twice (the first pays one-time library set-up
        that would poison the EMA). Errors reach the caller."""
        if self.router.dev_ema is None:
            self._device_search(queries, k, mask, mode, mask_dev=mask_dev)
        t0 = time.perf_counter()
        out = self._device_search(queries, k, mask, mode, mask_dev=mask_dev)
        self.router.record("device", time.perf_counter() - t0)
        return out

    def search(
        self,
        queries,
        k: int,
        mask: np.ndarray | None = None,
        mode: str = "exact",
        fetch: bool = True,
        mask_dev=None,
        host_sub=None,
    ):
        """fetch=False defers the device->host result transfer: returns
        device tensors the caller materializes later
        (ops/scan.py:fetch_results), so many launches can queue on the
        device before one drain. Host paths return numpy either way (already
        materialized). A fetching device search drains as the span
        ``search.fetch`` (utils/telemetry.py).

        mask_dev: optional device-resident padded copy of ``mask`` (or a
        callable taking the snapshot's dev_capacity and producing one — kept
        lazy so host-routed calls never upload it). The engine caches these
        per filter key so repeated filtered searches don't re-upload a
        dev_capacity-wide bool mask per call.

        Tensor queries (a ``torch.Tensor``, e.g. a serving batch uploaded
        once) skip the host round-trip entirely: no numpy conversion, no
        re-upload, no host-BLAS routing — the scan runs on the store's
        device."""
        if self.host_alive is not None and mask is None:
            # unfiltered search over a tombstoned corpus: the alive mask IS
            # the candidate mask (filtered masks already exclude dead rows)
            mask = self.host_alive
            mask_dev = self.alive_dev
        if scan_ops.is_device_array(queries):
            return self._device_search(queries, k, mask, mode, fetch=fetch,
                                       mask_dev=mask_dev)
        batch = 1 if np.ndim(queries) == 1 else int(np.shape(queries)[0])
        if self._host_eligible(mode, batch):
            if self.count * self.dim_bytes <= _HOST_ALWAYS_BYTES:
                return self._host_search(queries, k, mask, host_sub)
            which = self.router.choose()
            if which == "host":
                t0 = time.perf_counter()
                out = self._host_search(queries, k, mask, host_sub)
                self.router.record("host", time.perf_counter() - t0)
                return out
            if fetch or self.router.dev_ema is None:
                # (a deferred call still takes the FIRST device timing in
                # full: numpy results pass through the deferred-drain
                # contract)
                return self._timed_device_search(
                    queries, k, mask, mode, mask_dev
                )
            # deferred dispatch on the device, UN-timed: it returns before
            # the work drains, so timing it would poison the device EMA
            # with launch-only latency
        return self._device_search(queries, k, mask, mode, fetch=fetch,
                                   mask_dev=mask_dev)

    def _device_search(
        self,
        queries,
        k: int,
        mask: np.ndarray | None = None,
        mode: str = "exact",
        fetch: bool = True,
        mask_dev=None,
    ):
        device = self.device
        if scan_ops.is_device_array(queries):
            # the batch is already a tensor (e.g. a serving batch uploaded
            # once) — pad it on its device for the fused route, never bounce
            # it through the host
            q = scan_ops.as_device_queries(queries, device)
            b = int(q.shape[0])
        else:
            q_np = np.ascontiguousarray(queries, dtype=np.float32)
            b = q_np.shape[0] if q_np.ndim == 2 else None
            q = None
        bp = 1
        if b is not None:
            # The route is chosen on the batch padded to a BOUNDED set of
            # shapes, the shapes the JAX package runs (it bounds its compile
            # cache this way): small batches round up to a power of two >= 8;
            # larger ones to the next multiple of 256. Only the fused route
            # takes the pad (zero vectors whose result slots are sliced off
            # below); the small route takes the real queries alone, since
            # pad rows would cost its kernel their selection and merge.
            # Host routes never come through here.
            if b <= _POW2_PAD_MAX_BATCH:
                bp = max(8, 1 << (b - 1).bit_length())
            else:
                bp = -(-b // _POW2_PAD_MAX_BATCH) * _POW2_PAD_MAX_BATCH
        fused = self._use_fused(mode, bp)
        if fused and bp != b:
            if q is not None:
                q = torch.cat([q, q.new_zeros((bp - b, q.shape[1]))])
            else:
                q_np = np.concatenate(
                    [q_np, np.zeros((bp - b, q_np.shape[1]), np.float32)]
                )
        if q is None:
            q = scan_ops.to_device(q_np, device)
            if q.ndim == 1:
                q = q[None, :]
        kb = scan_ops.k_bucket(k, self.dev_capacity)
        if mask is None:
            mask_dev = None
        else:
            if callable(mask_dev):
                mask_dev = mask_dev(self.dev_capacity)
            if (
                mask_dev is None
                or mask_dev.shape[0] != self.dev_capacity  # capacity moved
            ):
                padded = np.zeros(self.dev_capacity, dtype=bool)
                padded[: mask.shape[0]] = mask
                mask_dev = scan_ops.to_device(padded, device)
        if fused:
            if self.device_dtype == "int8":
                vals, idx = fused_scan.fused_scan_topk_int8(
                    self.buf, self.inv_norms, q, self.count, kb, mask_dev
                )
            else:
                # 'approx' rides the same two-phase route with a zero
                # phase-2 margin: phase 3 gathers/rescores only k subtiles,
                # so it is strictly cheaper than 'exact' (which carries the
                # rounding margin)
                vals, idx = fused_scan.fused_scan_topk(
                    self.buf, self.inv_norms, q, self.count, kb, mask_dev,
                    margin=0 if mode == "approx" else None,
                    scan_buf=self.scan_buf,
                )
        elif self.device_dtype == "int8":
            vals, idx = scan_ops.scan_topk_int8(
                self.buf, self.inv_norms, q, self.count, kb, mask_dev, mode
            )
        else:
            vals, idx = scan_ops.scan_topk(
                self.buf, self.inv_norms, q, self.count, kb, mask_dev, mode
            )
        if b is not None:
            vals, idx = vals[:b], idx[:b]
        if not fetch:
            # device-resident slices; the caller drains with fetch_results
            return vals[:, :k], idx[:, :k]
        with span("search.fetch"):
            return scan_ops.fetch_results(vals[:, :k], idx[:, :k])

    def _use_fused(self, mode: str, batch: int) -> bool:
        """Batches of 16 and more over buffers of 4096 rows and more take the
        fused two-phase route, which never materializes the (B, C) score
        matrix; smaller ones the plain scan. The same rule holds on either
        device: the phase-1 wrapper picks the kernel for CUDA tensors and
        its plain version for CPU tensors."""
        return (
            mode in ("exact", "approx")
            and batch >= _FUSED_MIN_BATCH
            and self.dev_capacity >= _FUSED_MIN_CAPACITY
        )
