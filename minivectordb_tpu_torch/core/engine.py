"""Shared in-memory search engine: CRUD + filtered top-k search.

Counterpart of ``minivectordb_tpu/core/engine.py``: the single implementation
behind VectorDatabase (the reference duplicates ~390 lines of this logic into
each of its classes; SURVEY.md §2 notes the build should implement it once).

Search maps the reference's two code paths (prebuilt FAISS index for
unfiltered queries, throwaway per-query index for filtered ones,
vector_database.py:495-523) onto ONE device function: a masked cosine scan +
top-k (ops/scan.py, ops/fused_scan.py). Filters compile to a boolean row
mask; masked rows can never enter the top-k, which preserves the reference's
exact-count semantics (min(k, |candidates|) results, vector_database.py:489).

``index="ivf"`` adds the coarse-quantized index of ops/ivf.py behind the same
entry points: built lazily at ``build_threshold`` rows, rows added afterwards
overflow to a small exact side store, deletes tombstone slots in place, and
broad filters ride the probe with a device mask and an exact-scan fallback
that keeps the reference's exact-count contract.

``mesh=...`` (a parallel/mesh.py Mesh) shards the search: the exact scan
runs row-partitioned over the mesh (parallel/dist_scan.py, synced from the
host mirror incrementally), the IVF index list-partitioned
(parallel/dist_ivf.py), and deletes compact eagerly (the row-sharded buffers
re-sync from the compacted host mirror). The JAX engine's
``precompile_async`` hook (XLA programs compiled under a pending upload) has
no counterpart: PyTorch compiles nothing.
"""

from __future__ import annotations

import contextlib
import hashlib
import operator as _operator
import os
import pickle
import threading
import time

import numpy as np
import torch

from minivectordb_tpu_torch.core.store import VectorStore
from minivectordb_tpu_torch.filters.engine import (
    ColumnStore,
    FilterContext,
    MetadataIndex,
    filters_cache_key,
    select_rows,
)
from minivectordb_tpu_torch.ops import scan as scan_ops
from minivectordb_tpu_torch.ops.ivf import IVFIndex
from minivectordb_tpu_torch.ops.scan import fetch_results as _fetch_results
from minivectordb_tpu_torch.parallel.mesh import Mesh
from minivectordb_tpu_torch.utils.telemetry import (
    Telemetry,
    current_request,
    span,
    spanned,
)

_MASK_CACHE_MAX = 64
# Gathered host submatrices are bigger than masks: bound each copy and keep
# only a handful of filter keys hot.
_HOST_SUB_MAX_BYTES = int(
    os.environ.get("MINIVECTORDB_TORCH_HOST_SUB_BYTES", 64 << 20)
)
_HOST_SUB_CACHE_MAX = 8
# Aggregate bound across entries: the per-entry cap alone would let 8 keys
# (plus stale same-version inserts racing a clear) pin ~0.5 GB of gathered
# corpus copies.
_HOST_SUB_TOTAL_BYTES = int(
    os.environ.get(
        "MINIVECTORDB_TORCH_HOST_SUB_TOTAL_BYTES", 4 * _HOST_SUB_MAX_BYTES
    )
)
# Tombstoned-delete compaction policy: physical compaction (tail memmove +
# device gather) runs once dead rows pass this fraction of the corpus (or
# the floor, for small corpora), amortizing its O(N) cost over many O(1)
# deletes. Env-tunable for delete-heavy workloads.
_COMPACT_FRAC = float(os.environ.get("MINIVECTORDB_TORCH_COMPACT_FRAC", 0.25))
_COMPACT_FLOOR = int(os.environ.get("MINIVECTORDB_TORCH_COMPACT_FLOOR", 4096))


class _Deferred:
    """A deferred scan's result pair on its way to the host. The device->host
    copy starts NOW (it queues behind the producing work on the stream): one
    non-blocking transfer of the packed pair into pinned host memory plus a
    CUDA event (``scan_ops.ResultFetch``). Without this, each deferred
    handle's drain would serialize a synchronous copy; with the copies in
    flight, drains overlap across handles. numpy results (host route) pass
    through.

    ``get()`` is the span ``search.fetch``: it waits on the event before the
    pinned bytes are read, then calls ``drained`` (the scan's op, counted at
    dispatch and timed to this drain: ``Telemetry.begin``)."""

    __slots__ = ("_fetch", "_drained")

    def __init__(self, vals, idx, drained):
        self._fetch = scan_ops.ResultFetch(vals, idx)
        self._drained = drained

    def get(self) -> tuple[np.ndarray, np.ndarray]:
        with span("search.fetch"):
            pair = self._fetch.get()
        self._drained()
        return pair


def _merge_topk_device(va, ia, vb, ib, off, k):
    """Device-side merge of two descending top-k lists (for async callers
    that must not drain at dispatch time: the IVF + overflow path)."""
    v = torch.cat([va, vb], dim=1)
    i = torch.cat([ia.to(torch.int32), ib.to(torch.int32) + off], dim=1)
    tv, ti = scan_ops.topk_last_axis(v, k)
    return tv, torch.gather(i, 1, ti)


class _Coalescer:
    """Dynamic batching of concurrent single-query searches.

    A per-dispatch cost (launches + result transfer) dominates single-query
    searches, and N threads each paying it serialize into N dispatches. With
    coalescing, the FIRST arrival becomes the leader: it waits ``window_s``
    for followers, groups everything that arrived by (filter key, k, nprobe,
    return_distances), and executes one batched search per group; followers
    block on an event and read their slot. Opt-in (adds up to window_s of
    latency to uncontended calls) via the databases'
    ``coalesce_window_ms`` constructor kwarg — the classic serving-side
    dynamic batcher (no reference equivalent; the reference is strictly
    one query per call).

    Window sizing: ~10-25% of the per-dispatch cost. Note time.sleep's
    precision floor (~0.1-1 ms on Linux) makes windows under ~0.2 ms behave
    like 0."""

    __slots__ = (
        "engine", "window_s", "max_batch", "lock", "pending", "dispatch_lock",
        "auto", "group_ema", "dispatch_ema", "calls", "dispatches",
    )

    # auto-mode window bounds and policy (see __init__ docstring)
    _AUTO_WINDOW_FRAC = 0.15
    _AUTO_WINDOW_MIN_S = 2e-4
    _AUTO_WINDOW_MAX_S = 2e-3
    _AUTO_GROUP_ON = 1.3  # group-size EMA above this enables the window

    def __init__(self, engine, window_s: float, max_batch: int = 256,
                 auto: bool = False):
        self.engine = engine
        self.window_s = window_s
        self.max_batch = max_batch
        # auto mode (coalesce_window_ms="auto"): start with a ZERO window —
        # group formation comes from sweeping arrivals queued during the
        # previous dispatch (the dominant mechanism whenever per-op cost >>
        # any sane window). Once the observed group size shows real
        # concurrency, the window opens to ~15% of the measured per-dispatch
        # cost (bounded) to catch near-simultaneous arrivals; when groups
        # collapse back to size 1 (no concurrency — the mode where a fixed
        # window only adds latency) it closes again.
        self.auto = auto
        self.group_ema = 1.0
        self.dispatch_ema: float | None = None
        self.calls = 0
        self.dispatches = 0
        self.lock = threading.Lock()
        # Serializes LEADERS (group formation auto-extends over the previous
        # batch's in-flight dispatch) without contending with writers: the
        # engine lock is only taken inside _scan for filter+snapshot, same
        # as uncoalesced searches. Holding the ENGINE lock here instead
        # would make every store wait out a leader's full dispatch.
        self.dispatch_lock = threading.Lock()
        self.pending: list = []

    def _note_dispatch(self, group_size: int, dt: float) -> None:
        """Auto-mode controller (leader-called; float writes are atomic
        enough — the EMAs only steer the window)."""
        self.dispatches += 1
        self.calls += group_size
        if not self.auto:
            return
        self.group_ema = 0.8 * self.group_ema + 0.2 * group_size
        self.dispatch_ema = (
            dt if self.dispatch_ema is None
            else 0.7 * self.dispatch_ema + 0.3 * dt
        )
        if self.group_ema >= self._AUTO_GROUP_ON:
            self.window_s = min(
                self._AUTO_WINDOW_MAX_S,
                max(self._AUTO_WINDOW_MIN_S,
                    self._AUTO_WINDOW_FRAC * self.dispatch_ema),
            )
        else:
            self.window_s = 0.0  # self-disable: no concurrency observed

    def submit(self, q, metadata_filter, exclude_filter, or_filters, k,
               return_distances, nprobe):
        """One query in, one (ids, scores, metadatas) triple out."""
        try:
            gkey = (
                filters_cache_key(metadata_filter, exclude_filter, or_filters),
                k, nprobe, return_distances,
            )
            uncacheable = gkey[0] is None and (
                metadata_filter or exclude_filter or or_filters
            )
        except Exception:
            uncacheable = True
        # Malformed queries must fail their OWN caller, not poison the whole
        # group at np.stack time — validate shape before joining a batch.
        qv = np.asarray(q, dtype=np.float32).reshape(-1)
        if uncacheable or qv.shape[0] != self.engine.embedding_size:
            return self.engine._search_direct(
                q, metadata_filter, exclude_filter, or_filters, k,
                return_distances, nprobe,
            )
        ev = threading.Event()
        entry = [ev, qv, metadata_filter, exclude_filter, or_filters, gkey,
                 None, None]  # [..., result, exception]
        with self.lock:
            self.pending.append(entry)
            leader = len(self.pending) == 1
        if not leader:
            ev.wait()
            if entry[7] is not None:
                raise entry[7]
            return entry[6]
        batch = None
        try:
            if self.window_s > 0:
                time.sleep(self.window_s)
            t_disp = time.perf_counter()
            # Take the DISPATCH lock before swapping pending: while a
            # previous batch's dispatch still holds it, this leader blocks —
            # and every arrival during that dispatch lands in pending and is
            # swept into THIS batch. The window therefore auto-extends to
            # cover the in-flight dispatch time, which is where group
            # formation actually comes from when per-op cost >> window_s.
            with self.dispatch_lock:
                with self.lock:
                    batch = self.pending
                    self.pending = []
                dispatched = self._dispatch_groups(batch)
            self._drain_groups(dispatched)
            self._note_dispatch(len(batch), time.perf_counter() - t_disp)
        except BaseException:
            # the leader was interrupted (KeyboardInterrupt/SystemExit, or a
            # bug in the drain) — NEVER strand followers on ev.wait()
            if batch is None:
                with self.lock:
                    batch = self.pending
                    self.pending = []
            for e in batch:
                if e[6] is None and e[7] is None:
                    e[7] = RuntimeError(
                        "coalesced search aborted: the leader call was "
                        "interrupted; retry"
                    )
                e[0].set()
            raise
        if entry[7] is not None:
            raise entry[7]
        return entry[6]

    def _dispatch_groups(self, batch: list) -> list:
        """Dispatch every filter group fetch-deferred. The caller enters
        with the coalescer's dispatch lock held (leader serialization only
        — writers and uncoalesced searches never wait on it). Each chunk is
        internally snapshot-consistent because it is one _scan call (one
        filter+snapshot acquisition of the engine lock); different chunks
        are different callers' groups and carry no cross-group consistency
        contract."""
        groups: dict = {}
        for e in batch:
            groups.setdefault(e[5], []).append(e)
        dispatched = []  # (chunk, res-or-None, exception-or-None, kk, rd)
        for gk, entries in groups.items():
            _, kk, nprobe_g, rd = gk
            for lo in range(0, len(entries), self.max_batch):
                chunk = entries[lo: lo + self.max_batch]
                qs = np.stack([e[1] for e in chunk])
                # Group sizes vary with arrival timing; the DEVICE
                # boundary (StoreSnapshot._device_search) pads batches
                # to one pow2 shape. Padding here instead would also
                # inflate HOST-routed groups to 8 rows of BLAS work
                # for 1-4 real queries.
                try:
                    res = self.engine._scan(
                        qs, chunk[0][2], chunk[0][3], chunk[0][4], kk,
                        fetch=False, nprobe=nprobe_g,
                    )
                    dispatched.append((chunk, res, None, kk, rd))
                except Exception as exc:  # noqa: BLE001
                    dispatched.append((chunk, None, exc, kk, rd))
        return dispatched

    def _drain_groups(self, dispatched: list) -> None:
        """Drain + format outside the engine lock; every entry's event is
        set exactly once."""
        for chunk, res, exc, kk, rd in dispatched:
            try:
                if exc is not None:
                    for e in chunk:
                        e[7] = exc
                elif res is None:  # empty candidate set for this filter
                    for e in chunk:
                        e[6] = ([], [], [])
                else:
                    fetch, uids, metadata = res
                    v, ix = fetch.get()  # drain
                    with span("search.format"):
                        for j, e in enumerate(chunk):
                            e[6] = self.engine._format_hits(
                                v[j], ix[j], uids, metadata, rd
                            )
            except Exception as drain_exc:  # noqa: BLE001
                for e in chunk:
                    if e[6] is None and e[7] is None:
                        e[7] = drain_exc
            finally:
                for e in chunk:
                    e[0].set()



class SearchEngine:
    """Row-packed corpus + id maps + metadata index + masked device search."""

    def __init__(
        self,
        device_dtype: str = "float32",
        search_mode: str = "exact",
        mesh=None,
        index: str = "flat",
        ivf_opts: dict | None = None,
        coalesce_window_ms: float = 0.0,
        ivf_sidecar: str | None = None,
        device=None,
    ):
        if index not in ("flat", "ivf"):
            raise ValueError(f"Unknown index kind: {index}")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(
                    "mesh must be a minivectordb_tpu_torch.parallel.mesh.Mesh "
                    f"(search_mesh / pod_mesh), not {type(mesh).__name__}"
                )
            if mesh.distributed:
                raise ValueError(
                    "a database's mesh is one process's (search_mesh); a pod "
                    "across processes serves through parallel/multihost.py"
                )
            # the engine's device (store, masks, results) is the mesh's
            # first; a device that names another one is a contradiction
            first = mesh.local_shards()[0][1]
            if device is not None and scan_ops.resolve_device(device) != first:
                raise ValueError(
                    f"device={device!r} disagrees with the mesh, whose first "
                    f"device is {first}"
                )
            device = first
        # device=None means the CUDA card and raises when there is none;
        # the engine never carries on on the CPU unless asked to
        self.device = scan_ops.resolve_device(device)
        # Optional Mesh: searches run row-partitioned across it (shard-local
        # top-k + merge, parallel/dist_scan.py)
        self.mesh = mesh
        self._dist = None
        self._dist_version = -1
        self._dist_dirty_from = 0  # lowest row not yet synced to the mesh
        # Optional path for persisting the trained IVF layout OUTSIDE the
        # corpus pickle (sharded databases: write-through shards have no
        # single pickle to carry it). Written on build/attach/calibrate,
        # dropped on delete (see _persist_ivf_sidecar).
        self.ivf_sidecar = ivf_sidecar
        self.device_dtype = device_dtype
        self.search_mode = search_mode  # 'exact' | 'approx'
        self._version = 0  # bumped on every mutation
        # IVF index lifecycle (index='ivf'): lazily built at build_threshold
        # rows, incremental inserts overflow to a small exact side-buffer,
        # rebuilt when the overflow OR the deletes' dead slots pass
        # rebuild_frac of the indexed rows; deletes tombstone + remap the id
        # table (ops/ivf.py:delete_rows), keeping the trained k-means.
        # Mirrors the reference's index-as-DB-internal lifecycle (reference
        # vector_database.py:42-47, 477-479).
        self.index_kind = index
        self.ivf_opts = {
            "nlist": 1024,
            "nprobe": 32,
            "iters": 10,
            "build_threshold": 50_000,
            "rebuild_frac": 0.2,
            "rebuild_floor": 1024,  # min stale rows before a rebuild fires
            # bf16 lists + exact rescore against the corpus buffer: half the
            # list-tensor memory of float32 lists, and the two-stage search
            # makes the quantization observable only through speed ('int8'
            # quarters the list memory again)
            "lists_dtype": "bfloat16",
            # Broad filters ride the IVF probe too (overfetch + device mask
            # + exact-scan fallback when a row comes up short of k eligible
            # hits): a filter passing >= this fraction of the corpus leaves
            # the candidate set nearly as large as the corpus, where the ANN
            # index wins exactly as it does unfiltered. Selective filters
            # keep the exact masked scan (pruning there only costs recall).
            # Set > 1.0 to force every filtered query exact.
            "filtered_min_frac": 0.5,
            # Recall targeting: when set (e.g. 0.95), every fresh build
            # auto-calibrates nprobe to the smallest power of two whose
            # measured recall@10 vs this database's own exact scan meets the
            # target (see calibrate_nprobe) — recall stays pinned as the
            # corpus evolves through rebuilds instead of drifting under a
            # hand-tuned nprobe.
            "recall_target": None,
        }
        extra = ivf_opts or {}
        unknown = set(extra) - set(self.ivf_opts)
        if unknown:
            # a typo'd knob silently falling back to its default is the
            # worst failure mode for a recall/latency tunable
            raise ValueError(
                f"Unknown ivf_opts keys: {sorted(unknown)} "
                f"(valid: {sorted(self.ivf_opts)})"
            )
        self.ivf_opts.update(extra)
        self._ivf = None
        self._ivf_built_count = 0
        self._ivf_overflow = None  # VectorStore over rows added post-build
        self._ivf_pending_state = None  # persisted layout awaiting reattach
        self._ivf_dead_slots = 0  # tombstoned slots since the last build
        # True once a recall-target calibration chose ivf_opts['nprobe'];
        # survives rebuilds (the value lives in ivf_opts) and is stamped
        # onto every fresh index so persist/reload re-adopts it
        self._nprobe_calibrated = False
        self.embedding_size: int | None = None
        self.store: VectorStore | None = None
        self.uids: list = []  # row -> unique id
        self.inverse_id_map: dict = {}  # unique id -> row
        self.metadata: list = []  # row -> metadata dict
        self.meta_index = MetadataIndex()
        self.columns = ColumnStore()  # row-aligned vectorized filter columns
        self.lock = threading.RLock()
        self.telemetry = Telemetry()
        self._coalescer = self._make_coalescer(coalesce_window_ms)
        # (filter-triple key) -> (mask, n_candidates); flushed on mutation.
        self._mask_cache: dict = {}
        self._mask_cache_version = -1
        # device-resident padded filter masks, key -> (version, capacity,
        # bool tensor): repeated filtered searches otherwise re-upload a
        # dev_capacity-wide bool mask (1 MB at 1M rows) per call
        self._dev_mask_cache: dict = {}
        # host-route analog: key -> (version, rows, sub, subn) — a gathered
        # submatrix of a SELECTIVE filter's passing rows, so the host BLAS
        # scan costs selectivity x the full corpus instead of scanning
        # everything and masking (the reference's candidate-subset path,
        # vector_database.py:508-514, minus the throwaway index build)
        self._host_sub_cache: dict = {}

    # -- introspection -----------------------------------------------------

    @property
    def count(self) -> int:
        """PHYSICAL row count (includes tombstoned rows awaiting
        compaction); internal row-aligned structures index this space."""
        return 0 if self.store is None else self.store.count

    @property
    def live_count(self) -> int:
        """Observable corpus size (excludes tombstoned deletes) — what the
        reference's len(embeddings) would report."""
        if self.store is None:
            return 0
        return self.store.live_count

    @property
    def embeddings_view(self) -> np.ndarray | None:
        """Live-rows matrix (the public ``db.embeddings``). A gathered copy
        while tombstoned deletes are pending; the zero-copy host view
        otherwise."""
        if self.store is None:
            return None
        alive = self.store.alive_host
        if alive is None:
            return self.store.view()
        return self.store.view()[alive]

    def observable_uids(self) -> list:
        """row -> uid over LIVE rows in physical order (the reference's
        id_map value order). Identity with the internal list when no
        tombstones are pending."""
        if self.store is None or not self.store.dead_count:
            return self.uids
        alive = self.store.alive_host
        return [u for u, a in zip(self.uids, alive) if a]

    def observable_metadata(self) -> list:
        if self.store is None or not self.store.dead_count:
            return self.metadata
        alive = self.store.alive_host
        return [m for m, a in zip(self.metadata, alive) if a]

    def observable_inverse_id_map(self) -> dict:
        """uid -> LOGICAL row (dense renumbering over live rows), matching
        the reference's post-np.delete compacted map. The internal
        ``inverse_id_map`` keeps physical rows."""
        if self.store is None or not self.store.dead_count:
            return self.inverse_id_map
        return {u: i for i, u in enumerate(self.observable_uids())}

    @property
    def inverted_index(self):
        return self.meta_index.inverted_index

    def _filter_context(self) -> FilterContext:
        return FilterContext(self.meta_index, self.inverse_id_map,
                             self.metadata, self.columns)

    # -- mutations (caller holds self.lock) --------------------------------

    def _ensure_store(self, dim: int) -> None:
        if self.embedding_size is None:
            self.embedding_size = int(dim)
        if self.store is None:
            self.store = VectorStore(
                self.embedding_size, self.device_dtype, device=self.device
            )

    def add_one(self, unique_id, embedding: np.ndarray, metadata_dict: dict) -> int:
        if unique_id in self.inverse_id_map:
            raise ValueError("Unique ID already exists.")
        embedding = np.asarray(embedding, dtype=np.float32)
        self._ensure_store(embedding.shape[0])
        if embedding.shape[-1] != self.embedding_size:
            raise ValueError(
                f"Embedding dimension mismatch: expected {self.embedding_size}, "
                f"got {embedding.shape[-1]}."
            )
        row = self.store.append(embedding).start
        if self._ivf_overflow is not None:
            self._ivf_overflow.append(embedding)
        self._dist_dirty_from = min(self._dist_dirty_from, row)
        self.uids.append(unique_id)
        self.inverse_id_map[unique_id] = row
        self.metadata.append(metadata_dict)
        self.meta_index.add(unique_id, metadata_dict)
        self.columns.append(metadata_dict)
        self._version += 1
        return row

    def add_batch(self, unique_ids: list, embeddings, metadata_dicts: list) -> range:
        for uid in unique_ids:
            if uid in self.inverse_id_map:
                raise ValueError(f"Unique ID {uid} already exists.")
        mat = np.asarray(
            [np.asarray(e, dtype=np.float32) for e in embeddings], dtype=np.float32
        )
        self._ensure_store(mat.shape[1])
        if mat.shape[1] != self.embedding_size:
            raise ValueError(
                f"Embedding dimension mismatch: expected {self.embedding_size}, "
                f"got {mat.shape[1]}."
            )
        rows = self.store.append(mat)
        if self._ivf_overflow is not None:
            self._ivf_overflow.append(mat)
        self._dist_dirty_from = min(self._dist_dirty_from, rows.start)
        start = rows.start
        self.uids.extend(unique_ids)
        self.inverse_id_map.update(
            {uid: start + i for i, uid in enumerate(unique_ids)}
        )
        self.metadata.extend(metadata_dicts)
        for uid, md in zip(unique_ids, metadata_dicts):
            self.meta_index.add(uid, md)
        self.columns.append_many(metadata_dicts)
        self._version += 1
        return rows

    def delete_many(self, unique_ids: list) -> None:
        """Remove uids. Observable semantics match the reference's eager
        np.delete compaction (vector_database.py:119-155): deleted uids
        vanish from every map and the public id_map/embeddings renumber
        densely. Physically single-device engines TOMBSTONE the rows —
        O(deleted) work per call instead of moving the O(N*d) tail and
        re-streaming it over the link — and compact lazily once dead rows
        pass _COMPACT_FRAC of the corpus (mesh engines keep eager
        compaction: their row-sharded buffers re-sync from the compacted
        host mirror)."""
        if not unique_ids:
            return
        with self.telemetry.timed("delete"):
            self._delete_many_tombstone(unique_ids)
            if self.mesh is not None:
                self._compact_tombstones()

    def _delete_many_tombstone(self, unique_ids: list) -> None:
        by_row = {}
        for uid in unique_ids:
            by_row[self.inverse_id_map[uid]] = uid
        rows = sorted(by_row)
        for row in rows:
            uid = by_row[row]
            self.meta_index.remove(uid, self.metadata[row])
            del self.inverse_id_map[uid]
        self.columns.clear_rows(rows)
        self.store.tombstone_rows(rows)
        if self._ivf is not None or self._ivf_pending_state is not None:
            # physical ids do NOT move, so the trained layout stays valid
            # in memory (slots just go invalid) — but a sidecar written
            # before this delete would reattach WITHOUT the tombstones
            # after a crash; drop it (the next build/calibrate rewrites it)
            self._drop_ivf_sidecar()
            # a layout awaiting reattach indexes its own count of rows (the
            # built count is set only when it attaches); the JAX engine reads
            # the built count here, 0 before the attach, so its deletes never
            # reach a pending layout and the attached index serves them
            built = (self._ivf_built_count if self._ivf is not None
                     else int(self._ivf_pending_state["count"]))
            below = [r for r in rows if r < built]
            if self._ivf is not None:
                self._ivf_dead_slots += self._ivf.tombstone_rows(below)
            elif below:
                self._ivf_dead_slots += IVFIndex.state_tombstone_rows(
                    self._ivf_pending_state, below
                )
            if self._ivf_overflow is not None:
                over = [r - built for r in rows if r >= built]
                if over:
                    self._ivf_overflow.tombstone_rows(over)
        self._version += 1
        if self.store.dead_count > max(
            _COMPACT_FLOOR, _COMPACT_FRAC * self.count
        ):
            self._compact_tombstones()

    def _compact_tombstones(self) -> None:
        """Fold tombstoned rows out of every row-aligned structure (caller
        holds the lock). Runs when the dead fraction passes the policy
        threshold, before an IVF (re)build, and on explicit persistence —
        never per delete."""
        if self.store is None or not self.store.dead_count:
            return
        with self.telemetry.timed("delete_compaction"):
            dead = self.store.compact_dead()
            # the mesh's row blocks re-sync from the first row that moved
            self._dist_dirty_from = min(self._dist_dirty_from, int(dead[0]))
            doomed = set(dead.tolist())
            new_uids, new_metadata = [], []
            for row, uid in enumerate(self.uids):
                if row not in doomed:
                    new_uids.append(uid)
                    new_metadata.append(self.metadata[row])
            self.uids = new_uids
            self.metadata = new_metadata
            self.inverse_id_map = {uid: i for i, uid in enumerate(new_uids)}
            self.columns.delete_rows(dead.tolist())
            if self._ivf is not None or self._ivf_pending_state is not None:
                self._drop_ivf_sidecar()
                if self._ivf is not None:
                    # slots were already invalidated at tombstone time;
                    # delete_rows now remaps the SURVIVING ids to their
                    # post-compaction positions and shrinks the physical
                    # indexed count (n_del counts rows, not live slots)
                    n_del = self._ivf.delete_rows(dead)
                    self._ivf_built_count -= n_del
                    if n_del and self._ivf._data is not None:
                        buf, inv, _ = self._synced_corpus()
                        self._ivf.refresh_corpus(buf, inv)
                        self.store.pin(self._ivf)
                    self._start_overflow(self._ivf_built_count)
                else:
                    IVFIndex.state_after_deletes(self._ivf_pending_state, dead)
                    if "uid_digest" in self._ivf_pending_state:
                        self._ivf_pending_state["uid_digest"] = (
                            self._uid_digest(
                                int(self._ivf_pending_state["count"])
                            )
                        )
            self._version += 1

    def compact_tombstones(self) -> None:
        """Public: force physical compaction of tombstoned deletes."""
        with self.lock:
            self._compact_tombstones()

    def get_row(self, unique_id) -> np.ndarray:
        if unique_id not in self.inverse_id_map:
            raise ValueError("Unique ID does not exist.")
        return self.store.row(self.inverse_id_map[unique_id])

    def reset(self) -> None:
        self.embedding_size = None
        self.store = None
        self.uids = []
        self.inverse_id_map = {}
        self.metadata = []
        self.meta_index = MetadataIndex()
        self.columns = ColumnStore()
        self._invalidate_ivf()
        # a later load() re-ships every row to the mesh
        self._dist = None
        self._dist_version = -1
        self._dist_dirty_from = 0

    # -- IVF lifecycle (index='ivf') ----------------------------------------

    def _invalidate_ivf(self) -> None:
        self._ivf = None
        self._ivf_built_count = 0
        self._ivf_overflow = None
        self._ivf_pending_state = None
        self._ivf_dead_slots = 0
        self._drop_ivf_sidecar()

    def _uid_digest(self, n: int) -> str:
        """Stable digest of the first n uids IN ROW ORDER. The sidecar
        carries this so a layout can never attach onto a differently-ordered
        row space: shard reload order can diverge from the RAM append order
        the layout was trained against (delete→add churn backfills shard
        holes, reordering rows on the next load while leaving the count
        identical). Caller holds the lock."""
        h = hashlib.blake2b(digest_size=16)
        for u in self.uids[:n]:
            h.update(repr(u).encode())
            h.update(b"\x00")
        return h.hexdigest()

    def _persist_ivf_sidecar(self) -> None:
        """Write the trained layout to ivf_sidecar (sharded databases set
        this path — the flat class persists the layout inside its pickle
        instead). Atomic write; append-only growth after the write is safe
        (rows 0..count are immutable under appends), and every delete DROPS
        the sidecar (row compaction remaps ids, so a stale layout could
        reattach onto the wrong rows once the count grows back). The stored
        uid digest guards the reorder case the drop can't see (churn that
        ends at the same count but a different reload order)."""
        if self.ivf_sidecar is None:
            return
        if self._ivf is not None:
            state = dict(self._ivf.state_dict())
            state["uid_digest"] = self._uid_digest(int(state["count"]))
        elif self._ivf_pending_state is not None:
            # re-persisting a not-yet-attached layout (e.g. right after the
            # loader read it): keep its ORIGINAL digest — current uids may
            # not be loaded yet (WAL-only corpora re-add rows at replay)
            state = self._ivf_pending_state
        else:
            return
        tmp = self.ivf_sidecar + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, self.ivf_sidecar)

    def _drop_ivf_sidecar(self) -> None:
        if self.ivf_sidecar is not None:
            try:
                os.unlink(self.ivf_sidecar)
            except FileNotFoundError:
                pass

    def ivf_active(self) -> bool:
        """True when queries on this index='ivf' engine would serve from
        the coarse probe (built, pending, or due to build). The single
        source of the eligibility gate."""
        return self.index_kind == "ivf" and (
            self.count >= self.ivf_opts["build_threshold"]
            or self._ivf is not None
            or self._ivf_pending_state is not None
        )

    # -- serving knobs and stats --------------------------------------------

    def _make_coalescer(self, ms):
        if isinstance(ms, str):
            if ms != "auto":
                raise ValueError(
                    f"coalesce_window_ms must be a number or 'auto', got {ms!r}"
                )
            return _Coalescer(self, 0.0, auto=True)
        if ms and ms > 0:
            return _Coalescer(self, ms / 1000.0)
        return None

    def set_coalesce_window(self, ms) -> None:
        """Enable/disable/resize serving-side dynamic batching at runtime
        (0 disables; "auto" self-tunes the window from the measured
        per-dispatch cost and observed concurrency, self-disabling when
        calls never overlap). In-flight coalesced calls finish under the old
        coalescer; new calls see the new setting."""
        self._coalescer = self._make_coalescer(ms)

    def coalesce_stats(self) -> dict | None:
        """Dynamic-batching controller state for stats() (None when off)."""
        coal = self._coalescer
        if coal is None:
            return None
        return {
            "auto": coal.auto,
            "window_ms": coal.window_s * 1000.0,
            "group_size_ema": coal.group_ema,
            "dispatch_ema_ms": (
                None if coal.dispatch_ema is None
                else coal.dispatch_ema * 1000.0
            ),
            "calls": coal.calls,
            "dispatches": coal.dispatches,
        }

    def warmup(self, k: int = 10, batch: int = 1) -> None:
        """Move the cold-start costs off the first user query: sync the
        device corpus cache (the big upload after bulk ingest), build the
        IVF index if configured and due, build the CUDA kernels this batch
        size's route needs, and run one search of the (batch, k) shape. Serving deployments call this
        after load and before taking traffic; it is never required for
        correctness."""
        if self.store is None or self.live_count == 0:
            return
        q = np.zeros((batch, self.embedding_size), dtype=np.float32)
        q[:, 0] = 1.0
        self.search_batch(q, k=min(k, self.live_count))

    def routing_stats(self) -> dict | None:
        """Adaptive host/device router state + device mask-cache occupancy,
        and the device the store's buffers live on."""
        if self.store is None:
            return None
        r = self.store.router
        return {
            "host_ema_s": r.host_ema,
            "device_ema_s": r.dev_ema,
            "decisions": r.n,
            "dev_mask_cache_entries": len(self._dev_mask_cache),
            "device": str(self.store.device),
        }

    def ivf_stats(self) -> dict | None:
        """Operator-facing IVF lifecycle state for stats() (None when the
        engine is not index='ivf'): probe width and whether it was
        calibrated, indexed vs overflow row split, tombstoned slots, and the
        effective list count (skew splitting can raise it past nlist)."""
        if self.index_kind != "ivf":
            return None
        with self.lock:
            ivf = self._ivf
            return {
                "built": ivf is not None,
                "pending_attach": self._ivf_pending_state is not None,
                "indexed_rows": self._ivf_built_count,
                "overflow_rows": max(0, self.count - self._ivf_built_count),
                "dead_slots": self._ivf_dead_slots,
                "nlist_effective": (
                    None if ivf is None else int(ivf.centroids.shape[0])
                ),
                "nprobe": self.ivf_opts["nprobe"],
                "nprobe_calibrated": self._nprobe_calibrated,
                # duplicate centroids from skew splitting: search scales the
                # probe slot count by nlist_effective/(nlist_effective -
                # split_duplicates), so operators can derive the real
                # per-query probe cost from the configured nprobe
                "split_duplicates": 0 if ivf is None else int(ivf.n_dup),
                "lists_dtype": self.ivf_opts["lists_dtype"],
            }

    def ivf_state(self) -> dict | None:
        """Persistable IVF layout (centroids + slot maps; the packed list
        tensor is rebuilt from the embeddings on load). None when unbuilt."""
        with self.lock:
            if self._ivf is not None:
                return self._ivf.state_dict()
            return self._ivf_pending_state

    def set_ivf_state(self, state: dict | None) -> None:
        """Adopt a persisted IVF layout; reattached lazily on first search."""
        with self.lock:
            self._ivf = None
            self._ivf_built_count = 0
            self._ivf_overflow = None
            self._ivf_pending_state = state
            self._ivf_dead_slots = 0
            # adopting a foreign layout: its own flag decides at attach time
            self._nprobe_calibrated = False

    def _start_overflow(self, built: int) -> None:
        self._ivf_overflow = VectorStore(
            self.embedding_size, "float32", device=self.device
        )
        if built < self.count:
            self._ivf_overflow.append(self.store.view()[built:])
            alive = self.store.alive_host
            if alive is not None:
                # suffix rows tombstoned before this rebuild stay dead in
                # the fresh overflow copy (row i here is global built+i)
                dead_suffix = np.flatnonzero(~alive[built:])
                if dead_suffix.size:
                    self._ivf_overflow.tombstone_rows(dead_suffix)

    def _ensure_ivf(self) -> None:
        """Build / reattach / rebuild the IVF index (caller holds the lock —
        the reference likewise rebuilds its index under the lock when dirty,
        reference vector_database.py:477-479)."""
        opts = self.ivf_opts
        if self._ivf is None and self._ivf_pending_state is not None:
            st = self._ivf_pending_state
            self._ivf_pending_state = None
            dg = st.get("uid_digest")
            row_space_ok = (
                dg is None  # flat-pickle states are snapshot-consistent
                or (
                    st["count"] <= self.count
                    and dg == self._uid_digest(int(st["count"]))
                )
            )
            if not row_space_ok:
                # the persisted layout was trained against a different row
                # order (shard-hole backfill after delete→add churn) —
                # attaching would map list slots onto the wrong rows.
                # Fall through: the rebuild policy retrains cleanly.
                st = None
            if st is not None and 0 < st["count"] <= self.count:
                buf, inv, _ = self._synced_corpus()
                with self.telemetry.timed("ivf_attach"):
                    self._ivf = self._wrap_ivf(
                        IVFIndex.from_state(
                            st, buf, count=st["count"], inv_norms=inv
                        )
                    )
                self._ivf_built_count = st["count"]
                if st.get("nprobe_calibrated"):
                    # a recall-target calibration travels with the layout:
                    # re-adopt it as the serving default (db.nprobe can
                    # still override after load)
                    self.ivf_opts["nprobe"] = int(st["nprobe"])
                    self._nprobe_calibrated = True
                self._pin_ivf_corpus()
                self._release_mesh_build_buffer()
                self._start_overflow(st["count"])
                # rewrite the sidecar: engine.load()'s reset dropped the
                # file the pending state was read from
                self._persist_ivf_sidecar()
        overflow_rows = self.count - self._ivf_built_count
        stale = overflow_rows + self._ivf_dead_slots
        if self._ivf is not None and stale <= max(
            opts["rebuild_floor"], opts["rebuild_frac"] * self._ivf_built_count
        ):
            return
        # (re)building: fold tombstoned deletes out first — the k-means and
        # list assignment run over the store's rows, and dead rows must
        # neither train centroids nor enter lists as live slots
        self._compact_tombstones()
        nlist = opts["nlist"]
        if nlist in ("auto", None):
            # classic IVF sizing: ~4*sqrt(n) lists, a power of two (the sizes
            # the JAX package builds), floor 32. Resolved at BUILD time, so
            # rebuilds rescale as the corpus grows.
            nlist = 1 << max(
                5, int(round(np.log2(4.0 * np.sqrt(max(self.count, 1)))))
            )
        ivf = IVFIndex(
            nlist=nlist,
            nprobe=opts["nprobe"],
            iters=opts["iters"],
            device_dtype=opts["lists_dtype"],
            device=self.device,
        )
        buf, inv, count = self._synced_corpus()
        with self.telemetry.timed("ivf_build"):
            ivf.build(buf, count=count, inv_norms=inv)
        # a manual calibration survives rebuilds: stamp the flag so
        # persist/reload keeps re-adopting the calibrated nprobe
        # (auto-recalibration below refreshes the value itself when
        # recall_target is configured)
        ivf.nprobe = int(self.ivf_opts["nprobe"])
        ivf.nprobe_calibrated = self._nprobe_calibrated
        self._ivf = self._wrap_ivf(ivf)
        self._ivf_built_count = count
        self._ivf_dead_slots = 0
        self._pin_ivf_corpus()
        self._release_mesh_build_buffer()
        self._start_overflow(count)
        if self.ivf_opts.get("recall_target"):
            with self.telemetry.timed("nprobe_calibration"):
                self._run_nprobe_calibration(
                    self.ivf_opts["recall_target"], None, 10, 64, 0
                )
        self._persist_ivf_sidecar()

    def calibrate_nprobe(self, recall_target: float = 0.95, queries=None,
                         k: int = 10, sample: int = 64,
                         seed: int = 0) -> dict:
        """FAISS-autotune-style recall targeting: measure recall@k of the
        IVF probe against THIS database's own exact scan and install the
        smallest power-of-two nprobe that meets ``recall_target`` as the
        default (``ivf_opts['nprobe']``). The reference has no ANN index and
        therefore no such knob; this keeps the beyond-reference index
        honest — 'give me at least X recall' instead of hand-tuning nprobe.

        queries: optional (B, d) workload sample — the most faithful
        calibration; defaults to ``sample`` stored rows (corpus rows are
        slightly easy as queries — prefer a real workload when available).
        Recall is scored over indexed rows only: the live search path merges
        post-build overflow rows exactly, so production recall is >= the
        calibrated figure. Returns {"nprobe", "recall", "evaluated"}.
        """
        if not (0.0 < recall_target <= 1.0):
            raise ValueError("recall_target must be in (0, 1]")
        with self.lock:
            if self.index_kind != "ivf":
                raise ValueError("calibrate_nprobe requires index='ivf'")
            if self.count == 0:
                raise ValueError("cannot calibrate an empty database")
            if (
                self._ivf is None
                and self._ivf_pending_state is None
                and self.count < self.ivf_opts["build_threshold"]
            ):
                # respect the lifecycle: _ensure_ivf would happily build a
                # tiny index here, but searches gate on build_threshold
                raise ValueError(
                    "no IVF index built yet (corpus below build_threshold;"
                    " add rows or lower ivf_opts['build_threshold'])"
                )
            self._ensure_ivf()
            if self._ivf is None:
                raise ValueError(
                    "no IVF index built yet (corpus below build_threshold;"
                    " add rows or lower ivf_opts['build_threshold'])"
                )
            return self._run_nprobe_calibration(
                recall_target, queries, k, sample, seed
            )

    def _run_nprobe_calibration(self, recall_target, queries, k, sample,
                                seed) -> dict:
        """Measurement core (caller holds the lock and guarantees a built
        index). Kept separate so _ensure_ivf's auto-calibration can't
        recurse back through calibrate_nprobe -> _ensure_ivf."""
        ivf = self._ivf.snapshot()
        snap = self._index_snapshot()
        if self.mesh is not None and ivf.quantized:
            ivf.attach_sharded_rescore(snap)
        built = self._ivf_built_count
        if queries is None:
            rng = np.random.default_rng(seed)
            m = min(int(sample), self.count)
            rows = np.sort(rng.choice(self.count, m, replace=False))
            queries = self.store.view()[rows].copy()
        if scan_ops.is_device_array(queries):
            queries = queries.detach().cpu().numpy()
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        kk = max(1, min(k, built))
        exact_idx = np.asarray(
            self._snapshot_search(snap, q, min(k, self.count), None)[1]
        )
        # truth restricted to indexed rows: overflow rows are served by an
        # exact side-scan at query time, never by the probe
        truth = [set(int(x) for x in row if x < built) for row in exact_idx]
        denom = sum(len(t) for t in truth)
        if denom == 0:
            # every exact neighbor of the calibration queries lives in the
            # post-build overflow, which the live path always scans exactly
            # — the probe has nothing it could miss; keep the configured
            # nprobe rather than installing a meaningless maximum
            return {
                "nprobe": int(self.ivf_opts["nprobe"]),
                "recall": 1.0,
                "evaluated": [],
            }
        nlist = int(ivf.centroids.shape[0])
        evaluated = []
        p, best, rec = 1, nlist, 1.0
        while True:
            vals, ids = ivf.search(q, kk, nprobe=p)
            # sentinel-padded slots carry arbitrary ids (often 0) — counting
            # them as hits would overstate recall and stop a doubling early
            hits = sum(
                len(
                    truth[b]
                    & {
                        int(i)
                        for i, v in zip(ids[b], vals[b])
                        if v > -1.0e38
                    }
                )
                for b in range(len(truth))
            )
            rec = hits / denom
            evaluated.append({"nprobe": p, "recall": round(rec, 4)})
            if rec >= recall_target or p >= nlist:
                best = p
                break
            p = min(p * 2, nlist)
        self.ivf_opts["nprobe"] = int(best)
        self._nprobe_calibrated = True
        # persist with the layout: state_dict carries the calibrated value +
        # flag, and the attach path re-adopts it as the serving default
        self._ivf.nprobe = int(best)
        self._ivf.nprobe_calibrated = True
        self._persist_ivf_sidecar()
        return {"nprobe": int(best), "recall": rec, "evaluated": evaluated}

    def _pin_ivf_corpus(self) -> None:
        """Quantized IVF lists retain the store's device buffer as the
        exact-rescore corpus; pin it so store.sync() never writes it in
        place under the retained reference."""
        if self._ivf._data is not None:
            self.store.pin(self._ivf)

    def _synced_corpus(self):
        """store.sync() + DRAIN the upload queue, under its own timer.

        sync() queues host->device slab copies without waiting; the next
        device work queues behind them, so without a drain the one-time
        corpus transfer gets billed to whatever runs next (the ivf_build
        timer). On a CPU store there is nothing to drain."""
        with self.telemetry.timed("corpus_sync"):
            buf, inv, count = self.store.sync()
            if count and buf.device.type == "cuda":
                torch.cuda.synchronize(buf.device)
        return buf, inv, count

    def _wrap_ivf(self, ivf):
        """On a mesh, reshard the trained index list-per-device
        (parallel/dist_ivf.py).

        When the engine's distributed exact-scan buffer is float32
        (device_dtype 'float32'/'mixed' — DistributedScanIndex coerces
        'mixed' to float32), the quantized-lists exact rescore runs
        ROW-SHARDED against that buffer (_scan attaches it per search), so
        the wrapper drops its single-device corpus reference and
        _release_mesh_build_buffer can free the store's build-time buffer."""
        if self.mesh is None:
            return ivf
        from minivectordb_tpu_torch.parallel.dist_ivf import DistributedIVFIndex

        return DistributedIVFIndex(
            self.mesh, ivf,
            keep_single_device_rescore=self.device_dtype
            not in ("float32", "mixed"),
        )

    def _release_mesh_build_buffer(self) -> None:
        """On mesh engines the store's single-device buffer only serves the
        k-means build (search runs on the sharded corpus; the quantized
        rescore is either sharded too or pinned via _pin_ivf_corpus): once
        the index is wrapped and holds no reference to it, free it.
        Single-device engines keep it — it IS the search buffer."""
        if (
            self.mesh is not None
            and self._ivf is not None
            and self._ivf._data is None
        ):
            self.store.release_device()

    def load(self, embeddings, uids, metadatas, inverted_index=None) -> None:
        self.reset()
        self.uids = list(uids)
        self.metadata = list(metadatas)
        self.inverse_id_map = {uid: i for i, uid in enumerate(self.uids)}
        if embeddings is not None and len(embeddings):
            emb = np.asarray(embeddings, dtype=np.float32)
            self._ensure_store(emb.shape[1])
            self.store.append(emb)
        if inverted_index is not None:
            self.meta_index.load_inverted_index(
                inverted_index, self.uids, self.metadata
            )
        else:
            self.meta_index.rebuild(self.uids, self.metadata)
        self.columns.rebuild(self.metadata)
        self._version += 1

    def _index_snapshot(self):
        """Frozen searchable view (caller holds self.lock): the mesh's
        distributed index (row-partitioned shard-local top-k + merge) when a
        mesh is configured, else the single-device store.

        Mesh sync is INCREMENTAL: only rows from the lowest dirty row are
        re-shipped (padded to a power-of-two slab, the window shifted left
        rather than run off the buffer); a full reload happens only when the
        capacity bucket changes or most of the corpus is dirty."""
        if self.mesh is None:
            return self.store.snapshot()
        if self._dist is None:
            from minivectordb_tpu_torch.parallel.dist_scan import (
                DistributedScanIndex,
            )

            self._dist = DistributedScanIndex(
                self.mesh, self.embedding_size, device_dtype=self.device_dtype
            )
        if self._dist_version != self._version:
            view = self.store.view()
            dist = self._dist
            start = self._dist_dirty_from
            n_dirty = max(0, self.count - start)
            if (
                dist._bufs is None
                or self.count > dist.capacity
                or n_dirty > 0.5 * dist.capacity
            ):
                dist.load(view)
            elif n_dirty == 0:
                dist.count = self.count  # pure tail shrink: count masks it
            else:
                # zero-fill past the live rows (the dead zone is masked at
                # search time)
                p = min(scan_ops.capacity_bucket(n_dirty, 8), dist.capacity)
                if start + p > dist.capacity:
                    start = dist.capacity - p
                slab = np.zeros((p, view.shape[1]), dtype=np.float32)
                live = min(start + p, self.count) - start
                slab[:live] = view[start : start + live]
                dist.update(slab, start, self.count)
            self._dist_version = self._version
            self._dist_dirty_from = self.count
        return self._dist.snapshot()

    def _snapshot_search(self, snap, q, search_k, mask, fetch=True,
                         mask_dev=None, host_sub=None):
        if self.mesh is not None:
            return snap.search(q, search_k, mask=mask, fetch=fetch)
        return snap.search(q, search_k, mask, mode=self.search_mode,
                           fetch=fetch, mask_dev=mask_dev, host_sub=host_sub)

    def _device_mask_thunk(self, metadata_filter, exclude_filter, or_filters,
                           mask):
        """A lazy, cached device copy of the padded filter mask.

        Called under the lock (captures the corpus version the mask belongs
        to); the returned zero-arg callable runs on the search path OUTSIDE
        the lock, and only when the store actually routes to the device —
        host-routed calls never pay the upload. Entries pair a mask with the
        version it was built at, so a racing writer can never associate a
        stale mask with a newer version."""
        key = filters_cache_key(metadata_filter, exclude_filter, or_filters)
        if key is None or mask is None:
            return None
        version = self._version
        cache = self._dev_mask_cache
        device = self.device

        def thunk(capacity):
            # capacity comes from the SEARCHING snapshot, so the array is
            # always padded for the buffer it will mask
            ent = cache.get(key)
            if (
                ent is not None
                and ent[0] == version
                and ent[1] == capacity
            ):
                return ent[2]
            padded = np.zeros(capacity, dtype=bool)
            padded[: mask.shape[0]] = mask
            arr = scan_ops.to_device(padded, device)
            # runs OUTSIDE the engine lock: two concurrent searches may race
            # to evict the same victim — tolerate losing that race
            if len(cache) >= _MASK_CACHE_MAX:
                try:
                    cache.pop(next(iter(cache)), None)
                except (StopIteration, RuntimeError):
                    pass  # another thread emptied/resized it mid-iteration
            cache[key] = (version, capacity, arr)
            return arr

        return thunk

    def _host_sub_thunk(self, metadata_filter, exclude_filter, or_filters,
                        mask, n_candidates):
        """A lazy, cached gathered submatrix of the filter's passing rows
        for the host scan route.

        Only built for SELECTIVE filters (under half the corpus and a
        bounded copy size): scanning the gathered rows costs selectivity x
        the full-corpus BLAS scan, and caching per (filter key, version)
        makes repeated filtered searches pay only the submatrix scan. Broad
        filters keep the masked full scan — the gather would copy most of
        the corpus for no arithmetic saving.

        Called under the lock; the thunk runs OUTSIDE it against the
        SEARCHING snapshot's host arrays (copy-on-write keeps those aligned
        with the mask's version even while writers proceed)."""
        key = filters_cache_key(metadata_filter, exclude_filter, or_filters)
        if key is None or mask is None or self.store is None:
            return None
        if n_candidates * 2 >= self.count:
            return None
        if n_candidates * self.store.dim * 4 > _HOST_SUB_MAX_BYTES:
            return None
        version = self._version
        cache = self._host_sub_cache

        def thunk(host_data, host_norms):
            ent = cache.get(key)
            if ent is not None and ent[0] == version:
                # LRU: refresh recency on hit (dict preserves insertion
                # order; without this the hottest first-inserted key is
                # evicted first under alternating filters)
                try:
                    if cache.pop(key, None) is not None:
                        cache[key] = ent
                except RuntimeError:
                    pass
                return ent[1]
            rows = np.flatnonzero(mask).astype(np.int32)
            sub = np.ascontiguousarray(host_data[rows])
            subn = np.ascontiguousarray(host_norms[rows])
            gathered = (rows, sub, subn)
            nbytes = rows.nbytes + sub.nbytes + subn.nbytes
            if nbytes > _HOST_SUB_TOTAL_BYTES:
                # an entry over the AGGREGATE bound by itself (the two
                # bounds are independently env-tunable) must not evict the
                # entire warm cache only to be inserted over-budget anyway
                return gathered
            # outside the lock: tolerate racing evictions (see
            # _device_mask_thunk). Bound BOTH entry count and aggregate
            # bytes; stale-version entries (left by inserts racing a
            # clear) are evicted before live ones.
            try:
                total = sum(e[2] for e in list(cache.values()))
                while cache and (
                    len(cache) >= _HOST_SUB_CACHE_MAX
                    or total + nbytes > _HOST_SUB_TOTAL_BYTES
                ):
                    stale = next(
                        (k for k, e in list(cache.items())
                         if e[0] != version),
                        None,
                    )
                    victim = stale if stale is not None else next(iter(cache))
                    evicted = cache.pop(victim, None)
                    if evicted is not None:
                        total -= evicted[2]
            except (StopIteration, RuntimeError):
                pass
            cache[key] = (version, gathered, nbytes)
            return gathered

        return thunk

    # -- search ------------------------------------------------------------

    def _candidate_mask(self, metadata_filter, exclude_filter, or_filters):
        """(mask, n_candidates) for the filter triple. Caller holds the lock.

        mask is None for "all rows" — no-filter queries never touch a
        per-row Python structure (the reference pays an O(N) set build per
        query even unfiltered, vector_database.py:356). Filtered masks are
        cached per corpus version, so repeated filters cost one dict hit.
        """
        if not metadata_filter and not exclude_filter and not or_filters:
            # mask None: the snapshot injects the store's alive mask itself
            # when tombstoned deletes are pending (StoreSnapshot.search)
            return None, self.live_count

        if self._mask_cache_version != self._version:
            self._mask_cache.clear()
            # drop stale gathered submatrices too — they are the big entries
            # (version-checked at hit time, but holding dead copies until
            # eviction would pin up to _HOST_SUB_CACHE_MAX old corpora slices)
            self._host_sub_cache.clear()
            self._mask_cache_version = self._version
        key = filters_cache_key(metadata_filter, exclude_filter, or_filters)
        if key is not None and key in self._mask_cache:
            return self._mask_cache[key]

        sel = select_rows(
            self._filter_context(), metadata_filter, exclude_filter, or_filters
        )
        n = sel.n_candidates(self.count)
        mask = sel.to_mask(self.count)
        alive = self.store.alive_host if self.store is not None else None
        if alive is not None:
            # Tombstoned deletes pending: filter structures already exclude
            # dead uids (inverse_id_map / value index / cleared column
            # presence), but the lazy all-rows-minus-excludes sentinel and
            # any defensive path must not admit them — AND with the alive
            # mask and recount (one vectorized pass per (filter, version);
            # results are version-cached).
            mask = alive.copy() if mask is None else (mask & alive)
            n = int(mask.sum())
        if key is not None:
            if len(self._mask_cache) >= _MASK_CACHE_MAX:
                self._mask_cache.pop(next(iter(self._mask_cache)))
            self._mask_cache[key] = (mask, n)
        return mask, n

    def _scan(self, q, metadata_filter, exclude_filter, or_filters, k,
              fetch=True, nprobe=None, hold=None, _force_exact=False):
        """Shared search core: filter + snapshot under the lock, device scan
        outside it. Returns (vals, idx, uids, metadata) or None when the
        candidate set is empty. With fetch=False it returns (results, uids,
        metadata): results is a ``_Deferred`` whose ``get()`` drains the
        pair, and the scan's op (``device_scan`` / ``ivf_scan``) is counted
        at dispatch and timed to that drain, not to the enqueue.

        hold: optional list that receives the store snapshot(s), for a caller
        that must keep them alive past this call (a deferred search: while a
        snapshot lives, the store does not write its tensors in place).

        nprobe: per-call override of ivf_opts['nprobe'] (index='ivf' only) —
        the standard IVF recall/latency knob, so one database can serve both
        fast dashboards and high-recall offline jobs.

        Snapshot-consistency: uids/metadata are only ever appended to or
        wholesale replaced under the lock (compaction builds fresh lists),
        so the references captured here stay row-aligned with the device
        snapshot even while writers proceed.

        Routing: index='ivf' serves unfiltered queries from the
        coarse-quantized index (+ exact scan of the post-build overflow rows,
        merged). BROAD filters (passing >= filtered_min_frac of the corpus)
        ride the same probe with an overfetched, device-masked candidate
        stage; any query row that still finds fewer than search_k eligible
        hits reruns through the exact masked scan (_force_exact), so the
        reference's exact-count contract holds unconditionally. Selective
        filters, filtered async dispatches and sub-threshold corpora keep the
        exact masked scan (ANN pruning there would only cost recall)."""
        ivf = osnap = None
        built = 0
        ivf_mask = None
        with self.lock:
            with self.telemetry.timed("filter", "search.filter"):
                mask, n_candidates = self._candidate_mask(
                    metadata_filter, exclude_filter, or_filters
                )
            if n_candidates == 0:
                return None
            search_k = min(k, n_candidates)
            use_ivf = (
                not _force_exact
                and (
                    mask is None
                    or (
                        fetch
                        and n_candidates
                        >= self.ivf_opts["filtered_min_frac"] * self.count
                    )
                )
                and self.ivf_active()
            )
            if use_ivf:
                self._ensure_ivf()
                # frozen view: deletes swap the live index's tables, and
                # this scan runs outside the lock against the uids/metadata
                # captured below
                ivf = self._ivf.snapshot()
                if (
                    self.mesh is not None
                    and ivf.quantized
                    and ivf.data is None
                ):
                    # row-sharded exact rescore: bind the distributed scan
                    # snapshot (synced here, under the lock, so its rows
                    # match the id space the probe's tables index into).
                    # Only float32 mesh engines drop the single-device
                    # rescore corpus (data is None); bf16/int8 engines keep
                    # it, and building the sharded exact-scan buffer for
                    # them would cost a redundant corpus copy
                    ivf.attach_sharded_rescore(self._index_snapshot())
                built = self._ivf_built_count
                if self._ivf_overflow is not None and self._ivf_overflow.count:
                    osnap = self._ivf_overflow.snapshot()
                    if hold is not None:
                        hold.append(osnap)
            else:
                snap = self._index_snapshot()
                if hold is not None:
                    hold.append(snap)
            uids, metadata = self.uids, self.metadata
            if nprobe is None:
                nprobe = self.ivf_opts["nprobe"]
            else:
                # operator.index accepts any integral type (np.int64, …)
                # but bool must not silently mean nprobe=1
                if isinstance(nprobe, bool):
                    raise ValueError("nprobe must be a positive integer")
                try:
                    nprobe = _operator.index(nprobe)
                except TypeError:
                    raise ValueError(
                        "nprobe must be a positive integer"
                    ) from None
                if nprobe < 1:
                    raise ValueError("nprobe must be a positive integer")
            mask_dev = (
                None
                if mask is None
                else self._device_mask_thunk(
                    metadata_filter, exclude_filter, or_filters, mask
                )
            )
            # mesh engines use the mask thunk only on the IVF branch (the
            # exact mesh path ships the host mask to its shards itself) and
            # have no host route
            host_sub = (
                None
                if mask is None or self.mesh is not None
                else self._host_sub_thunk(
                    metadata_filter, exclude_filter, or_filters, mask,
                    n_candidates,
                )
            )
            if ivf is not None and mask is not None:
                # capacity matches the exact path's padded snapshot width so
                # both share one _dev_mask_cache entry per filter key; the
                # thunk itself resolves (uploads) OUTSIDE the lock below
                ivf_mask_cap = self.store.next_device_capacity()
                ivf_frac = n_candidates / max(1, self.count)
        if ivf is not None:
            with self._scan_op("ivf_scan", fetch) as drained:
                if mask is not None:
                    ivf_mask = (
                        mask_dev(ivf_mask_cap)
                        if mask_dev is not None
                        else scan_ops.to_device(mask, self.device)
                    )
                if ivf_mask is not None:
                    vals, idx = ivf.search(
                        q, search_k, nprobe=nprobe, fetch=False,
                        mask_dev=ivf_mask, mask_frac=ivf_frac,
                    )
                else:
                    vals, idx = ivf.search(
                        q, search_k, nprobe=nprobe, fetch=False
                    )
                if fetch:
                    with span("search.fetch"):
                        vals, idx = _fetch_results(vals, idx)
                if osnap is not None:
                    ovals, oidx = osnap.search(
                        q, min(search_k, osnap.count), fetch=fetch,
                        mask=None if mask is None else mask[built:],
                    )
                    if fetch:
                        vals = np.concatenate([vals, ovals], axis=1)
                        idx = np.concatenate([idx, oidx + built], axis=1)
                        order = np.argsort(-vals, axis=1)[:, :search_k]
                        vals = np.take_along_axis(vals, order, axis=1)
                        idx = np.take_along_axis(idx, order, axis=1)
                    else:
                        # async callers must not drain here: merge the IVF
                        # hits with the overflow scan ON DEVICE so the
                        # dispatch stays queued until .result() (a host-
                        # routed overflow scan, or an index with no live
                        # row, hands back numpy: upload those few values)
                        km = min(
                            search_k,
                            int(vals.shape[1]) + int(ovals.shape[1]),
                        )
                        vals, idx = _merge_topk_device(
                            *(self._as_device(t) for t in
                              (vals, idx, ovals, oidx)),
                            built, km,
                        )
            if not fetch:
                return _Deferred(vals, idx, drained), uids, metadata
            if mask is not None:
                # count-guarantee: queries that found fewer than search_k
                # eligible rows in the probed lists (filter correlated with
                # cluster structure past what the overfetch covers) rerun
                # through the exact masked scan, which serves exactly
                # min(k, n_candidates) like the reference. Only the SHORT
                # rows rerun — the probe work for the rest is kept.
                vals, idx = _fetch_results(vals, idx)
                if vals.shape[1] < search_k:
                    short = np.arange(vals.shape[0])
                else:
                    short = np.flatnonzero(
                        (vals > -1.0e38).sum(axis=1) < search_k
                    )
                if short.size == vals.shape[0]:
                    return self._scan(
                        q, metadata_filter, exclude_filter, or_filters, k,
                        nprobe=nprobe, _force_exact=True,
                    )
                if short.size:
                    # a tensor batch is sliced where it lives — the
                    # zero-copy contract must hold on the short-row rerun
                    # too, not just the happy path
                    q_short = (
                        q[torch.from_numpy(short).to(q.device)]
                        if scan_ops.is_device_array(q)
                        else np.asarray(q)[short]
                    )
                    res2 = self._scan(
                        q_short, metadata_filter,
                        exclude_filter, or_filters, k,
                        nprobe=nprobe, _force_exact=True,
                    )
                    # splice only when the row space provably did not move
                    # under us: appends mutate uids/metadata in place (old
                    # row ids stay valid), deletes build FRESH lists — an
                    # identity mismatch means rerun the whole batch against
                    # one consistent snapshot instead
                    if (
                        res2 is not None
                        and res2[2] is uids
                        and res2[3] is metadata
                        and res2[0].shape[1] == vals.shape[1]
                    ):
                        if not vals.flags.writeable:
                            vals, idx = vals.copy(), idx.copy()
                        vals[short] = res2[0]
                        idx[short] = res2[1]
                        return vals, idx, uids, metadata
                    return self._scan(
                        q, metadata_filter, exclude_filter, or_filters, k,
                        nprobe=nprobe, _force_exact=True,
                    )
            return vals, idx, uids, metadata
        with self._scan_op("device_scan", fetch) as drained:
            vals, idx = self._snapshot_search(
                snap, q, search_k, mask, fetch=fetch, mask_dev=mask_dev,
                host_sub=host_sub,
            )
        if not fetch:
            return _Deferred(vals, idx, drained), uids, metadata
        return vals, idx, uids, metadata

    @contextlib.contextmanager
    def _scan_op(self, op, fetch):
        """The span ``search.scan`` around a scan, with the count and time of
        its op. A fetching scan is timed to the end of the block; a deferred
        one is counted now, and the block gets the callable that adds its
        time at the drain (``_Deferred``)."""
        if fetch:
            with self.telemetry.timed(op, "search.scan"):
                yield None
        else:
            drained = self.telemetry.begin(op)
            with span("search.scan"):
                yield drained

    def _as_device(self, t):
        """A result array as a tensor on the engine's device (numpy from a
        host-routed scan is uploaded; a tensor passes through)."""
        if isinstance(t, torch.Tensor):
            return t
        return scan_ops.to_device(np.ascontiguousarray(t), self.device)

    @staticmethod
    def _format_hits(vals_row, idx_row, uids, metadata, return_distances):
        n = len(vals_row)
        # scores arrive sorted DESCENDING from every search path, so one
        # check of the last slot detects the common no-masked-slots case and
        # skips the per-item sentinel test (this formatting loop runs
        # B*k times per batch call — it shows up in api_efficiency)
        if n and vals_row[n - 1] >= -1.0e38:
            if return_distances:
                # 1 - s of a descending s is already ascending: sorted
                return (
                    tuple(uids[r] for r in idx_row),
                    tuple(1.0 - float(s) for s in vals_row),
                    tuple(metadata[r] for r in idx_row),
                )
            return (
                tuple(uids[r] for r in idx_row),
                # Python floats, matching _format_hits_batch's fast path
                # (vals.tolist()) — callers see ONE scalar type regardless
                # of which formatting path a batch happened to take
                tuple(float(s) for s in vals_row),
                tuple(metadata[r] for r in idx_row),
            )
        found = []
        for score, row in zip(vals_row, idx_row):
            if score < -1.0e38:  # masked/padded slot — fewer than k candidates
                continue
            s = float(score)
            found.append(
                (uids[row],
                 (1.0 - s) if return_distances else s,
                 metadata[row])
            )
        if return_distances:
            found.sort(key=lambda t: t[1])
        return tuple(zip(*found)) if found else ([], [], [])

    @staticmethod
    def _format_hits_batch(vals, idx, uids, metadata, return_distances):
        """Batch-vectorized _format_hits: one C-level gather per field
        instead of B*k Python generator steps — the per-row loop is the
        dominant serial term in pipelined serving throughput (device work
        overlaps across in-flight handles; this does not). The fast path requires no masked slots
        anywhere in the batch — scores arrive sorted descending per row,
        so one min() over the last column checks every row at once.
        Filtered batches that came up short fall back to the row loop."""
        B = vals.shape[0]
        if vals.size == 0 or float(vals[:, -1].min()) < -1.0e38:
            return [
                SearchEngine._format_hits(vals[b], idx[b], uids, metadata,
                                          return_distances)
                for b in range(B)
            ]
        k = vals.shape[1]
        flat = idx.ravel().tolist()
        if len(flat) == 1:
            ids_flat = (uids[flat[0]],)
            md_flat = (metadata[flat[0]],)
        else:
            getter = _operator.itemgetter(*flat)
            ids_flat = getter(uids)
            md_flat = getter(metadata)
        if return_distances:
            # float64 subtraction matches the row path's 1.0 - float(s)
            rows = (1.0 - vals.astype(np.float64)).tolist()
        else:
            rows = vals.tolist()
        return [
            (ids_flat[b * k:(b + 1) * k], tuple(rows[b]),
             md_flat[b * k:(b + 1) * k])
            for b in range(B)
        ]

    @spanned("search")
    def search(
        self,
        embedding,
        metadata_filter=None,
        exclude_filter=None,
        or_filters=None,
        k: int = 5,
        return_distances: bool = False,
        nprobe: int | None = None,
    ):
        """Filtered top-k. Returns (ids, scores, metadatas) tuples.

        ``return_distances=True`` converts cosine similarity to cosine
        distance (1 - cos), mirroring the usearch engine's lower-is-better
        outputs (reference sharded_vector_database_usearch.py:629-637).

        With coalescing enabled (coalesce_window_ms > 0), concurrent calls
        from different threads batch into shared device dispatches."""
        # capture once: set_coalesce_window may swap the attribute between
        # the check and the call
        coal = self._coalescer
        if coal is not None and self.store is not None and self.count:
            return coal.submit(
                embedding, metadata_filter, exclude_filter, or_filters, k,
                return_distances, nprobe,
            )
        return self._search_direct(
            embedding, metadata_filter, exclude_filter, or_filters, k,
            return_distances, nprobe,
        )

    def _search_direct(
        self,
        embedding,
        metadata_filter=None,
        exclude_filter=None,
        or_filters=None,
        k: int = 5,
        return_distances: bool = False,
        nprobe: int | None = None,
    ):
        if self.store is None or self.count == 0:
            return [], [], []
        q = np.asarray(embedding, dtype=np.float32).reshape(1, -1)
        res = self._scan(q, metadata_filter, exclude_filter, or_filters, k,
                         nprobe=nprobe)
        if res is None:
            return [], [], []
        vals, idx, uids, metadata = res
        with span("search.format"):
            return self._format_hits(vals[0], idx[0], uids, metadata,
                                     return_distances)

    @spanned("search")
    def search_batch(
        self,
        embeddings,
        metadata_filter=None,
        exclude_filter=None,
        or_filters=None,
        k: int = 5,
        return_distances: bool = False,
        nprobe: int | None = None,
    ):
        """Batched search: one device scan over all queries. Returns a
        list of (ids, scores, metadatas) triples; filters apply to every
        query. No reference equivalent (the reference is one query/call).

        A tensor batch (``torch.Tensor`` — e.g. a serving batch uploaded
        once to the engine's device) is passed through zero-copy: the
        queries are never pulled to host or re-uploaded, and the scan runs
        on the device where they live."""
        if scan_ops.is_device_array(embeddings):
            q = scan_ops.as_device_queries(embeddings, self.device)
        else:
            q = np.asarray(embeddings, dtype=np.float32)
            if q.ndim == 1:
                q = q[None, :]
        if self.store is None or self.count == 0:
            return [([], [], [])] * q.shape[0]
        res = self._scan(q, metadata_filter, exclude_filter, or_filters, k,
                         nprobe=nprobe)
        if res is None:
            return [([], [], [])] * q.shape[0]
        vals, idx, uids, metadata = res
        with span("search.format"):
            return self._format_hits_batch(vals, idx, uids, metadata,
                                           return_distances)

    @spanned("search")
    def search_batch_multi(
        self,
        embeddings,
        metadata_filters,
        k: int = 5,
        return_distances: bool = False,
        nprobe: int | None = None,
    ):
        """Batched search with a DIFFERENT filter per query.

        ``metadata_filters``: one metadata_filter (dict/list or None) per
        query. Queries sharing an identical (cache-key-equal) filter are
        grouped into ONE masked device dispatch; distinct filters become
        separate dispatches made with fetch=False so they queue on the
        device before a single drain. Returns one (ids, scores,
        metadatas) triple per query, in input order."""
        q = np.asarray(embeddings, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        B = q.shape[0]
        if len(metadata_filters) != B:
            raise ValueError(
                f"metadata_filters must have one entry per query "
                f"({len(metadata_filters)} != {B})"
            )
        if self.store is None or self.count == 0:
            return [([], [], [])] * B
        groups: dict = {}
        for i, f in enumerate(metadata_filters):
            key = filters_cache_key(f, None, None)
            gk = key if key is not None else ("__uncacheable__", i)
            groups.setdefault(gk, (f, []))[1].append(i)
        results = [None] * B
        if len(groups) == 1:
            # one filter group = the ordinary batch path: fetch=True keeps
            # the adaptive host/device router in the loop (fetch=False
            # bypasses it) and there is nothing to pipeline anyway
            ((f, idxs),) = groups.values()
            res = self._scan(q, f, None, None, k, nprobe=nprobe)
            if res is None:
                return [([], [], [])] * B
            vals, idx, uids, metadata = res
            v, ix = _fetch_results(vals, idx)
            with span("search.format"):
                return self._format_hits_batch(v, ix, uids, metadata,
                                               return_distances)
        pending = []
        # one lock acquisition (RLock — _scan re-enters it) around every
        # group's filter+snapshot capture, so all groups answer from ONE
        # corpus version even with racing writers — same snapshot
        # consistency the shared-filter batch paths give. Dispatches are
        # fetch=False (async); the drains below run outside the lock.
        with self.lock:
            for f, idxs in groups.values():
                sub = np.ascontiguousarray(q[np.asarray(idxs)])
                res = self._scan(sub, f, None, None, k, fetch=False,
                                 nprobe=nprobe)
                pending.append((idxs, res))
        for idxs, res in pending:
            if res is None:
                for i in idxs:
                    results[i] = ([], [], [])
                continue
            fetch, uids, metadata = res
            v, ix = fetch.get()  # drains this group
            with span("search.format"):
                formatted = self._format_hits_batch(
                    v, ix, uids, metadata, return_distances
                )
            for j, i in enumerate(idxs):
                results[i] = formatted[j]
        return results

    @spanned("search")
    def search_batch_async(
        self,
        embeddings,
        metadata_filter=None,
        exclude_filter=None,
        or_filters=None,
        k: int = 5,
        return_distances: bool = False,
        nprobe: int | None = None,
    ) -> "PendingSearch":
        """Pipelined batched search: queues the device work and returns
        immediately with a PendingSearch; the wait for the device->host
        result transfer and the host-side formatting happen at .result().
        Several in-flight PendingSearch objects queue their work on the
        device back to back, which a synchronous call serializes with a
        drain each. Snapshot-consistent: the handle holds its snapshot's
        tensors, so results reflect the corpus at dispatch time regardless
        of mutations before .result(). Tensor batches pass through
        zero-copy, same contract as search_batch."""
        if scan_ops.is_device_array(embeddings):
            q = scan_ops.as_device_queries(embeddings, self.device)
        else:
            q = np.asarray(embeddings, dtype=np.float32)
            if q.ndim == 1:
                q = q[None, :]
        if self.store is None or self.count == 0:
            return PendingSearch(lambda: [([], [], [])] * q.shape[0])
        snap_hold: list = []
        res = self._scan(q, metadata_filter, exclude_filter, or_filters, k,
                         fetch=False, nprobe=nprobe, hold=snap_hold)
        if res is None:
            return PendingSearch(lambda: [([], [], [])] * q.shape[0])
        fetch, uids, metadata = res

        def materialize():
            # blocks until the device work drains; one batched transfer. The
            # closure holds the snapshot until then, so no writer touches
            # the tensors the queued scan reads.
            v, i = fetch.get()
            snap_hold.clear()
            with span("search.format"):
                return self._format_hits_batch(v, i, uids, metadata,
                                               return_distances)

        return PendingSearch(materialize, current_request())


class PendingSearch:
    """Handle for an in-flight search (engine.search_batch_async): call
    .result() to drain the device transfer and get the formatted hits.
    Idempotent — the materialized result is cached. The drain is the span
    ``search.result``, a root under its dispatch's request id."""

    __slots__ = ("_materialize", "_out", "_request")

    def __init__(self, materialize, request=None):
        self._materialize = materialize
        self._out = None
        self._request = request

    def result(self):
        if self._out is None:
            with span("search.result", request=self._request):
                self._out = self._materialize()
            self._materialize = None
        return self._out


def _rel_change(delta: float, denom: float) -> float:
    """delta/denom with the zero-denominator limit: an exact-match hit
    (cosine distance exactly 0.0, or a 0 score) made the reference's raw
    division crash with ZeroDivisionError. The limiting behavior is what a
    user means: any change away from 0 is an infinite relative change; no
    change is none."""
    if denom != 0.0:
        return delta / denom
    return float("inf") if delta > 0 else (float("-inf") if delta < 0 else 0.0)


def autocut_scores(score_list):
    """Indices to drop after the sharpest >20% score DROP (higher-is-better).

    Parity with reference vector_database.py:443-464 (plus the zero-score
    guard — see _rel_change)."""
    score_decreases = []
    for i in range(1, len(score_list)):
        score_decreases.append(
            _rel_change(score_list[i - 1] - score_list[i], score_list[i - 1])
        )
    max_dec = max(score_decreases)
    if max_dec > 0.2:
        return list(range(score_decreases.index(max_dec) + 1, len(score_list)))
    return []


def autocut_distances(distance_list):
    """Indices to drop after the sharpest >20% distance INCREASE
    (lower-is-better). Parity with reference
    sharded_vector_database_usearch.py:573-594 (plus the exact-match
    zero-distance guard — an exact hit at distance 0.0 means every worse
    hit is an infinite relative increase, so only the exact match stays)."""
    increases = []
    for i in range(1, len(distance_list)):
        increases.append(
            _rel_change(
                distance_list[i] - distance_list[i - 1], distance_list[i - 1]
            )
        )
    max_inc = max(increases)
    if max_inc > 0.2:
        return list(range(increases.index(max_inc) + 1, len(distance_list)))
    return []


def apply_autocut(remove_indexes, ids, distances, metadatas):
    if remove_indexes:
        keep = [i for i in range(len(ids)) if i not in remove_indexes]
        ids = [ids[i] for i in keep]
        distances = [distances[i] for i in keep]
        metadatas = [metadatas[i] for i in keep]
    return ids, distances, metadatas
