"""Distributed exact scan: row-partitioned corpus, shard-local top-k, merge.

Counterpart of ``minivectordb_tpu/parallel/dist_scan.py``. The packed corpus
matrix is partitioned row-wise across the devices of a mesh
(parallel/mesh.py); each shard scans its own row block and produces a local
(k scores, k global ids) list; the lists are gathered on the first device and
a final top-k yields the global answer — the classic distributed exact-kNN
recipe (SURVEY.md §2c).

Each shard's scan is the single-device scan of the port: the fused route of
ops/fused_scan.py (phase-1 kernels K1-f32, K1-bf16 and K2 on a CUDA device,
their plain versions on the CPU) for batches of 16 and more over row blocks
of 4096 rows and more in whole 256-row tiles, else ops/scan.py. It is the
counterpart of the JAX module's ``_use_pallas``; there is no force of either
route.

The merge concatenates the shards' lists in shard order and takes
``topk_last_axis``, which keeps the lower position among equal scores — the
order of the JAX package's all-gather + ``lax.top_k``. A 2-D (dcn, ici) pod
mesh merges hierarchically: the shards of each host first, then the hosts'
lists; across processes (a mesh built after ``init_pod``) the host lists
travel by one ``torch.distributed.all_gather``, so every process returns the
same answer.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from minivectordb_tpu_torch.core.store import _FUSED_MIN_BATCH, _FUSED_MIN_CAPACITY
from minivectordb_tpu_torch.ops import fused_scan
from minivectordb_tpu_torch.ops import scan as scan_ops

_MASKED_SCORE = float(scan_ops._MASKED_SCORE)
_FUSED_ROW_TILE = 256  # row blocks in whole tiles (the JAX kernel's contract)
_DTYPES = ("float32", "bfloat16", "int8")


def _local_topk(buf, inv_norms, q, count_local: int, mask, k: int,
                row_base: int, fused: bool):
    """Top-k of one shard's row block. Returns (values (B, k) float32,
    GLOBAL row ids (B, k) int32). A block wholly past ``count`` scans
    nothing: its list is the sentinel at ids row_base .. row_base + k - 1,
    what a top-k over all-masked scores gives."""
    if count_local <= 0:
        b = q.shape[0]
        vals = torch.full((b, k), _MASKED_SCORE, device=buf.device)
        ids = torch.arange(k, device=buf.device, dtype=torch.int32) + row_base
        return vals, ids.expand(b, k)
    int8 = buf.dtype == torch.int8
    if fused:
        fn = fused_scan.fused_scan_topk_int8 if int8 else fused_scan.fused_scan_topk
    else:
        fn = scan_ops.scan_topk_int8 if int8 else scan_ops.scan_topk
    vals, idx = fn(buf, inv_norms, q, count_local, k, mask)
    return vals, idx + row_base


def merge_topk(pairs, k_out: int, device):
    """(values, ids) lists of several shards, in shard order, merged on
    ``device``: concatenated along the candidates and cut to the top
    ``k_out`` (lower position first among equal scores)."""
    vals = torch.cat([v.to(device) for v, _ in pairs], dim=1)
    ids = torch.cat([i.to(device) for _, i in pairs], dim=1)
    mv, pos = scan_ops.topk_last_axis(vals, min(k_out, int(vals.shape[1])))
    return mv, torch.gather(ids, 1, pos)


def _gather_processes(vals, ids):
    """All-gather one (values, ids) pair over the process group, packed into
    one int32 tensor (one collective): the lists of every process, in rank
    order."""
    import torch.distributed as dist

    packed = torch.stack([vals.contiguous().view(torch.int32), ids.to(torch.int32)])
    parts = [torch.empty_like(packed) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, packed)
    return [(p[0].view(torch.float32), p[1]) for p in parts]


def mesh_merge(mesh, pairs: dict, k_out: int, device):
    """Merge the local shards' lists ({global shard index: pair}) over the
    mesh. A 1-D mesh merges once; a (dcn, ici) pod mesh merges each host's
    shards first, then the hosts' lists — by an all-gather when the mesh
    spans processes."""
    if len(mesh.axis_names) != 2:
        return merge_topk([pairs[s] for s in sorted(pairs)], k_out, device)
    c = mesh.devices.shape[1]
    hosts = sorted({s // c for s in pairs})
    per_host = [
        merge_topk([pairs[s] for s in range(h * c, (h + 1) * c)], k_out, device)
        for h in hosts
    ]
    if mesh.distributed:
        per_host = _gather_processes(*per_host[0])
    return merge_topk(per_host, k_out, device)


def queries_on(queries, devices) -> dict:
    """The query batch as a float32 (B, d) tensor on each of ``devices``
    (one copy a distinct device): a numpy batch is uploaded, a tensor moved
    where it is needed."""
    out = {}
    base = None
    for dev in devices:
        if dev in out:
            continue
        if scan_ops.is_device_array(queries):
            out[dev] = scan_ops.as_device_queries(queries, dev)
            continue
        if base is None:
            base = np.ascontiguousarray(queries, dtype=np.float32)
            if base.ndim == 1:
                base = base[None, :]
        out[dev] = scan_ops.to_device(base, dev)
    return out


def _host_rows(rows: np.ndarray, dtype: str):
    """(rows in the stored type, as a CPU tensor; float32 1/norms or None):
    int8 and bfloat16 rows are quantized / cast on the host with the
    store's own helpers, so mesh and flat engines store identical rows and
    the link carries the stored bytes."""
    if dtype == "int8":
        qr, inorm = scan_ops.quantize_rows_int8_host(rows)
        return torch.from_numpy(qr), inorm
    if dtype == "bfloat16":
        return scan_ops.cast_rows_bf16_host(rows)
    return torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32)), None


class DistributedScanIndex:
    """Mesh-sharded packed corpus for multi-device exact search.

    Host-canonical like core.store.VectorStore: the caller keeps the rows;
    this index holds one row block a shard, each on its shard's device
    (capacity / n rows), and writes changed rows in place or, while a
    snapshot reads the old tensors, into copies."""

    def __init__(self, mesh, dim: int, device_dtype: str = "float32"):
        if device_dtype == "mixed":
            device_dtype = "float32"  # the bf16 shadow is the store's alone
        if device_dtype not in _DTYPES:
            raise ValueError(f"Unsupported device dtype: {device_dtype}")
        self.mesh = mesh
        self.dim = int(dim)
        self.n = int(mesh.devices.size)
        self.device_dtype = device_dtype
        self.count = 0
        self._shards = mesh.local_shards()
        self._bufs = None  # one tensor a local shard, in _shards' order
        self._invs = None
        self._capacity = 0
        # bytes shipped host -> devices (the incremental-sync test asserts a
        # mutation does not re-upload the corpus)
        self.bytes_uploaded = 0
        # weakrefs to snapshots of the CURRENT tensors: update() writes in
        # place only when none is alive (the store's discipline)
        self._snap_refs: list[weakref.ref] = []

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def local_rows(self) -> int:
        return self._capacity // self.n

    def _bucket(self, count: int) -> int:
        """pow2 up to 2^21 rows, then 2^21-multiples (ops/scan.py:
        capacity_bucket), rounded up to a multiple of n for odd meshes."""
        cap = scan_ops.capacity_bucket(max(count, 1), 1024)
        return cap + (-cap) % self.n

    def _write_block(self, rows: np.ndarray, dev) -> tuple:
        """A zero-padded (local_rows, d) block of ``rows`` in the stored
        type on ``dev``, with its 1/norms."""
        lr = self.local_rows
        stored, inorm = _host_rows(rows, self.device_dtype)
        block = torch.zeros((lr, self.dim), dtype=stored.dtype)
        block[: stored.shape[0]] = stored
        buf = scan_ops._tensor_to_device(block, dev)
        self.bytes_uploaded += block.numel() * block.element_size()
        if inorm is None:
            return buf, scan_ops.row_inv_norms(buf)
        inv = np.zeros(lr, dtype=np.float32)
        inv[: inorm.shape[0]] = inorm
        self.bytes_uploaded += inv.nbytes
        return buf, scan_ops.to_device(inv, dev)

    def load_rows(self, rows: np.ndarray, offset: int, capacity: int,
                  count: int) -> None:
        """Reset the index to ``capacity`` rows, ``count`` of them live, from
        the rows [offset, offset + len(rows)) of the global corpus; each
        local shard takes the part of them that falls in its row block."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if capacity % self.n:
            raise ValueError(f"capacity {capacity} is not a multiple of {self.n}")
        self._capacity = int(capacity)
        lr = self.local_rows
        bufs, invs = [], []
        for s, dev in self._shards:
            lo = max(s * lr - offset, 0)
            hi = min((s + 1) * lr - offset, rows.shape[0])
            buf, inv = self._write_block(rows[lo:max(lo, hi)], dev)
            bufs.append(buf)
            invs.append(inv)
        self._bufs, self._invs = bufs, invs
        self.count = int(count)
        self._snap_refs = []

    def load(self, matrix: np.ndarray) -> None:
        """The whole corpus (every process passes all of it; each keeps the
        blocks of its own shards)."""
        matrix = np.ascontiguousarray(matrix, dtype=np.float32)
        n = matrix.shape[0]
        self.load_rows(matrix, 0, self._bucket(n), n)

    def update(self, rows: np.ndarray, start: int, new_count: int) -> None:
        """Dirty-range sync: write ``rows`` at global row ``start`` into the
        shards whose blocks the range meets, in place when no snapshot is
        alive, else into copies (the snapshot keeps the old tensors). Caller
        guarantees start + len(rows) <= capacity and new_count <= capacity."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        n, lr = rows.shape[0], self.local_rows
        if start < 0 or start + n > self._capacity:
            raise ValueError(
                f"row window [{start}, {start + n}) outside capacity {self._capacity}"
            )
        self._snap_refs = [r for r in self._snap_refs if r() is not None]
        in_place = not self._snap_refs
        bufs, invs = list(self._bufs), list(self._invs)
        for j, (s, dev) in enumerate(self._shards):
            lo, hi = max(start, s * lr), min(start + n, (s + 1) * lr)
            if lo >= hi:
                continue
            stored, inorm = _host_rows(rows[lo - start:hi - start], self.device_dtype)
            piece = scan_ops._tensor_to_device(stored, dev)
            self.bytes_uploaded += stored.numel() * stored.element_size()
            if inorm is None:
                bufs[j], invs[j] = scan_ops.update_rows(
                    bufs[j], invs[j], piece, lo - s * lr, in_place)
            else:
                self.bytes_uploaded += inorm.nbytes
                bufs[j], invs[j] = scan_ops.write_rows_pre(
                    bufs[j], invs[j], piece, scan_ops.to_device(inorm, dev),
                    lo - s * lr, in_place)
        self._bufs, self._invs = bufs, invs
        self._snap_refs = []
        self.count = int(new_count)

    def snapshot(self) -> "DistSnapshot":
        """Frozen view for lock-free search (mirrors StoreSnapshot): holds
        the current tensors and count, so a concurrent ``update`` or
        ``load`` cannot tear a search in progress."""
        snap = DistSnapshot(self.mesh, self._shards, tuple(self._bufs),
                            tuple(self._invs), self.count, self._capacity)
        # prune dead refs on every snapshot too: read-only workloads never
        # reach update()'s prune
        self._snap_refs = [r for r in self._snap_refs if r() is not None]
        self._snap_refs.append(weakref.ref(snap))
        return snap

    def search(self, queries, k: int, mask: np.ndarray | None = None,
               fetch: bool = True):
        return self.snapshot().search(queries, k, mask, fetch=fetch)


class DistSnapshot:
    __slots__ = ("mesh", "shards", "bufs", "inv_norms", "count", "capacity",
                 "__weakref__")

    def __init__(self, mesh, shards, bufs, inv_norms, count, capacity):
        self.mesh = mesh
        self.shards = shards
        self.bufs = bufs
        self.inv_norms = inv_norms
        self.count = count
        self.capacity = capacity

    @property
    def dtype(self) -> torch.dtype:
        return self.bufs[0].dtype

    @property
    def local_rows(self) -> int:
        return self.capacity // int(self.mesh.devices.size)

    @property
    def device(self) -> torch.device:
        """Where results are merged and returned: the first local shard's."""
        return self.shards[0][1]

    def use_fused(self, batch: int) -> bool:
        """The per-shard route: the fused scan for batches of 16 and more
        over row blocks of 4096 rows and more in whole 256-row tiles (the
        store's crossover on each shard), else the plain scan."""
        lr = self.local_rows
        return (
            batch >= _FUSED_MIN_BATCH
            and lr >= _FUSED_MIN_CAPACITY
            and lr % _FUSED_ROW_TILE == 0
        )

    def search(self, queries, k: int, mask: np.ndarray | None = None,
               fetch: bool = True):
        """(scores, global row ids) (B, min(k, n·local candidates)),
        descending. ``mask`` (bool, one entry a corpus row) restricts the
        candidates. fetch=False returns tensors on ``device`` (no transfer),
        for async callers."""
        n = int(self.mesh.devices.size)
        lr = self.local_rows
        kb = 1
        while kb < k:
            kb <<= 1
        # per-shard candidates are bounded by local rows; the merge width
        # recovers min(k, count) when k exceeds a shard's rows
        kb_local = min(kb, lr)
        k_final = min(kb, n * kb_local)
        qs = queries_on(queries, [dev for _, dev in self.shards])
        batch = int(next(iter(qs.values())).shape[0])
        fused = self.use_fused(batch)
        padded = None
        if mask is not None:
            padded = np.zeros(self.capacity, dtype=bool)
            padded[: mask.shape[0]] = mask
        pairs = {}
        for j, (s, dev) in enumerate(self.shards):
            row_base = s * lr
            count_local = min(max(self.count - row_base, 0), lr)
            mask_s = (
                None if padded is None
                else scan_ops.to_device(padded[row_base:row_base + lr], dev)
            )
            pairs[s] = _local_topk(self.bufs[j], self.inv_norms[j], qs[dev],
                                   count_local, mask_s, kb_local, row_base, fused)
        vals, idx = mesh_merge(self.mesh, pairs, k_final, self.device)
        vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
        if not fetch:
            return vals, idx
        return scan_ops.fetch_results(vals, idx)
