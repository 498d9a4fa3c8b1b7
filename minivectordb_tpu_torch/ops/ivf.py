"""IVF (inverted-file) coarse-quantized search.

Counterpart of ``minivectordb_tpu/ops/ivf.py``. The reference has no ANN
index at all (exact FAISS/usearch scans only). This is an IVF-flat design
with static shapes:

- k-means trained on the device (Lloyd iterations, all products on the
  device);
- the corpus is re-packed CLUSTER-MAJOR into a dense (nlist, P, d) tensor,
  each list padded to the same capacity P (valid-mask carried alongside), so
  a probe reads whole list blocks, never a ragged loop;
- query: score centroids -> top-nprobe lists -> score the probed blocks
  (ops/ivf_probe.py: kernels K3, K4, K5) -> masked top-k.

Recall is tunable via nprobe; with nprobe = nlist the search is exact.

Everything here is plain PyTorch on the tensors' device (CUDA or CPU) plus
int-sized numpy bookkeeping on the host. float32 products are IEEE float32
(ops/scan.py switches TF32 off).

Differences from the JAX module:
- the k-means start rows are drawn from a ``torch.Generator`` seeded with
  ``seed`` (``jax.random.choice`` has no PyTorch equivalent), so centroids
  trained by the two packages differ; ``_kmeans_device`` takes ``init_idx``
  so a test can hand both the same rows, and a trained layout crosses between
  the packages as a state dict (``convert.ivf_state_from_numpy``);
- Lloyd sums are ``index_add_``, whose order on a CUDA device varies from run
  to run, so centroids repeat only to float32 rounding there;
- nothing is compiled, so the JAX index's ``precompile_async`` (XLA programs
  compiled under a pending upload) has no counterpart;
- ``IVFSnapshot.search`` has one route rule on either device: batch >= 16 or
  int8 lists -> grouped probe, else paged probe; the wrappers of
  ops/ivf_probe.py pick kernel (CUDA tensor) or plain version (CPU tensor).
  ``_ivf_search`` is kept as a second, independent formulation of the probe.
"""

from __future__ import annotations

import numpy as np
import torch

from minivectordb_tpu_torch.ops import ivf_probe
from minivectordb_tpu_torch.ops import scan as scan_ops

_MASKED = float(scan_ops._MASKED_SCORE)

_LISTS_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
}

_ASSIGN_CHUNK = 1 << 16  # rows per assignment step (bounds the sims matrix)


def _assign_chunked(data, centroids):
    """argmax-similarity assignment without materializing (n, nlist) at once."""
    scan_ops._assert_ieee_f32(data)
    n = data.shape[0]
    out = torch.empty((n,), dtype=torch.int64, device=data.device)
    ct = centroids.T
    for lo in range(0, n, _ASSIGN_CHUNK):
        hi = min(lo + _ASSIGN_CHUNK, n)
        out[lo:hi] = torch.argmax(data[lo:hi].to(torch.float32) @ ct, dim=1)
    return out


def _kmeans_device(data, nlist: int, iters: int, seed: int = 0, init_idx=None):
    """Spherical k-means (cosine) on the device. data: (n, d) float32,
    L2-normalized. Returns (centroids (nlist, d), assignment (n,) int64).

    Lloyd updates use ``index_add_`` (scatter-add) instead of a one-hot
    matmul so memory stays O(n*d + nlist*d); assignment is chunked for the
    same reason. ``init_idx``: the nlist start rows; drawn without
    replacement from a generator seeded with ``seed`` when None."""
    n, d = data.shape
    if init_idx is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed))
        init_idx = torch.randperm(n, generator=gen)[:nlist]
    init_idx = torch.as_tensor(np.array(init_idx), dtype=torch.int64).to(data.device)
    centroids = data[init_idx]
    for _ in range(iters):
        assign = _assign_chunked(data, centroids)
        sums = torch.zeros((nlist, d), dtype=torch.float32, device=data.device)
        sums.index_add_(0, assign, data)
        counts = torch.bincount(assign, minlength=nlist).to(torch.float32)[:, None]
        new_cent = torch.where(
            counts > 0, sums / torch.clamp(counts, min=1.0), centroids
        )
        norms = torch.linalg.vector_norm(new_cent, dim=1, keepdim=True)
        centroids = new_cent / torch.clamp(norms, min=1e-30)
    return centroids, _assign_chunked(data, centroids)


def _assign_full_device(data, centroids, n: int):
    """Assign every live row on the device. Row scaling never changes the
    argmax across unit-norm centroids, so RAW rows are assigned directly —
    the normalized corpus is never materialized for assignment."""
    return _assign_chunked(data[:n], centroids)


def _gather_normalized_sample(data, inv_norms, idx):
    return data[idx].to(torch.float32) * inv_norms[idx][:, None]


_SCATTER_CHUNK = 1 << 17  # rows per scatter step (bounds the transient)


def _scatter_lists(data, inv_norms, dest, n: int, slots: int, out_dtype):
    """Normalize + cast + cluster-major scatter, chunked. data (cap, d);
    dest (n,) int64 flat slot per row. Returns (slots, d) lists.

    Chunking bounds the transient normalized-rows buffer to CHUNK x d while
    the corpus and the output are both live. The output is written in place."""
    out = torch.zeros((slots, data.shape[1]), dtype=out_dtype, device=data.device)
    for lo in range(0, n, _SCATTER_CHUNK):
        hi = min(lo + _SCATTER_CHUNK, n)
        rows = data[lo:hi].to(torch.float32) * inv_norms[lo:hi, None]
        if out_dtype == torch.int8:
            # rows are unit-norm, so a global 127 scale is the usearch-style
            # symmetric quantizer (round half to even, never -128); per-slot
            # inverse norms (computed after the scatter) absorb the rounding
            # in the cosine reconstruction
            rows = torch.clamp(torch.round(rows * 127.0), -127, 127)
        out[dest[lo:hi]] = rows.to(out_dtype)
    return out


def _slot_inv_norms(lists_flat):
    """1/||int8 slot|| per packed slot (0 for empty slots): the float32 scale
    that turns the int32 probe dot back into a cosine."""
    x = lists_flat.to(torch.float32)
    n = torch.sqrt(torch.sum(x * x, dim=-1))
    return torch.where(n > 0, 1.0 / torch.clamp(n, min=1e-30), torch.zeros_like(n))


def _rescore_kwide(k: int, lists_dtype) -> int:
    """Stage-1 candidate width for the two-stage quantized search: the true
    top-k only has to land anywhere inside the candidate set. bfloat16
    candidates get a 4x margin, int8's coarser scores 10x (the JAX package's
    constants, kept so both packages select the same candidate sets)."""
    if lists_dtype == torch.int8:
        return max(10 * k, k + 90)
    return max(4 * k, k + 30)


def _exact_rescore(data, inv_norms, q, cand_vals, cand_ids, k: int):
    """Re-rank quantized-path candidates against the corpus buffer.

    Quantized lists (bf16/int8) lose about 3 decimal digits of score
    precision; where the top-k neighbors sit within that noise the quantized
    ORDER is wrong even when the candidate SET is right. The fix is the
    classic two-stage pattern: take a wider quantized top-K', gather those K'
    rows from the corpus resident on the device (the store's packed buffer —
    no extra copy), and rescore exactly: B*K' rows against B*nprobe*P in the
    probe.

    cand_vals/cand_ids: (B, K') quantized scores + global row ids. Masked
    candidates (score <= -1.5e38) stay masked. Returns (B, k)."""
    scan_ops._assert_ieee_f32(data)
    qn = scan_ops._normalize(q.to(torch.float32))
    ids = cand_ids.long()
    rows = data[ids].to(torch.float32) * inv_norms[ids][..., None]  # (B, K', d)
    s = torch.bmm(rows, qn[:, :, None]).squeeze(-1)
    s = torch.where(cand_vals > _MASKED / 2, s, _MASKED)
    vals, pos = scan_ops.topk_last_axis(s, min(k, int(s.shape[1])))
    return vals, torch.gather(cand_ids, -1, pos)


def masked_overfetch_width(kk: int, mask_frac: float, count: int) -> int:
    """Candidate-stage width for a filter-masked probe: with fraction f of
    rows passing, a K-wide candidate set holds ~f*K eligible rows — widen by
    2/f (a power of two, the widths the JAX package runs) to make a kk-deep
    eligible set likely."""
    want = int(np.ceil(2.0 * kk / max(min(mask_frac, 1.0), 1e-6)))
    kk_eff = 1 << (max(want, 1) - 1).bit_length()
    return max(kk, min(kk_eff, count))


def _mask_scores(mask, vals, ids):
    """Sentinel-mask candidate scores whose global row fails the filter mask
    (True = eligible). Padded/invalid candidates already carry the sentinel
    and keep it (their ids may be arbitrary — the score check wins)."""
    return torch.where(mask[ids.long()], vals, _MASKED)


def _select_topk(vals, ids, k: int):
    v, pos = scan_ops.topk_last_axis(vals, k)
    return v, torch.gather(ids, -1, pos)


def _ivf_search(centroids, lists, list_ids, list_valid, q, nprobe, k,
                list_inv=None):
    """The probe written the plain way: one query at a time, one probed list
    at a time. centroids (L, d); lists (L, P, d) bf16/f32/int8; list_ids
    (L, P) int32; list_valid (L, P) bool; q (B, d) float32; list_inv (L, P)
    float32 for int8 lists. Returns (B, kk) scores + global ids,
    kk = min(k, nprobe*P).

    No search path calls this on a CUDA device: it is a second, independent
    formulation of what ``ivf_probe.ivf_search_grouped`` / ``_paged`` compute
    (the JAX package serves its CPU backend with the same formulation), held
    against them in the tests and in chip_smoke.py."""
    scan_ops._assert_ieee_f32(lists)
    # centroids are scored BATCHED, exactly like the kernel routes
    qn, probe_all = ivf_probe.probe_lists(centroids, q, nprobe)
    if list_inv is not None:
        qi, qinv_all = ivf_probe.quantize_queries_ivf(qn)
    else:
        qi = qn.to(lists.dtype).to(torch.float32)
        qinv_all = None
    p = lists.shape[1]
    kk = min(k, nprobe * p)
    vals_out, ids_out = [], []
    for b in range(q.shape[0]):
        scores, cand = [], []
        for list_id in probe_all[b].tolist():
            s = lists[list_id].to(torch.float32) @ qi[b]  # (P,)
            if list_inv is not None:
                s = s * list_inv[list_id] * qinv_all[b]
            scores.append(torch.where(list_valid[list_id], s, _MASKED))
            cand.append(list_ids[list_id])
        vals, pos = scan_ops.topk_last_axis(torch.cat(scores), kk)
        vals_out.append(vals)
        ids_out.append(torch.cat(cand)[pos])
    return torch.stack(vals_out), torch.stack(ids_out).to(torch.int32)


def _sorted_rows(rows) -> np.ndarray:
    return np.asarray(sorted({int(r) for r in rows}), dtype=np.int64)


def _remap_ids_for_deletes(ids, valid, rows, count):
    """Shared tombstone+remap core: returns (ids, valid, n_deleted)."""
    rows = _sorted_rows(rows)
    rows = rows[rows < count]
    if rows.size == 0:
        return ids, valid, 0
    doomed = valid & np.isin(ids, rows)
    valid = valid & ~doomed
    # compacted id = id - (# deleted rows below it); only live slots
    # matter (dead slots keep stale ids, never read past the mask)
    shift = np.searchsorted(rows, ids, side="left").astype(ids.dtype)
    ids = np.where(valid, ids - shift, ids)
    return ids, valid, int(rows.size)


def _tombstone(ids, valid, rows, count):
    """(valid with the slots of ``rows`` cleared, number cleared); ids stay."""
    rows = _sorted_rows(rows)
    rows = rows[(rows >= 0) & (rows < count)]
    if rows.size == 0:
        return valid, 0
    doomed = valid & np.isin(ids, rows)
    n_del = int(doomed.sum())
    return (valid & ~doomed) if n_del else valid, n_del


class IVFIndex:
    """Cluster-major padded IVF-flat index over a fixed corpus snapshot.

    Built once from the packed matrix (bulk path — incremental inserts go to
    the exact scan until the next build, like classic IVF train/add).
    ``device`` places the index when ``build`` is handed a host array (None
    = the CUDA card); a tensor is indexed where it lives."""

    def __init__(self, nlist: int = 1024, nprobe: int = 32, iters: int = 10,
                 device_dtype: str = "float32", seed: int = 0, *, device=None):
        self.nlist = nlist
        self.nprobe = nprobe
        self.iters = iters
        self.device_dtype = device_dtype
        self.seed = seed
        self.device = device
        self.nprobe_calibrated = False
        # duplicate centroids created by skew splitting (see build): search
        # widens the probe by this many slots so nprobe keeps counting
        # distinct trained clusters
        self.n_dup = 0
        self.centroids = None
        self._lists = None
        self._list_ids = None
        self._list_valid = None
        self._ids_host = None  # host copies of the two tables above
        self._valid_host = None
        self._list_inv = None  # int8 lists only: per-slot 1/||int8 row||
        # corpus refs (the store's resident buffer — no copy) for the
        # two-stage exact rescore of quantized (bf16/int8) candidates
        self._data = None
        self._inv_norms = None
        self.pad_len = 0
        # count: live vectors == the corpus row-prefix length this index
        # references (each live prefix row occupies exactly one valid slot,
        # an invariant delete_rows preserves). Dead slots accumulate in the
        # packed lists until the owner's rebuild policy triggers.
        self.count = 0

    def _train_shapes(self, n: int) -> tuple[int, int]:
        """(nlist, sample_rows) the build path uses for a corpus of n live
        rows."""
        nlist = min(self.nlist, max(1, n // 4))
        train_cap = max(nlist * 64, 100_000)
        return nlist, min(n, train_cap)

    def _lists_dtype(self):
        return _LISTS_DTYPES.get(self.device_dtype, torch.float32)

    def _upload(self, matrix, count):
        """Returns (data, inv_norms, n) on the device. ``matrix`` may be a
        host array or an already-resident (possibly capacity-padded) tensor —
        the store's device buffer feeds builds with no host round trip."""
        if isinstance(matrix, torch.Tensor):
            data = matrix
            n = int(matrix.shape[0]) if count is None else int(count)
        else:
            host = np.ascontiguousarray(matrix, dtype=np.float32)
            n = host.shape[0] if count is None else int(count)
            data = scan_ops.to_device(host, scan_ops.resolve_device(self.device))
        return data, scan_ops.row_inv_norms(data), n

    def build(self, matrix, count: int | None = None, inv_norms=None,
              centroids=None) -> None:
        """Train + pack, everything heavy on the device: the corpus crosses
        the host boundary at most once and only int-sized bookkeeping ever
        comes back. ``centroids`` (nlist, d), when given, replace the k-means
        (a test hands in the centroids the JAX package trained)."""
        data, inv, n = self._upload(matrix, count)
        if inv_norms is not None:
            inv = inv_norms
        self.count = n
        nlist, m = self._train_shapes(n)
        if centroids is None:
            # train on a bounded sample (classic IVF practice), assign all
            if n > m:
                rng = np.random.default_rng(self.seed)
                idx = np.sort(rng.choice(n, m, replace=False)).astype(np.int64)
            else:
                idx = np.arange(n, dtype=np.int64)
            sample = _gather_normalized_sample(
                data, inv, torch.from_numpy(idx).to(data.device)
            )
            centroids, _ = _kmeans_device(sample, nlist, self.iters, self.seed)
            del sample
        else:
            centroids = scan_ops.to_device(
                np.asarray(centroids, dtype=np.float32), data.device
            )
            nlist = int(centroids.shape[0])
        assign = _assign_full_device(data, centroids, n).cpu().numpy()
        centroids_np = centroids.cpu().numpy()

        # Skew control: the packed layout costs nlist_eff * P * d memory, so
        # P must stay near the BALANCED list size regardless of skew. Split
        # every cluster above cap into duplicate centroids (identical query
        # similarity -> duplicates rank adjacent, so a probed centroid's
        # overflow lists get probed with it) and drop empty clusters
        # entirely (an empty list can never contain a result). Total slots
        # are then <= ~n * 1.5 + nlist * small.
        counts = np.bincount(assign, minlength=nlist)
        # Pad cap: every list block is read whole at probe time, so padding
        # is wasted memory bandwidth. Align the cap itself to 128 rows and
        # keep it tight: oversized lists split into duplicates below.
        avg = n / max(1, nlist)
        cap = int(max(8, np.ceil(1.02 * avg)))
        if cap > 128:
            cap = (cap + 127) // 128 * 128
        new_centroids = [centroids_np]
        next_id = nlist
        for c in np.nonzero(counts > cap)[0]:
            rows = np.nonzero(assign == c)[0]
            n_parts = int(np.ceil(len(rows) / cap))
            for part_no in range(1, n_parts):
                part = rows[part_no * cap: (part_no + 1) * cap]
                assign[part] = next_id
                new_centroids.append(centroids_np[c][None, :])
                next_id += 1
        # Splitting grows the centroid count past the configured nlist, which
        # would silently break the documented "nprobe = nlist is exact"
        # contract: record the duplicate count so search can scale the probe
        # slot count by the split factor (duplicates score identically to
        # their parent, so they interleave with the distinct clusters a
        # user's nprobe was tuned against).
        self.n_dup = next_id - nlist
        if next_id > nlist:
            centroids_np = np.vstack(new_centroids)
            nlist = next_id
        counts = np.bincount(assign, minlength=nlist)
        nonempty = np.nonzero(counts > 0)[0]
        if len(nonempty) < nlist:
            remap = np.full(nlist, -1, dtype=np.int64)
            remap[nonempty] = np.arange(len(nonempty))
            assign = remap[assign]
            centroids_np = centroids_np[nonempty]
            nlist = len(nonempty)
        self.centroids = scan_ops.to_device(centroids_np, data.device)

        # cluster-major layout bookkeeping (int-sized host work only): rank
        # of each row within its cluster = position in the sorted order minus
        # the cluster's start
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        counts = np.bincount(sorted_assign, minlength=nlist)
        pad = int(max(1, counts.max()))
        # P is a multiple of 128: the JAX package's probe kernel needs it,
        # and both packages must pack the same shapes for a layout to cross
        # between them (the probe kernels here tile slots by 128 as well)
        pad = (pad + 127) // 128 * 128
        self.pad_len = pad

        starts = np.zeros(nlist, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        rank = np.arange(len(order), dtype=np.int64) - starts[sorted_assign]
        slot = sorted_assign.astype(np.int64) * pad + rank
        list_ids = np.zeros(nlist * pad, dtype=np.int32)
        valid = np.zeros(nlist * pad, dtype=bool)
        list_ids[slot] = order
        valid[slot] = True
        self._finish_pack(data, inv, slot, order, n, nlist, pad, list_ids, valid)

    def _finish_pack(self, data, inv, slot, order, n, nlist, pad,
                     list_ids, valid) -> None:
        """Device scatter into the padded cluster-major tensor; normalize +
        dtype cast happen on the scatter operand (rows store normalized so
        IP == cosine). A row without a valid slot (tombstoned in a layout
        that was reattached before its compaction) goes to one spare slot
        past the lists, which is cut off."""
        slots = nlist * pad
        dest = np.full(n, slots, dtype=np.int64)
        dest[order] = slot
        dev = data.device
        lists_flat = _scatter_lists(
            data, inv, scan_ops.to_device(dest, dev), n, slots + 1,
            self._lists_dtype(),
        )[:slots]
        if self._lists_dtype() != torch.float32:
            # quantized lists: keep refs to the corpus (already resident —
            # the store's buffer) so snapshots can rescore exactly
            self._data = data
            self._inv_norms = inv
        d = int(data.shape[1])
        self._lists = lists_flat.reshape(nlist, pad, d)
        # int8 lists carry a per-slot float32 inverse-norm table (the cosine
        # reconstruction scale); immutable after build, deletes only touch
        # ids/valid, so it lives OUTSIDE the atomically-swapped tuple
        self._list_inv = (
            _slot_inv_norms(lists_flat).reshape(nlist, pad)
            if lists_flat.dtype == torch.int8
            else None
        )
        self._set_tables(list_ids.reshape(nlist, pad), valid.reshape(nlist, pad))

    def _set_tables(self, list_ids: np.ndarray, valid: np.ndarray) -> None:
        """Upload fresh id / validity tables and swap them in. Single-
        attribute table tuple: searches run OUTSIDE the owning database's
        lock, so they must read (lists, ids, valid) in one atomic reference
        grab — deletes swap this tuple wholesale and never write a table in
        place (reading ids from one version and valid from another could
        resurrect a deleted row under a stale-remapped id). The host copies
        stay beside the tensors, so a delete reads nothing back from the
        device; they too are replaced, never written."""
        dev = self._lists.device
        self._ids_host = np.ascontiguousarray(list_ids, dtype=np.int32)
        self._valid_host = np.ascontiguousarray(valid, dtype=bool)
        self._list_ids = scan_ops.to_device(self._ids_host, dev)
        self._list_valid = scan_ops.to_device(self._valid_host, dev)
        self._tables = (self._lists, self._list_ids, self._list_valid)

    def refresh_corpus(self, data, inv_norms) -> None:
        """Swap the exact-rescore corpus refs (quantized lists only).

        Required after the owning store compacts rows: delete_rows remaps
        slot ids to post-compaction positions, so the retained build-time
        buffer no longer lines up with them — rescore would gather the wrong
        rows. The owner calls this with its freshly-synced (compacted)
        buffer under its lock, atomically with the id remap."""
        if self._data is not None:
            self._data = data
            self._inv_norms = inv_norms

    def delete_rows(self, rows) -> int:
        """Tombstone deleted global rows and remap the surviving slot ids to
        their post-compaction positions. Returns the number of rows
        tombstoned (rows >= count are ignored — they were never in the
        index).

        The owning database compacts its row matrix, shifting every global
        id above a deleted row down by the number of deletions below it.
        Remapping the (nlist, P) id table (pure int32 host work) keeps the
        trained centroids and the packed list tensor valid — the dead slots'
        stale vectors are masked by list_valid at probe time — so a delete
        never forces a full k-means rebuild."""
        ids, valid, n_del = _remap_ids_for_deletes(
            self._ids_host, self._valid_host, rows, self.count,
        )
        if n_del:
            self._set_tables(ids, valid)
            self.count -= n_del
        return n_del

    def tombstone_rows(self, rows) -> int:
        """Mark the slots of tombstoned global rows invalid WITHOUT remapping
        ids (the deferred-compaction delete path: physical row ids do not
        move, so surviving slot ids stay correct as-is; ``count`` keeps its
        physical meaning). Returns the number of newly-invalid slots."""
        valid, n_del = _tombstone(
            self._ids_host, self._valid_host, rows, self.count
        )
        if n_del:
            self._set_tables(self._ids_host, valid)
        return n_del

    @staticmethod
    def state_tombstone_rows(state: dict, rows) -> int:
        """tombstone_rows for a persisted (not yet attached) state dict —
        clears list_valid in place without remapping ids or count."""
        valid, n_del = _tombstone(
            np.asarray(state["list_ids"]), np.asarray(state["list_valid"]),
            rows, int(state["count"]),
        )
        if n_del:
            state["list_valid"] = valid
        return n_del

    @staticmethod
    def state_after_deletes(state: dict, rows) -> int:
        """delete_rows for a persisted (not yet attached) state dict —
        mutates list_ids/list_valid/count in place; returns rows removed."""
        ids, valid, n_del = _remap_ids_for_deletes(
            np.asarray(state["list_ids"]), np.asarray(state["list_valid"]),
            rows, int(state["count"]),
        )
        if n_del:
            state["list_ids"] = ids
            state["list_valid"] = valid
            state["count"] = int(state["count"]) - n_del
        return n_del

    # -- persistence ---------------------------------------------------------

    def state_dict(self) -> dict:
        """Small host-side state: centroids + layout, numpy arrays and
        builtins only (the JAX package's schema, so a pickle carrying it
        loads in either package). The packed list tensor itself is NOT stored
        (it duplicates the corpus); ``from_state`` rebuilds it with one
        device scatter from the embeddings."""
        return {
            "nlist": int(self.centroids.shape[0]),
            "nprobe": self.nprobe,
            # True when nprobe came from recall-target calibration — the
            # engine re-adopts it as the serving default on reattach
            "nprobe_calibrated": bool(self.nprobe_calibrated),
            "iters": self.iters,
            "seed": self.seed,
            "n_dup": int(self.n_dup),
            "pad_len": self.pad_len,
            "count": self.count,
            "device_dtype": self.device_dtype,
            "centroids": self.centroids.cpu().numpy(),
            "list_ids": self._ids_host.copy(),
            "list_valid": self._valid_host.copy(),
        }

    @classmethod
    def from_state(cls, state: dict, matrix, count: int | None = None,
                   inv_norms=None, device=None) -> "IVFIndex":
        """Reattach a persisted layout to the corpus without re-training."""
        idx = cls(
            nlist=state["nlist"],
            nprobe=state["nprobe"],
            iters=state.get("iters", 10),
            device_dtype=state.get("device_dtype", "float32"),
            seed=state.get("seed", 0),
            device=device,
        )
        idx.nprobe_calibrated = bool(state.get("nprobe_calibrated", False))
        idx.n_dup = int(state.get("n_dup", 0))
        idx.pad_len = int(state["pad_len"])
        idx.count = int(state["count"])
        list_ids = np.asarray(state["list_ids"])
        valid = np.asarray(state["list_valid"])
        nlist, pad = list_ids.shape
        data, inv, n = idx._upload(matrix, count)
        if inv_norms is not None:
            inv = inv_norms
        if n < idx.count:
            raise ValueError(
                f"IVF state covers {idx.count} rows but corpus has {n}"
            )
        idx.centroids = scan_ops.to_device(
            np.asarray(state["centroids"], dtype=np.float32), data.device
        )
        flat_valid = valid.reshape(-1)
        flat_ids = list_ids.reshape(-1)
        slot = np.nonzero(flat_valid)[0]
        order = flat_ids[slot]
        idx._finish_pack(data, inv, slot, order, idx.count, nlist, pad,
                         flat_ids, flat_valid)
        return idx

    def snapshot(self) -> "IVFSnapshot":
        """Frozen searchable view. The owning database captures this UNDER
        its lock (together with the row-aligned uids/metadata lists) and
        scans outside it: delete_rows swaps this index's tables, so a search
        bound to a live IVFIndex could resolve freshly-remapped ids against
        pre-delete uid lists."""
        return IVFSnapshot(
            self.centroids, self._tables, self.count, self.nprobe,
            self._list_inv, self._data, self._inv_norms, self.n_dup,
        )

    def search(self, queries, k: int, nprobe: int | None = None):
        return self.snapshot().search(queries, k, nprobe)


class IVFSnapshot:
    __slots__ = ("centroids", "tables", "count", "nprobe", "list_inv",
                 "data", "inv_norms", "n_dup")

    def __init__(self, centroids, tables, count, nprobe, list_inv=None,
                 data=None, inv_norms=None, n_dup=0):
        self.centroids = centroids
        self.tables = tables
        self.count = count
        self.nprobe = nprobe
        self.n_dup = n_dup
        self.list_inv = list_inv
        # corpus refs (tensors no writer touches below `count`) for exact
        # rescore of quantized candidates; None for float32 lists (scores
        # already exact)
        self.data = data
        self.inv_norms = inv_norms

    def search(self, queries, k: int, nprobe: int | None = None,
               fetch: bool = True, mask_dev=None, mask_frac: float = 1.0):
        """fetch=False returns DEVICE tensors (no result transfer), so async
        callers can queue several dispatches before one drain — same
        contract as StoreSnapshot.search(fetch=False).

        mask_dev: optional device bool tensor (True = row eligible), length
        >= the corpus row space the packed ids index into. The probe widens
        its candidate stage by ~1/mask_frac (the filter's passing fraction)
        so enough eligible rows survive the cut, then sentinel-masks
        ineligible candidates before the final top-k. Rows that still come
        up short carry sentinel scores — the owning engine falls back to the
        exact masked scan for those (count-guarantee stays with the engine).
        """
        nprobe = self.nprobe if nprobe is None else nprobe
        # nprobe counts DISTINCT trained clusters: skew splitting stores
        # oversized clusters under duplicate centroids, so scale the slot
        # count by the split factor (nlist_eff / distinct). This keeps the
        # probed-fraction semantics a user tunes against independent of
        # skew, and — because ceil(distinct * eff/distinct) = eff — keeps
        # the documented "nprobe = nlist is exact" contract.
        nlist_eff = int(self.centroids.shape[0])
        distinct = max(1, nlist_eff - self.n_dup)
        nprobe = min(-(-nprobe * nlist_eff // distinct), nlist_eff)
        dev = self.centroids.device
        if scan_ops.is_device_array(queries):
            # a tensor batch is searched where the index lives: no host bounce
            q = scan_ops.as_device_queries(queries, dev)
        else:
            q = np.ascontiguousarray(queries, dtype=np.float32)
            q = scan_ops.to_device(q[None, :] if q.ndim == 1 else q, dev)
        kk = min(k, self.count)
        if kk <= 0:
            # every indexed row tombstoned while stale stays under the
            # rebuild floor: a 0-wide top-k is undefined for the kernels
            b = int(q.shape[0])
            return (np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int32))
        lists, list_ids, list_valid = self.tables
        kk_eff = (
            masked_overfetch_width(kk, mask_frac, self.count)
            if mask_dev is not None
            else kk
        )
        # two-stage search for quantized lists: wider quantized top-K' then
        # exact rescore (quantized score noise reorders true neighbors; see
        # _exact_rescore). The margin only needs the true top-k to land
        # anywhere in the top-K' candidate set.
        rescore = self.data is not None and lists.dtype != torch.float32
        if rescore:
            kwide = min(
                _rescore_kwide(kk_eff, lists.dtype),
                nprobe * int(lists.shape[1]),
            )
        elif mask_dev is not None:
            kwide = min(kk_eff, nprobe * int(lists.shape[1]))
        else:
            kwide = kk
        if q.shape[0] >= 16 or self.list_inv is not None:
            # batch-first grouped probe: pairs are sorted by list on the
            # device so each touched list block is read once per group of 16
            # queries instead of once per query. int8 lists always take this
            # path (the per-pair kernel is f32/bf16).
            vals, ids = ivf_probe.ivf_search_grouped(
                self.centroids, lists, list_ids, list_valid, q, nprobe,
                kwide, list_inv=self.list_inv,
                selector="approx" if rescore else "exact",
            )
        else:
            # small batches are latency-bound; the per-pair paged kernel
            # skips the grouping bookkeeping
            vals, ids = ivf_probe.ivf_search_paged(
                self.centroids, lists, list_ids, list_valid, q, nprobe, kwide,
            )
        if mask_dev is not None:
            # sentinel-mask ineligible candidates BEFORE the rescore cut so
            # failing rows can't crowd eligible ones out of the final top-k
            vals = _mask_scores(mask_dev, vals, ids)
        if rescore:
            vals, ids = _exact_rescore(
                self.data, self.inv_norms, q, vals, ids, kk
            )
        elif mask_dev is not None:
            vals, ids = _select_topk(vals, ids, min(kk, int(vals.shape[1])))
        if not fetch:
            return vals, ids
        return scan_ops.fetch_results(vals, ids)
