"""Shard-per-device IVF: lists partitioned across the device mesh.

Counterpart of ``minivectordb_tpu/parallel/dist_ivf.py``. The trained
cluster-major list tensor (L, P, d) is partitioned on the LIST axis across a
1-D mesh, padded to a multiple of n with dead lists; each shard holds L/n
lists plus its slice of the centroid table. A query runs per shard as: score
the local centroids (dead lists masked) -> probe the local top-p lists
(p = ceil(nprobe / n)) -> local top-k over p*P candidates; the shards' lists
are then merged on the first device.

Probing each shard's top-p rather than the global top-nprobe is the classic
Faiss IndexShards recipe: no coordination before the merge, and with
p = L/n the probe is exhaustive and equal to the exact scan. Each shard picks
its own lists, so this index's results are those of the JAX package's
distributed index, not of the single-device one.

The per-shard scores come from the port's probe kernels: float32 and
bfloat16 lists through ``ops/ivf_probe.probe_scores`` (K3, exactly the JAX
module's ``scan_list``); int8 lists through ``grouped_scores_q`` (K5) on the
pairs of ``group_pairs``, with the JAX module's query quantizer
(round(qn * 127)) and scale order ((dots * 1/||slot||) * 1/||q||), which K5
computes bit for bit.

Quantized lists rescore exactly after the merge: against the single-device
corpus the wrapped index kept, or — after ``attach_sharded_rescore`` —
row-sharded against a distributed exact-scan snapshot: each shard rescores
the candidates it owns, the others give the sentinel, and an elementwise
max over the shards rebuilds the exact scores (the JAX module's ``pmax``).
"""

from __future__ import annotations

import numpy as np
import torch

from minivectordb_tpu_torch.ops import ivf_probe
from minivectordb_tpu_torch.ops import scan as scan_ops
from minivectordb_tpu_torch.ops.ivf import (
    _exact_rescore,
    _mask_scores,
    _remap_ids_for_deletes,
    _rescore_kwide,
    _select_topk,
    _tombstone,
    masked_overfetch_width,
)
from minivectordb_tpu_torch.parallel.dist_scan import merge_topk, queries_on

_MASKED_SCORE = float(scan_ops._MASKED_SCORE)


def _pad_lists(t: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


class DistributedIVFIndex:
    """Mesh-sharded wrapper over a trained IVFIndex, with the same search
    and state surface, so the engine treats both alike. Construction moves
    the packed tensors onto the mesh (device to device) and drops the
    wrapped index's own references to them."""

    def __init__(self, mesh, ivf, keep_single_device_rescore: bool = True):
        if mesh.distributed:
            raise ValueError("DistributedIVFIndex needs a mesh of one process")
        self.mesh = mesh
        self.n = int(mesh.devices.size)
        self.nprobe = ivf.nprobe
        self.nprobe_calibrated = ivf.nprobe_calibrated
        # duplicate centroids from skew splitting: search widens the probe
        # by this many slots (same contract as IVFSnapshot.search)
        self.n_dup = int(ivf.n_dup)
        self.count = ivf.count
        self.pad_len = ivf.pad_len
        self._state = ivf.state_dict()  # host-side, small (no list tensor)
        self.centroids = ivf.centroids  # unpadded (nlist, d), the first device
        nlist = int(ivf.centroids.shape[0])
        pad = (-nlist) % self.n
        self.nlist = nlist
        self._local_lists = (nlist + pad) // self.n
        live = np.ones(nlist + pad, dtype=bool)
        live[nlist:] = False
        cent = _pad_lists(ivf.centroids, pad)
        lists = _pad_lists(ivf._lists, pad)
        list_inv = None if ivf._list_inv is None else _pad_lists(ivf._list_inv, pad)
        self._shards = mesh.local_shards()
        ll = self._local_lists
        self._cent = tuple(cent[s * ll:(s + 1) * ll].to(d) for s, d in self._shards)
        self._cent_live = tuple(
            scan_ops.to_device(live[s * ll:(s + 1) * ll], d) for s, d in self._shards)
        self._list_inv = (
            None if list_inv is None
            else tuple(list_inv[s * ll:(s + 1) * ll].to(d) for s, d in self._shards))
        # f32 corpus refs for the exact rescore of quantized candidates after
        # the merge. keep_single_device_rescore=True keeps the store's
        # buffer; the engine passes False when its distributed exact-scan
        # buffer is float32: snapshots then need attach_sharded_rescore and
        # no device holds a whole float32 corpus copy
        self._quantized = lists.dtype != torch.float32
        if keep_single_device_rescore or not self._quantized:
            self._data, self._inv_norms = ivf._data, ivf._inv_norms
        else:
            self._data = self._inv_norms = None
        # padded HOST copies of the slot tables: deletes remap these with
        # int32 host work and re-upload only the two small tables — the
        # sharded list tensor never moves
        self._ids_host = np.pad(ivf._ids_host, ((0, pad), (0, 0)))
        self._valid_host = np.pad(ivf._valid_host, ((0, pad), (0, 0)))
        lists_dev = tuple(lists[s * ll:(s + 1) * ll].to(d) for s, d in self._shards)
        # one tuple swapped wholesale on delete, so a snapshot taken under
        # the engine lock reads one consistent table version
        self._tables = (lists_dev,) + self._upload_tables()
        ivf._lists = ivf._list_ids = ivf._list_valid = ivf._tables = None

    def _upload_tables(self) -> tuple:
        ll = self._local_lists
        ids = tuple(scan_ops.to_device(self._ids_host[s * ll:(s + 1) * ll], d)
                    for s, d in self._shards)
        valid = tuple(scan_ops.to_device(self._valid_host[s * ll:(s + 1) * ll], d)
                      for s, d in self._shards)
        return ids, valid

    def state_dict(self) -> dict:
        """The wrapped index's layout, kept current: unpadded slot tables,
        count and the probe width (a calibration writes it here)."""
        st = dict(self._state)
        st.update(
            nprobe=self.nprobe,
            nprobe_calibrated=bool(self.nprobe_calibrated),
            count=self.count,
            list_ids=self._ids_host[: self.nlist].copy(),
            list_valid=self._valid_host[: self.nlist].copy(),
        )
        return st

    def refresh_corpus(self, data, inv_norms) -> None:
        """Same contract as IVFIndex.refresh_corpus: rebind the rescore
        corpus to the post-compaction buffer after a delete's id remap."""
        if self._quantized and self._data is not None:
            self._data = data
            self._inv_norms = inv_norms

    def delete_rows(self, rows) -> int:
        """Tombstone + remap with IVFIndex.delete_rows' semantics: the
        remapped id and validity tables are uploaded per shard while the
        centroids and the packed list tensor stay where they are — a delete
        costs O(tables), not a k-means rebuild."""
        ids, valid, n_del = _remap_ids_for_deletes(
            self._ids_host, self._valid_host, rows, self.count
        )
        if n_del:
            self._ids_host, self._valid_host = ids, valid
            self._tables = (self._tables[0],) + self._upload_tables()
            self.count -= n_del
        return n_del

    def tombstone_rows(self, rows) -> int:
        """IVFIndex.tombstone_rows: the slots of ``rows`` go invalid, ids
        and count stay (the engine's delete_rows at compaction remaps
        them). Returns the number of newly-invalid slots."""
        valid, n_del = _tombstone(self._ids_host, self._valid_host, rows, self.count)
        if n_del:
            self._valid_host = valid
            self._tables = (self._tables[0],) + self._upload_tables()
        return n_del

    def snapshot(self) -> "DistIVFSnapshot":
        """Frozen searchable view (captured under the engine lock)."""
        return DistIVFSnapshot(self)

    def search(self, queries, k: int, nprobe: int | None = None,
               fetch: bool = True):
        return self.snapshot().search(queries, k, nprobe, fetch=fetch)


class DistIVFSnapshot:
    __slots__ = ("mesh", "shards", "cent", "cent_live", "tables", "count",
                 "nprobe", "nlist", "pad_len", "local_lists", "n", "list_inv",
                 "data", "inv_norms", "quantized", "rescore_src", "n_dup",
                 "centroids")

    def __init__(self, owner: DistributedIVFIndex):
        self.mesh = owner.mesh
        self.shards = owner._shards
        self.cent = owner._cent
        self.cent_live = owner._cent_live
        self.tables = owner._tables
        self.count = owner.count
        self.nprobe = owner.nprobe
        self.n_dup = owner.n_dup
        self.nlist = owner.nlist
        self.centroids = owner.centroids
        self.pad_len = owner.pad_len
        self.local_lists = owner._local_lists
        self.n = owner.n
        self.list_inv = owner._list_inv
        self.data = owner._data
        self.inv_norms = owner._inv_norms
        self.quantized = owner._quantized
        self.rescore_src = None

    def attach_sharded_rescore(self, dist_snap) -> bool:
        """Bind a parallel.dist_scan.DistSnapshot as the exact-rescore
        corpus: the rescore then runs row-sharded (see search) instead of
        gathering from a single-device copy. Holding the snapshot registers
        it with its DistributedScanIndex, so an update writes copies, never
        the tensors a search in flight reads.

        Returns False (no-op) when the snapshot cannot serve: lists that are
        not quantized, a non-float32 buffer (the rescore must be exact), a
        different mesh, or a buffer that does not cover every candidate row
        id."""
        if (
            not self.quantized
            or dist_snap is None
            or dist_snap.mesh is not self.mesh
            or dist_snap.dtype != torch.float32
            or dist_snap.count < self.count
        ):
            return False
        self.rescore_src = dist_snap
        return True

    def probe_width(self, nprobe: int | None = None) -> int:
        """Lists each shard probes for ``nprobe`` (default: the index's),
        scaled by the skew-split factor so nprobe keeps counting distinct
        trained clusters ("nprobe = nlist is exact", as IVFSnapshot.search)."""
        nprobe = self.nprobe if nprobe is None else nprobe
        distinct = max(1, self.nlist - self.n_dup)
        nprobe = min(-(-nprobe * self.nlist // distinct), self.nlist)
        return min(self.local_lists, -(-nprobe // self.n))

    def shard_probe(self, j: int, qn, p: int):
        """Shard j's top-p live lists (local indices, (B, p)) for each of
        the normalized queries ``qn`` (dead padded lists never win)."""
        cs = qn @ self.cent[j].T
        cs = torch.where(self.cent_live[j], cs, _MASKED_SCORE)
        return scan_ops.topk_last_axis(cs, p)[1]

    def _shard_candidates(self, j, qn, qi, qinv, p: int, k_local: int):
        """One shard's top-k_local (scores, global ids) over its top-p lists."""
        lists, list_ids, list_valid = (t[j] for t in self.tables)
        probe = self.shard_probe(j, qn, p)
        b, pp = probe.shape[0], p * self.pad_len
        if lists.dtype == torch.int8:
            g = int(min(ivf_probe.GROUP_MAX, max(8, b * p)))
            step_list, step_q, pair_step, pair_slot = ivf_probe.group_pairs(
                probe, int(lists.shape[0]), g)
            step_scores = ivf_probe.grouped_scores_q(
                lists, qi.to(torch.int8)[step_q], step_list, list_valid,
                self.list_inv[j], qinv[step_q])
            scores = step_scores[pair_step, pair_slot].reshape(b, pp)
        else:
            scores = ivf_probe.probe_scores(
                lists, qn.to(lists.dtype).contiguous(), probe.to(torch.int32))
        scores = torch.where(list_valid[probe].reshape(b, pp), scores, _MASKED_SCORE)
        vals, pos = scan_ops.topk_last_axis(scores, k_local)
        return vals, torch.gather(list_ids[probe].reshape(b, pp), 1, pos)

    def _sharded_rescore(self, qn, vals, ids, kk: int):
        """Each shard of the attached exact-scan snapshot rescores the merged
        candidates whose global id lies in its row block; every other shard
        gives the sentinel, so an elementwise max over the shards holds the
        exact scores. Then the final top-kk."""
        src = self.rescore_src
        lr = src.local_rows
        first = vals.device
        best = torch.full(vals.shape, _MASKED_SCORE, device=first)
        for j, (s, dev) in enumerate(src.shards):
            row_lo = s * lr
            v, i = vals.to(dev), ids.to(dev).long()
            # candidates this shard owns AND that survived the filter and
            # padding (padded slots carry arbitrary ids: the sentinel wins)
            own = (i >= row_lo) & (i < row_lo + lr) & (v > _MASKED_SCORE / 2)
            loc = (i - row_lo).clamp(0, lr - 1)
            rows = src.bufs[j][loc] * src.inv_norms[j][loc][..., None]
            s_ = torch.bmm(rows, qn.to(dev)[:, :, None]).squeeze(-1)
            best = torch.maximum(best, torch.where(own, s_, _MASKED_SCORE).to(first))
        return _select_topk(best, ids, min(kk, int(best.shape[1])))

    def search(self, queries, k: int, nprobe: int | None = None,
               fetch: bool = True, mask_dev=None, mask_frac: float = 1.0):
        """fetch=False returns tensors on the first device (no transfer), so
        async callers can queue several dispatches.

        mask_dev/mask_frac: IVFSnapshot.search's contract — the merged
        candidates are overfetched by about 1/mask_frac and ineligible rows
        are sentinel-masked before the rescore cut (list ids are GLOBAL row
        ids on every shard, so one mask covers the mesh)."""
        p = self.probe_width(nprobe)
        qs = queries_on(queries, [d for _, d in self.shards])
        first = self.shards[0][1]
        b = int(qs[first].shape[0])
        kk = min(k, self.count)
        if kk <= 0:
            return (np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int32))
        kk_eff = (
            masked_overfetch_width(kk, mask_frac, self.count)
            if mask_dev is not None else kk
        )
        # quantized lists: widen the merged candidate list and rescore it
        # exactly (IVFSnapshot.search's two stages), row-sharded when an
        # exact-scan snapshot is attached
        sharded = self.quantized and self.rescore_src is not None
        rescore = self.quantized and (sharded or self.data is not None)
        if self.quantized and not rescore:
            raise RuntimeError(
                "quantized mesh IVF index holds no rescore corpus: it was "
                "built for sharded rescore (keep_single_device_rescore="
                "False) — attach_sharded_rescore(dist_snapshot) before "
                "searching"
            )
        lists_dtype = self.tables[0][0].dtype
        if rescore:
            kwide = _rescore_kwide(kk_eff, lists_dtype)
        elif mask_dev is not None:
            kwide = kk_eff
        else:
            kwide = kk
        k_local = min(kwide, p * self.pad_len)
        # normalized (and, for int8 lists, quantized) queries, once a device
        qns = {dev: scan_ops._normalize(q) for dev, q in qs.items()}
        qqs = {dev: (ivf_probe.quantize_queries_ivf(qn) if lists_dtype == torch.int8
                     else (None, None)) for dev, qn in qns.items()}
        pairs = [self._shard_candidates(j, qns[dev], *qqs[dev], p, k_local)
                 for j, (_s, dev) in enumerate(self.shards)]
        vals, ids = merge_topk(pairs, kwide, first)
        if mask_dev is not None:
            # sentinel-mask ineligible candidates BEFORE the rescore cut
            vals = _mask_scores(mask_dev, vals, ids)
        if sharded:
            vals, ids = self._sharded_rescore(qns[first], vals, ids, kk)
        elif rescore:
            vals, ids = _exact_rescore(self.data, self.inv_norms, qs[first],
                                       vals, ids, kk)
        elif mask_dev is not None:
            vals, ids = _select_topk(vals, ids, min(kk, int(vals.shape[1])))
        vals, ids = vals[:, :kk], ids[:, :kk].to(torch.int32)
        if not fetch:
            return vals, ids
        return scan_ops.fetch_results(vals, ids)
