"""ShardedVectorDatabase — the PyTorch/CUDA sharded database.

Counterpart of ``minivectordb_tpu/sharded_vector_database.py`` with the same
public methods, properties and files, plus one keyword: ``device``.

API- and storage-compatible with the reference ShardedVectorDatabase
(reference sharded_vector_database.py:8-662): same constructor
(storage_dir, shard_size), same public attributes (embeddings, metadata,
unique_ids, inverse_id_map, inverted_index, box_item_map,
inverse_box_item_map), same write-through ``shard_<N>.pkl`` persistence with
identical pickle schema (so shard directories written by the reference, by
the JAX package or by this one load in the others), batch-only delete, and
the flat-db migration helper. ``wal.log`` and ``ivf_layout.bin`` share the
JAX package's formats too.

Shards are purely a *persistence* unit. Search runs over the packed global
device matrix through the same engine as the flat class (core/engine.py:
the phase-1 kernels of csrc/phase1.cu, or the IVF probe kernels of
csrc/ivf_probe.cu with ``index="ivf"``); the reference also searches
globally — its shards are never searched independently (SURVEY.md §2c).

``mesh=`` maps the search onto a device mesh (parallel/): shard-local top-k
over a row-partitioned corpus and one merge; the shard files stay a
persistence unit.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from minivectordb_tpu_torch.core import engine as engine_mod
from minivectordb_tpu_torch.core import wal as wal_mod
from minivectordb_tpu_torch.core.engine import SearchEngine
from minivectordb_tpu_torch.core.sharding import ShardRegistry
from minivectordb_tpu_torch.rerank.hybrid import hybrid_rerank_results as _hybrid_rerank


class ShardedVectorDatabase:
    _device_dtype = "float32"
    _default_storage_dir = "db_shards"

    def __init__(
        self,
        storage_dir: str | None = None,
        shard_size: int = 5000,
        durability: str = "shard",
        search_mode: str = "exact",
        mesh=None,
        index: str = "flat",
        ivf_opts: dict | None = None,
        coalesce_window_ms: float = 0.0,
        *,
        device=None,
    ):
        """device: where the corpus buffer and the scans live. ``None``
        (default) means the CUDA card and raises when there is none; pass
        ``"cpu"`` to ask for the host explicitly (the tests do).
        durability:
        - 'shard' (default): reference-compatible — every mutation rewrites
          its whole shard pickle synchronously
          (reference sharded_vector_database.py:134-154).
        - 'wal': same process-crash durability contract at O(record) cost —
          mutations append to a CRC-framed write-ahead log and fold into
          shard files on compact()/reload (core/wal.py).
        - 'wal_fsync': 'wal' plus an fsync per record — survives power loss,
          not just process crashes.
        """
        if durability not in ("shard", "wal", "wal_fsync"):
            raise ValueError(f"Unknown durability mode: {durability}")
        self.storage_dir = storage_dir or self._default_storage_dir
        self.shard_size = shard_size
        self.durability = durability
        self._use_wal = durability.startswith("wal")
        self._wal_fsync = durability == "wal_fsync"
        self._engine = SearchEngine(
            device_dtype=self._device_dtype, search_mode=search_mode, mesh=mesh,
            index=index, ivf_opts=ivf_opts,
            coalesce_window_ms=coalesce_window_ms, device=device,
            # write-through shards have no single pickle to carry the
            # trained IVF layout (the flat class embeds it in db.pkl), so it
            # persists in a sidecar. NOT named *.pkl: the reference's loader
            # int()-parses every .pkl filename in the dir
            # (reference sharded_vector_database.py:45-46)
            ivf_sidecar=os.path.join(self.storage_dir, "ivf_layout.bin"),
        )
        self._shards = ShardRegistry(self.storage_dir, shard_size)
        self._wal_path = os.path.join(self.storage_dir, "wal.log")
        self._load_database()

    @property
    def nprobe(self) -> int:
        """Default IVF probe width (index='ivf'); same knob as
        VectorDatabase.nprobe."""
        return self._engine.ivf_opts["nprobe"]

    @nprobe.setter
    def nprobe(self, value: int) -> None:
        self._engine.ivf_opts["nprobe"] = int(value)

    # -- reference-compatible attributes -----------------------------------

    @property
    def embedding_size(self):
        return self._engine.embedding_size

    @property
    def embeddings(self):
        return self._engine.embeddings_view

    @property
    def metadata(self):
        return self._engine.observable_metadata()

    @property
    def unique_ids(self) -> list:
        return self._engine.observable_uids()

    @property
    def inverse_id_map(self) -> dict:
        return self._engine.observable_inverse_id_map()

    @property
    def inverted_index(self):
        return self._engine.inverted_index

    @property
    def box_item_map(self) -> dict:
        return self._shards.box_item_map

    @property
    def inverse_box_item_map(self) -> dict:
        return self._shards.inverse_box_item_map

    @property
    def lock(self):
        return self._engine.lock

    # -- load / migration --------------------------------------------------

    def _load_database(self) -> None:
        all_embeddings, uids, metadatas = [], [], []
        # read the persisted IVF layout BEFORE engine.load: load() resets
        # the engine, and reset drops the sidecar file (a reset corpus
        # invalidates any on-disk layout)
        ivf_state = None
        sc = self._engine.ivf_sidecar
        if sc and os.path.exists(sc):
            try:
                with open(sc, "rb") as f:
                    ivf_state = pickle.load(f)
            except Exception:
                ivf_state = None  # corrupt sidecar: retrain on next search
        with self._engine.lock:
            for shard_file in self._shards.shard_files_sorted():
                data = self._shards.read_shard_file(shard_file)
                if len(data["unique_ids"]):
                    all_embeddings.append(
                        np.asarray(data["embeddings"], dtype=np.float32)
                    )
                metadatas.extend(data["metadata"])
                uids.extend(data["unique_ids"])
                self._shards.register_loaded(shard_file, data["unique_ids"])
            if uids:
                matrix = np.vstack(all_embeddings)
                self._engine.load(matrix, uids, metadatas)
            if ivf_state is not None:
                # adopt even when the shard files are empty — a WAL-only
                # corpus re-adds its rows during replay in the same order
                # the layout was trained against (the attach-time uid digest
                # check is the safety net either way). Reattached lazily on
                # first search (no k-means re-run); WAL-replayed deletes
                # below remap the pending state.
                self._engine.set_ivf_state(ivf_state)
                # load()'s reset dropped the sidecar file; rewrite it NOW so
                # an open that never searches (ingest-only sessions, early
                # crashes) cannot lose the trained layout
                self._engine._persist_ivf_sidecar()
            self._replay_wal()

    def _replay_wal(self) -> None:
        """Fold pending WAL records (from a prior 'wal'-mode session) into
        RAM state, then compact them into the shard files."""
        ops = wal_mod.read_records(self._wal_path)
        if not ops:
            return
        for op in ops:
            kind = op[0]
            if kind == "add":
                _, uid, embedding, metadata = op
                if uid in self._engine.inverse_id_map:
                    continue  # record already compacted
                self._engine.add_one(uid, embedding, metadata)
                self._shards.place(uid)
            elif kind == "del":
                _, del_uids = op
                live = [u for u in del_uids if u in self._engine.inverse_id_map]
                if live:
                    self._engine.delete_many(live)
                    self._unplace(live)
        # fold replayed tombstoned deletes out before the device ever syncs
        # (host-only compaction at load time — the buffer doesn't exist yet)
        self._engine.compact_tombstones()
        self.compact()

    def _unplace(self, uids) -> None:
        for uid in uids:
            shard_id = self._shards.inverse_box_item_map.pop(uid, None)
            if shard_id is not None:
                try:
                    self._shards.box_item_map[shard_id].remove(uid)
                except (KeyError, ValueError):
                    pass

    def compact(self) -> None:
        """Rewrite every registered shard file from the in-RAM state and
        truncate the WAL. No-op cost in 'shard' mode (files are already
        up to date) but safe to call in either mode."""
        with self._engine.lock:
            if self._engine.embedding_size is None:
                wal_mod.truncate(self._wal_path)
                return
            # PHYSICAL structures: inverse_id_map values are physical rows,
            # so gather from the physical store view (embeddings_view is the
            # logical live-rows matrix while tombstoned deletes are pending)
            inv = self._engine.inverse_id_map
            view = self._engine.store.view()
            metadata = self._engine.metadata

            for shard_id, shard_uids in self._shards.box_item_map.items():
                rows = [inv[u] for u in shard_uids]
                inverted = {}
                for u in shard_uids:
                    for key in metadata[inv[u]]:
                        inverted.setdefault(key, set()).add(u)
                data = {
                    "embeddings": np.asarray(
                        view[rows] if rows else
                        np.zeros((0, self._engine.embedding_size), np.float32),
                        dtype=np.float32,
                    ),
                    "metadata": [metadata[r] for r in rows],
                    "unique_ids": list(shard_uids),
                    "inverted_index": inverted,
                }
                path = os.path.join(self.storage_dir, f"shard_{shard_id}.pkl")
                with open(path, "wb") as f:
                    pickle.dump(data, f)
            wal_mod.truncate(self._wal_path)

    def _convert_from_non_sharded_db(self, non_sharded_db_object) -> None:
        """Migrate a flat VectorDatabase into this sharded one
        (reference sharded_vector_database.py:26-33)."""
        embeddings = non_sharded_db_object.embeddings
        metadata = non_sharded_db_object.metadata
        id_map = non_sharded_db_object.id_map
        unique_ids = [id_map[i] for i in range(len(embeddings))]
        self.store_embeddings_batch(unique_ids, embeddings, list(metadata))
        del non_sharded_db_object

    # -- CRUD (write-through) ----------------------------------------------

    def get_vector(self, unique_id) -> np.ndarray:
        with self._engine.lock:
            if unique_id not in self._engine.inverse_id_map:
                raise ValueError("Unique ID does not exist.")
            if self._use_wal:
                # shard files may lag the WAL; RAM is authoritative
                return self._engine.get_row(unique_id)
            return self._shards.read_vector(unique_id)

    def store_embedding(self, unique_id, embedding, metadata_dict=None) -> None:
        metadata_dict = {} if metadata_dict is None else metadata_dict
        with self._engine.lock:
            self._engine.add_one(unique_id, embedding, metadata_dict)
            shard_id = self._shards.place(unique_id)
            if self._use_wal:
                wal_mod.append_record(
                    self._wal_path,
                    ("add", unique_id,
                     np.asarray(embedding, dtype=np.float32), metadata_dict),
                    fsync=self._wal_fsync,
                )
            else:
                self._shards.append_to_shard(
                    shard_id,
                    [unique_id],
                    np.asarray(embedding, dtype=np.float32)[None, :],
                    [metadata_dict],
                    self._engine.embedding_size,
                )

    def store_embeddings_batch(self, unique_ids: list, embeddings, metadata_dicts=None):
        metadata_dicts = [] if metadata_dicts is None else metadata_dicts
        with self._engine.lock:
            if len(unique_ids) != len(embeddings):
                raise ValueError(
                    "Number of unique IDs must match number of embeddings."
                )
            if len(metadata_dicts) < len(unique_ids):
                metadata_dicts = list(metadata_dicts) + [
                    {} for _ in range(len(unique_ids) - len(metadata_dicts))
                ]
            self._engine.add_batch(list(unique_ids), embeddings, list(metadata_dicts))
            # group consecutive placements by shard, then one write per shard
            groups: dict[int, list[int]] = {}
            for i, uid in enumerate(unique_ids):
                shard_id = self._shards.place(uid)
                groups.setdefault(shard_id, []).append(i)
            if self._use_wal:
                for i, uid in enumerate(unique_ids):
                    wal_mod.append_record(
                        self._wal_path,
                        ("add", uid,
                         np.asarray(embeddings[i], dtype=np.float32),
                         metadata_dicts[i]),
                        fsync=self._wal_fsync,
                    )
                return
            for shard_id, idxs in groups.items():
                self._shards.append_to_shard(
                    shard_id,
                    [unique_ids[i] for i in idxs],
                    np.asarray(
                        [np.asarray(embeddings[i], dtype=np.float32) for i in idxs]
                    ),
                    [metadata_dicts[i] for i in idxs],
                    self._engine.embedding_size,
                )

    def delete_embeddings_batch(self, unique_ids) -> None:
        with self._engine.lock:
            if not isinstance(unique_ids, list):
                unique_ids = [unique_ids]
            if not unique_ids:
                raise ValueError("No unique IDs provided.")
            if not all(uid in self._engine.inverse_id_map for uid in unique_ids):
                raise ValueError("One or more unique IDs do not exist.")
            unique_ids = [uid for uid in unique_ids if uid is not None]
            if self._use_wal:
                wal_mod.append_record(self._wal_path, ("del", list(unique_ids)),
                                      fsync=self._wal_fsync)
                self._unplace(unique_ids)
                self._engine.delete_many(unique_ids)
                return
            shard_groups: dict[int, list] = {}
            for uid in unique_ids:
                shard_groups.setdefault(
                    self._shards.inverse_box_item_map[uid], []
                ).append(uid)
            for shard_id, shard_uids in shard_groups.items():
                self._shards.remove_from_shard(shard_id, shard_uids)
            self._engine.delete_many(unique_ids)

    # -- search ------------------------------------------------------------

    def find_most_similar(
        self,
        embedding,
        metadata_filter=None,
        exclude_filter=None,
        or_filters=None,
        k: int = 5,
        autocut: bool = False,
        nprobe: int | None = None,
    ):
        ids, distances, metadatas = self._engine.search(
            embedding,
            metadata_filter=metadata_filter,
            exclude_filter=exclude_filter,
            or_filters=or_filters,
            k=k,
            nprobe=nprobe,
        )
        if autocut and len(distances) > 1:
            remove = self.autocut_scores(distances)
            ids, distances, metadatas = engine_mod.apply_autocut(
                remove, ids, distances, metadatas
            )
        return ids, distances, metadatas

    def find_most_similar_batch(
        self,
        embeddings,
        metadata_filter=None,
        exclude_filter=None,
        or_filters=None,
        k: int = 5,
        nprobe: int | None = None,
        metadata_filters=None,
    ):
        """Batched search: one device program over all queries (no reference
        equivalent). ``metadata_filters``: optional per-query filter list —
        see VectorDatabase.find_most_similar_batch."""
        if metadata_filters is not None:
            if metadata_filter or exclude_filter or or_filters:
                raise ValueError(
                    "metadata_filters (per-query) is mutually exclusive "
                    "with the shared filter arguments"
                )
            return self._engine.search_batch_multi(
                embeddings, metadata_filters, k=k, nprobe=nprobe,
                return_distances=self._device_dtype == "int8",
            )
        return self._engine.search_batch(
            embeddings,
            metadata_filter=metadata_filter,
            exclude_filter=exclude_filter,
            or_filters=or_filters,
            k=k,
            return_distances=self._device_dtype == "int8",
            nprobe=nprobe,
        )

    def find_most_similar_batch_async(
        self,
        embeddings,
        metadata_filter=None,
        exclude_filter=None,
        or_filters=None,
        k: int = 5,
        nprobe: int | None = None,
    ):
        """Pipelined batched search (see VectorDatabase
        .find_most_similar_batch_async): returns a PendingSearch handle;
        in-flight handles overlap device dispatch + result transfer."""
        return self._engine.search_batch_async(
            embeddings,
            metadata_filter=metadata_filter,
            exclude_filter=exclude_filter,
            or_filters=or_filters,
            k=k,
            return_distances=self._device_dtype == "int8",
            nprobe=nprobe,
        )

    # -- rerank / autocut --------------------------------------------------

    def hybrid_rerank_results(self, sentences, search_scores, query, k=5,
                              weights=(0.80, 0.15, 0.05), device=None):
        """device=True runs the batched rerank on this database's device,
        False the host path; None routes by candidate count
        (rerank/hybrid.py)."""
        return _hybrid_rerank(sentences, search_scores, query, k=k,
                              weights=weights, device=device,
                              torch_device=self._engine.device)

    def autocut_scores(self, score_list):
        return engine_mod.autocut_scores(score_list)

    def warmup(self, k: int = 10, batch: int = 1) -> None:
        """See VectorDatabase.warmup."""
        self._engine.warmup(k=k, batch=batch)

    def set_coalesce_window(self, ms: float) -> None:
        """See VectorDatabase.set_coalesce_window."""
        self._engine.set_coalesce_window(ms)

    def calibrate_nprobe(self, recall_target: float = 0.95, queries=None,
                         k: int = 10, sample: int = 64,
                         seed: int = 0) -> dict:
        """See VectorDatabase.calibrate_nprobe (index='ivf' only)."""
        return self._engine.calibrate_nprobe(
            recall_target, queries=queries, k=k, sample=sample, seed=seed
        )

    def stats(self) -> dict:
        """Operation counters/latencies (observability — no reference
        equivalent, SURVEY.md §5). See VectorDatabase.stats for ``routing``."""
        eng = self._engine
        out = {
            "count": eng.live_count,
            "tombstoned_rows": eng.count - eng.live_count,
            "embedding_size": eng.embedding_size,
            "device_dtype": eng.device_dtype,
            "search_mode": eng.search_mode,
            "shards": len(self._shards.box_item_map),
            "ops": eng.telemetry.snapshot(),
        }
        routing = eng.routing_stats()
        if routing is not None:
            out["routing"] = routing
        coal = eng.coalesce_stats()
        if coal is not None:
            out["coalescing"] = coal
        ivf = eng.ivf_stats()
        if ivf is not None:
            out["ivf"] = ivf
        return out
