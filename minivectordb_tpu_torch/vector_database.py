"""Flat (single-file) vector database — the PyTorch/CUDA VectorDatabase.

Counterpart of ``minivectordb_tpu/vector_database.py`` with the same public
methods, properties and pickle file, plus one keyword: ``device``.

API- and persistence-compatible with the reference ``VectorDatabase``
(reference vector_database.py:7-548): same constructor, same public methods
and attributes, same pickle schema
({embeddings, metadata, id_map, inverse_id_map, inverted_index}) and the same
implicit auto-load on construction. The pickle holds numpy arrays and
builtins only, so a ``db.pkl`` written by this package loads in the JAX
package and the other way round.

What changed underneath, against the reference:
- no FAISS index: searches run as a masked cosine scan + top-k over a
  device-resident packed matrix (core/engine.py, ops/scan.py,
  ops/fused_scan.py); there is nothing to rebuild on mutation, only a dirty
  row range to re-upload.
- inserts are O(1) amortized into a preallocated buffer instead of the
  reference's O(N*d) np.vstack per insert (vector_database.py:72).
- filtered search applies a boolean row mask on device instead of building a
  throwaway index per query (vector_database.py:508-523).
- stored embeddings stay RAW: the reference's ``_build_index`` L2-normalizes
  the stored matrix in place (vector_database.py:45), so after any search its
  ``get_vector``/pickle observe normalized rows; here normalization happens
  inside the scan and stored rows are returned as stored.

``index="ivf"`` puts the coarse-quantized index of ops/ivf.py behind the same
methods; its trained layout travels in the pickle under the extra key
``"ivf"`` (numpy arrays and builtins, the JAX package's schema).

``mesh=`` (``parallel.mesh.search_mesh(...)``) shards the search across
devices, or across logical shards of one device (parallel/).
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict

import numpy as np

from minivectordb_tpu_torch.core import engine as engine_mod
from minivectordb_tpu_torch.core.engine import SearchEngine
from minivectordb_tpu_torch.rerank.hybrid import hybrid_rerank_results as _hybrid_rerank


class VectorDatabase:
    def __init__(
        self,
        storage_file: str = "db.pkl",
        device_dtype: str = "float32",
        search_mode: str = "exact",
        mesh=None,
        index: str = "flat",
        nlist: int = 1024,
        nprobe: int = 32,
        ivf_opts: dict | None = None,
        coalesce_window_ms: float = 0.0,
        *,
        device=None,
    ):
        """device: where the corpus buffer and the scans live. ``None``
        (default) means the CUDA card and raises when there is none — the
        database does not carry on on the CPU; pass ``"cpu"`` to ask for the
        host explicitly (the tests do), or e.g. ``"cuda:1"``.
        device_dtype: 'float32' (exact), 'bfloat16' or 'int8' (quantized
        device buffer, half/quarter the bytes read per scan), or 'mixed'
        (f32 buffer + bf16 scan shadow: phase-1 selection reads the bf16
        copy, the top candidates rescore against the f32 buffer). 'float32'
        stays the DEFAULT deliberately: 'mixed' stores both copies (1.5x the
        device memory), and its exactness is a margin property, not a
        guarantee. search_mode: 'exact' or 'approx' (batches of 16 and more:
        the fused scan with a zero phase-2 margin; smaller batches are
        served exactly).
        mesh: a parallel.mesh.Mesh (``search_mesh(...)``): searches run
        row-partitioned across its shards (flat) or list-partitioned
        (index='ivf'), shard-local top-k then one merge. ``device`` defaults
        to the mesh's first device; one that disagrees raises.
        index: 'flat' (exact scan) or 'ivf' — coarse-quantized ANN, built
        lazily once the corpus passes ivf_opts['build_threshold'] rows
        (incremental inserts overflow to an exact side-buffer until the
        rebuild policy folds them in; the trained layout persists in the
        pickle). nlist/nprobe are the IVF knobs; ivf_opts fine-tunes
        {build_threshold, rebuild_frac, iters, lists_dtype, ...}.
        coalesce_window_ms: > 0 enables serving-side dynamic batching —
        concurrent find_most_similar calls from different threads merge
        into shared device dispatches (each call waits up to the window);
        "auto" self-tunes the window from the measured per-dispatch cost
        and observed concurrency (self-disabling when calls never
        overlap)."""
        self.storage_file = storage_file
        merged_ivf = {"nlist": nlist, "nprobe": nprobe, **(ivf_opts or {})}
        self._engine = SearchEngine(
            device_dtype=device_dtype, search_mode=search_mode, mesh=mesh,
            index=index, ivf_opts=merged_ivf,
            coalesce_window_ms=coalesce_window_ms, device=device,
        )
        self._load_database()

    @property
    def nprobe(self) -> int:
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
    def id_map(self) -> dict:
        """row -> unique id (reference vector_database.py:14)."""
        return {i: uid for i, uid in enumerate(self._engine.observable_uids())}

    @property
    def inverse_id_map(self) -> dict:
        return self._engine.observable_inverse_id_map()

    @property
    def inverted_index(self):
        return self._engine.inverted_index

    @property
    def lock(self):
        return self._engine.lock

    # -- persistence -------------------------------------------------------

    def _load_database(self) -> None:
        if not os.path.exists(self.storage_file):
            return
        with self._engine.lock:
            with open(self.storage_file, "rb") as f:
                data = pickle.load(f)
            embeddings = data["embeddings"]
            id_map = data["id_map"]
            uids = [id_map[i] for i in sorted(id_map.keys())]
            self._engine.load(
                embeddings,
                uids,
                data["metadata"],
                data.get("inverted_index", defaultdict(set)),
            )
            if data.get("ivf") is not None:
                # trained IVF layout travels with the pickle; reattached to
                # the corpus lazily on first search (one device scatter, no
                # k-means re-run)
                self._engine.set_ivf_state(data["ivf"])

    def persist_to_disk(self) -> None:
        """Pickle snapshot, schema-compatible with the reference
        (vector_database.py:538-548)."""
        with self._engine.lock:
            # fold out tombstoned deletes first: the pickle carries the
            # dense compacted schema the reference writes
            self._engine._compact_tombstones()
            data = {
                "embeddings": None
                if self._engine.store is None
                else np.array(self._engine.embeddings_view),
                "metadata": list(self._engine.metadata),
                "id_map": self.id_map,
                "inverse_id_map": dict(self._engine.inverse_id_map),
                "inverted_index": self._engine.inverted_index,
            }
            # extra key; the reference's loader reads only the 5 keys above,
            # so its pickles stay loadable there
            ivf_state = self._engine.ivf_state()
            if ivf_state is not None:
                data["ivf"] = ivf_state
        # atomic replace: the reference pickles in place
        # (vector_database.py:547), so a crash mid-write leaves a torn file
        # that poisons every future auto-load; tmp+rename means any crash
        # leaves either the old snapshot or the new one, never garbage
        tmp = self.storage_file + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(data, f)
        os.replace(tmp, self.storage_file)

    # -- CRUD --------------------------------------------------------------

    def get_vector(self, unique_id) -> np.ndarray:
        with self._engine.lock:
            return self._engine.get_row(unique_id)

    def store_embedding(self, unique_id, embedding, metadata_dict=None) -> None:
        metadata_dict = {} if metadata_dict is None else metadata_dict
        with self._engine.lock:
            self._engine.add_one(unique_id, embedding, metadata_dict)

    def store_embeddings_batch(self, unique_ids, embeddings, metadata_dicts=None):
        metadata_dicts = [] if metadata_dicts is None else metadata_dicts
        with self._engine.lock:
            if 0 < len(metadata_dicts) < len(unique_ids):
                raise ValueError(
                    "Metadata dictionaries must be provided for all unique IDs."
                )
            if len(metadata_dicts) == 0:
                metadata_dicts = [{} for _ in unique_ids]
            self._engine.add_batch(list(unique_ids), embeddings, list(metadata_dicts))

    def delete_embedding(self, unique_id) -> None:
        if unique_id not in self._engine.inverse_id_map:
            raise ValueError("Unique ID does not exist.")
        with self._engine.lock:
            # re-check under the lock (the reference's pre-lock check is a
            # benign-by-luck race, SURVEY.md §5)
            if unique_id not in self._engine.inverse_id_map:
                raise ValueError("Unique ID does not exist.")
            self._engine.delete_many([unique_id])

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
        """Top-k cosine search with mongo-like filtering.

        Returns (ids, distances, metadatas); "distances" are cosine
        similarities (higher is better), as in the reference FAISS-IP path
        (vector_database.py:466-536).

        ``nprobe`` (index='ivf' only): per-call override of the configured
        probe width — the IVF recall/latency knob.
        """
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
        """Batched search (no reference equivalent — the reference is
        strictly one query per call). Returns a list of (ids, distances,
        metadatas) triples, one per query; filters apply to every query.

        ``metadata_filters``: optional list with ONE filter per query
        (mutually exclusive with the shared ``metadata_filter``/
        ``exclude_filter``/``or_filters``); queries sharing a filter are
        grouped into one device dispatch, distinct filters pipeline."""
        if metadata_filters is not None:
            if metadata_filter or exclude_filter or or_filters:
                raise ValueError(
                    "metadata_filters (per-query) is mutually exclusive "
                    "with the shared filter arguments"
                )
            return self._engine.search_batch_multi(
                embeddings, metadata_filters, k=k, nprobe=nprobe,
            )
        return self._engine.search_batch(
            embeddings,
            metadata_filter=metadata_filter,
            exclude_filter=exclude_filter,
            or_filters=or_filters,
            k=k,
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
        """Pipelined batched search: returns a handle immediately; call
        ``.result()`` for the list of (ids, distances, metadatas) triples.
        Several in-flight handles overlap their device dispatches and
        result transfers — on serving paths this recovers the raw kernel
        throughput that per-call synchronous drains forfeit. Results are
        snapshot-consistent as of dispatch time."""
        return self._engine.search_batch_async(
            embeddings,
            metadata_filter=metadata_filter,
            exclude_filter=exclude_filter,
            or_filters=or_filters,
            k=k,
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
        """Pay the cold-start costs now instead of on the first query:
        device corpus upload, IVF build (if configured and due), the kernel
        build, one search of the (batch, k) shape. Optional; idempotent."""
        self._engine.warmup(k=k, batch=batch)

    def set_coalesce_window(self, ms: float) -> None:
        """Runtime knob for serving-side dynamic batching (see the
        constructor's coalesce_window_ms; 0 disables)."""
        self._engine.set_coalesce_window(ms)

    def calibrate_nprobe(self, recall_target: float = 0.95, queries=None,
                         k: int = 10, sample: int = 64,
                         seed: int = 0) -> dict:
        """Measure IVF recall@k against this database's own exact scan and
        install the smallest nprobe meeting ``recall_target`` as the default
        (index='ivf' only). Pass a real query workload via ``queries`` for
        the most faithful figure (``seed`` varies the default corpus-row
        sampling); ``ivf_opts={"recall_target": ...}`` runs this
        automatically after every build. The calibrated value persists with
        the pickled layout. Returns {"nprobe", "recall", "evaluated"}."""
        return self._engine.calibrate_nprobe(
            recall_target, queries=queries, k=k, sample=sample, seed=seed
        )

    def stats(self) -> dict:
        """Operation counters/latencies (observability — no reference
        equivalent, SURVEY.md §5). ``routing`` reports the adaptive
        host/device scan router's state (EMA seconds per path; None =
        unprimed), the device filter-mask cache occupancy and the device
        the corpus buffer lives on."""
        eng = self._engine
        out = {
            "count": eng.live_count,
            "tombstoned_rows": eng.count - eng.live_count,
            "embedding_size": eng.embedding_size,
            "device_dtype": eng.device_dtype,
            "search_mode": eng.search_mode,
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
