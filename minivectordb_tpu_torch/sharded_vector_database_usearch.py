"""ShardedVectorDatabaseUsearch — int8-quantized sharded database.

Counterpart of ``minivectordb_tpu/sharded_vector_database_usearch.py``, plus
one keyword: ``device``.

API- and storage-compatible with the reference ShardedVectorDatabaseUsearch
(reference sharded_vector_database_usearch.py:9-650): same write-through
shard persistence as ShardedVectorDatabase, but the search path matches the
usearch ``Index(ndim, metric='cos', dtype='i8')`` behavior
(sharded_vector_database_usearch.py:621-627):

- results are cosine DISTANCES (lower is better), so ``autocut`` uses
  ``autocut_distances`` (relative increases,
  sharded_vector_database_usearch.py:573-594);
- scoring runs over an int8 symmetric-quantized corpus (quarter the HBM
  bandwidth of float32).

Where the reference builds a fresh int8 usearch index for EVERY
query over the filtered candidate matrix
(sharded_vector_database_usearch.py:616-637), the int8 device buffer here is
persistent and incrementally maintained; a query is one masked int8 scan +
top-k (ops/scan.py:scan_topk_int8, or the int8 phase-1 kernel K2 of
csrc/phase1.cu through ops/fused_scan.py for batches of 16 and more).
"""

from __future__ import annotations

from minivectordb_tpu_torch.core import engine as engine_mod
from minivectordb_tpu_torch.sharded_vector_database import ShardedVectorDatabase

_BANNER = """
    Warning: You are using the `usearch`-equivalent version of minivectordb_tpu_torch.
    This version is focused on being lightweight: it scans an int8-quantized copy of the embeddings.
    Results are cosine distances (lower is better); the int8 device buffer is maintained incrementally.
"""


class ShardedVectorDatabaseUsearch(ShardedVectorDatabase):
    _device_dtype = "int8"
    _default_storage_dir = "db_shards_usearch"

    def __init__(
        self,
        storage_dir: str | None = None,
        shard_size: int = 5000,
        durability: str = "shard",
        search_mode: str = "exact",
        mesh=None,
        *,
        device=None,
    ):
        """Constructor parity with ShardedVectorDatabase: the WAL ingest
        modes compose with the int8 engine; ``device`` as there."""
        print(_BANNER)
        super().__init__(
            storage_dir=storage_dir,
            shard_size=shard_size,
            durability=durability,
            search_mode=search_mode,
            mesh=mesh,
            device=device,
        )

    def find_most_similar(
        self,
        embedding,
        metadata_filter=None,
        exclude_filter=None,
        or_filters=None,
        k: int = 5,
        autocut: bool = False,
    ):
        ids, distances, metadatas = self._engine.search(
            embedding,
            metadata_filter=metadata_filter,
            exclude_filter=exclude_filter,
            or_filters=or_filters,
            k=k,
            return_distances=True,
        )
        if autocut and len(distances) > 1:
            remove = self.autocut_distances(distances)
            ids, distances, metadatas = engine_mod.apply_autocut(
                remove, ids, distances, metadatas
            )
        return ids, distances, metadatas

    def autocut_distances(self, distance_list):
        return engine_mod.autocut_distances(distance_list)
