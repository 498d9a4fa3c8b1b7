"""Shard-file persistence (write-through pickle shards).

Counterpart of ``minivectordb_tpu/core/sharding.py``, copied: the same pickle
schema, file names, atomic writes, load order and placement, so a shard
directory written by either package loads in the other.

Storage semantics preserved from the reference ShardedVectorDatabase
(reference sharded_vector_database.py:41-241): fixed-capacity
``shard_<N>.pkl`` files holding
{embeddings, metadata, unique_ids, inverted_index}, write-through on every
mutation, placement into the first shard with free space, numeric-id sorted
load order, and box maps (shard -> uids, uid -> shard).

This module only manages the files and the box maps; the global in-RAM state
and all search live in core/engine.py — shards are a *persistence* unit,
never a search partition.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict

import numpy as np


def _atomic_pickle(path: str, data: dict) -> None:
    """tmp + rename: the reference rewrites shard pickles in place
    (sharded_vector_database.py:141-142), so a crash mid-write tears the
    file and loses the WHOLE shard's rows on the next load. The temp name
    ends in .tmp, not .pkl — the reference's loader int()-parses every .pkl
    filename in the directory."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(data, f)
    os.replace(tmp, path)


def _shard_path(storage_dir: str, shard_id: int) -> str:
    return os.path.join(storage_dir, f"shard_{shard_id}.pkl")


def _empty_shard(dim: int) -> dict:
    return {
        "embeddings": np.zeros((0, dim), dtype=np.float32),
        "metadata": [],
        "unique_ids": [],
        "inverted_index": defaultdict(set),
    }


class ShardRegistry:
    """Box maps + read-modify-write shard files."""

    def __init__(self, storage_dir: str, shard_size: int):
        self.storage_dir = storage_dir
        self.shard_size = shard_size
        self.box_item_map: dict[int, list] = {}
        self.inverse_box_item_map: dict = {}
        os.makedirs(storage_dir, exist_ok=True)

    # -- load --------------------------------------------------------------

    def shard_files_sorted(self) -> list[str]:
        files = [f for f in os.listdir(self.storage_dir) if f.endswith(".pkl")]
        files.sort(key=lambda x: int(x.split("_")[1].split(".")[0]))
        return files

    def read_shard_file(self, shard_file: str) -> dict:
        with open(os.path.join(self.storage_dir, shard_file), "rb") as f:
            return pickle.load(f)

    def register_loaded(self, shard_file: str, unique_ids: list) -> None:
        shard_id = int(os.path.basename(shard_file).split("_")[1].split(".")[0])
        self.box_item_map[shard_id] = list(unique_ids)
        for uid in unique_ids:
            self.inverse_box_item_map[uid] = shard_id

    # -- placement (reference sharded_vector_database.py:98-102) -----------

    def available_shard_id(self) -> int:
        for shard_id, items in self.box_item_map.items():
            if len(items) < self.shard_size:
                return shard_id
        return len(self.box_item_map)

    def place(self, uid) -> int:
        shard_id = self.available_shard_id()
        self.box_item_map.setdefault(shard_id, []).append(uid)
        self.inverse_box_item_map[uid] = shard_id
        return shard_id

    # -- write-through -----------------------------------------------------

    def _read_or_init(self, shard_id: int, dim: int) -> dict:
        path = _shard_path(self.storage_dir, shard_id)
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = pickle.load(f)
            data["inverted_index"] = defaultdict(set, data["inverted_index"])
            return data
        return _empty_shard(dim)

    def _write(self, shard_id: int, data: dict) -> None:
        to_save = data.copy()
        to_save["inverted_index"] = dict(data["inverted_index"])
        _atomic_pickle(_shard_path(self.storage_dir, shard_id), to_save)

    def append_to_shard(
        self, shard_id: int, unique_ids, embeddings: np.ndarray, metadata_dicts, dim: int
    ) -> None:
        data = self._read_or_init(shard_id, dim)
        data["embeddings"] = np.vstack(
            [data["embeddings"], np.asarray(embeddings, dtype=np.float32)]
        )
        data["metadata"].extend(metadata_dicts)
        data["unique_ids"].extend(unique_ids)
        for uid, md in zip(unique_ids, metadata_dicts):
            for key in md:
                data["inverted_index"][key].add(uid)
        self._write(shard_id, data)

    def remove_from_shard(self, shard_id: int, unique_ids) -> None:
        """Rewrite one shard without the given uids
        (reference sharded_vector_database.py:180-204)."""
        path = _shard_path(self.storage_dir, shard_id)
        with open(path, "rb") as f:
            data = pickle.load(f)
        doomed = set(unique_ids)
        keep = [i for i, uid in enumerate(data["unique_ids"]) if uid not in doomed]
        data["embeddings"] = data["embeddings"][keep]
        data["metadata"] = [data["metadata"][i] for i in keep]
        data["unique_ids"] = [data["unique_ids"][i] for i in keep]
        for uid in doomed:
            for key, ids in list(data["inverted_index"].items()):
                if uid in ids:
                    ids.discard(uid)
                    if not ids:
                        del data["inverted_index"][key]
        _atomic_pickle(path, data)
        self.box_item_map[shard_id] = data["unique_ids"]
        for uid in doomed:
            self.inverse_box_item_map.pop(uid, None)

    def read_vector(self, uid) -> np.ndarray:
        """Disk read of one vector (reference get_vector reads the shard
        file, sharded_vector_database.py:86-96 — but indexes it with the
        GLOBAL row number, a latent multi-shard bug; here the uid is located
        within its own shard)."""
        shard_id = self.inverse_box_item_map[uid]
        with open(_shard_path(self.storage_dir, shard_id), "rb") as f:
            data = pickle.load(f)
        idx = data["unique_ids"].index(uid)
        return data["embeddings"][idx]
