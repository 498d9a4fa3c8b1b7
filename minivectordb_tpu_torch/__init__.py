"""minivectordb_tpu_torch — the PyTorch/CUDA port of minivectordb_tpu.

A second package beside the JAX one, ported slice by slice; it imports
``torch`` and ``numpy`` and nothing of the JAX package. It holds
``VectorDatabase`` (flat and ``index="ivf"``: store vectors, then
``find_most_similar`` / ``find_most_similar_batch`` on one NVIDIA GPU),
``ShardedVectorDatabase`` and ``ShardedVectorDatabaseUsearch`` (the same
search over write-through ``shard_<N>.pkl`` files, with an optional
write-ahead log) and ``EmbeddingModel`` (text -> embedding, with
``core/pipeline.py``'s ``TextSearchPipeline`` for text -> search), with the
kernels written in CUDA C++ for Hopper (``csrc/phase1.cu``,
``csrc/ivf_probe.cu``, ``csrc/flash_attention.cu``, compiled at first use).
Modules mirror the JAX package's layout (``ops/scan.py``,
``ops/fused_scan.py`` for ``ops/pallas_scan.py``, ``core/store.py``,
``core/engine.py``, ``vector_database.py``, ``sharded_vector_database.py``,
``models/``, ``embedding_model.py``). ``parallel/`` maps search onto a
device mesh (``mesh=``): shard-local top-k over a row-partitioned corpus
(or list-partitioned IVF lists) and a merge, and pod search across
processes over ``torch.distributed``.

    from minivectordb_tpu_torch import EmbeddingModel, ShardedVectorDatabase, VectorDatabase
    db = VectorDatabase("db.pkl")            # on the CUDA card
    db = VectorDatabase("db.pkl", device="cpu")   # on the host, explicitly
    sdb = ShardedVectorDatabase("db_shards", device="cpu")
    model = EmbeddingModel(device="cpu")
"""

__version__ = "0.1.0"

from minivectordb_tpu_torch.vector_database import VectorDatabase
from minivectordb_tpu_torch.sharded_vector_database import ShardedVectorDatabase
from minivectordb_tpu_torch.sharded_vector_database_usearch import ShardedVectorDatabaseUsearch
from minivectordb_tpu_torch.embedding_model import EmbeddingModel, AlternativeModel

__all__ = [
    "VectorDatabase",
    "ShardedVectorDatabase",
    "ShardedVectorDatabaseUsearch",
    "EmbeddingModel",
    "AlternativeModel",
    "__version__",
]
