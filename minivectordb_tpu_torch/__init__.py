"""minivectordb_tpu_torch — the PyTorch/CUDA port of minivectordb_tpu.

A second package beside the JAX one, ported slice by slice; it imports
``torch`` and ``numpy`` and nothing of the JAX package. This slice holds the
flat ``VectorDatabase``: store vectors, then ``find_most_similar`` /
``find_most_similar_batch`` on one NVIDIA GPU, with the fused phase-1 scan
kernels written in CUDA C++ for Hopper (``csrc/phase1.cu``, compiled at first
use). Modules mirror the JAX package's layout (``ops/scan.py``,
``ops/fused_scan.py`` for ``ops/pallas_scan.py``, ``core/store.py``,
``core/engine.py``, ``vector_database.py``).

    from minivectordb_tpu_torch import VectorDatabase
    db = VectorDatabase("db.pkl")            # on the CUDA card
    db = VectorDatabase("db.pkl", device="cpu")   # on the host, explicitly
"""

__version__ = "0.1.0"

from minivectordb_tpu_torch.vector_database import VectorDatabase

__all__ = ["VectorDatabase", "__version__"]
