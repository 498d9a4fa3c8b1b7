"""Multi-host pod search: process-local corpus shards, global searches.

Counterpart of ``minivectordb_tpu/parallel/multihost.py``. Every host process
calls ``init_pod`` (``torch.distributed``), contributes its LOCAL row block
to a corpus sharded over a (dcn, ici) pod mesh — the rows of one process
never leave it — and then every process runs the same search: each host
merges its shards' lists, the host lists travel by one all-gather, and every
process returns the same (scores, global row ids).

CPU coverage with two real processes over gloo: tests/test_torch_multihost.py.
"""

from __future__ import annotations

import numpy as np

from minivectordb_tpu_torch.parallel.dist_scan import DistributedScanIndex
from minivectordb_tpu_torch.parallel.mesh import (  # re-export
    DCN_AXIS,
    ICI_AXIS,
    init_pod,
    pod_mesh,
)

__all__ = ["init_pod", "pod_mesh", "PodScanIndex"]


class PodScanIndex:
    """Row-partitioned exact-search corpus over a (dcn, ici) pod mesh.

    SPMD usage — every process makes the same calls:

        init_pod("host0:1234", num_processes=H, process_id=h)
        mesh = pod_mesh()
        idx = PodScanIndex(mesh, dim)
        idx.load_local(my_rows, row_offset, global_count)
        vals, gids = idx.search(queries, k)   # same result on every host
    """

    def __init__(self, mesh, dim: int):
        if tuple(mesh.axis_names) != (DCN_AXIS, ICI_AXIS):
            raise ValueError("PodScanIndex needs a (dcn, ici) pod mesh")
        self.mesh = mesh
        self.dim = int(dim)
        self.n = int(mesh.devices.size)
        self._index = DistributedScanIndex(mesh, dim)

    @property
    def count(self) -> int:
        return self._index.count

    @property
    def capacity(self) -> int:
        return self._index.capacity

    def load_local(self, local_rows: np.ndarray, row_offset: int,
                   global_count: int) -> None:
        """Contribute this process's contiguous row block.

        ``local_rows`` are the rows [row_offset, row_offset + len) of the
        global corpus. The capacity (a power of two >= 1024, rounded to a
        multiple of the mesh size) is split into equal blocks, one a process
        in process order: on a mesh over ``torch.distributed`` process h
        holds hosts row h, capacity / n_hosts rows; a process that holds the
        whole mesh (one process emulating the pod) holds them all.
        ``row_offset`` must equal the start of this process's block — it is
        validated, not used for placement: a wrong offset would land rows
        under another host's ids. The block must also be EXACTLY the dense
        share implied by global_count (full below the boundary,
        global_count - offset on the boundary host, empty above): a short
        block would leave zero rows below global_count unmasked, and their
        0.0 scores would beat genuinely negative matches into the top-k as
        phantom ids."""
        local_rows = np.ascontiguousarray(local_rows, dtype=np.float32)
        n_hosts = self.mesh.devices.shape[0]
        cap = 1024
        while cap < global_count:
            cap <<= 1
        cap += (-cap) % self.n
        if self.mesh.distributed:
            pidx, per_process = self.mesh.process_index, cap // n_hosts
        else:
            pidx, per_process = 0, cap
        expected_offset = pidx * per_process
        if row_offset != expected_offset:
            raise ValueError(
                f"row_offset {row_offset} must be process_index * per_host "
                f"= {expected_offset} for process {pidx} "
                f"(blocks are placed by process order)"
            )
        expected_rows = min(max(global_count - row_offset, 0), per_process)
        if local_rows.shape[0] != expected_rows:
            raise ValueError(
                f"local block must hold exactly the dense share "
                f"[{row_offset}, {row_offset + expected_rows}) of the "
                f"global corpus ({expected_rows} rows for "
                f"global_count={global_count}); got {local_rows.shape[0]}"
            )
        self._index.load_rows(local_rows, row_offset, cap, global_count)

    def search(self, queries, k: int):
        """Global exact top-k; the same (scores, global row ids) on every
        participating process."""
        return self._index.search(queries, k)
