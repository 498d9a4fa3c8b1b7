"""Device meshes for sharded search and for training.

Counterpart of ``minivectordb_tpu/parallel/mesh.py``. The reference is
single-process and single-node; its "shards" are pickle files. Here a search
mesh is a 1-D array of devices over the corpus-row axis (search data
parallelism), a pod mesh a 2-D (dcn, ici) array: hosts by the devices of
each host, and a training mesh a 2-D (dp, tp) array: data-parallel replicas
by tensor-parallel shards (models/train.py, parallel/tensor_parallel.py).

``Mesh`` stands in for ``jax.sharding.Mesh``: an ndarray of ``torch.device``
(one entry per shard) with axis names. One device may appear several times:
then several logical shards live on it, each with its own row block, and
their scans run one after the other. That is how one card (or the CPU in the
tests) shows the sharding logic, the per-shard kernel launches and the merge;
it is the emulation the JAX tests get from XLA's forced host device count,
and it shows no speed-up from more chips.

A pod mesh built after ``init_pod`` spans processes: row h of its (dcn, ici)
array belongs to process h, and each process holds (and scans) only its own
row; a training mesh built with ``pod=True`` after ``init_pod`` gives each
process one position, its rank in row-major order. Collectives go through
``torch.distributed``: NCCL between CUDA devices, gloo between CPU
processes.

``PartitionSpec`` and ``NamedSharding`` stand in for ``jax.sharding``'s: the
layout of one parameter on a training mesh, as ``param_shardings``
(models/train.py) gives it, in the JAX package's terms.
"""

from __future__ import annotations

import numpy as np
import torch

from dataclasses import dataclass

from minivectordb_tpu_torch.ops import scan as scan_ops

SHARD_AXIS = "shards"  # corpus-row partition axis (search DP)
DP_AXIS = "dp"  # batch axis (training)
TP_AXIS = "tp"  # hidden/head axis (training tensor parallelism)
DCN_AXIS = "dcn"  # host axis of a multi-host pod (data-center network)
ICI_AXIS = "ici"  # device axis within a host


class Mesh:
    """An ndarray of ``torch.device`` and its axis names.

    ``process_index`` is None for a mesh whose every shard this process holds
    (``search_mesh``, ``train_mesh(device=...)``, an emulated pod); for a
    mesh over ``torch.distributed`` it is this process's rank. Each process
    then holds ``per_process`` consecutive positions in row-major order: a
    pod mesh's row (the default), one position of a training mesh. The other
    entries name the same local layout on the other processes."""

    def __init__(self, devices, axis_names, process_index: int | None = None,
                 per_process: int | None = None):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"devices of rank {arr.ndim} for axes {tuple(axis_names)}"
            )
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        if process_index is not None and arr.ndim != 2:
            raise ValueError(
                "a mesh across processes is a (dcn, ici) pod mesh or a (dp, tp) "
                "training mesh"
            )
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.process_index = process_index
        self.per_process = per_process or (arr.shape[-1] if arr.ndim == 2 else arr.size)

    @property
    def distributed(self) -> bool:
        """True when the mesh spans processes (merges end in an all-gather
        over ``torch.distributed``)."""
        return self.process_index is not None

    def local_shards(self) -> list[tuple[int, torch.device]]:
        """(global shard index, device) of every shard this process holds, in
        shard order: row-major over the mesh (the JAX package's order)."""
        flat = list(self.devices.reshape(-1))
        if not self.distributed:
            return list(enumerate(flat))
        c = self.per_process
        lo = self.process_index * c
        return [(lo + i, flat[lo + i]) for i in range(c)]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one mesh axis name (or None) per
    dimension of an array; ``PartitionSpec()`` replicates it."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and the spec of one array on
    it."""

    mesh: Mesh
    spec: PartitionSpec


def train_spec(path: tuple) -> PartitionSpec:
    """The Megatron layout of one leaf of the encoder's parameter pytree (its
    path of keys, list indices included), in the JAX package's terms: its
    dense weights are (in, out), so q, k, v and ffn_in split their output
    columns, ``PartitionSpec(None, "tp")``, with their biases,
    ``PartitionSpec("tp")``; attn_out and ffn_out split their input rows,
    ``PartitionSpec("tp", None)``; everything else is replicated."""
    if "layers" in path:
        parent, leaf = path[-2], path[-1]
        if leaf == "w":
            if parent in ("q", "k", "v", "ffn_in"):
                return PartitionSpec(None, TP_AXIS)
            if parent in ("attn_out", "ffn_out"):
                return PartitionSpec(TP_AXIS, None)
        if leaf == "b" and parent in ("q", "k", "v", "ffn_in"):
            return PartitionSpec(TP_AXIS)
    return PartitionSpec()


def _cuda_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh over the visible CUDA devices needs one and none is "
            "available; pass device='cpu' for logical shards on the host"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def search_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """1-D mesh for sharded search.

    ``device=None``: over all (or the first ``n_devices``) visible CUDA
    devices, one shard each; raises when there is none. With ``device``
    (``"cpu"``, ``"cuda:0"``): ``n_devices`` (default 1) logical shards on
    that one device, each with its own row block — the emulation of a
    multi-device mesh that the JAX tests get from XLA's forced host device
    count. It checks the sharding logic and the merge, and shows no
    speed-up: the shards' scans run one after the other."""
    if device is None:
        devices = _cuda_devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    else:
        devices = [scan_ops.resolve_device(device)] * (n_devices or 1)
    return Mesh(devices, (SHARD_AXIS,))


def init_pod(coordinator_address: str, num_processes: int, process_id: int,
             device=None) -> None:
    """Join a multi-host pod: one call per process before any pod search.

    Idempotent wrapper over ``torch.distributed.init_process_group``. The
    backend follows ``device``: NCCL for CUDA (``None`` means the card,
    which then becomes this process's current device), gloo for ``"cpu"``.
    A backend that fails raises; there is no switch to another.
    ``coordinator_address`` is ``"host:port"`` (a TCP store on the first
    process) or an ``init_method`` URL such as ``"file:///path/store"``,
    which needs no port. After it, ``pod_mesh()`` builds its (dcn, ici) axes
    from the process group."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dev = scan_ops.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    init_method = (
        coordinator_address
        if "://" in coordinator_address
        else f"tcp://{coordinator_address}"
    )
    dist.init_process_group(
        backend=backend, init_method=init_method,
        world_size=int(num_processes), rank=int(process_id),
    )


def pod_mesh(n_hosts: int | None = None, chips_per_host: int | None = None,
             device=None) -> Mesh:
    """2-D (dcn, ici) mesh for pod search: the outer axis spans hosts, the
    inner axis the devices of each host. parallel/dist_scan.py merges each
    host's shards first, so one k-wide candidate list per host crosses
    between hosts.

    After ``init_pod`` the dcn axis follows the process group: one row a
    process (``n_hosts``, when given, must equal the world size), each row
    this process's devices — its visible CUDA devices, or
    ``chips_per_host`` (default 1) logical shards on ``device``. Without a
    process group it reshapes one process's devices, as the JAX package does
    on one host: ``n_hosts`` is required."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_hosts is not None and n_hosts != world:
            raise ValueError(f"need {n_hosts} hosts, the process group has {world}")
        if device is None:
            local = _cuda_devices()
            chips_per_host = chips_per_host or len(local)
            if len(local) < chips_per_host:
                raise ValueError(
                    f"need {chips_per_host} devices a host, have {len(local)}"
                )
            row = local[:chips_per_host]
        else:
            row = [scan_ops.resolve_device(device)] * (chips_per_host or 1)
        return Mesh([row] * world, (DCN_AXIS, ICI_AXIS), process_index=rank)
    if n_hosts is None:
        raise ValueError("n_hosts is required in a single-process pod emulation")
    if device is None:
        devices = _cuda_devices()
        if chips_per_host is None:
            chips_per_host = len(devices) // n_hosts
    else:
        chips_per_host = chips_per_host or 1
        devices = [scan_ops.resolve_device(device)] * (n_hosts * chips_per_host)
    need = n_hosts * chips_per_host
    if need == 0 or len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.empty((n_hosts, chips_per_host), dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i // chips_per_host, i % chips_per_host] = d
    return Mesh(arr, (DCN_AXIS, ICI_AXIS))


def train_mesh(n_devices: int | None = None, tp: int = 2, device=None,
               pod: bool = False) -> Mesh:
    """2-D (dp, tp) mesh for encoder training. ``tp`` is halved until it
    divides the number of positions n, as the JAX package does; dp = n / tp.

    ``device=None``: over all (or the first ``n_devices``) visible CUDA
    devices, one position each; raises when there is none. With ``device``
    (``"cpu"``, ``"cuda:0"``): ``n_devices`` (default 1) logical positions on
    that one device, the emulation the JAX tests get from XLA's forced host
    device count; their work runs one after the other. Both hold every
    position in this process, whether or not a process group is open.
    ``pod=True`` (after ``init_pod``): one position a process of the group
    (``n_devices``, when given, must equal the world size), this process's
    at its rank, on ``device`` or on the card ``init_pod`` made current."""
    import torch.distributed as dist

    if pod:
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("train_mesh(pod=True) needs the process group of init_pod")
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(
                f"need {n_devices} positions, the process group has {world}"
            )
        local = scan_ops.resolve_device(device)
        devices, process_index = [local] * world, rank
    elif device is None:
        devices, process_index = _cuda_devices(), None
        if n_devices is not None:
            devices = devices[:n_devices]
    else:
        devices = [scan_ops.resolve_device(device)] * (n_devices or 1)
        process_index = None
    n = len(devices)
    while tp > 1 and n % tp != 0:
        tp //= 2
    arr = np.empty((n // tp, tp), dtype=object)
    for i, d in enumerate(devices):
        arr[i // tp, i % tp] = d
    return Mesh(arr, (DP_AXIS, TP_AXIS), process_index=process_index,
                per_process=1 if process_index is not None else None)
