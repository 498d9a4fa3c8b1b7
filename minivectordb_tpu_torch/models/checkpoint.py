"""Training checkpoint save/restore.

Counterpart of ``minivectordb_tpu/models/checkpoint.py``: params, optimizer
state and the step counter as one pickle of numpy pytrees (keys ``params``,
``opt_state``, ``step``, ``extra``), written to ``path + ".tmp"`` and moved
into place with ``os.replace``, so a crash never corrupts the previous file.

The pickle holds the JAX package's layout, so either package reads the
other's checkpoints:

- ``params`` is the encoder's parameter pytree (``convert.encoder_to_numpy``:
  dense weights (in, out)); ``minivectordb_tpu.models.checkpoint`` loads it
  and the JAX ``encode`` gives the port's embeddings.
- ``opt_state`` of the port is ``convert.adamw_state_to_numpy``'s dict
  ``{"count", "mu", "nu"}`` (the fields of optax's ``ScaleByAdamState``, the
  moments in the parameters' layout). A JAX checkpoint holds optax's own
  NamedTuples; ``load_checkpoint`` reads those without importing optax (which
  imports jax): its unpickler maps ``ScaleByAdamState`` and ``EmptyState`` to
  plain stand-ins, and ``convert.adamw_state_from_numpy`` takes either form.
- a bfloat16 encoder's params and moments are ``ml_dtypes.bfloat16`` leaves in
  both packages (``convert.tensor_to_numpy``), so a bfloat16 run resumes in
  bfloat16 in either. The unpickler takes ``ml_dtypes.bfloat16`` and no other
  class of ml_dtypes.
- a run on a (dp, tp) mesh writes the same file: its placed params and
  AdamW state gathered into the JAX pytree (``tensor_parallel.gather``),
  as ``np.asarray`` gathers the JAX package's sharded arrays. So a mesh run's
  checkpoint of either package loads into a single-device run of either, and
  the other way round; ``load_checkpoint(path, shardings=)`` places the
  params on a mesh.
"""

from __future__ import annotations

import collections
import os
import pickle

import torch

from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch.models.encoder import Encoder
from minivectordb_tpu_torch.parallel import tensor_parallel

# optax's state classes as a JAX checkpoint pickles them, by name
ScaleByAdamState = collections.namedtuple("ScaleByAdamState", "count mu nu")
EmptyState = collections.namedtuple("EmptyState", "")
_STAND_INS = {"ScaleByAdamState": ScaleByAdamState, "EmptyState": EmptyState}
_FOREIGN = ("optax", "jax", "jaxlib", "flax")


class _Unpickler(pickle.Unpickler):
    """Reads optax's state classes as the stand-ins above and refuses any
    other class of jax's family, so loading imports none of it."""

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            if name != "bfloat16":
                raise pickle.UnpicklingError(
                    f"{module}.{name}: the port reads ml_dtypes.bfloat16 leaves only")
            try:
                import ml_dtypes
            except ImportError as e:
                raise pickle.UnpicklingError(
                    "the checkpoint holds bfloat16 leaves (ml_dtypes.bfloat16): "
                    "reading them needs ml_dtypes") from e
            return ml_dtypes.bfloat16
        if module.split(".")[0] in _FOREIGN:
            if module.startswith("optax") and name in _STAND_INS:
                return _STAND_INS[name]
            raise pickle.UnpicklingError(
                f"{module}.{name}: the port reads optax's ScaleByAdamState and "
                "EmptyState from a checkpoint, and no other class of jax's family"
            )
        return super().find_class(module, name)


def _to_host(tree):
    """numpy leaves for tensors (bfloat16 ones as ml_dtypes.bfloat16);
    dicts, lists and tuples kept as they are."""
    if isinstance(tree, torch.Tensor):
        return convert.tensor_to_numpy(tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*map(_to_host, tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(_to_host, tree))
    return tree


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    extra: dict | None = None) -> None:
    """``params``: an ``Encoder`` (written as the JAX pytree), a
    ``MeshEncoder`` (gathered into it) or any pytree of arrays and tensors.
    ``opt_state``: with an ``Encoder`` or a ``MeshEncoder``, its AdamW's
    ``state`` (``optimizer.state``, as ``models/train.py`` passes it around),
    written in the JAX layout; else any pytree, or None. On a mesh across
    processes every process calls it (the gather is collective) and process
    0 writes the file."""
    if isinstance(params, tensor_parallel.MeshEncoder):
        host_opt = (None if opt_state is None
                    else tensor_parallel.gather_adamw(params, opt_state))
        host_params = tensor_parallel.gather(params)
        if params.mesh.process_index not in (None, 0):
            return
    elif isinstance(params, Encoder):
        host_opt = (None if opt_state is None
                    else convert.adamw_state_to_numpy(opt_state, params))
        host_params = convert.encoder_to_numpy(params)
    else:
        host_params = _to_host(params)
        host_opt = None if opt_state is None else _to_host(opt_state)
    payload = {
        "params": host_params,
        "opt_state": host_opt,
        "step": int(step),
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)  # atomic on POSIX — a crash never corrupts the old


def load_checkpoint(path: str, shardings=None):
    """Returns (params, opt_state, step, extra) as numpy pytrees, from a
    checkpoint of either package. With ``shardings`` (``param_shardings``'
    pytree for a training mesh) the params are placed into their mesh
    layout: a pytree of ``tensor_parallel.ShardedArray``, each leaf's block
    of every position this process holds on that position's device, which
    ``init_training`` / ``train_loop(mesh=)`` take. The opt state stays
    numpy, as in the JAX package."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    params = payload["params"]
    if shardings is not None:
        params = tensor_parallel.place_tree(params, shardings)
    return params, payload["opt_state"], payload["step"], payload["extra"]
