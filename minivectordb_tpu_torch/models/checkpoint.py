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
"""

from __future__ import annotations

import collections
import os
import pickle

import torch

from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch.models.encoder import Encoder

# optax's state classes as a JAX checkpoint pickles them, by name
ScaleByAdamState = collections.namedtuple("ScaleByAdamState", "count mu nu")
EmptyState = collections.namedtuple("EmptyState", "")
_STAND_INS = {"ScaleByAdamState": ScaleByAdamState, "EmptyState": EmptyState}
_FOREIGN = ("optax", "jax", "jaxlib", "flax")


class _Unpickler(pickle.Unpickler):
    """Reads optax's state classes as the stand-ins above and refuses any
    other class of jax's family, so loading imports none of it."""

    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            if module.startswith("optax") and name in _STAND_INS:
                return _STAND_INS[name]
            raise pickle.UnpicklingError(
                f"{module}.{name}: the port reads optax's ScaleByAdamState and "
                "EmptyState from a checkpoint, and no other class of jax's family"
            )
        return super().find_class(module, name)


def _to_host(tree):
    """numpy leaves for tensors; dicts, lists and tuples kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*map(_to_host, tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(_to_host, tree))
    return tree


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    extra: dict | None = None) -> None:
    """``params``: an ``Encoder`` (written as the JAX pytree) or any pytree of
    arrays and tensors. ``opt_state``: with an ``Encoder``, its AdamW's
    ``state`` (``optimizer.state``, as ``models/train.py`` passes it around),
    written in the JAX layout; else any pytree, or None."""
    if isinstance(params, Encoder):
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
    checkpoint of either package. ``shardings`` (a multi-device layout)
    raises until the port has a mesh (ROADMAP queue 1, item 13:
    ``parallel/`` -> ``torch.distributed``)."""
    if shardings is not None:
        raise NotImplementedError(
            "sharded checkpoints wait for the port's mesh (queue 1, item 13: "
            "parallel/ -> torch.distributed)"
        )
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    return payload["params"], payload["opt_state"], payload["step"], payload["extra"]
