"""Carries state from numpy into the port.

The JAX package and this one share no code, so the tests (and a user moving
a corpus over) hand state across as numpy arrays and builtins:

- the five keys of ``db.pkl`` (``embeddings``, uids in row order,
  ``metadata``, ``inverted_index``) become a loaded ``SearchEngine``;
- a JAX store's device arrays pulled with ``np.asarray`` (``buf``,
  ``inv_norms``, optionally the bfloat16 ``scan_buf``) become tensors on the
  port's device, byte for byte, so kernel-level tests run both packages on
  the same bytes. numpy has no bfloat16: bf16 arrays cross as ``uint16``
  views (``np.asarray(x).view(np.uint16)``) and are reinterpreted here.
"""

from __future__ import annotations

import numpy as np
import torch

from minivectordb_tpu_torch.core.engine import SearchEngine
from minivectordb_tpu_torch.ops import scan as scan_ops


def tensor_from_numpy(arr: np.ndarray, device, bf16: bool = False) -> torch.Tensor:
    """A tensor on ``device`` with ``arr``'s bytes. ``bf16=True`` reads a
    ``uint16`` array as the bit patterns of bfloat16 values."""
    arr = np.ascontiguousarray(arr)
    if bf16:
        if arr.dtype != np.uint16:
            raise TypeError("bfloat16 state crosses as a uint16 view")
        t = scan_ops.to_device(arr.view(np.int16), device)
        return t.view(torch.bfloat16)
    return scan_ops.to_device(arr, device)


def store_state_from_numpy(
    embeddings=None,
    uids=None,
    metadata=None,
    inverted_index=None,
    *,
    buf=None,
    inv_norms=None,
    scan_buf=None,
    device=None,
    device_dtype: str = "float32",
    search_mode: str = "exact",
):
    """Build the port's state from numpy.

    With ``embeddings`` (N, d) float32 and ``uids`` (row order; ``metadata``
    defaults to empty dicts, ``inverted_index`` is rebuilt when None):
    returns a ``SearchEngine`` on ``device`` loaded with them — what
    ``VectorDatabase`` builds from a ``db.pkl``.

    With ``buf`` (and ``inv_norms``): returns ``(buf, inv_norms, scan_buf)``
    as tensors on ``device`` holding exactly those bytes. ``buf`` is float32,
    int8, or uint16 (bfloat16 bits); ``scan_buf`` is uint16 or None.
    """
    if buf is not None:
        dev = scan_ops.resolve_device(device)
        buf = np.asarray(buf)
        t_buf = tensor_from_numpy(buf, dev, bf16=buf.dtype == np.uint16)
        t_inv = (
            None if inv_norms is None
            else tensor_from_numpy(np.asarray(inv_norms, np.float32), dev)
        )
        t_scan = (
            None if scan_buf is None
            else tensor_from_numpy(np.asarray(scan_buf), dev, bf16=True)
        )
        return t_buf, t_inv, t_scan
    engine = SearchEngine(
        device_dtype=device_dtype, search_mode=search_mode, device=device
    )
    n = 0 if embeddings is None else len(embeddings)
    uids = list(range(n)) if uids is None else list(uids)
    metadata = [{} for _ in uids] if metadata is None else list(metadata)
    with engine.lock:
        engine.load(embeddings, uids, metadata, inverted_index)
    return engine


_IVF_STATE_INTS = ("nlist", "nprobe", "iters", "seed", "n_dup", "pad_len", "count")


def ivf_state_from_numpy(state: dict) -> dict:
    """The port's IVF state from the JAX package's.

    ``state`` is what ``minivectordb_tpu.ops.ivf.IVFIndex.state_dict()``
    returns: builtins plus numpy arrays ``centroids`` (L, d), ``list_ids``
    (L, P) and ``list_valid`` (L, P). The two packages share the schema, so
    this checks it and copies it with the dtypes fixed (float32 / int32 /
    bool arrays, Python ints); the input is left untouched. Hand the result
    to ``ops.ivf.IVFIndex.from_state`` together with the corpus, or to
    ``SearchEngine.set_ivf_state``. Keys this function does not know (a
    sidecar's ``uid_digest``) are carried over as they are."""
    missing = {"nlist", "nprobe", "pad_len", "count", "centroids", "list_ids",
               "list_valid"} - set(state)
    if missing:
        raise ValueError(f"IVF state lacks {sorted(missing)}")
    out = dict(state)
    for key in _IVF_STATE_INTS:
        if key in out:
            out[key] = int(out[key])
    out["nprobe_calibrated"] = bool(out.get("nprobe_calibrated", False))
    out["device_dtype"] = str(out.get("device_dtype", "float32"))
    out["centroids"] = np.array(state["centroids"], dtype=np.float32)
    out["list_ids"] = np.array(state["list_ids"], dtype=np.int32)
    out["list_valid"] = np.array(state["list_valid"], dtype=bool)
    l, p = out["list_ids"].shape
    if out["list_valid"].shape != (l, p) or out["centroids"].shape[0] != l:
        raise ValueError("IVF state tables disagree on the number of lists")
    if p != out["pad_len"]:
        raise ValueError(f"pad_len {out['pad_len']} but tables have {p} slots")
    return out
