"""Carries state from numpy into the port.

The JAX package and this one share no code, so the tests (and a user moving
a corpus over) hand state across as numpy arrays and builtins:

- the five keys of ``db.pkl`` (``embeddings``, uids in row order,
  ``metadata``, ``inverted_index``) become a loaded ``SearchEngine``;
- a JAX store's device arrays pulled with ``np.asarray`` (``buf``,
  ``inv_norms``, optionally the bfloat16 ``scan_buf``) become tensors on the
  port's device, byte for byte, so kernel-level tests run both packages on
  the same bytes. numpy has no bfloat16: bf16 arrays cross as ``uint16``
  views (``np.asarray(x).view(np.uint16)``) and are reinterpreted here;
- the encoder's parameter pytree as numpy arrays (what
  ``models/convert.load_converted`` reads from a ``params.npz``, and what the
  JAX package's ``init_params`` / ``load_converted`` give after
  ``np.asarray``) becomes a loaded ``models.encoder.Encoder``, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from minivectordb_tpu_torch.core.engine import SearchEngine
from minivectordb_tpu_torch.models import convert as model_convert
from minivectordb_tpu_torch.models.encoder import Encoder, EncoderConfig
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


_DENSE_NAMES = ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")
_LN_NAMES = ("attn_ln", "ffn_ln")


def encoder_from_numpy(params: dict, cfg: EncoderConfig, device=None,
                       dtype: torch.dtype = torch.float32) -> Encoder:
    """A loaded ``Encoder`` on ``device`` from the parameter pytree.

    ``params`` is the JAX package's pytree with numpy leaves (nested, or the
    flat ``layers.0.q.w`` names of a ``params.npz``); leaves of any float type
    are cast to ``dtype`` (the bundled artifacts hold float16). The pytree's
    dense weights are (in, out), for ``x @ w``; the port stores them (out, in),
    as ``torch.nn.functional.linear`` reads them, and transposes each ONCE,
    here, never per call. ``device=None`` means the CUDA card and raises
    without one."""
    dev = scan_ops.resolve_device(device)
    if "layers" not in params:
        params = model_convert._unflatten_params(params, cfg.layers)
    if len(params["layers"]) != cfg.layers:
        raise ValueError(
            f"{len(params['layers'])} layers of parameters for a config of {cfg.layers}"
        )
    enc = Encoder(cfg, dev, dtype)

    def put(param, arr, transpose=False):
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        want = tuple(param.shape)[::-1] if transpose else tuple(param.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"parameter of shape {arr.shape}, expected {want}")
        t = scan_ops.to_device(arr, dev)
        param.copy_(t.T if transpose else t)  # casts to the module's dtype

    with torch.no_grad():
        put(enc.word_emb, params["word_emb"])
        put(enc.pos_emb, params["pos_emb"])
        # only token type 0 is ever used: keep that row of a wider table
        put(enc.type_emb, np.asarray(params["type_emb"])[:1])
        put(enc.emb_ln.g, params["emb_ln"]["g"])
        put(enc.emb_ln.b, params["emb_ln"]["b"])
        for layer, lp in zip(enc.layers, params["layers"]):
            for name in _DENSE_NAMES:
                put(getattr(layer, name).weight, lp[name]["w"], transpose=True)
                put(getattr(layer, name).bias, lp[name]["b"])
            for name in _LN_NAMES:
                put(getattr(layer, name).g, lp[name]["g"])
                put(getattr(layer, name).b, lp[name]["b"])
    return enc


def encoder_to_numpy(encoder: Encoder) -> dict:
    """The parameter pytree (float32 numpy leaves, dense weights (in, out)) of
    a loaded ``Encoder``: what ``models/convert.save_converted`` writes and
    either package loads."""
    def arr(t, transpose=False):
        a = t.detach().to(device="cpu", dtype=torch.float32).numpy()
        return np.ascontiguousarray(a.T) if transpose else a

    def ln(mod):
        return {"g": arr(mod.g), "b": arr(mod.b)}

    params = {
        "word_emb": arr(encoder.word_emb),
        "pos_emb": arr(encoder.pos_emb),
        "type_emb": arr(encoder.type_emb),
        "emb_ln": ln(encoder.emb_ln),
        "layers": [],
    }
    for layer in encoder.layers:
        entry = {}
        for name in _DENSE_NAMES:
            mod = getattr(layer, name)
            entry[name] = {"w": arr(mod.weight, transpose=True), "b": arr(mod.bias)}
        for name in _LN_NAMES:
            entry[name] = ln(getattr(layer, name))
        params["layers"].append(entry)
    return params
