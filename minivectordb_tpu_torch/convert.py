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
  ``np.asarray``) becomes a loaded ``models.encoder.Encoder``, and back;
- the AdamW state of a training run (optax's ``ScaleByAdamState``: count, mu
  and nu, the moments in the parameters' pytree layout) becomes the state of
  a ``torch.optim.AdamW`` over an ``Encoder``'s parameters, and back;
- on a (dp, tp) training mesh, either pytree (parameters, or AdamW's mu and
  nu) splits into the pieces of the tensor-parallel positions
  (``shard_tree``, by ``parallel.mesh.train_spec``) and joins again
  (``unshard_trees``); a piece loads into a piece ``Encoder``
  (``encoder_from_numpy(..., tp=)``) like a whole tree into a whole one.

A bfloat16 encoder's pytree (JAX's ``init_params(..., dtype=jnp.bfloat16)``)
has ``ml_dtypes.bfloat16`` numpy leaves. They are recognised by their dtype's
name, without importing ml_dtypes, and cross through the uint16 convention
above; going back, the port writes such leaves again (importing ml_dtypes,
which the JAX package also uses), so bfloat16 state never turns float32 on
the way.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from minivectordb_tpu_torch.core.engine import SearchEngine
from minivectordb_tpu_torch.models import convert as model_convert
from minivectordb_tpu_torch.models.encoder import Encoder, EncoderConfig
from minivectordb_tpu_torch.ops import scan as scan_ops
from minivectordb_tpu_torch.parallel.mesh import train_spec


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


def _is_bf16(arr) -> bool:
    """Whether ``arr`` is a numpy array of ``ml_dtypes.bfloat16`` (JAX's
    bfloat16 on the host), told by its dtype's name: ml_dtypes is not
    imported."""
    return isinstance(arr, np.ndarray) and arr.dtype.name == "bfloat16"


def _ml_bfloat16():
    try:
        import ml_dtypes
    except ImportError as e:
        raise RuntimeError(
            "bfloat16 tensors leave the port as ml_dtypes.bfloat16 numpy arrays "
            "(the JAX package's host type), and ml_dtypes is not installed: "
            "install it rather than write them as float32"
        ) from e
    return ml_dtypes.bfloat16


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy array of ``t``: bfloat16 tensors become
    ``ml_dtypes.bfloat16`` arrays with the same bits, any other type its
    own."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return bits.view(_ml_bfloat16())
    return t.numpy()


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


def _param_paths(encoder: Encoder):
    """(path in the JAX parameter pytree, parameter, transposed) for every
    parameter of ``encoder``, in the pytree's order. The dense weights are
    transposed: the pytree holds them (in, out), for ``x @ w``; the module
    (out, in), as ``torch.nn.functional.linear`` reads them."""
    yield ("word_emb",), encoder.word_emb, False
    yield ("pos_emb",), encoder.pos_emb, False
    yield ("type_emb",), encoder.type_emb, False
    yield ("emb_ln", "g"), encoder.emb_ln.g, False
    yield ("emb_ln", "b"), encoder.emb_ln.b, False
    for i, layer in enumerate(encoder.layers):
        for name in _DENSE_NAMES:
            yield ("layers", i, name, "w"), getattr(layer, name).weight, True
            yield ("layers", i, name, "b"), getattr(layer, name).bias, False
        for name in _LN_NAMES:
            yield ("layers", i, name, "g"), getattr(layer, name).g, False
            yield ("layers", i, name, "b"), getattr(layer, name).b, False


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _tree_of(encoder: Encoder, leaf) -> dict:
    """The JAX parameter pytree of ``encoder`` with ``leaf(param, transposed)``
    at every leaf."""
    tree: dict = {}
    for path, param, transposed in _param_paths(encoder):
        node = tree
        for key, below in zip(path, path[1:]):
            if isinstance(key, int):
                node = node[key]
            else:
                node = node.setdefault(
                    key, [{} for _ in encoder.layers] if isinstance(below, int) else {})
        node[path[-1]] = leaf(param, transposed)
    return tree


def encoder_from_numpy(params: dict, cfg: EncoderConfig, device=None,
                       tp: int = 1) -> Encoder:
    """A loaded ``Encoder`` on ``device`` from the parameter pytree.

    ``params`` is the JAX package's pytree with numpy leaves (nested, or the
    flat ``layers.0.q.w`` names of a ``params.npz``). Each leaf keeps its
    type: a ``ml_dtypes.bfloat16`` leaf loads as bfloat16, a leaf of any other
    float type as float32 (the bundled artifacts hold float16), and the
    encoder computes in its embeddings' type. So a JAX bfloat16 pytree trains
    as JAX trains it: ``init_params(..., dtype=jnp.bfloat16)`` gives bfloat16
    embeddings, biases and layer norms but float32 dense weights (its
    ``normal(..., dtype) * (1 / np.sqrt(n))`` promotes), which the encoder
    casts to the activations' type at each product (``_dense`` in both
    packages). The pytree's dense weights are (in, out), for ``x @ w``; the
    port stores them (out, in), as ``torch.nn.functional.linear`` reads
    them, and transposes each ONCE, here, never per call. ``device=None``
    means the CUDA card and raises without one.

    With ``tp`` > 1, ``params`` is one tensor-parallel position's piece
    (``shard_tree``) and the result that position's piece ``Encoder``.
    Leaves may also be tensors (in the pytree's layout), as a placed
    checkpoint holds them."""
    dev = scan_ops.resolve_device(device)
    if "layers" not in params:
        params = model_convert._unflatten_params(params, cfg.layers)
    if len(params["layers"]) != cfg.layers:
        raise ValueError(
            f"{len(params['layers'])} layers of parameters for a config of {cfg.layers}"
        )
    emb = params["word_emb"]
    bf16 = (emb.dtype == torch.bfloat16 if isinstance(emb, torch.Tensor)
            else _is_bf16(np.asarray(emb)))
    enc = Encoder(cfg, "meta", torch.bfloat16 if bf16 else torch.float32, tp)
    enc = enc.to_empty(device=dev)
    with torch.no_grad():
        for path, param, transposed in _param_paths(enc):
            leaf = _module_layout(_at(params, path), param, transposed, enc)
            if leaf.dtype != param.dtype:
                param.data = torch.empty(param.shape, dtype=leaf.dtype, device=dev)
            param.copy_(leaf)
    return enc


def _module_layout(arr, param, transposed: bool, encoder: Encoder) -> torch.Tensor:
    """A pytree leaf (numpy, or a tensor) as a tensor of ``param``'s shape on
    its device: bfloat16 for a bfloat16 leaf, else float32. Only token type 0
    is ever used: a wider ``type_emb`` keeps that row."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype != torch.bfloat16:
            t = t.to(torch.float32)
        if param is encoder.type_emb:
            t = t[:1]
        want = tuple(param.shape)[::-1] if transposed else tuple(param.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"parameter of shape {tuple(t.shape)}, expected {want}")
        t = t.to(param.device)
        return t.T if transposed else t
    arr = np.asarray(arr)
    bf16 = _is_bf16(arr)
    if bf16:
        arr = arr.view(np.uint16)
    elif arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    if param is encoder.type_emb:
        arr = arr[:1]
    want = tuple(param.shape)[::-1] if transposed else tuple(param.shape)
    if tuple(arr.shape) != want:
        raise ValueError(f"parameter of shape {arr.shape}, expected {want}")
    t = tensor_from_numpy(arr, param.device, bf16=bf16)
    return t.T if transposed else t


def _to_numpy(t, transpose: bool) -> np.ndarray:
    """bfloat16 stays bfloat16 (``tensor_to_numpy``); other types become
    float32."""
    if t.dtype != torch.bfloat16:
        t = t.to(torch.float32)
    a = tensor_to_numpy(t)
    return np.ascontiguousarray(a.T) if transpose else a


def encoder_to_numpy(encoder: Encoder) -> dict:
    """The parameter pytree (dense weights (in, out)) of a loaded
    ``Encoder``: what ``models/convert.save_converted`` writes and either
    package loads. Leaves are float32, or ``ml_dtypes.bfloat16`` for a
    bfloat16 encoder, as the JAX package holds its bfloat16 parameters."""
    return _tree_of(encoder, _to_numpy)


def adamw_state_to_numpy(opt_state, encoder: Encoder) -> dict:
    """The AdamW state of ``encoder``'s parameters in the JAX layout:
    ``{"count": int32 array, "mu": pytree, "nu": pytree}``, the moments with
    the parameters' pytree structure (dense moments (in, out)), float32 or
    ``ml_dtypes.bfloat16`` as the parameters are (optax keeps its moments in
    the parameters' type).
    ``opt_state`` is a ``torch.optim.AdamW``'s ``state`` (parameter ->
    ``step``, ``exp_avg``, ``exp_avg_sq``); a parameter without state (no
    step taken yet) gets zero moments. optax's ``ScaleByAdamState`` holds the
    same three: ``optax.ScaleByAdamState(**d)`` rebuilds it."""
    steps = {int(st["step"]) for st in opt_state.values() if "step" in st}
    if len(steps) > 1:
        raise ValueError(f"the parameters' AdamW steps differ: {sorted(steps)}")

    def moment(key):
        def leaf(param, transpose):
            st = opt_state.get(param)
            return _to_numpy(st[key] if st else torch.zeros_like(param), transpose)
        return leaf

    return {
        "count": np.asarray(steps.pop() if steps else 0, dtype=np.int32),
        "mu": _tree_of(encoder, moment("exp_avg")),
        "nu": _tree_of(encoder, moment("exp_avg_sq")),
    }


def adamw_state_from_numpy(state, encoder: Encoder, optimizer) -> None:
    """Loads an AdamW state into ``optimizer`` (a ``torch.optim.AdamW`` over
    ``encoder``'s parameters). ``state`` is ``adamw_state_to_numpy``'s dict,
    or what a JAX checkpoint holds for ``optax.adamw``: the tuple
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())`` (read
    without optax by ``models/checkpoint.py``). Moments of a wider
    ``type_emb`` (a converted checkpoint) keep row 0, as the parameter does."""
    count, mu, nu = adamw_fields(state)
    if "layers" not in mu or len(mu["layers"]) != len(encoder.layers):
        raise ValueError("the AdamW state does not have the encoder's layers")
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    for path, param, transposed in _param_paths(encoder):

        def moment(tree):
            t = _module_layout(_at(tree, path), param, transposed, encoder)
            return t.to(param.dtype).contiguous()

        optimizer.state[param] = {"step": step.clone(), "exp_avg": moment(mu),
                                  "exp_avg_sq": moment(nu)}




def adamw_fields(state) -> tuple:
    """(count, mu, nu) of an AdamW state in either package's form:
    ``adamw_state_to_numpy``'s dict, or optax's
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``."""
    if isinstance(state, Mapping):
        return state["count"], state["mu"], state["nu"]
    return tuple(state[0])[:3]


def shard_leaf(leaf, spec, index: int, tp: int):
    """The ``index``-th of ``tp`` blocks of a leaf along the mesh axis its
    spec names (the leaf itself when replicated)."""
    if not any(spec):
        return leaf
    axis = [a is not None for a in spec].index(True)
    n = leaf.shape[axis]
    if n % tp:
        raise ValueError(
            f"a dimension of {n} does not split into {tp} tensor-parallel shards"
        )
    lo, hi = index * n // tp, (index + 1) * n // tp
    return leaf[lo:hi] if axis == 0 else leaf[:, lo:hi]


def shard_tree(tree, index: int, tp: int, path: tuple = ()):
    """Tensor-parallel position ``index``'s piece of a parameter pytree (or
    of AdamW's mu or nu, which have its structure): each leaf's block by
    ``parallel.mesh.train_spec``, the replicated leaves whole. Leaves are
    numpy arrays or tensors, in the JAX package's layout (dense weights (in,
    out))."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, index, tp, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_tree(v, index, tp, path + (i,)) for i, v in enumerate(tree)]
    return shard_leaf(tree, train_spec(path), index, tp)


def unshard_trees(trees: list, path: tuple = ()):
    """The whole pytree from the pieces of tensor-parallel positions 0 ...
    tp - 1 (numpy leaves): the sharded leaves joined along their mesh axis,
    the replicated ones taken from position 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: unshard_trees([t[k] for t in trees], path + (k,)) for k in first}
    if isinstance(first, list):
        return [unshard_trees([t[i] for t in trees], path + (i,))
                for i in range(len(first))]
    spec = train_spec(path)
    if not any(spec):
        return first
    axis = [a is not None for a in spec].index(True)
    return np.concatenate([np.asarray(t) for t in trees], axis=axis)
