"""Training the encoder on a (dp, tp) mesh: placement, the sharded step and
its collectives.

Counterpart of what GSPMD inserts into the JAX package's
``make_train_step(mesh=)`` (``minivectordb_tpu/models/train.py``): there XLA
partitions the one-device step by ``param_shardings`` and the batch's
``P("dp", None)`` and adds every collective itself. PyTorch has no such
pass, so this module writes the Megatron layout and its collectives out.

Placement. Position (r, j) of the mesh, flat index r * tp + j (dp replica r,
tp shard j), holds a piece ``Encoder`` (``models/encoder.py`` with ``tp``):
block j of the output columns of q, k, v and ffn_in (whole heads) and of the
input rows of attn_out and ffn_out, and every other parameter whole
(replicated). Each position keeps its own AdamW state (``MeshAdamW``).
``place`` splits a numpy pytree, an ``Encoder`` or a placed checkpoint
(``ShardedArray`` leaves, ``place_tree``) into pieces; ``gather`` joins them
into the JAX package's pytree again (``convert.shard_tree`` /
``unshard_trees``, by ``parallel.mesh.train_spec``).

The step (``make_step``). The batch rows split over dp in blocks of
ceil(B / dp), the layout GSPMD gives ``with_sharding_constraint`` (so a
replica may get no rows), ``labels`` included. Each replica encodes its
rows:

- the embeddings and layer norms are replicated: in one process they are
  computed once a replica, with its tp position 0's parameters (the other
  positions' copies follow through the gradient hand-over below); across
  processes each position computes them, as Megatron does;
- per layer, ``_CopyToTP`` (identity forward, gradients summed backward)
  hands the hidden states to the tp positions; each projects its heads' q,
  k and v and runs the encoder's attention on them
  (``models.encoder.attention_context``: on the card K6 with its log-sum-exp
  forward, K7 and K8 backward, at nh / tp heads); its attn_out rows give a
  float32 partial product; ``_ReduceFromTP`` (sum forward, identity
  backward) sums the partials in float32, and the bias is added once, after
  the sum, with one rounding to the activations' type, as JAX's ``_dense``
  does after GSPMD's reduction. The MLP the same way: ffn_in columns, GELU,
  ffn_out rows. With tp = 1 a replica encodes with ``models.encoder.encode``,
  the single-device forward;
- the InfoNCE logits span the global batch: ``_GatherFromDP`` gives each
  replica every passage embedding (backward: each replica's gradient summed
  onto the rows it came from); a replica's loss is its rows' cross entropy
  summed and divided by B, so the replicas' losses add up to the global mean.

After the backward every gradient is summed over dp in float32 and rounded
once, and each replicated one is handed to every tp position; each
position's AdamW then steps, so the dp replicas of a tp shard, and the
copies of a replicated parameter, stay equal bit for bit.

Backends. Each collective is one ``torch.autograd.Function`` (or, for the
gradients, one function) that first sums the positions this process holds
and then all-reduces over a ``torch.distributed`` group when the mesh spans
processes: in one process (``train_mesh(n, device=...)``, or several cards)
the sum is taken on the replica's first device and copied back; across
processes (``train_mesh(pod=True)`` after ``init_pod``, one position a process) the
tp and dp groups come from ``dist.new_group``, NCCL on the card and gloo on
the CPU. NCCL refuses two ranks on one GPU, so on one card the process-group
path runs as a one-rank world. A sum of two float32 operands is the same in
either order, so a mesh whose groups have two members gives the in-process
emulation's bits across processes too.

Deliberate differences from GSPMD: a tp shard must hold whole heads and an
equal share of the MLP (``check_widths`` raises otherwise), where GSPMD
reshards heads split across devices; the replicated parameters' copies are
kept by every position (GSPMD keeps one array).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch.nn import functional as F

from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch.models import convert as model_convert
from minivectordb_tpu_torch.models.encoder import (
    Encoder,
    EncoderConfig,
    _dense,
    _layer_norm,
    attention_context,
    embed_tokens,
    encode,
    mean_pool_normalize,
)
from minivectordb_tpu_torch.ops import scan as scan_ops
from minivectordb_tpu_torch.parallel.mesh import (
    DP_AXIS,
    TP_AXIS,
    Mesh,
    NamedSharding,
    train_spec,
)

# the piece parameters split over tp (module names; the rest is replicated)
_COLUMN = ("q", "k", "v", "ffn_in")
_ROW = ("attn_out", "ffn_out")


def check_mesh(mesh) -> tuple[int, int]:
    """(dp, tp) of a training mesh; raises for any other object."""
    if not isinstance(mesh, Mesh) or mesh.axis_names != (DP_AXIS, TP_AXIS):
        raise TypeError(
            f"training takes a (dp, tp) mesh from parallel.mesh.train_mesh, not {mesh!r}"
        )
    dp, tp = mesh.devices.shape
    return dp, tp


def check_widths(cfg: EncoderConfig, tp: int) -> None:
    """Each tp shard holds whole heads and an equal share of the MLP."""
    if cfg.heads % tp or cfg.intermediate % tp:
        raise ValueError(
            f"{tp} tensor-parallel shards need whole heads and an equal share of "
            f"the MLP each: heads {cfg.heads} (of {cfg.hidden // cfg.heads}), "
            f"hidden {cfg.hidden}, intermediate {cfg.intermediate}"
        )


def row_spans(b: int, dp: int) -> list[tuple[int, int]]:
    """The batch rows [lo, hi) of each dp replica: blocks of ceil(b / dp),
    as GSPMD lays out a dimension that dp does not divide."""
    c = -(-b // dp)
    return [(min(r * c, b), min((r + 1) * c, b)) for r in range(dp)]


def _is_split(name: str) -> bool:
    """Whether a piece parameter (``named_parameters`` name) is split over tp."""
    parts = name.split(".")
    if len(parts) != 4 or parts[0] != "layers":
        return False
    module, leaf = parts[2], parts[3]
    return module in _COLUMN or (module in _ROW and leaf == "weight")


class MeshEncoder:
    """An encoder placed on a training mesh: this process's piece ``Encoder``
    of each position it holds, by flat position (r * tp + j)."""

    def __init__(self, cfg: EncoderConfig, mesh: Mesh, pieces: dict):
        self.cfg = cfg
        self.mesh = mesh
        self.pieces = pieces

    @property
    def tp(self) -> int:
        return self.mesh.devices.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.pieces.values())).dtype

    def rows(self) -> dict:
        """dp replica -> this process's pieces of it, in tp order."""
        out: dict = {}
        for pos in sorted(self.pieces):
            out.setdefault(pos // self.tp, []).append(self.pieces[pos])
        return out

    def parameters(self):
        for piece in self.pieces.values():
            yield from piece.parameters()

    def requires_grad_(self, flag: bool = True) -> "MeshEncoder":
        for piece in self.pieces.values():
            piece.requires_grad_(flag)
        return self


class ShardedArray:
    """One parameter placed on a training mesh, as ``load_checkpoint(path,
    shardings=)`` gives it (the counterpart of a sharded ``jax.Array``):
    its ``sharding``, the leaf's global ``shape`` and numpy ``dtype``, and
    ``shards``: flat position -> this process's block of the leaf on that
    position's device, a tensor in the pytree's layout (dense weights (in,
    out))."""

    def __init__(self, sharding: NamedSharding, shape, dtype, shards: dict):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype
        self.shards = shards


def _walk(tree, leaf_fn, path: tuple = ()):
    if isinstance(tree, dict):
        return {k: _walk(v, leaf_fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, leaf_fn, path + (i,)) for i, v in enumerate(tree)]
    return leaf_fn(tree, path)


def _host_leaf(arr, device) -> torch.Tensor:
    """A numpy leaf as a tensor on ``device``, in its own type (bfloat16 for
    ``ml_dtypes.bfloat16``)."""
    arr = np.asarray(arr)
    if convert._is_bf16(arr):
        return convert.tensor_from_numpy(arr.view(np.uint16), device, bf16=True)
    return convert.tensor_from_numpy(arr, device)


def place_tree(params, shardings):
    """The numpy parameter pytree placed by ``shardings`` (``param_shardings``'
    pytree of ``NamedSharding``): a pytree of ``ShardedArray`` holding each
    leaf's block of every position this process holds."""
    flat_s: dict = {}
    _walk(shardings, lambda s, path: flat_s.__setitem__(path, s))

    def place_leaf(arr, path):
        sharding = flat_s[path]
        mesh = sharding.mesh
        tp = check_mesh(mesh)[1]
        arr = np.asarray(arr)
        shards = {pos: _host_leaf(convert.shard_leaf(arr, sharding.spec, pos % tp, tp), dev)
                  for pos, dev in mesh.local_shards()}
        return ShardedArray(sharding, arr.shape, arr.dtype, shards)

    return _walk(params, place_leaf)


def place(params, cfg: EncoderConfig, mesh: Mesh) -> MeshEncoder:
    """``params`` on the mesh: a ``MeshEncoder`` of this process's positions.
    ``params`` is the JAX parameter pytree (numpy leaves, nested or the flat
    names of a ``params.npz``), a placed checkpoint (``ShardedArray``
    leaves), an ``Encoder``, or a ``MeshEncoder`` (kept when it is on this
    mesh, else gathered and placed again)."""
    tp = check_mesh(mesh)[1]
    check_widths(cfg, tp)
    if isinstance(params, MeshEncoder):
        if params.mesh is mesh:
            return params
        params = gather(params)
    if isinstance(params, Encoder):
        params = convert._tree_of(params, lambda p, t: p.detach().T if t else p.detach())
    elif "layers" not in params:
        params = model_convert._unflatten_params(params, cfg.layers)
    pieces = {}
    for pos, dev in mesh.local_shards():
        def leaf(x, path, pos=pos):
            if isinstance(x, ShardedArray):
                return x.shards[pos]
            return convert.shard_leaf(x, train_spec(path), pos % tp, tp)
        pieces[pos] = convert.encoder_from_numpy(_walk(params, leaf), cfg, dev, tp=tp)
    return MeshEncoder(cfg, mesh, pieces)


def _row0(mesh: Mesh, local: dict, tp: int) -> list:
    """The values of positions 0 ... tp - 1 (replica 0) from ``local``
    (position -> value of this process's positions of replica 0). Across
    processes a collective: every process calls it."""
    if mesh.distributed:
        import torch.distributed as dist

        parts: list = [None] * dist.get_world_size()
        dist.all_gather_object(parts, local)
        local = {pos: v for part in parts for pos, v in part.items()}
    return [local[j] for j in range(tp)]


def gather(menc: MeshEncoder) -> dict:
    """The JAX parameter pytree (numpy leaves) of a placed encoder, from dp
    replica 0's pieces. Across processes a collective: every process calls it
    and gets the tree."""
    tp = menc.tp
    local = {pos: convert.encoder_to_numpy(p) for pos, p in menc.pieces.items() if pos < tp}
    return convert.unshard_trees(_row0(menc.mesh, local, tp))


def gather_adamw(menc: MeshEncoder, opt_state: Mapping) -> dict:
    """``convert.adamw_state_to_numpy``'s dict for a placed encoder's AdamW
    state (position -> ``torch.optim.AdamW.state``), joined from dp replica
    0's positions. Across processes a collective, as ``gather``."""
    tp = menc.tp
    local = {pos: convert.adamw_state_to_numpy(opt_state[pos], p)
             for pos, p in menc.pieces.items() if pos < tp}
    states = _row0(menc.mesh, local, tp)
    return {"count": states[0]["count"],
            "mu": convert.unshard_trees([s["mu"] for s in states]),
            "nu": convert.unshard_trees([s["nu"] for s in states])}


class MeshAdamW:
    """One ``torch.optim.AdamW`` a position, over its piece's parameters.
    ``state`` is position -> that optimizer's state."""

    def __init__(self, menc: MeshEncoder, lr: float, **kw):
        self.optimizers = {pos: torch.optim.AdamW(p.parameters(), lr=lr, **kw)
                           for pos, p in menc.pieces.items()}

    @property
    def state(self) -> dict:
        return {pos: opt.state for pos, opt in self.optimizers.items()}

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for opt in self.optimizers.values():
            opt.step()


def resume(opt_state, menc: MeshEncoder, optimizer: MeshAdamW) -> None:
    """Loads ``opt_state`` into fresh per-position optimizers: an earlier
    call's (position -> AdamW state over these pieces), or a checkpoint's
    numpy state of either package (split into each position's block)."""
    if isinstance(opt_state, Mapping) and all(isinstance(k, int) for k in opt_state):
        for pos, opt in optimizer.optimizers.items():
            for param in menc.pieces[pos].parameters():
                if param in opt_state[pos]:
                    opt.state[param] = opt_state[pos][param]
        return
    count, mu, nu = convert.adamw_fields(opt_state)
    tp = menc.tp
    for pos, piece in menc.pieces.items():
        part = {"count": count, "mu": convert.shard_tree(mu, pos % tp, tp),
                "nu": convert.shard_tree(nu, pos % tp, tp)}
        convert.adamw_state_from_numpy(part, piece, optimizer.optimizers[pos])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _groups(mesh: Mesh) -> tuple:
    """(tp group, dp group) of this process on a mesh across processes: the
    ``torch.distributed`` groups of its replica's positions and of its
    shard's replicas; None for a group of one, and for an in-process mesh.
    Every process creates every group, in one order (``dist.new_group`` is
    collective); they are kept on the mesh."""
    if not mesh.distributed:
        return None, None
    cached = getattr(mesh, "_train_groups", None)
    if cached is not None:
        return cached
    import torch.distributed as dist

    dp, tp = mesh.devices.shape
    rank = mesh.process_index
    tp_groups = ([dist.new_group([r * tp + j for j in range(tp)]) for r in range(dp)]
                 if tp > 1 else None)
    dp_groups = ([dist.new_group([r * tp + j for r in range(dp)]) for j in range(tp)]
                 if dp > 1 else None)
    mesh._train_groups = (tp_groups[rank // tp] if tp_groups else None,
                          dp_groups[rank % tp] if dp_groups else None)
    return mesh._train_groups


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, group=group)
    return t


def _sum_f32(tensors, shape, device) -> torch.Tensor:
    """The float32 sum, on ``device``, of the tensors that are not None."""
    total = torch.zeros(shape, dtype=torch.float32, device=device)
    for t in tensors:
        if t is not None:
            total += t.to(device=device, dtype=torch.float32)
    return total


class _CopyToTP(torch.autograd.Function):
    """Where a column-parallel block begins (Megatron's f): forward, x on
    each of this process's tp positions of the replica; backward, their
    gradients summed in float32, all-reduced over the tp group, rounded once
    to x's type."""

    @staticmethod
    def forward(ctx, group, x, *devices):
        ctx.group, ctx.dtype, ctx.device, ctx.shape = group, x.dtype, x.device, x.shape
        return tuple(x.view_as(x) if torch.device(d) == x.device else x.to(d)
                     for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = _all_reduce(_sum_f32(grads, ctx.shape, ctx.device), ctx.group)
        return (None, total.to(ctx.dtype), *([None] * len(grads)))


class _ReduceFromTP(torch.autograd.Function):
    """Where a row-parallel block ends (Megatron's g): forward, the tp
    positions' float32 partial products summed on ``device`` and all-reduced
    over the tp group; backward, the gradient handed to every partial."""

    @staticmethod
    def forward(ctx, group, device, *partials):
        ctx.devices = [p.device for p in partials]
        return _all_reduce(_sum_f32(partials, partials[0].shape, device), group)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *(grad.to(d) for d in ctx.devices))


class _GatherFromDP(torch.autograd.Function):
    """Every replica's rows of a (rows, H) float32 tensor: forward, this
    process's replicas' blocks (``rows`` of them, spans ``spans``) joined
    with the others' (an all-gather over the dp group, padded to the widest
    block), one (B, H) copy on each local block's device; backward, the
    copies' gradients summed (float32, all-reduced over the dp group) and
    each block's rows handed back."""

    @staticmethod
    def forward(ctx, group, spans, rows, *blocks):
        home = blocks[0].device
        ctx.group, ctx.home, ctx.b = group, home, spans[-1][1]
        ctx.local = [(spans[r], blk.device) for r, blk in zip(rows, blocks)]
        width = blocks[0].shape[1]
        if group is None:
            full = torch.cat([blk.to(home) for blk in blocks])
        else:
            import torch.distributed as dist

            (blk,) = blocks
            pad = max(hi - lo for lo, hi in spans)
            mine = torch.zeros((pad, width), dtype=blk.dtype, device=home)
            mine[:blk.shape[0]] = blk
            parts = [torch.empty_like(mine) for _ in spans]
            dist.all_gather(parts, mine, group=group)
            full = torch.cat([p[:hi - lo] for p, (lo, hi) in zip(parts, spans)])
        return tuple(full.to(blk.device) for blk in blocks)

    @staticmethod
    def backward(ctx, *grads):
        width = next(g.shape[1] for g in grads if g is not None)
        total = _all_reduce(_sum_f32(grads, (ctx.b, width), ctx.home), ctx.group)
        return (None, None, None,
                *(total[lo:hi].to(dev) for (lo, hi), dev in ctx.local))


def _reduce_grads(menc: MeshEncoder, dp_group) -> None:
    """Every parameter's gradient summed over dp (float32, one rounding to
    the parameter's type), given to each dp replica; a replicated parameter's
    from the position that computed it (tp position 0 of each replica in one
    process) to every tp position. A parameter without a gradient (a replica
    without rows) counts zero."""
    tp = menc.tp
    named = {pos: dict(p.named_parameters()) for pos, p in menc.pieces.items()}
    columns: dict = {}
    for pos in named:
        columns.setdefault(pos % tp, []).append(pos)
    for name in named[next(iter(named))]:
        split = _is_split(name)
        totals = []
        for positions in columns.values():
            sources = [pos if split or pos - pos % tp not in named else pos - pos % tp
                       for pos in positions]
            ref = named[positions[0]][name]
            total = _sum_f32([named[s][name].grad for s in sources], ref.shape, ref.device)
            totals.append(_all_reduce(total, dp_group).to(ref.dtype))
        for positions, total in zip(columns.values(), totals):
            for pos in positions:
                param = named[pos][name]
                param.grad = total.to(param.device, copy=True)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


class _MixedPartial(torch.autograd.Function):
    """h @ w.T of bfloat16 operands on the card as a float32 product: the
    tensor cores' exact products and float32 accumulation (``torch.mm``'s
    ``out_dtype``), no rounding. Backward: the gradient, the rounding of a
    bfloat16 value (``_biased``), is exact in bfloat16; dh and dw are the
    same products, each rounded once to bfloat16."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        h2 = h.reshape(-1, h.shape[-1])
        out = torch.mm(h2, w.T, out_dtype=torch.float32)
        return out.view(*h.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        h, w = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1]).to(w.dtype)
        dh = torch.mm(g, w, out_dtype=torch.float32).to(h.dtype).view_as(h)
        dw = torch.mm(g.T, h.reshape(-1, h.shape[-1]), out_dtype=torch.float32)
        return dh, dw.to(w.dtype)


def _partial(h, lin) -> torch.Tensor:
    """h times this position's rows of a row-parallel weight: a float32
    partial product of exact products (bfloat16 operands are exact in
    float32), without the bias. On the card bfloat16 operands go to the
    tensor cores (``_MixedPartial``); the CPU, which has no such product,
    multiplies them upcast to float32."""
    scan_ops._assert_ieee_f32(h)
    w = lin.weight.to(h.dtype)
    if h.dtype == torch.float32:
        return F.linear(h, w)
    if h.device.type == "cuda":
        return _MixedPartial.apply(h, w)
    return F.linear(h.to(torch.float32), w.to(torch.float32))


def _biased(total, lin, dtype) -> torch.Tensor:
    """The reduced product plus the bias, rounded once to ``dtype``."""
    return (total + lin.bias.to(torch.float32)).to(dtype)


def encode_replica(pieces: list, input_ids, attention_mask, tp_group=None):
    """One dp replica's forward on tp > 1 shards -> last_hidden_state (rows,
    S, H) on its first piece's device, in the parameters' type. ``pieces``
    are this process's tp positions of the replica, in tp order."""
    lead = pieces[0]
    cfg = lead.cfg
    hd = cfg.hidden // cfg.heads
    eps = cfg.layer_norm_eps
    devices = [p.device for p in pieces]
    mask = attention_mask.to(torch.bool)
    masks = [mask.to(d) for d in devices]
    x = embed_tokens(lead, input_ids, attention_mask)
    for i, own in enumerate(lead.layers):
        layers = [p.layers[i] for p in pieces]
        xs = _CopyToTP.apply(tp_group, x, *devices)
        parts = [_partial(attention_context(xj, lj, mj, hd), lj.attn_out)
                 for xj, lj, mj in zip(xs, layers, masks)]
        attn = _biased(_ReduceFromTP.apply(tp_group, x.device, *parts), own.attn_out, x.dtype)
        x = _layer_norm(x + attn, own.attn_ln.g, own.attn_ln.b, eps)
        xs = _CopyToTP.apply(tp_group, x, *devices)
        parts = [_partial(F.gelu(_dense(xj, lj.ffn_in)), lj.ffn_out)
                 for xj, lj in zip(xs, layers)]
        ff = _biased(_ReduceFromTP.apply(tp_group, x.device, *parts), own.ffn_out, x.dtype)
        x = _layer_norm(x + ff, own.ffn_ln.g, own.ffn_ln.b, eps)
    return x


def _embeddings(pieces, ids, mask, tp, tp_group):
    """Pooled unit embeddings (rows, H) float32; a replica without rows
    gives an empty leaf, so its process still takes part in the dp
    collectives of the backward."""
    lead = pieces[0]
    if ids.shape[0] == 0:
        return torch.zeros((0, lead.cfg.hidden), dtype=torch.float32,
                           device=lead.device, requires_grad=True)
    if tp == 1:
        hidden = encode(lead, ids, mask)
    else:
        hidden = encode_replica(pieces, ids, mask, tp_group)
    return mean_pool_normalize(hidden, mask, lead.cfg.token_norm_pool)


def _batch_rows(batch: dict, lo: int, hi: int, device) -> dict:
    out = {}
    for key, val in batch.items():
        t = val if isinstance(val, torch.Tensor) else torch.as_tensor(np.asarray(val))
        out[key] = t[lo:hi].to(device)
    return out


def make_step(cfg: EncoderConfig, optimizer: MeshAdamW, mesh: Mesh,
              temperature: float = 0.05):
    """The sharded training step ``step(params, opt_state, batch) ->
    (params, opt_state, {"loss", "accuracy"})`` over a ``MeshEncoder`` on
    ``mesh``: the global batch (numpy; every process passes the whole batch)
    split over dp, the forward and backward above, the gradients summed over
    dp, one AdamW update at every position, in place. The metrics are the
    global batch's, float32 scalar tensors on replica 0's first device (this
    process's replica across processes)."""
    dp, tp = check_mesh(mesh)
    tp_group, dp_group = _groups(mesh)

    def step(params: MeshEncoder, opt_state, batch):
        rows = params.rows()
        spans = row_spans(int(np.shape(batch["q_ids"])[0]), dp)
        b = spans[-1][1]
        optimizer.zero_grad(set_to_none=True)
        q_emb, p_emb, parts = {}, {}, {}
        for r, pieces in rows.items():
            parts[r] = _batch_rows(batch, *spans[r], pieces[0].device)
            q_emb[r] = _embeddings(pieces, parts[r]["q_ids"], parts[r]["q_mask"], tp, tp_group)
            p_emb[r] = _embeddings(pieces, parts[r]["p_ids"], parts[r]["p_mask"], tp, tp_group)
        scan_ops._assert_ieee_f32(next(iter(q_emb.values())))
        passages = _GatherFromDP.apply(dp_group, spans, list(rows), *p_emb.values())
        home = next(iter(rows.values()))[0].device
        loss = hits = None
        for (r, q), p_all in zip(q_emb.items(), passages):
            logits = torch.matmul(q, p_all.T) / temperature
            pred = torch.argmax(logits, dim=-1)
            if "labels" in parts[r]:
                labels = parts[r]["labels"].to(torch.float32)
                loss_r = F.cross_entropy(logits, labels, reduction="sum")
                hit = torch.gather(labels > 0, 1, pred[:, None])[:, 0]
            else:
                diag = torch.arange(*spans[r], device=logits.device)
                loss_r = F.cross_entropy(logits, diag, reduction="sum")
                hit = pred == diag
            loss_r = (loss_r / b).to(home)
            hits_r = hit.to(torch.float32).sum().to(home)
            loss = loss_r if loss is None else loss + loss_r
            hits = hits_r if hits is None else hits + hits_r
        loss.backward()
        _reduce_grads(params, dp_group)
        optimizer.step()
        metrics = torch.stack([loss.detach(), hits / b])
        metrics = _all_reduce(metrics, dp_group) if dp_group is not None else metrics
        return params, opt_state, {"loss": metrics[0], "accuracy": metrics[1]}

    return step
