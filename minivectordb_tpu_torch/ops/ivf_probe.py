"""IVF probe: hand-written probe kernels + the plain orchestration around them.

Counterpart of ``minivectordb_tpu/ops/pallas_ivf.py``. Two ways to score the
lists a batch of queries probes, over the packed index ``lists (L, P, d)``
(rows stored normalized, so a dot product is a cosine):

- **paged probe** (``ivf_search_paged``, small batches): one matrix-vector
  product per (query, probed list). Kernel K3, ``probe_scores``.
- **grouped probe** (``ivf_search_grouped``, batches of 16 and more, and int8
  lists at every batch size): the (query, list) pairs are sorted by list on
  the device and each list's queries packed into groups of G; one step scores
  a whole group against its list block, so a touched block is read once per
  group instead of once per query. Kernels K4 ``grouped_scores`` (float32,
  bfloat16) and K5 ``grouped_scores_q`` (int8, with the cosine reconstruction
  ``(dots * list_inv[slot]) * qinv[query]`` and the validity mask — in that
  order: empty slots carry ``list_inv == 0`` and a sentinel times 0 would be
  a clean 0.0 score).

Centroid scoring, the probe top-k, the grouping bookkeeping, the gather into
(B, nprobe, P) and the final top-k are plain PyTorch, as the JAX package
leaves them to XLA. No step of the bookkeeping reads a value back to the host.

On a CUDA tensor each wrapper launches its kernel of ``csrc/ivf_probe.cu``
(compiled at first use, kernels/build.py) or raises on what the kernel does
not take; the ``*_plain`` versions serve tensors that lie on the CPU, and only
those. ``LAUNCHES`` counts kernel launches per instantiation.

A padding step (``step_list[s] < 0``: the static step bound over-provisions)
scores nothing; kernel and plain version both write the sentinel -3.0e38 over
its whole (G, P) tile, so no uninitialised value ever leaves a wrapper. No
(pair_step, pair_slot) points at one.

Differences from the JAX module: ``ivf_search_paged`` takes any batch in one
launch (the 64-query chunking there bounds a whole-in-VMEM output);
``selector="approx"`` is served exactly (PyTorch has no ``approx_max_k``; the
JAX module itself selects exactly off the TPU); every top-k is
``ops/scan.py:topk_last_axis`` (ties to the lower position).
"""

from __future__ import annotations

import ctypes

import torch

from minivectordb_tpu_torch.kernels import build
from minivectordb_tpu_torch.ops import scan as scan_ops

_MASKED_SCORE = float(scan_ops._MASKED_SCORE)

GROUP_MAX = 16  # widest query group the grouped kernels take (one mma A tile)
_PLAIN_STEPS = 64  # steps per piece of the plain grouped versions

# Kernel launches per C entry point of csrc/ivf_probe.cu. Incremented in
# _launch, where the kernel is launched, and nowhere else.
LAUNCHES = {
    "ivf_probe_f32": 0, "ivf_probe_bf16": 0,
    "ivf_grouped_f32": 0, "ivf_grouped_bf16": 0, "ivf_grouped_i8": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # lists, q, ids, out, L, P, d, B, nprobe, stream
    "ivf_probe_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ivf_probe_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # lists, gq, step_list, valid, out, L, P, d, S, G, stream
    "ivf_grouped_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ivf_grouped_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # lists, gq, step_list, valid, list_inv, gqinv, out, L, P, d, S, G, stream
    "ivf_grouped_i8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
_fns: dict = {}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = build.load_library("ivf_probe")
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, tensors, out, ints):
    """Launch on the current stream of the tensors' device; no synchronise."""
    fn = _kernel_fn(name)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], out.data_ptr(),
                 *[int(i) for i in ints], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    return out


def _check_lists(lists, q, q_name: str, elem_dtypes) -> None:
    if lists.ndim != 3:
        raise ValueError("lists must be (L, P, d)")
    if lists.dtype not in elem_dtypes:
        raise TypeError(f"lists dtype {lists.dtype} not in {elem_dtypes}")
    if q.dtype != lists.dtype:
        raise TypeError(
            f"{q_name} is {q.dtype}, lists are {lists.dtype}: types must match"
        )
    if q.shape[-1] != lists.shape[2]:
        raise ValueError(f"{q_name} has dim {q.shape[-1]}, lists have {lists.shape[2]}")
    if 0 in lists.shape:
        raise ValueError("lists must not be empty")
    if (lists.shape[2] * lists.element_size()) % 4:
        raise ValueError(
            f"a row of d={lists.shape[2]} {lists.dtype} values is not a whole "
            "number of 32-bit words"
        )


def _check_placed(lists, named) -> None:
    for name, t in named:
        if t.device != lists.device:
            raise ValueError(f"{name} lies on {t.device}, lists on {lists.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# K3: paged probe
# ---------------------------------------------------------------------------


def probe_scores_plain(lists, q, probe_ids):
    """The function K3 computes, in plain PyTorch, one query at a time (so
    the gathered blocks stay at (nprobe, P, d)). Same arguments and result as
    ``probe_scores``."""
    scan_ops._assert_ieee_f32(lists)
    b, nprobe = probe_ids.shape
    p = lists.shape[1]
    out = torch.empty((b, nprobe * p), dtype=torch.float32, device=lists.device)
    qf = q.to(torch.float32)
    for i in range(b):
        blocks = lists[probe_ids[i].long()].to(torch.float32)  # (nprobe, P, d)
        out[i] = (blocks @ qf[i]).reshape(-1)
    return out


def probe_scores(lists, q, probe_ids):
    """Paged probe (kernel K3). lists (L, P, d) float32 or bfloat16; q (B, d)
    of the lists' dtype, already normalized; probe_ids (B, nprobe) int32 with
    values in [0, L). Returns (B, nprobe*P) float32:
    ``out[b, i*P + r] = dot(q[b], lists[probe_ids[b, i], r])``, UNMASKED (the
    caller masks invalid slots).

    CUDA tensors launch the kernel (or raise); CPU tensors use
    ``probe_scores_plain``."""
    _check_lists(lists, q, "q", (torch.float32, torch.bfloat16))
    if q.ndim != 2 or probe_ids.ndim != 2 or probe_ids.shape[0] != q.shape[0]:
        raise ValueError("q must be (B, d) and probe_ids (B, nprobe)")
    if probe_ids.dtype != torch.int32:
        raise TypeError(f"probe_ids must be int32, not {probe_ids.dtype}")
    if 0 in probe_ids.shape:
        raise ValueError("probe_ids must not be empty")
    _check_placed(lists, (("lists", lists), ("q", q), ("probe_ids", probe_ids)))
    if lists.device.type != "cuda":
        return probe_scores_plain(lists, q, probe_ids)
    l, p, d = lists.shape
    b, nprobe = probe_ids.shape
    out = torch.empty((b, nprobe * p), dtype=torch.float32, device=lists.device)
    name = "ivf_probe_f32" if lists.dtype == torch.float32 else "ivf_probe_bf16"
    return _launch(name, (lists, q, probe_ids), out, (l, p, d, b, nprobe))


# ---------------------------------------------------------------------------
# K4 / K5: grouped probe
# ---------------------------------------------------------------------------


def _check_grouped(lists, grouped_q, step_list, list_valid, elem_dtypes):
    _check_lists(lists, grouped_q, "grouped_q", elem_dtypes)
    if grouped_q.ndim != 3:
        raise ValueError("grouped_q must be (S, G, d)")
    s, g, _ = grouped_q.shape
    if s == 0 or not 0 < g <= GROUP_MAX:
        raise ValueError(f"grouped_q needs S > 0 and 0 < G <= {GROUP_MAX}")
    if step_list.shape != (s,) or step_list.dtype != torch.int32:
        raise ValueError("step_list must be (S,) int32")
    if list_valid.shape != lists.shape[:2] or list_valid.dtype != torch.bool:
        raise ValueError("list_valid must be (L, P) bool")
    _check_placed(lists, (("lists", lists), ("grouped_q", grouped_q),
                          ("step_list", step_list), ("list_valid", list_valid)))
    return s, g


def _grouped_plain(lists, grouped_q, step_list, list_valid, scale):
    """Shared body of the plain grouped versions, in pieces of _PLAIN_STEPS
    steps so the gathered blocks stay bounded. ``scale(dots, lo, hi, lst)``
    turns the (c, G, P) raw dots of steps [lo, hi) into scores."""
    scan_ops._assert_ieee_f32(lists)
    s, g, _ = grouped_q.shape
    p = lists.shape[1]
    out = torch.empty((s, g, p), dtype=torch.float32, device=lists.device)
    for lo in range(0, s, _PLAIN_STEPS):
        hi = min(lo + _PLAIN_STEPS, s)
        sl = step_list[lo:hi].long()
        live = sl >= 0
        lst = sl.clamp(min=0)
        blocks = lists[lst]  # (c, P, d)
        scores = scale(_batched_dots(grouped_q[lo:hi], blocks), lo, hi, lst)
        keep = list_valid[lst][:, None, :] & live[:, None, None]
        out[lo:hi] = torch.where(keep, scores, _MASKED_SCORE)
    return out


def _batched_dots(gq, blocks):
    """(c, G, d) x (c, P, d) -> (c, G, P): float32 sums of exact products for
    float operands; exact int32 dots for int8, through float32 products in
    pieces of at most 1024 along d added in int32 (see ops/scan.py)."""
    gf, bf = gq.to(torch.float32), blocks.to(torch.float32)
    if blocks.dtype != torch.int8:
        return torch.bmm(gf, bf.transpose(1, 2))
    step = scan_ops._INT8_EXACT_D
    acc = None
    for k0 in range(0, gq.shape[-1], step):
        part = torch.bmm(
            gf[:, :, k0:k0 + step], bf[:, :, k0:k0 + step].transpose(1, 2)
        ).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def grouped_scores_plain(lists, grouped_q, step_list, list_valid):
    """The function K4 computes, in plain PyTorch. Same arguments and result
    as ``grouped_scores``."""
    return _grouped_plain(
        lists, grouped_q, step_list, list_valid, lambda dots, lo, hi, lst: dots
    )


def grouped_scores(lists, grouped_q, step_list, list_valid):
    """Grouped probe (kernel K4). lists (L, P, d) float32 or bfloat16;
    grouped_q (S, G, d) of the lists' dtype, G <= 16; step_list (S,) int32
    (a list id per step, negative = padding step); list_valid (L, P) bool.
    Returns (S, G, P) float32: ``dot(grouped_q[s, g], lists[step_list[s], r])``
    where the slot is valid, -3.0e38 where it is not and over the whole tile
    of a padding step.

    CUDA tensors launch the kernel (or raise); CPU tensors use
    ``grouped_scores_plain``."""
    s, g = _check_grouped(
        lists, grouped_q, step_list, list_valid, (torch.float32, torch.bfloat16)
    )
    if lists.device.type != "cuda":
        return grouped_scores_plain(lists, grouped_q, step_list, list_valid)
    l, p, d = lists.shape
    out = torch.empty((s, g, p), dtype=torch.float32, device=lists.device)
    name = "ivf_grouped_f32" if lists.dtype == torch.float32 else "ivf_grouped_bf16"
    return _launch(name, (lists, grouped_q, step_list, list_valid), out,
                   (l, p, d, s, g))


def grouped_scores_q_plain(lists, grouped_q, step_list, list_valid, list_inv,
                           grouped_qinv):
    """The function K5 computes, in plain PyTorch: exact int32 dots, then
    ``(float(dots) * list_inv[slot]) * qinv[query]`` in that order (bit for
    bit what the kernel does), then the mask."""
    def scale(dots, lo, hi, lst):
        return (dots.to(torch.float32) * list_inv[lst][:, None, :]
                * grouped_qinv[lo:hi, :, None])

    return _grouped_plain(lists, grouped_q, step_list, list_valid, scale)


def grouped_scores_q(lists, grouped_q, step_list, list_valid, list_inv,
                     grouped_qinv):
    """Grouped probe, int8 (kernel K5). lists (L, P, d) int8, d a multiple of
    4; grouped_q (S, G, d) int8; list_inv (L, P) float32 = 1/||int8 slot|| (0
    on empty slots); grouped_qinv (S, G) float32 = 1/||int8 query||. Returns
    (S, G, P) float32 cosine scores, invalid slots and padding steps at
    -3.0e38. CUDA tensors launch the kernel (or raise); CPU tensors use the
    plain version."""
    s, g = _check_grouped(lists, grouped_q, step_list, list_valid, (torch.int8,))
    if list_inv.shape != lists.shape[:2] or list_inv.dtype != torch.float32:
        raise ValueError("list_inv must be (L, P) float32")
    if grouped_qinv.shape != (s, g) or grouped_qinv.dtype != torch.float32:
        raise ValueError("grouped_qinv must be (S, G) float32")
    _check_placed(lists, (("list_inv", list_inv), ("grouped_qinv", grouped_qinv)))
    if lists.device.type != "cuda":
        return grouped_scores_q_plain(
            lists, grouped_q, step_list, list_valid, list_inv, grouped_qinv
        )
    l, p, d = lists.shape
    out = torch.empty((s, g, p), dtype=torch.float32, device=lists.device)
    return _launch(
        "ivf_grouped_i8",
        (lists, grouped_q, step_list, list_valid, list_inv, grouped_qinv),
        out, (l, p, d, s, g),
    )


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def _exclusive_cumsum(x):
    c = torch.cumsum(x, dim=0)
    return torch.cat([c.new_zeros((1,)), c[:-1]])


def probe_lists(centroids, q, nprobe: int):
    """Normalize the queries, score them against the centroids in ONE batched
    product (a per-query product would sum in another order and near-tied
    centroids would then flip probe sets between the two probes), and take the
    top-nprobe lists. Returns (qn (B, d) float32, probe (B, nprobe) int64)."""
    scan_ops._assert_ieee_f32(centroids)
    qn = scan_ops._normalize(q.to(torch.float32))
    cscores = qn @ centroids.T
    _, probe = scan_ops.topk_last_axis(cscores, nprobe)
    return qn, probe


def quantize_queries_ivf(qn):
    """int8 queries for int8 lists: normalized values times a global 127,
    round half to even, clip to +-127 (the lists' own quantizer). Returns
    (float32 integer-valued (B, d), float32 (B,) 1/||int8 q||)."""
    qi = torch.clamp(torch.round(qn * 127.0), -127, 127)
    qinv = 1.0 / torch.clamp(torch.sqrt(torch.sum(qi * qi, dim=-1)), min=1e-30)
    return qi, qinv


def group_pairs(probe, l: int, g: int):
    """Grouping bookkeeping of the grouped probe, all on ``probe``'s device.

    probe (B, nprobe) int64 list ids. Sorts the B*nprobe (query, list) pairs
    by list (stably, so queries of one list keep their order), cuts each
    list's run into groups of g and numbers the groups in list order.
    Returns (step_list (S,) int32, step_q (S, g) int64, pair_step (B, nprobe)
    int64, pair_slot (B, nprobe) int64) with the static bound
    S = min(l, m) + m // g: every touched list contributes at most one partial
    group, full groups are bounded by m // g. Steps past the last group keep
    step_list = -1; pad slots of step_q repeat query 0 (their scores are
    never selected)."""
    b, nprobe = probe.shape
    m = b * nprobe
    dev = probe.device
    l_flat = probe.reshape(-1)
    q_flat = torch.arange(b, device=dev).repeat_interleave(nprobe)
    ls, order = torch.sort(l_flat, stable=True)  # pairs sorted by list id
    qs = q_flat[order]
    counts = torch.bincount(ls, minlength=l)
    starts = _exclusive_cumsum(counts)
    rank = torch.arange(m, device=dev) - starts[ls]
    g_in_list = rank // g
    slot = rank % g
    gbase = _exclusive_cumsum((counts + g - 1) // g)
    gid = gbase[ls] + g_in_list  # group id per sorted pair
    n_steps = int(min(l, m) + m // g)  # a host integer: no device read-back
    step_list = torch.full((n_steps,), -1, dtype=torch.int32, device=dev)
    step_list[gid] = ls.to(torch.int32)  # duplicate gids write the same list
    step_q = torch.zeros((n_steps, g), dtype=torch.int64, device=dev)
    step_q[gid, slot] = qs  # (gid, slot) pairs are unique
    # inverse map: pair (b, i) -> (its group, its slot) for selection later
    inv_gid = torch.empty((m,), dtype=torch.int64, device=dev)
    inv_gid[order] = gid
    inv_slot = torch.empty((m,), dtype=torch.int64, device=dev)
    inv_slot[order] = slot
    return (step_list, step_q,
            inv_gid.reshape(b, nprobe), inv_slot.reshape(b, nprobe))


def ivf_search_grouped(centroids, lists, list_ids, list_valid, q, nprobe, k,
                       group: int = GROUP_MAX, list_inv=None,
                       selector: str = "exact"):
    """Batch-first grouped IVF probe. centroids (L, d) float32; lists
    (L, P, d) float32 / bfloat16 / int8; list_ids (L, P) int32; list_valid
    (L, P) bool; q (B, d) float32 raw queries; list_inv (L, P) float32 is
    required for int8 lists. Returns (scores (B, kk) float32, global row ids
    (B, kk) int32), kk = min(k, nprobe*P), descending; slots beyond a
    query's valid candidates carry -3.0e38 and an arbitrary id.

    ``group`` (at most 16) is the query-group width; 16 forms the groups the
    JAX package forms. ``selector`` is accepted for signature parity: both
    values select exactly."""
    if selector not in ("exact", "approx"):
        raise ValueError(f"unknown selector {selector!r}")
    l, p, _d = lists.shape
    b = q.shape[0]
    g = int(min(group, max(8, b * nprobe)))
    qn, probe = probe_lists(centroids, q, nprobe)
    step_list, step_q, pair_step, pair_slot = group_pairs(probe, l, g)
    if lists.dtype == torch.int8:
        if list_inv is None:
            raise ValueError("int8 lists need list_inv")
        qi, qinv = quantize_queries_ivf(qn)
        grouped_q = qi.to(torch.int8)[step_q]  # (S, G, d)
        step_scores = grouped_scores_q(
            lists, grouped_q, step_list, list_valid, list_inv, qinv[step_q]
        )
    else:
        grouped_q = qn.to(lists.dtype)[step_q]
        step_scores = grouped_scores(lists, grouped_q, step_list, list_valid)
    # the kernel emits final masked scores, so selection is one gather into
    # (B, nprobe, P) + the top-k; winning ids resolve with (B, kk) gathers
    scores = step_scores[pair_step, pair_slot].reshape(b, nprobe * p)
    kk = min(k, nprobe * p)
    vals, pos = scan_ops.topk_last_axis(scores, kk)
    win_list = torch.gather(probe, -1, pos // p)
    ids = list_ids[win_list, pos % p]
    return vals, ids.to(torch.int32)


def ivf_search_paged(centroids, lists, list_ids, list_valid, q, nprobe, k):
    """Per-pair paged IVF probe for small batches (float32 / bfloat16 lists):
    no grouping bookkeeping. Same contract as ``ivf_search_grouped``."""
    _l, p, _d = lists.shape
    b = q.shape[0]
    qn, probe = probe_lists(centroids, q, nprobe)
    scores = probe_scores(
        lists, qn.to(lists.dtype).contiguous(), probe.to(torch.int32)
    )
    valid = list_valid[probe].reshape(b, nprobe * p)
    gids = list_ids[probe].reshape(b, nprobe * p)
    scores = torch.where(valid, scores, _MASKED_SCORE)
    kk = min(k, nprobe * p)
    vals, pos = scan_ops.topk_last_axis(scores, kk)
    return vals, torch.gather(gids, -1, pos).to(torch.int32)
