"""Fused exact scan: hand-written phase-1 kernels + plain phases 2 and 3.

Counterpart of ``minivectordb_tpu/ops/pallas_scan.py``. The plain scan
(ops/scan.py) writes the whole (B, C) score matrix to device memory and reads
it back for top-k. This route never materializes the scores: phase 1 fuses

    cosine matmul -> per-row 1/norm scale -> validity mask ->
    max-reduce over SUBTILE-row groups

so only (B, C/SUBTILE) subtile maxima leave the kernel — 32x fewer bytes
than the score matrix.

Exact top-k then proceeds in two cheap phases (plain PyTorch, as the JAX
package leaves them to XLA):
  Phase 2: top-(k + margin) over subtile maxima (small tensor).
  Phase 3: gather the winning subtiles' rows (chunked over queries so the
           gather stays tens of MB), rescore exactly (IEEE float32), final
           top-k.

Exactness argument: if row r is among the true top-k, its subtile's max is
>= score(r) >= (k-th best score); at most k-1 subtiles can have maxima
strictly greater (each such max is itself a top-k row's score), so r's
subtile always ranks within the top-k subtile maxima. Phase 1 need not be
exact for that: phase 3 rescores the winners in IEEE float32 and is
authoritative, so the returned scores are IEEE whatever phase 1's rounding.
Let eps bound phase 1's error on a subtile maximum. A subtile holding a true
top-k row can then be outranked only by subtiles whose maxima lie within
2 eps of it, i.e. that hold a row scoring within 2 eps of the k-th best;
the extra ``margin`` subtiles absorb those, and where more than ``margin``
such rows crowd the k-th place, only rows whose exact scores lie within
2 eps of each other can trade places (IEEE summation order alone already
swaps such ties). float32's kernel forms its products in 3xTF32 (below):
eps about 1e-6 on cosine scores of random rows, up to 1e-5 where a row
equals the query (the tensor cores' accumulation); the bfloat16 shadow of
``mixed`` mode rounds maxima by up to 2^-8 relative, at margin 8.

Phase 1 on a CUDA tensor is the CUDA C++ kernel of ``csrc/phase1.cu`` (K1:
float32 and bfloat16; K2: int8), compiled at first use
(kernels/build.py). ``subtile_maxima`` and ``subtile_maxima_int8`` launch it
for CUDA tensors and raise on what it does not take; they use the plain
versions below ONLY for tensors that lie on the CPU. ``LAUNCHES`` counts
kernel launches per instantiation. Rows of a whole number of 16 bytes (what
TMA can describe) take a Hopper kernel: ``wgmma`` fed by a TMA ring, in
3xTF32 for float32 (each float32 word read as TF32 is its hi, truncated;
lo = x - hi; a_lo b_hi + a_hi b_lo + a_hi b_hi summed in float32, which
``subtile_maxima_3xtf32_plain`` repeats), on bf16 / int8 values as they lie
for the others. Narrower rows (float32 at d = 25, int8 at d = 24, say) take
the narrow kernels (IEEE FMAs on the CUDA cores for float32, ``mma.sync``
for bf16 / int8), chosen by row width alone. The library's
``phase1_route`` says which a launch took; the narrow kernels' launches are
counted in ``NARROW_LAUNCHES`` instead. The plain versions stay IEEE.

Layout: ``subtile_maxima`` returns **(B, C/SUBTILE)**. The JAX function
returns the transpose, (C/SUBTILE, B), a constraint of its compiler, and its
caller transposes at once.

Ties. Every top-k here is ``ops/scan.py:topk_last_axis``: among equal values
the lower position wins. In phase 3 "position" is the place in the gathered
candidate list (subtiles in phase-2 order, rows in order inside a subtile),
not the row id — the JAX package's order too. So duplicate rows come back in
the same order as from the JAX package whenever phase 1 gives both packages
the same maxima ordering; where rounding orders two near-equal subtile
maxima differently, tied rows may swap (their scores are equal either way).
"""

from __future__ import annotations

import ctypes

import torch

from minivectordb_tpu_torch.kernels import build
from minivectordb_tpu_torch.ops import scan as scan_ops
from minivectordb_tpu_torch.ops.tf32 import matmul_3xtf32

_MASKED_SCORE = float(scan_ops._MASKED_SCORE)

SUBTILE = 32  # rows per max-reduce group
_PHASE3_CHUNK = 64  # queries per phase-3 gather step
_PLAIN_ROWS = 1 << 16  # rows per step of the plain versions

# Kernel launches per instantiation of csrc/phase1.cu's kernel: its C entry
# point, plus "_mask" for the masked form. Incremented in _launch, where the
# kernel is launched, and nowhere else.
LAUNCHES = {
    "phase1_f32": 0, "phase1_f32_mask": 0,
    "phase1_bf16": 0, "phase1_bf16_mask": 0,
    "phase1_i8": 0, "phase1_i8_mask": 0,
}


# Launches of the narrow kernels that rows narrower than TMA can describe take
# (csrc/phase1.cu, phase1_route), by the same names.
NARROW_LAUNCHES = {
    "phase1_f32": 0, "phase1_f32_mask": 0, "phase1_bf16": 0, "phase1_bf16_mask": 0,
    "phase1_i8": 0, "phase1_i8_mask": 0,
}


def reset_launches() -> None:
    for counts in (LAUNCHES, NARROW_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t itself where its data starts on a 16-byte boundary (every fresh
    allocation does), else an aligned copy: TMA and 16-byte copies need it."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # buf, q, inv, mask, out, C, d, B, count, stream
    "phase1_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "phase1_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # buf, qi, inv, qinv, mask, out, C, d, B, count, stream
    "phase1_i8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}
_fns: dict = {}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = build.load_library("phase1")
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES.get(name, [_I, _I])  # phase1_route: d, itemsize
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_operands(buf, inv_norms, q, mask, elem_dtypes) -> tuple[int, int, int]:
    """What the kernel takes; anything else raises (no fall-back)."""
    if buf.ndim != 2 or q.ndim != 2:
        raise ValueError("buf must be (C, d) and q (B, d)")
    c, d = buf.shape
    b = q.shape[0]
    if buf.dtype not in elem_dtypes:
        raise TypeError(f"buf dtype {buf.dtype} not in {elem_dtypes}")
    if q.dtype != buf.dtype:
        raise TypeError(f"q is {q.dtype}, buf is {buf.dtype}: types must match")
    if q.shape[1] != d:
        raise ValueError(f"q has dim {q.shape[1]}, buf has {d}")
    if c % SUBTILE or c == 0 or b == 0:
        raise ValueError(f"C={c} must be a positive multiple of {SUBTILE}; B={b} > 0")
    if (d * buf.element_size()) % 4:
        raise ValueError(
            f"a row of d={d} {buf.dtype} values is not a whole number of "
            "32-bit words"
        )
    if inv_norms.shape != (c,) or inv_norms.dtype != torch.float32:
        raise ValueError("inv_norms must be (C,) float32")
    if mask is not None and (mask.shape != (c,) or mask.dtype != torch.bool):
        raise ValueError("mask must be (C,) bool")
    for name, t in (("buf", buf), ("q", q), ("inv_norms", inv_norms), ("mask", mask)):
        if t is None:
            continue
        if t.device != buf.device:
            raise ValueError(f"{name} lies on {t.device}, buf on {buf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return c, d, b


def _launch(name: str, buf, args_before_mask, mask, c, d, b, count):
    """Allocate the output, launch on the current stream, do not synchronise."""
    fn = _kernel_fn(name)
    args_before_mask = [_aligned16(t) for t in args_before_mask]
    mask = None if mask is None else _aligned16(mask)
    counts = LAUNCHES
    if not _kernel_fn("phase1_route")(d, buf.element_size()):
        counts = NARROW_LAUNCHES
    out = torch.empty((b, c // SUBTILE), dtype=torch.float32, device=buf.device)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            *[t.data_ptr() for t in args_before_mask],
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), c, d, b, int(count), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    counts[name if mask is None else name + "_mask"] += 1
    return out


# ---------------------------------------------------------------------------
# Phase 1: kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def subtile_maxima_plain(buf, inv_norms, q, count, mask=None):
    """The function K1 computes, in plain PyTorch, in row pieces so the
    (B, C) score matrix never exists whole. Same arguments and result as
    ``subtile_maxima``; float32 dots are IEEE float32."""
    return _plain_maxima(buf, inv_norms, q, count, mask, scan_ops.dots_f32)


def subtile_maxima_3xtf32_plain(buf, inv_norms, q, count, mask=None):
    """K1-f32's arithmetic on the tensor cores in plain PyTorch, for tests
    and chip_smoke.py only (the kernel's plain version stays the IEEE
    ``subtile_maxima_plain``): each dot from three TF32 products of the
    float32 words truncated to TF32 (hi) and of their truncated remainders
    (lo), q_lo buf_hi + q_hi buf_lo + q_hi buf_hi summed in float32
    (``tf32.matmul_3xtf32(rounding="zero")``), then the same scale, mask and
    32-row max. float32 only."""
    if buf.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError(f"the 3xTF32 form is float32's, not {buf.dtype}'s")

    def dots(qq, rows):
        return matmul_3xtf32(qq, rows.T, rounding="zero")

    return _plain_maxima(buf, inv_norms, q, count, mask, dots)


def _plain_maxima(buf, inv_norms, q, count, mask, dots):
    c = buf.shape[0]
    b = q.shape[0]
    out = torch.empty((b, c // SUBTILE), dtype=torch.float32, device=buf.device)
    rows = torch.arange(c, device=buf.device)
    for lo in range(0, c, _PLAIN_ROWS):
        hi = min(lo + _PLAIN_ROWS, c)
        scores = dots(q, buf[lo:hi]) * inv_norms[None, lo:hi]
        valid = rows[lo:hi] < count
        if mask is not None:
            valid = valid & mask[lo:hi]
        scores = scores.masked_fill(~valid[None, :], _MASKED_SCORE)
        out[:, lo // SUBTILE:hi // SUBTILE] = scores.reshape(
            b, (hi - lo) // SUBTILE, SUBTILE
        ).amax(dim=-1)
    return out


def subtile_maxima(buf, inv_norms, q, count, mask=None):
    """Phase 1 (kernel K1). buf (C, d) float32 or bfloat16, C a multiple of
    32; q (B, d) of buf's dtype, already normalized; inv_norms (C,) float32;
    mask optional (C,) bool; count the number of live rows (an int).

    Returns (B, C/SUBTILE) float32: for each query and each 32-row subtile,
    the max of ``dot(row, q) * inv_norms[row]`` over the subtile's rows with
    ``row < count`` and ``mask[row]``; -3.0e38 where there is none. (The JAX
    ``subtile_maxima`` returns the transpose of this.)

    CUDA tensors launch the kernel (or raise); CPU tensors use
    ``subtile_maxima_plain``."""
    c, d, b = _check_operands(
        buf, inv_norms, q, mask, (torch.float32, torch.bfloat16)
    )
    if buf.device.type != "cuda":
        return subtile_maxima_plain(buf, inv_norms, q, count, mask)
    name = "phase1_f32" if buf.dtype == torch.float32 else "phase1_bf16"
    return _launch(name, buf, (buf, q, inv_norms), mask, c, d, b, count)


def subtile_maxima_int8_plain(buf_i8, inv_norms_i8, qi, q_inv, count, mask=None):
    """The function K2 computes, in plain PyTorch: exact int32 dots, then
    ``float(dots) * inv[row] * qinv[query]`` in that order (bit for bit what
    the kernel does), mask, 32-row max."""
    c = buf_i8.shape[0]
    b = qi.shape[0]
    out = torch.empty((b, c // SUBTILE), dtype=torch.float32, device=buf_i8.device)
    rows = torch.arange(c, device=buf_i8.device)
    for lo in range(0, c, _PLAIN_ROWS):
        hi = min(lo + _PLAIN_ROWS, c)
        dots = scan_ops.dots_int8(qi, buf_i8[lo:hi]).to(torch.float32)
        scores = dots * inv_norms_i8[None, lo:hi] * q_inv[:, None]
        valid = rows[lo:hi] < count
        if mask is not None:
            valid = valid & mask[lo:hi]
        scores = scores.masked_fill(~valid[None, :], _MASKED_SCORE)
        out[:, lo // SUBTILE:hi // SUBTILE] = scores.reshape(
            b, (hi - lo) // SUBTILE, SUBTILE
        ).amax(dim=-1)
    return out


def subtile_maxima_int8(buf_i8, inv_norms_i8, qi, q_inv, count, mask=None):
    """Phase 1, int8 (kernel K2). buf_i8 (C, d) int8, d a multiple of 4;
    qi (B, d) int8 pre-quantized queries; q_inv (B,) float32 = 1/||qi||, so
    positive (the kernel scales a subtile's maximum by it, which equals the
    maximum of the scaled scores only for a positive factor).
    Returns (B, C/SUBTILE) float32 subtile maxima of int8-cosine scores.
    CUDA tensors launch the kernel (or raise); CPU tensors use the plain
    version."""
    c, d, b = _check_operands(buf_i8, inv_norms_i8, qi, mask, (torch.int8,))
    if q_inv.shape != (b,) or q_inv.dtype != torch.float32:
        raise ValueError("q_inv must be (B,) float32")
    if q_inv.device != buf_i8.device or not q_inv.is_contiguous():
        raise ValueError("q_inv must be contiguous on buf's device")
    if buf_i8.device.type != "cuda":
        return subtile_maxima_int8_plain(
            buf_i8, inv_norms_i8, qi, q_inv, count, mask
        )
    return _launch(
        "phase1_i8", buf_i8, (buf_i8, qi, inv_norms_i8, q_inv), mask,
        c, d, b, count,
    )


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------

_SUPER = 32  # subtiles per supertile (1024 rows) for two-level phase 2


def _phase2_topk_subtiles(maxima, n_sub):
    """Select the top-n_sub subtiles from (bp, n_subtiles) maxima.

    Two-level EXACT reduction, so the wide top-k never runs over all C/32
    maxima: max-reduce groups of 32 subtiles into supertile maxima,
    top-n_sub over C/1024 supertiles, then top-n_sub over the selected
    supertiles' 32*n_sub subtile maxima. Exactness: a top-n_sub subtile's
    supertile always ranks in the top n_sub supertiles (at most n_sub-1
    supertiles can hold a strictly greater subtile max).
    """
    bp, ns = maxima.shape
    nsup = ns // _SUPER
    if ns % _SUPER or n_sub >= nsup or nsup < 4:
        return scan_ops.topk_last_axis(maxima, n_sub)[1]
    grouped = maxima.reshape(bp, nsup, _SUPER)
    sup = grouped.amax(dim=-1)
    sup_idx = scan_ops.topk_last_axis(sup, n_sub)[1]  # (bp, n_sub) supertiles
    gathered = torch.gather(
        grouped, 1, sup_idx[..., None].expand(bp, n_sub, _SUPER)
    )
    base = sup_idx[..., None] * _SUPER + torch.arange(
        _SUPER, device=maxima.device
    )
    pos = scan_ops.topk_last_axis(gathered.reshape(bp, n_sub * _SUPER), n_sub)[1]
    return torch.gather(base.reshape(bp, n_sub * _SUPER), -1, pos)


# ---------------------------------------------------------------------------
# Phase 3 + the public fused scans
# ---------------------------------------------------------------------------


def _padded_batch(b: int) -> int:
    """Batches pad to a power of two >= 8 (the shapes the JAX package runs;
    the kernel itself takes any B)."""
    return max(8, 1 << (b - 1).bit_length())


def _pad_rows(t: torch.Tensor, bp: int) -> torch.Tensor:
    b = t.shape[0]
    if bp == b:
        return t
    return torch.cat([t, t.new_zeros((bp - b,) + tuple(t.shape[1:]))])


def _phase3(score_chunk, bp, sub_idx, count, sub_mask, k_wide):
    """Gather the winning subtiles and rescore, in query chunks (a full-batch
    gather would materialize B*n_sub*SUBTILE*d values). ``score_chunk(lo,
    hi, sidx)`` returns the (ch, n_sub, SUBTILE) exact scores of one chunk."""
    vals_out, idx_out = [], []
    lane = torch.arange(SUBTILE, device=sub_idx.device)
    for lo in range(0, bp, _PHASE3_CHUNK):
        hi = min(lo + _PHASE3_CHUNK, bp)
        sidx = sub_idx[lo:hi]  # (ch, n_sub)
        scores = score_chunk(lo, hi, sidx)
        gids = sidx[:, :, None] * SUBTILE + lane
        valid = gids < count
        if sub_mask is not None:
            valid = valid & sub_mask[sidx]
        scores = scores.masked_fill(~valid, _MASKED_SCORE)
        ch = hi - lo
        vals, pos = scan_ops.topk_last_axis(scores.reshape(ch, -1), k_wide)
        vals_out.append(vals)
        idx_out.append(torch.gather(gids.reshape(ch, -1), -1, pos))
    return torch.cat(vals_out), torch.cat(idx_out)


def fused_scan_topk_int8(buf_i8, inv_norms_i8, q, count, k, mask=None,
                         margin: int | None = None):
    """Int8 fused scan + top-k (the usearch-equivalent metric) via the
    two-phase subtile-max scheme. Scores are int8-cosine similarities — the
    metric of ops/scan.py:scan_topk_int8, so phase 3's int8 rescore is
    authoritative (no float refine needed).

    buf_i8 (C, d) int8 with C >= 4096 a capacity bucket; q (B, d) float32;
    mask optional (C,) bool. Returns (values (B, k) f32, indices (B, k)
    int32), descending."""
    c, d = buf_i8.shape
    b = q.shape[0]
    bp = _padded_batch(b)
    qi, q_inv = scan_ops.quantize_queries_int8(_pad_rows(q.to(torch.float32), bp))

    maxima = subtile_maxima_int8(buf_i8, inv_norms_i8, qi, q_inv, count, mask)

    if margin is None:
        margin = 16
    n_sub = min(k + margin, c // SUBTILE)
    sub_idx = _phase2_topk_subtiles(maxima, n_sub)

    sub_buf = buf_i8.reshape(c // SUBTILE, SUBTILE, d)
    sub_inv = inv_norms_i8.reshape(c // SUBTILE, SUBTILE)
    sub_mask = None if mask is None else mask.reshape(c // SUBTILE, SUBTILE)
    kk = min(k, n_sub * SUBTILE)

    def score_chunk(lo, hi, sidx):
        cand = sub_buf[sidx].reshape(hi - lo, n_sub * SUBTILE, d)
        dots = _batched_dots_int8(qi[lo:hi], cand).to(torch.float32)
        dots = dots.reshape(hi - lo, n_sub, SUBTILE)
        return dots * sub_inv[sidx] * q_inv[lo:hi, None, None]

    vals, idx = _phase3(score_chunk, bp, sub_idx, count, sub_mask, kk)
    return vals[:b], idx[:b].to(torch.int32)


def _batched_dots_int8(qi, cand):
    """(ch, d) int8 x (ch, N, d) int8 -> (ch, N) int32, exact: float32
    products of int8 values in pieces of at most 1024 along d, pieces added
    in int32 (see ops/scan.py)."""
    d = qi.shape[1]
    step = scan_ops._INT8_EXACT_D
    qf = qi.to(torch.float32)
    cf = cand.to(torch.float32)
    acc = None
    for k0 in range(0, d, step):
        part = torch.bmm(
            cf[:, :, k0:k0 + step], qf[:, k0:k0 + step, None]
        ).squeeze(-1).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def fused_scan_topk(buf, inv_norms, q, count, k, mask=None,
                    margin: int | None = None, scan_buf=None):
    """Exact fused scan + top-k without materializing (B, C) scores.

    buf: (C, d) float32/bfloat16, C >= 4096 and a capacity bucket (a power
    of two, or a 2^21-multiple above the linear bucket tier — see
    ops/scan.py:capacity_bucket); q: (B, d) float32; count: live rows (int);
    mask: optional (C,) bool.
    Returns (values (B, k) f32, indices (B, k) int32), descending.

    scan_buf: optional lower-precision shadow of buf (bfloat16) used ONLY
    for phase-1 subtile selection ("mixed" mode: phase 1 reads half the
    bytes); phase 3 always gathers + rescores from `buf`, so returned scores
    are exact for a float32 `buf` and recall is governed by `margin`
    absorbing the shadow's rounding of subtile maxima.

    margin: extra subtiles kept by phase 2. Default 16; 8 with a shadow (it
    only has to absorb bf16 rounding of SUBTILE MAXIMA, <= 2^-8 relative,
    and phase-3 cost grows with it); core/store.py passes 0 for 'approx'.
    """
    scan_ops._assert_ieee_f32(buf)
    c, d = buf.shape
    b = q.shape[0]
    bp = _padded_batch(b)
    qn = _pad_rows(scan_ops._normalize(q.to(torch.float32)), bp)

    p1_buf = buf if scan_buf is None else scan_buf
    maxima = subtile_maxima(
        p1_buf, inv_norms, qn.to(p1_buf.dtype).contiguous(), count, mask
    )  # (bp, C/SUBTILE)

    if margin is None:
        margin = 8 if scan_buf is not None else 16
    n_sub = min(k + margin, c // SUBTILE)
    sub_idx = _phase2_topk_subtiles(maxima, n_sub)  # (bp, n_sub) subtile ids

    sub_buf = buf.reshape(c // SUBTILE, SUBTILE, d)
    sub_inv = inv_norms.reshape(c // SUBTILE, SUBTILE)
    sub_mask = None if mask is None else mask.reshape(c // SUBTILE, SUBTILE)
    k_wide = min(k, n_sub * SUBTILE)
    # a bfloat16 buffer rescores from its own bf16 values with the query
    # rounded to bf16, products exact and summed in float32
    q3 = qn.to(buf.dtype).to(torch.float32)

    def score_chunk(lo, hi, sidx):
        cand = sub_buf[sidx].reshape(hi - lo, n_sub * SUBTILE, d)
        scores = torch.bmm(
            cand.to(torch.float32), q3[lo:hi, :, None]
        ).squeeze(-1)
        return scores.reshape(hi - lo, n_sub, SUBTILE) * sub_inv[sidx]

    vals, idx = _phase3(score_chunk, bp, sub_idx, count, sub_mask, k_wide)
    return vals[:b], idx[:b].to(torch.int32)
