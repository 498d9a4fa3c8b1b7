"""Flash attention with segment ids: the encoder's attention kernel (K6).

The JAX package has no module of its own for this: ``models/encoder.py``
(``_attention``, the flash branch) calls JAX's Pallas TPU kernel
``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention`` with
``SegmentIds(q=seg, kv=seg)``. The port's counterpart is written by hand in
``csrc/flash_attention.cu`` (compiled at first use, kernels/build.py), with its
wrapper and its plain PyTorch version here.

The function, for q, k, v of shape (B, nh, S, hd) and segment ids (B, S):

    s[b, h, i, j] = dot(q[b, h, i], k[b, h, j]) * sm_scale   if seg[b, i] == seg[b, j]
                    MASK_VALUE                               otherwise
    out[b, h, i]  = sum_j softmax_j(s[b, h, i, :]) * v[b, h, j]

with the logits, the softmax and both sums in float32 and the result cast to
q's type. ``MASK_VALUE`` is the TPU kernel's finite ``-0.7 * float32 max``.
Segment ids, not a key-padding mask: the encoder passes its attention mask
(real tokens 1, pads 0), so a pad query attends to the pad keys of its own
row, and every query sees at least itself.

Layout. The public functions take (B, nh, S, hd) like the TPU kernel, with ANY
batch, head and sequence strides as long as the last axis is contiguous: the
kernel is given the strides, so the encoder passes transposed views of its
(B, S, nh*hd) projections and no transposed copy is made on the way in. The
result has q's strides (``torch.empty_like``), so transposing it back and
flattening the heads is a view as well. q, k and v must share their strides
and start every row on a 16-byte boundary; tensors that do not are copied to
contiguous ones first.

On a CUDA tensor ``flash_attention`` launches the kernel or raises (a type or
head width the kernel does not take, a failed build); ``flash_attention_plain``
serves tensors that lie on the CPU, and only those. ``LAUNCHES`` counts kernel
launches per C entry point. The kernel takes any S >= 1; which sequences the
encoder sends here is the encoder's gate (models/encoder.py).

Training. When grad mode is on and an input requires grad, ``flash_attention``
goes through ``FlashAttention`` (a ``torch.autograd.Function``), as JAX's
kernel goes through its custom VJP. Its forward is K6 with the row statistic
the backward needs, ``lse[b, h, i] = log sum_j exp(s[b, h, i, j])`` in float32
(``flash_attention_lse``); its backward is two more kernels written by hand,
in ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``), which replace
the TPU kernel's ``_flash_attention_bwd_dkv`` (K7: dK, dV) and
``_flash_attention_bwd_dq`` (K8: dQ):

    P  = exp(s - lse)            (0 where the segments differ)
    dV = P^T dO,   dS = P * (dO V^T - rowsum(dO * O)),
    dK = dS^T Q * sm_scale,   dQ = dS K * sm_scale

K7 and K8 exist for float32, the training path's type; a bfloat16 backward
on the card raises (ROADMAP queue 2). On CPU tensors both directions use the
plain versions, ``flash_attention_lse_plain`` and ``flash_attention_bwd_plain``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from minivectordb_tpu_torch.kernels import build
from minivectordb_tpu_torch.ops import scan as scan_ops

# float32(-0.7 * float32 max): what a query scores against a key of another
# segment. Finite, so a row of masked logits has a softmax and no NaN.
MASK_VALUE = float(np.float32(-0.7 * float(np.finfo(np.float32).max)))

HEAD_DIMS = tuple(range(16, 129, 16))  # the widths the kernel is instantiated for
_PLAIN_LOGIT_BYTES = 256 << 20  # (rows, nh, S, S) float32 logits per piece

# Kernel launches per C entry point of csrc/flash_attention.cu (K6; the _lse_
# ones also write the row log-sum-exp) and csrc/flash_attention_bwd.cu (K7,
# K8). Incremented where each kernel is launched, and nowhere else.
LAUNCHES = {
    "flash_attention_f32": 0, "flash_attention_bf16": 0,
    "flash_attention_lse_f32": 0, "flash_attention_lse_bf16": 0,
    "flash_attention_bwd_dkv_f32": 0, "flash_attention_bwd_dq_f32": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# q, k, v, seg, out, [lse,] B, NH, S, HD, in strides (b, h, s), out strides
# (b, h, s), sm_scale, stream
_FWD = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, ctypes.c_float, _P]
_FWD_LSE = _FWD[:5] + [_P] + _FWD[5:]
# q, k, v, dout, lse, delta, seg, outputs (dk, dv | dq), B, NH, S, HD, strides of
# q/k/v, of dout and of the outputs (b, h, s), sm_scale, stream
_BWD = [_I, _I, _I, _I] + [_L] * 9 + [ctypes.c_float, _P]
_ARGTYPES = {
    "flash_attention_f32": _FWD,
    "flash_attention_bf16": _FWD,
    "flash_attention_lse_f32": _FWD_LSE,
    "flash_attention_lse_bf16": _FWD_LSE,
    "flash_attention_bwd_dkv_f32": [_P] * 9 + _BWD,
    "flash_attention_bwd_dq_f32": [_P] * 8 + _BWD,
}
# the source (csrc/<name>.cu) of each entry point
_SOURCE = {name: "flash_attention_bwd" if "_bwd_" in name else "flash_attention"
           for name in LAUNCHES}
_fns: dict = {}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = build.load_library(_SOURCE[name])
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k, v, segment_ids) -> None:
    if q.ndim != 4:
        raise ValueError("q, k, v must be (B, nh, S, hd)")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} must "
            "have one shape (self-attention)"
        )
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q is {q.dtype}: float32 or bfloat16 expected")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q is {q.dtype}, k {k.dtype}, v {v.dtype}: types must match")
    if 0 in q.shape:
        raise ValueError("q must not be empty")
    if segment_ids.shape != (q.shape[0], q.shape[2]):
        raise ValueError(
            f"segment_ids must be (B, S) = {(q.shape[0], q.shape[2])}, "
            f"not {tuple(segment_ids.shape)}"
        )
    if segment_ids.dtype != torch.int32:
        raise TypeError(f"segment_ids must be int32, not {segment_ids.dtype}")
    for name, t in (("k", k), ("v", v), ("segment_ids", segment_ids)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")


def _plain_pieces(q, segment_ids):
    """Batch-row slices that keep the plain versions' (rows, nh, S, S)
    float32 matrices bounded."""
    b, nh, s, _hd = q.shape
    rows = max(1, _PLAIN_LOGIT_BYTES // (nh * s * s * 4))
    for lo in range(0, b, rows):
        yield slice(lo, min(lo + rows, b))


def _plain_logits(q, k, segment_ids, sm_scale: float):
    """float32 logits of one piece with ``MASK_VALUE`` where the segments
    differ."""
    logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    logits = logits * sm_scale
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    return torch.where(same, logits, MASK_VALUE)


def flash_attention_plain(q, k, v, segment_ids, sm_scale: float):
    """The function K6 computes, in plain PyTorch: float32 logits, the
    segment-equality mask with ``MASK_VALUE``, float32 softmax, float32 P V,
    cast to q's type. Batch rows go in pieces so the (rows, nh, S, S) logits
    stay bounded. Same arguments and result as ``flash_attention``; autograd
    differentiates it."""
    return _plain_forward(q, k, v, segment_ids, sm_scale, with_lse=False)[0]


def flash_attention_lse_plain(q, k, v, segment_ids, sm_scale: float):
    """``flash_attention_plain``'s result and the rows' log-sum-exp of the
    masked float32 logits, (B, nh, S) float32: what K6 computes with its
    row statistic (``flash_attention_lse``)."""
    return _plain_forward(q, k, v, segment_ids, sm_scale, with_lse=True)


def _plain_forward(q, k, v, segment_ids, sm_scale: float, with_lse: bool):
    _check(q, k, v, segment_ids)
    scan_ops._assert_ieee_f32(q)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    for sl in _plain_pieces(q, segment_ids):
        logits = _plain_logits(q[sl], k[sl], segment_ids[sl], sm_scale)
        if with_lse:
            lse[sl] = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        out[sl] = torch.matmul(probs, v[sl].to(torch.float32)).to(q.dtype)
    return out, lse


def _check_bwd(q, out, dout, lse) -> None:
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}: q's shape, "
                "type and device expected"
            )
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(
            f"lse is {tuple(lse.shape)} {lse.dtype} on {lse.device}: "
            f"{tuple(q.shape[:3])} float32 on q's device expected"
        )


def flash_attention_bwd_plain(q, k, v, segment_ids, out, dout, lse, sm_scale: float):
    """The function K7 and K8 compute, in plain PyTorch, in float32 and in
    pieces of batch rows: P = exp(masked logits - lse) (the masked logits'
    exp underflows to 0, as in the TPU kernel), delta = rowsum(dO * O),
    dV = P^T dO, dS = P * (dO V^T - delta), dK = dS^T Q * sm_scale and
    dQ = dS K * sm_scale. Returns (dq, dk, dv) in q's type."""
    _check(q, k, v, segment_ids)
    _check_bwd(q, out, dout, lse)
    scan_ops._assert_ieee_f32(q)
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)]
    for sl in _plain_pieces(q, segment_ids):
        qf, kf, vf, dof = (t[sl].to(torch.float32) for t in (q, k, v, dout))
        delta = torch.sum(out[sl].to(torch.float32) * dof, dim=-1)
        p = torch.exp(_plain_logits(q[sl], k[sl], segment_ids[sl], sm_scale)
                      - lse[sl][..., None])
        ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
        grads[0][sl] = (torch.matmul(ds, kf) * sm_scale).to(q.dtype)
        grads[1][sl] = (torch.matmul(ds.transpose(-1, -2), qf) * sm_scale).to(q.dtype)
        grads[2][sl] = torch.matmul(p.transpose(-1, -2), dof).to(q.dtype)
    return tuple(grads)


def tile_shape(dtype, hd: int) -> tuple[int, int]:
    """(query rows, keys) of one tile of the kernel that serves (dtype, hd):
    bfloat16 128 x 128; float32 128 x 64, or 64 x 64 at hd = 128
    (csrc/flash_attention.cu: BF_BM, BF_KT; F32Cfg::BM, BN)."""
    if dtype == torch.bfloat16:
        return 128, 128
    return (64 if hd == 128 else 128), 64


def visited_tiles(segment_ids, rows: int, keys: int) -> int:
    """How many (batch row, query tile, key tile) blocks of the (S, S) logits
    the kernels multiply, per head: those whose ranges of segment ids [min,
    max] meet, over the rows and keys below S (the kernels' skipping rule).
    Measurement only: chip_smoke.py counts the operations the kernel did with
    it beside the ones the data needs."""
    b, s = segment_ids.shape

    def ranges(t):
        n = -(-s // t)
        pad = n * t - s
        seg = segment_ids.to(torch.int64)
        lo = torch.cat([seg, seg.new_full((b, pad), 2**62)], 1).view(b, n, t).amin(-1)
        hi = torch.cat([seg, seg.new_full((b, pad), -2**62)], 1).view(b, n, t).amax(-1)
        return lo, hi

    qlo, qhi = ranges(rows)
    klo, khi = ranges(keys)
    apart = (khi[:, None, :] < qlo[:, :, None]) | (klo[:, None, :] > qhi[:, :, None])
    return int((~apart).sum())


def _kernel_ready(t) -> bool:
    """Unit stride along hd and every row on a 16-byte boundary."""
    per16 = 16 // t.element_size()
    return (
        t.stride(3) == 1
        and t.data_ptr() % 16 == 0
        and all(st % per16 == 0 for st in t.stride()[:3])
    )


def _kernel_operands(q, k, v, segment_ids):
    """q, k, v as the kernels take them (one set of strides, 16-byte rows,
    else contiguous copies) and contiguous segment ids; raises on a head
    width the kernels are not built for."""
    hd = q.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(
            f"head width {hd} is not one the kernel is built for {HEAD_DIMS}"
        )
    if not (_kernel_ready(q) and _kernel_ready(k) and _kernel_ready(v)
            and q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v, segment_ids.contiguous()


def _launch(name: str, q, *args) -> None:
    """Launches entry point ``name`` on q's device and current stream with
    ``args`` after q's pointer; counts the launch."""
    fn = _kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1


def _forward(q, k, v, segment_ids, sm_scale: float, with_lse: bool):
    """K6 on CUDA tensors: (out, lse or None)."""
    b, nh, s, hd = q.shape
    q, k, v, segment_ids = _kernel_operands(q, k, v, segment_ids)
    out = torch.empty_like(q)  # q's layout; the kernel is given out's own strides
    kind = "f32" if q.dtype == torch.float32 else "bf16"
    lse = None
    ptrs = [k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), out.data_ptr()]
    if with_lse:
        lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
        ptrs.append(lse.data_ptr())
    name = f"flash_attention_lse_{kind}" if with_lse else f"flash_attention_{kind}"
    _launch(name, q, *ptrs, b, nh, s, hd, *q.stride()[:3], *out.stride()[:3],
            float(sm_scale))
    return out, lse


def flash_attention(q, k, v, segment_ids, sm_scale: float):
    """Attention within segments (kernel K6). q, k, v (B, nh, S, hd) float32
    or bfloat16, one shape and type; segment_ids (B, S) int32; returns
    (B, nh, S, hd) of q's type with q's strides (see the module docstring for
    the function and the layout).

    CUDA tensors launch the kernel (or raise); CPU tensors use
    ``flash_attention_plain``. With grad mode on and an input that requires
    grad, the call goes through ``FlashAttention`` (K6 with lse forward, K7
    and K8 backward)."""
    _check(q, k, v, segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type == "cuda" and q.dtype != torch.float32:
            raise NotImplementedError(
                "flash attention's backward is ported for float32 only; the bfloat16 "
                "K7/K8 are still to port (ROADMAP queue 2)"
            )
        return FlashAttention.apply(q, k, v, segment_ids, sm_scale)
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, segment_ids, sm_scale)
    return _forward(q, k, v, segment_ids, sm_scale, with_lse=False)[0]


def flash_attention_lse(q, k, v, segment_ids, sm_scale: float):
    """``flash_attention``'s result and each row's log-sum-exp of the masked,
    scaled float32 logits, (B, nh, S) float32 contiguous: K6 writing its row
    statistic from the epilogue (``flash_attention_lse_f32`` / ``_bf16``).
    CPU tensors use ``flash_attention_lse_plain``."""
    _check(q, k, v, segment_ids)
    if q.device.type != "cuda":
        return flash_attention_lse_plain(q, k, v, segment_ids, sm_scale)
    return _forward(q, k, v, segment_ids, sm_scale, with_lse=True)


def flash_attention_bwd(q, k, v, segment_ids, out, dout, lse, sm_scale: float):
    """(dq, dk, dv) of attention within segments, given the forward's ``out``
    and ``lse`` and the gradient ``dout`` of out: K7 (dK, dV) then K8 (dQ),
    float32, on CUDA tensors (or raise); CPU tensors use
    ``flash_attention_bwd_plain``. delta = rowsum(dO * O) is one torch.sum
    here, as JAX computes it outside its kernels. The gradients have q's
    strides; dout may have any strides (autograd chooses them)."""
    _check(q, k, v, segment_ids)
    _check_bwd(q, out, dout, lse)
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, segment_ids, out, dout, lse, sm_scale)
    if q.dtype != torch.float32:
        raise NotImplementedError(
            "flash attention's backward kernels are ported for float32 only; the "
            "bfloat16 K7/K8 are still to port (ROADMAP queue 2)"
        )
    ops = _bwd_operands(q, k, v, segment_ids, out, dout, lse)
    dk, dv = _bwd_dkv(*ops, sm_scale)
    return _bwd_dq(*ops, sm_scale), dk, dv


def _bwd_operands(q, k, v, segment_ids, out, dout, lse):
    """(q, k, v, segment_ids, dout, lse, delta) as K7 and K8 take them, with
    delta = rowsum(dO * O) (B, nh, S) float32."""
    q, k, v, segment_ids = _kernel_operands(q, k, v, segment_ids)
    if not _kernel_ready(dout):
        dout = dout.contiguous()
    delta = torch.sum(out * dout, dim=-1).contiguous()
    return q, k, v, segment_ids, dout, lse.contiguous(), delta


def _bwd_launch(name, q, k, v, segment_ids, dout, lse, delta, grads, sm_scale) -> None:
    b, nh, s, hd = q.shape
    _launch(name, q, k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), segment_ids.data_ptr(), *(g.data_ptr() for g in grads),
            b, nh, s, hd, *q.stride()[:3], *dout.stride()[:3], *grads[0].stride()[:3],
            float(sm_scale))


def _bwd_dkv(q, k, v, segment_ids, dout, lse, delta, sm_scale):
    """K7 on ``_bwd_operands``: (dk, dv) with q's strides."""
    grads = (torch.empty_like(q), torch.empty_like(q))
    _bwd_launch("flash_attention_bwd_dkv_f32", q, k, v, segment_ids, dout, lse, delta,
                grads, sm_scale)
    return grads


def _bwd_dq(q, k, v, segment_ids, dout, lse, delta, sm_scale):
    """K8 on ``_bwd_operands``: dq with q's strides."""
    dq = torch.empty_like(q)
    _bwd_launch("flash_attention_bwd_dq_f32", q, k, v, segment_ids, dout, lse, delta,
                (dq,), sm_scale)
    return dq


class FlashAttention(torch.autograd.Function):
    """Attention within segments with a gradient: the forward saves the row
    log-sum-exp (``flash_attention_lse``), the backward runs
    ``flash_attention_bwd`` (K7 and K8 on the card; never a plain fallback
    for a CUDA tensor). The counterpart of the TPU kernel's custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, sm_scale):
        out, lse = flash_attention_lse(q, k, v, segment_ids, sm_scale)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, segment_ids, out, dout, lse, ctx.sm_scale)
        return dq, dk, dv, None, None
