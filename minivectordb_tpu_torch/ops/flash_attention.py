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

Arithmetic. The float32 kernel forms Q K^T and P V on the tensor cores in
3xTF32: each operand x is cut into TF32 words hi = tf32(x) and
lo = tf32(x - hi), and a product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi,
summed in float32 (``ops/tf32.py``). Its plain version stays
the IEEE float32 ``flash_attention_plain``, and both are held to the same
2e-5; ``flash_attention_3xtf32_plain`` repeats the kernel's arithmetic in
plain PyTorch, for the tests and chip_smoke.py.

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

K7 and K8 exist for float32 (``csrc/flash_attention_bwd.cu``, both on the
tensor cores in 3xTF32) and for bfloat16 (tensor cores,
``csrc/flash_attention_bwd_bf16.cu``). The float32 kernels' plain version
stays the IEEE ``flash_attention_bwd_plain``, held to the same 2e-5;
``flash_attention_bwd_3xtf32_plain`` repeats their arithmetic. In
bfloat16 they round where the TPU kernels round: P to bfloat16 before
``dV = P^T dO``, and ``dS * sm_scale`` to bfloat16 before ``dK = dS^T Q`` and
``dQ = dS K``, every sum in float32. delta is float32 from float32 products in
either type. On CPU tensors both directions use the plain versions,
``flash_attention_lse_plain`` and ``flash_attention_bwd_plain``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from minivectordb_tpu_torch.kernels import build
from minivectordb_tpu_torch.ops import scan as scan_ops
from minivectordb_tpu_torch.ops.tf32 import matmul_3xtf32, tf32_split

# float32(-0.7 * float32 max): what a query scores against a key of another
# segment. Finite, so a row of masked logits has a softmax and no NaN.
MASK_VALUE = float(np.float32(-0.7 * float(np.finfo(np.float32).max)))

HEAD_DIMS = tuple(range(16, 129, 16))  # the widths the kernel is instantiated for
_PLAIN_LOGIT_BYTES = 256 << 20  # (rows, nh, S, S) float32 logits per piece

# Kernel launches per C entry point of csrc/flash_attention.cu (K6; the _lse_
# ones also write the row log-sum-exp), csrc/flash_attention_bwd.cu (K7, K8 in
# float32) and csrc/flash_attention_bwd_bf16.cu (K7, K8 in bfloat16).
# Incremented where each kernel is launched, and nowhere else.
LAUNCHES = {
    "flash_attention_f32": 0, "flash_attention_bf16": 0,
    "flash_attention_lse_f32": 0, "flash_attention_lse_bf16": 0,
    "flash_attention_bwd_dkv_f32": 0, "flash_attention_bwd_dq_f32": 0,
    "flash_attention_bwd_dkv_bf16": 0, "flash_attention_bwd_dq_bf16": 0,
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
    "flash_attention_bwd_dkv_bf16": [_P] * 9 + _BWD,
    "flash_attention_bwd_dq_bf16": [_P] * 8 + _BWD,
}
# the source (csrc/<name>.cu) of each entry point
_SOURCE = {
    name: ("flash_attention" if "_bwd_" not in name
           else "flash_attention_bwd_bf16" if name.endswith("_bf16")
           else "flash_attention_bwd")
    for name in LAUNCHES
}
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


def _plain_logits(q, k, segment_ids, sm_scale: float, matmul=torch.matmul):
    """float32 logits of one piece with ``MASK_VALUE`` where the segments
    differ."""
    logits = matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
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


def flash_attention_3xtf32_plain(q, k, v, segment_ids, sm_scale: float):
    """K6-f32's arithmetic in plain PyTorch, for tests and chip_smoke.py
    only (the kernel's plain version stays ``flash_attention_plain``, in IEEE
    float32): the logits Q K^T and the output P V each from three TF32
    products (``matmul_3xtf32``), P = exp(s - max) before the division by
    its row sum, softmax and sums in float32. float32 inputs only."""
    return _plain_3xtf32(q, k, v, segment_ids, sm_scale)[0]


def flash_attention_lse_3xtf32_plain(q, k, v, segment_ids, sm_scale: float):
    """``flash_attention_3xtf32_plain``'s result and the rows' log-sum-exp,
    max + log(sum), (B, nh, S) float32: K6-f32 with its row statistic."""
    return _plain_3xtf32(q, k, v, segment_ids, sm_scale)


def _plain_3xtf32(q, k, v, segment_ids, sm_scale: float):
    _check(q, k, v, segment_ids)
    if q.dtype != torch.float32:
        raise TypeError(f"the 3xTF32 form is float32's, not {q.dtype}'s")
    scan_ops._assert_ieee_f32(q)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    for sl in _plain_pieces(q, segment_ids):
        logits = _plain_logits(q[sl], k[sl], segment_ids[sl], sm_scale, matmul_3xtf32)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        rowsum = p.sum(dim=-1, keepdim=True)
        out[sl] = matmul_3xtf32(p, v[sl]) / rowsum
        lse[sl] = (m + torch.log(rowsum))[..., 0]
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


def _delta(out, dout):
    """delta = rowsum(dO * O), (.., S) float32 from float32 products,
    whatever the type of out and dout (the TPU code's
    ``sum(o.astype(f32) * do.astype(f32), -1)``)."""
    return torch.sum(out.to(torch.float32) * dout.to(torch.float32), dim=-1)


def flash_attention_bwd_plain(q, k, v, segment_ids, out, dout, lse, sm_scale: float):
    """The function K7 and K8 compute, in plain PyTorch, in pieces of batch
    rows: P = exp(masked float32 logits - lse) (the masked logits' exp
    underflows to 0, as in the TPU kernel), delta = rowsum(dO * O) in
    float32, dS = P * (dO V^T - delta), all in float32. Float32 inputs:
    dV = P^T dO, dK = dS^T Q * sm_scale, dQ = dS K * sm_scale. bfloat16
    inputs round where the TPU kernels round: dV = bf16(P)^T dO,
    dK = bf16(dS * sm_scale)^T Q, dQ = bf16(dS * sm_scale) K, every sum in
    float32. Returns (dq, dk, dv) in q's type."""
    _check(q, k, v, segment_ids)
    _check_bwd(q, out, dout, lse)
    scan_ops._assert_ieee_f32(q)
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)]
    rounded = q.dtype != torch.float32
    for sl in _plain_pieces(q, segment_ids):
        qf, kf, vf, dof = (t[sl].to(torch.float32) for t in (q, k, v, dout))
        delta = _delta(out[sl], dout[sl])
        p = torch.exp(_plain_logits(q[sl], k[sl], segment_ids[sl], sm_scale)
                      - lse[sl][..., None])
        ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
        if rounded:
            p = p.to(q.dtype).to(torch.float32)
            ds = (ds * sm_scale).to(q.dtype).to(torch.float32)
            grads[0][sl] = torch.matmul(ds, kf).to(q.dtype)
            grads[1][sl] = torch.matmul(ds.transpose(-1, -2), qf).to(q.dtype)
        else:
            grads[0][sl] = (torch.matmul(ds, kf) * sm_scale).to(q.dtype)
            grads[1][sl] = (torch.matmul(ds.transpose(-1, -2), qf) * sm_scale).to(q.dtype)
        grads[2][sl] = torch.matmul(p.transpose(-1, -2), dof).to(q.dtype)
    return tuple(grads)


DKV_F32_STEP = 64  # queries a step of the float32 K7 (csrc/flash_attention_bwd.cu: DkvCfg::W)
DQ_F32_STEP = 64  # keys a step of the float32 K8 (csrc/flash_attention_bwd.cu: DqCfg::W)


def _bwd_product(x, y):
    """A product of the float32 K7 or K8 in 3xTF32: x's words (K7: Q, dO,
    Q^T, dO^T; K8: K, V, K^T) truncated, as the kernel reads them from the
    tiles, y's (K7: K, V, P, dS; K8: Q, dO, dS) rounded to nearest, as the
    kernel writes them."""
    return matmul_3xtf32(x, y, rounding="zero", rounding_b="nearest")


def flash_attention_bwd_3xtf32_plain(q, k, v, segment_ids, out, dout, lse, sm_scale: float):
    """The float32 K7's and K8's arithmetic in plain PyTorch, for tests and
    chip_smoke.py only (the kernels' plain version stays
    ``flash_attention_bwd_plain``, in IEEE float32). Every product is three
    TF32 products (``matmul_3xtf32``), the words of the tiles the kernel
    reads truncated and those it writes rounded to nearest (``_bwd_product``);
    P = exp(S * sm_scale - lse), dS = P (dP - delta), in float32.

    K7 (dK, dV): S = Q K^T and dP = dO V^T; dS = (hi + lo) * (dP - delta) from
    P's TF32 words (rounded to nearest; hi + lo is P to 2^-22); then per step
    of ``DKV_F32_STEP`` queries dV^T = dO^T P and dK^T = Q^T dS, the steps'
    sums added in float32 in ascending order, dK times sm_scale.

    K8 (dQ), K7 mirrored: S^T = K Q^T and dP^T = V dO^T, dS = P (dP - delta)
    as is; then per step of ``DQ_F32_STEP`` keys dQ^T = K^T dS^T, the steps'
    sums added in float32 in ascending order, times sm_scale.

    float32 inputs only. Returns (dq, dk, dv)."""
    _check(q, k, v, segment_ids)
    _check_bwd(q, out, dout, lse)
    if q.dtype != torch.float32:
        raise TypeError(f"the 3xTF32 form is float32's, not {q.dtype}'s")
    scan_ops._assert_ieee_f32(q)
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)]
    s = q.shape[2]
    for sl in _plain_pieces(q, segment_ids):
        qf, kf, vf, dof = q[sl], k[sl], v[sl], dout[sl]
        delta = _delta(out[sl], dout[sl])[..., None]
        grads[0][sl] = _k8_dq(qf, kf, vf, dof, segment_ids[sl], lse[sl], delta, sm_scale)
        # dK, dV: K7's
        p = torch.exp(_plain_logits(qf, kf, segment_ids[sl], sm_scale, _bwd_product)
                      - lse[sl][..., None])
        p_hi, p_lo = tf32_split(p)  # warpgroup 1 reads P back from its words
        ds = (p_hi + p_lo) * (_bwd_product(dof, vf.transpose(-1, -2)) - delta)
        dvt = torch.zeros(q[sl].transpose(-1, -2).shape, dtype=torch.float32, device=q.device)
        dkt = torch.zeros_like(dvt)
        for m0 in range(0, s, DKV_F32_STEP):
            rows = slice(m0, min(m0 + DKV_F32_STEP, s))
            dvt += _bwd_product(dof[..., rows, :].transpose(-1, -2), p[..., rows, :])
            dkt += _bwd_product(qf[..., rows, :].transpose(-1, -2), ds[..., rows, :])
        grads[1][sl] = dkt.transpose(-1, -2) * sm_scale
        grads[2][sl] = dvt.transpose(-1, -2)
    return tuple(grads)


def _k8_dq(q, k, v, dout, segment_ids, lse, delta, sm_scale: float):
    """The float32 K8's dQ of one piece (see flash_attention_bwd_3xtf32_plain);
    ``delta`` (.., S, 1)."""
    s = q.shape[2]
    st = _bwd_product(k, q.transpose(-1, -2))  # S^T: keys x queries
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    p = torch.where(same, torch.exp(st.transpose(-1, -2) * sm_scale - lse[..., None]), 0.0)
    ds = p * (_bwd_product(v, dout.transpose(-1, -2)).transpose(-1, -2) - delta)
    dqt = torch.zeros(q.transpose(-1, -2).shape, dtype=torch.float32, device=q.device)
    for n0 in range(0, s, DQ_F32_STEP):
        keys = slice(n0, min(n0 + DQ_F32_STEP, s))
        dqt += _bwd_product(k[..., keys, :].transpose(-1, -2), ds[..., keys].transpose(-1, -2))
    return dqt.transpose(-1, -2) * sm_scale


def tile_shape(dtype, hd: int) -> tuple[int, int]:
    """(query rows, keys) of one tile of the kernel that serves (dtype, hd):
    bfloat16 128 x 128; float32 128 x 64 up to hd = 64, 128 x 32 above
    (csrc/flash_attention.cu: BF_BM, BF_KT; F32_BM, F32Cfg::KT)."""
    if dtype == torch.bfloat16:
        return 128, 128
    return 128, (64 if hd <= 64 else 32)


def bwd_tile_shapes(dtype, hd: int) -> dict:
    """{"dkv": (query rows, keys), "dq": (query rows, keys)}: the tile on
    which K7 and K8 serving (dtype, hd) decide to skip or multiply, with
    W = 64 up to hd = 64, else 32. float32 (csrc/flash_attention_bwd.cu): K7
    64 x W (DkvCfg::W, KEYS), K8 W x 64 (DqCfg::QUERIES, W). bfloat16
    (csrc/flash_attention_bwd_bf16.cu): K7 W x 64 (DkvCfg::W, KEYS), K8
    64 x W (DqCfg::QUERIES, W)."""
    w = 64 if hd <= 64 else 32
    if dtype == torch.bfloat16:
        return {"dkv": (w, 64), "dq": (64, w)}
    return {"dkv": (DKV_F32_STEP, w), "dq": (w, DQ_F32_STEP)}


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


def bwd_bf16_blocks_per_sm(hd: int, kernel: str) -> int:
    """Blocks of the bfloat16 K7 (``kernel="dkv"``) or K8 (``"dq"``) at head
    width ``hd`` that one SM of the current CUDA device holds at once, from
    the kernel's registers, threads and shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). Measurement only:
    chip_smoke.py and profile_search report it beside the kernels' times."""
    if kernel not in ("dkv", "dq"):
        raise ValueError(f"kernel must be 'dkv' or 'dq', not {kernel!r}")
    fn = build.load_library("flash_attention_bwd_bf16").flash_attention_bwd_bf16_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(hd, int(kernel == "dkv"), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_bf16_blocks_per_sm: cudaError {err}")
    return blocks.value


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


def _kind(q) -> str:
    return "f32" if q.dtype == torch.float32 else "bf16"


def _forward(q, k, v, segment_ids, sm_scale: float, with_lse: bool):
    """K6 on CUDA tensors: (out, lse or None)."""
    b, nh, s, hd = q.shape
    q, k, v, segment_ids = _kernel_operands(q, k, v, segment_ids)
    out = torch.empty_like(q)  # q's layout; the kernel is given out's own strides
    kind = _kind(q)
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
    float32 or bfloat16, on CUDA tensors (or raise); CPU tensors use
    ``flash_attention_bwd_plain``. delta = rowsum(dO * O) is one torch.sum
    here, in float32, as JAX computes it outside its kernels. The gradients
    have q's strides; dout may have any strides (autograd chooses them)."""
    _check(q, k, v, segment_ids)
    _check_bwd(q, out, dout, lse)
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, segment_ids, out, dout, lse, sm_scale)
    ops = _bwd_operands(q, k, v, segment_ids, out, dout, lse)
    dk, dv = _bwd_dkv(*ops, sm_scale)
    return _bwd_dq(*ops, sm_scale), dk, dv


def _bwd_operands(q, k, v, segment_ids, out, dout, lse):
    """(q, k, v, segment_ids, dout, lse, delta) as K7 and K8 take them, with
    delta = rowsum(dO * O) (B, nh, S) float32 from float32 products."""
    q, k, v, segment_ids = _kernel_operands(q, k, v, segment_ids)
    if not _kernel_ready(dout):
        dout = dout.contiguous()
    delta = _delta(out, dout).contiguous()
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
    _bwd_launch(f"flash_attention_bwd_dkv_{_kind(q)}", q, k, v, segment_ids, dout, lse,
                delta, grads, sm_scale)
    return grads


def _bwd_dq(q, k, v, segment_ids, dout, lse, delta, sm_scale):
    """K8 on ``_bwd_operands``: dq with q's strides."""
    dq = torch.empty_like(q)
    _bwd_launch(f"flash_attention_bwd_dq_{_kind(q)}", q, k, v, segment_ids, dout, lse,
                delta, (dq,), sm_scale)
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
