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

# Kernel launches per C entry point of csrc/flash_attention.cu. Incremented in
# flash_attention, where the kernel is launched, and nowhere else.
LAUNCHES = {"flash_attention_f32": 0, "flash_attention_bf16": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# q, k, v, seg, out, B, NH, S, HD, in strides (b, h, s), out strides (b, h, s),
# sm_scale, stream
_ARGTYPES = {
    name: [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
           ctypes.c_float, _P]
    for name in LAUNCHES
}
_fns: dict = {}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = build.load_library("flash_attention")
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


def flash_attention_plain(q, k, v, segment_ids, sm_scale: float):
    """The function K6 computes, in plain PyTorch: float32 logits, the
    segment-equality mask with ``MASK_VALUE``, float32 softmax, float32 P V,
    cast to q's type. Batch rows go in pieces so the (rows, nh, S, S) logits
    stay bounded. Same arguments and result as ``flash_attention``."""
    _check(q, k, v, segment_ids)
    scan_ops._assert_ieee_f32(q)
    b, nh, s, _hd = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rows = max(1, _PLAIN_LOGIT_BYTES // (nh * s * s * 4))
    for lo in range(0, b, rows):
        hi = min(lo + rows, b)
        qf = q[lo:hi].to(torch.float32)
        kf = k[lo:hi].to(torch.float32)
        vf = v[lo:hi].to(torch.float32)
        seg = segment_ids[lo:hi]
        logits = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
        same = seg[:, None, :, None] == seg[:, None, None, :]
        logits = torch.where(same, logits, MASK_VALUE)
        probs = torch.softmax(logits, dim=-1)
        out[lo:hi] = torch.matmul(probs, vf).to(q.dtype)
    return out


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


def flash_attention(q, k, v, segment_ids, sm_scale: float):
    """Attention within segments (kernel K6). q, k, v (B, nh, S, hd) float32
    or bfloat16, one shape and type; segment_ids (B, S) int32; returns
    (B, nh, S, hd) of q's type with q's strides (see the module docstring for
    the function and the layout).

    CUDA tensors launch the kernel (or raise); CPU tensors use
    ``flash_attention_plain``."""
    _check(q, k, v, segment_ids)
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, segment_ids, sm_scale)
    b, nh, s, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(
            f"head width {hd} is not one the kernel is built for {HEAD_DIMS}"
        )
    if not (_kernel_ready(q) and _kernel_ready(k) and _kernel_ready(v)
            and q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    segment_ids = segment_ids.contiguous()
    out = torch.empty_like(q)  # q's layout; the kernel is given out's own strides
    name = "flash_attention_f32" if q.dtype == torch.float32 else "flash_attention_bf16"
    fn = _kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
                 out.data_ptr(), b, nh, s, hd, *q.stride()[:3], *out.stride()[:3],
                 float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    return out
