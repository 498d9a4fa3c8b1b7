"""The float32 backward kernels' arithmetic on the CPU: K7 (dK, dV) and K8
(dQ) form their products on the tensor cores in 3xTF32 (x = hi + lo cut into
TF32 words, a_lo b_hi + a_hi b_lo + a_hi b_hi summed in float32, the small
terms first). K7: S = Q K^T and dP = dO V^T, then per step of 64 queries
dV^T = dO^T P and dK^T = Q^T dS, whose step sums are added in float32. K8,
K7 mirrored: S^T = K Q^T and dP^T = V dO^T, then per step of 64 keys
dQ^T = K^T dS^T, whose step sums are added in float32. The words of the
tiles a kernel reads (K7: Q, dO and their transposes; K8: K, V, K^T) are
truncated, those it writes (K7: K and V's, P's and dS's; K8: Q and dO's,
dS's) rounded with cvt.rna. ``flash_attention_bwd_3xtf32_plain`` repeats
that arithmetic in plain PyTorch; here its gradients are held to ``jax.vjp``
of JAX's Pallas TPU flash attention run in interpret mode (its custom VJP
runs the two backward kernels) and to the port's IEEE plain backward (the
kernels' plain version, which stays IEEE float32), at the head widths of the
e5-large encoder (64) and of the bundled slots (48, 128), S = 256 and 512,
with the segment ids the training paths send. The forward's output and row
log-sum-exp come from the port's IEEE plain forward.

Tolerance: 2e-5, the float32 tolerance of every K7 / K8 test and of
chip_smoke.py. Each product drops a_lo b_lo and cuts the two lo words: about
3 * 2^-22 of |a| |b| a product rounded, 2^-20 truncated (IEEE: 2^-24 a
multiply-add). Over at most 128 terms (S, dP) or 64 (a step of dV, dK, dQ)
of standard normal inputs that is of order 1e-6 in gradients of at most
about 10, a tenth of the tolerance (a scratch run: at most 1.4e-6 against
the IEEE plain version).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_fa

from minivectordb_tpu_torch.ops import flash_attention as fa

TOL = 2e-5


def _lengths(b, s, pattern, rng):
    """Real tokens, then pads. ``e5_large``: the training step's ragged
    lengths (chip_smoke.py draws them from 200 / 512 of S up, one row without
    pads); ``slot``: train_builtin's batches at a slot's widths (from 100 /
    256 of S up) with one row of a single real token."""
    lo = s * 200 // 512 if pattern == "e5_large" else s * 100 // 256
    lens = rng.integers(lo, s + 1, size=b)
    lens[0] = s
    if pattern == "slot":
        lens[-1] = 1
    return lens


@functools.lru_cache(maxsize=None)
def _case(s, hd, pattern):
    rng = np.random.default_rng(s * 11 + hd + (0 if pattern == "e5_large" else 1))
    b, nh = (3, 2) if s == 256 else (2, 2)
    q, k, v, do = (rng.standard_normal((b, nh, s, hd)).astype(np.float32) for _ in range(4))
    seg = (np.arange(s)[None, :] < _lengths(b, s, pattern, rng)[:, None]).astype(np.int32)
    return q, k, v, do, seg


@functools.lru_cache(maxsize=None)
def _jax(s, hd, pattern):
    """(dq, dk, dv) of JAX's TPU kernel interpreted (cached: tests only read
    them)."""
    q, k, v, do, seg = _case(s, hd, pattern)
    ids = jax_fa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    scale = float(1.0 / np.sqrt(hd))
    with pltpu.force_tpu_interpret_mode():
        _out, vjp = jax.vjp(
            lambda q_, k_, v_: jax_fa.flash_attention(q_, k_, v_, segment_ids=ids,
                                                      sm_scale=scale),
            *(jnp.asarray(x) for x in (q, k, v)))
        return tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


def _port(fn, s, hd, pattern):
    """(dq, dk, dv) of a port backward on the case, given the IEEE plain
    forward's output and row log-sum-exp."""
    q, k, v, do, seg = (torch.from_numpy(x.copy()) for x in _case(s, hd, pattern))
    scale = float(1.0 / np.sqrt(hd))
    out, lse = fa.flash_attention_lse_plain(q, k, v, seg, scale)
    grads = fn(q, k, v, seg, out, do, lse, scale)
    for g in grads:
        assert g.dtype == torch.float32 and g.shape == q.shape
        assert torch.isfinite(g).all()
    return tuple(g.numpy() for g in grads)


CASES = [(s, hd, pattern) for hd in (48, 64, 128) for s in (256, 512)
         for pattern in ("e5_large", "slot")]


@pytest.mark.parametrize("s, hd, pattern", CASES)
def test_3xtf32_backward_equals_the_tpu_kernels_vjp(s, hd, pattern):
    got = _port(fa.flash_attention_bwd_3xtf32_plain, s, hd, pattern)
    want = _jax(s, hd, pattern)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.abs(g - w).max() <= TOL, name  # every position, pads included


@pytest.mark.parametrize("s, hd, pattern", CASES)
def test_3xtf32_backward_equals_the_ieee_plain(s, hd, pattern):
    got = _port(fa.flash_attention_bwd_3xtf32_plain, s, hd, pattern)
    want = _port(fa.flash_attention_bwd_plain, s, hd, pattern)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.abs(g - w).max() <= TOL, name
    # the 3xTF32 gradients differ from the IEEE ones: the emulation is not the
    # IEEE path under another name (dQ included: K8 is 3xTF32 too)
    assert not np.array_equal(got[0], want[0])
    assert not np.array_equal(got[2], want[2])


def test_3xtf32_backward_sums_its_steps_apart():
    """dV and dK are the sums of 64-query steps, each step's 3xTF32 product
    formed apart: a product over fewer queries than one step equals the
    one-step form, and zeroed steps add nothing."""
    q, k, v, do, seg = (torch.from_numpy(x) for x in _case(256, 64, "e5_large"))
    scale = 0.125
    out, lse = fa.flash_attention_lse_plain(q, k, v, seg, scale)
    _dq, dk, dv = fa.flash_attention_bwd_3xtf32_plain(q, k, v, seg, out, do, lse, scale)
    # the same gradients from the steps summed by hand
    step = fa.DKV_F32_STEP
    assert step == 64 and fa.bwd_tile_shapes(torch.float32, 64)["dkv"][0] == step
    p = torch.exp(fa._plain_logits(q, k, seg, scale, fa._bwd_product) - lse[..., None])
    want = torch.zeros_like(dv.transpose(-1, -2))
    for m0 in range(0, 256, step):
        want += fa.matmul_3xtf32(do[..., m0:m0 + step, :].transpose(-1, -2), p[..., m0:m0 + step, :],
                                 rounding="zero", rounding_b="nearest")
    assert torch.equal(dv, want.transpose(-1, -2))
    assert dk.shape == dv.shape and torch.isfinite(dk).all()


@pytest.mark.parametrize("hd", [48, 64, 128])
def test_3xtf32_dq_sums_its_steps_apart(hd):
    """dQ is the sum of 64-key steps, each step's 3xTF32 product dQ^T =
    K^T dS^T formed apart (K^T truncated, dS^T rounded to nearest) and added
    in float32 in ascending key order, from S^T = K Q^T and dP^T = V dO^T
    (K, V truncated; Q, dO rounded); the one product over all keys is another
    sum."""
    q, k, v, do, seg = (torch.from_numpy(x) for x in _case(256, hd, "slot"))
    scale = float(1.0 / np.sqrt(hd))
    out, lse = fa.flash_attention_lse_plain(q, k, v, seg, scale)
    dq = fa.flash_attention_bwd_3xtf32_plain(q, k, v, seg, out, do, lse, scale)[0]
    step = fa.DQ_F32_STEP
    assert step == 64 and fa.bwd_tile_shapes(torch.float32, hd)["dq"][1] == step
    st = fa.matmul_3xtf32(k, q.transpose(-1, -2), rounding="zero", rounding_b="nearest")
    same = seg[:, None, :, None] == seg[:, None, None, :]
    p = torch.where(same, torch.exp(st.transpose(-1, -2) * scale - lse[..., None]), 0.0)
    dpt = fa.matmul_3xtf32(v, do.transpose(-1, -2), rounding="zero", rounding_b="nearest")
    ds = p * (dpt.transpose(-1, -2) - fa._delta(out, do)[..., None])
    want = torch.zeros_like(dq.transpose(-1, -2))
    for n0 in range(0, 256, step):
        want += fa.matmul_3xtf32(k[..., n0:n0 + step, :].transpose(-1, -2),
                                 ds[..., n0:n0 + step].transpose(-1, -2),
                                 rounding="zero", rounding_b="nearest")
    assert torch.equal(dq, want.transpose(-1, -2) * scale)
    whole = fa.matmul_3xtf32(k.transpose(-1, -2), ds.transpose(-1, -2),
                             rounding="zero", rounding_b="nearest")
    assert not torch.equal(dq, whole.transpose(-1, -2) * scale)
    assert (dq - whole.transpose(-1, -2) * scale).abs().max() <= TOL


@pytest.mark.parametrize("bad", ["bf16", "shape"])
def test_3xtf32_backward_takes_what_the_kernel_takes(bad):
    q, k, v, do, seg = (torch.from_numpy(x) for x in _case(256, 48, "slot"))
    out, lse = fa.flash_attention_lse_plain(q, k, v, seg, 0.1)
    if bad == "bf16":
        args = [t.to(torch.bfloat16) for t in (q, k, v)] + [seg, out.to(torch.bfloat16),
                                                             do.to(torch.bfloat16), lse]
        with pytest.raises(TypeError):
            fa.flash_attention_bwd_3xtf32_plain(*args, 0.1)
    else:
        with pytest.raises(ValueError):
            fa.flash_attention_bwd_3xtf32_plain(q, k, v, seg, out, do, lse[:, :, :-1], 0.1)
