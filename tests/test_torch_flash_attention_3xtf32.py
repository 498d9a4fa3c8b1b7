"""K6-f32's arithmetic on the CPU: the float32 kernel forms Q K^T and P V on
the tensor cores from three TF32 products each (3xTF32: x = hi + lo, hi and lo
rounded to TF32 with cvt.rna, a_lo b_hi + a_hi b_lo + a_hi b_hi summed in
float32, the small terms first). ``flash_attention_3xtf32_plain`` repeats that
arithmetic in plain PyTorch; here it is held, output and row log-sum-exp, to
JAX's Pallas TPU flash attention run in interpret mode and to the port's IEEE
plain version (the kernel's plain version, which stays IEEE float32), at the
head widths of the e5-large encoder (64) and of the bundled slots (48, 128),
S = 256 and 512, with the segment ids those paths send.

Tolerance: 2e-5, the float32 tolerance of every K6 test and of chip_smoke.py.
Each product drops a_lo b_lo and rounds the two lo words: about 3 * 2^-22 of
|a| |b| a product (IEEE: 2^-24 a multiply-add). Over at most 128 terms of
standard normal inputs that is of order 1e-6 in the logits and the outputs, a
tenth of the tolerance (a scratch run: at most 1.1e-6 against the IEEE plain
version).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_fa

from minivectordb_tpu_torch.ops import flash_attention as fa
from minivectordb_tpu_torch.ops import tf32

TOL = 2e-5


def _lengths(b, s, pattern, rng):
    """Real tokens, then pads. ``e5_large``: the embed call's ragged lengths
    (chip_smoke.py draws them from 200 / 512 of S up, one row without pads);
    ``slot``: train_builtin's batches at a slot's widths (from 100 / 256 of S
    up) with one row of a single real token."""
    lo = s * 200 // 512 if pattern == "e5_large" else s * 100 // 256
    lens = rng.integers(lo, s + 1, size=b)
    lens[0] = s
    if pattern == "slot":
        lens[-1] = 1
    return lens


@functools.lru_cache(maxsize=None)
def _case(s, hd, pattern):
    rng = np.random.default_rng(s * 7 + hd + (0 if pattern == "e5_large" else 1))
    b, nh = 3, 2
    q, k, v = (rng.standard_normal((b, nh, s, hd)).astype(np.float32) for _ in range(3))
    seg = (np.arange(s)[None, :] < _lengths(b, s, pattern, rng)[:, None]).astype(np.int32)
    return q, k, v, seg


@functools.lru_cache(maxsize=None)
def _jax(s, hd, pattern):
    """(out, lse = m + log l) of JAX's TPU kernel interpreted, with residuals."""
    q, k, v, seg = _case(s, hd, pattern)
    ids = jax_fa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    scale = float(1.0 / np.sqrt(hd))
    blocks = jax_fa.BlockSizes.get_default(*q.shape[:3], s, hd)
    with pltpu.force_tpu_interpret_mode():
        out, l, m = jax_fa._flash_attention(*(jnp.asarray(x) for x in (q, k, v)), None, ids,
                                            True, False, scale, blocks, False)
    return np.asarray(out), np.asarray(m + jnp.log(l))


def _port(fn, s, hd, pattern):
    q, k, v, seg = _case(s, hd, pattern)
    out, lse = fn(*(torch.from_numpy(x) for x in (q, k, v, seg)), float(1.0 / np.sqrt(hd)))
    assert out.dtype == lse.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    return out.numpy(), lse.numpy()


CASES = [(s, hd, pattern) for hd in (48, 64, 128) for s in (256, 512)
         for pattern in ("e5_large", "slot")]


@pytest.mark.parametrize("s, hd, pattern", CASES)
def test_3xtf32_plain_equals_the_tpu_kernel_interpreted(s, hd, pattern):
    got, got_lse = _port(fa.flash_attention_lse_3xtf32_plain, s, hd, pattern)
    want, want_lse = _jax(s, hd, pattern)
    assert got.shape == want.shape == (3, 2, s, hd)
    assert np.abs(got - want).max() <= TOL  # every position, pads included
    assert got_lse.shape == want_lse.shape == (3, 2, s)
    assert np.abs(got_lse - want_lse).max() <= TOL


@pytest.mark.parametrize("s, hd, pattern", CASES)
def test_3xtf32_plain_equals_the_ieee_plain(s, hd, pattern):
    got, got_lse = _port(fa.flash_attention_lse_3xtf32_plain, s, hd, pattern)
    want, want_lse = _port(fa.flash_attention_lse_plain, s, hd, pattern)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got_lse - want_lse).max() <= TOL
    # the inference form is the same function without its row statistic
    q, k, v, seg = (torch.from_numpy(x) for x in _case(s, hd, pattern))
    alone = fa.flash_attention_3xtf32_plain(q, k, v, seg, float(1.0 / np.sqrt(hd)))
    assert torch.equal(alone, torch.from_numpy(got))


def _f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))


def _bits(t):
    return t.numpy().view(np.uint32).tolist()


def test_tf32_round_on_hand_picked_bit_patterns():
    """cvt.rna.tf32.f32: keep 10 stored significand bits, round to nearest,
    ties away from zero, on the float32 bits."""
    cases = {
        0x3F800000: 0x3F800000,  # 1.0: already TF32
        0x3F801000: 0x3F802000,  # 1 + 2^-11: a tie, away from zero
        0xBF801000: 0xBF802000,  # -(1 + 2^-11): a tie, away from zero
        0x3F803000: 0x3F804000,  # 1 + 3 * 2^-11: a tie, away (not to even)
        0x3F800FFF: 0x3F800000,  # just below the tie
        0x3F801001: 0x3F802000,  # just above it
        0x3FFFF000: 0x40000000,  # rounds up into the next binade
        0x00000000: 0x00000000,  # +0
        0x80000000: 0x80000000,  # -0 keeps its sign
        0x00000001: 0x00000000,  # the smallest subnormal rounds to 0
        0x80000FFF: 0x80000000,  # a negative subnormal below the tie, to -0
        0x00001000: 0x00002000,  # a subnormal tie, away from zero
        0x007FF000: 0x00800000,  # the largest subnormals round to the smallest normal
        0x7F800000: 0x7F800000,  # inf
        0xFF800000: 0xFF800000,  # -inf
        0x7F7FE000: 0x7F7FE000,  # the largest TF32 value
        0x7F7FF000: 0x7F800000,  # its half step rounds to inf
    }
    got = tf32.tf32_round(_f32(list(cases)))
    assert _bits(got) == list(cases.values())
    nan = tf32.tf32_round(_f32([0x7FC00000, 0x7F800001]))
    assert torch.isnan(nan).all()  # a NaN whose payload would round to inf stays NaN
    with pytest.raises(TypeError):
        tf32.tf32_round(torch.ones(2, dtype=torch.float64))


def test_tf32_split_is_exact_where_it_must_be():
    """hi and lo are TF32 values, x - hi is exact in float32, and hi + lo
    keeps x to about 2^-21 of itself; on random and strided inputs."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal((64, 48)) * 10.0 ** rng.integers(-30, 30, (64, 48)))
                         .astype(np.float32))[:, ::3]
    hi, lo = tf32.tf32_split(x)
    assert hi.shape == lo.shape == x.shape
    for t in (hi, lo):
        assert not (t.contiguous().numpy().view(np.uint32) & 0x1FFF).any()
    xd, hid, lod = (t.double() for t in (x, hi, lo))
    assert torch.equal((x - hi).double(), xd - hid)  # no rounding in x - hi
    assert float(((xd - hid - lod).abs() / xd.abs()).max()) <= 2.0 ** -21
    assert float(((xd - hid).abs() / xd.abs()).max()) <= 2.0 ** -11


def test_3xtf32_products_are_near_float64_and_only_float32():
    """The emulated product against float64: within a few 2^-22 of
    sum |a| |b|, where one TF32 product would be 2^-11 off."""
    rng = np.random.default_rng(12)
    a, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((32, 128), (128, 40)))
    scale = (a.double().abs() @ b.double().abs())
    err3 = ((tf32.matmul_3xtf32(a, b).double() - a.double() @ b.double()).abs() / scale).max()
    err1 = ((tf32.tf32_round(a).double() @ tf32.tf32_round(b).double() - a.double() @ b.double())
            .abs() / scale).max()
    assert float(err3) <= 4 * 2.0 ** -22
    assert float(err1) > 16 * float(err3)
    q = torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention_3xtf32_plain(q, q, q, torch.ones((1, 4), dtype=torch.int32), 1.0)
