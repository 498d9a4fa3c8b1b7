"""TF32 words of float32 values and the 3xTF32 product, in plain PyTorch.

The port's float32 tensor-core kernels form a float32 product a b on
``wgmma`` from TF32 words (10 stored significand bits, float32's exponent):
each operand x is cut into hi and lo = x - hi (exact in float32), and
a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, summed in float32, the small terms
first (a_lo b_lo is dropped). Two kernels cut x two ways:

- ``rounding="nearest"``: hi = tf32_round(x), lo = tf32_round(x - hi), what
  ``cvt.rna.tf32.f32`` gives K6-f32 (csrc/flash_attention.cu);
- ``rounding="zero"``: hi = tf32_truncate(x), lo = tf32_truncate(x - hi),
  what the tensor core reads from a float32 word as it lies (its 13 low
  significand bits ignored): K1-f32 (csrc/phase1.cu) hands it the words
  unrounded.

These functions repeat that arithmetic for the tests and chip_smoke.py; no
search or encoder path calls them.
"""

from __future__ import annotations

import torch

_ROUNDINGS = ("nearest", "zero")


def _bits(x):
    if x.dtype != torch.float32:
        raise TypeError(f"TF32 words are cut from float32, not {x.dtype}")
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(bits, x):
    rounded = (bits - ((bits >> 31) << 32)).to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded.view(x.shape))


def tf32_round(x):
    """float32 ``x`` rounded to the nearest TF32 value (10 stored significand
    bits, float32's exponent), ties away from zero: what ``cvt.rna.tf32.f32``
    gives the float32 kernel, computed on the float32 bits (half a TF32 step
    added to the magnitude, the 13 low bits cleared). Subnormals round on the
    same grid, signed zeros keep their sign, inf stays inf, NaN stays NaN, and
    a value past the largest TF32 value's half step rounds to inf."""
    return _from_bits((_bits(x) + 0x1000) & 0xFFFFE000, x)


def tf32_truncate(x):
    """float32 ``x`` with its 13 low significand bits cleared: the TF32 value
    the tensor core reads from a float32 word, rounded toward zero. Signed
    zeros keep their sign, inf stays inf, NaN stays NaN."""
    return _from_bits(_bits(x) & 0xFFFFE000, x)


def tf32_split(x, rounding: str = "nearest"):
    """(hi, lo) with hi = f(x) and lo = f(x - hi), f = ``tf32_round``
    (``rounding="nearest"``) or ``tf32_truncate`` (``"zero"``): the two TF32
    operands a 3xTF32 product takes for float32 ``x`` (x - hi is exact in
    float32; hi + lo keeps about 21 of x's 24 significand bits rounded, 20
    truncated)."""
    if rounding not in _ROUNDINGS:
        raise ValueError(f"rounding must be one of {_ROUNDINGS}, not {rounding!r}")
    f = tf32_round if rounding == "nearest" else tf32_truncate
    hi = f(x)
    return hi, f(x - hi)


def matmul_3xtf32(a, b, rounding: str = "nearest", rounding_b: str | None = None):
    """a @ b as the float32 kernels form it on the tensor cores: three
    products of TF32 operands, a_lo b_hi + a_hi b_lo + a_hi b_hi, summed in
    float32 in that order, the small terms first (each product of two TF32
    values is exact in float32; the dropped a_lo b_lo is below 2^-22 of
    |a| |b| rounded, 2^-20 truncated). ``rounding_b`` cuts b another way than
    a (by default the same): K7-f32 truncates the tiles it reads as they lie
    and rounds the words it writes."""
    a_hi, a_lo = tf32_split(a, rounding)
    b_hi, b_lo = tf32_split(b, rounding if rounding_b is None else rounding_b)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) + torch.matmul(a_hi, b_hi)
