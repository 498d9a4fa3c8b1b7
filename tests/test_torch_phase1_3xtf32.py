"""K1-f32's arithmetic on the CPU: the float32 phase-1 kernel forms its dots
on the tensor cores in 3xTF32 from the float32 words as they lie (the tensor
core reads a word as TF32 with its 13 low significand bits ignored, so
hi = trunc(x), lo = trunc(x - hi), q_lo row_hi + q_hi row_lo + q_hi row_hi
summed in float32). ``fused_scan.subtile_maxima_3xtf32_plain`` repeats that
arithmetic in plain PyTorch; here it is held to JAX's ``subtile_maxima`` (its
Pallas TPU kernel, interpreted on the CPU as the JAX package's own tests run
it) and to the port's IEEE plain version (the kernel's plain version, which
stays IEEE float32), at d = 384 and 48, B = 16 and 256, with and without a
mask, `count` inside a subtile. The whole fused scan with that phase 1 must
return what the IEEE path returns: phase 3 rescores in IEEE float32.

Tolerance: 1e-5 on the subtile maxima, as the float32 maxima of
tests/test_torch_fused_scan.py (the kernel is held to 2e-5 on the card).
Truncated words keep x to 2^-20 of itself, so each product is off by at most
3 * 2^-20 |q_i| |row_i|; with a unit query and the row's 1/norm that sums to
at most 3 * 2^-20 = 2.9e-6 of a cosine (a scratch run: 4e-7 against the IEEE
plain version at d = 384).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minivectordb_tpu.ops import pallas_scan as jfused
from minivectordb_tpu.ops import scan as jscan
from minivectordb_tpu_torch.kernels import build
from minivectordb_tpu_torch.ops import fused_scan as tfused
from minivectordb_tpu_torch.ops import scan as tscan
from minivectordb_tpu_torch.ops import tf32

TOL = 1e-5
MASKED = -3.0e38
CAP = 4096
COUNT = 4013  # inside subtile 125 (4013 = 125 * 32 + 13)


def _operands(d, b, seed):
    rng = np.random.default_rng(seed)
    full = rng.standard_normal((CAP, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mask = rng.random(CAP) < 0.5
    return full, q, mask


CASES = [(d, b, use_mask) for d in (384, 48) for b in (16, 256) for use_mask in (False, True)]


def _emulated(d, b, use_mask):
    full, q, mask = _operands(d, b, d + b)
    tb = torch.from_numpy(full)
    tm = torch.from_numpy(mask) if use_mask else None
    got = tfused.subtile_maxima_3xtf32_plain(tb, tscan.row_inv_norms(tb), torch.from_numpy(q),
                                            COUNT, tm)
    assert got.shape == (b, CAP // 32) and got.dtype == torch.float32
    return (full, q, mask), got


@pytest.mark.parametrize("d, b, use_mask", CASES)
def test_3xtf32_plain_equals_the_tpu_kernel_interpreted(d, b, use_mask):
    (full, q, mask), got = _emulated(d, b, use_mask)
    jb = jnp.asarray(full)
    want = np.asarray(jfused.subtile_maxima(
        jb, jscan.row_inv_norms(jb), jnp.asarray(q), COUNT,
        jnp.asarray(mask.astype(np.float32)) if use_mask else None)).T
    np.testing.assert_array_equal(got.numpy() == MASKED, want == MASKED)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("d, b, use_mask", CASES)
def test_3xtf32_plain_equals_the_ieee_plain(d, b, use_mask):
    (full, q, mask), got = _emulated(d, b, use_mask)
    tb = torch.from_numpy(full)
    want = tfused.subtile_maxima_plain(tb, tscan.row_inv_norms(tb), torch.from_numpy(q), COUNT,
                                       torch.from_numpy(mask) if use_mask else None)
    assert torch.equal(got == MASKED, want == MASKED)
    live = want != MASKED
    assert float((got[live] - want[live]).abs().max()) <= TOL
    # the subtiles wholly past count are the sentinel, every one before holds a row
    assert bool((got[:, -(-COUNT // 32):] == MASKED).all())


def test_3xtf32_plain_takes_float32_only():
    bf = torch.zeros((64, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tfused.subtile_maxima_3xtf32_plain(bf, torch.zeros(64), bf[:8], 64)


def _f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))


def _bits(t):
    return t.numpy().view(np.uint32).tolist()


def test_tf32_truncate_on_hand_picked_bit_patterns():
    """The word the tensor core reads: the 13 low significand bits cleared,
    whatever they were (toward zero, for either sign)."""
    cases = {
        0x3F800000: 0x3F800000,  # 1.0: already TF32
        0x3F801000: 0x3F800000,  # 1 + 2^-11: a tie, toward zero
        0x3F801FFF: 0x3F800000,  # just below the next TF32 value, still down
        0xBF803FFF: 0xBF802000,  # negative: toward zero as well
        0x3FFFFFFF: 0x3FFFE000,  # stays in its binade
        0x80000000: 0x80000000,  # -0 keeps its sign
        0x00001FFF: 0x00000000,  # a subnormal below the first TF32 step, to 0
        0x7F800000: 0x7F800000,  # inf
        0x7F7FFFFF: 0x7F7FE000,  # the largest float32 stays finite
    }
    assert _bits(tf32.tf32_truncate(_f32(list(cases)))) == list(cases.values())
    assert torch.isnan(tf32.tf32_truncate(_f32([0x7FC00000, 0x7F800001]))).all()
    with pytest.raises(TypeError):
        tf32.tf32_truncate(torch.ones(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        tf32.tf32_split(torch.ones(2), "up")


def test_truncated_split_is_exact_where_it_must_be():
    """hi and lo are TF32 values, hi = x as the tensor core reads it, x - hi
    is exact in float32, hi + lo keeps x to 2^-20 of itself; products of the
    truncated split are within a few 2^-20 of float64."""
    rng = np.random.default_rng(19)
    x = torch.from_numpy((rng.standard_normal((64, 48)) * 10.0 ** rng.integers(-30, 30, (64, 48)))
                         .astype(np.float32))
    hi, lo = tf32.tf32_split(x, "zero")
    for t in (hi, lo):
        assert not (t.numpy().view(np.uint32) & 0x1FFF).any()
    assert torch.equal(hi, tf32.tf32_truncate(x))
    xd, hid, lod = (t.double() for t in (x, hi, lo))
    assert torch.equal((x - hi).double(), xd - hid)
    assert float(((xd - hid - lod).abs() / xd.abs()).max()) <= 2.0 ** -20
    a, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((32, 384), (384, 40)))
    scale = a.double().abs() @ b.double().abs()
    err = (tf32.matmul_3xtf32(a, b, "zero").double() - a.double() @ b.double()).abs() / scale
    assert float(err.max()) <= 4 * 2.0 ** -20


def _topk_cases():
    rng = np.random.default_rng(23)
    n, d, b = 6000, 48, 16
    full = rng.standard_normal((jscan.capacity_bucket(n), d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(full.shape[0]) < 0.5
    dup = full.copy()
    for r in (40, 41, 3000, 5999):  # exact duplicates: equal scores, ties
        dup[r] = dup[7]
    bits = dup.view(np.uint32)
    for r, src in ((900, 7), (2100, 7), (4500, 8)):  # one last bit away from another row
        dup[r] = dup[src]
        bits[r, 5] ^= 1
    dq = q.copy()
    dq[0], dq[1] = dup[7], dup[8]
    return {"plain": (full, q, None, n), "mask": (full, q, mask, n),
            "duplicates_and_last_bits": (dup, dq, None, n)}


_TOPK = _topk_cases()


@pytest.mark.parametrize("case", sorted(_TOPK))
def test_fused_scan_with_3xtf32_phase1_returns_the_ieee_result(case, monkeypatch):
    """Phase 3 rescores in IEEE float32, so the 3xTF32 phase 1 changes no
    score; ids are equal, except that rows of exactly equal score may trade
    places (the module docstring's ties)."""
    full, q, mask, n = _TOPK[case]
    tb, tq = torch.from_numpy(full), torch.from_numpy(q)
    inv = tscan.row_inv_norms(tb)
    tm = None if mask is None else torch.from_numpy(mask)
    want_v, want_i = tfused.fused_scan_topk(tb, inv, tq, n, 10, mask=tm)
    monkeypatch.setattr(tfused, "subtile_maxima_plain", tfused.subtile_maxima_3xtf32_plain)
    got_v, got_i = tfused.fused_scan_topk(tb, inv, tq, n, 10, mask=tm)
    assert torch.equal(got_v, want_v)
    for row in range(q.shape[0]):
        for value in torch.unique(want_v[row]):
            at = want_v[row] == value
            assert set(got_i[row][at].tolist()) == set(want_i[row][at].tolist()), (row, value)
    if case == "duplicates_and_last_bits":
        # row 7, its four copies and its two last-bit neighbours all score 1
        # to float32's precision
        assert set(got_i[0, :7].tolist()) == {7, 40, 41, 3000, 5999, 900, 2100}
        assert {8, 4500} <= set(got_i[1, :2].tolist())


def _phase1_source():
    with open(os.path.join(build.CSRC_DIR, "phase1.cu"), encoding="utf-8") as f:
        return f.read()


def test_float32_rows_take_the_route_their_width_allows():
    """float32 is routed like bf16 and int8: rows TMA can describe (d * 4 a
    multiple of 16) take the 3xTF32 wgmma kernel, the rest the CUDA-core
    kernel, counted in NARROW_LAUNCHES; the wrapper asks the library's
    phase1_route for every type and aligns every operand to 16 bytes."""
    import inspect

    src = _phase1_source()
    assert ('extern "C" int phase1_route(int d, int esize) '
            '{ return (d * esize) % 16 == 0 ? 1 : 0; }') in src
    entry = src[src.index('extern "C" int phase1_f32('):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (phase1_route(d, 4)) return launch_tf32(" in entry
    assert "return launch_blocks<void>(" in entry
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in src
    assert "cvt.rna.tf32.f32 %" not in src  # the words are read as they lie: truncated
    launch = inspect.getsource(tfused._launch)
    assert '_kernel_fn("phase1_route")(d, buf.element_size())' in launch
    assert "phase1_f32" not in launch  # no type is exempt any more
    assert {"phase1_f32", "phase1_f32_mask"} <= set(tfused.NARROW_LAUNCHES)
    route = {d: (d * 4) % 16 == 0 for d in (24, 25, 48, 383, 384, 1536)}
    assert route == {24: True, 25: False, 48: True, 383: False, 384: True, 1536: True}


def _const(src, name):
    m = re.search(rf"constexpr int (?:\w+ = \d+, )*{name} = (\d+)[;,]", src)
    assert m, name
    return int(m.group(1))


def test_f32_kernel_register_split_and_shared_memory_plan():
    """Two consumer warpgroups (B > 64) take the producer warpgroup's
    registers with setmaxnreg; the split must fit the 384 x 168 registers the
    block is charged, or the consumers would wait forever, and the launcher
    refuses a build whose entry count could not cover it. A stage holds the
    corpus slab (128 rows of 128 bytes), its lo words and the block's query
    slab: at least three stages fit beside the inv slots and the barriers at
    every batch the plan takes, every region on the swizzle's 1024 bytes."""
    src = _phase1_source()
    cfg = src[src.index("struct Tf32Cfg {"):]
    cfg = cfg[:cfg.index("};")]
    regs = re.search(r"PRODUCER_REGS = (\d+), CONSUMER_REGS = (\d+);", cfg)
    producer, consumer = int(regs.group(1)), int(regs.group(2))
    assert all(r % 8 == 0 and 24 <= r <= 256 for r in (producer, consumer))
    assert 128 * producer + 256 * consumer <= 384 * (65536 // 384 // 8 * 8) == 384 * 168
    assert "static constexpr int THREADS = CONSUMERS + 128;" in cfg
    assert "static constexpr bool TRADE = WG > 1;" in cfg
    assert "__launch_bounds__(Tf32Cfg<WG, MT>::THREADS, 1)" in src
    assert "phase1_tf32_kernel<WG, MT><<<p.per_qblock * p.qblocks, Cfg::THREADS, SMEM_LIMIT" in src
    assert "if (attr.numRegs * threads < regs) return" in src
    for ptx in ("setmaxnreg.dec.sync.aligned.u32", "setmaxnreg.inc.sync.aligned.u32",
                "fence.proxy.async.shared::cta"):
        assert ptx in src
    assert _const(src, "TF_HELPERS") == 96  # the producer warpgroup's other warps

    tn, slab = _const(src, "TF_TN"), _const(src, "SLAB")
    ninfo, max_stages = _const(src, "NINFO"), _const(src, "MAX_STAGES")
    limit = _const(src, "SMEM_LIMIT")
    assert "constexpr int TF_BAR_BYTES = (3 * MAX_STAGES + 2 * NINFO) * 8;" in src
    bar_bytes = (3 * max_stages + 2 * ninfo) * 8
    for b in (8, 16, 64, 65, 128, 200, 256, 1024):
        wg, mt = (2 if b > 64 else 1), (2 if b > 128 else 1)
        qb = 64 * wg * mt
        stage = 2 * tn * slab + qb * slab
        stages = min(max_stages, (limit - ninfo * tn * 4 - bar_bytes) // stage)
        assert stages >= 3, b
        assert stages * stage + ninfo * tn * 4 + bar_bytes <= limit
        assert stage % 1024 == 0 and (2 * tn * slab) % 1024 == 0 and (64 * slab) % 1024 == 0
        assert -(-b // qb) == (1 if b <= 256 else b // 256)
