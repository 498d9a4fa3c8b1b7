"""K6 on the CPU: the port's plain flash attention against JAX's Pallas TPU
flash attention run in interpret mode and against JAX's own reference
(mha_reference), on the same seeded inputs, at every position, pads included.

Tolerances. float32: 2e-5 (three float32 softmax formulations that sum in
different orders; inputs are standard normal, outputs are averages of them).
bfloat16: 2e-2 (the TPU kernel rounds the probabilities to bf16 before P V
and rounds its output once; the plain version keeps float32 probabilities and
rounds once; outputs reach about 3 in magnitude, where a bf16 step is 1.6e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_fa

from minivectordb_tpu_torch.ops import flash_attention as fa

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _case(b, nh, s, hd, lengths, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, nh, s, hd)).astype(np.float32) for _ in range(3))
    seg = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return q, k, v, seg


def _pattern_case(b, nh, s, hd, pattern, seed):
    """Segment ids other than "real tokens, then pads": ``packed`` holds three
    sequences back to back and pads after them (ids 1, 2, 3, then 0), with
    other cut points in every batch row; ``cyclic`` is the non-monotone
    ``(i // 37) % 3``, whose ids come back tile after tile."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, nh, s, hd)).astype(np.float32) for _ in range(3))
    i = np.arange(s)
    if pattern == "packed":
        seg = np.zeros((b, s), np.int32)
        for row in range(b):
            cuts = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
            seg[row] = np.searchsorted(cuts, i, side="right") + 1
            seg[row][i >= cuts[2]] = 0
    else:
        seg = np.broadcast_to(((i // 37) % 3).astype(np.int32), (b, s)).copy()
    return q, k, v, seg


def _jax_kernel(q, k, v, seg, dtype=jnp.float32):
    ids = jax_fa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    with pltpu.force_tpu_interpret_mode():
        out = jax_fa.flash_attention(
            jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            segment_ids=ids, sm_scale=scale)
    return np.asarray(out.astype(jnp.float32))


def _jax_reference(q, k, v, seg):
    ids = jax_fa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    return np.asarray(jax_fa.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, segment_ids=ids,
        sm_scale=scale))


def _port(q, k, v, seg, dtype=torch.float32, fn=None):
    fn = fn or fa.flash_attention
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    out = fn(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
             torch.from_numpy(seg), scale)
    assert out.dtype == dtype
    return out.to(torch.float32).numpy()


# ragged lengths: a full row, a row with one real token, a row with none padded
# in its first tile only, and one whose pads fill whole 128-key tiles
LENGTHS = {256: [256, 1, 130, 77], 512: [512, 1, 300, 120]}


@pytest.mark.parametrize("hd", [32, 48, 64, 128])
@pytest.mark.parametrize("s", [256, 512])
def test_plain_equals_the_tpu_kernel_interpreted_f32(s, hd):
    q, k, v, seg = _case(4, 2, s, hd, LENGTHS[s], seed=s + hd)
    got = _port(q, k, v, seg)
    want = _jax_kernel(q, k, v, seg)
    assert got.shape == want.shape == (4, 2, s, hd)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= F32_TOL  # every position, pads included


@pytest.mark.parametrize("hd", [32, 48, 64, 128])
@pytest.mark.parametrize("s", [256, 512])
def test_plain_equals_mha_reference_f32(s, hd):
    q, k, v, seg = _case(4, 2, s, hd, LENGTHS[s], seed=1000 + s + hd)
    got = _port(q, k, v, seg, fn=fa.flash_attention_plain)
    assert np.abs(got - _jax_reference(q, k, v, seg)).max() <= F32_TOL


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_plain_equals_the_tpu_kernel_interpreted_bf16(hd):
    q, k, v, seg = _case(2, 2, 256, hd, [256, 90], seed=2000 + hd)
    got = _port(q, k, v, seg, dtype=torch.bfloat16)
    want = _jax_kernel(q, k, v, seg, dtype=jnp.bfloat16)
    assert np.abs(got - want).max() <= BF16_TOL


@pytest.mark.parametrize("pattern", ["packed", "cyclic"])
@pytest.mark.parametrize("s", [384, 512])
def test_plain_equals_the_tpu_kernel_interpreted_segment_patterns(s, pattern):
    """Segment skipping must stay right when the ids are not "ones, then
    zeros": a key tile may hold several ids, and a query tile's range may meet
    a key tile's without one pair of equal ids."""
    q, k, v, seg = _pattern_case(2, 2, s, 64, pattern, seed=3000 + s)
    got = _port(q, k, v, seg)
    want = _jax_kernel(q, k, v, seg)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("pattern", ["packed", "cyclic"])
def test_plain_equals_the_tpu_kernel_interpreted_segment_patterns_bf16(pattern):
    q, k, v, seg = _pattern_case(2, 2, 384, 32, pattern, seed=3100)
    got = _port(q, k, v, seg, dtype=torch.bfloat16)
    want = _jax_kernel(q, k, v, seg, dtype=jnp.bfloat16)
    assert np.abs(got - want).max() <= BF16_TOL


# The TPU kernel takes key blocks of 128 only, so sequences that are not a
# multiple of 128 (and of the port's tiles of 64) are held against JAX's
# reference with the same segment ids.
@pytest.mark.parametrize("pattern", ["lengths", "packed", "cyclic"])
@pytest.mark.parametrize("s", [129, 200, 333])
def test_plain_equals_mha_reference_any_length(s, pattern):
    if pattern == "lengths":
        q, k, v, seg = _case(3, 2, s, 48, [s, 1, s // 2 + 1], seed=4000 + s)
    else:
        q, k, v, seg = _pattern_case(3, 2, s, 48, pattern, seed=4100 + s)
    got = _port(q, k, v, seg, fn=fa.flash_attention_plain)
    assert np.abs(got - _jax_reference(q, k, v, seg)).max() <= F32_TOL


def _visited_by_loops(seg, rows, keys):
    """The kernels' skipping rule, tile by tile."""
    b, s = seg.shape
    count = 0
    for row in range(b):
        for m0 in range(0, s, rows):
            qt = seg[row, m0:m0 + rows]
            for n0 in range(0, s, keys):
                kt = seg[row, n0:n0 + keys]
                count += not (kt.max() < qt.min() or kt.min() > qt.max())
    return count


@pytest.mark.parametrize("pattern", ["lengths", "packed", "cyclic"])
@pytest.mark.parametrize("s, rows, keys", [(512, 128, 64), (512, 128, 128), (200, 128, 64),
                                           (129, 64, 64), (4500, 128, 128)])
def test_visited_tiles_follows_the_skipping_rule(s, rows, keys, pattern):
    """What chip_smoke.py counts as multiplied: the tiles whose id ranges
    meet, never fewer than those holding a pair of one segment, never more
    than all of them."""
    if pattern == "lengths":
        seg = (np.arange(s)[None, :] < np.array([[s], [1], [s // 3]])).astype(np.int32)
    else:
        seg = _pattern_case(3, 1, s, 16, pattern, seed=5000 + s)[3]
    got = fa.visited_tiles(torch.from_numpy(seg), rows, keys)
    assert got == _visited_by_loops(seg, rows, keys)
    mt, nt = -(-s // rows), -(-s // keys)
    assert got <= 3 * mt * nt
    pairs = 0
    for row in range(3):
        for m0 in range(0, s, rows):
            for n0 in range(0, s, keys):
                pairs += bool(np.intersect1d(seg[row, m0:m0 + rows],
                                             seg[row, n0:n0 + keys]).size)
    assert got >= pairs
    if pattern == "lengths" and s == 512:
        assert got < 3 * mt * nt  # the real-by-pad corners are skipped


def test_tile_shape_matches_the_kernels():
    import os
    import re

    from minivectordb_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC_DIR, "flash_attention.cu"), encoding="utf-8") as f:
        src = f.read()
    consts = {name: int(re.search(rf"(?:constexpr int|#define) {name}\b\D*(\d+)", src).group(1))
              for name in ("F32_BM", "BF_BM", "BF_KT")}
    assert fa.tile_shape(torch.bfloat16, 64) == (consts["BF_BM"], consts["BF_KT"]) == (128, 128)
    # float32: 128 query rows at every width (two consumer warpgroups of 64),
    # 64 keys a tile up to hd = 64 and 32 above (F32Cfg::KT)
    kt = re.search(r"static constexpr int KT = HD <= (\d+) \? (\d+) : (\d+);", src)
    assert kt is not None and tuple(int(x) for x in kt.groups()) == (64, 64, 32)
    assert fa.tile_shape(torch.float32, 64) == (consts["F32_BM"], 64) == (128, 64)
    assert fa.tile_shape(torch.float32, 128) == (128, 32)
    for hd in fa.HEAD_DIMS:
        assert fa.tile_shape(torch.float32, hd) == (128, 64 if hd <= 64 else 32)
    # bfloat16 keeps its 128 x 128 tile at every width: above hd = 64 the
    # register split, not a narrower key tile, makes room for o, S and P
    for hd in fa.HEAD_DIMS:
        assert fa.tile_shape(torch.bfloat16, hd) == (128, 128)


def test_pad_queries_attend_to_pads_of_their_own_row():
    """Segment equality, not a key-padding mask: a pad query averages the pad
    keys' values, a real query the real keys'."""
    q, k, v, seg = _case(1, 1, 256, 32, [100], seed=5)
    q[:] = 0.0  # uniform attention inside a segment
    got = _port(q, k, v, seg)
    np.testing.assert_allclose(got[0, 0, 0], v[0, 0, :100].mean(axis=0), atol=2e-6)
    np.testing.assert_allclose(got[0, 0, 255], v[0, 0, 100:].mean(axis=0), atol=2e-6)


def test_any_sequence_length_and_strided_views():
    """The function is defined for any S >= 1 (the encoder's gate is not the
    kernel's), and for (B, nh, S, hd) views of (B, S, nh*hd) projections: the
    result keeps q's strides, so flattening the heads again is a view."""
    rng = np.random.default_rng(7)
    b, s, nh, hd = 2, 37, 3, 16
    proj = [torch.from_numpy(rng.standard_normal((b, s, nh * hd)).astype(np.float32))
            for _ in range(3)]
    q, k, v = (p.view(b, s, nh, hd).transpose(1, 2) for p in proj)
    seg = torch.from_numpy((np.arange(s)[None, :] < np.array([[37], [5]])).astype(np.int32))
    out = fa.flash_attention(q, k, v, seg, 0.25)
    dense = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), seg, 0.25)
    assert torch.equal(out, dense)
    want = _jax_reference(*(x.contiguous().numpy() for x in (q, k, v)), seg.numpy())
    assert np.abs(out.numpy() - want).max() <= F32_TOL
    one = fa.flash_attention(q[:, :, :1], k[:, :, :1], v[:, :, :1], seg[:, :1].contiguous(), 1.0)
    assert torch.equal(one, v[:, :, :1])  # S = 1: softmax of one logit


def test_mask_value_is_the_tpu_kernels():
    assert np.float32(fa.MASK_VALUE) == np.float32(jax_fa.DEFAULT_MASK_VALUE)
    assert np.isfinite(fa.MASK_VALUE)


@pytest.mark.parametrize("bad, exc", [
    ("shape", ValueError), ("dtype", TypeError), ("mixed", TypeError),
    ("seg_shape", ValueError), ("seg_dtype", TypeError), ("empty", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    q = torch.zeros((2, 2, 8, 16))
    k, v, seg = q.clone(), q.clone(), torch.ones((2, 8), dtype=torch.int32)
    if bad == "shape":
        k = k[:, :, :4]
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        v = v.to(torch.bfloat16)
    elif bad == "seg_shape":
        seg = seg[:, :4]
    elif bad == "seg_dtype":
        seg = seg.long()
    elif bad == "empty":
        q = k = v = torch.zeros((0, 2, 8, 16))
        seg = torch.ones((0, 8), dtype=torch.int32)
    with pytest.raises(exc):
        fa.flash_attention(q, k, v, seg, 1.0)


def test_kernel_has_a_source_counts_launches_and_builds_nothing_at_import():
    import os
    import re

    from minivectordb_tpu_torch.kernels import build

    assert fa._fns == {} and "flash_attention" not in build.build_info
    with open(os.path.join(build.CSRC_DIR, "flash_attention.cu"), encoding="utf-8") as f:
        src = f.read()
    for symbol in ("flash_attention_f32", "flash_attention_bf16"):
        assert f'extern "C" int {symbol}(' in src
        assert symbol in fa._ARGTYPES and fa.LAUNCHES[symbol] == 0
    for ptx in ("wgmma.mma_async.sync.aligned.m64n64k16", "cp.async.bulk.tensor",
                "mbarrier.try_wait", "cp.async.mbarrier.arrive"):
        assert ptx in src
    assert "mma.sync" not in src  # the first kernels are replaced, not kept beside
    for word in ("cublas", "cutlass", "cudnn"):
        assert word not in src.lower()
    for hd in (32, 48, 64, 128):
        assert hd in fa.HEAD_DIMS and f"FLASH_CASE({hd})" in src
    assert f"{np.float32(fa.MASK_VALUE):.7e}".replace("e+", "e") + "f" in src
    # bfloat16: a producer warpgroup (384 threads a block) gives registers to
    # the two consumer warpgroups. The split must fit the 168 registers a
    # thread that __launch_bounds__(384, 1) leaves (65,536 / 384, rounded
    # down to a multiple of 8), or the consumers would wait forever.
    for ptx in ("setmaxnreg.dec.sync.aligned.u32", "setmaxnreg.inc.sync.aligned.u32"):
        assert ptx in src
    assert "static constexpr int THREADS = CONSUMERS + 128;" in src
    assert "__launch_bounds__(BfCfg<HD>::THREADS, 1)" in src
    assert "flash_bf16_kernel<HD><<<blocks, Cfg::THREADS, smem, p.stream>>>" in src
    assert "constexpr int CONSUMERS = 256;" in src
    regs = re.search(r"PRODUCER_REGS = (\d+), CONSUMER_REGS = (\d+);", src)
    producer, consumer = int(regs.group(1)), int(regs.group(2))
    assert all(r % 8 == 0 and 24 <= r <= 256 for r in (producer, consumer))
    assert 128 * producer + 256 * consumer <= 384 * (65536 // 384 // 8 * 8)
    assert "attr.numRegs * threads < regs" in src  # a block that could not split is refused
    # its tiles land as slabs in the widest TMA swizzle whose row divides hd,
    # every width the kernel is built for has one
    assert "SPAN = HD % 64 == 0 ? 128 : HD % 32 == 0 ? 64 : 32;" in src
    for mode in ("SWIZZLE_128B", "SWIZZLE_64B", "SWIZZLE_32B"):
        assert f"CU_TENSOR_MAP_{mode}" in src
    for hd in fa.HEAD_DIMS:
        span = 128 if hd % 64 == 0 else 64 if hd % 32 == 0 else 32
        assert hd % (span // 2) == 0 and 128 * hd * 2 % 1024 == 0


def test_f32_kernel_register_split_and_slab_span():
    """float32 runs 3xTF32 on wgmma in the bfloat16 kernel's skeleton: a
    producer warpgroup whose registers go to the two consumer warpgroups (the
    split must fit the 384 x 168 registers the block is charged, or the
    consumers would wait forever), three of its warps helping (K and V into
    TF32 hi / lo words, V transposed), and tiles landing as slabs in the
    widest TMA swizzle that divides a row's 4 * hd bytes. Every width's
    query slot, two stages and the ids fit a block's shared memory."""
    import os
    import re

    from minivectordb_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC_DIR, "flash_attention.cu"), encoding="utf-8") as f:
        src = f.read()
    f32 = src[src.index("struct F32Cfg {"):]
    f32 = f32[:f32.index("};")]
    # one split up to hd = 64 and one above (o and Q's lo grow with hd)
    prod = re.search(r"PRODUCER_REGS = HD > 64 \? (\d+) : (\d+);", f32)
    cons = re.search(r"CONSUMER_REGS = HD > 64 \? (\d+) : (\d+);", f32)
    assert prod and cons
    for producer, consumer in zip(map(int, prod.groups()), map(int, cons.groups())):
        assert all(r % 8 == 0 and 24 <= r <= 256 for r in (producer, consumer))
        assert 128 * producer + 256 * consumer <= 384 * (65536 // 384 // 8 * 8) == 384 * 168
    assert "static constexpr int THREADS = CONSUMERS + 128;" in f32
    assert "static constexpr int HELPERS = 96;" in f32  # the producer warpgroup's other warps
    assert "__launch_bounds__(F32Cfg<HD>::THREADS, 1)" in src
    assert "flash_f32_kernel<HD><<<blocks, C::THREADS, smem, p.stream>>>" in src
    assert "constexpr int regs = 128 * C::PRODUCER_REGS + CONSUMERS * C::CONSUMER_REGS;" in src
    for ptx in ("wgmma.mma_async.sync.aligned.m64n\" #N \"k8.f32.tf32.tf32", "cvt.rna.tf32.f32",
                "fence.proxy.async.shared::cta"):
        assert ptx in src
    assert "static constexpr int SPAN = HD % 32 == 0 ? 128 : 64;" in f32
    for hd in fa.HEAD_DIMS:
        span = 128 if hd % 32 == 0 else 64
        widest = max(w for w in (32, 64, 128) if 4 * hd % w == 0)
        assert span == widest
    # shared memory: a query slot of 128 x hd words, and per stage four tiles
    # of KT x hd words (K, K lo where V lands first, V^T hi, V^T lo), the
    # ids, the barriers and their scratch; as many stages as fit with one
    # slot, at most four, then a second slot if it fits (csrc's Layout)
    assert ("static constexpr int ST = L<1, 4>::BYTES <= SMEM_LIMIT ? 4 : "
            "L<1, 3>::BYTES <= SMEM_LIMIT ? 3 : 2;") in f32
    assert "static constexpr int NQ = L<2, ST>::BYTES <= SMEM_LIMIT ? 2 : 1;" in f32
    assert "using L = Layout<QB, NQ_, ST_, 2 * TB, 2 * TB, 64, F32_BM, KT>;" in f32

    def layout_bytes(hd, nq, st):
        kt = fa.tile_shape(torch.float32, hd)[1]
        ids = 64 + nq * 128 * 4 + st * kt * 4  # ready barriers' scratch, query and key ids
        return nq * 128 * hd * 4 + st * 4 * kt * hd * 4 + ids + 3 * st * 8 + nq * 8

    for hd in fa.HEAD_DIMS:
        kt = fa.tile_shape(torch.float32, hd)[1]
        assert 128 * hd * 4 % 1024 == 0 and kt * hd * 4 % 1024 == 0 and hd * 128 % 1024 == 0
        st = next(n for n in (4, 3, 2) if layout_bytes(hd, 1, n) <= 232448)
        nq = 2 if layout_bytes(hd, 2, st) <= 232448 else 1
        assert layout_bytes(hd, nq, st) <= 232448
        # three stages or more where Q stays in registers (hd <= 64), two above
        assert st >= (3 if hd <= 64 else 2), hd


@pytest.mark.parametrize("hd", [48, 64, 128])
def test_profile_search_attention_takes_the_slots_widths(hd):
    """``profile_search --attention --hd --heads`` parses at every head width
    the slots and the e5 encoders use, keeps today's shape by default, and
    stops without a CUDA device: it has no CPU fallback."""
    import os
    import subprocess
    import sys

    from minivectordb_tpu_torch import profile_search

    args = profile_search.parse_args(["--attention", "--hd", str(hd), "--heads", "8",
                                      "--seq", "256", "--batch", "64",
                                      "--against", "OTHER/flash_attention.cu"])
    assert (args.hd, args.heads, args.seq, args.batch, args.attention) == (hd, 8, 256, 64, True)
    default = profile_search.parse_args(["--attention"])
    assert (default.hd, default.heads, default.seq, default.batch) == (64, 16, 512, None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "minivectordb_tpu_torch.profile_search", "--attention",
         "--hd", str(hd), "--heads", "8", "--seq", "256"],
        cwd=root, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0 and "needs a CUDA device" in res.stderr, res.stderr


@pytest.mark.parametrize("argv", [["--hd", "100"], ["--hd", "256"], ["--hd", "8"],
                                  ["--heads", "0"]])
def test_profile_search_attention_refuses_a_width_the_kernel_is_not_built_for(argv):
    """A head width outside HEAD_DIMS (or no heads) is refused while the
    command line is read, before any CUDA call, with the widths it takes."""
    import os
    import subprocess
    import sys

    from minivectordb_tpu_torch import profile_search

    with pytest.raises(SystemExit) as exc:
        profile_search.parse_args(["--attention", *argv])
    assert exc.value.code == 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "minivectordb_tpu_torch.profile_search", "--attention", *argv],
        cwd=root, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 2 and "needs a CUDA device" not in res.stderr, res.stderr
    assert ("the kernels are built for" in res.stderr if "--hd" in argv
            else "must be at least 1" in res.stderr), res.stderr


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs this check")
    q, k, v, seg = _case(2, 2, 200, 64, [200, 70], seed=9)
    args = [torch.from_numpy(x).cuda() for x in (q, k, v, seg)]
    got = fa.flash_attention(*args, 0.125)
    want = fa.flash_attention_plain(*args, 0.125)
    assert float((got - want).abs().max()) <= F32_TOL
