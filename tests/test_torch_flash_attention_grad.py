"""Flash attention's backward (K7, K8) and K6's row log-sum-exp on the CPU:
the port's plain versions, autograd through ``flash_attention_plain`` and the
``FlashAttention`` autograd Function, against ``jax.vjp`` of JAX's Pallas TPU
flash attention run in interpret mode (its custom VJP runs the two backward
kernels), on the same seeded inputs, at every position, pads included.

JAX's ``mha_reference`` is no reference here: its backward raises
``NotImplementedError`` with segment ids.

Tolerance: 2e-5 for the gradients and the log-sum-exp (float32 sums of at most
S products in another order; gradients reach about 3, the log-sum-exp about 8;
a scratch run matched to 1e-6).

bfloat16 (the same cases, inputs rounded to bfloat16 by both packages): the
TPU kernels round P, and dS * sm_scale, to bfloat16 before their products, and
the port's plain backward rounds at the same points. Given JAX's own forward
output and log-sum-exp, it is held per tensor to BF16_MAX_TOL (one bfloat16
ulp of the tensor's largest value: an element whose float32 sum lies on the
other side of a rounding boundary moves by one of its ulps) and to
BF16_MEAN_TOL for the mean error over the mean value (a scratch run: at most
3e-6, 0.12% of the elements differing; without the two roundings 1.6e-3, 41%
of the elements differing). End to end through the port's own forward, whose
output rounds P V in another order than the TPU's, the gradients are held to
BF16_MAX_TOL (a scratch run: 4.5e-3 of the largest value at most).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_fa

from minivectordb_tpu_torch.ops import flash_attention as fa

TOL = 2e-5
BF16_MAX_TOL = 2.0 ** -7  # of max |JAX| over the tensor
BF16_MEAN_TOL = 2.0 ** -12  # mean |port - JAX| over mean |JAX|


def _inputs(b, nh, s, hd, pattern, seed):
    """q, k, v, dO standard normal and segment ids: ``lengths`` (real tokens
    then pads, one row without pads and one with a single real token),
    ``packed`` (three sequences back to back, then pads) or ``cyclic``
    ((i // 37) % 3, ids that come back tile after tile)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, nh, s, hd)).astype(np.float32) for _ in range(4))
    i = np.arange(s)
    if pattern == "lengths":
        lengths = np.array([s, 1, s // 2 + 3, 77][:b])
        seg = (i[None, :] < lengths[:, None]).astype(np.int32)
    elif pattern == "packed":
        seg = np.zeros((b, s), np.int32)
        for row in range(b):
            cuts = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
            seg[row] = np.searchsorted(cuts, i, side="right") + 1
            seg[row][i >= cuts[2]] = 0
    else:
        seg = np.broadcast_to(((i // 37) % 3).astype(np.int32), (b, s)).copy()
    return q, k, v, do, seg


# the interpreted cases (about 3-5 s each on this CPU): S = 256, hd 32 and 64
CASES = {
    "lengths_hd32": (4, 2, 256, 32, "lengths", 1),
    "lengths_hd64": (4, 2, 256, 64, "lengths", 2),
    "packed_hd64": (2, 2, 256, 64, "packed", 3),
    "cyclic_hd32": (2, 2, 256, 32, "cyclic", 4),
}


def _private(result):
    """A copy of a cached result for one test: no test sees another's arrays."""
    if isinstance(result, tuple):
        return tuple(_private(x) for x in result)
    return np.array(result, copy=True)


def _jax(case: str):
    return _private(_jax_cached(case))


def _jax_bf16(case: str):
    return _private(_jax_bf16_cached(case))


@functools.lru_cache(maxsize=None)
def _jax_cached(case: str):
    """(inputs, lse = m + log l, (dq, dk, dv)) of JAX's TPU kernel interpreted."""
    b, nh, s, hd, pattern, seed = CASES[case]
    q, k, v, do, seg = _inputs(b, nh, s, hd, pattern, seed)
    ids = jax_fa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    scale = float(1.0 / np.sqrt(hd))
    args = [jnp.asarray(x) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        _out, vjp = jax.vjp(
            lambda q_, k_, v_: jax_fa.flash_attention(q_, k_, v_, segment_ids=ids,
                                                      sm_scale=scale), *args)
        grads = tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))
        blocks = jax_fa.BlockSizes.get_default(b, nh, s, s, hd)
        _o, l, m = jax_fa._flash_attention(*args, None, ids, True, False, scale, blocks, False)
    lse = np.asarray(m + jnp.log(l))
    return (q, k, v, do, seg), lse, grads


@functools.lru_cache(maxsize=None)
def _jax_bf16_cached(case: str):
    """The same case with q, k, v and dO rounded to bfloat16: (inputs as the
    float32 values of their bfloat16 roundings, out, lse = m + log l, (dq,
    dk, dv)), out and the gradients as float32 arrays of bfloat16 values."""
    b, nh, s, hd, pattern, seed = CASES[case]
    q, k, v, do, seg = _inputs(b, nh, s, hd, pattern, seed)
    # The roundings are made on the host (round to nearest even, as XLA's
    # conversion rounds) and both packages take these very values: the inputs
    # are never read back from JAX buffers, as the float32 cases' are not.
    rounded = tuple(torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v, do))
    ids = jax_fa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    scale = float(1.0 / np.sqrt(hd))
    args = [jnp.asarray(x).astype(jnp.bfloat16) for x in rounded[:3]]  # exact
    jdo = jnp.asarray(rounded[3]).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda q_, k_, v_: jax_fa.flash_attention(q_, k_, v_, segment_ids=ids,
                                                      sm_scale=scale), *args)
        grads = tuple(np.asarray(g.astype(jnp.float32)) for g in vjp(jdo))
        blocks = jax_fa.BlockSizes.get_default(b, nh, s, s, hd)
        _o, l, m = jax_fa._flash_attention(*args, None, ids, True, False, scale, blocks, False)
    return rounded + (seg,), np.asarray(out.astype(jnp.float32)), np.asarray(m + jnp.log(l)), grads


def _bf16(*arrays):
    """float32 arrays of bfloat16 values -> bfloat16 tensors (exact)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16) for a in arrays]


def _assert_bf16_close(got, want, mean_too: bool):
    """got: bfloat16 tensors; want: float32 arrays of JAX's bfloat16 values."""
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16, name
        err = np.abs(g.float().numpy() - w)
        assert err.max() <= BF16_MAX_TOL * np.abs(w).max(), (name, err.max())
        if mean_too:
            assert err.mean() <= BF16_MEAN_TOL * np.abs(w).mean(), (name, err.mean())


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_lse_equals_the_tpu_kernels_row_statistics(case):
    """K6's row statistic of bfloat16 inputs is float32: float32 sums of
    exact products, held to the float32 tolerance."""
    (q, k, v, _do, seg), _out, lse, _grads = _jax_bf16(case)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    _o, got = fa.flash_attention_lse_plain(*_bf16(q, k, v), torch.from_numpy(seg), scale)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - lse).max() <= TOL


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_plain_backward_rounds_where_the_tpu_kernels_round(case):
    """Given JAX's forward output and log-sum-exp, the plain backward of
    bfloat16 inputs is the TPU kernels' function: P and dS * sm_scale rounded
    to bfloat16 before the products, float32 sums. Without those roundings
    the mean error is about 7x BF16_MEAN_TOL."""
    (q, k, v, do, seg), out, lse, grads = _jax_bf16(case)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    tq, tk, tv, tdo, tout = _bf16(q, k, v, do, out)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, torch.from_numpy(seg), tout, tdo,
                                       torch.from_numpy(lse), scale)
    _assert_bf16_close(got, grads, mean_too=True)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_autograd_function_equals_the_tpu_kernels_vjp(case):
    """bfloat16 inputs that require grad go through FlashAttention (its own
    forward, then the plain backward on CPU tensors)."""
    (q, k, v, do, seg), _out, _lse, grads = _jax_bf16(case)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    tq, tk, tv = (t.requires_grad_() for t in _bf16(q, k, v))
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), scale)
    assert out.dtype == torch.bfloat16 and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (tq, tk, tv), _bf16(do)[0])
    _assert_bf16_close(got, grads, mean_too=False)


def test_delta_is_float32_from_float32_products():
    """delta = rowsum(dO * O), as K7 and K8 receive it, is float32 and summed
    from float32 products for bfloat16 tensors too (the TPU code's
    ``sum(o.astype(f32) * do.astype(f32), -1)``)."""
    q, k, v, do, seg = _inputs(2, 2, 64, 32, "lengths", 12)
    tq, tk, tv, tdo = (t.to(torch.bfloat16) for t in _t(q, k, v, do))
    tseg = torch.from_numpy(seg)
    out, lse = fa.flash_attention_lse_plain(tq, tk, tv, tseg, 0.25)
    delta = fa._bwd_operands(tq, tk, tv, tseg, out, tdo, lse)[-1]
    want = torch.sum(out.double() * tdo.double(), dim=-1)
    assert delta.dtype == torch.float32 and delta.shape == (2, 2, 64)
    assert float((delta.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", list(CASES))
def test_lse_equals_the_tpu_kernels_row_statistics(case):
    (q, k, v, _do, seg), lse, _grads = _jax(case)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    out, got = fa.flash_attention_lse(*_t(q, k, v, seg), scale)
    assert got.dtype == torch.float32 and got.shape == q.shape[:3]
    assert np.abs(got.numpy() - lse).max() <= TOL
    plain = fa.flash_attention_plain(*_t(q, k, v, seg), scale)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_equals_the_tpu_kernels_vjp(case):
    (q, k, v, do, seg), _lse, grads = _jax(case)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    tq, tk, tv, tdo, tseg = _t(q, k, v, do, seg)
    out, lse = fa.flash_attention_lse_plain(tq, tk, tv, tseg, scale)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, tseg, out, tdo, lse, scale)
    for name, g, want in zip("qkv", got, grads):
        assert np.isfinite(g.numpy()).all(), name
        assert np.abs(g.numpy() - want).max() <= TOL, name


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_through_the_plain_forward_equals_the_tpu_kernels_vjp(case):
    (q, k, v, do, seg), _lse, grads = _jax(case)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention_plain(tq, tk, tv, torch.from_numpy(seg), scale)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, g, want in zip("qkv", got, grads):
        assert np.abs(g.numpy() - want).max() <= TOL, name


@pytest.mark.parametrize("case", list(CASES))
def test_the_autograd_function_equals_the_tpu_kernels_vjp(case):
    """flash_attention with inputs that require grad goes through
    FlashAttention: on CPU tensors its forward and backward are the plain
    versions."""
    (q, k, v, do, seg), _lse, grads = _jax(case)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), scale)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, g, want in zip("qkv", got, grads):
        assert np.abs(g.numpy() - want).max() <= TOL, name


@pytest.mark.parametrize("pattern", ["lengths", "packed", "cyclic"])
@pytest.mark.parametrize("s, hd", [(37, 16), (129, 48), (200, 64)])
def test_function_equals_autograd_through_plain_at_any_length(s, hd, pattern):
    """The TPU kernel takes key blocks of 128 only; at other lengths the
    Function is held against autograd through the plain forward, on
    (B, nh, S, hd) views of (B, S, nh * hd) projections (the encoder's
    layout)."""
    q, k, v, do, seg = _inputs(3, 2, s, hd, pattern, seed=10 + s)
    proj = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
            .reshape(3, s, 2 * hd).requires_grad_() for x in (q, k, v)]
    views = [p.view(3, s, 2, hd).transpose(1, 2) for p in proj]
    tseg, tdo = torch.from_numpy(seg), torch.from_numpy(do)
    out = fa.flash_attention(*views, tseg, 0.3)
    got = torch.autograd.grad(out, proj, tdo)
    want = torch.autograd.grad(fa.flash_attention_plain(*views, tseg, 0.3), proj, tdo)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= TOL


@pytest.mark.parametrize("pattern", ["lengths", "packed"])
@pytest.mark.parametrize("s, hd", [(333, 48), (333, 80), (384, 48), (384, 80)])
def test_plain_backward_dq_at_ragged_tails_and_partial_column_groups(s, hd, pattern):
    """The plain backward's dQ (what chip_smoke.py holds K8 to) against
    autograd through the plain forward at the shapes that reach K8's ragged
    last tile (S = 333) and its partial float4 column groups (hd = 48, 80:
    12 and 20 of a thread grid's 16 and 32)."""
    q, k, v, do, seg = _inputs(4, 2, s, hd, pattern, seed=20 + s + hd)
    scale = float(1.0 / np.sqrt(hd))
    tq, tk, tv, tdo, tseg = _t(q, k, v, do, seg)
    out, lse = fa.flash_attention_lse_plain(tq, tk, tv, tseg, scale)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, tseg, out, tdo, lse, scale)[0]
    tq.requires_grad_()
    (want,) = torch.autograd.grad(fa.flash_attention_plain(tq, tk, tv, tseg, scale), tq, tdo)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


def test_no_graph_without_grad_mode_or_inputs_that_need_it():
    q, k, v, _do, seg = _inputs(2, 2, 40, 16, "lengths", 5)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    with torch.no_grad():
        out = fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), 0.25)
    assert out.grad_fn is None
    out = fa.flash_attention(*_t(q, k, v), torch.from_numpy(seg), 0.25)
    assert out.grad_fn is None and not out.requires_grad


def test_masked_keys_get_no_gradient():
    """A key of another segment contributes P = 0: its dK and dV are zero for
    queries of other segments (here every query of row 1 is real token 0 or
    a pad, so the pads' keys get gradient only from the pads)."""
    q, k, v, do, seg = _inputs(2, 1, 64, 16, "lengths", 6)
    do[1, :, 1:] = 0.0  # only row 1's real query (token 0) sends a gradient
    tq, tk, tv, tdo, tseg = _t(q, k, v, do, seg)
    out, lse = fa.flash_attention_lse_plain(tq, tk, tv, tseg, 0.25)
    dq, dk, dv = fa.flash_attention_bwd_plain(tq, tk, tv, tseg, out, tdo, lse, 0.25)
    assert torch.count_nonzero(dk[1, :, 1:]) == 0 and torch.count_nonzero(dv[1, :, 1:]) == 0
    assert torch.count_nonzero(dv[1, :, 0]) > 0


@pytest.mark.parametrize("bad", ["lse_shape", "lse_dtype", "dout_shape", "out_dtype"])
def test_backward_rejects_what_the_kernels_do_not_take(bad):
    q, k, v, do, seg = _inputs(2, 2, 16, 16, "lengths", 7)
    tq, tk, tv, tdo, tseg = _t(q, k, v, do, seg)
    out, lse = fa.flash_attention_lse_plain(tq, tk, tv, tseg, 0.25)
    if bad == "lse_shape":
        lse = lse[:, :, :8]
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "dout_shape":
        tdo = tdo[:, :, :8]
    else:
        out = out.double()
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(tq, tk, tv, tseg, out, tdo, lse, 0.25)


def test_bfloat16_gradients_on_the_cpu_use_the_plain_versions():
    """On CPU tensors the Function runs the plain versions in bfloat16 too
    (on the card, K6-bf16 with its log-sum-exp and the bfloat16 K7/K8)."""
    q, k, v, do, seg = _inputs(2, 2, 32, 16, "lengths", 8)
    tq, tk, tv = (t.to(torch.bfloat16).requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), 0.25)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).to(torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all() for g in got)


def test_backward_kernels_have_a_source_count_launches_and_build_nothing_at_import():
    import os

    from minivectordb_tpu_torch.kernels import build

    assert fa._fns == {} and "flash_attention_bwd" not in build.build_info
    assert "flash_attention_bwd" in build.SOURCES and "flash_attention" in build.SOURCES
    with open(os.path.join(build.CSRC_DIR, "flash_attention_bwd.cu"), encoding="utf-8") as f:
        bwd = f.read()
    with open(os.path.join(build.CSRC_DIR, "flash_attention.cu"), encoding="utf-8") as f:
        fwd = f.read()
    for symbol, src in (("flash_attention_bwd_dkv_f32", bwd), ("flash_attention_bwd_dq_f32", bwd),
                        ("flash_attention_lse_f32", fwd), ("flash_attention_lse_bf16", fwd)):
        assert f'extern "C" int {symbol}(' in src
        assert symbol in fa._ARGTYPES and fa.LAUNCHES[symbol] == 0
        assert fa._SOURCE[symbol] == ("flash_attention_bwd" if src is bwd else "flash_attention")
    # K7 / K8 argument lists: 9 / 8 pointers, 4 ints, 9 strides, scale, stream
    assert len(fa._ARGTYPES["flash_attention_bwd_dkv_f32"]) == 9 + 4 + 9 + 2
    assert len(fa._ARGTYPES["flash_attention_bwd_dq_f32"]) == 8 + 4 + 9 + 2
    for hd in fa.HEAD_DIMS:
        assert f"BWD_CASE({hd})" in bwd
    # K7 and K8 form their products (four and three) on the tensor cores in
    # 3xTF32 (wgmma with TF32 operands: A from shared memory for the hi words
    # of the first products, from registers otherwise; hi and lo words by
    # truncation where a kernel reads a tile, by cvt.rna where it writes one;
    # tiles by TMA onto mbarriers); no CUDA-core dot loop, no library. P is
    # one ex2.approx of a prescaled argument in both kernels
    k7 = bwd[bwd.index("bwd_dkv_tf32_kernel(const"):bwd.index("// K8: 3xTF32 on wgmma")]
    k8 = bwd[bwd.index("bwd_dq_tf32_kernel(const"):bwd.index("struct Problem {")]
    assert k7.count("Tf32Mma<KEYS>::rs(") == 4 and k7.count("Tf32Mma<KEYS>::ss(") == 2
    assert "tf32_split(" in k7 and "tf32_trunc(" in k7 and "fmaf(s[" not in k7
    assert "cvt.rna.tf32.f32" in bwd and "cp.async.bulk.tensor.5d" in bwd
    for n in (32, 64):  # K7's keys a block, K8's queries: N of the products
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 {{" in bwd
    assert k7.count("fast_exp2(fmaf(x, scale2, -lq[hh]))") == 1
    # K8: S^T and dP^T (one rs, in two groups above hd = 64, and two ss a
    # k-step), dQ^T (three rs)
    assert k8.count("Tf32Mma<QN>::rs(") == 2 and k8.count("Tf32Mma<QN>::ss(") == 2
    assert k8.count("Tf32Mma<NQ>::rs(") == 3
    assert "tf32_split(" in k8 and "tf32_trunc(" in k8 and "tma_load(" in k8
    assert k8.count("fast_exp2(fmaf(s, scale2, -(e ? lq.y : lq.x) * LOG2E))") == 1
    assert "fmaf(s[" not in k8 and "exp2f(" not in k8 and "for (int kk = 0; kk < HD;" not in k8
    assert "bwd_dq_tf32_kernel<HD><<<" in bwd and "bwd_dq_kernel" not in bwd  # the CUDA-core K8 is gone
    assert "mma.sync" not in bwd and "bwd_dkv_kernel" not in bwd  # the CUDA-core K7 is gone
    assert "atom." not in bwd and "atomicAdd" not in bwd  # deterministic: no atomics
    for word in ("cublas", "cutlass", "cudnn"):
        assert word not in bwd.lower()
    with pytest.raises(ValueError):
        build.load_library("not_a_source")



def _bwd_tile_consts():
    """The tile constants of the two backward sources: float32 K8's keys a
    step (W, in DqCfg); bfloat16
    K8's queries a block (QUERIES, in DqCfg) and its rule for W (W = HD <= a
    ? b : c), and K7's keys a block (KEYS, in DkvCfg) and its own rule for W;
    float32 K7's queries a step and keys a block, and K8's queries a block."""
    import os
    import re

    from minivectordb_tpu_torch.kernels import build

    def read(name):
        with open(os.path.join(build.CSRC_DIR, name + ".cu"), encoding="utf-8") as f:
            return f.read()

    def struct(src, name):
        body = src[src.index(f"struct {name} {{"):]
        return body[:body.index("};")]

    f32, bf16 = read("flash_attention_bwd"), read("flash_attention_bwd_bf16")
    dq_cfg, dkv_cfg = struct(bf16, "DqCfg"), struct(bf16, "DkvCfg")
    rule = r"constexpr int W = HD <= (\d+) \? (\d+) : (\d+);"
    w_dq = [int(x) for x in re.search(rule, dq_cfg).groups()]
    bt = int(re.search(r"constexpr int QUERIES = (\d+);", dq_cfg).group(1))
    w_dkv = [int(x) for x in re.search(rule, dkv_cfg).groups()]
    keys = int(re.search(r"constexpr int KEYS = (\d+);", dkv_cfg).group(1))
    # the float32 K7: W queries a step, KEYS keys a block by the head width
    f32_dkv = struct(f32, "DkvCfg")
    w_f32 = int(re.search(r"constexpr int W = (\d+);", f32_dkv).group(1))
    keys_f32 = [int(x) for x in re.search(r"constexpr int KEYS = HD <= (\d+) \? (\d+) : (\d+);",
                                          f32_dkv).groups()]
    # the float32 K8: W keys a step, QUERIES queries a block by the head width
    f32_dq = struct(f32, "DqCfg")
    t = int(re.search(r"constexpr int W = (\d+);", f32_dq).group(1))
    queries_f32 = [int(x) for x in re.search(
        r"constexpr int QUERIES = HD <= (\d+) \? (\d+) : (\d+);", f32_dq).groups()]
    return t, bt, w_dq, keys, w_dkv, w_f32, keys_f32, queries_f32


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_bwd_tile_shapes_match_the_kernels(hd):
    """What chip_smoke.py multiplies out for K7 / K8: the tiles on which each
    backward kernel decides to skip or multiply, read from the sources."""
    t, bt, w_dq, keys, w_dkv, w_f32, keys_f32, queries_f32 = _bwd_tile_consts()

    def w(rule):
        upto, then, other = rule
        return then if hd <= upto else other

    assert fa.bwd_tile_shapes(torch.float32, hd) == {"dkv": (w_f32, w(keys_f32)),
                                                     "dq": (w(queries_f32), t)}
    assert t == bt == w_f32 == fa.DKV_F32_STEP == fa.DQ_F32_STEP == 64
    assert fa.bwd_tile_shapes(torch.bfloat16, hd) == {"dkv": (w(w_dkv), keys),
                                                      "dq": (bt, w(w_dq))}


@pytest.mark.parametrize("pattern", ["lengths", "packed", "cyclic"])
@pytest.mark.parametrize("s", [200, 512])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_visited_tiles_at_the_backward_tiles(hd, s, pattern):
    """visited_tiles at each backward tile against the skipping rule walked
    tile by tile, and never below the tiles that hold a pair of one segment."""
    seg = _inputs(4, 1, s, 16, pattern, 6000 + s + hd)[4]
    shapes = {(d, name): shape for d in (torch.float32, torch.bfloat16)
              for name, shape in fa.bwd_tile_shapes(d, hd).items()}
    for what, (rows, keys) in shapes.items():
        loops = pairs = 0
        for row in range(seg.shape[0]):
            for m0 in range(0, s, rows):
                qt = seg[row, m0:m0 + rows]
                for n0 in range(0, s, keys):
                    kt = seg[row, n0:n0 + keys]
                    loops += not (kt.max() < qt.min() or kt.min() > qt.max())
                    pairs += bool(np.intersect1d(qt, kt).size)
        got = fa.visited_tiles(torch.from_numpy(seg), rows, keys)
        assert got == loops, what
        assert pairs <= got <= seg.shape[0] * -(-s // rows) * -(-s // keys), what


def test_profile_search_backward_parses_and_needs_a_card():
    """``profile_search --backward`` (and ``--train --against``) takes its
    options and stops without a CUDA device: it has no CPU fallback."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}

    def run(*args):
        return subprocess.run([sys.executable, "-m", "minivectordb_tpu_torch.profile_search",
                               *args], cwd=root, env=env, capture_output=True, text=True,
                              timeout=120)

    res = run("--backward", "--dtype", "bfloat16", "--batch", "8",
              "--against", "OTHER/flash_attention_bwd_bf16.cu")
    assert res.returncode != 0 and "needs a CUDA device" in res.stderr, res.stderr
    res = run("--train", "--dtype", "bfloat16", "--against", "OTHER/flash_attention_bwd_bf16.cu")
    assert res.returncode != 0 and "needs a CUDA device" in res.stderr, res.stderr
    bad = run("--backward", "--dtype", "float16")
    assert bad.returncode == 2 and "invalid choice" in bad.stderr, bad.stderr


def test_bwd_bf16_blocks_per_sm_names_its_kernel():
    """The occupancy query takes K7 ("dkv") or K8 ("dq") and nothing else;
    it is refused before any library is built."""
    from minivectordb_tpu_torch.kernels import build

    for bad in ("dk", "DKV", ""):
        with pytest.raises(ValueError):
            fa.bwd_bf16_blocks_per_sm(64, bad)
    assert "flash_attention_bwd_bf16" not in build.build_info
    with open(os.path.join(build.CSRC_DIR, "flash_attention_bwd_bf16.cu"), encoding="utf-8") as f:
        src = f.read()
    assert 'extern "C" int flash_attention_bwd_bf16_blocks_per_sm(int hd, int dkv, int* blocks)' in src
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src


_PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118bwd_dq_bf16_kernelILi64EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118bwd_dq_bf16_kernelILi64EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119bwd_dkv_bf16_kernelILi64EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119bwd_dkv_bf16_kernelILi64EEEvPK13__nv_bfloat16
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__171b0146_22_flash_attention_bwd_cu_fecfc4fd19bwd_dkv_tf32_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_bbPKfS3_PKiPfS6_iiNS_7StridesEf' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__171b0146_22_flash_attention_bwd_cu_fecfc4fd19bwd_dkv_tf32_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_bbPKfS3_PKiPfS6_iiNS_7StridesEf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 4 barriers, 592 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__171b0146_22_flash_attention_bwd_cu_fecfc4fd18bwd_dq_tf32_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_bbPKfS3_PKiPfiiNS_7StridesEf' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__171b0146_22_flash_attention_bwd_cu_fecfc4fd18bwd_dq_tf32_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_bbPKfS3_PKiPfiiNS_7StridesEf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 3 barriers, 592 bytes cmem[0]
"""


@pytest.mark.parametrize("kernel, want", [
    ("bwd_dkv_bf16_kernelILi64E", "Used 168 registers, used 1 barriers, 528 bytes cmem[0]; "
                                  "8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads"),
    ("bwd_dq_bf16_kernelILi64E", "Used 154 registers, used 1 barriers, 528 bytes cmem[0]; "
                                 "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("bwd_dkv_bf16_kernelILi128E", None),
    # the float32 K7 (3xTF32), whose name an older source does not hold: the
    # first name the log holds is reported
    ("bwd_dkv_tf32_kernelILi128E", "Used 254 registers, used 4 barriers, 592 bytes cmem[0]; "
                                   "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("bwd_dkv_kernelILi128E bwd_dkv_tf32_kernelILi128E",
     "Used 254 registers, used 4 barriers, 592 bytes cmem[0]; "
     "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("bwd_dkv_kernelILi64E bwd_dkv_tf32_kernelILi64E", None),
    # the float32 K8 (3xTF32), as profile_search asks for it: its new name,
    # then the name in sources before its 3xTF32 form
    ("bwd_dq_tf32_kernelILi64E bwd_dq_kernelILi64E",
     "Used 254 registers, used 3 barriers, 592 bytes cmem[0]; "
     "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ("bwd_dq_tf32_kernelILi128E bwd_dq_kernelILi128E", None),
])
def test_profile_search_reads_each_kernels_registers_and_spills(kernel, want):
    """``profile_search --backward`` reports what ptxas -v said of the kernel
    it times, found by its mangled name (the first of several names that the
    log holds), and nothing for a kernel the log does not hold."""
    from minivectordb_tpu_torch import profile_search

    assert profile_search._ptxas(_PTXAS_LOG, *kernel.split()) == want


@pytest.mark.cuda
def test_backward_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs this check")
    q, k, v, do, seg = _inputs(2, 2, 200, 64, "lengths", 9)
    tq, tk, tv, tdo, tseg = (t.cuda() for t in _t(q, k, v, do, seg))
    out, lse = fa.flash_attention_lse(tq, tk, tv, tseg, 0.125)
    got = fa.flash_attention_bwd(tq, tk, tv, tseg, out, tdo, lse, 0.125)
    want = fa.flash_attention_bwd_plain(tq, tk, tv, tseg, out, tdo, lse, 0.125)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= TOL


def test_bf16_backward_kernels_have_a_source_count_launches_and_run_on_the_tensor_cores():
    import os

    from minivectordb_tpu_torch.kernels import build

    assert "flash_attention_bwd_bf16" not in build.build_info
    assert "flash_attention_bwd_bf16" in build.SOURCES
    with open(os.path.join(build.CSRC_DIR, "flash_attention_bwd_bf16.cu"), encoding="utf-8") as f:
        src = f.read()
    for symbol, pointers in (("flash_attention_bwd_dkv_bf16", 9), ("flash_attention_bwd_dq_bf16", 8)):
        assert f'extern "C" int {symbol}(' in src
        assert fa._SOURCE[symbol] == "flash_attention_bwd_bf16"
        assert fa.LAUNCHES[symbol] == 0 and symbol not in fa._fns
        assert len(fa._ARGTYPES[symbol]) == pointers + 4 + 9 + 2
    for hd in fa.HEAD_DIMS:
        assert f"BWD_CASE({hd})" in src
    # bf16 products on the tensor cores with float32 accumulators; P and dS
    # rounded to bf16 in registers; no library. Both kernels on wgmma: S^T
    # and dP^T (K7) or S and dP (K8) with both operands in shared memory, dV
    # and dK (K7) or dQ (K8) with A from registers at every head width, their
    # tiles brought by TMA onto mbarriers
    k7 = src[src.index("bwd_dkv_bf16_kernel("):src.index("struct DqCfg {")]
    k8 = src[src.index("bwd_dq_bf16_kernel("):src.index("struct Problem")]
    for kernel in (k7, k8):
        assert "wgmma_ss<W>" in kernel and "wgmma_rs<HD>" in kernel and "pack_bf16" in kernel
        assert "mma(" not in kernel and "ldsm_x4" not in kernel
    for n in (32, 64):  # W, queries (K7) or keys (K8) a step
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{" in src
    for hd in fa.HEAD_DIMS:
        assert f"wgmma_rs<{hd}>(float (&d)[{hd // 2}]" in src
        assert f"wgmma.mma_async.sync.aligned.m64n{hd}k16.f32.bf16.bf16 {{" in src
    assert "cp.async.bulk.tensor.5d" in src and "mbarrier.try_wait" in src
    assert k7.count("tma_load(") == 4  # K, V once; a step's Q and dO
    assert k8.count("tma_load(") == 4  # Q, dO once; a step's K and V
    # K8's tiles in the 32-, 64- or 128-byte swizzle, whole slab rows a box row
    assert "smem_desc_sw<SPAN>" in k8 and "smem_desc(" not in k8
    for span in (32, 64, 128):
        assert f"CU_TENSOR_MAP_SWIZZLE_{span}B" in src
    # no mma.sync is left, nor its ldmatrix feed
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" not in src
    assert "ldmatrix.sync" not in src
    assert "atom." not in src and "atomicAdd" not in src  # deterministic: no atomics
    for word in ("cublas", "cutlass", "cudnn"):
        assert word not in src.lower()


@pytest.mark.cuda
def test_bf16_backward_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs this check")
    q, k, v, do, seg = _inputs(2, 2, 200, 64, "lengths", 9)
    tq, tk, tv, tdo = (t.cuda().to(torch.bfloat16) for t in _t(q, k, v, do))
    tseg = torch.from_numpy(seg).cuda()
    out, lse = fa.flash_attention_lse(tq, tk, tv, tseg, 0.125)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_bwd(tq, tk, tv, tseg, out, tdo, lse, 0.125)
    assert fa.LAUNCHES["flash_attention_bwd_dkv_bf16"] == before["flash_attention_bwd_dkv_bf16"] + 1
    assert fa.LAUNCHES["flash_attention_bwd_dq_bf16"] == before["flash_attention_bwd_dq_bf16"] + 1
    want = fa.flash_attention_bwd_plain(tq, tk, tv, tseg, out, tdo, lse, 0.125)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= BF16_MAX_TOL * scale + 2e-3
