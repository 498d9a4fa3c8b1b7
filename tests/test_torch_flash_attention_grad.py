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


@functools.lru_cache(maxsize=None)
def _jax(case: str):
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
    """On the card a bfloat16 backward raises (its K7/K8 are still to port);
    on CPU tensors the Function runs the plain versions in any float type."""
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
    # float32 FMAs on the CUDA cores: no tensor-core instruction, no library
    assert "fmaf" in bwd and "expf" in bwd
    assert "mma.sync" not in bwd and "mma_async" not in bwd
    for word in ("cublas", "cutlass", "cudnn"):
        assert word not in bwd.lower()
    with pytest.raises(ValueError):
        build.load_library("not_a_source")


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
