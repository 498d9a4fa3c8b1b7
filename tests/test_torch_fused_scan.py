"""ops/fused_scan.py of the PyTorch port against
minivectordb_tpu.ops.pallas_scan, on the CPU: the JAX side runs its Pallas
kernels in interpret mode (it does so by itself on the CPU backend), the port
runs the kernels' plain versions (a CUDA kernel cannot run here; each is held
against its plain version on the card by chip_smoke.py).

Tolerances: subtile maxima atol 1e-5 for float32 (another summation order),
1e-5 for the bfloat16 shadow (products of bf16 values are exact in float32),
1e-6 for int8 (exact integer dots, two float32 multiplies). Fused top-k: ids
equal, scores atol 1e-5 (int8 1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minivectordb_tpu.ops import pallas_scan as jfused
from minivectordb_tpu.ops import scan as jscan
from minivectordb_tpu_torch.ops import fused_scan as tfused
from minivectordb_tpu_torch.ops import scan as tscan


def _setup(seed, n, d, cap, b):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, d)).astype(np.float32)
    full = np.vstack([mat, rng.standard_normal((cap - n, d)).astype(np.float32)])
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(cap) < 0.5
    return rng, mat, full, q, mask


def _normalized(q):
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-30)


def test_constants_match():
    assert tfused.SUBTILE == jfused.SUBTILE == 32
    assert tfused._PHASE3_CHUNK == jfused._PHASE3_CHUNK
    assert tfused._SUPER == jfused._SUPER
    assert np.float32(tfused._MASKED_SCORE) == jfused._MASKED_SCORE


# Batch sizes of the cases that are not 8 (keyed by (cap, d, count)): the edges
# of the Hopper kernel's tiling. 4064 rows are not a whole number of its
# 128-row tiles; each such `count` lies inside the last live tile.
_BATCH = {
    (4064, 32, 4014): 13, (4096, 1024, 3996): 70, (8192, 48, 8150): 200,
    (4608, 768, 4550): 64, (4096, 1536, 2085): 16,
}
_TILING_CASES = list(_BATCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize(
    "cap,d,count", [(4096, 16, 3001), (4096, 24, 4096), (16384, 32, 9000)] + _TILING_CASES
)
def test_subtile_maxima_plain_vs_pallas(dtype, use_mask, cap, d, count):
    """`count` = 3001 falls inside a subtile (3001 = 93 * 32 + 25)."""
    b = _BATCH.get((cap, d, count), 8)
    _, _, full, q, mask = _setup(cap + d, count, d, cap, b)
    qn = _normalized(q)
    jb, tb = jnp.asarray(full), torch.from_numpy(full)
    jq, tq = jnp.asarray(qn), torch.from_numpy(qn)
    if dtype == "bfloat16":
        jb, tb = jb.astype(jnp.bfloat16), tb.to(torch.bfloat16)
        jq, tq = jq.astype(jnp.bfloat16), tq.to(torch.bfloat16)
    ji, ti = jscan.row_inv_norms(jb), tscan.row_inv_norms(tb)
    want = np.asarray(
        jfused.subtile_maxima(
            jb, ji, jq, count,
            jnp.asarray(mask.astype(np.float32)) if use_mask else None,
        )
    ).T
    tm = torch.from_numpy(mask) if use_mask else None
    got = tfused.subtile_maxima_plain(tb, ti, tq, count, tm)
    assert got.shape == (b, cap // 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # masked and past-count subtiles are exactly the sentinel
    np.testing.assert_array_equal(got.numpy() == -3.0e38, want == -3.0e38)
    # on a CPU tensor the wrapper IS the plain version
    np.testing.assert_array_equal(
        tfused.subtile_maxima(tb, ti, tq, count, tm).numpy(), got.numpy()
    )


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize(
    "cap,d,count", [(4096, 16, 3001), (4096, 24, 4000), (8192, 32, 8192)] + _TILING_CASES
)
def test_subtile_maxima_int8_plain_vs_pallas(use_mask, cap, d, count):
    b = _BATCH.get((cap, d, count), 8)
    _, _, full, q, mask = _setup(cap + d + 1, count, d, cap, b)
    ri, rinv = tscan.quantize_rows_int8_host(full)
    tqi, tqinv = tscan.quantize_queries_int8(torch.from_numpy(q))
    want = np.asarray(
        jfused._subtile_maxima_int8(
            jnp.asarray(ri), jnp.asarray(rinv), jnp.asarray(tqi.numpy()),
            jnp.asarray(tqinv.numpy()), count,
            jnp.asarray(mask.astype(np.float32)) if use_mask else None,
        )
    ).T
    tm = torch.from_numpy(mask) if use_mask else None
    got = tfused.subtile_maxima_int8_plain(
        torch.from_numpy(ri), torch.from_numpy(rinv), tqi, tqinv, count, tm
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.numpy() == -3.0e38, want == -3.0e38)
    np.testing.assert_array_equal(
        tfused.subtile_maxima_int8(
            torch.from_numpy(ri), torch.from_numpy(rinv), tqi, tqinv, count, tm
        ).numpy(),
        got.numpy(),
    )


def test_query_quantization_matches_jax():
    rng = np.random.default_rng(21)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    q[2] = 0.0
    q[3, 0] = 0.5 * np.abs(q[3]).max() / 127 * 3  # lands near a rounding half
    qf = jnp.asarray(q)
    qmax = jnp.max(jnp.abs(qf), axis=-1, keepdims=True)
    qscale = jnp.maximum(qmax, 1e-30) / 127.0
    want = np.asarray(jnp.clip(jnp.round(qf / qscale), -127, 127).astype(jnp.int8))
    got, ginv = tscan.quantize_queries_int8(torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().min() >= -127
    norms = np.linalg.norm(want.astype(np.float32), axis=-1)
    np.testing.assert_allclose(
        ginv.numpy(), 1.0 / np.maximum(norms, 1e-30), rtol=1e-6
    )


@pytest.mark.parametrize(
    "bad",
    ["dtype_mismatch", "capacity", "noncontiguous", "mask_dtype", "inv_shape", "odd_bf16"],
)
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    buf = torch.zeros((64, 16))
    inv = torch.zeros(64)
    q = torch.zeros((8, 16))
    mask = None
    if bad == "dtype_mismatch":
        q = q.to(torch.bfloat16)
    elif bad == "capacity":
        buf, inv = torch.zeros((48, 16)), torch.zeros(48)
    elif bad == "noncontiguous":
        buf = torch.zeros((16, 64)).T
    elif bad == "mask_dtype":
        mask = torch.ones(64)
    elif bad == "inv_shape":
        inv = torch.zeros(32)
    elif bad == "odd_bf16":
        buf, q = torch.zeros((64, 3), dtype=torch.bfloat16), torch.zeros((8, 3), dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        tfused.subtile_maxima(buf, inv, q, 64, mask)


def test_launch_counters_do_not_move_on_cpu():
    before = dict(tfused.LAUNCHES)
    narrow = dict(tfused.NARROW_LAUNCHES)
    tfused.subtile_maxima(torch.zeros((64, 16)), torch.zeros(64), torch.zeros((8, 16)), 64)
    bf = torch.zeros((64, 16), dtype=torch.bfloat16)
    tfused.subtile_maxima(bf, torch.zeros(64), bf[:8], 64, torch.ones(64, dtype=torch.bool))
    for d in (24, 32):  # a narrow and a wide int8 row
        i8 = torch.zeros((64, d), dtype=torch.int8)
        tfused.subtile_maxima_int8(i8, torch.zeros(64), i8[:8], torch.ones(8), 64)
    assert tfused.LAUNCHES == before
    assert tfused.NARROW_LAUNCHES == narrow
    assert set(before) == {
        "phase1_f32", "phase1_f32_mask", "phase1_bf16", "phase1_bf16_mask",
        "phase1_i8", "phase1_i8_mask",
    }
    assert set(narrow) == set(before)  # float32 rows too can be narrow


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("count", [0, 4000, 4096])
def test_plain_versions_write_the_sentinel_past_count(kind, count):
    """Every subtile wholly at or past `count` is exactly the sentinel, and
    none before it (no row is masked): the kernels' output comes from
    torch.empty, so each must write those subtiles too."""
    _, _, full, q, _ = _setup(5, 4096, 64, 4096, 12)
    if kind == "int8":
        ri, rinv = tscan.quantize_rows_int8_host(full)
        qi, qinv = tscan.quantize_queries_int8(torch.from_numpy(q))
        got = tfused.subtile_maxima_int8_plain(
            torch.from_numpy(ri), torch.from_numpy(rinv), qi, qinv, count)
    else:
        dt = getattr(torch, kind)
        tb = torch.from_numpy(full).to(dt)
        got = tfused.subtile_maxima_plain(
            tb, tscan.row_inv_norms(tb), torch.from_numpy(_normalized(q)).to(dt), count)
    live = -(-count // 32)
    assert (got[:, live:] == -3.0e38).all()
    assert (got[:, :live] > -3.0e38).all()


def test_misaligned_operands_are_copied_aligned():
    base = torch.zeros(4096 + 1, dtype=torch.int8)
    view = base[1:]
    assert view.data_ptr() % 16 != 0
    fixed = tfused._aligned16(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    aligned = base[16:]
    assert tfused._aligned16(aligned) is aligned


@pytest.mark.parametrize("n_sub", [8, 26, 63, 70])
def test_phase2_both_branches(n_sub):
    """2048 subtiles = 64 supertiles: n_sub < 64 takes the two-level branch,
    n_sub >= 64 the direct one. Both must select what the JAX function
    selects, in its order."""
    rng = np.random.default_rng(3)
    maxima = rng.standard_normal((4, 2048)).astype(np.float32)
    maxima[:, 100:140] = -3.0e38  # a run of tied (masked) subtiles
    want = np.asarray(jfused._phase2_topk_subtiles(jnp.asarray(maxima), n_sub))
    got = tfused._phase2_topk_subtiles(torch.from_numpy(maxima), n_sub).numpy()
    np.testing.assert_array_equal(got, want)
    _, direct = jax.lax.top_k(jnp.asarray(maxima), n_sub)
    for b in range(4):
        assert set(got[b].tolist()) == set(np.asarray(direct)[b].tolist())


def test_phase2_small_input_takes_direct_branch():
    rng = np.random.default_rng(4)
    maxima = rng.standard_normal((3, 96)).astype(np.float32)  # 3 supertiles < 4
    want = np.asarray(jfused._phase2_topk_subtiles(jnp.asarray(maxima), 5))
    got = tfused._phase2_topk_subtiles(torch.from_numpy(maxima), 5).numpy()
    np.testing.assert_array_equal(got, want)


_FUSED_CASES = {
    # name: (n, d, b, k, kwargs)
    "plain": (9000, 32, 20, 8, {}),
    "b3_padded_to_8": (9000, 32, 3, 8, {}),
    "b128_two_chunks": (6000, 16, 128, 8, {}),
    "mask": (6000, 24, 16, 8, {"mask": True}),
    "margin0": (20000, 32, 16, 8, {"margin": 0}),
    "scan_buf": (6000, 24, 16, 8, {"scan_buf": True}),
    "scan_buf_mask": (6000, 24, 16, 16, {"scan_buf": True, "mask": True}),
    "two_level_phase2": (40000, 16, 16, 8, {}),
    "bfloat16_buffer": (6000, 24, 16, 8, {"bf16": True}),
}


@pytest.mark.parametrize("case", sorted(_FUSED_CASES))
def test_fused_scan_topk_vs_pallas(case):
    n, d, b, k, opts = _FUSED_CASES[case]
    cap = jscan.capacity_bucket(n)
    _, _, full, q, mask = _setup(len(case) + n, n, d, cap, b)
    jb, tb = jnp.asarray(full), torch.from_numpy(full)
    if opts.get("bf16"):
        jb, tb = jb.astype(jnp.bfloat16), tb.to(torch.bfloat16)
    ji, ti = jscan.row_inv_norms(jb), tscan.row_inv_norms(tb)
    jkw, tkw = {}, {}
    if opts.get("mask"):
        jkw["mask"], tkw["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if "margin" in opts:
        jkw["margin"] = tkw["margin"] = opts["margin"]
    if opts.get("scan_buf"):
        jkw["scan_buf"] = jb.astype(jnp.bfloat16)
        tkw["scan_buf"] = tb.to(torch.bfloat16)
    jv, jx = jfused.pallas_scan_topk(jb, ji, jnp.asarray(q), n, k, **jkw)
    tv, tx = tfused.fused_scan_topk(tb, ti, torch.from_numpy(q), n, k, **tkw)
    assert tv.shape == (b, k) and tx.dtype == torch.int32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    assert (tx.numpy() < n).all()


@pytest.mark.parametrize("case", ["plain", "mask", "b3", "b128", "margin0"])
def test_fused_scan_topk_int8_vs_pallas(case):
    n, d, k = 5000, 32, 8
    b = {"b3": 3, "b128": 128}.get(case, 16)
    cap = jscan.capacity_bucket(n)
    _, _, full, q, mask = _setup(31 + b, n, d, cap, b)
    ri, rinv = tscan.quantize_rows_int8_host(full)
    jkw, tkw = {}, {}
    if case == "mask":
        jkw["mask"], tkw["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if case == "margin0":
        jkw["margin"] = tkw["margin"] = 0
    jv, jx = jfused.pallas_scan_topk_int8(
        jnp.asarray(ri), jnp.asarray(rinv), jnp.asarray(q), n, k, **jkw
    )
    tv, tx = tfused.fused_scan_topk_int8(
        torch.from_numpy(ri), torch.from_numpy(rinv), torch.from_numpy(q), n, k, **tkw
    )
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


def test_fused_scan_duplicate_rows_match_jax_order():
    """Tied rows: order among equal scores is position in the gathered
    candidates, as in the JAX function."""
    n, d, b, k = 6000, 16, 16, 8
    cap = jscan.capacity_bucket(n)
    _, mat, full, q, _ = _setup(77, n, d, cap, b)
    for r in (40, 41, 3000, 5999):
        full[r] = full[7]
    q[0] = full[7]
    jb, tb = jnp.asarray(full), torch.from_numpy(full)
    jv, jx = jfused.pallas_scan_topk(jb, jscan.row_inv_norms(jb), jnp.asarray(q), n, k)
    tv, tx = tfused.fused_scan_topk(tb, tscan.row_inv_norms(tb), torch.from_numpy(q), n, k)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert set(tx.numpy()[0, :5].tolist()) == {7, 40, 41, 3000, 5999}


def test_fused_scan_int8_exact_at_d_1536():
    rng = np.random.default_rng(13)
    n, d, b, k = 4096, 1536, 16, 4
    mat = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    ri, rinv = tscan.quantize_rows_int8_host(mat)
    jv, jx = jfused.pallas_scan_topk_int8(
        jnp.asarray(ri), jnp.asarray(rinv), jnp.asarray(q), n, k
    )
    tv, tx = tfused.fused_scan_topk_int8(
        torch.from_numpy(ri), torch.from_numpy(rinv), torch.from_numpy(q), n, k
    )
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
