"""ops/scan.py of the PyTorch port against minivectordb_tpu.ops.scan, on the
CPU, on inputs made from a seed with numpy and handed to both.

Tolerances: ids equal; scores atol 1e-5 for float32 (another summation order),
2e-5 for bfloat16 buffers (float32 sums of exact bf16 products), 1e-6 for int8
(integer dots are exact; the scale is two float32 multiplies)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from minivectordb_tpu.ops import scan as jscan
from minivectordb_tpu_torch.ops import scan as tscan


def _corpus(seed, n, d, cap, zero_rows=(), dup=()):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, d)).astype(np.float32)
    for r in zero_rows:
        mat[r] = 0.0
    for a, b in dup:
        mat[b] = mat[a]
    full = np.vstack([mat, np.zeros((cap - n, d), np.float32)])
    return rng, mat, full


@pytest.mark.parametrize("n", [0, 1, 1024, 1025, 4096, 5000, (1 << 21) + 1, 5_000_000])
def test_capacity_bucket(n):
    assert tscan.capacity_bucket(n) == jscan.capacity_bucket(n)
    assert tscan.capacity_bucket(n, 8) == jscan.capacity_bucket(n, 8)


@pytest.mark.parametrize("k,cap", [(1, 1024), (5, 1024), (8, 4), (17, 4096), (1000, 512)])
def test_k_bucket(k, cap):
    assert tscan.k_bucket(k, cap) == jscan.k_bucket(k, cap)


@pytest.mark.parametrize("d,itemsize", [(16, 4), (384, 4), (384, 2), (384, 1), (1536, 4)])
def test_upload_slab_rows(d, itemsize):
    assert tscan.upload_slab_rows(d, itemsize) == jscan.upload_slab_rows(d, itemsize)


def test_masked_score_constant():
    assert tscan._MASKED_SCORE == jscan._MASKED_SCORE
    assert tscan._MASKED_SCORE.dtype == np.float32


def test_row_inv_norms():
    _, _, full = _corpus(0, 300, 24, 512, zero_rows=(3, 17))
    want = np.asarray(jscan.row_inv_norms(jnp.asarray(full)))
    got = tscan.row_inv_norms(torch.from_numpy(full)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[3] == 0.0 and got[17] == 0.0 and (got[300:] == 0).all()


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case", ["plain", "count_lt_c", "mask", "zero_rows", "k_gt_candidates", "ties"]
)
def test_scan_topk(dtype, case):
    n, d, cap, b, k = 700, 24, 1024, 5, 8
    zero = (4, 9) if case == "zero_rows" else ()
    dup = ((10, 20), (10, 650), (30, 31)) if case == "ties" else ()
    rng, mat, full = _corpus(11, n, d, cap, zero, dup)
    if case != "plain":
        # live-looking data in the padded zone must never be returned
        full[n:] = rng.standard_normal((cap - n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if case == "ties":
        q[0] = mat[10]  # three equal best rows
    mask = None
    if case == "mask":
        mask = rng.random(cap) < 0.5
    if case == "k_gt_candidates":
        mask = np.zeros(cap, bool)
        mask[[5, 99, 400]] = True
    jb = jnp.asarray(full)
    tb = torch.from_numpy(full)
    if dtype == "bfloat16":
        jb, tb = jb.astype(jnp.bfloat16), tb.to(torch.bfloat16)
    ji = jscan.row_inv_norms(jb)
    ti = tscan.row_inv_norms(tb)
    jv, jx = jscan.scan_topk(
        jb, ji, jnp.asarray(q), n, k, None if mask is None else jnp.asarray(mask)
    )
    tv, tx = tscan.scan_topk(
        tb, ti, torch.from_numpy(q), n, k,
        None if mask is None else torch.from_numpy(mask),
    )
    assert tv.dtype == torch.float32 and tx.dtype == torch.int32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(
        tv.numpy(), np.asarray(jv), rtol=0,
        atol=1e-5 if dtype == "float32" else 2e-5,
    )
    assert (tx.numpy()[tv.numpy() > -1e38] < n).all()
    if case == "k_gt_candidates":
        assert ((tv.numpy() > -1e38).sum(axis=1) == 3).all()
    if case == "ties":
        assert tx.numpy()[0, :3].tolist() == [10, 20, 650]


def test_scan_topk_bf16_scores_are_float32_precise():
    """A bfloat16 buffer still gives float32 sums (a bf16 matmul result would
    be off by ~3e-3)."""
    rng, _, full = _corpus(3, 512, 32, 512)
    tb = torch.from_numpy(full).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    tv, tx = tscan.scan_topk(tb, tscan.row_inv_norms(tb), q, 512, 4)
    qn = tscan._normalize(q).to(torch.bfloat16).to(torch.float64)
    rows = tb.to(torch.float64)
    exact = (qn @ rows.T) * tscan.row_inv_norms(tb).to(torch.float64)[None, :]
    want = torch.gather(exact, 1, tx.to(torch.int64))
    assert float((tv.to(torch.float64) - want).abs().max()) < 2e-6


def test_topk_last_axis_ties_across_kth_boundary():
    s = torch.tensor([[0.5, 0.75, 0.5, 0.5, -0.0, 0.0, 0.75]], dtype=torch.float32)
    v, i = tscan.topk_last_axis(s, 4)
    assert i.tolist() == [[1, 6, 0, 2]]
    assert v.tolist() == [[0.75, 0.75, 0.5, 0.5]]
    v, i = tscan.topk_last_axis(s, 7)
    assert i.tolist() == [[1, 6, 0, 2, 3, 4, 5]]  # -0.0 ties with +0.0
    neg = torch.tensor([[-3.0e38, -1.0, -3.0e38, -2.0]], dtype=torch.float32)
    assert tscan.topk_last_axis(neg, 4)[1].tolist() == [[1, 3, 0, 2]]


@pytest.mark.parametrize("case", ["plain", "mask", "zero_rows", "ties"])
def test_scan_topk_int8(case):
    n, d, cap, b, k = 900, 32, 1024, 4, 8
    zero = (7,) if case == "zero_rows" else ()
    dup = ((2, 3), (2, 500)) if case == "ties" else ()
    rng, mat, full = _corpus(5, n, d, cap, zero, dup)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if case == "ties":
        q[1] = mat[2]
    mask = rng.random(cap) < 0.6 if case == "mask" else None
    jb, ji = jscan.update_rows_int8(
        jnp.zeros((cap, d), jnp.int8), jnp.zeros((cap,), jnp.float32),
        jnp.asarray(full), 0,
    )
    tb, ti = tscan.update_rows_int8(
        torch.zeros((cap, d), dtype=torch.int8), torch.zeros(cap),
        torch.from_numpy(full), 0, in_place=True,
    )
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6, atol=0)
    jv, jx = jscan.scan_topk_int8(
        jb, ji, jnp.asarray(q), n, k, None if mask is None else jnp.asarray(mask)
    )
    tv, tx = tscan.scan_topk_int8(
        tb, ti, torch.from_numpy(q), n, k,
        None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


def test_int8_dots_exact_at_d_1536():
    """d * 127^2 passes 2^24 at d = 1041: the pieces are added in int32, so
    the dots stay exact integers (worst case: every value +-127)."""
    rng = np.random.default_rng(9)
    n, d = 64, 1536
    rows = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    rows[0] = 127
    rows[1] = -127
    qi = rng.integers(-127, 128, size=(3, d)).astype(np.int8)
    qi[0] = 127
    want = qi.astype(np.int64) @ rows.astype(np.int64).T
    got = tscan.dots_int8(torch.from_numpy(qi), torch.from_numpy(rows))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert want[0, 0] == 1536 * 127 * 127 > (1 << 24)
    # and the whole scan agrees with the JAX function at that width
    mat = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((3, d)).astype(np.float32)
    ri, rinv = tscan.quantize_rows_int8_host(mat)
    jv, jx = jscan.scan_topk_int8(
        jnp.asarray(ri), jnp.asarray(rinv), jnp.asarray(q), n, 8
    )
    tv, tx = tscan.scan_topk_int8(
        torch.from_numpy(ri), torch.from_numpy(rinv), torch.from_numpy(q), n, 8
    )
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


def test_quantize_rows_int8_host():
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((50, 24)).astype(np.float32)
    rows[5] = 0.0
    rows[6, 0] = 0.5 * np.abs(rows[6]).max()  # a value that rounds on a half
    ji, jn = jscan.quantize_rows_int8_host(rows)
    ti, tn = tscan.quantize_rows_int8_host(rows)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tn, jn)
    assert ti.min() >= -127 and tn[5] == 0.0
    # the host mirror equals the device quantizer
    db, dn = tscan.update_rows_int8(
        torch.zeros((64, 24), dtype=torch.int8), torch.zeros(64),
        torch.from_numpy(rows), 0, in_place=True,
    )
    np.testing.assert_array_equal(db.numpy()[:50], ti)
    np.testing.assert_allclose(dn.numpy()[:50], tn, rtol=1e-6)


def test_cast_rows_bf16_host():
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((40, 16)).astype(np.float32)
    rows[1] = 0.0
    jb, jn = jscan.cast_rows_bf16_host(rows)
    tb, tn = tscan.cast_rows_bf16_host(rows)
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jb).view(np.uint16),
    )
    np.testing.assert_array_equal(tn, jn)


@pytest.mark.parametrize("in_place", [True, False])
def test_update_rows(in_place):
    rng = np.random.default_rng(6)
    cap, d = 64, 16
    base = rng.standard_normal((cap, d)).astype(np.float32)
    rows = rng.standard_normal((8, d)).astype(np.float32)
    jb, ji = jscan.update_rows_nodonate(
        jnp.asarray(base), jscan.row_inv_norms(jnp.asarray(base)),
        jnp.asarray(rows), 24,
    )
    tb0 = torch.from_numpy(base.copy())
    ti0 = tscan.row_inv_norms(tb0)
    before = tb0.clone()
    tb, ti = tscan.update_rows(tb0, ti0, torch.from_numpy(rows), 24, in_place)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6)
    if in_place:
        assert tb is tb0 and ti is ti0
    else:
        assert tb is not tb0 and torch.equal(tb0, before)
    with pytest.raises(ValueError):
        tscan.update_rows(tb, ti, torch.from_numpy(rows), cap - 4, True)


@pytest.mark.parametrize("in_place", [True, False])
def test_update_rows_cast_and_write_rows_pre(in_place):
    rng = np.random.default_rng(7)
    cap, d = 32, 16
    rows = rng.standard_normal((8, d)).astype(np.float32)
    shadow0 = torch.zeros((cap, d), dtype=torch.bfloat16)
    shadow = tscan.update_rows_cast(shadow0, torch.from_numpy(rows), 8, in_place)
    want = np.asarray(
        jscan.update_rows_cast_nodonate(
            jnp.zeros((cap, d), jnp.bfloat16), jnp.asarray(rows), 8
        )
    ).view(np.uint16)
    np.testing.assert_array_equal(
        shadow.view(torch.int16).numpy().view(np.uint16), want
    )
    assert (shadow is shadow0) == in_place
    if not in_place:
        assert not shadow0.any()

    qi, qn = tscan.quantize_rows_int8_host(rows)
    buf0 = torch.zeros((cap, d), dtype=torch.int8)
    inv0 = torch.zeros(cap)
    buf, inv = tscan.write_rows_pre(
        buf0, inv0, torch.from_numpy(qi), torch.from_numpy(qn), 16, in_place
    )
    jb, ji = jscan.write_rows_pre_nodonate(
        jnp.zeros((cap, d), jnp.int8), jnp.zeros((cap,), jnp.float32),
        jnp.asarray(qi), jnp.asarray(qn), 16,
    )
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ji))
    assert (buf is buf0) == in_place
    with pytest.raises(TypeError):
        tscan.write_rows_pre(buf, inv, torch.from_numpy(rows), inv[:8], 0, True)


def test_clear_mask_rows_never_in_place():
    mask = np.ones(64, dtype=bool)
    rows = np.array([3, 9, 40], dtype=np.int64)
    want = np.asarray(jscan.clear_mask_rows(jnp.asarray(mask), rows))
    t0 = torch.from_numpy(mask.copy())
    got = tscan.clear_mask_rows(t0, rows)
    np.testing.assert_array_equal(got.numpy(), want)
    assert t0.all() and got is not t0


def test_compact_gather():
    rng = np.random.default_rng(8)
    cap, d = 32, 8
    base = rng.standard_normal((cap, d)).astype(np.float32)
    inv = rng.random(cap).astype(np.float32)
    perm = np.zeros(cap, dtype=np.int64)
    kept = np.array([i for i in range(20) if i % 3])
    perm[: kept.size] = kept
    jb, ji = jscan.compact_gather_nodonate(
        jnp.asarray(base), jnp.asarray(inv), jnp.asarray(perm.astype(np.int32))
    )
    tb0 = torch.from_numpy(base.copy())
    tb, ti = tscan.compact_gather(tb0, torch.from_numpy(inv), torch.from_numpy(perm))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tb0.numpy(), base)
    one = tscan.compact_gather_one(tb0, torch.from_numpy(perm))
    np.testing.assert_array_equal(one.numpy(), np.asarray(jb))


def test_device_array_predicates_and_fetch():
    q = np.ones((3, 4), np.float32)
    assert not tscan.is_device_array(q)
    t = torch.from_numpy(q).to(torch.float64)
    assert tscan.is_device_array(t)
    out = tscan.as_device_queries(t[0], "cpu")
    assert out.shape == (1, 4) and out.dtype == torch.float32
    vals = torch.tensor([[0.5, 0.25]])
    idx = torch.tensor([[7, 2]], dtype=torch.int32)
    v, i = tscan.fetch_results(vals, idx)
    assert isinstance(v, np.ndarray) and v.dtype == np.float32 and i.dtype == np.int32
    assert v.tolist() == [[0.5, 0.25]] and i.tolist() == [[7, 2]]
    nv, ni = np.zeros((1, 2), np.float32), np.zeros((1, 2), np.int32)
    got = tscan.fetch_results(nv, ni)
    assert got[0] is nv and got[1] is ni
    handle = tscan.ResultFetch(vals, idx)
    assert handle.get()[1].tolist() == [[7, 2]]


def test_resolve_device_without_cuda_raises():
    if torch.cuda.is_available():
        assert tscan.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tscan.resolve_device(None)
    assert tscan.resolve_device("cpu") == torch.device("cpu")
