"""The IVF probe of the port against the JAX package's Pallas probe.

The same numpy-seeded inputs go through ``minivectordb_tpu/ops/pallas_ivf.py``
(kernels interpreted on the CPU backend, as tests/test_pallas_ivf.py runs
them) and through ``minivectordb_tpu_torch/ops/ivf_probe.py`` on CPU tensors,
where each wrapper uses its kernel's plain version. Tolerances: float32 and
bfloat16 scores 2e-5 (another summation order over d <= 128 float32 terms;
bf16 products are exact in float32); int8 equal to the bit (integer dots, the
same two float32 multiplies in the same order); bookkeeping tables equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minivectordb_tpu.ops import pallas_ivf
from minivectordb_tpu.ops.ivf import IVFIndex as JaxIVF
from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch.ops import ivf_probe
from minivectordb_tpu_torch.ops.ivf import IVFIndex as TorchIVF

MASKED = np.float32(-3.0e38)
L, P, D = 6, 128, 64


def _bf16(x: np.ndarray):
    """(jax bf16 array, torch bf16 tensor) with the same values."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16), t


def _lists(seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((L, P, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    valid = rng.random((L, P)) < 0.8
    if dtype == "int8":
        xi = np.clip(np.round(x * 127.0), -127, 127).astype(np.int8)
        return rng, jnp.asarray(xi), torch.from_numpy(xi), valid
    if dtype == "bfloat16":
        return (rng,) + _bf16(x) + (valid,)
    return rng, jnp.asarray(x), torch.from_numpy(x), valid


def _queries(rng, n, dtype):
    q = rng.standard_normal((n, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    if dtype == "bfloat16":
        return _bf16(q)
    return jnp.asarray(q), torch.from_numpy(q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_probe_scores_match_the_pallas_kernel(dtype):
    rng, jl, tl, _ = _lists(0, dtype)
    jq, tq = _queries(rng, 5, dtype)
    ids = rng.integers(0, L, size=(5, 3)).astype(np.int32)
    want = np.asarray(pallas_ivf._probe_scores(jl, jq, jnp.asarray(ids)))
    got = ivf_probe.probe_scores(tl, tq, torch.from_numpy(ids))
    assert got.shape == (5, 3 * P) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def _steps(rng, n_steps, g, dtype):
    """A step table with padding steps, and one query group per step."""
    step_list = rng.integers(0, L, size=n_steps).astype(np.int32)
    step_list[[1, n_steps - 1]] = -1
    q = rng.standard_normal((n_steps, g, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return step_list, q


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_scores_match_the_pallas_kernel_on_live_steps(dtype):
    rng, jl, tl, valid = _lists(1, dtype)
    step_list, q = _steps(rng, 7, 16, dtype)
    if dtype == "bfloat16":
        jq, tq = _bf16(q)
    else:
        jq, tq = jnp.asarray(q), torch.from_numpy(q)
    want = np.asarray(pallas_ivf._grouped_scores(
        jl, jq, jnp.asarray(step_list), jnp.asarray(valid)))
    got = ivf_probe.grouped_scores(
        tl, tq, torch.from_numpy(step_list), torch.from_numpy(valid)).numpy()
    live = step_list >= 0
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=2e-5)
    # invalid slots carry the sentinel exactly, in both
    dead = ~valid[step_list[live]]
    assert (got[live].transpose(0, 2, 1)[dead] == MASKED).all()
    assert (want[live].transpose(0, 2, 1)[dead] == MASKED).all()
    # a padding step is all sentinel in the port (the Pallas kernel leaves
    # its output unwritten; nothing ever reads it)
    assert (got[~live] == MASKED).all()


def test_grouped_scores_int8_equal_the_pallas_kernel_to_the_bit():
    rng, jl, tl, valid = _lists(2, "int8")
    step_list, q = _steps(rng, 6, 16, "int8")
    qi = np.clip(np.round(q * 127.0), -127, 127).astype(np.int8)
    qinv = (1.0 / np.linalg.norm(qi.astype(np.float32), axis=-1)).astype(np.float32)
    linv = 1.0 / np.linalg.norm(np.asarray(jl).astype(np.float32), axis=-1)
    linv = np.where(valid, linv, 0.0).astype(np.float32)  # 0 on empty slots
    want = np.asarray(pallas_ivf._grouped_scores_q(
        jl, jnp.asarray(qi), jnp.asarray(step_list), jnp.asarray(valid),
        jnp.asarray(linv), jnp.asarray(qinv)))
    got = ivf_probe.grouped_scores_q(
        tl, torch.from_numpy(qi), torch.from_numpy(step_list),
        torch.from_numpy(valid), torch.from_numpy(linv), torch.from_numpy(qinv),
    ).numpy()
    live = step_list >= 0
    np.testing.assert_array_equal(got[live], want[live])
    assert (got[~live] == MASKED).all()
    # mask after scale: an empty slot (list_inv == 0) is the sentinel, not 0.0
    dead = ~valid[step_list[live]]
    assert (got[live].transpose(0, 2, 1)[dead] == MASKED).all()


@pytest.mark.parametrize("g", [8, 16])
def test_wrappers_take_narrow_groups_and_reject_bad_operands(g):
    rng, _, tl, valid = _lists(3, "float32")
    step_list, q = _steps(rng, 4, g, "float32")
    out = ivf_probe.grouped_scores(
        tl, torch.from_numpy(q), torch.from_numpy(step_list), torch.from_numpy(valid))
    assert out.shape == (4, g, P)
    sl, tv = torch.from_numpy(step_list), torch.from_numpy(valid)
    with pytest.raises(TypeError):
        ivf_probe.grouped_scores(tl, torch.from_numpy(q).to(torch.bfloat16), sl, tv)
    with pytest.raises(ValueError):
        ivf_probe.grouped_scores(tl, torch.from_numpy(q), sl.long(), tv)
    with pytest.raises(ValueError):
        ivf_probe.grouped_scores(tl, torch.from_numpy(q), sl, tv.to(torch.int8))
    with pytest.raises(ValueError):
        ivf_probe.grouped_scores(
            tl, torch.zeros((4, 17, D)), sl, tv)  # wider than one mma tile
    with pytest.raises(TypeError):
        ivf_probe.probe_scores(tl, torch.from_numpy(q[:, 0]), torch.zeros((4, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        ivf_probe.probe_scores(tl.transpose(0, 1), torch.from_numpy(q[:, 0]),
                               torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(TypeError):
        ivf_probe.grouped_scores_q(tl, torch.from_numpy(q), sl, tv, tv, tv)


@pytest.mark.parametrize("b,nprobe", [(32, 4), (16, 6), (3, 2), (1, 1)])
def test_grouping_bookkeeping_equals_the_jax_bookkeeping(b, nprobe):
    """step_list / step_q / pair_step / pair_slot against the tables that
    pallas_ivf_search_grouped builds (recomputed here with the JAX ops of
    pallas_ivf.py:314-343 on the same probe)."""
    import jax

    rng = np.random.default_rng(10 + b)
    probe = np.stack([rng.permutation(L)[:nprobe] for _ in range(b)]).astype(np.int32)
    g = int(min(16, max(8, b * nprobe)))
    m = b * nprobe
    l_flat = jnp.asarray(probe).reshape(-1)
    q_flat = jax.lax.broadcasted_iota(jnp.int32, (b, nprobe), 0).reshape(-1)
    order = jnp.argsort(l_flat)
    ls, qs = l_flat[order], q_flat[order]
    counts = jax.ops.segment_sum(jnp.ones((m,), jnp.int32), ls, num_segments=L)
    starts = pallas_ivf._exclusive_cumsum(counts)
    rank = jnp.arange(m, dtype=jnp.int32) - starts[ls]
    slot = rank % g
    gid = pallas_ivf._exclusive_cumsum((counts + g - 1) // g)[ls] + rank // g
    n_steps = int(min(L, m) + m // g)
    j_step_list = jnp.full((n_steps,), -1, jnp.int32).at[gid].set(ls)
    j_step_q = jnp.zeros((n_steps, g), jnp.int32).at[gid, slot].set(qs)
    j_pair_step = jnp.zeros((m,), jnp.int32).at[order].set(gid).reshape(b, nprobe)
    j_pair_slot = jnp.zeros((m,), jnp.int32).at[order].set(slot).reshape(b, nprobe)

    step_list, step_q, pair_step, pair_slot = ivf_probe.group_pairs(
        torch.from_numpy(probe).long(), L, g)
    assert step_list.dtype == torch.int32 and step_list.shape == (n_steps,)
    np.testing.assert_array_equal(step_list.numpy(), np.asarray(j_step_list))
    np.testing.assert_array_equal(step_q.numpy(), np.asarray(j_step_q))
    np.testing.assert_array_equal(pair_step.numpy(), np.asarray(j_pair_step))
    np.testing.assert_array_equal(pair_slot.numpy(), np.asarray(j_pair_slot))
    # every pair points at a live step of its own list, in its own slot
    sl = step_list.numpy()
    assert (sl[pair_step.numpy()] == probe).all()
    assert (step_q.numpy()[pair_step.numpy(), pair_slot.numpy()]
            == np.arange(b)[:, None]).all()


# -- whole searches on a JAX-built index carried across ----------------------


def _carried(dtype, seed=0, n=3000, d=128, nlist=16):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, d)).astype(np.float32)
    jidx = JaxIVF(nlist=nlist, nprobe=6, iters=4, device_dtype=dtype)
    jidx.build(mat)
    state = convert.ivf_state_from_numpy(jidx.state_dict())
    tidx = TorchIVF.from_state(state, mat, device="cpu")
    return rng, mat, jidx, tidx


def _same_hits(tv, ti, jv, ji, atol=2e-5):
    tv, ti = np.asarray(tv), np.asarray(ti)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert tv.shape == jv.shape and ti.shape == ji.shape
    np.testing.assert_allclose(tv, jv, rtol=0, atol=atol)
    # ids equal wherever the neighbouring scores are not tied
    differ = ti != ji
    if differ.any():
        gap = np.minimum(
            np.abs(np.diff(jv, axis=1, prepend=np.inf)),
            np.abs(np.diff(jv, axis=1, append=-np.inf)),
        )
        assert (gap[differ] <= 2 * atol).all(), (ti[differ], ji[differ])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_from_state_packs_the_lists_the_jax_index_packed(dtype):
    _, _, jidx, tidx = _carried(dtype)
    np.testing.assert_array_equal(tidx._list_ids.numpy(), np.asarray(jidx._list_ids))
    np.testing.assert_array_equal(tidx._list_valid.numpy(), np.asarray(jidx._list_valid))
    np.testing.assert_array_equal(tidx.centroids.numpy(), np.asarray(jidx.centroids))
    jl = np.asarray(jidx._lists.astype(jnp.float32))
    tl = tidx._lists.to(torch.float32).numpy()
    if dtype == "int8":
        # a value that lands within rounding of .5 may round the other way
        assert np.abs(tl - jl).max() <= 1 and (tl != jl).mean() < 1e-4
        np.testing.assert_allclose(
            tidx._list_inv.numpy(), np.asarray(jidx._list_inv), rtol=1e-4)
    else:
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6 if dtype == "float32" else 8e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("batch", [32, 16])
def test_ivf_search_grouped_matches_pallas_grouped(dtype, batch):
    rng, _, jidx, tidx = _carried(dtype)
    q = rng.standard_normal((batch, 128)).astype(np.float32)
    # both probe the SAME packed bytes: hand the JAX function the port's lists
    # (from_state re-normalizes on another device, which may move an int8
    # value by one step or a bf16 value by one ulp)
    lists = tidx._lists
    if dtype == "bfloat16":
        jl = jnp.asarray(lists.to(torch.float32).numpy()).astype(jnp.bfloat16)
    else:
        jl = jnp.asarray(lists.numpy())
    jinv = None if tidx._list_inv is None else jnp.asarray(tidx._list_inv.numpy())
    jv, ji = pallas_ivf.pallas_ivf_search_grouped(
        jidx.centroids, jl, jidx._list_ids, jidx._list_valid, jnp.asarray(q),
        6, 10, list_inv=jinv)
    tv, ti = ivf_probe.ivf_search_grouped(
        tidx.centroids, lists, tidx._list_ids, tidx._list_valid,
        torch.from_numpy(q), 6, 10, list_inv=tidx._list_inv)
    assert ti.dtype == torch.int32
    _same_hits(tv, ti, jv, ji, atol=0 if dtype == "int8" else 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [5, 70])
def test_ivf_search_paged_matches_pallas_paged(dtype, batch):
    rng, _, jidx, tidx = _carried(dtype, seed=1)
    q = rng.standard_normal((batch, 128)).astype(np.float32)
    lists = tidx._lists
    if dtype == "bfloat16":
        jl = jnp.asarray(lists.to(torch.float32).numpy()).astype(jnp.bfloat16)
    else:
        jl = jnp.asarray(lists.numpy())
    jv, ji = pallas_ivf.pallas_ivf_search(
        jidx.centroids, jl, jidx._list_ids, jidx._list_valid, jnp.asarray(q), 6, 10)
    tv, ti = ivf_probe.ivf_search_paged(
        tidx.centroids, lists, tidx._list_ids, tidx._list_valid,
        torch.from_numpy(q), 6, 10)
    _same_hits(tv, ti, jv, ji)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_empty_slots_never_win_when_every_score_is_negative(dtype):
    """Mask-ordering regression of tests/test_pallas_ivf.py: every corpus row
    anti-correlates with the query, so all true scores are about -1 and an
    empty slot that leaked through as 0.0 would win the top-k."""
    rng = np.random.default_rng(7)
    n, d = 300, 128
    base = rng.standard_normal(d).astype(np.float32)
    base /= np.linalg.norm(base)
    mat = (-base[None, :] + 0.05 * rng.standard_normal((n, d))).astype(np.float32)
    index = TorchIVF(nlist=2, nprobe=2, iters=3, device_dtype=dtype, device="cpu")
    index.build(mat)
    for batch in (16, 2):  # grouped probe / paged probe (int8: grouped both)
        q = np.tile(base, (batch, 1)).astype(np.float32)
        vals, ids = index.snapshot().search(q, k=10)
        assert vals.max() < 0.0, (dtype, batch, float(vals.max()))
        assert ids.min() >= 0 and ids.max() < n


def test_selector_approx_is_served_exactly_and_unknown_selector_raises():
    rng, _, _, tidx = _carried("float32", seed=2)
    q = torch.from_numpy(rng.standard_normal((16, 128)).astype(np.float32))
    args = (tidx.centroids, tidx._lists, tidx._list_ids, tidx._list_valid, q, 4, 10)
    ev, ei = ivf_probe.ivf_search_grouped(*args, selector="exact")
    av, ai = ivf_probe.ivf_search_grouped(*args, selector="approx")
    assert torch.equal(ev, av) and torch.equal(ei, ai)
    with pytest.raises(ValueError):
        ivf_probe.ivf_search_grouped(*args, selector="fast")
    with pytest.raises(ValueError):  # int8 lists need their scales
        ivf_probe.ivf_search_grouped(
            tidx.centroids, tidx._lists.to(torch.int8), tidx._list_ids,
            tidx._list_valid, q, 4, 10)


def test_launch_counters_stay_zero_on_the_cpu():
    assert set(ivf_probe.LAUNCHES) == set(ivf_probe._ARGTYPES)
    ivf_probe.reset_launches()
    rng, _, tl, valid = _lists(5, "float32")
    step_list, q = _steps(rng, 4, 16, "float32")
    ivf_probe.grouped_scores(
        tl, torch.from_numpy(q), torch.from_numpy(step_list), torch.from_numpy(valid))
    assert all(n == 0 for n in ivf_probe.LAUNCHES.values())
    assert ivf_probe._fns == {}
