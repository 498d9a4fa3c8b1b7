"""Training on a (dp, tp) mesh in the port (parallel/tensor_parallel.py,
models/train.py's ``mesh=``) against the JAX package's GSPMD step on its 8
virtual CPU devices, on the CPU: ``train_mesh(8, tp=2, device="cpu")`` is a
(4, 2) mesh of logical positions, JAX's ``train_mesh(8, tp=2)`` the same
shape over its forced host devices.

Tolerances are tests/test_torch_train.py's: the loss within 1e-4 of JAX's
sharded step (tests/test_train.py's bound for sharded against single
device) and 1e-5 of the port's single-device step; every parameter leaf
within PARAM_TOL of JAX's sharded step after 1 and 3 steps (k biases 2 * lr
a step: their gradient is rounding noise); in bfloat16 the BF16_* rules.
Within the port the dp replicas of a tp shard, and the copies of a
replicated parameter, are equal bit for bit after every step, and a (1, 1)
mesh repeats the single-device step exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (
    LOSS_TOL,
    TINY,
    _bf16_loss_close,
    _bf16_params,
    _corpus_setup,
    _leaves,
    _same_params,
    _same_params_bf16,
    _tiny_setup,
)

from minivectordb_tpu.models import checkpoint as jck
from minivectordb_tpu.models import train as jtrain
from minivectordb_tpu.models.encoder import EncoderConfig as JaxConfig
from minivectordb_tpu.parallel.mesh import train_mesh as jax_train_mesh
from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch.models import checkpoint as tck
from minivectordb_tpu_torch.models import train as ttrain
from minivectordb_tpu_torch.models.encoder import EncoderConfig
from minivectordb_tpu_torch.parallel import tensor_parallel as tpar
from minivectordb_tpu_torch.parallel.mesh import NamedSharding, train_mesh

MESH_LOSS_TOL = 1e-4  # against JAX's sharded step (tests/test_train.py:59)
LR = 1e-3


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _replicas_equal(menc):
    """Every position's parameters equal, bit for bit, to those of the same
    tp shard in replica 0; every replicated parameter to position 0's."""
    tp = menc.tp
    named = {pos: dict(p.named_parameters()) for pos, p in menc.pieces.items()}
    for pos, params in named.items():
        for name, param in params.items():
            same_shard = named[pos % tp][name]
            assert torch.equal(param, same_shard), (pos, name)
            if not tpar._is_split(name):
                assert torch.equal(param, named[0][name]), (pos, name)


def _steps(kw, params, batches, same_params, loss_close, labels: bool = False,
           n: int = 8, tp: int = 2, params_against: str = "mesh"):
    """The port's step on train_mesh(n, tp), JAX's on its own, and both
    packages' single-device steps, from the same params over ``batches``.
    The port's params are held against JAX's sharded step's, or with
    ``params_against="single"`` against JAX's single-device step's."""
    jcfg, cfg = JaxConfig(**kw), EncoderConfig(**kw)
    jmesh = jax_train_mesh(n, tp=tp)
    runs = {}
    for name, m in (("mesh", jmesh), ("single", None)):
        jp, jo, jopt = jtrain.init_training(jcfg, jax.tree.map(jnp.asarray, params), mesh=m,
                                            learning_rate=LR)
        runs[name] = [jp, jo, jtrain.make_train_step(jcfg, jopt, mesh=m)]
    mesh = train_mesh(n, tp=tp, device="cpu")
    assert mesh.devices.shape == jmesh.devices.shape
    menc, mo, mopt = ttrain.init_training(cfg, params, mesh=mesh, learning_rate=LR)
    assert isinstance(menc, tpar.MeshEncoder) and sorted(menc.pieces) == list(range(n))
    mstep = ttrain.make_train_step(cfg, mopt, mesh=mesh)
    enc, o, opt = ttrain.init_training(cfg, params, learning_rate=LR, device="cpu")
    step = ttrain.make_train_step(cfg, opt)
    for i, batch in enumerate(batches):
        assert ("labels" in batch) == labels
        metrics = {}
        for name, run in runs.items():
            run[0], run[1], metrics[name] = run[2](run[0], run[1], _jax_batch(batch))
        jm = metrics["mesh"]
        menc, mo, mm = mstep(menc, mo, batch)
        enc, o, sm = step(enc, o, batch)
        assert loss_close(float(mm["loss"]), float(jm["loss"]), MESH_LOSS_TOL), i
        assert loss_close(float(mm["loss"]), float(sm["loss"]), LOSS_TOL), i
        assert float(mm["accuracy"]) == float(jm["accuracy"]) == float(sm["accuracy"]), i
        _replicas_equal(menc)
        if i in (0, 2):
            gathered = tpar.gather(menc)
            same_params(runs[params_against][0], _as_encoder(gathered, cfg), i + 1, LR)
    return menc, mo, mopt


def _as_encoder(tree, cfg):
    return convert.encoder_from_numpy(tree, cfg, "cpu")


def _f32_close(got, want, tol):
    return abs(got - want) <= tol


def _bf16_close(got, want, _tol):
    return _bf16_loss_close(got, want)


@pytest.mark.parametrize("setup", [_tiny_setup, _corpus_setup], ids=["tiny", "corpus"])
def test_sharded_steps_match_jax_and_the_single_device_step(setup):
    kw, params, batches = setup()
    _steps(kw, params, batches, _same_params, _f32_close,
           labels=setup is _corpus_setup)


@pytest.mark.parametrize("kw, seed, setup", [(TINY, 0, _tiny_setup), (None, 1, _corpus_setup)],
                         ids=["tiny", "corpus"])
def test_bf16_sharded_steps_match_jax(kw, seed, setup):
    kw_, _p, batches = setup()
    params = _bf16_params(kw or kw_, seed)
    menc, _mo, _opt = _steps(kw or kw_, params, batches, _same_params_bf16, _bf16_close,
                             labels=setup is _corpus_setup)
    assert menc.dtype == torch.bfloat16


def test_param_shardings_are_jaxs_for_every_leaf():
    _kw, params, _b = _tiny_setup()
    cfg = EncoderConfig(**TINY)
    jspecs = jtrain.param_shardings(jax_train_mesh(8, tp=2), params)
    mesh = train_mesh(8, tp=2, device="cpu")
    want = dict(_leaves(jax.tree.map(lambda s: np.asarray(tuple(s.spec), dtype=object), jspecs,
                                      is_leaf=lambda x: hasattr(x, "spec"))))
    menc = tpar.place(params, cfg, mesh)
    for given in (params, convert.encoder_from_numpy(params, cfg, "cpu"), menc):
        specs = ttrain.param_shardings(mesh, given)
        flat = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}.{k}" if path else k)
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, f"{path}.{i}")
            else:
                assert isinstance(node, NamedSharding) and node.mesh is mesh
                flat[path] = tuple(node.spec)

        walk(specs, "")
        assert flat.keys() == want.keys()
        for name, spec in want.items():
            assert flat[name] == tuple(spec), name
    assert flat["layers.0.q.w"] == (None, "tp") and flat["layers.1.ffn_out.w"] == ("tp", None)
    assert flat["layers.0.k.b"] == ("tp",) and flat["layers.0.attn_out.b"] == ()


@pytest.mark.parametrize("n, tp", [(8, 2), (8, 4), (6, 4), (4, 8), (3, 2), (1, 2), (8, 1)])
def test_train_mesh_halves_tp_as_jax_does(n, tp):
    mesh = train_mesh(n, tp=tp, device="cpu")
    assert mesh.devices.shape == jax_train_mesh(n, tp=tp).devices.shape
    assert mesh.axis_names == ("dp", "tp") and not mesh.distributed
    assert [pos for pos, _d in mesh.local_shards()] == list(range(n))


def test_a_one_by_one_mesh_repeats_the_single_device_step():
    kw, params, batches = _corpus_setup()
    cfg = EncoderConfig(**kw)
    menc, mo, mopt = ttrain.init_training(cfg, params, mesh=train_mesh(1, device="cpu"),
                                          learning_rate=LR)
    mstep = ttrain.make_train_step(cfg, mopt, mesh=menc.mesh)
    enc, o, opt = ttrain.init_training(cfg, params, learning_rate=LR, device="cpu")
    step = ttrain.make_train_step(cfg, opt)
    for batch in batches:
        menc, mo, mm = mstep(menc, mo, batch)
        enc, o, sm = step(enc, o, batch)
        assert float(mm["loss"]) == float(sm["loss"])
        assert float(mm["accuracy"]) == float(sm["accuracy"])
    for a, b in zip(menc.pieces[0].parameters(), enc.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n, tp", [(4, 1), (8, 2)], ids=["4x1", "4x2"])
def test_a_batch_dp_does_not_divide_matches_jax(n, tp):
    """B = 6 over dp = 4: GSPMD pads the row blocks to 2, 2, 2, 0; the port
    splits the same way, and replica 3 takes part with no rows. On (4, 1)
    the params are held against JAX's sharded step; on (4, 2) against its
    single-device step, since JAX's (4, 2) step leaves NaN in word_emb,
    pos_emb and type_emb at this batch (its loss is right)."""
    kw, params, batches = _tiny_setup()
    batch = {k: v[:6] for k, v in batches[0].items()}
    assert tpar.row_spans(6, 4) == [(0, 2), (2, 4), (4, 6), (6, 6)]
    _steps(kw, params, [batch], _same_params, _f32_close, n=n, tp=tp,
           params_against="mesh" if tp == 1 else "single")


@pytest.mark.parametrize("widths, tp", [
    (dict(hidden=24, heads=3), 2),        # heads % tp: JAX reshards split heads
    (dict(heads=2), 4),                   # tp > heads: the same
    (dict(intermediate=66), 4),           # intermediate % tp: JAX raises too
], ids=["heads-odd", "tp-above-heads", "intermediate"])
def test_uneven_widths_raise_naming_them(widths, tp):
    kw = dict(TINY, **widths)
    params = jax.tree.map(np.asarray, jax_init_params(kw))
    mesh = train_mesh(8, tp=tp, device="cpu")
    assert mesh.devices.shape[1] == tp
    with pytest.raises(ValueError, match=f"heads {kw['heads']}.*intermediate {kw['intermediate']}"):
        ttrain.init_training(EncoderConfig(**kw), params, mesh=mesh)


def jax_init_params(kw):
    from minivectordb_tpu.models.encoder import init_params

    return init_params(JaxConfig(**kw), seed=0)


def test_intermediate_that_tp_does_not_divide_raises_in_jax_too():
    kw = dict(TINY, intermediate=66)
    params = jax_init_params(kw)
    with pytest.raises(ValueError, match="divisible"):
        jtrain.init_training(JaxConfig(**kw), params, mesh=jax_train_mesh(8, tp=4))


def test_mesh_arguments_are_checked():
    kw, params, _b = _tiny_setup()
    cfg = EncoderConfig(**kw)
    from minivectordb_tpu_torch.parallel.mesh import search_mesh

    with pytest.raises(TypeError, match="train_mesh"):
        ttrain.init_training(cfg, params, mesh=search_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="not the mesh's"):
        ttrain.init_training(cfg, params, mesh=train_mesh(2, device="cpu"), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_mesh(2)
    with pytest.raises(ValueError, match="init_pod"):
        train_mesh(2, device="cpu", pod=True)


def test_only_pod_true_spans_the_process_group(tmp_path):
    """An open process group changes nothing for train_mesh(n, device=):
    every position stays in this process; pod=True asks for one position a
    process of the group."""
    import torch.distributed as dist

    from minivectordb_tpu_torch.parallel.mesh import init_pod

    init_pod("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    try:
        local = train_mesh(4, tp=2, device="cpu")
        assert local.devices.shape == (2, 2) and not local.distributed
        assert [pos for pos, _d in local.local_shards()] == [0, 1, 2, 3]
        pod = train_mesh(device="cpu", pod=True)
        assert pod.distributed and pod.process_index == 0 and pod.devices.shape == (1, 1)
        with pytest.raises(ValueError, match="process group has 1"):
            train_mesh(4, device="cpu", pod=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_row_parallel_partials_on_the_card_equal_the_upcast_products():
    """A bfloat16 partial on the card (tensor cores, float32 output) equals
    the float32 product of the upcast operands, forward and backward, to
    float32 summation order (dh and dw: one bfloat16 rounding apart)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's train_mesh_path runs it")
    rng = np.random.default_rng(5)
    h = torch.tensor(rng.standard_normal((2, 64, 256)), dtype=torch.bfloat16, device="cuda")
    lin = torch.nn.Linear(256, 128, device="cuda", dtype=torch.bfloat16)
    g = torch.tensor(rng.standard_normal((2, 64, 128)), dtype=torch.bfloat16, device="cuda")
    h.requires_grad_(True)
    got = tpar._partial(h, lin)
    got.backward(g.float())
    got_dh, got_dw = h.grad, lin.weight.grad
    h.grad = lin.weight.grad = None
    want = torch.nn.functional.linear(h.float(), lin.weight.float())
    want.backward(g.float())
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for a, b in ((got_dh, h.grad), (got_dw, lin.weight.grad)):
        big = float(b.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(big)) - 7)  # one bfloat16 ulp of the largest value
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b.float()).abs().max()) <= ulp


def test_train_loop_on_a_mesh_checkpoints_and_resumes(tmp_path):
    """train_loop(mesh=) returns the placed params; its checkpoint holds the
    gathered JAX pytree and optax's fields; load_checkpoint(shardings=)
    places them, and the resumed step repeats the uninterrupted one."""
    kw, params, batches = _corpus_setup()
    cfg = EncoderConfig(**kw)
    mesh = train_mesh(8, tp=2, device="cpu")
    ck = str(tmp_path / "mesh.pkl")
    menc, mo, hist = ttrain.train_loop(cfg, params, iter(batches[:2]), 2, mesh=mesh,
                                       learning_rate=LR, checkpoint_path=ck, log_every=1,
                                       log_fn=lambda _s: None)
    assert isinstance(menc, tpar.MeshEncoder) and set(mo) == set(range(8))
    menc, _mo, hist3 = ttrain.train_loop(cfg, menc, iter(batches[2:3]), 1, mesh=mesh,
                                         start_step=2, opt_state=mo, learning_rate=LR,
                                         log_every=1, log_fn=lambda _s: None)
    ck_params, ck_opt, step, _e = tck.load_checkpoint(
        ck, shardings=ttrain.param_shardings(mesh, params))
    assert step == 2 and int(ck_opt["count"]) == 2
    q_w = ck_params["layers"][0]["q"]["w"]
    assert isinstance(q_w, tpar.ShardedArray) and q_w.shape == (32, 32)
    assert tuple(q_w.shards[3].shape) == (32, 16) and tuple(q_w.sharding.spec) == (None, "tp")
    blocks = [convert.tensor_to_numpy(q_w.shards[j]) for j in range(2)]
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1),
                                  tck.load_checkpoint(ck)[0]["layers"][0]["q"]["w"])
    resumed, _ro, hist_r = ttrain.train_loop(cfg, ck_params, iter(batches[2:3]), 1, mesh=mesh,
                                             start_step=2, opt_state=ck_opt, learning_rate=LR,
                                             log_every=1, log_fn=lambda _s: None)
    assert hist_r == hist3 and [h["step"] for h in hist] == [0, 1]
    for a, b in zip(resumed.parameters(), menc.parameters()):
        assert torch.equal(a, b)


def test_mesh_checkpoints_cross_packages_and_layouts(tmp_path):
    """A port mesh checkpoint resumes in JAX's single-device and sharded
    loops and in the port's single-device loop; a JAX sharded checkpoint
    and a port single-device one resume on the port's mesh: every step 3
    within the tolerances of JAX's uninterrupted run."""
    kw, params, batches = _corpus_setup()
    jcfg, cfg = JaxConfig(**kw), EncoderConfig(**kw)
    jbatches = [_jax_batch(b) for b in batches]
    mesh, jmesh = train_mesh(8, tp=2, device="cpu"), jax_train_mesh(8, tp=2)
    quiet = {"log_every": 1, "log_fn": lambda _s: None}
    jp3, _jo, jhist = jtrain.train_loop(jcfg, jax.tree.map(jnp.asarray, params),
                                        iter(jbatches), 3, learning_rate=LR, **quiet)
    want = jax.tree.map(np.asarray, jp3)

    def check(got_tree, hist3):
        assert abs(hist3[0]["loss"] - jhist[2]["loss"]) <= MESH_LOSS_TOL
        _same_params(want, _as_encoder(got_tree, cfg), 3, LR)

    port_mesh = str(tmp_path / "port_mesh.pkl")
    ttrain.train_loop(cfg, params, iter(batches[:2]), 2, mesh=mesh, learning_rate=LR,
                      checkpoint_path=port_mesh, log_every=0)
    # -> JAX, one device and the mesh (optax's state rebuilt from the dict)
    import optax

    for jm in (None, jmesh):
        p, o, step, _ = jck.load_checkpoint(
            port_mesh, shardings=None if jm is None else jtrain.param_shardings(jm, params))
        opt_state = (optax.ScaleByAdamState(**{k: jax.tree.map(jnp.asarray, v)
                                               for k, v in o.items()}),
                     optax.EmptyState(), optax.EmptyState())
        jp, _o, h = jtrain.train_loop(jcfg, p, iter(jbatches[2:3]), 1, mesh=jm, start_step=step,
                                      opt_state=opt_state, learning_rate=LR, **quiet)
        check(jax.tree.map(np.asarray, jp), h)
    # -> the port on one device
    p, o, step, _ = tck.load_checkpoint(port_mesh)
    enc, _o, h = ttrain.train_loop(cfg, p, iter(batches[2:3]), 1, start_step=step, opt_state=o,
                                   learning_rate=LR, device="cpu", **quiet)
    check(convert.encoder_to_numpy(enc), h)
    # JAX's mesh run and the port's single-device run -> the port's mesh
    jax_mesh = str(tmp_path / "jax_mesh.pkl")
    jtrain.train_loop(jcfg, jax.tree.map(jnp.asarray, params), iter(jbatches[:2]), 2,
                      mesh=jmesh, learning_rate=LR, checkpoint_path=jax_mesh, log_every=0)
    port_one = str(tmp_path / "port_one.pkl")
    ttrain.train_loop(cfg, params, iter(batches[:2]), 2, learning_rate=LR,
                      checkpoint_path=port_one, log_every=0, device="cpu")
    for path in (jax_mesh, port_one):
        p, o, step, _ = tck.load_checkpoint(path, shardings=ttrain.param_shardings(mesh, params))
        menc, _o, h = ttrain.train_loop(cfg, p, iter(batches[2:3]), 1, mesh=mesh,
                                        start_step=step, opt_state=o, learning_rate=LR, **quiet)
        _replicas_equal(menc)
        check(tpar.gather(menc), h)


def test_placement_round_trips_every_leaf_and_its_moments():
    """place -> gather gives the pytree back bit for bit, in float32 and in
    bfloat16 (JAX's mixture: float32 dense weights); a placed Encoder splits
    the same way; the AdamW moments go through resume -> gather_adamw."""
    cfg = EncoderConfig(**TINY)
    mesh = train_mesh(4, tp=2, device="cpu")
    for params in (_tiny_setup()[1], _bf16_params(TINY, 0)):
        menc = tpar.place(params, cfg, mesh)
        piece = menc.pieces[1]
        assert piece.tp == 2 and piece.layers[0].q.weight.shape == (16, 32)
        assert piece.layers[0].ffn_out.weight.shape == (32, 32)
        back = dict(_leaves(tpar.gather(menc)))
        for name, w in _leaves(params):
            assert back[name].dtype == w.dtype, name
            np.testing.assert_array_equal(back[name].astype(np.float32), w.astype(np.float32))
        again = dict(_leaves(tpar.gather(
            tpar.place(convert.encoder_from_numpy(params, cfg, "cpu"), cfg, mesh))))
        for name, w in _leaves(params):
            np.testing.assert_array_equal(again[name].astype(np.float32),
                                          w.astype(np.float32), name)
        rng = np.random.default_rng(7)
        moments = {key: jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(x.dtype),
                                     params) for key in ("mu", "nu")}
        state = {"count": np.asarray(5, np.int32), **moments}
        opt = tpar.MeshAdamW(menc, LR, **ttrain.ADAMW)
        tpar.resume(state, menc, opt)
        got = tpar.gather_adamw(menc, opt.state)
        assert int(got["count"]) == 5
        for key in ("mu", "nu"):
            g = dict(_leaves(got[key]))
            for name, w in _leaves(moments[key]):
                np.testing.assert_array_equal(g[name].astype(np.float32),
                                              w.astype(np.float32), name)
