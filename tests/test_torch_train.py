"""models/train.py of the port against minivectordb_tpu.models.train on the
CPU: the same parameters (JAX's seeded ``init_params``, loaded through
``convert.encoder_from_numpy``) and the same batches (numpy) through one and
three steps of each package's ``make_train_step``, and ``train_loop``.

Tolerances: loss 1e-5 (absolute; float32 sums in another order), accuracy
equal, every parameter leaf 2e-6 after each step (a scratch run: 3.6e-7) with
one exception. Each layer's k bias has a zero gradient in exact arithmetic
(q_i . b_k is the same for every key of row i, and softmax ignores a
constant), so both packages hand AdamW rounding noise for it, which
g / (|g| + eps) turns into steps of up to the learning rate: those leaves are
held to 2 * lr per step, and the port's k-bias gradient to rounding level.

bfloat16 (JAX's ``init_params(..., dtype=jnp.bfloat16)``: bfloat16
embeddings, biases and layer norms, float32 dense weights cast to bfloat16 at
each product; the port loads each leaf in its own type). Both packages round
every activation and gradient to bfloat16, in another order, and AdamW's
update rounds in another order too (torch scales p by 1 - lr * wd first and
keeps bfloat16 moments through its own sequence of in-place operations). The
loss is held to BF16_LOSS_RTOL of JAX's plus BF16_LOSS_ATOL (a scratch run:
2.4e-3 relative at most where the loss is above 1, 1.8e-2 relative = 7e-6
absolute where it is 4e-4). A gradient element near zero can change sign
between the two orders, and Adam's first steps move such an element by lr
either way: every parameter leaf is held to 2 * lr per step (the k-bias rule)
plus BF16_ULPS bfloat16 ulps of the leaf's largest value, and, except the k
biases (all rounding noise), to a mean error of BF16_MEAN_LR * lr (a scratch
run: 2.3% of elements a step apart, a mean of 0.071 * lr after three steps).
The moments are held to BF16_MOMENT_ULPS ulps of the leaf's largest value (a
scratch run: 6); the k biases' moments, rounding noise in both, are not
compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minivectordb_tpu.models import builtin_data as jdata
from minivectordb_tpu.models import train as jtrain
from minivectordb_tpu.models.encoder import EncoderConfig as JaxConfig
from minivectordb_tpu.models.encoder import init_params as jax_init
from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch.models import train as ttrain
from minivectordb_tpu_torch.models.encoder import EncoderConfig
from minivectordb_tpu_torch.models.train_builtin import make_tokenizer

LOSS_TOL = 1e-5
PARAM_TOL = 2e-6
BF16_LOSS_RTOL = 2.0 ** -7
BF16_LOSS_ATOL = 1e-4
BF16_ULPS = 4
BF16_MEAN_LR = 0.25
BF16_MOMENT_ULPS = 16

TINY = dict(vocab_size=256, hidden=32, layers=2, heads=4, intermediate=64)
# the builtin corpus's tokenizer needs the trained configs' vocabulary
CORPUS = dict(vocab_size=4096, hidden=32, layers=1, heads=4, intermediate=64,
              token_norm_pool=True)


def _tiny_setup():
    """The JAX tests' _tiny_setup (tests/test_train.py), as numpy."""
    params = jax.tree.map(np.asarray, jax_init(JaxConfig(**TINY), seed=0))
    rng = np.random.default_rng(0)
    b, s = 8, 16
    batch = {
        "q_ids": rng.integers(4, 256, (b, s), dtype=np.int32),
        "q_mask": np.ones((b, s), dtype=np.int32),
        "p_ids": rng.integers(4, 256, (b, s), dtype=np.int32),
        "p_mask": np.ones((b, s), dtype=np.int32),
    }
    batch["p_ids"] = batch["q_ids"]
    return TINY, params, [batch] * 3


def _corpus_setup():
    """Soft-label batches of the builtin concept corpus (ragged masks)."""
    params = jax.tree.map(np.asarray, jax_init(JaxConfig(**CORPUS), seed=1))
    tok = make_tokenizer(EncoderConfig(**CORPUS))
    it = jdata.batch_iterator(tok, 8, 16, seed=3)
    batches = [next(it) for _ in range(3)]
    assert all("labels" in b for b in batches)
    return CORPUS, params, batches


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, f"{path}.{key}" if path else key)
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            yield from _leaves(val, f"{path}.{i}")
    else:
        yield path, np.asarray(tree)


def _same_params(jparams, encoder, steps: int, lr: float):
    got = dict(_leaves(convert.encoder_to_numpy(encoder)))
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max())
        limit = 2 * lr * steps if name.endswith(".k.b") else PARAM_TOL
        assert err <= limit, (name, steps, err)


@pytest.mark.parametrize("setup", [_tiny_setup, _corpus_setup], ids=["tiny", "corpus"])
def test_one_and_three_steps_match_jax(setup):
    kw, params, batches = setup()
    lr = 1e-3
    jcfg, cfg = JaxConfig(**kw), EncoderConfig(**kw)
    jp, jopt_state, jopt = jtrain.init_training(jcfg, jax.tree.map(jnp.asarray, params),
                                                learning_rate=lr)
    jstep = jtrain.make_train_step(jcfg, jopt)
    enc, opt_state, opt = ttrain.init_training(cfg, params, learning_rate=lr, device="cpu")
    tstep = ttrain.make_train_step(cfg, opt)
    for i, batch in enumerate(batches):
        jp, jopt_state, jm = jstep(jp, jopt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        enc, opt_state, tm = tstep(enc, opt_state, batch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL, i
        assert float(tm["accuracy"]) == float(jm["accuracy"]), i
        _same_params(jp, enc, i + 1, lr)
        if i == 0:
            grads = dict(enc.named_parameters())
            k_bias = max(float(grads[f"layers.{n}.k.bias"].grad.abs().max())
                         for n in range(cfg.layers))
            k_weight = min(float(grads[f"layers.{n}.k.weight"].grad.abs().max())
                           for n in range(cfg.layers))
            assert k_bias <= 1e-5 * k_weight, (k_bias, k_weight)
    assert opt_state is opt.state and all(int(st["step"]) == 3 for st in opt.state.values())


def test_loss_reduces_and_the_optimizer_is_optax_adamws():
    kw, params, batches = _tiny_setup()
    enc, opt_state, opt = ttrain.init_training(EncoderConfig(**kw), params,
                                               learning_rate=1e-3, device="cpu")
    (group,) = opt.param_groups
    assert isinstance(opt, torch.optim.AdamW)
    assert group["weight_decay"] == 1e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["lr"] == 1e-3
    assert all(p.requires_grad for p in enc.parameters())
    step = ttrain.make_train_step(EncoderConfig(**kw), opt)
    losses = []
    for _ in range(5):
        enc, opt_state, m = step(enc, opt_state, batches[0])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_train_loop_history_and_checkpoint_cadence_match_jax(tmp_path):
    kw, params, batches = _corpus_setup()
    lr = 3e-4
    more = batches + batches
    jp, _jo, jhist = jtrain.train_loop(
        JaxConfig(**kw), jax.tree.map(jnp.asarray, params), iter(more), steps=5,
        learning_rate=lr, start_step=3, log_every=2, log_fn=lambda _s: None)
    lines = []
    tp, topt, thist = ttrain.train_loop(
        EncoderConfig(**kw), params, iter(more), steps=5, learning_rate=lr, start_step=3,
        log_every=2, log_fn=lines.append, checkpoint_path=str(tmp_path / "ck.pkl"),
        checkpoint_every=3, device="cpu")
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [4, 6]
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) <= LOSS_TOL and t["accuracy"] == j["accuracy"]
    assert lines[0].startswith("step 4: loss=")
    _same_params(jp, tp, 5, lr)
    assert topt is not None and len(topt) == len(list(tp.parameters()))
    from minivectordb_tpu_torch.models.checkpoint import load_checkpoint

    _p, _o, step, _e = load_checkpoint(str(tmp_path / "ck.pkl"))
    assert step == 8  # the last save: start_step + steps (the in-loop one came at 6)


def test_mesh_raises_naming_the_roadmap_item():
    """Training on a mesh is ported (ROADMAP item 13b): the three entry points
    take a (dp, tp) mesh from train_mesh, and raise for anything else, naming
    train_mesh (tests/test_torch_train_mesh.py holds the sharded step)."""
    from minivectordb_tpu_torch.parallel.mesh import train_mesh

    kw, params, batches = _tiny_setup()
    cfg = EncoderConfig(**kw)
    for call in (lambda: ttrain.make_train_step(cfg, None, mesh=object()),
                 lambda: ttrain.init_training(cfg, params, mesh=object()),
                 lambda: ttrain.train_loop(cfg, params, iter(batches), 1, mesh=object())):
        with pytest.raises(TypeError, match="train_mesh"):
            call()
    mesh = train_mesh(2, device="cpu")
    enc, _o, hist = ttrain.train_loop(cfg, params, iter(batches), 1, mesh=mesh, log_every=1,
                                      log_fn=lambda _s: None)
    assert sorted(enc.pieces) == [0, 1] and np.isfinite(hist[0]["loss"])


def test_training_defaults_to_the_card():
    kw, params, batches = _tiny_setup()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.init_training(EncoderConfig(**kw), params)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train_loop(EncoderConfig(**kw), params, iter(batches), 1)


def test_an_encoder_is_trained_in_place_and_a_numpy_tree_is_loaded():
    from minivectordb_tpu_torch.models.encoder import Encoder

    kw, params, batches = _tiny_setup()
    cfg = EncoderConfig(**kw)
    enc = convert.encoder_from_numpy(params, cfg, "cpu")
    assert not any(p.requires_grad for p in enc.parameters())  # serving default
    out, _opt, _hist = ttrain.train_loop(cfg, enc, iter(batches), 1, log_every=0,
                                         device="cpu")
    assert out is enc and isinstance(out, Encoder)
    assert not np.array_equal(convert.encoder_to_numpy(enc)["word_emb"], params["word_emb"])


def _bf16_params(kw, seed):
    return jax.tree.map(np.asarray, jax_init(JaxConfig(**kw), seed=seed, dtype=jnp.bfloat16))


def _ulp(x: np.ndarray) -> float:
    """One bfloat16 ulp at the largest magnitude of x."""
    big = float(np.abs(x.astype(np.float32)).max())
    return float(2.0 ** (np.floor(np.log2(max(big, 2.0 ** -126))) - 7))


def _same_params_bf16(jparams, encoder, steps: int, lr: float):
    got = dict(_leaves(convert.encoder_to_numpy(encoder)))
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype, (name, got[name].dtype, w.dtype)
        err = np.abs(got[name].astype(np.float32) - w.astype(np.float32))
        assert err.max() <= 2 * lr * steps + BF16_ULPS * _ulp(w), (name, steps, err.max())
        if not name.endswith(".k.b"):
            assert err.mean() <= BF16_MEAN_LR * lr, (name, steps, err.mean())


def _same_moments_bf16(jopt_state, opt, encoder):
    got = convert.adamw_state_to_numpy(opt.state, encoder)
    jadam = jopt_state[0]
    assert int(got["count"]) == int(jadam.count)
    for key, jtree in (("mu", jadam.mu), ("nu", jadam.nu)):
        g = dict(_leaves(got[key]))
        for name, w in _leaves(jax.tree.map(np.asarray, jtree)):
            assert g[name].dtype == w.dtype, (key, name)
            if name.endswith(".k.b"):
                continue
            err = np.abs(g[name].astype(np.float32) - w.astype(np.float32)).max()
            assert err <= BF16_MOMENT_ULPS * _ulp(w), (key, name, err)


def _bf16_loss_close(got: float, want: float) -> bool:
    return abs(got - want) <= BF16_LOSS_RTOL * abs(want) + BF16_LOSS_ATOL


def test_a_bf16_pytree_loads_leaf_by_leaf_into_a_bf16_encoder():
    """init_training keeps a JAX bfloat16 pytree's types: bfloat16 leaves
    bfloat16, its float32 dense weights float32 (JAX casts them to the
    activations' bfloat16 at each product, and so does the port)."""
    params = _bf16_params(TINY, 0)
    assert params["word_emb"].dtype.name == "bfloat16"
    assert params["layers"][0]["q"]["w"].dtype == np.float32  # JAX's own mixture
    enc, _opt_state, opt = ttrain.init_training(EncoderConfig(**TINY), params,
                                                learning_rate=1e-3, device="cpu")
    assert enc.dtype == torch.bfloat16
    back = dict(_leaves(convert.encoder_to_numpy(enc)))
    for name, w in _leaves(params):
        assert back[name].dtype == w.dtype, name
        np.testing.assert_array_equal(back[name].astype(np.float32), w.astype(np.float32))
    assert {p.dtype for p in opt.param_groups[0]["params"]} == {torch.bfloat16, torch.float32}


@pytest.mark.parametrize("kw, seed, batches", [(TINY, 0, "tiny"), (CORPUS, 1, "corpus")],
                         ids=["tiny", "corpus"])
def test_bf16_one_and_three_steps_match_jax(kw, seed, batches):
    _kw, _p, data = _tiny_setup() if batches == "tiny" else _corpus_setup()
    params = _bf16_params(kw, seed)
    lr = 1e-3
    jcfg, cfg = JaxConfig(**kw), EncoderConfig(**kw)
    jp, jopt_state, jopt = jtrain.init_training(jcfg, jax.tree.map(jnp.asarray, params),
                                                learning_rate=lr)
    jstep = jtrain.make_train_step(jcfg, jopt)
    enc, opt_state, opt = ttrain.init_training(cfg, params, learning_rate=lr, device="cpu")
    tstep = ttrain.make_train_step(cfg, opt)
    for i, batch in enumerate(data):
        jp, jopt_state, jm = jstep(jp, jopt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        enc, opt_state, tm = tstep(enc, opt_state, batch)
        assert _bf16_loss_close(float(tm["loss"]), float(jm["loss"])), i
        assert float(tm["accuracy"]) == float(jm["accuracy"]), i
        _same_params_bf16(jp, enc, i + 1, lr)
        _same_moments_bf16(jopt_state, opt, enc)
    for param in enc.parameters():
        st = opt.state[param]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == param.dtype


def test_bf16_train_loop_matches_jax():
    kw, _p, batches = _corpus_setup()
    params = _bf16_params(kw, 1)
    lr = 3e-4
    jp, _jo, jhist = jtrain.train_loop(
        JaxConfig(**kw), jax.tree.map(jnp.asarray, params), iter(batches), steps=3,
        learning_rate=lr, log_every=1, log_fn=lambda _s: None)
    tp, _topt, thist = ttrain.train_loop(
        EncoderConfig(**kw), params, iter(batches), steps=3, learning_rate=lr, log_every=1,
        log_fn=lambda _s: None, device="cpu")
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [0, 1, 2]
    for t, j in zip(thist, jhist):
        assert _bf16_loss_close(t["loss"], j["loss"]) and t["accuracy"] == j["accuracy"]
    assert tp.dtype == torch.bfloat16
    _same_params_bf16(jp, tp, 3, lr)
