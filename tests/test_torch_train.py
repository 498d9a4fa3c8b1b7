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
    kw, params, batches = _tiny_setup()
    cfg = EncoderConfig(**kw)
    for call in (lambda: ttrain.make_train_step(cfg, None, mesh=object()),
                 lambda: ttrain.init_training(cfg, params, mesh=object(), device="cpu"),
                 lambda: ttrain.train_loop(cfg, params, iter(batches), 1, mesh=object(),
                                           device="cpu")):
        with pytest.raises(NotImplementedError, match="item 13"):
            call()


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
