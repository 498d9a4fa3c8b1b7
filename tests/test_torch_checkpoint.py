"""models/checkpoint.py of the port: round trip and atomic overwrite (as
tests/test_checkpoint.py holds the JAX package's), resume equal to an
uninterrupted run, and checkpoints crossing between the packages in both
directions on the CPU. A JAX checkpoint pickles optax's NamedTuples; the
port reads them without importing optax or jax (checked in a fresh process).

Tolerances: a resumed port run repeats the uninterrupted one exactly (the
same float32 operations on the same values). Across packages: loss 1e-5,
parameters 2e-6 (k biases 2 * lr per step; see tests/test_torch_train.py),
embeddings 2e-5 (unit vectors).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minivectordb_tpu.models import checkpoint as jck
from minivectordb_tpu.models import encoder as jenc
from minivectordb_tpu.models import train as jtrain
from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch.models import checkpoint as tck
from minivectordb_tpu_torch.models import encoder as tenc
from minivectordb_tpu_torch.models import train as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=128, hidden=32, layers=1, heads=4, intermediate=64)
LR = 1e-3


def _batches(b=8, s=12, seed=0, n=6):
    """tests/test_checkpoint.py's batches, as numpy, with ragged masks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(4, KW["vocab_size"], (b, s), dtype=np.int32)
        mask = (np.arange(s)[None, :] < rng.integers(3, s + 1, (b, 1))).astype(np.int32)
        out.append({"q_ids": ids, "q_mask": mask, "p_ids": ids, "p_mask": mask})
    return out


def _params(seed=0):
    return jax.tree.map(np.asarray, jenc.init_params(jenc.EncoderConfig(**KW), seed=seed))


def _flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _close(got_tree, want_tree, steps):
    for path, g, w in zip(_paths(want_tree), _flat(got_tree), _flat(want_tree)):
        limit = 2 * LR * steps if path.endswith("['k']['b']") else 2e-6
        assert np.abs(g - w).max() <= limit, path


def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg = tenc.EncoderConfig(**KW)
    ckpt = str(tmp_path / "ck.pkl")
    batches = _batches()
    params1, opt1, _hist = ttrain.train_loop(
        cfg, _params(), iter(batches[:4]), steps=4, learning_rate=LR, checkpoint_path=ckpt,
        checkpoint_every=2, log_every=0, device="cpu")
    assert os.path.exists(ckpt) and not os.path.exists(ckpt + ".tmp")
    loaded_params, loaded_opt, step, extra = tck.load_checkpoint(ckpt)
    assert step == 4 and extra == {}
    for a, b in zip(_flat(convert.encoder_to_numpy(params1)), _flat(loaded_params)):
        np.testing.assert_array_equal(a, b)
    assert int(loaded_opt["count"]) == 4
    moments = convert.adamw_state_to_numpy(opt1, params1)
    for a, b in zip(_flat(moments), _flat(loaded_opt)):
        np.testing.assert_array_equal(a, b)
    # resume continues without error and changes params
    params2, _, _ = ttrain.train_loop(cfg, loaded_params, iter(batches[4:]), steps=2,
                                      start_step=step, opt_state=loaded_opt, log_every=0,
                                      device="cpu")
    assert any(not np.array_equal(a, b) for a, b in
               zip(_flat(convert.encoder_to_numpy(params2)), _flat(loaded_params)))


def test_checkpoint_atomic_overwrite(tmp_path):
    path = str(tmp_path / "c.pkl")
    tck.save_checkpoint(path, {"w": np.ones(3)}, step=1)
    tck.save_checkpoint(path, {"w": torch.zeros(3)}, step=2)
    params, _, step, _ = tck.load_checkpoint(path)
    assert step == 2
    np.testing.assert_array_equal(params["w"], np.zeros(3))
    assert not os.path.exists(path + ".tmp")


def test_resume_equals_an_uninterrupted_run(tmp_path):
    cfg = tenc.EncoderConfig(**KW)
    batches = _batches(seed=1)
    full, _o, hist_full = ttrain.train_loop(cfg, _params(), iter(batches[:4]), steps=4,
                                            learning_rate=LR, log_every=1,
                                            log_fn=lambda _s: None, device="cpu")
    ckpt = str(tmp_path / "half.pkl")
    ttrain.train_loop(cfg, _params(), iter(batches[:2]), steps=2, learning_rate=LR,
                      checkpoint_path=ckpt, log_every=0, device="cpu")
    p, o, step, _ = tck.load_checkpoint(ckpt)
    resumed, _o2, hist = ttrain.train_loop(cfg, p, iter(batches[2:4]), steps=2,
                                           start_step=step, opt_state=o, learning_rate=LR,
                                           log_every=1, log_fn=lambda _s: None, device="cpu")
    assert [h["step"] for h in hist] == [2, 3]
    assert hist == hist_full[2:]
    for a, b in zip(full.parameters(), resumed.parameters()):
        assert torch.equal(a, b)


def test_a_port_checkpoint_loads_in_jax_and_embeds_the_same(tmp_path):
    cfg = tenc.EncoderConfig(**KW)
    ckpt = str(tmp_path / "port.pkl")
    enc, _opt, _h = ttrain.train_loop(cfg, _params(), iter(_batches(seed=2)[:2]), steps=2,
                                      learning_rate=LR, checkpoint_path=ckpt, log_every=0,
                                      device="cpu")
    params, opt_state, step, _extra = jck.load_checkpoint(ckpt)
    assert step == 2 and int(opt_state["count"]) == 2
    assert params["layers"][0]["q"]["w"].shape == (KW["hidden"], KW["hidden"])
    rng = np.random.default_rng(5)
    ids = rng.integers(4, KW["vocab_size"], (6, 20)).astype(np.int32)
    mask = (np.arange(20)[None, :] < np.array([[20], [3], [11], [20], [7], [1]])).astype(np.int32)
    want = np.asarray(jenc.embed_program(jax.tree.map(jnp.asarray, params),
                                         jenc.EncoderConfig(**KW), jnp.asarray(ids),
                                         jnp.asarray(mask), "mean"))
    got = tenc.embed_program(enc, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.abs(got - want).max() <= 2e-5
    # the JAX optimizer state can be rebuilt from the port's dict
    import optax

    state = optax.ScaleByAdamState(**opt_state)
    assert int(state.count) == 2 and state.mu["layers"][0]["k"]["w"].shape == (32, 32)


def test_a_jax_checkpoint_resumes_in_the_port_as_jax_continues(tmp_path):
    """JAX trains 2 steps and writes its checkpoint; the port loads it (optax
    state included) and takes step 3, which matches JAX's own step 3."""
    jcfg = jenc.EncoderConfig(**KW)
    batches = _batches(seed=3)
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    ckpt = str(tmp_path / "jax.pkl")
    jtrain.train_loop(jcfg, jax.tree.map(jnp.asarray, _params()), iter(jbatches[:2]), steps=2,
                      learning_rate=LR, checkpoint_path=ckpt, log_every=0)
    jp3, _jo, jhist = jtrain.train_loop(jcfg, jax.tree.map(jnp.asarray, _params()),
                                        iter(jbatches[:3]), steps=3, learning_rate=LR,
                                        log_every=1, log_fn=lambda _s: None)
    params, opt_state, step, _ = tck.load_checkpoint(ckpt)
    assert step == 2 and type(opt_state[0]).__name__ == "ScaleByAdamState"
    assert type(opt_state[0]).__module__ == tck.__name__  # the stand-in, not optax's
    enc, _o, hist = ttrain.train_loop(tenc.EncoderConfig(**KW), params, iter(batches[2:3]),
                                      steps=1, start_step=2, opt_state=opt_state,
                                      learning_rate=LR, log_every=1, log_fn=lambda _s: None,
                                      device="cpu")
    assert hist[0]["step"] == jhist[2]["step"] == 2
    assert abs(hist[0]["loss"] - jhist[2]["loss"]) <= 1e-5
    _close(convert.encoder_to_numpy(enc), jax.tree.map(np.asarray, jp3), 3)


def test_reading_a_jax_checkpoint_imports_neither_jax_nor_optax(tmp_path):
    ckpt = str(tmp_path / "jax.pkl")
    jcfg = jenc.EncoderConfig(**KW)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in _batches(seed=4)[:1]]
    jtrain.train_loop(jcfg, jax.tree.map(jnp.asarray, _params()), iter(batches), steps=1,
                      learning_rate=LR, checkpoint_path=ckpt, log_every=0)
    code = (
        "import sys\n"
        "from minivectordb_tpu_torch.models.checkpoint import load_checkpoint\n"
        f"p, o, s, e = load_checkpoint({ckpt!r})\n"
        "assert s == 1 and type(o[0]).__name__ == 'ScaleByAdamState', o\n"
        "assert [type(x).__name__ for x in o[1:]] == ['EmptyState', 'EmptyState']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'minivectordb_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"


def test_the_loader_refuses_other_classes_of_jaxs_family(tmp_path):
    import pickle

    path = tmp_path / "bad.pkl"
    path.write_bytes(b"cjax.numpy\nzeros\n.")  # a GLOBAL of jax, then STOP
    with pytest.raises(pickle.UnpicklingError, match="jax.numpy.zeros"):
        tck.load_checkpoint(str(path))
    with pytest.raises(NotImplementedError, match="item 13"):
        tck.load_checkpoint(str(path), shardings=object())


def test_a_wider_type_table_keeps_row_0_for_the_parameter_and_its_moments():
    """A converted checkpoint may carry two token types; the port keeps type 0
    (the only one it uses), for the parameter and for AdamW's moments."""
    cfg = tenc.EncoderConfig(**KW)
    params = _params()
    params["type_emb"] = np.stack([params["type_emb"][0] + 1.0, params["type_emb"][0] - 1.0])
    enc = convert.encoder_from_numpy(params, cfg, "cpu")
    assert enc.type_emb.shape == (1, KW["hidden"]) and float(enc.type_emb[0, 0]) == 1.0
    opt = torch.optim.AdamW(enc.parameters(), **ttrain.ADAMW)
    state = {"count": np.asarray(5, np.int32),
             "mu": jax.tree.map(lambda x: np.full(x.shape, 0.5, np.float32), params),
             "nu": jax.tree.map(lambda x: np.full(x.shape, 0.25, np.float32), params)}
    state["mu"]["type_emb"][1] = 9.0
    convert.adamw_state_from_numpy(state, enc, opt)
    st = opt.state[enc.type_emb]
    assert st["exp_avg"].shape == (1, KW["hidden"]) and float(st["exp_avg"].max()) == 0.5
    assert int(st["step"]) == 5
    dense = opt.state[enc.layers[0].ffn_in.weight]
    assert dense["exp_avg"].shape == enc.layers[0].ffn_in.weight.shape
    back = convert.adamw_state_to_numpy(opt.state, enc)
    assert int(back["count"]) == 5
    assert back["mu"]["layers"][0]["ffn_in"]["w"].shape == params["layers"][0]["ffn_in"]["w"].shape
