"""The port's encoder against the JAX package's, on the CPU: the same weights
(made by the JAX initialiser from a seed, carried over as numpy by
convert.encoder_from_numpy) and the same token batches through both.

Tolerances. float32: 2e-5 on hidden states of magnitude about 1 and on unit
vectors (the two frameworks sum in different orders). bfloat16: 8e-2 on hidden
states of magnitude up to about 4 (one bf16 step there is 3e-2, and the
roundings of the dense layers, GELU and the probabilities fall at different
places in the two frameworks) and 2e-2 on the pooled unit vectors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from minivectordb_tpu.models import encoder as jenc
from minivectordb_tpu_torch import convert as port_convert
from minivectordb_tpu_torch.models import encoder as tenc

F32_TOL = 2e-5
BF16_HIDDEN_TOL = 8e-2
BF16_UNIT_TOL = 2e-2

CFG = dict(vocab_size=300, hidden=64, layers=2, heads=4, intermediate=128,
           max_positions=530)


def _configs(**over):
    kw = {**CFG, **over}
    return jenc.EncoderConfig(**kw), tenc.EncoderConfig(**kw)


def _numpy_tree(params):
    return jax.tree.map(lambda x: np.asarray(x, dtype=np.float32), params)


def _pair(seed=0, dtype="float32", **over):
    """(jax params, jax cfg, port encoder) holding the same weights."""
    jcfg, tcfg = _configs(**over)
    params = jenc.init_params(jcfg, seed)
    # biases and layer norms away from their trivial initial values
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda x: x + jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)) * 0.05
        if x.ndim == 1 or x.shape[0] == 1 else x, params)
    enc = port_convert.encoder_from_numpy(_numpy_tree(params), tcfg, "cpu")
    if dtype == "bfloat16":
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
        enc = enc.to(torch.bfloat16)
    return params, jcfg, enc


def _tokens(b, s, lengths, seed, vocab=300):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    ids[mask == 0] = 1
    return ids, mask


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.to(torch.float32).numpy()


def test_config_is_the_same_frozen_dataclass():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jenc.EncoderConfig)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tenc.EncoderConfig)]
    assert jf == tf
    _, tcfg = _configs()
    with pytest.raises(dataclasses.FrozenInstanceError):
        tcfg.hidden = 1


@pytest.mark.parametrize("n", [1, 15, 16, 17, 100, 255, 256, 257, 511, 512, 513, 4000])
def test_seq_bucket(n):
    assert tenc.seq_bucket(n) == jenc.seq_bucket(n)
    assert tenc.seq_bucket(n, 128) == jenc.seq_bucket(n, 128)


def test_layer_norm_and_dense():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jenc._layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5))
    got = tenc._layer_norm(_t(x), _t(g), _t(b), 1e-5).numpy()
    assert np.abs(got - want).max() <= F32_TOL
    # bf16 activations: computed in float32, cast back
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jenc._layer_norm(xb, jnp.asarray(g, jnp.bfloat16),
                                       jnp.asarray(b, jnp.bfloat16), 1e-5)
                      .astype(jnp.float32))
    got = tenc._layer_norm(_t(x, torch.bfloat16), _t(g, torch.bfloat16),
                           _t(b, torch.bfloat16), 1e-5)
    assert got.dtype == torch.bfloat16
    assert np.abs(_np(got) - want).max() <= 4e-2  # one bf16 step at magnitude 4

    params, _jcfg, enc = _pair(seed=4)
    layer, tl = params["layers"][0], enc.layers[0]
    for name in ("q", "ffn_in", "ffn_out"):
        kin = layer[name]["w"].shape[0]
        xin = rng.standard_normal((5, kin)).astype(np.float32)
        want = np.asarray(jenc._dense(jnp.asarray(xin), layer[name]))
        got = tenc._dense(_t(xin), getattr(tl, name)).numpy()
        assert got.shape == want.shape and np.abs(got - want).max() <= F32_TOL
        # the port stores (out, in), transposed once at load
        assert tuple(getattr(tl, name).weight.shape) == layer[name]["w"].shape[::-1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_einsum_route(dtype):
    params, jcfg, enc = _pair(seed=5, dtype=dtype)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 24, 64)).astype(np.float32)
    _ids, mask = _tokens(3, 24, [24, 9, 1], seed=7)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jenc._attention(
        jnp.asarray(x, jd), params["layers"][0], jnp.asarray(mask).astype(bool), jcfg,
        allow_flash=False).astype(jnp.float32))
    got = _np(tenc._attention(_t(x, td), enc.layers[0], _t(mask).bool(), enc.cfg,
                              allow_flash=False))
    tol = F32_TOL if dtype == "float32" else BF16_HIDDEN_TOL
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode(dtype):
    params, jcfg, enc = _pair(seed=8, dtype=dtype)
    ids, mask = _tokens(4, 32, [32, 20, 5, 1], seed=9)
    want = np.asarray(jenc.encode(params, jcfg, jnp.asarray(ids), jnp.asarray(mask))
                      .astype(jnp.float32))
    got = tenc.encode(enc, _t(ids), _t(mask))
    assert got.dtype == enc.dtype and got.shape == (4, 32, 64)
    tol = F32_TOL if dtype == "float32" else BF16_HIDDEN_TOL
    assert np.abs(_np(got) - want).max() <= tol  # pad positions included
    assert torch.equal(enc(_t(ids), _t(mask)), got)  # the module's forward is encode


def test_encode_position_ids_and_type_embedding():
    """cumsum(mask) * mask + pad_id, and type row 0 on every token: a change
    of either shows in the first layer's input."""
    params, jcfg, enc = _pair(seed=10, layers=1)
    ids, mask = _tokens(2, 16, [16, 6], seed=11)
    with torch.no_grad():
        enc.type_emb.add_(0.5)
    params["type_emb"] = params["type_emb"] + 0.5
    want = np.asarray(jenc.encode(params, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    assert np.abs(tenc.encode(enc, _t(ids), _t(mask)).numpy() - want).max() <= F32_TOL


def test_pools_and_cos_floor():
    rng = np.random.default_rng(12)
    hidden = rng.standard_normal((4, 10, 32)).astype(np.float32)
    mask = (np.arange(10)[None, :] < np.array([[10], [3], [1], [0]])).astype(np.int32)
    for token_norm in (False, True):
        want = np.asarray(jenc.mean_pool_normalize(jnp.asarray(hidden), jnp.asarray(mask),
                                                   token_norm))
        got = tenc.mean_pool_normalize(_t(hidden), _t(mask), token_norm).numpy()
        assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got[3]).max() == 0.0  # an all-pad row pools to zeros, not NaN
    want = np.asarray(jenc.cls_pool_normalize(jnp.asarray(hidden), jnp.asarray(mask)))
    assert np.abs(tenc.cls_pool_normalize(_t(hidden), _t(mask)).numpy() - want).max() <= 1e-6
    # bf16 hidden states pool in float32
    got = tenc.mean_pool_normalize(_t(hidden, torch.bfloat16), _t(mask))
    assert got.dtype == torch.float32

    unit = hidden[:, 0] / np.linalg.norm(hidden[:, 0], axis=-1, keepdims=True)
    for floor in (0.0, 0.3):
        jcfg, tcfg = _configs(cos_floor=floor)
        want = np.asarray(jenc.apply_cos_floor(jnp.asarray(unit), jcfg))
        got = tenc.apply_cos_floor(_t(unit), tcfg).numpy()
        assert np.abs(got - want).max() <= 1e-6
    assert np.allclose(got[:, -1], np.sqrt(0.3)) and np.allclose(
        np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooling, over", [
    ("mean", {}), ("cls", {}), ("mean", {"token_norm_pool": True, "cos_floor": 0.2}),
])
def test_embed_program(pooling, over, dtype):
    params, jcfg, enc = _pair(seed=13, dtype=dtype, **over)
    ids, mask = _tokens(4, 64, [64, 33, 7, 1], seed=14)
    want = np.asarray(jenc.embed_program(params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                         pooling))
    got = tenc.embed_program(enc, _t(ids), _t(mask), pooling)
    assert got.dtype == torch.float32 and got.shape == (4, 64)
    assert np.abs(got.numpy() - want).max() <= (F32_TOL if dtype == "float32" else BF16_UNIT_TOL)
    host = tenc.embed_program_host(enc, ids, mask, pooling)  # numpy in, the CPU copy
    assert torch.equal(host, got)


@pytest.mark.parametrize("s, lengths", [(256, [256, 140, 3]), (512, [300, 512, 1])])
def test_encode_flash_route_on_both_sides(monkeypatch, s, lengths):
    """Both packages through their flash route: the JAX encode with the
    backend test answered 'tpu' and the Pallas kernel interpreted, the port's
    encode with its gate opened so the wrapper serves the CPU tensors with the
    kernel's plain version. Equal at EVERY position: pad queries attend to
    pads on both sides (segment ids), unlike the einsum route."""
    params, jcfg, enc = _pair(seed=15, hidden=128, heads=4, layers=2)
    ids, mask = _tokens(3, s, lengths, seed=16)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert jenc._use_flash_attention(s, 32)
    # jitted: the interpreter's callbacks must not race an eager dispatch
    jitted = jax.jit(jenc.encode, static_argnames=("cfg", "allow_flash"))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jitted(params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                 allow_flash=True))
    monkeypatch.undo()
    assert not tenc._use_flash_attention(s, 32, torch.device("cpu"))
    einsum = tenc.encode(enc, _t(ids), _t(mask)).numpy()
    monkeypatch.setattr(tenc, "_use_flash_attention", lambda seq, hd, dev: True)
    got = tenc.encode(enc, _t(ids), _t(mask)).numpy()
    assert np.abs(got - want).max() <= F32_TOL
    # the two routes of one package differ at pad positions only
    real = mask.astype(bool)
    assert np.abs(got[real] - einsum[real]).max() <= F32_TOL
    assert np.abs(got[~real] - einsum[~real]).max() > 1e-3


def test_flash_gate_is_the_reference_gate_plus_the_device():
    cuda = torch.device("cuda", 0)
    for seq in (128, 255, 256, 384, 400, 512):
        for hd in (16, 32, 64):
            want = seq >= 256 and seq % 128 == 0 and hd >= 32
            assert tenc._use_flash_attention(seq, hd, cuda) == want
            assert not tenc._use_flash_attention(seq, hd, torch.device("cpu"))


def test_init_params_is_seeded_and_scaled():
    _, tcfg = _configs(hidden=128, intermediate=256, vocab_size=2000)
    gen = torch.Generator().manual_seed(7)
    a = tenc.init_params(tcfg, gen)
    b = tenc.init_params(tcfg, torch.Generator().manual_seed(7))
    c = tenc.init_params(tcfg, torch.Generator().manual_seed(8))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb) and not pa.requires_grad
    assert not torch.equal(a.word_emb, c.word_emb) and not a.training
    assert abs(float(a.word_emb.std()) - 0.02) < 2e-3
    assert abs(float(a.layers[0].ffn_out.weight.std()) - 1 / 16) < 5e-3  # 1/sqrt(256)
    assert float(a.layers[1].q.bias.abs().max()) == 0.0
    assert torch.equal(a.emb_ln.g, torch.ones(128)) and float(a.type_emb.abs().max()) == 0.0
    ids, mask = _tokens(2, 16, [16, 4], seed=1, vocab=2000)
    out = tenc.embed_program(a, _t(ids), _t(mask))
    assert torch.isfinite(out).all()
    assert np.allclose(out.norm(dim=1).numpy(), 1.0, atol=1e-5)


def test_encoder_round_trip_through_numpy():
    params, _jcfg, enc = _pair(seed=17)
    back = port_convert.encoder_to_numpy(enc)
    flat_a = jax.tree.leaves(_numpy_tree(params))
    flat_b = jax.tree.leaves(back)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        assert x.shape == y.shape and np.array_equal(x, y)
    with pytest.raises(ValueError, match="layers"):
        port_convert.encoder_from_numpy({**back, "layers": back["layers"][:1]}, enc.cfg, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: device=None resolves to the card")
        port_convert.encoder_from_numpy(back, enc.cfg)
