"""models/convert.py and the numpy carrier: the params.npz + config.json
artifact format is shared (a directory written by either package loads in the
other), and a random XLMRobertaModel converts to an encoder that reproduces
transformers' forward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minivectordb_tpu.models import convert as jconv
from minivectordb_tpu.models import encoder as jenc
from minivectordb_tpu_torch import convert as port_convert
from minivectordb_tpu_torch.models import configs as tconfigs
from minivectordb_tpu_torch.models import convert as tconv
from minivectordb_tpu_torch.models import encoder as tenc

F32_TOL = 2e-5
KW = dict(vocab_size=120, hidden=32, layers=2, heads=4, intermediate=48,
          max_positions=40, token_norm_pool=True, cos_floor=0.1)


def _tokens():
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 120, (3, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([[16], [9], [2]])).astype(np.int32)
    ids[mask == 0] = 1
    return ids, mask


def test_artifact_written_by_the_jax_package_loads_in_the_port(tmp_path):
    jcfg = jenc.EncoderConfig(**KW)
    params = jenc.init_params(jcfg, 3)
    jconv.save_converted(params, jcfg, str(tmp_path / "a"))
    loaded, tcfg = tconv.load_converted(str(tmp_path / "a"))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert isinstance(tcfg, tenc.EncoderConfig)
    enc = port_convert.encoder_from_numpy(loaded, tcfg, "cpu")
    ids, mask = _tokens()
    want = np.asarray(jenc.embed_program(params, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    got = tenc.embed_program(enc, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.abs(got - want).max() <= F32_TOL
    # load_pretrained takes the directory too, and the flat npz names work
    again, _ = tconv.load_pretrained(str(tmp_path / "a"))
    flat = tconv._flatten_params(again)
    assert "layers.1.ffn_out.w" in flat and "emb_ln.g" in flat and "word_emb" in flat
    enc2 = port_convert.encoder_from_numpy(flat, tcfg, "cpu")
    for a, b in zip(enc.parameters(), enc2.parameters()):
        assert torch.equal(a, b)


def test_artifact_written_by_the_port_loads_in_the_jax_package(tmp_path):
    tcfg = tenc.EncoderConfig(**KW)
    enc = tenc.init_params(tcfg, torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in enc.parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(6)) * 0.05)
    tconv.save_converted(port_convert.encoder_to_numpy(enc), tcfg, str(tmp_path / "b"))
    params, jcfg = jconv.load_converted(str(tmp_path / "b"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = jax.tree.map(jnp.asarray, params)
    ids, mask = _tokens()
    want = np.asarray(jenc.embed_program(params, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    got = tenc.embed_program(enc, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.abs(got - want).max() <= F32_TOL


def test_flatten_round_trip_and_names_equal_the_jax_package():
    jcfg = jenc.EncoderConfig(**KW)
    params = jax.tree.map(np.asarray, jenc.init_params(jcfg, 1))
    flat_t, flat_j = tconv._flatten_params(params), jconv._flatten_params(params)
    assert list(flat_t) == list(flat_j)
    back = tconv._unflatten_params(flat_t, jcfg.layers)
    assert jax.tree.structure(back) == jax.tree.structure(
        jconv._unflatten_params(flat_j, jcfg.layers))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(x, y)


def test_configs_equal_the_jax_package():
    from minivectordb_tpu.models import configs as jconfigs

    for table in ("REAL_CONFIGS", "FALLBACK_CONFIGS", "TRAINED_CONFIGS"):
        jt, tt = getattr(jconfigs, table), getattr(tconfigs, table)
        assert list(jt) == list(tt)
        for key in jt:
            assert dataclasses.asdict(jt[key]) == dataclasses.asdict(tt[key]), (table, key)
    for table in ("FALLBACK_SEEDS", "TRAINED_SEEDS", "HF_MODEL_NAMES"):
        assert getattr(jconfigs, table) == getattr(tconfigs, table)
    assert tconfigs.FALLBACK_VOCAB == jconfigs.FALLBACK_VOCAB
    e5 = tconfigs.E5_LARGE
    assert (e5.layers, e5.hidden, e5.heads, e5.intermediate, e5.vocab_size) == (
        24, 1024, 16, 4096, 250037)


@pytest.fixture(scope="module")
def tiny_hf_model():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.XLMRobertaConfig(
        vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=66, pad_token_id=1,
        layer_norm_eps=1e-5,
    )
    torch.manual_seed(0)
    model = transformers.XLMRobertaModel(cfg, add_pooling_layer=False)
    model.eval()
    return model, cfg


def test_converted_encoder_matches_transformers_forward(tiny_hf_model):
    model, hf_cfg = tiny_hf_model
    cfg = tconv.config_from_hf(hf_cfg)
    jcfg = jconv.config_from_hf(hf_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = tconv.params_from_state_dict(model.state_dict(), cfg)
    jparams = jconv.params_from_state_dict(model.state_dict(), jcfg)
    for x, y in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        assert np.array_equal(x, y)
    enc = port_convert.encoder_from_numpy(params, cfg, "cpu")
    # the dense weights are back in torch's own (out, in) orientation
    assert torch.equal(enc.layers[0].q.weight,
                       model.state_dict()["encoder.layer.0.attention.self.query.weight"])

    rng = np.random.default_rng(0)
    ids = rng.integers(4, 200, (3, 10), dtype=np.int64)
    mask = np.ones((3, 10), dtype=np.int64)
    mask[1, 7:] = 0
    ids[1, 7:] = 1
    with torch.no_grad():
        want = model(input_ids=torch.tensor(ids),
                     attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    got = tenc.encode(enc, torch.tensor(ids), torch.tensor(mask)).numpy()
    real = mask.astype(bool)
    assert np.abs(got[real] - want[real]).max() <= F32_TOL
    prefixed = {"roberta." + k: v for k, v in model.state_dict().items()}
    again = tconv.params_from_state_dict(prefixed, cfg)
    assert np.array_equal(again["layers"][1]["ffn_in"]["w"], params["layers"][1]["ffn_in"]["w"])
