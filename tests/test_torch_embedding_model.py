"""The port's EmbeddingModel (device="cpu") against the JAX package's, for the
four bundled slots, on the same texts. float32 unit vectors agree within 2e-5
(the two frameworks sum in different orders); compute_dtype="bfloat16" within
2e-2 per component and a cosine of 0.995 (bf16 roundings fall at different
places in the two frameworks)."""

import inspect
import os
import warnings

import numpy as np
import pytest
import torch

from minivectordb_tpu import embedding_model as jem
from minivectordb_tpu_torch import embedding_model as tem
from minivectordb_tpu_torch.models import configs as tconfigs

F32_TOL = 2e-5

SHORT = ["i like animals", "i like cars", "the stock market fell sharply today",
         "dogs are friendly", "zzqx vvkj"]
# more than 300 tokens of vocabulary words: the sequence bucket is 512
LONG = " ".join(["dogs and cats like the house by the blue river in summer"] * 30)

SLOTS = {
    "builtin": dict(use_quantized_onnx_model=True),
    "small": dict(use_quantized_onnx_model=False, alternative_model="small"),
    "large": dict(use_quantized_onnx_model=False, alternative_model="large"),
    "bgem3": dict(use_quantized_onnx_model=False, alternative_model="bgem3"),
}
_cache = {}


def _pair(slot):
    if slot not in _cache:
        _cache[slot] = (tem.EmbeddingModel(**SLOTS[slot], device="cpu"),
                        jem.EmbeddingModel(**SLOTS[slot]))
    return _cache[slot]


@pytest.mark.parametrize("slot", list(SLOTS))
def test_bundled_slot_equals_the_jax_model(slot):
    t, j = _pair(slot)
    assert t.weights_source == j.weights_source == "bundled-trained"
    assert t.is_trained and not t.is_pretrained
    assert t.model.cfg == tconfigs.TRAINED_CONFIGS[slot]
    assert t.model.pooling == j.model.pooling == "mean"
    assert t.model.prefix == j.model.prefix == ("passage " if slot in ("small", "large") else "")
    got, want = t.extract_embeddings_batch(SHORT), j.extract_embeddings_batch(SHORT)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= F32_TOL
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    # one text of 300+ tokens: S = 512 on both sides
    ids, _mask = t.model._tokenize_padded([LONG], 512)
    assert ids.shape == (1, 512)
    assert np.abs(np.asarray(t.extract_embeddings(LONG), np.float32)
                  - np.asarray(j.extract_embeddings(LONG), np.float32)).max() <= F32_TOL


@pytest.mark.parametrize("slot", list(SLOTS))
def test_tokenize_padded_equals_the_jax_model(slot):
    t, j = _pair(slot)
    for texts in (SHORT[:1], SHORT[:3], SHORT, [LONG, "short"]):
        ti, tm = t.model._tokenize_padded(texts, 512)
        ji, jm = j.model._tokenize_padded(texts, 512)
        assert np.array_equal(ti, ji) and np.array_equal(tm, jm)
        assert ti.shape[0] & (ti.shape[0] - 1) == 0  # batch padded to a power of two
        assert (tm.sum(axis=1) >= 1).all()  # pad rows keep one token


def test_extract_methods_keep_their_names_and_types():
    t, j = _pair("small")
    for name in ("extract_embeddings", "extract_embeddings_e5_multi",
                 "extract_embeddings_bgem3", "extract_embeddings_quant_onnx"):
        got, want = getattr(t, name)("i like dogs"), getattr(j, name)("i like dogs")
        assert type(got) is type(want)
        assert np.abs(np.asarray(got) - np.asarray(want)).max() <= F32_TOL
    # the 'passage ' prefix is part of the e5 slots' input
    bare = tem.EmbeddingModel(device="cpu")
    assert bare.model.prefix == ""
    padded, _mask = t.model._tokenize_padded(["x"], 512)
    prefixed = t.model.tokenizer(["passage x"], max_length=512)["input_ids"][0]
    assert padded[0, : len(prefixed)].tolist() == prefixed


def test_public_surface_is_the_jax_class_plus_device():
    def public(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    assert public(tem.EmbeddingModel) == public(jem.EmbeddingModel)
    jp = list(inspect.signature(jem.EmbeddingModel.__init__).parameters.values())
    tp = list(inspect.signature(tem.EmbeddingModel.__init__).parameters.values())
    assert [str(p) for p in tp if p.name != "device"] == [str(p) for p in jp]
    dev = inspect.signature(tem.EmbeddingModel.__init__).parameters["device"]
    assert dev.default is None and dev.kind is inspect.Parameter.KEYWORD_ONLY
    assert [m.value for m in tem.AlternativeModel] == [m.value for m in jem.AlternativeModel]
    for name in ("extract_embeddings", "extract_embeddings_batch", "average_pool", "warmup"):
        assert str(inspect.signature(getattr(tem.EmbeddingModel, name))) == str(
            inspect.signature(getattr(jem.EmbeddingModel, name)))


def test_e5_model_size_back_compat_and_validation():
    t = tem.EmbeddingModel(use_quantized_onnx_model=False, e5_model_size="small", device="cpu")
    assert t.alternative_model is tem.AlternativeModel.small and t.model.cfg.hidden == 384
    with pytest.raises(ValueError):
        tem.EmbeddingModel(use_quantized_onnx_model=False, alternative_model="huge", device="cpu")
    with pytest.raises(AssertionError):
        tem.EmbeddingModel(onnx_model_cpu_core_count="4", device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        tem.EmbeddingModel(compute_dtype="float16", device="cpu")
    assert tem.EmbeddingModel(onnx_model_cpu_core_count=4, device="cpu").onnx_model_cpu_core_count == 4


def test_average_pool_equals_the_jax_helper():
    t, j = _pair("builtin")
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 6, 8)).astype(np.float32)
    m = np.array([[1] * 6, [1, 1, 0, 0, 0, 0], [0] * 6])
    assert np.array_equal(t.average_pool(h, m), j.average_pool(h, m))
    assert np.isfinite(t.average_pool(h, m)).all()


def test_device_none_raises_without_a_card():
    if torch.cuda.is_available():
        assert tem.EmbeddingModel().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tem.EmbeddingModel()
        with pytest.raises(RuntimeError, match="CUDA"):
            tem.EmbeddingModel(device="cuda")
    assert tem.EmbeddingModel(device="cpu").device == torch.device("cpu")


def test_compute_dtype_bfloat16():
    t = tem.EmbeddingModel(compute_dtype="bfloat16", device="cpu")
    j = jem.EmbeddingModel(compute_dtype="bfloat16")
    assert t.model.encoder.dtype == torch.bfloat16
    got, want = t.extract_embeddings_batch(SHORT), j.extract_embeddings_batch(SHORT)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-2
    assert np.sum(got * want, axis=1).min() >= 0.995
    f32 = _pair("builtin")[0].extract_embeddings_batch(SHORT)
    assert np.sum(got * f32, axis=1).min() >= 0.99


def test_router_serves_small_batches_and_is_bypassed_by_large_ones(monkeypatch):
    """On the CPU the host route is off (host == device). With the device test
    answered 'not the cpu', batches of at most 8 go through the router (host
    first, then a timed device call, in line), larger ones straight to the
    device; MINIVECTORDB_TORCH_HOST_EMBED_BATCH=0 switches the route off."""
    t = tem.EmbeddingModel(device="cpu")
    enc = t.model
    assert not enc._host_capable() and enc.routing_stats()["host_capable"] is False
    before = t.extract_embeddings_batch(SHORT[:2])
    assert enc.routing_stats()["host_calls"] == 0

    monkeypatch.setattr(type(enc), "_host_capable", lambda self: tem._HOST_EMBED_MAX_BATCH > 0)
    for _ in range(4):  # the host path primes first
        out = t.extract_embeddings_batch(SHORT[:2])
        assert np.array_equal(out, before)
    st = enc.routing_stats()
    assert st["host_calls"] == 4 and st["host_ema_s"] is not None and st["device_ema_s"] is None
    dev_calls = st["device_calls"]
    t.extract_embeddings_batch(SHORT[:2])  # fifth call: the device, warmed then timed
    st = enc.routing_stats()
    assert st["device_calls"] == dev_calls + 2 and st["device_ema_s"] is not None
    host_calls = st["host_calls"]
    big = ["sentence %d" % i for i in range(tem._HOST_EMBED_MAX_BATCH + 1)]
    t.extract_embeddings_batch(big)  # over the routing bound
    assert enc.routing_stats()["host_calls"] == host_calls
    monkeypatch.setattr(tem, "_HOST_EMBED_MAX_BATCH", 0)
    t.extract_embeddings_batch(SHORT[:2])
    assert enc.routing_stats()["host_calls"] == host_calls
    # a real checkpoint's size is never host-routed
    monkeypatch.undo()
    assert tem._HOST_EMBED_MAX_LAYERS == jem._HOST_EMBED_MAX_LAYERS
    assert tem._HOST_EMBED_MAX_BATCH == jem._HOST_EMBED_MAX_BATCH == 8


def test_bf16_cast_drops_the_host_copy():
    t = tem.EmbeddingModel(device="cpu")
    host = t.model._host_encoder_synced()
    assert host is not t.model.encoder and host.dtype == torch.float32
    t.compute_dtype = "bfloat16"
    t._maybe_cast()
    assert t.model._host_encoder_synced().dtype == torch.bfloat16


def test_weights_order_converted_then_bundled_then_seeded(tmp_path, monkeypatch):
    from minivectordb_tpu_torch import convert as port_convert
    from minivectordb_tpu_torch.models import convert as tconv
    from minivectordb_tpu_torch.models import encoder as tenc

    # 1. a converted artifact under MINIVECTORDB_TORCH_WEIGHTS/<slot> wins
    cfg = tenc.EncoderConfig(vocab_size=500, hidden=32, layers=1, heads=2, intermediate=64)
    enc = tenc.init_params(cfg, torch.Generator().manual_seed(1))
    tconv.save_converted(port_convert.encoder_to_numpy(enc), cfg, str(tmp_path / "w" / "large"))
    monkeypatch.setenv("MINIVECTORDB_TORCH_WEIGHTS", str(tmp_path / "w"))
    m = tem.EmbeddingModel(use_quantized_onnx_model=False, alternative_model="large", device="cpu")
    assert m.weights_source == "pretrained" and m.is_pretrained and m.model.cfg == cfg
    assert m.model.prefix == "passage " and m.extract_embeddings_batch(SHORT).shape == (5, 32)
    # the JAX package reads the same directory through its own variable
    monkeypatch.setenv("MINIVECTORDB_" + "TPU_WEIGHTS", str(tmp_path / "w"))
    j = jem.EmbeddingModel(use_quantized_onnx_model=False, alternative_model="large")
    assert j.weights_source == "pretrained"
    assert np.abs(m.extract_embeddings_batch(SHORT)
                  - j.extract_embeddings_batch(SHORT)).max() <= F32_TOL
    # the builtin slot ignores it; a slot without a directory falls through
    assert tem.EmbeddingModel(device="cpu").weights_source == "bundled-trained"
    monkeypatch.delenv("MINIVECTORDB_" + "TPU_WEIGHTS")
    monkeypatch.setenv("MINIVECTORDB_TORCH_WEIGHTS", str(tmp_path / "nothing"))
    assert tem.EmbeddingModel(use_quantized_onnx_model=False, alternative_model="small",
                              device="cpu").weights_source == "bundled-trained"
    # 2. no bundled artifact either: the seeded fallback, with the warning
    monkeypatch.setattr(tem, "_resources_dir", lambda: str(tmp_path / "empty"))
    with pytest.warns(UserWarning, match="seeded encoder"):
        s1 = tem.EmbeddingModel(device="cpu")
    assert s1.weights_source == "seeded" and not s1.is_trained
    assert s1.model.cfg == tconfigs.FALLBACK_CONFIGS["builtin"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s2 = tem.EmbeddingModel(device="cpu")
    a, b = s1.extract_embeddings_batch(SHORT), s2.extract_embeddings_batch(SHORT)
    assert np.array_equal(a, b) and a.shape == (5, 512)  # the same seed, the same values
    assert np.allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)


def test_corrupt_bundled_artifact_warns_and_falls_back(tmp_path, monkeypatch):
    bundle = tmp_path / "res" / "builtin"
    bundle.mkdir(parents=True)
    (bundle / "config.json").write_text('{"vocab_size": 10}')
    monkeypatch.setattr(tem, "_resources_dir", lambda: str(tmp_path / "res"))
    with pytest.warns(UserWarning) as rec:
        m = tem.EmbeddingModel(device="cpu")
    assert m.weights_source == "seeded"
    assert any("failed to load" in str(w.message) for w in rec)


def test_resources_are_read_from_the_jax_package_as_data_files():
    assert os.path.isfile(os.path.join(tem._bundled_dir("builtin"), "params.npz"))
    assert tem._bundled_dir("large").endswith(os.path.join("resources", "trained_large"))
    assert tem._bundled_dir("builtin") == jem._bundled_dir("builtin")
