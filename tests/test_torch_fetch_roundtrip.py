"""The port's fetch -> convert -> serve against the JAX package's, from one
real HF checkpoint on disk (tests/test_fetch_roundtrip.py's tiny
XLMRobertaModel and WordLevel fast tokenizer, saved with save_pretrained):

- the port's fetch_one writes the artifact (params.npz, config.json, the
  tokenizer files), leaf for leaf equal to what the JAX package's writes;
- EmbeddingModel serves it as "pretrained" and matches the transformers
  forward within 2e-4 (the JAX test's tolerance) and the JAX EmbeddingModel
  on the JAX artifact within 2e-5 (tests/test_torch_embedding_model.py);
- an artifact either package fetched serves in the other;
- the command line with --from-hf-cache returns 0.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

from minivectordb_tpu import embedding_model as jem  # noqa: E402
from minivectordb_tpu.models import configs as jax_configs  # noqa: E402
from minivectordb_tpu.models import fetch_weights as jax_fetch  # noqa: E402
from minivectordb_tpu_torch import embedding_model as tem  # noqa: E402
from minivectordb_tpu_torch.models import configs as port_configs  # noqa: E402
from minivectordb_tpu_torch.models import fetch_weights  # noqa: E402

from test_fetch_roundtrip import hf_checkpoint  # noqa: E402,F401  (the shared fixture)

TEXTS = ["hello world dogs", "i like cars", "animals like dogs and cats"]
TORCH_TOL = 2e-4  # tests/test_fetch_roundtrip.py
JAX_TOL = 2e-5  # tests/test_torch_embedding_model.py's float32 tolerance


@pytest.fixture
def fetched(hf_checkpoint, tmp_path, monkeypatch):  # noqa: F811
    """Both packages' fetch_one("small") from the checkpoint: (port's
    artifact root, JAX's artifact root)."""
    src, _, _ = hf_checkpoint
    monkeypatch.setitem(port_configs.HF_MODEL_NAMES, "small", src)
    monkeypatch.setitem(jax_configs.HF_MODEL_NAMES, "small", src)
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    assert fetch_weights.fetch_one("small", port_root) == os.path.join(port_root, "small")
    jax_fetch.fetch_one("small", jax_root)
    return port_root, jax_root


def _torch_forward(model, fast, text):
    """The transformers oracle: the e5 'passage ' prefix, masked mean-pool,
    L2 norm (tests/test_fetch_roundtrip.py)."""
    batch = fast(["passage " + text], return_tensors="pt", padding=True)
    with torch.no_grad():
        out = model(**batch).last_hidden_state
    mask = batch["attention_mask"][..., None].float()
    pooled = (out * mask).sum(1) / mask.sum(1)
    return torch.nn.functional.normalize(pooled, dim=-1)[0].numpy()


def _port_model(root, monkeypatch):
    monkeypatch.setenv("MINIVECTORDB_TORCH_WEIGHTS", root)
    return tem.EmbeddingModel(use_quantized_onnx_model=False, alternative_model="small",
                              device="cpu")


def _jax_model(root, monkeypatch):
    monkeypatch.setenv("MINIVECTORDB_TPU_WEIGHTS", root)
    return jem.EmbeddingModel(use_quantized_onnx_model=False,
                              alternative_model=jem.AlternativeModel.small)


def test_fetch_one_writes_the_artifact(fetched):
    port_root, _ = fetched
    for name in ("params.npz", "config.json", "tokenizer.json"):
        assert os.path.exists(os.path.join(port_root, "small", name)), name


def test_artifact_equals_the_jax_packages_leaf_for_leaf(fetched):
    port_root, jax_root = fetched
    with np.load(os.path.join(port_root, "small", "params.npz")) as got, \
            np.load(os.path.join(jax_root, "small", "params.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        assert len(got.files) == 5 + 16 * 2  # embeddings + 16 leaves a layer, 2 layers
        for name in want.files:
            assert got[name].dtype == want[name].dtype, name
            assert np.array_equal(got[name], want[name]), name
    with open(os.path.join(port_root, "small", "config.json")) as f:
        got_cfg = json.load(f)
    with open(os.path.join(jax_root, "small", "config.json")) as f:
        want_cfg = json.load(f)
    assert got_cfg == want_cfg
    assert sorted(os.listdir(os.path.join(port_root, "small"))) == sorted(
        os.listdir(os.path.join(jax_root, "small")))


def test_embedding_model_serves_it_like_torch_and_the_jax_package(
        hf_checkpoint, fetched, monkeypatch):  # noqa: F811
    _, model, fast = hf_checkpoint
    port_root, jax_root = fetched
    t = _port_model(port_root, monkeypatch)
    j = _jax_model(jax_root, monkeypatch)
    assert t.weights_source == j.weights_source == "pretrained"
    assert t.is_pretrained and t.is_trained
    got = np.asarray(t.extract_embeddings_batch(TEXTS), np.float32)
    want = np.asarray(j.extract_embeddings_batch(TEXTS), np.float32)
    assert got.shape == want.shape == (len(TEXTS), 32)
    assert np.abs(got - want).max() <= JAX_TOL
    for row, text in zip(got, TEXTS):
        np.testing.assert_allclose(row, _torch_forward(model, fast, text),
                                   rtol=TORCH_TOL, atol=TORCH_TOL)


@pytest.mark.parametrize("direction", ["jax_fetched_served_by_port",
                                       "port_fetched_served_by_jax"])
def test_an_artifact_serves_in_the_other_package(hf_checkpoint, fetched, monkeypatch,  # noqa: F811
                                                 direction):
    _, model, fast = hf_checkpoint
    port_root, jax_root = fetched
    if direction == "jax_fetched_served_by_port":
        served = _port_model(jax_root, monkeypatch)
    else:
        served = _jax_model(port_root, monkeypatch)
    assert served.weights_source == "pretrained"
    got = np.asarray(served.extract_embeddings(TEXTS[0]), np.float32)
    np.testing.assert_allclose(got, _torch_forward(model, fast, TEXTS[0]),
                               rtol=TORCH_TOL, atol=TORCH_TOL)


def test_command_line_from_the_local_cache(hf_checkpoint, tmp_path, monkeypatch, capsys):  # noqa: F811
    src, _, _ = hf_checkpoint
    monkeypatch.setitem(port_configs.HF_MODEL_NAMES, "small", src)
    out = str(tmp_path / "cli")
    assert fetch_weights.main(["--model", "small", "--from-hf-cache", "--out", out]) == 0
    assert os.path.exists(os.path.join(out, "small", "params.npz"))
    printed = capsys.readouterr().out
    assert f"export MINIVECTORDB_TORCH_WEIGHTS={os.path.abspath(out)}" in printed
    assert "MINIVECTORDB_TPU_WEIGHTS" not in printed
    with pytest.raises(SystemExit):
        fetch_weights.main(["--out", out])  # neither --model nor --all
