"""models/train_builtin.py of the port against the JAX package's on the CPU,
and the port's copies of models/builtin_data.py and models/quality_probes.py
held equal to the originals.

The probes run on the bundled builtin artifact (read by path; nothing under
minivectordb_tpu/resources/ is written). Tolerances: boolean probes and
accuracies equal; margins and ratios 1e-5 (cosines of unit float32 vectors
summed in another order). ``main`` writes its artifact to a temporary
directory only.
"""

import ast
import dataclasses
import inspect
import json
import os

import jax
import numpy as np
import pytest

from minivectordb_tpu.embedding_model import _load_bundled as jax_bundled
from minivectordb_tpu.models import builtin_data as jdata
from minivectordb_tpu.models import quality_probes as jprobes
from minivectordb_tpu.models import train_builtin as jtb
from minivectordb_tpu.models.encoder import init_params as jax_init
from minivectordb_tpu_torch.models import builtin_data as tdata
from minivectordb_tpu_torch.models import configs as tconfigs
from minivectordb_tpu_torch.models import quality_probes as tprobes
from minivectordb_tpu_torch.models import train_builtin as ttb

FLOAT_TOL = 1e-5


def _body(module) -> str:
    """The module's code without its docstring, as an AST dump."""
    tree = ast.parse(inspect.getsource(module))
    if isinstance(tree.body[0], ast.Expr) and isinstance(tree.body[0].value, ast.Constant):
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("pair", [(jdata, tdata), (jprobes, tprobes)],
                         ids=["builtin_data", "quality_probes"])
def test_the_copies_are_the_originals(pair):
    original, copy = pair
    assert _body(copy) == _body(original)
    assert "jax" not in inspect.getsource(copy).split('"""', 2)[2]


def test_batches_and_word_list_equal_the_originals():
    assert tdata.word_list() == jdata.word_list()
    tok = ttb.make_tokenizer()
    jit = jdata.batch_iterator(tok, 16, 24, seed=5)
    tit = tdata.batch_iterator(tok, 16, 24, seed=5)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert jb.keys() == tb.keys()
        for key in jb:
            np.testing.assert_array_equal(jb[key], tb[key])
    assert tprobes.STRESSOR_FLOORS == jprobes.STRESSOR_FLOORS
    assert tprobes.STRESSORS == jprobes.STRESSORS


def test_tokenizer_trained_ids_and_shrink_equal_the_jax_packages():
    ttok, jtok = ttb.make_tokenizer(), jtb.make_tokenizer()
    assert ttok.words == jtok.words and ttok.drop_oov == jtok.drop_oov
    np.testing.assert_array_equal(ttb.trained_token_ids(ttok), jtb.trained_token_ids(jtok))
    params = jax.tree.map(np.asarray, jax_init(jtb.TRAINED_BUILTIN, seed=0))
    got = ttb.shrink_untrained_rows(params, ttok)
    want = jtb.shrink_untrained_rows(params, jtok)
    np.testing.assert_array_equal(got["word_emb"], np.asarray(want["word_emb"]))
    assert got["layers"] is params["layers"]  # only the word table is touched


@pytest.fixture(scope="module")
def bundled():
    jenc = jax_bundled("builtin")
    tenc, ttok = ttb._bundled("builtin", "cpu")
    assert jenc is not None
    return jenc, tenc, ttok


def _same_probes(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, w in want.items():
        if isinstance(w, bool):
            assert got[key] is w, key
        elif key.endswith("_acc") or key.startswith("stressor_"):
            assert got[key] == w, key
        else:
            assert abs(got[key] - w) <= FLOAT_TOL, key


def test_scenario_probes_equal_the_jax_packages(bundled):
    jenc, tenc, ttok = bundled
    for floor in (0.0, 0.35):
        jcfg = dataclasses.replace(jenc.cfg, cos_floor=floor)
        tcfg = dataclasses.replace(tenc.cfg, cos_floor=floor)
        _same_probes(ttb.scenario_probes(tenc, ttok, cfg=tcfg),
                     jtb.scenario_probes(jenc.params, jenc.tokenizer, cfg=jcfg))


def test_run_probes_equal_the_jax_packages_and_the_bundled_record(bundled):
    jenc, tenc, ttok = bundled
    got = ttb.run_probes(tenc, ttok, log=lambda _s: None)
    want = jtb.run_probes(jenc.params, jenc.tokenizer, log=lambda _s: None, cfg=jenc.cfg)
    _same_probes(got, want)
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "minivectordb_tpu", "resources", "builtin", "probes.json")) as f:
        recorded = json.load(f)
    assert ttb.probes_pass(got) == jtb.probes_pass(want) == jtb.probes_pass(recorded)


def test_main_writes_an_artifact_that_embedding_model_loads(tmp_path, monkeypatch, capsys):
    from minivectordb_tpu_torch import EmbeddingModel

    out = tmp_path / "resources" / "builtin"
    assert ttb.main(["--steps", "2", "--batch", "8", "--force", "--out", str(out),
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "training builtin-512" in printed and "artifact written to" in printed
    assert sorted(os.listdir(out)) == ["config.json", "params.npz", "probes.json", "vocab.json"]
    with np.load(out / "params.npz") as z:
        assert all(z[k].dtype == np.float16 for k in z.files)
    monkeypatch.setenv("MINIVECTORDB_TORCH_RESOURCES", str(tmp_path / "resources"))
    model = EmbeddingModel(device="cpu")
    assert model.weights_source == "bundled-trained"
    emb = model.extract_embeddings_batch(["i like dogs", "the sky is blue"])
    assert emb.shape == (2, tconfigs.TRAINED_BUILTIN.hidden)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
    # the same artifact through the JAX package's loader
    from minivectordb_tpu.models.convert import load_converted

    params, cfg = load_converted(str(out))
    assert cfg.hidden == 512 and params["word_emb"].shape == (4096, 512)


def test_main_needs_out_to_train_and_probe_only_writes_only_there(tmp_path, capsys):
    with pytest.raises(SystemExit):
        ttb.main(["--steps", "1", "--device", "cpu"])
    if not __import__("torch").cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            ttb.main(["--steps", "1", "--out", str(tmp_path / "x")])
    rc = ttb.main(["--probe-only", "--out", str(tmp_path), "--device", "cpu"])
    assert rc == 0 and "probe gate: PASS" in capsys.readouterr().out
    with open(tmp_path / "probes.json") as f:
        assert json.load(f)["dogs_top1_animals"] is True
