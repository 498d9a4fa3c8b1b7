"""The port stands alone: it imports torch and numpy, never jax and nothing of
the JAX package; its public classes have the JAX classes' surfaces plus
`device`."""

import ast
import inspect
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "minivectordb_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(PORT):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "minivectordb_tpu")


def test_import_in_fresh_process_loads_no_jax():
    code = (
        "import sys\n"
        "import minivectordb_tpu_torch as p\n"
        "import minivectordb_tpu_torch.convert, minivectordb_tpu_torch.ops.fused_scan\n"
        "import minivectordb_tpu_torch.kernels.build, minivectordb_tpu_torch.utils.telemetry\n"
        "import minivectordb_tpu_torch.ops.ivf, minivectordb_tpu_torch.ops.ivf_probe\n"
        "import minivectordb_tpu_torch.ops.flash_attention\n"
        "import minivectordb_tpu_torch.models.encoder, minivectordb_tpu_torch.models.configs\n"
        "import minivectordb_tpu_torch.models.tokenizer, minivectordb_tpu_torch.models.convert\n"
        "import minivectordb_tpu_torch.embedding_model, minivectordb_tpu_torch.core.pipeline\n"
        "import minivectordb_tpu_torch.profile_search\n"
        "import minivectordb_tpu_torch.models.train, minivectordb_tpu_torch.models.checkpoint\n"
        "import minivectordb_tpu_torch.models.train_builtin\n"
        "import minivectordb_tpu_torch.models.builtin_data\n"
        "import minivectordb_tpu_torch.models.quality_probes\n"
        "import minivectordb_tpu_torch.models.fetch_weights\n"
        "import minivectordb_tpu_torch.core.wal, minivectordb_tpu_torch.core.sharding\n"
        "import minivectordb_tpu_torch.rerank.device\n"
        "import minivectordb_tpu_torch.parallel.mesh, minivectordb_tpu_torch.parallel.dist_scan\n"
        "import minivectordb_tpu_torch.parallel.dist_ivf, minivectordb_tpu_torch.parallel.multihost\n"
        "from minivectordb_tpu_torch import ShardedVectorDatabase, ShardedVectorDatabaseUsearch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'minivectordb_tpu'))\n"
        "assert not bad, bad\n"
        "assert p.__all__ == ['VectorDatabase', 'ShardedVectorDatabase', "
        "'ShardedVectorDatabaseUsearch', 'EmbeddingModel', 'AlternativeModel', "
        "'__version__'], p.__all__\n"
        "assert p.EmbeddingModel(device='cpu').weights_source == 'bundled-trained'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'minivectordb_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean', p.__version__)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_by_ast(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert not _forbidden(alias.name), (path, node.lineno, alias.name)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0 and not _forbidden(node.module or ""), (
                path, node.lineno, node.module)
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "id", None) or getattr(fn, "attr", None)
            if name in ("__import__", "import_module") and node.args:
                arg = node.args[0]
                assert not (isinstance(arg, ast.Constant)
                            and _forbidden(str(arg.value))), (path, node.lineno)


def test_fetch_weights_imports_without_transformers():
    """transformers is read inside fetch_one only: without it (as on a card
    that has none) the module imports and fetch_one alone raises."""
    code = (
        "import sys\n"
        "sys.modules['transformers'] = None\n"
        "import minivectordb_tpu_torch\n"
        "from minivectordb_tpu_torch.models import fetch_weights\n"
        "assert callable(fetch_weights.main)\n"
        "try:\n"
        "    fetch_weights.fetch_one('small', 'unused')\n"
        "except ImportError:\n"
        "    print('fetch_one raised ImportError')\n"
        "else:\n"
        "    raise SystemExit('fetch_one ran without transformers')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'minivectordb_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "fetch_one raised ImportError"


def test_kernel_modules_import_without_nvcc_or_triton():
    """Nothing is built or looked up at import: the CPU tests import every
    module of the port."""
    from minivectordb_tpu_torch.kernels import build
    from minivectordb_tpu_torch.ops import fused_scan

    assert os.path.isfile(os.path.join(build.CSRC_DIR, "phase1.cu"))
    assert build.build_info == {} and fused_scan._fns == {}
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    with open(os.path.join(build.CSRC_DIR, "phase1.cu"), encoding="utf-8") as f:
        src = f.read()
    for symbol in ("phase1_f32", "phase1_bf16", "phase1_i8"):
        assert f'extern "C" int {symbol}(' in src
        assert symbol in fused_scan._ARGTYPES
    # the product is computed in the kernel's own body
    assert "cublas" not in src.lower() and "cutlass" not in src.lower()


def test_ivf_probe_kernels_have_a_source_and_build_nothing_at_import():
    from minivectordb_tpu_torch.kernels import build
    from minivectordb_tpu_torch.ops import ivf_probe

    assert ivf_probe._fns == {} and "ivf_probe" not in build.build_info
    with open(os.path.join(build.CSRC_DIR, "ivf_probe.cu"), encoding="utf-8") as f:
        src = f.read()
    for symbol in ("ivf_probe_f32", "ivf_probe_bf16", "ivf_grouped_f32",
                   "ivf_grouped_bf16", "ivf_grouped_i8"):
        assert f'extern "C" int {symbol}(' in src
        assert symbol in ivf_probe._ARGTYPES and symbol in ivf_probe.LAUNCHES
    assert "mma.sync.aligned.m16n8k16" in src and "mma.sync.aligned.m16n8k32" in src
    assert "cublas" not in src.lower() and "cutlass" not in src.lower()


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def _jax_and_port_classes():
    import minivectordb_tpu as jax_pkg
    import minivectordb_tpu_torch as port

    return [(getattr(jax_pkg, n), getattr(port, n)) for n in
            ("VectorDatabase", "ShardedVectorDatabase", "ShardedVectorDatabaseUsearch")]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["flat", "sharded", "usearch"])
def test_public_surface_is_the_jax_class_plus_device(which):
    JaxDB, TorchDB = _jax_and_port_classes()[which]
    assert _public(TorchDB) == _public(JaxDB)
    for name in sorted(_public(JaxDB)):
        j, t = inspect.getattr_static(JaxDB, name), inspect.getattr_static(TorchDB, name)
        assert type(j) is type(t), name
        if isinstance(j, property):
            assert (j.fset is None) == (t.fset is None), name
        else:
            assert str(inspect.signature(t)) == str(inspect.signature(j)), name
    jp = list(inspect.signature(JaxDB.__init__).parameters.values())
    tp = list(inspect.signature(TorchDB.__init__).parameters.values())
    assert [str(p) for p in tp[:-1]] == [str(p) for p in jp]
    assert tp[-1].name == "device" and tp[-1].default is None
    assert tp[-1].kind is inspect.Parameter.KEYWORD_ONLY


def test_engine_and_store_take_device():
    from minivectordb_tpu_torch.core.engine import SearchEngine
    from minivectordb_tpu_torch.core.store import VectorStore

    for cls in (SearchEngine, VectorStore):
        assert inspect.signature(cls.__init__).parameters["device"].default is None


def test_constructor_without_cuda_raises(tmp_path):
    import torch

    from minivectordb_tpu_torch import VectorDatabase

    path = str(tmp_path / "db.pkl")
    if torch.cuda.is_available():
        assert VectorDatabase(path).stats()["count"] == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            VectorDatabase(path)
        with pytest.raises(RuntimeError, match="CUDA"):
            VectorDatabase(path, device="cuda")
    assert VectorDatabase(path, device="cpu").stats()["count"] == 0


def test_port_reads_its_own_environment_variables_only():
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            src = f.read()
        assert "MINIVECTORDB_TPU_" not in src.replace("MINIVECTORDB_TPU_TORCH", ""), path
