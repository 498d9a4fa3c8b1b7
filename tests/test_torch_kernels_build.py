"""kernels/build.py on the CPU: the compiler's output (ptxas -v: each
kernel's registers and spills) is kept beside the library it built, so a
later process that finds the library built reads the same report.

nvcc is not in this container: a stand-in compiler (a script that builds an
empty shared library with g++ and prints a ptxas-like line) takes its place
through MINIVECTORDB_TORCH_NVCC.
"""

import os
import shutil
import stat
import sys

import pytest

from minivectordb_tpu_torch.kernels import build

_REPORT = "ptxas info    : Used 42 registers, used 1 barriers"


@pytest.fixture
def stand_in_nvcc(tmp_path, monkeypatch):
    """(build directory, file that counts the compiler's runs); the module's
    caches are swapped for empty ones, so other tests see none of this."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the stand-in compiler")
    calls = tmp_path / "calls"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import subprocess, sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"open({str(calls)!r}, 'a').write('x')\n"
        f"stub = {str(tmp_path / 'stub.c')!r}\n"
        "open(stub, 'w').write('int stub(void) { return 0; }\\n')\n"
        "subprocess.run(['g++', '-shared', '-fPIC', '-o', out, '-x', 'c', stub], check=True)\n"
        f"print({_REPORT!r})\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    out_dir = tmp_path / "build"
    monkeypatch.setenv("MINIVECTORDB_TORCH_NVCC", str(script))
    monkeypatch.setenv("MINIVECTORDB_TORCH_BUILD_DIR", str(out_dir))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_info", {})
    return out_dir, calls


def test_the_compilers_report_is_kept_beside_the_library(stand_in_nvcc, monkeypatch):
    out_dir, calls = stand_in_nvcc
    build.load_library("flash_attention_bwd_bf16")
    info = build.build_info["flash_attention_bwd_bf16"]
    assert info["seconds"] > 0 and _REPORT in info["log"]
    assert os.path.isfile(info["path"]) and os.path.dirname(info["path"]) == str(out_dir)
    with open(info["path"] + ".log", encoding="utf-8") as f:
        assert f.read() == info["log"]
    assert calls.read_text() == "x"

    # a later process: the library is there, so nothing is built and the
    # report is read back
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_info", {})
    build.load_library("flash_attention_bwd_bf16")
    again = build.build_info["flash_attention_bwd_bf16"]
    assert again["seconds"] == 0.0 and again["path"] == info["path"]
    assert again["log"] == info["log"]
    assert calls.read_text() == "x"
    assert sorted(os.listdir(out_dir)) == sorted(
        os.path.basename(info["path"]) + suffix for suffix in ("", ".log"))
