"""Builds native/fastops.cpp with g++ into the package's build directory.

    python -m minivectordb_tpu_torch.native.build

``native/fastops.py`` calls ``build()`` at first use, so this is only needed
to build ahead. The library goes where the CUDA kernels go
(``kernels.build.build_dir()``, ``MINIVECTORDB_TORCH_BUILD_DIR`` to move it)
as ``libfastops_<hash>.so``: the hash covers the source and the flags, so an
edited source rebuilds. The compiler writes to a name of its own and the
result is moved into place with ``os.replace``, so processes that build at
once (test workers) never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import threading

from minivectordb_tpu_torch.kernels.build import build_dir

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastops.cpp")
# no -march=native and no contraction into FMAs: the library's floating
# point (partial_ratio's rounding to 0..100) is the Python path's
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")


def find_cxx() -> str:
    """g++ on PATH; FileNotFoundError when there is none."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError(
            "no C++ compiler (g++ on PATH): the native fast path is not built "
            "and the pure-Python paths serve"
        )
    return cxx


def build() -> str:
    """The path of the built library, compiling it if it is not there yet.
    Raises FileNotFoundError without a compiler and RuntimeError when the
    compiler fails."""
    with open(SOURCE, "rb") as f:
        source = f.read()
    digest = hashlib.sha256(source + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    path = os.path.join(out_dir, f"libfastops_{digest}.so")
    if os.path.exists(path):
        return path
    cxx = find_cxx()
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{cxx} failed on {SOURCE} (exit {proc.returncode}):\n"
            f"{(proc.stdout + proc.stderr).strip()}"
        )
    os.replace(tmp, path)
    return path


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
