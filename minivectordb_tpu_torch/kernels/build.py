"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``minivectordb_tpu_torch/build/lib<name>_<hash>.so`` at first use
(seconds; no PyTorch headers are involved). The file name carries a hash of
the source and the flags, so an edited source rebuilds and a stale library is
never loaded. Nothing is built or looked up when the package is imported.

Override the build directory with ``MINIVECTORDB_TORCH_BUILD_DIR`` (for a
read-only install) and the compiler with ``MINIVECTORDB_TORCH_NVCC``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

# -Xptxas -v only makes ptxas report each kernel's registers, shared memory
# and spills (kept in build_info[name]["log"]); it changes no code.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every source of csrc/: the phase-1 scan (K1, K2), the IVF probes (K3-K5),
# flash attention's forward (K6) and its backward (K7, K8)
SOURCES = ("phase1", "ivf_probe", "flash_attention", "flash_attention_bwd")

_lock = threading.Lock()  # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}  # one per source: sources build in parallel
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when the library was already there),
#          "log": compiler output, "path": the shared library}
build_info: dict[str, dict] = {}


def build_dir() -> str:
    return os.environ.get(
        "MINIVECTORDB_TORCH_BUILD_DIR", os.path.join(_PKG_DIR, "build")
    )


def find_nvcc() -> str:
    cands = [os.environ.get("MINIVECTORDB_TORCH_NVCC")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at MINIVECTORDB_TORCH_NVCC, CUDA_HOME, PATH "
        "and /usr/local/cuda): the CUDA kernels are compiled at first use "
        "and need the CUDA toolkit"
    )


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it.
    Raises if the compiler fails. Different sources may build at once, from
    different threads."""
    if name not in SOURCES:
        raise ValueError(f"{name!r} is not a source of csrc/ {SOURCES}")
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, name + ".cu")
        with open(src, "rb") as f:
            source = f.read()
        digest = hashlib.sha256(
            source + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"lib{name}_{digest}.so")
        info = {"seconds": 0.0, "log": "", "path": path}
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True,
            )
            info["seconds"] = time.perf_counter() - t0
            info["log"] = (proc.stdout + proc.stderr).strip()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n{info['log']}"
                )
            os.replace(tmp, path)  # atomic: a racing process loads old or new
        build_info[name] = info
        lib = ctypes.CDLL(path)
        _libs[name] = lib
        return lib
