"""ctypes loader for the C++ host fast path (native/fastops.cpp).

Counterpart of ``minivectordb_tpu/native/fastops.py``, with the same entry
points: ``hash_ngrams`` (rerank/hashing.py), ``partial_ratio``
(rerank/fuzzy.py), ``crc32`` and ``wal_append`` (core/wal.py). Each returns
None when the library is not there, and the caller takes its pure-Python
path, which gives the same result. The library is built at first use
(native/build.py), not when the package is imported; ``available()`` says
whether it loaded, and if not, why (no compiler, a failed build).

Unlike the JAX package, whose callers swallow any exception of the fast path
and fall back, an error raised by a loaded library reaches the caller here:
the fallback stands in for a missing library, not for a failing one.

``CALLS`` counts the calls that went into the library, per entry point, and
nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from dataclasses import dataclass

import numpy as np

from minivectordb_tpu_torch.native import build

CALLS = {"hash_ngrams": 0, "partial_ratio": 0, "crc32": 0, "wal_append": 0}
_calls_lock = threading.Lock()  # the sharded classes append from several threads


def reset_calls() -> None:
    with _calls_lock:
        for name in CALLS:
            CALLS[name] = 0


def _count(name: str) -> None:
    with _calls_lock:
        CALLS[name] += 1


@dataclass(frozen=True)
class Status:
    """Whether the library loaded (truthy when it did) and ``detail``: its
    path, or why it is not there."""

    loaded: bool
    detail: str

    def __bool__(self) -> bool:
        return self.loaded


_lock = threading.Lock()
_LIB = None
_STATUS: Status | None = None

_ARGTYPES = {
    "mvdb_hash_ngrams": (None, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.POINTER(ctypes.c_double)]),
    "mvdb_partial_ratio": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64,
                                          ctypes.c_char_p, ctypes.c_int64]),
    "mvdb_crc32": (ctypes.c_uint32, [ctypes.c_char_p, ctypes.c_int64]),
    "mvdb_wal_append": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int]),
}


def _load():
    """The loaded library, building it at the first call; None when there is
    no compiler or the build failed (``available()`` keeps the reason)."""
    global _LIB, _STATUS
    if _STATUS is not None:
        return _LIB
    with _lock:
        if _STATUS is None:
            try:
                path = build.build()
                lib = ctypes.CDLL(path)
                for name, (restype, argtypes) in _ARGTYPES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _LIB, _STATUS = lib, Status(True, path)
            except FileNotFoundError as e:  # no compiler: the Python paths serve
                _STATUS = Status(False, str(e))
            except (RuntimeError, OSError) as e:
                _STATUS = Status(False, f"the native fast path did not build: {e}")
                warnings.warn(_STATUS.detail, RuntimeWarning, stacklevel=3)
    return _LIB


def available() -> Status:
    """Loads the library if that was not tried yet; its ``Status``."""
    _load()
    return _STATUS


def hash_ngrams(text: str, n_features: int, nmin: int, nmax: int):
    """Signed char-ngram feature hashing of ``text`` (the caller lowercases
    it) into ``n_features`` float64 buckets; None without the library."""
    lib = _load()
    if lib is None:
        return None
    data = text.encode("utf-8")
    out = np.zeros(n_features, dtype=np.float64)
    lib.mvdb_hash_ngrams(data, len(data), n_features, nmin, nmax,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    _count("hash_ngrams")
    return out


def partial_ratio(s1: str, s2: str):
    """0..100 best-window Indel similarity; None without the library."""
    lib = _load()
    if lib is None:
        return None
    b1, b2 = s1.encode("utf-8"), s2.encode("utf-8")
    _count("partial_ratio")
    return int(lib.mvdb_partial_ratio(b1, len(b1), b2, len(b2)))


def crc32(data: bytes):
    """CRC32 (zlib's) of a byte string; None without the library."""
    lib = _load()
    if lib is None:
        return None
    _count("crc32")
    return int(lib.mvdb_crc32(data, len(data)))


def wal_append(path: str, payload: bytes, fsync: bool = False):
    """Appends one CRC-framed record to the WAL file (core/wal.py's framing);
    None without the library, else whether the write succeeded."""
    lib = _load()
    if lib is None:
        return None
    _count("wal_append")
    rc = lib.mvdb_wal_append(os.fsencode(path), payload, len(payload), int(fsync))
    return rc == 0
