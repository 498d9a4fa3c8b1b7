"""The port's C++ host fast path (minivectordb_tpu_torch/native): the port's
copy of tests/test_native.py, plus its build and its hooks.

The library is built here with g++ at first use. Each entry point is held
against the pure-Python path it stands in for (the library switched off),
on tests/test_native.py's inputs; the WAL bytes a native append writes are
those of the JAX package's pure-Python append (imported inside that test
only: the JAX package is the reference, nothing else here uses it).
"""

import os
import random
import subprocess
import sys
import zlib

import numpy as np
import pytest

from minivectordb_tpu_torch.core import wal
from minivectordb_tpu_torch.native import build, fastops
from minivectordb_tpu_torch.rerank import fuzzy, hashing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _library():
    status = fastops.available()
    assert status, status.detail  # g++ is present here
    return status


def _python_only(fn, *args):
    """fn with the native library switched off: the pure-Python path."""
    saved = fastops._LIB, fastops._STATUS
    fastops._LIB, fastops._STATUS = None, fastops.Status(False, "switched off by the test")
    try:
        return fn(*args)
    finally:
        fastops._LIB, fastops._STATUS = saved


def test_hash_ngrams_parity_with_python():
    texts = ["hello world", "wörld — ünïcode ngrams", "a", "", "xy " * 30, "MiXeD CaSe"]
    for t in texts:
        c_vec = fastops.hash_ngrams(t.lower(), 64, 1, 6)
        py_vec = np.zeros(64)
        for g in hashing._char_ngrams(t):
            h = hashing.murmur3_32(g.encode("utf-8"))
            s = h - 0x100000000 if h >= 0x80000000 else h
            py_vec[abs(s) % 64] += 1.0 if s >= 0 else -1.0
        np.testing.assert_array_equal(c_vec, py_vec)
        before = fastops.CALLS["hash_ngrams"]
        np.testing.assert_array_equal(hashing.hash_text_features(t),
                                      _python_only(hashing.hash_text_features, t))
        assert fastops.CALLS["hash_ngrams"] == before + 1


def test_partial_ratio_parity_with_python():
    random.seed(42)
    for _ in range(200):
        a = "".join(random.choices("abcdef ", k=random.randint(0, 25)))
        b = "".join(random.choices("abcdef ", k=random.randint(0, 60)))
        assert fastops.partial_ratio(a, b) == _python_only(fuzzy.partial_ratio, a, b), (a, b)


def test_partial_ratio_unicode_and_long_needles():
    assert fastops.partial_ratio("naïve", "a naïve approach") == 100
    assert fastops.partial_ratio("日本語", "これは日本語です") == 100
    rng = random.Random(7)
    for m in (63, 64, 65, 130):  # the bit-parallel LCS and the DP past 64
        a = "".join(rng.choices("abcdé ", k=m))
        b = "".join(rng.choices("abcdé ", k=m + 40))
        assert fastops.partial_ratio(a, b) == _python_only(fuzzy.partial_ratio, a, b), m


def test_hybrid_scores_equal_with_and_without_the_library():
    docs = ["the cat sat", "a dog ran", "naïve café", "", "cats and dogs"]
    for query in ("cat", "café dog", ""):
        assert hashing.text_hash_scores(query, docs) == _python_only(
            hashing.text_hash_scores, query, docs)
        assert fuzzy.fuzzy_ratios(query, docs) == _python_only(fuzzy.fuzzy_ratios, query, docs)


def test_crc32_is_zlibs():
    for data in (b"", b"hello", bytes(range(256)) * 17):
        assert fastops.crc32(data) == zlib.crc32(data) & 0xFFFFFFFF


@pytest.mark.parametrize("fsync", [False, True], ids=["append", "fsync"])
def test_wal_bytes_equal_jaxs_python_append(tmp_path, fsync):
    from minivectordb_tpu.core import wal as jax_wal
    from minivectordb_tpu.native import fastops as jax_fastops

    assert jax_fastops._load() is None  # the JAX package's library is not built: Python
    ops = [("add", [1, 2], np.arange(6, dtype=np.float32).reshape(2, 3), [{"k": "ü"}, {}]),
           ("del", [2]), ("add", [], np.zeros((0, 3), np.float32), [])]
    port, ref = str(tmp_path / "port.log"), str(tmp_path / "jax.log")
    before = fastops.CALLS["wal_append"]
    for op in ops:
        wal.append_record(port, op, fsync=fsync)
        jax_wal.append_record(ref, op, fsync=fsync)
    assert fastops.CALLS["wal_append"] == before + len(ops)
    with open(port, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    replayed = wal.read_records(port)
    assert [op[0] for op in replayed] == ["add", "del", "add"]
    np.testing.assert_array_equal(replayed[0][2], ops[0][2])
    assert jax_wal.read_records(port)[1] == ("del", [2])


def test_a_failing_native_append_reaches_the_caller(tmp_path):
    with pytest.raises(OSError, match="WAL append failed"):
        wal.append_record(str(tmp_path / "no_such_dir" / "wal.log"), ("del", [1]))


def test_the_library_is_built_once_into_the_build_directory(tmp_path):
    """Four processes build into a fresh directory at once: one library, no
    temporary file left; importing the hooked modules builds nothing. Each
    process waits until all four have imported (a marker file each) before
    its first use, so a slow import never sees another process's build."""
    out, ready = tmp_path / "build", tmp_path / "ready"
    out.mkdir()
    ready.mkdir()
    env = {**os.environ, "MINIVECTORDB_TORCH_BUILD_DIR": str(out)}
    code = ("import sys; sys.path.insert(0, {root!r})\n"
            "import os, time\n"
            "from minivectordb_tpu_torch.rerank import hybrid, hashing\n"
            "from minivectordb_tpu_torch.core import wal\n"
            "assert not os.listdir({out!r}), os.listdir({out!r})\n"
            "open(os.path.join({ready!r}, str(os.getpid())), 'w').close()\n"
            "t0 = time.time()\n"
            "while len(os.listdir({ready!r})) < 4 and time.time() - t0 < 200:\n"
            "    time.sleep(0.01)\n"
            "from minivectordb_tpu_torch.native import fastops\n"
            "v = hashing.hash_text_features('first use builds')\n"
            "assert fastops.available() and fastops.CALLS['hash_ngrams'] == 1\n"
            "print(fastops.available().detail)\n").format(
                root=ROOT, out=str(out), ready=str(ready))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for _ in range(4)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len(os.listdir(ready)) == 4
    paths = {o.strip().splitlines()[-1] for o in outs}
    assert len(paths) == 1 and os.path.dirname(paths.pop()) == str(out)
    (name,) = os.listdir(out)
    assert name.startswith("libfastops_") and name.endswith(".so")
    assert build.CXX_FLAGS[-1] == "-ffp-contract=off"


def test_without_a_compiler_the_python_paths_serve(tmp_path):
    env = {**os.environ, "MINIVECTORDB_TORCH_BUILD_DIR": str(tmp_path), "PATH": ""}
    code = ("import sys; sys.path.insert(0, {root!r})\n"
            "from minivectordb_tpu_torch.native import fastops\n"
            "from minivectordb_tpu_torch.rerank import fuzzy, hashing\n"
            "st = fastops.available()\n"
            "assert not st and 'no C++ compiler' in st.detail, st\n"
            "assert fastops.hash_ngrams('x', 64, 1, 6) is None\n"
            "print(repr(hashing.hash_text_features('naïve café').tolist()))\n"
            "print(fuzzy.partial_ratio('naïve', 'a naïve approach'))\n"
            "assert sum(fastops.CALLS.values()) == 0\n").format(root=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    vec_line, ratio_line = out.stdout.strip().splitlines()
    assert eval(vec_line) == hashing.hash_text_features("naïve café").tolist()
    assert int(ratio_line) == 100
    assert not os.listdir(tmp_path)
