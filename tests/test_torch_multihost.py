"""Pod search of the port (parallel/multihost.py) across real processes over
gloo, as tests/test_multihost.py runs the JAX package's.

Two processes each hold a 4-shard CPU mesh row: both join a process group
with ``init_pod`` (gloo, a TCP store on localhost), build a (2, 4) pod mesh
from the group, contribute disjoint halves of the corpus with
``PodScanIndex.load_local`` (a process's rows never leave it), and run the
hierarchical search; every process must report the numpy oracle's ids.
Then the same with a one-process group through a ``file://`` store (what
chip_smoke.py does over NCCL on the card), and the block-placement checks of
tests/test_review_fixes.py:115 in this process."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from minivectordb_tpu_torch.parallel.mesh import pod_mesh, search_mesh
from minivectordb_tpu_torch.parallel.multihost import PodScanIndex

_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, {repo!r})

pid, n_proc, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import torch.distributed as dist
from minivectordb_tpu_torch.parallel.multihost import init_pod, pod_mesh, PodScanIndex

init_pod(addr, num_processes=n_proc, process_id=pid, device="cpu")
init_pod(addr, num_processes=n_proc, process_id=pid, device="cpu")  # idempotent
assert dist.get_world_size() == n_proc and dist.get_backend() == "gloo"

mesh = pod_mesh(chips_per_host=4, device="cpu")
assert mesh.devices.shape == (n_proc, 4), mesh.devices.shape
assert mesh.axis_names == ("dcn", "ici") and mesh.process_index == pid
assert [s for s, _ in mesh.local_shards()] == list(range(4 * pid, 4 * pid + 4))

n, d, k = 1000, 32, 8
rng = np.random.default_rng(0)
mat = rng.standard_normal((n, d)).astype(np.float32)

idx = PodScanIndex(mesh, d)
per_host = 1024 // n_proc
lo, hi = pid * per_host, min(n, (pid + 1) * per_host)
try:
    idx.load_local(mat[lo:hi], lo + 1, n)
    raise SystemExit("a wrong offset was accepted")
except ValueError as e:
    assert "process_index" in str(e)
idx.load_local(mat[lo:hi], lo, n)
assert idx.capacity == 1024 and idx.count == n

q = mat[:4] + 0.01
vals, gids = idx.search(q, k)

qn = q / np.linalg.norm(q, axis=1, keepdims=True)
scores = (qn @ mat.T) / np.linalg.norm(mat, axis=1)
oracle = np.argsort(-scores, axis=1)[:, :k]
assert (gids == oracle).all(), (gids, oracle)
np.testing.assert_allclose(vals, np.take_along_axis(scores, oracle, 1), atol=1e-5)
dist.destroy_process_group()
print(f"proc{{pid}} OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _run(tmp_path, n_proc: int, addr: str):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "pod_child.py"
    script.write_text(_CHILD.format(repo=repo))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(n_proc), addr],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(tmp_path),
        )
        for pid in range(n_proc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("pod child timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out[-3000:]}"
        assert f"proc{pid} OK" in out


@pytest.mark.timeout(300)
def test_two_process_pod_search_matches_oracle(tmp_path):
    _run(tmp_path, 2, f"127.0.0.1:{_free_port()}")


@pytest.mark.timeout(300)
def test_one_process_pod_over_a_file_store(tmp_path):
    _run(tmp_path, 1, "file://" + str(tmp_path / "store"))


def test_pod_load_local_rejects_wrong_offset_and_short_block():
    mesh = pod_mesh(2, 2, device="cpu")
    idx = PodScanIndex(mesh, 8)
    rng = np.random.default_rng(1)
    # one process holds the whole emulated pod: its block starts at row 0
    with pytest.raises(ValueError, match="process_index"):
        idx.load_local(rng.standard_normal((512, 8)), 512, 1024)
    # a short block below global_count would leave phantom zero rows
    with pytest.raises(ValueError, match="dense share"):
        idx.load_local(rng.standard_normal((100, 8)), 0, 2000)
    with pytest.raises(ValueError, match="pod mesh"):
        PodScanIndex(search_mesh(4, device="cpu"), 8)


def test_emulated_pod_search_matches_oracle():
    """One process holding a (2, 4) pod: load_local takes the whole corpus,
    and the hierarchical merge gives the oracle's ids."""
    mesh = pod_mesh(2, 4, device="cpu")
    rng = np.random.default_rng(2)
    n, d, k = 1500, 16, 6
    mat = rng.standard_normal((n, d)).astype(np.float32)
    idx = PodScanIndex(mesh, d)
    idx.load_local(mat, 0, n)
    q = rng.standard_normal((5, d)).astype(np.float32)
    vals, gids = idx.search(q, k)
    s = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
        mat / np.linalg.norm(mat, axis=1, keepdims=True)).T
    assert (gids == np.argsort(-s, axis=1)[:, :k]).all()
