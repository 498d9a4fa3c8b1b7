"""Training on a (dp, tp) mesh across real processes over gloo
(parallel/tensor_parallel.py's torch.distributed backend), against the
in-process emulation of the same mesh, in the style of
tests/test_torch_multihost.py.

Each child joins a process group with ``init_pod`` (gloo, a TCP store on
localhost), builds ``train_mesh(tp=..., pod=True)`` over the group (one position a
process), and runs ``train_loop(mesh=)`` one step at a time, three times,
each call resuming the previous one's params and AdamW state and writing a
checkpoint (the gather is collective; process 0 writes). Every step's loss
and accuracy, and every checkpoint's params and moments, must EQUAL the
in-process mesh's bit for bit: each group has at most two members, and a
float32 sum of two operands is the same in either order.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_train import _corpus_setup, _leaves, _tiny_setup

from minivectordb_tpu_torch.models import checkpoint as tck
from minivectordb_tpu_torch.models import train as ttrain
from minivectordb_tpu_torch.models.encoder import EncoderConfig
from minivectordb_tpu_torch.parallel.mesh import train_mesh

LR = 1e-3
STEPS = 3

_CHILD = r"""
import pickle, sys
sys.path.insert(0, {repo!r})
pid, n_proc, addr, tp, data = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]), sys.argv[5]
import torch.distributed as dist
from minivectordb_tpu_torch.models import train as ttrain
from minivectordb_tpu_torch.models.encoder import EncoderConfig
from minivectordb_tpu_torch.parallel.mesh import init_pod, train_mesh

init_pod(addr, num_processes=n_proc, process_id=pid, device="cpu")
assert dist.get_backend() == "gloo"
with open(data, "rb") as f:
    kw, params, batches = pickle.load(f)
mesh = train_mesh(tp=tp, device="cpu", pod=True)
assert mesh.distributed and mesh.process_index == pid
assert mesh.devices.size == n_proc and mesh.devices.shape[1] == tp, mesh.devices.shape
assert [pos for pos, _d in mesh.local_shards()] == [pid]
cfg = EncoderConfig(**kw)
hist, opt = [], None
for step, batch in enumerate(batches):
    params, opt, h = ttrain.train_loop(
        cfg, params, iter([batch]), 1, mesh=mesh, learning_rate={lr!r}, start_step=step,
        opt_state=opt, checkpoint_path=data + f".ck{{step}}", log_every=1,
        log_fn=lambda _s: None)
    assert sorted(params.pieces) == [pid]
    hist += h
if pid == 0:
    with open(data + ".hist", "wb") as f:
        pickle.dump(hist, f)
dist.destroy_process_group()
print(f"proc{{pid}} OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _run(tmp_path, n_proc: int, tp: int, setup):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    kw, params, batches = setup()
    data = str(tmp_path / "data.pkl")
    with open(data, "wb") as f:
        pickle.dump((kw, params, batches[:STEPS]), f)
    script = tmp_path / "train_child.py"
    script.write_text(_CHILD.format(repo=repo, lr=LR))
    addr = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(n_proc), addr, str(tp), data],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path),
            env=env,
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
            pytest.fail("train child timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out[-3000:]}"
        assert f"proc{pid} OK" in out

    # the same steps on the in-process emulation of the mesh, with the
    # children's one thread (a CPU matmul's sums follow its thread count)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _in_process(tmp_path, data, n_proc, tp, kw, params, batches)
    finally:
        torch.set_num_threads(threads)


def _in_process(tmp_path, data, n_proc, tp, kw, params, batches):
    mesh = train_mesh(n_proc, tp=tp, device="cpu")
    assert mesh.devices.shape == (n_proc // tp, tp)
    cfg = EncoderConfig(**kw)
    menc, mo, mopt = ttrain.init_training(cfg, params, mesh=mesh, learning_rate=LR)
    step = ttrain.make_train_step(cfg, mopt, mesh=mesh)
    with open(data + ".hist", "rb") as f:
        hist = pickle.load(f)
    assert [h["step"] for h in hist] == list(range(STEPS))
    for i, batch in enumerate(batches[:STEPS]):
        menc, mo, metrics = step(menc, mo, batch)
        assert hist[i]["loss"] == float(metrics["loss"]), i
        assert hist[i]["accuracy"] == float(metrics["accuracy"]), i
        got_p, got_o, got_step, _e = tck.load_checkpoint(data + f".ck{i}")
        assert got_step == i + 1
        ck = str(tmp_path / f"inproc{i}.pkl")
        tck.save_checkpoint(ck, menc, mo, i + 1)
        want_p, want_o, _s, _e = tck.load_checkpoint(ck)
        for got, want in ((got_p, want_p), (got_o["mu"], want_o["mu"]),
                          (got_o["nu"], want_o["nu"])):
            g = dict(_leaves(got))
            for name, w in _leaves(want):
                np.testing.assert_array_equal(g[name], w, err_msg=f"step {i}: {name}")
        assert int(got_o["count"]) == int(want_o["count"]) == i + 1


@pytest.mark.timeout(300)
@pytest.mark.parametrize("n_proc, tp", [(2, 2), (2, 1)], ids=["1x2", "2x1"])
def test_two_process_mesh_equals_the_in_process_mesh(tmp_path, n_proc, tp):
    _run(tmp_path, n_proc, tp, _tiny_setup)


@pytest.mark.timeout(300)
def test_four_process_mesh_equals_the_in_process_mesh(tmp_path):
    """A (2, 2) mesh: two tp groups and two dp groups, soft labels."""
    _run(tmp_path, 4, 2, _corpus_setup)

