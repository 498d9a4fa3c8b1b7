"""Contrastive fine-tuning through ``models.train``: one step object,
driven in a closed loop.

Set-up draws the encoder's weights on the device from the seed, hands them
to ``init_training`` as the converted-checkpoint pytree with the mix's
learning rate, and builds the step with ``make_train_step`` (in-batch
InfoNCE, the port's AdamW). It tokenizes a pool of batches with the frozen
tokenizer, then drives that same step through its first ``warm_steps``
steps on the first batches of the pool, through the window's own call and
feed, and reads from the program, through its public converters: each
step's loss, the first gradient as the optimizer got it (AdamW's first
moment after one step, over 1 - beta1) and each leaf's change after the
warm steps. The window then runs one step after another, reading each
step's loss.

After the window the program is freed, the weights are made again from the
seed and the reference follows the same warm steps (``reference.train``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import families, hashtok, reference, traffic
from portbench.drivers import common
from portbench.drivers.embed import port_config

FEED = ("q_ids", "q_mask", "p_ids", "p_mask")


def norm64(a: np.ndarray) -> float:
    """Euclidean norm of a float32 array, summed in float64 a slice at a
    time."""
    flat = a.reshape(-1)
    total = 0.0
    for lo in range(0, flat.size, 1 << 22):
        part = flat[lo:lo + (1 << 22)].astype(np.float64)
        total += float(part @ part)
    return math.sqrt(total)


def run(run, tmp: str, t_start: float) -> None:
    from minivectordb_tpu_torch import convert
    from minivectordb_tpu_torch.models import train as port_train

    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    mc, warm = cfg["model"], int(mix["warm_steps"])
    fam = families.of(mc)
    run.mark("imports")
    w = traffic.make_weights(mc, run.seed, dev)
    start = {p: v.cpu().numpy() for p, v in w.items()}
    del w
    common.free(dev)
    run.mark("weights")
    pcfg = port_config(cfg)
    encoder, opt_state, optimizer = port_train.init_training(
        pcfg, fam.to_pytree(start), learning_rate=float(mix["learning_rate"]), device=dev)
    step = port_train.make_train_step(pcfg, optimizer, temperature=float(mix["temperature"]))
    tok = hashtok.HashTokenizer(int(mc["vocab_size"]))
    batches = traffic.train_pool(mix, tok.encode, run.seed)
    feed = [{k: b[k] for k in FEED} for b in batches]
    run.mark("model and batches")

    got = {"loss": [], "grad_norm": {}, "change_norm": {}}
    for s in range(warm):
        encoder, opt_state, m = step(encoder, opt_state, feed[s])
        got["loss"].append(float(m["loss"]))
        if s == 0:
            mu = fam.from_pytree(convert.adamw_state_to_numpy(opt_state, encoder)["mu"])
            scale = 1.0 - float(mix["betas"][0])
            got["grad_norm"] = {p: norm64(v) / scale for p, v in mu.items()}
            del mu
    run.mark("warm steps")
    after = fam.from_pytree(convert.encoder_to_numpy(encoder))
    got["change_norm"] = {p: norm64(after[p] - start[p]) for p in start}
    del after, start
    run.mark("change read")

    from portbench import trace
    steps = []
    j = warm
    pairs = int(mix["pairs"])
    with trace.profiled(run, cpu=True, ranges=("Optimizer.step",)):
        end = common.start_window(run, dev, t_start) + run.seconds
        while time.perf_counter() < end:
            b = batches[j % len(batches)]
            f = feed[j % len(batches)]
            j += 1
            run.attempted += pairs
            a = time.time_ns()
            ts = time.perf_counter()
            try:
                encoder, opt_state, m = step(encoder, opt_state, f)
                loss = float(m["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"step {j}: loss {loss}")
            except Exception as exc:
                run.fail(pairs, exc)
                continue
            finally:
                run.span("step", a, time.time_ns())
            common.done(run, ts, time.perf_counter(), pairs, sum(b["q_len"]) + sum(b["p_len"]))
            steps.append((b["q_len"], b["p_len"]))
    common.close_window(run, dev)
    run.facts.update(steps=steps, dtype="float32")
    del encoder, opt_state, optimizer, step, m
    common.free(dev)
    check(run, batches, got)


def gaps(got: dict, want: dict) -> dict:
    """The three numbers compared: the relative gap of the first step's
    loss (the later steps' losses move with the sign noise Adam gives the
    leaves left out below, and are reported, not compared); the largest gap between a leaf's first-gradient norm in the
    program and in the reference, over the larger of the reference's norm
    of that leaf and of the median leaf; and the same for each leaf's change
    over the warm steps, leaving out the leaves whose reference gradient is
    under a thousandth of the median leaf's (nought to rounding, as a key
    projection's bias is under softmax: Adam moves them by round-off
    alone)."""
    by_step = [abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])]
    g_med = float(np.median(list(want["grad_norm"].values())))
    grad = {p: abs(got["grad_norm"][p] - n) / max(n, g_med)
            for p, n in want["grad_norm"].items()}
    moved = [p for p, n in want["grad_norm"].items() if n >= 1e-3 * g_med]
    c_med = float(np.median([want["change_norm"][p] for p in moved]))
    change = {p: abs(got["change_norm"][p] - want["change_norm"][p])
              / max(want["change_norm"][p], c_med) for p in moved}
    return {"loss_gap": by_step[0], "loss_gap_by_step": by_step, "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "grad_gap_leaf": max(grad, key=grad.get), "change_gap_leaf": max(change, key=change.get),
            "left_out": sorted(set(want["grad_norm"]) - set(moved))}


def reference_run(config: dict, mix: dict, batches: list, seed: int, device,
                  tf32: bool = False) -> dict:
    """The reference's warm steps from the seed's weights."""
    w = traffic.make_weights(config["model"], seed, device)
    feed = [{k: torch.as_tensor(b[k], dtype=torch.int64, device=device) for k in FEED}
            for b in batches[:int(mix["warm_steps"])]]
    out = reference.train(w, feed, config["model"], mix, int(mix["warm_steps"]), tf32=tf32)
    del w, feed
    common.free(device)
    return out


def check(run, batches: list, got: dict) -> None:
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    want = reference_run(cfg, mix, batches, run.seed, dev)
    g = gaps(got, want)
    run.notes.update({k: g[k] for k in ("loss_gap_by_step", "grad_gap_leaf", "change_gap_leaf",
                                        "left_out")})
    lim = mix["limits"]
    run.checks = {k: (g[k], float(lim[k])) for k in ("loss_gap", "grad_gap", "change_gap")}


def control_answers(mix: dict) -> int:
    """A training control compares the warm steps, not answers."""
    return 0


def control(run, answers: int) -> dict:
    """The reference's warm steps computed in TF32 in the program's place,
    and the fault "half of the batch left out, the mean taken over the
    rest" planted in the reference, each held to the run's limits."""
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    tok = hashtok.HashTokenizer(int(cfg["model"]["vocab_size"]))
    batches = traffic.train_pool(mix, tok.encode, run.seed)
    want = reference_run(cfg, mix, batches, run.seed, dev)
    control = reference_run(cfg, mix, batches, run.seed, dev, tf32=True)
    half = [{k: (v[:len(v) // 2] if k in FEED else v) for k, v in b.items()}
            for b in batches]
    fault = reference_run(cfg, mix, half, run.seed, dev)
    lim = mix["limits"]
    out = {}
    for name, got in (("control", control), ("half_batch", fault)):
        g = gaps(got, want)
        out[name] = {k: {"value": g[k], "limit": float(lim[k])}
                     for k in ("loss_gap", "grad_gap", "change_gap")}
        out[name]["leaves"] = [g["grad_gap_leaf"], g["change_gap_leaf"]]
        out[name]["loss_gap_by_step"] = g["loss_gap_by_step"]
    run.checks = {k: (v["value"], v["limit"]) for k, v in out["control"].items()
                  if k in ("loss_gap", "grad_gap", "change_gap")}
    return out


def tiny(config: dict, mix: dict) -> None:
    """The mix cut, in place, to a size the CPU runs in seconds."""
    mix.update(pairs=4, pool_batches=5, query={"min": 4, "max": 12, "seq": 16},
               passage={"full_share": 0.75, "tail_min": 8, "tail_max": 60, "max_tokens": 64,
                        "seq": 64})
