#!/usr/bin/env python3
"""The controls of the comparison that decides ``correct``, read on the
card at a cell's own size. The benchmark's runs never run this.

    python3 portbench/control.py --workload <name> --seeds 11 12 13 [--answers N]

For each seed it makes the cell's inputs as a run does, puts the reference
computed in TF32 (the nearest precision below the float32 the
configurations state) in the program's place, and prints the numbers the
cell compares, each beside its limit, as one JSON line. For a training cell
it also reads the fault "half of the batch left out, the mean taken over
the rest", planted in the reference put in the program's place. A state
left unchanged reads 1 on ``change_gap`` by its definition and needs no run.
Each driver brings its own control: ``control`` and ``control_answers`` in
``portbench/drivers/<driver>.py``, found by the mix's ``driver``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def control_of(cell):
    """(control, its default number of answers) of the cell's driver:
    ``control(run, answers)`` and ``control_answers(mix)`` of
    ``portbench/drivers/<driver>.py``, found by the mix's ``driver``."""
    from portbench import harness
    drv = harness.driver(cell.traffic["driver"])
    return drv.control, drv.control_answers(cell.traffic)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--answers", type=int, default=None,
                    help="answers compared a seed (default: about as many as a run compares)")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    from portbench import harness
    cell = harness.load_cell(root, args.workload)
    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    fn, default = control_of(cell)
    answers = args.answers or default
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, 0.0, False, "cuda")
        extra = fn(run, answers)
        line = {"workload": cell.name, "seed": seed, "control": "tf32",
                "correct": harness.is_correct(run), "seconds": time.perf_counter() - t0,
                "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}}
        line.update(extra)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
