"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
dry runs: the same drivers, generators and reference, the published
widths replaced by small ones (each model family's ``tiny`` and each
driver's)."""

from __future__ import annotations

import copy
import json
import os

from portbench import families, harness

BATCH = "cohere-1m-768.b256-k100"


def with_batch_cell(root: str) -> dict:
    """BENCHMARK.json with the batch search cell added, as the PR that
    brings it back would add it: its mix file, drivers and readers are
    already under portbench/ (the cell is out of BENCHMARK.json for its
    run-to-run spread, PERF.md section 7)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": BATCH, "config": "cohere-1m-768", "traffic": "b256-k100",
                               "chips": 1, "why": "async batches of 256, k = 100"})
    for m in bench["end_to_end"]:
        if "cohere-1m-768.serial-k100" in m.get("workloads", []):
            m["workloads"].append(BATCH)
    bench["per_layer"] += [
        {"name": n, "unit": u, "better": b, "source": "device_trace", "layer": n,
         "moves": "search_qps", "workloads": [BATCH]}
        for n, u, b in (("dispatch_ms.batch256", "ms", "lower"), ("fused_phase23_ms", "ms", "lower"),
                        ("k1_f32_roofline", "%", "higher"), ("device_idle_pct.search", "%", "lower"))]
    return bench


def tiny_cell(root: str, name: str) -> harness.Cell:
    """The cell with its model's widths cut by its family's ``tiny`` and its
    corpus and mix by its driver's, both found by name."""
    cell = harness.load_cell(root, name, with_batch_cell(root) if name == BATCH else None)
    cfg, mix = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if "model" in cfg:
        families.of(cfg["model"]).tiny(cfg["model"])
    harness.driver(mix["driver"]).tiny(cfg, mix)
    cell.config, cell.traffic = cfg, mix
    return cell


def dry_run(root: str, name: str, seed: int = 2 ** 40 + 17, seconds: float = 1.0):
    cell = tiny_cell(root, name)
    import time
    return harness.measure(root, cell, seed, seconds, False, "cpu", time.perf_counter())
