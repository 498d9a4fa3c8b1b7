"""One run of one cell: find its files by name, run its driver, read its
metrics, decide ``correct`` and print the result line.

What belongs to one configuration, model family, traffic mix, driver or
metric sits in files of its own, found by the names in ``BENCHMARK.json``:

- ``configs[].file``: the configuration (sizes and guarantees); an encoder's
  ``model["model_type"]``, ``-`` changed to ``_``, names its model family
  ``portbench/families/<model_type>.py``: its leaves and their layout, the
  plain reference's forward, its FLOPs and attention launches, and its cut
  for the CPU (``portbench/families/__init__.py`` lists them);
- ``portbench/mixes/<traffic>.json``: the traffic mix, which names the
  driver and the limits of the comparison that decides ``correct``;
- ``portbench/drivers/<driver>.py``: the loop that serves the mix, with
  ``run(run, tmp, t_start)``, ``check``, its control ``control(run,
  answers)`` and ``control_answers(mix)`` (``portbench/control.py``) and
  ``tiny(config, mix)``, its cut for the CPU;
- ``portbench/metrics/<metric>.py``: a reader ``read(run) -> float | None``
  for each metric, end to end or per layer;
- ``portbench/tests/faults/<driver>.py``: the faults the CPU dry runs plant
  under the driver's timed path.

A later cell adds a mix file and entries in ``BENCHMARK.json``; a later
model configuration adds its configuration file and, where its architecture
is new, a family file, and where its loop is new, a driver file and a fault
file; a later metric adds a reader file. None edits a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

# top-level module names that must not be loaded in the process that prints
# the result: JAX, and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "minivectordb_tpu")

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with everything it names, loaded."""
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list


@dataclasses.dataclass
class Run:
    """What one run measured and kept, for the metric readers and the
    checks. Times on the host clock are ``time.perf_counter`` seconds;
    spans are (name, start_ns, end_ns) on ``time.time_ns``, the clock the
    profiler's trace uses."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    setup_s: float = 0.0
    attempted: int = 0           # items (queries, texts, pairs) the window asked for
    failed: int = 0              # of those, items whose call raised
    items_done: int = 0          # items of the calls the window completed
    tokens_done: int = 0         # real tokens of those
    window_t0: float = 0.0       # the window's start on time.perf_counter
    window_s: float = 0.0        # from the window's start to its last call's completion
    latencies_s: list = dataclasses.field(default_factory=list)  # per call completed in the window
    spans: list = dataclasses.field(default_factory=list)
    facts: dict = dataclasses.field(default_factory=dict)        # shapes the readers need
    profile: object = None       # trace.Profile of the window, with --trace 1
    checks: dict = dataclasses.field(default_factory=dict)       # name -> (value, limit)
    memory_peak_bytes: int = 0
    window_start_ns: int = 0
    errors: list = dataclasses.field(default_factory=list)
    marks: list = dataclasses.field(default_factory=list)  # (set-up step, perf_counter at its end)
    notes: dict = dataclasses.field(default_factory=dict)  # what the check looked at

    def mark(self, step: str) -> None:
        self.marks.append((step, time.perf_counter()))

    def span(self, name: str, start_ns: int, end_ns: int) -> None:
        self.spans.append((name, start_ns, end_ns))

    def fail(self, items: int, exc: BaseException) -> None:
        self.failed += items
        if len(self.errors) < 5:
            self.errors.append(f"{type(exc).__name__}: {exc}")


def read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(root: str, name: str, bench: dict | None = None) -> Cell:
    """The workload ``name`` of ``root``/BENCHMARK.json (or of ``bench``,
    its contents) with its configuration, its traffic mix and the metrics
    it reports."""
    bench = bench or read_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = read_json(os.path.join(root, "portbench", "mixes", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in e2e_names else [])]
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer)


def reader(root: str, metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    """The module ``portbench/drivers/<name>.py``."""
    return importlib.import_module(f"portbench.drivers.{name}")


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def power_limit() -> str:
    """nvidia-smi's "name, power.limit" of the first card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read: {exc}"


def measure(root: str, cell: Cell, seed: int, seconds: float, trace: bool,
            device: str, t_start: float) -> Run:
    """Drive one run of ``cell``: the driver sets up, measures for
    ``seconds`` and checks its outputs against the reference. ``t_start``
    is the process's start on ``time.perf_counter``."""
    run = Run(cell, seed, seconds, trace, device)
    tmp = tempfile.mkdtemp(prefix="portbench-")  # under the run's TMPDIR
    try:
        driver(cell.traffic["driver"]).run(run, tmp, t_start)
        run.mark("check")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return run


def metrics_of(root: str, run: Run) -> dict:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (trace
    on), each read by its own reader; a reader with nothing to read is left
    out."""
    out = {}
    for m in (run.cell.per_layer if run.trace else run.cell.end_to_end):
        value = reader(root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def is_correct(run: Run) -> bool:
    return (bool(run.checks) and run.failed == 0
            and all(v <= lim for v, lim in run.checks.values()))


def result_line(root: str, run: Run, power: str) -> dict:
    dev = {"platform": "gpu" if run.device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if run.device != "cpu" else "cpu",
           "count": run.cell.chips,
           "memory_peak_bytes": int(run.memory_peak_bytes),
           "power": power}
    line = {"correct": is_correct(run), "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics_of(root, run), "device": dev}
    if run.trace and run.profile is not None:
        dev["busy_s"] = run.profile.busy_s
        dev["window_s"] = run.profile.window_s
        line["breakdown"] = run.profile.breakdown()
    if run.errors:
        line["errors"] = run.errors
    if run.notes:
        line["notes"] = run.notes
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return line


def main(args, t_start: float) -> int:
    root = os.path.dirname(HERE)
    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    power = power_limit()
    run = measure(root, cell, args.seed, float(args.seconds), bool(args.trace), "cuda", t_start)
    line = result_line(root, run, power)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    steps, last = [], t_start
    for step, t in run.marks:
        steps.append(f"{step} {t - last:.2f}")
        last = t
    print("steps (s): " + ", ".join(steps), file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

