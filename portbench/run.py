#!/usr/bin/env python3
"""One run of one cell of the benchmark of minivectordb_tpu_torch.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``workloads`` in
BENCHMARK.json; its configuration, traffic mix and metrics are files under
portbench/ found by name. Needs as many CUDA devices as the cell asks for:
without them it exits with code 2 and prints no result. The last line of
standard output is the result (a JSON object); the last lines of standard
error give each number compared beside its limit.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def environment() -> None:
    """Fixed build and kernel-cache directories inside the checkout, so only
    a checkout's first run builds; transformers, which the port's tokenizer
    loader imports where it is installed, kept from loading JAX or
    TensorFlow and from the network."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["MINIVECTORDB_TORCH_BUILD_DIR"] = os.path.join(cache, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    for key, value in (("USE_JAX", "0"), ("USE_FLAX", "0"), ("USE_TF", "0"),
                       ("USE_TORCH", "1"), ("HF_HUB_OFFLINE", "1"),
                       ("TRANSFORMERS_OFFLINE", "1")):
        os.environ[key] = value


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    environment()
    # the checkout's root, not portbench/, leads the path: portbench's module
    # names must not shadow the standard library's
    sys.path[0] = ROOT
    from portbench import harness
    sys.exit(harness.main(args, T_START))
