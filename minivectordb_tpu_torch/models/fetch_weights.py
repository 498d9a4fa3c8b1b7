"""Fetch + convert pretrained encoder weights into the runtime artifact.

Counterpart of ``minivectordb_tpu/models/fetch_weights.py``: the same
functions, flags and output. Pretrained transformer weights are too large to
vendor in a wheel, so they are fetched once and converted into a
self-contained directory:

    python -m minivectordb_tpu_torch.models.fetch_weights --model small --out ./weights
    python -m minivectordb_tpu_torch.models.fetch_weights --all --out ./weights
    export MINIVECTORDB_TORCH_WEIGHTS=./weights

Each model lands in <out>/<kind>/ as params.npz + config.json + the HF
tokenizer files; EmbeddingModel then loads it with no transformers
involvement at inference time (models/convert.py:load_converted). The
directory is the JAX package's artifact format, so either package serves
what either fetched. Offline machines can run the fetch anywhere with
network access and copy the directory across. ``--from-hf-cache`` converts
from an already-populated local HF cache without touching the network.

It runs on the host only: the checkpoint is read by transformers on the
CPU and written as numpy arrays; no model runs and no device is touched.
"""

from __future__ import annotations

import argparse
import os
import sys

from minivectordb_tpu_torch.models import configs as model_configs

_KINDS = ("small", "large", "bgem3")


def fetch_one(kind: str, out_dir: str, local_only: bool = False) -> str:
    from transformers import AutoConfig, AutoModel, AutoTokenizer

    from minivectordb_tpu_torch.models.convert import (
        config_from_hf,
        params_from_state_dict,
        save_converted,
    )

    hf_name = model_configs.HF_MODEL_NAMES[kind]
    dest = os.path.join(out_dir, kind)
    print(f"[fetch_weights] {kind}: {hf_name} -> {dest}", flush=True)
    hf_cfg = AutoConfig.from_pretrained(hf_name, local_files_only=local_only)
    model = AutoModel.from_pretrained(hf_name, local_files_only=local_only)
    cfg = config_from_hf(hf_cfg)
    params = params_from_state_dict(model.state_dict(), cfg)
    save_converted(params, cfg, dest)
    tok = AutoTokenizer.from_pretrained(hf_name, local_files_only=local_only)
    tok.save_pretrained(dest)
    print(f"[fetch_weights] wrote {dest} "
          f"({cfg.layers} layers, hidden {cfg.hidden})", flush=True)
    return dest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=_KINDS, help="which encoder slot")
    ap.add_argument("--all", action="store_true", help="fetch every slot")
    ap.add_argument("--out", default="./weights", help="artifact directory")
    ap.add_argument(
        "--from-hf-cache",
        action="store_true",
        help="convert from the local HF cache only (no network)",
    )
    args = ap.parse_args(argv)
    kinds = _KINDS if args.all else ([args.model] if args.model else [])
    if not kinds:
        ap.error("pass --model or --all")
    for kind in kinds:
        fetch_one(kind, args.out, local_only=args.from_hf_cache)
    print(
        f"[fetch_weights] done. export MINIVECTORDB_TORCH_WEIGHTS="
        f"{os.path.abspath(args.out)}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
