"""HF checkpoint -> encoder parameters, and the converted-artifact format.

Counterpart of ``minivectordb_tpu/models/convert.py``. Parameters travel as
the JAX package's pytree of numpy arrays: ``word_emb``, ``pos_emb``,
``type_emb``, ``emb_ln`` {g, b} and ``layers`` [{q, k, v, attn_out, ffn_in,
ffn_out: {w, b}; attn_ln, ffn_ln: {g, b}}], with dense weights (in, out) for
``x @ w``. That is also what an artifact directory holds (``params.npz`` with
the flattened names + ``config.json``), so a directory written by either
package loads in the other. ``convert.encoder_from_numpy`` turns the pytree
into a loaded ``Encoder`` (transposing the dense weights once), and
``convert.encoder_to_numpy`` goes back.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from minivectordb_tpu_torch.models.encoder import EncoderConfig


def config_from_hf(hf_config) -> EncoderConfig:
    return EncoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden=hf_config.hidden_size,
        layers=hf_config.num_hidden_layers,
        heads=hf_config.num_attention_heads,
        intermediate=hf_config.intermediate_size,
        max_positions=hf_config.max_position_embeddings,
        pad_id=getattr(hf_config, "pad_token_id", 1) or 1,
        layer_norm_eps=hf_config.layer_norm_eps,
    )


def params_from_state_dict(sd: dict, cfg: EncoderConfig) -> dict:
    """Map an XLMRobertaModel/BertModel-style state dict to the pytree.

    torch Linear stores (out, in); the pytree's dense is x @ w, so weights
    transpose (as views: nothing is copied here).
    """
    def t(name):
        w = sd[name]
        arr = w.detach().cpu().numpy() if hasattr(w, "detach") else np.asarray(w)
        return np.asarray(arr, dtype=np.float32)

    def dense(prefix):
        return {"w": t(f"{prefix}.weight").T, "b": t(f"{prefix}.bias")}

    def ln(prefix):
        return {"g": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    prefix = ""
    if any(k.startswith("roberta.") for k in sd):
        prefix = "roberta."

    params = {
        "word_emb": t(f"{prefix}embeddings.word_embeddings.weight"),
        "pos_emb": t(f"{prefix}embeddings.position_embeddings.weight"),
        "type_emb": t(f"{prefix}embeddings.token_type_embeddings.weight"),
        "emb_ln": ln(f"{prefix}embeddings.LayerNorm"),
        "layers": [],
    }
    for i in range(cfg.layers):
        lp = f"{prefix}encoder.layer.{i}"
        params["layers"].append(
            {
                "q": dense(f"{lp}.attention.self.query"),
                "k": dense(f"{lp}.attention.self.key"),
                "v": dense(f"{lp}.attention.self.value"),
                "attn_out": dense(f"{lp}.attention.output.dense"),
                "attn_ln": ln(f"{lp}.attention.output.LayerNorm"),
                "ffn_in": dense(f"{lp}.intermediate.dense"),
                "ffn_out": dense(f"{lp}.output.dense"),
                "ffn_ln": ln(f"{lp}.output.LayerNorm"),
            }
        )
    return params


def load_pretrained(name_or_path: str):
    """Load a converted artifact directory (``params.npz`` + ``config.json``)
    or an HF checkpoint (cache/local only — no network) and convert.

    Returns (params, cfg) or raises if unavailable.
    """
    if os.path.isdir(name_or_path) and os.path.exists(
        os.path.join(name_or_path, "params.npz")
    ):
        return load_converted(name_or_path)
    from transformers import AutoConfig, AutoModel

    hf_cfg = AutoConfig.from_pretrained(name_or_path, local_files_only=True)
    model = AutoModel.from_pretrained(name_or_path, local_files_only=True)
    cfg = config_from_hf(hf_cfg)
    params = params_from_state_dict(model.state_dict(), cfg)
    return params, cfg


# -- converted-artifact format (params.npz + config.json) --------------------
#
# Pretrained transformer weights are too large to vendor in a wheel, so they
# live in a self-contained directory that MINIVECTORDB_TORCH_WEIGHTS points at.


def _flatten_params(params: dict) -> dict:
    flat = {}
    for k, v in params.items():
        if k == "layers":
            for i, layer in enumerate(v):
                for lk, lv in layer.items():
                    for pk, pv in lv.items():
                        flat[f"layers.{i}.{lk}.{pk}"] = pv
        elif isinstance(v, dict):
            for pk, pv in v.items():
                flat[f"{k}.{pk}"] = pv
        else:
            flat[k] = v
    return flat


def _unflatten_params(flat: dict, n_layers: int) -> dict:
    params: dict = {"layers": [dict() for _ in range(n_layers)]}
    for k, v in flat.items():
        parts = k.split(".")
        if parts[0] == "layers":
            i, lk, pk = int(parts[1]), parts[2], parts[3]
            params["layers"][i].setdefault(lk, {})[pk] = v
        elif len(parts) == 2:
            params.setdefault(parts[0], {})[parts[1]] = v
        else:
            params[k] = v
    return params


def save_converted(params: dict, cfg: EncoderConfig, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "params.npz"), **_flatten_params(params))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_converted(artifact_dir: str):
    with open(os.path.join(artifact_dir, "config.json")) as f:
        cfg = EncoderConfig(**json.load(f))
    with np.load(os.path.join(artifact_dir, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_params(flat, cfg.layers), cfg
