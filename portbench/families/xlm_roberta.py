"""XLM-RoBERTa's encoder (``model_type`` "xlm-roberta"): post-LN layers of
full attention and a GELU MLP, absolute positions counted from the pad id,
mean pooling. multilingual-e5-large is one. See ``portbench/families``
for what each function gives."""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from portbench import counts
from portbench.reference import layer_norm, mean_pool


def weight_shapes(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(path, shape, kind) of every leaf of an XLM-R encoder in the
    converted-checkpoint layout (dense weights (in, out) for x @ w + b).
    kind: "emb", "dense", "bias", "gain" or "shift"."""
    h, inter = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
    out = [("word_emb", (int(cfg["vocab_size"]), h), "emb"),
           ("pos_emb", (int(cfg["max_position_embeddings"]), h), "emb"),
           ("type_emb", (int(cfg["type_vocab_size"]), h), "emb"),
           ("emb_ln.g", (h,), "gain"), ("emb_ln.b", (h,), "shift")]
    dense = {"q": (h, h), "k": (h, h), "v": (h, h), "attn_out": (h, h),
             "ffn_in": (h, inter), "ffn_out": (inter, h)}
    for i in range(int(cfg["num_hidden_layers"])):
        for name, shape in dense.items():
            out.append((f"layers.{i}.{name}.w", shape, "dense"))
            out.append((f"layers.{i}.{name}.b", (shape[1],), "bias"))
            if name == "attn_out":
                out += [(f"layers.{i}.attn_ln.g", (h,), "gain"),
                        (f"layers.{i}.attn_ln.b", (h,), "shift")]
        out += [(f"layers.{i}.ffn_ln.g", (h,), "gain"),
                (f"layers.{i}.ffn_ln.b", (h,), "shift")]
    return out


def to_pytree(flat: dict) -> dict:
    """{path: array} -> the converted-checkpoint pytree: word_emb, pos_emb,
    type_emb, emb_ln {g, b}, layers [{q, k, v, attn_out, ffn_in, ffn_out:
    {w, b}; attn_ln, ffn_ln: {g, b}}]."""
    tree: dict = {"layers": []}
    for path, leaf in flat.items():
        parts = path.split(".")
        if parts[0] == "layers":
            i = int(parts[1])
            while len(tree["layers"]) <= i:
                tree["layers"].append({})
            tree["layers"][i].setdefault(parts[2], {})[parts[3]] = leaf
        elif len(parts) == 2:
            tree.setdefault(parts[0], {})[parts[1]] = leaf
        else:
            tree[path] = leaf
    return tree


def from_pytree(tree: dict) -> dict:
    """The inverse of ``to_pytree``."""
    flat = {}
    for key, val in tree.items():
        if key == "layers":
            for i, layer in enumerate(val):
                for name, leaves in layer.items():
                    for leaf, arr in leaves.items():
                        flat[f"layers.{i}.{name}.{leaf}"] = arr
        elif isinstance(val, dict):
            for leaf, arr in val.items():
                flat[f"{key}.{leaf}"] = arr
        else:
            flat[key] = val
    return flat


def encode(w: dict, ids: torch.Tensor, mask: torch.Tensor, cfg: dict) -> torch.Tensor:
    """XLM-RoBERTa's post-LN encoder: last hidden states (B, S, H) of token
    ``ids`` under ``mask`` (1 real, 0 pad). Position ids count real tokens
    from pad_id + 1 and give pads pad_id; attention scores every query
    against the real keys only; GELU is the erf form."""
    heads, eps = int(cfg["num_attention_heads"]), float(cfg["layer_norm_eps"])
    pad = int(cfg["pad_token_id"])
    b, s = ids.shape
    m = mask.to(torch.int64)
    pos = torch.cumsum(m, dim=1) * m + pad
    x = w["word_emb"][ids.to(torch.int64)] + w["pos_emb"][pos] + w["type_emb"][0]
    x = layer_norm(x, w["emb_ln.g"], w["emb_ln.b"], eps)
    hd = x.shape[-1] // heads
    keep = mask.to(torch.bool)[:, None, None, :]
    for i in range(int(cfg["num_hidden_layers"])):
        p = f"layers.{i}."

        def dense(t, name):
            return t @ w[p + name + ".w"] + w[p + name + ".b"]

        def split(t):
            return t.view(b, s, heads, hd).transpose(1, 2)

        q, k, v = split(dense(x, "q")), split(dense(x, "k")), split(dense(x, "v"))
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        logits = logits.masked_fill(~keep, -math.inf)
        ctx = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, s, -1)
        x = layer_norm(x + dense(ctx, "attn_out"), w[p + "attn_ln.g"], w[p + "attn_ln.b"], eps)
        ff = dense(F.gelu(dense(x, "ffn_in")), "ffn_out")
        x = layer_norm(x + ff, w[p + "ffn_ln.g"], w[p + "ffn_ln.b"], eps)
    return x


def embed(w: dict, ids: torch.Tensor, mask: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Unit embeddings (B, H) of a batch of token ids. Each sequence is cut
    to the longest real length in the batch first: pads change nothing."""
    s = int(mask.sum(dim=1).max())
    return mean_pool(encode(w, ids[:, :s], mask[:, :s], cfg), mask[:, :s])


def forward_flops(cfg: dict, lengths: list[int]) -> float:
    """Every layer's dense products and full attention over the real
    tokens (``counts.encoder_forward_flops``)."""
    return counts.encoder_forward_flops(list(lengths), int(cfg["hidden_size"]),
                                        int(cfg["intermediate_size"]),
                                        int(cfg["num_hidden_layers"]))


def _all_pairs(n: int) -> int:
    return n * n


def attention(cfg: dict) -> dict:
    """Every layer launches the full-attention kernels (K6, and K7 / K8 in
    training) over all real pairs of each sequence."""
    heads = int(cfg["num_attention_heads"])
    return {"full": {"layers": int(cfg["num_hidden_layers"]), "heads": heads,
                     "head_dim": int(cfg["hidden_size"]) // heads, "pairs": _all_pairs}}


def tiny(cfg: dict) -> None:
    cfg.update(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128)
