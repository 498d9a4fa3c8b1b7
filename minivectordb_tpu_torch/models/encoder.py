"""Transformer encoder (XLM-RoBERTa family) as a PyTorch module.

Counterpart of ``minivectordb_tpu/models/encoder.py``: one post-LN encoder
serves every model family of ``EmbeddingModel`` (the multilingual-e5 sizes,
bge-m3 and the bundled trained artifacts); weights come from converted
checkpoints (models/convert.py, convert.py:encoder_from_numpy) or from a
seeded initialiser.

PyTorch's idiom where the JAX module is functional: ``Encoder`` is an
``nn.Module`` of ``EncoderLayer``s holding ``nn.Parameter``s; the serving
entry points (``embed_program``) run under ``torch.inference_mode()``, while
``encode`` runs under the caller's grad mode, so training (models/train.py)
differentiates it with ``torch.autograd``; the device is explicit;
``init_params`` takes a ``torch.Generator``. Pooling and
the cosine floor are plain functions on tensors. Dense weights are stored the
way ``torch.nn.functional.linear`` wants them, (out, in): the JAX pytree's
(in, out) matrices are transposed once when they are loaded.

Numerics follow the JAX module: a dense layer accumulates in float32 and
rounds once to the activations' type; layer norm, softmax and pooling compute
in float32 whatever the parameters' type; GELU is the exact erf form; float32
products are IEEE float32 (TF32 stays off, ops/scan.py). Attention takes one
of two routes, chosen as the JAX module chooses: sequences of 256 and more
(a multiple of 128, head width >= 32) on a CUDA device go through the
hand-written flash-attention kernel (ops/flash_attention.py, segment ids =
the attention mask; with a gradient, its backward kernels too); everything
else materialises the (S, S) logits and masks keys only. The two differ at pad
positions alone, which both pools drop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from minivectordb_tpu_torch.ops import flash_attention as flash_ops
from minivectordb_tpu_torch.ops import scan as scan_ops


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int
    hidden: int
    layers: int
    heads: int
    intermediate: int
    max_positions: int = 514
    pad_id: int = 1
    layer_norm_eps: float = 1e-5
    # XLM-R position ids start at pad_id + 1 for real tokens
    pos_offset: int = 2
    # L2-normalize each token's hidden state BEFORE mean pooling, so every
    # token contributes exactly 1/n to the sentence vector. Used by the
    # bundled trained encoders: with raw mean pooling the effective per-token
    # weight varies with the hidden-state norm.
    token_norm_pool: bool = False
    # When > 0, the LAST output dim is replaced by the constant sqrt(f) and
    # the rest rescaled by sqrt(1-f), so every pairwise cosine becomes
    # (1-f)*cos + f >= 2f-1 exactly (the high-anisotropy score distribution
    # of real sentence encoders, which the autocut contract presumes).
    cos_floor: float = 0.0


class _LayerNormParams(nn.Module):
    def __init__(self, hidden: int, device, dtype):
        super().__init__()
        self.g = nn.Parameter(torch.ones(hidden, device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(hidden, device=device, dtype=dtype))


class _DenseParams(nn.Module):
    """weight (out, in), as ``torch.nn.functional.linear`` takes it, and bias
    (out,). Left uninitialised (``nn.Linear`` would draw values that are
    overwritten at once)."""

    def __init__(self, kin: int, kout: int, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((kout, kin), device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(kout, device=device, dtype=dtype))


class EncoderLayer(nn.Module):
    """One post-LN transformer layer's parameters: the dense layers q, k, v,
    attn_out, ffn_in, ffn_out and the two layer norms."""

    def __init__(self, cfg: EncoderConfig, device, dtype):
        super().__init__()
        self.q = _DenseParams(cfg.hidden, cfg.hidden, device, dtype)
        self.k = _DenseParams(cfg.hidden, cfg.hidden, device, dtype)
        self.v = _DenseParams(cfg.hidden, cfg.hidden, device, dtype)
        self.attn_out = _DenseParams(cfg.hidden, cfg.hidden, device, dtype)
        self.attn_ln = _LayerNormParams(cfg.hidden, device, dtype)
        self.ffn_in = _DenseParams(cfg.hidden, cfg.intermediate, device, dtype)
        self.ffn_out = _DenseParams(cfg.intermediate, cfg.hidden, device, dtype)
        self.ffn_ln = _LayerNormParams(cfg.hidden, device, dtype)


class Encoder(nn.Module):
    """The encoder's parameters and its forward pass (``encode``). Built in
    eval mode with ``requires_grad`` off (the module has no dropout, so eval
    and train mode compute the same); training switches ``requires_grad`` on
    (models/train.py:init_training). Parameters are uninitialised until
    ``init_params`` or ``convert.encoder_from_numpy`` fills them."""

    def __init__(self, cfg: EncoderConfig, device="cpu", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = {"device": device, "dtype": dtype}
        self.word_emb = nn.Parameter(torch.empty((cfg.vocab_size, cfg.hidden), **kw))
        self.pos_emb = nn.Parameter(torch.empty((cfg.max_positions, cfg.hidden), **kw))
        self.type_emb = nn.Parameter(torch.zeros((1, cfg.hidden), **kw))
        self.emb_ln = _LayerNormParams(cfg.hidden, device, dtype)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device, dtype) for _ in range(cfg.layers)
        )
        self.requires_grad_(False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.word_emb.device

    @property
    def dtype(self) -> torch.dtype:
        return self.word_emb.dtype

    def forward(self, input_ids, attention_mask, allow_flash: bool = True):
        return encode(self, input_ids, attention_mask, allow_flash)


def init_params(cfg: EncoderConfig, generator: torch.Generator, device="cpu",
                dtype=torch.float32) -> Encoder:
    """Seeded initialisation, the no-pretrained fallback: dense weights
    normal * 1/sqrt(in), embeddings normal * 0.02, biases and the type
    embedding zero, layer norms at identity (the JAX initialiser's scales).
    Values are drawn on the generator's device in float32 and differ from
    ``jax.random``'s for the same seed."""
    enc = Encoder(cfg, device, dtype)
    gdev = generator.device

    def normal_(param, scale):
        vals = torch.randn(param.shape, generator=generator, device=gdev) * scale
        param.copy_(vals.to(device=param.device, dtype=param.dtype))

    with torch.no_grad():
        normal_(enc.word_emb, 0.02)
        normal_(enc.pos_emb, 0.02)
        for layer in enc.layers:
            for name in ("q", "k", "v", "attn_out", "ffn_in", "ffn_out"):
                lin = getattr(layer, name)
                normal_(lin.weight, 1.0 / math.sqrt(lin.weight.shape[1]))
    return enc


def _layer_norm(x, g, b, eps: float):
    """Layer norm over the last axis: statistics (biased variance) and the
    affine step in float32, one rounding to x's type (``F.layer_norm``
    accumulates in float32 whatever the tensors' type). g and b have x's type
    in every module of this package: parameters are cast wholesale."""
    return F.layer_norm(x, x.shape[-1:], g.to(x.dtype), b.to(x.dtype), eps)


def _dense(x, lin: _DenseParams):
    """x @ W^T + b, accumulated in float32 and rounded once to x's type."""
    scan_ops._assert_ieee_f32(x)
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _use_flash_attention(seq: int, head_dim: int, device: torch.device) -> bool:
    """The flash-attention kernel serves long sequences on a CUDA device
    (memory linear in seq, fused softmax); the materialised route serves the
    CPU and short sequences."""
    return (
        device.type == "cuda"
        and seq >= 256
        and seq % 128 == 0
        and head_dim >= 32
    )


def _attention(x, layer: EncoderLayer, mask, cfg: EncoderConfig,
               allow_flash: bool = True):
    b, s, h = x.shape
    nh, hd = cfg.heads, cfg.hidden // cfg.heads
    # (B, nh, S, hd) views of the (B, S, H) projections: no copy
    q = _dense(x, layer.q).view(b, s, nh, hd).transpose(1, 2)
    k = _dense(x, layer.k).view(b, s, nh, hd).transpose(1, 2)
    v = _dense(x, layer.v).view(b, s, nh, hd).transpose(1, 2)
    if allow_flash and _use_flash_attention(s, hd, x.device):
        seg = mask.to(torch.int32)  # pads form their own segment (0)
        ctx = flash_ops.flash_attention(q, k, v, seg, 1.0 / math.sqrt(hd))
        return _dense(ctx.transpose(1, 2).reshape(b, s, h), layer.attn_out)
    # float32 logits of exact products, as the JAX einsum asks for
    logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    logits = logits / math.sqrt(hd)
    logits = logits.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.matmul(probs, v)  # float32 accumulation, one rounding
    return _dense(ctx.transpose(1, 2).reshape(b, s, h), layer.attn_out)


def encode(encoder: Encoder, input_ids, attention_mask, allow_flash: bool = True):
    """Forward pass -> last_hidden_state (B, S, H) in the parameters' type.

    input_ids / attention_mask: (B, S) integer tensors on the encoder's
    device. Post-LN transformer matching XLM-RoBERTa; position ids follow the
    XLM-R convention (pad positions get pad_id, real tokens count from
    pad_id + 1). ``allow_flash=False`` forces the materialised attention.
    Runs under the caller's grad mode: the serving callers enter
    ``torch.inference_mode()`` themselves, training records the graph."""
    cfg = encoder.cfg
    attention_mask = attention_mask.to(torch.int64)
    mask = attention_mask.to(torch.bool)
    positions = torch.cumsum(attention_mask, dim=-1) * attention_mask + cfg.pad_id
    x = (
        encoder.word_emb[input_ids.to(torch.int64)]
        + encoder.pos_emb[positions]
        + encoder.type_emb[0]
    )
    x = _layer_norm(x, encoder.emb_ln.g, encoder.emb_ln.b, cfg.layer_norm_eps)
    for layer in encoder.layers:
        attn = _attention(x, layer, mask, cfg, allow_flash)
        x = _layer_norm(x + attn, layer.attn_ln.g, layer.attn_ln.b,
                        cfg.layer_norm_eps)
        ff = _dense(F.gelu(_dense(x, layer.ffn_in)), layer.ffn_out)
        x = _layer_norm(x + ff, layer.ffn_ln.g, layer.ffn_ln.b,
                        cfg.layer_norm_eps)
    return x


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def mean_pool_normalize(hidden, attention_mask, token_norm: bool = False):
    """Masked mean-pool + L2 normalize, in float32 whatever the encoder's
    compute type. token_norm: see EncoderConfig.token_norm_pool."""
    hidden = hidden.to(torch.float32)
    if token_norm:
        hidden = _unit(hidden)
    m = attention_mask[..., None].to(torch.float32)
    summed = torch.sum(hidden * m, dim=1)
    counts = torch.clamp(torch.sum(m, dim=1), min=1.0)
    return _unit(summed / counts)


def cls_pool_normalize(hidden, attention_mask):
    """CLS-token pooling + L2 normalize (bge-m3's dense vectors)."""
    del attention_mask
    return _unit(hidden[:, 0, :].to(torch.float32))


def apply_cos_floor(out, cfg: EncoderConfig):
    """Apply cfg.cos_floor to unit embeddings (see EncoderConfig.cos_floor);
    identity when the floor is 0. Must be applied by EVERY path that emits
    this encoder's embeddings (embed_program AND the fused pipeline)."""
    if cfg.cos_floor <= 0.0:
        return out
    f = cfg.cos_floor
    body = _unit(out[:, :-1]) * float(np.sqrt(1.0 - f))
    last = torch.full((out.shape[0], 1), float(np.sqrt(f)), dtype=out.dtype,
                      device=out.device)
    return torch.cat([body, last], dim=-1)


def embed_program(encoder: Encoder, input_ids, attention_mask, pooling: str = "mean",
                  allow_flash: bool = True):
    """The embed program: encoder forward + pool + normalize + cosine floor.
    Returns (B, hidden) float32 unit vectors on the encoder's device."""
    with torch.inference_mode():
        hidden = encode(encoder, input_ids, attention_mask, allow_flash)
        if pooling == "cls":
            out = cls_pool_normalize(hidden, attention_mask)
        else:
            out = mean_pool_normalize(hidden, attention_mask,
                                      encoder.cfg.token_norm_pool)
        return apply_cos_floor(out, encoder.cfg)


def embed_program_host(host_encoder: Encoder, input_ids, attention_mask,
                       pooling: str = "mean"):
    """The same embed program on a copy of the encoder that lives on the CPU:
    for the compact bundled encoders a single-text forward is well under a
    millisecond of host sgemm, less than a round trip to the card. The
    adaptive router of embedding_model.py picks this route for small batches
    the way the store routes small scans to host BLAS. ids and mask are numpy
    arrays or CPU tensors; the materialised attention is the only route here."""
    if host_encoder.device.type != "cpu":
        raise ValueError(f"the host copy lives on {host_encoder.device}, not the CPU")
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64)
    mask = torch.as_tensor(np.asarray(attention_mask), dtype=torch.int64)
    return embed_program(host_encoder, ids, mask, pooling, allow_flash=False)


def seq_bucket(n: int, max_len: int = 512) -> int:
    b = 16
    while b < n and b < max_len:
        b <<= 1
    return min(b, max_len)
