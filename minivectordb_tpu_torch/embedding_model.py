"""EmbeddingModel — text -> dense embedding, on one NVIDIA GPU.

Counterpart of ``minivectordb_tpu/embedding_model.py``, with the same
arguments, method names and results, plus the keyword ``device`` (``None`` =
the CUDA card, raising without one; ``"cpu"`` runs on the host explicitly):

- ``use_quantized_onnx_model=True`` (default): the built-in 512-dim encoder
  slot, served by the bundled trained artifact.
  ``onnx_model_cpu_core_count`` is accepted and validated for compatibility.
- ``alternative_model`` in {small, large, bgem3} mirrors
  multilingual-e5-small/large and bge-m3, with the back-compat
  ``e5_model_size`` kwarg.
- e5 paths prepend the literal ``'passage {text}'`` prefix (no colon) and
  truncate at 512 tokens.

Weights, in this order: a converted checkpoint (an artifact directory under
``MINIVECTORDB_TORCH_WEIGHTS``, or an HF checkpoint in the local cache), the
bundled trained artifact of the slot, or a seeded random encoder of the same
output width (with a warning). The bundled artifacts are read as data files
from ``minivectordb_tpu/resources/<slot>/`` beside this package (or from
``MINIVECTORDB_TORCH_RESOURCES``, where models/train_builtin.py can write
one); nothing of that package is imported.

One embed call is one forward of ``models/encoder.py:embed_program`` over the
whole batch. Token batches are padded to a power-of-two batch and a sequence
bucket (16 .. 512), the shapes the JAX package compiles for, so both packages
run the same shapes and take the same attention route (sequences of 256 and
512 reach the flash-attention kernel on the card).

Batches of at most 8 on a compact model may run on a CPU copy of the module
when an adaptive router measured that faster than the card (a documented
route, visible in ``EmbeddingModel.model.routing_stats()``; it is no fallback:
a model constructed for a card that is missing raises).
``MINIVECTORDB_TORCH_HOST_EMBED_BATCH=0`` disables it. Unlike the JAX
package's, the router takes its first device timing in line on the caller's
thread, and a device error reaches the caller.
"""

from __future__ import annotations

import copy
import json
import os
import time
import warnings
from enum import Enum

import numpy as np
import torch

from minivectordb_tpu_torch.convert import encoder_from_numpy
from minivectordb_tpu_torch.core.store import _ScanRouter
from minivectordb_tpu_torch.models import configs as model_configs
from minivectordb_tpu_torch.models.convert import load_converted, load_pretrained
from minivectordb_tpu_torch.models.encoder import (
    Encoder,
    embed_program,
    embed_program_host,
    init_params,
    seq_bucket,
)
from minivectordb_tpu_torch.models.tokenizer import WordVocabTokenizer, load_tokenizer
from minivectordb_tpu_torch.ops import scan as scan_ops

# Single-text/small-batch embeds may run on the HOST instead of the card: the
# compact bundled encoders (2 layers) are well under a millisecond of host
# sgemm (the same economics as the store's host BLAS scan route,
# core/store.py). 0 disables host embedding.
_HOST_EMBED_MAX_BATCH = int(
    os.environ.get("MINIVECTORDB_TORCH_HOST_EMBED_BATCH", 8)
)
# Host eligibility is bounded by model size: beyond ~4 compact layers a real
# checkpoint (12-24 layers, 250k vocab) is device-bound, and timing the host
# would waste hundreds of ms per call while the router warms.
_HOST_EMBED_MAX_LAYERS = 4
_HOST_EMBED_MAX_HIDDEN = 1024
_HOST_EMBED_MAX_VOCAB = 65536

class AlternativeModel(str, Enum):
    small = "small"
    large = "large"
    bgem3 = "bgem3"


class _TorchEncoder:
    """Bundles the encoder module + tokenizer + pooling into one callable.

    Small-batch embeds are adaptively routed between the card and a CPU copy
    of the same module (see the module docstring); the router
    (core.store._ScanRouter) times both paths and keeps the winner."""

    def __init__(self, encoder: Encoder, tokenizer, pooling: str, prefix: str = ""):
        self.encoder = encoder
        self.cfg = encoder.cfg
        self.tokenizer = tokenizer
        self.pooling = pooling
        self.prefix = prefix
        self._host_encoder = None
        self._router = _ScanRouter()
        self._calls = {"host": 0, "device": 0}

    @property
    def device(self) -> torch.device:
        return self.encoder.device

    def routing_stats(self) -> dict:
        """Which route served how many embed calls, and the router's timings
        (seconds, exponential moving averages; None before the first)."""
        return {
            "device": str(self.device),
            "host_capable": self._host_capable(),
            "host_calls": self._calls["host"],
            "device_calls": self._calls["device"],
            "host_ema_s": self._router.host_ema,
            "device_ema_s": self._router.dev_ema,
        }

    def _host_capable(self) -> bool:
        return (
            _HOST_EMBED_MAX_BATCH > 0
            and self.cfg.layers <= _HOST_EMBED_MAX_LAYERS
            and self.cfg.hidden <= _HOST_EMBED_MAX_HIDDEN
            and self.cfg.vocab_size <= _HOST_EMBED_MAX_VOCAB
            and self.device.type != "cpu"  # host == device on the cpu
        )

    def _host_encoder_synced(self) -> Encoder:
        """CPU-resident mirror of self.encoder (EmbeddingModel._maybe_cast
        drops it when it casts the module)."""
        if self._host_encoder is None:
            self._host_encoder = copy.deepcopy(self.encoder).to("cpu")
        return self._host_encoder

    def _embed_host(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        self._calls["host"] += 1
        out = embed_program_host(self._host_encoder_synced(), ids, mask, self.pooling)
        return out.numpy()

    def _embed_device(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        self._calls["device"] += 1
        dev = self.device
        out = embed_program(
            self.encoder, scan_ops.to_device(ids, dev), scan_ops.to_device(mask, dev),
            self.pooling,
        )
        return out.cpu().numpy()

    def _tokenize_padded(self, texts: list[str], max_length: int):
        """Tokenize + pad to (pow2-batch, seq-bucket): the shapes the JAX
        package runs."""
        texts = [self.prefix + t for t in texts]
        batch = self.tokenizer(texts, max_length=max_length)
        ids = np.asarray(batch["input_ids"], dtype=np.int32)
        mask = np.asarray(batch["attention_mask"], dtype=np.int32)
        s = seq_bucket(ids.shape[1], max_length)
        if ids.shape[1] < s:
            pad = s - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=self.cfg.pad_id)
            mask = np.pad(mask, ((0, 0), (0, pad)))
        b = 1
        while b < ids.shape[0]:
            b <<= 1
        if ids.shape[0] < b:
            pad = b - ids.shape[0]
            ids = np.pad(ids, ((0, pad), (0, 0)), constant_values=self.cfg.pad_id)
            mask = np.pad(mask, ((0, pad), (0, 0)))
            mask[-pad:, 0] = 1  # fully-masked rows would divide by zero count
        return ids, mask

    def embed(self, texts: list[str], max_length: int = 512) -> np.ndarray:
        ids, mask = self._tokenize_padded(texts, max_length)
        if ids.shape[0] <= _HOST_EMBED_MAX_BATCH and self._host_capable():
            which = self._router.choose()
            if which == "device" and self._router.dev_ema is None:
                # the first device call pays one-time set-up (a kernel build,
                # library handles) that would poison the timing: run it once
                # untimed, in line; an error reaches the caller
                self._embed_device(ids, mask)
            t0 = time.perf_counter()
            if which == "host":
                out = self._embed_host(ids, mask)
            else:
                out = self._embed_device(ids, mask)
            self._router.record(which, time.perf_counter() - t0)
            return out[: len(texts)]
        return self._embed_device(ids, mask)[: len(texts)]


def _resources_dir() -> str:
    """Where the slots' trained artifacts live: ``MINIVECTORDB_TORCH_RESOURCES``
    (e.g. a directory models/train_builtin.py wrote ``builtin/`` into), else
    the JAX package's bundled resources, read by path."""
    override = os.environ.get("MINIVECTORDB_TORCH_RESOURCES")
    if override:
        return override
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "minivectordb_tpu", "resources")


def _bundled_dir(kind: str) -> str:
    return os.path.join(
        _resources_dir(), "builtin" if kind == "builtin" else f"trained_{kind}"
    )


def _load_bundled(kind: str, prefix: str, device) -> "_TorchEncoder | None":
    """A trained artifact shipped as package data: every slot
    (builtin/small/large/bgem3) carries one, so the semantic contract holds
    offline for all four. The files hold float16; they load as float32."""
    bundle = _bundled_dir(kind)
    try:
        params, cfg = load_converted(bundle)
        with open(os.path.join(bundle, "vocab.json")) as f:
            vocab = json.load(f)
        if vocab.get("format") != "word-vocab-v1":
            return None
        encoder = encoder_from_numpy(params, cfg, device)
        tok = WordVocabTokenizer(
            vocab["words"], cfg.vocab_size,
            drop_oov=bool(vocab.get("drop_oov", False)),
        )
        # trained artifacts pool with the mean/token-norm head they were
        # trained with, whatever the slot's HF counterpart would use
        return _TorchEncoder(encoder, tok, "mean", prefix)
    except FileNotFoundError:
        return None
    except (OSError, ValueError, KeyError, TypeError) as exc:
        # the artifact EXISTS but failed to load: corruption, not absence —
        # surface the real error so it is distinguishable from a missing file
        warnings.warn(
            f"minivectordb_tpu_torch: bundled '{kind}' encoder artifact failed "
            f"to load ({type(exc).__name__}: {exc}); falling back to the seeded "
            "encoder. The package data may be corrupt or truncated."
        )
        return None


def _load_encoder(kind: str, device=None) -> tuple[_TorchEncoder, str]:
    """kind in {'builtin', 'small', 'large', 'bgem3'} -> (encoder, source).

    source: 'pretrained' (converted checkpoint), 'bundled-trained' (the
    package-data artifact), or 'seeded' (random fallback)."""
    device = scan_ops.resolve_device(device)
    pooling = "cls" if kind == "bgem3" else "mean"
    prefix = "passage " if kind in ("small", "large") else ""
    hf_name = model_configs.HF_MODEL_NAMES.get(kind)
    override = os.environ.get("MINIVECTORDB_TORCH_WEIGHTS")
    if override:
        hf_name = os.path.join(override, kind) if os.path.isdir(
            os.path.join(override, kind)
        ) else override
    if kind != "builtin" and hf_name is not None:
        try:
            params, cfg = load_pretrained(hf_name)
        except (ImportError, OSError, ValueError, KeyError):
            params = None  # no converted weights here: the next source serves
        if params is not None:
            encoder = encoder_from_numpy(params, cfg, device)
            tok, _ = load_tokenizer(hf_name, cfg.vocab_size)
            return _TorchEncoder(encoder, tok, pooling, prefix), "pretrained"
    enc = _load_bundled(kind, prefix, device)
    if enc is not None:
        return enc, "bundled-trained"
    cfg = model_configs.FALLBACK_CONFIGS[kind]
    generator = torch.Generator(device="cpu")
    generator.manual_seed(model_configs.FALLBACK_SEEDS[kind])
    encoder = init_params(cfg, generator, device)
    tok, _ = load_tokenizer(None, cfg.vocab_size)
    warnings.warn(
        f"minivectordb_tpu_torch: pretrained weights for '{kind}' are not "
        "available offline; using a deterministic seeded encoder (correct "
        "dimensions, no semantic quality). Set MINIVECTORDB_TORCH_WEIGHTS or "
        "populate the HF cache to enable pretrained embeddings."
    )
    return _TorchEncoder(encoder, tok, pooling, prefix), "seeded"


class EmbeddingModel:
    def __init__(
        self,
        use_quantized_onnx_model: bool = True,
        alternative_model: AlternativeModel = AlternativeModel.bgem3,
        onnx_model_cpu_core_count=None,
        compute_dtype: str | None = None,
        *,
        device=None,
        **kwargs,
    ):
        """compute_dtype: optional 'bfloat16' casts the encoder's parameters
        for tensor-core throughput (layernorm/softmax/pooling stay float32
        internally; embeddings differ from float32 by ~1e-3 — fine for
        retrieval). device: None = the CUDA card (raises without one);
        'cpu' runs on the host."""
        self.use_quantized_onnx_model = use_quantized_onnx_model
        self.onnx_model_cpu_core_count = onnx_model_cpu_core_count
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype {compute_dtype!r}: None, 'float32' or 'bfloat16'"
            )
        self.compute_dtype = compute_dtype
        self.device = scan_ops.resolve_device(device)
        if not (
            isinstance(self.onnx_model_cpu_core_count, int)
            or self.onnx_model_cpu_core_count is None
        ):
            raise AssertionError("onnx_model_cpu_core_count must be an int or None")
        # back-compat kwarg
        if "e5_model_size" in kwargs:
            self.alternative_model = AlternativeModel(kwargs["e5_model_size"])
        else:
            self.alternative_model = AlternativeModel(alternative_model)

        if self.use_quantized_onnx_model:
            self.load_onnx_model()
        else:
            self.load_alternative_model()

    # -- loading (names preserved from the reference) ----------------------

    def load_onnx_model(self) -> None:
        self.model, self.weights_source = _load_encoder("builtin", self.device)
        self._maybe_cast()

    def load_alternative_model(self) -> None:
        self.model, self.weights_source = _load_encoder(
            self.alternative_model.value, self.device
        )
        self._maybe_cast()

    @property
    def is_pretrained(self) -> bool:
        """True when converted HF checkpoint weights loaded."""
        return self.weights_source == "pretrained"

    @property
    def is_trained(self) -> bool:
        """True when the encoder carries real semantic signal — converted
        HF weights or the bundled trained artifact (vs the seeded random
        fallback)."""
        return self.weights_source in ("pretrained", "bundled-trained")

    def _maybe_cast(self) -> None:
        if self.compute_dtype == "bfloat16":
            self.model.encoder.to(torch.bfloat16)  # in place
            self.model._host_encoder = None  # rebuilt from the cast module

    def warmup(self, batch: int = 1) -> None:
        """Run the embed program for one (batch, seq) shape before taking
        traffic (counterpart of VectorDatabase.warmup): on the card that
        builds nothing for short texts, but it loads the libraries and routes
        through the same adaptive host/device path a real call would, so it
        also primes the router. Idempotent."""
        self.model.embed(["warmup"] * batch)

    def average_pool(self, last_hidden_states, attention_mask):
        """Masked mean over the sequence axis. The encoder's own pooling is
        part of the embed program (models/encoder.py:mean_pool_normalize);
        this standalone helper is kept for API parity and works on numpy
        arrays or anything np.asarray-able."""
        h = np.asarray(last_hidden_states, dtype=np.float32)
        m = np.asarray(attention_mask)
        h = np.where(m[..., None].astype(bool), h, 0.0)
        # all-zero mask rows would divide 0/0 -> silent NaN embeddings; clamp
        # the count instead — the degenerate row pools to zeros,
        # non-degenerate rows are unchanged
        counts = np.maximum(m.sum(axis=1), 1e-9)
        return h.sum(axis=1) / counts[..., None]

    # -- extraction (names preserved from the reference) -------------------

    def extract_embeddings_quant_onnx(self, text: str) -> np.ndarray:
        return self.model.embed([text])[0]

    def extract_embeddings_e5_multi(self, text: str) -> list:
        return self.model.embed([text])[0].tolist()

    def extract_embeddings_bgem3(self, text: str) -> list:
        return self.model.embed([text])[0].tolist()

    def extract_embeddings(self, text: str):
        if self.use_quantized_onnx_model:
            return self.extract_embeddings_quant_onnx(text)
        if self.alternative_model in (AlternativeModel.small, AlternativeModel.large):
            return self.extract_embeddings_e5_multi(text)
        return self.extract_embeddings_bgem3(text)

    def extract_embeddings_batch(self, texts: list[str]) -> np.ndarray:
        """Batched embedding — one forward over the whole batch."""
        return self.model.embed(list(texts))
