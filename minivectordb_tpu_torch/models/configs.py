"""Encoder model-family configurations.

Counterpart of ``minivectordb_tpu/models/configs.py`` (the same values; the
port keeps its own copy). Full-size configs mirror the HF checkpoints;
fallback configs are small seeded encoders with the SAME output
dimensionality, used when neither converted weights nor a bundled trained
artifact is available (this keeps every API/shape contract intact offline —
semantic quality obviously requires trained weights).
"""

from __future__ import annotations

from minivectordb_tpu_torch.models.encoder import EncoderConfig

# Real architectures (for weight conversion via models/convert.py)
E5_SMALL = EncoderConfig(
    vocab_size=250037, hidden=384, layers=12, heads=12, intermediate=1536
)
E5_LARGE = EncoderConfig(
    vocab_size=250037, hidden=1024, layers=24, heads=16, intermediate=4096
)
BGE_M3 = EncoderConfig(  # XLM-RoBERTa-large backbone, 8192 positions
    vocab_size=250002,
    hidden=1024,
    layers=24,
    heads=16,
    intermediate=4096,
    max_positions=8194,
)

# Fallback (seeded) configs — same output dims, small bodies.
FALLBACK_VOCAB = 32768
FALLBACK_E5_SMALL = EncoderConfig(
    vocab_size=FALLBACK_VOCAB, hidden=384, layers=2, heads=6, intermediate=1024
)
FALLBACK_E5_LARGE = EncoderConfig(
    vocab_size=FALLBACK_VOCAB, hidden=1024, layers=2, heads=8, intermediate=2048
)
FALLBACK_BGE_M3 = EncoderConfig(
    vocab_size=FALLBACK_VOCAB, hidden=1024, layers=2, heads=8, intermediate=2048
)
# The builtin 512-dim slot (stands in for a quantized ONNX Universal Sentence
# Encoder; the API surface is preserved).
BUILTIN_512 = EncoderConfig(
    vocab_size=FALLBACK_VOCAB, hidden=512, layers=4, heads=8, intermediate=1024
)
# The BUNDLED trained builtin encoder: compact enough to ship as package data
# (~9 MB f16). vocab layout is WordVocabTokenizer's: 4 specials + the curated
# corpus words + hashed OOV buckets.
TRAINED_BUILTIN = EncoderConfig(
    vocab_size=4096, hidden=512, layers=2, heads=8, intermediate=1024,
    token_norm_pool=True,
)
# Bundled trained stand-ins for the alternative-model slots: same output
# dimensionality as the HF checkpoints each slot would serve (e5-small 384,
# e5-large/bge-m3 1024), trained offline with the same stack as the builtin
# so the semantic contract holds for EVERY slot with no network. Converted
# real checkpoints still take precedence when present.
TRAINED_SMALL = EncoderConfig(
    vocab_size=4096, hidden=384, layers=2, heads=8, intermediate=1024,
    token_norm_pool=True,
)
TRAINED_LARGE = EncoderConfig(
    vocab_size=4096, hidden=1024, layers=2, heads=8, intermediate=1536,
    token_norm_pool=True,
)
TRAINED_BGEM3 = EncoderConfig(
    vocab_size=4096, hidden=1024, layers=2, heads=8, intermediate=1536,
    token_norm_pool=True,
)
TRAINED_CONFIGS = {
    "builtin": TRAINED_BUILTIN,
    "small": TRAINED_SMALL,
    "large": TRAINED_LARGE,
    "bgem3": TRAINED_BGEM3,
}
# the seeds the bundled artifacts were trained with
TRAINED_SEEDS = {"builtin": 0, "small": 11, "large": 32, "bgem3": 33}

HF_MODEL_NAMES = {
    "small": "intfloat/multilingual-e5-small",
    "large": "intfloat/multilingual-e5-large",
    "bgem3": "BAAI/bge-m3",
}

REAL_CONFIGS = {"small": E5_SMALL, "large": E5_LARGE, "bgem3": BGE_M3}
FALLBACK_CONFIGS = {
    "small": FALLBACK_E5_SMALL,
    "large": FALLBACK_E5_LARGE,
    "bgem3": FALLBACK_BGE_M3,
    "builtin": BUILTIN_512,
}
FALLBACK_SEEDS = {"small": 101, "large": 102, "bgem3": 103, "builtin": 100}
