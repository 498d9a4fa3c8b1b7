"""The yardstick: operations, bytes and least times of the work a cell asks
for, from shapes and lengths alone.

Every count here is of what the inputs need, counted once, whatever a
kernel reads again or computes and throws away: live corpus rows and real
queries for a scan, the real token pairs of each sequence for attention,
every input byte read once and every output byte written once. So a later,
faster implementation of the same work can never read above 100% of a
roofline, and the yardstick does not move when the implementation does.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity), at the full 700 W power limit; a run reports the card's own
limit beside them. Float32 work is held to the TF32 tensor-core rate: a
float32 kernel that splits its products into TF32 words (3xTF32) does three
products for each one counted here, and that choice is the
implementation's, not the work's.
"""

from __future__ import annotations

PEAK_FLOPS = {
    "float32": 495e12,   # TF32 tensor cores, dense
    "bfloat16": 989e12,
    "int8": 1979e12,     # operations per second
}
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def least_seconds(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The roofline: the larger of the operations at the peak rate of
    ``dtype`` and the bytes at HBM bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# -- exact search ------------------------------------------------------------


def phase1_work(rows: int, dim: int, queries: int, subtile: int = 32,
                dtype: str = "float32") -> tuple[float, float]:
    """(flops, bytes) of phase 1 of a fused scan: every live row scored
    against every real query (2 operations a multiply-add), the live rows,
    their inverse norms and the queries read once, one maximum a (query,
    subtile of ``subtile`` live rows) written."""
    flops = 2.0 * rows * dim * queries
    subtiles = -(-rows // subtile)
    nbytes = (rows * dim * DTYPE_BYTES[dtype] + rows * 4
              + queries * dim * 4 + queries * subtiles * 4)
    return flops, nbytes


def scan_work(rows: int, dim: int, queries: int, k: int,
              dtype: str = "float32") -> tuple[float, float]:
    """(flops, bytes) of a whole exact top-k scan of ``queries`` queries:
    the scores as in ``phase1_work``, the corpus, its norms and the queries
    read once, k (score, id) pairs a query written. The ranking itself is
    not counted as operations."""
    flops = 2.0 * rows * dim * queries
    nbytes = (rows * dim * DTYPE_BYTES[dtype] + rows * 4 + queries * dim * 4
              + queries * k * (4 + 8))
    return flops, nbytes


# -- attention ---------------------------------------------------------------

# multiply-adds a real (query, key) pair costs a head, times head width, for
# each kernel: the forward forms S = Q K^T and O = P V; dK / dV recomputes S,
# forms dP = dO V^T, dV = P^T dO and dK = dS^T Q; dQ recomputes S and dP and
# forms dQ = dS K
_ATTENTION_PRODUCTS = {"forward": 2, "dkv": 4, "dq": 3}


def attention_work(kernel: str, lengths: list[int], heads: int, head_dim: int,
                   dtype: str = "float32", pairs: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of one attention kernel launch over a batch of
    sequences of ``lengths`` real tokens. Operations count the real token
    pairs the launch needs: ``pairs`` where given (a kernel that attends
    within a window), else every pair of each sequence; bytes count every
    tensor the launch reads and writes once, at the real tokens' rows (pads
    are padding the implementation chose, not work), the row statistics at
    one float32 a (real token, head).

    kernel: "forward" (O from Q, K, V), "forward_lse" (O and the row
    log-sum-exp), "dkv" (dK, dV from Q, K, V, dO, lse, delta) or "dq"
    (dQ from the same)."""
    tokens = float(sum(lengths))
    pairs = float(sum(n * n for n in lengths) if pairs is None else pairs)
    base = "forward" if kernel.startswith("forward") else kernel
    flops = 2.0 * _ATTENTION_PRODUCTS[base] * heads * head_dim * pairs
    tensor = tokens * heads * head_dim * DTYPE_BYTES[dtype]
    stat = tokens * heads * 4
    if kernel == "forward":
        nbytes = 4 * tensor                      # q, k, v in; o out
    elif kernel == "forward_lse":
        nbytes = 4 * tensor + stat               # + lse out
    elif kernel == "dkv":
        nbytes = 6 * tensor + 2 * stat           # q, k, v, dO, lse, delta in; dK, dV out
    elif kernel == "dq":
        nbytes = 5 * tensor + 2 * stat           # q, k, v, dO, lse, delta in; dQ out
    else:
        raise ValueError(f"unknown attention kernel {kernel!r}")
    return flops, nbytes


# -- whole encoder -----------------------------------------------------------


def dense_weights(hidden: int, intermediate: int, layers: int) -> int:
    """Weights of an encoder's dense layers (q, k, v, the attention output,
    the two feed-forward layers), biases left out."""
    return layers * (4 * hidden * hidden + 2 * hidden * intermediate)


def encoder_forward_flops(lengths: list[int], hidden: int, intermediate: int,
                          layers: int) -> float:
    """Model operations of one forward pass over sequences of ``lengths``
    real tokens: 2 per dense weight per real token, plus the attention's two
    products over each sequence's real token pairs (4 x hidden a pair a
    layer). Pads, embedding lookups, norms and pooling are not counted."""
    tokens = float(sum(lengths))
    pairs = float(sum(n * n for n in lengths))
    return (2.0 * dense_weights(hidden, intermediate, layers) * tokens
            + 4.0 * hidden * pairs * layers)


def mfu_share(flops: float, seconds: float, dtype: str = "float32") -> float:
    """Percent of the peak of ``dtype`` that ``flops`` over ``seconds``
    reach."""
    return 100.0 * flops / (PEAK_FLOPS[dtype] * seconds)


def roofline_share(least_s: float, measured_s: float) -> float:
    """Percent of its roofline a kernel reached: least time over time."""
    return 100.0 * least_s / measured_s
