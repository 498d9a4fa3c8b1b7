"""Small-batch exact scan: one pass over a float32 corpus, the top-k selected
inside it (``csrc/small_scan.cu``).

``ops/scan.py:scan_topk`` hands this module the searches of up to 8 queries
over a CUDA float32 buffer (``device_dtype`` "float32", and "mixed", whose
``buf`` is float32) whose selection width ``kb`` is at most ``KMAX``
(``takes_kernel``). Every other input keeps ``scan_topk``'s plain route:
bfloat16 and int8 buffers, wider selections, larger batches, CPU tensors.

The kernel replaces no Pallas kernel: the JAX package leaves this route to
XLA (a matmul into the (B, C) score matrix, then ``lax.top_k``), and so did
the port (``torch.matmul`` with the batch padded to 8, the scale and mask,
``topk_last_axis``: about 60 launches a search that write and re-read that
matrix). Bytes bound it: the corpus is read once, in IEEE float32 FMAs on the
CUDA cores (no TF32, the exact path's contract), and each block keeps the
top ``kb`` of its rows for each query in shared memory; a second kernel
merges the blocks' lists. The source's header gives the design.

The answer is ``scan_topk``'s: the same scores up to the summation order of
each dot (IEEE float32 both ways), ranked as ``topk_last_axis`` ranks them —
descending score, the lower row first among equal scores (also across the
kb-th place), -0.0 equal to +0.0 (a score of -0.0 comes back as +0.0), masked
rows and rows past ``count`` scoring ``_MASKED_SCORE`` and ranked by row.
``small_scan_plain`` repeats the kernel's arithmetic in plain PyTorch:
per-block top-k of the same 64-bit keys, then the merge. ``LAUNCHES`` counts
the kernels' launches: two a search (the scan and the merge), the merge
alone at ``count`` = 0.
"""

from __future__ import annotations

import ctypes

import torch

from minivectordb_tpu_torch.kernels import build
from minivectordb_tpu_torch.ops import scan as scan_ops

KMAX = 1024  # the widest selection the kernel's shared memory holds (csrc MAX_KB)
MAX_QUERIES = 8
MIN_BLOCK_ROWS = 256  # rows a scan block takes at least
_PLAIN_BLOCKS = 264  # the plain version's block count by default (2 an SM of an H100)
_EMPTY = -(1 << 63)  # the plain version's "no key", below every key

# Kernel launches: the scan ("_mask": with a candidate mask) and the merge; a
# search launches one merge and, unless count is 0, one scan. Incremented in
# small_scan_topk, where the kernels are launched, and nowhere else.
LAUNCHES = {"small_scan_f32": 0, "small_scan_f32_mask": 0, "small_scan_merge": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def takes_kernel(device_type: str, dtype: torch.dtype, batch: int, kb: int) -> bool:
    """Whether a scan of ``batch`` queries keeping ``kb`` per query over a
    buffer of ``dtype`` on a ``device_type`` device is this kernel's."""
    return (device_type == "cuda" and dtype == torch.float32
            and 1 <= batch <= MAX_QUERIES and kb <= KMAX)


def plan(count: int, max_blocks: int) -> tuple[int, int]:
    """(scan blocks, rows a block) for rows [0, count): as many blocks as
    the card holds at once (``max_blocks``), none with fewer than
    ``MIN_BLOCK_ROWS`` rows unless the corpus is smaller, none empty.
    (0, 0) at count 0: the merge alone runs."""
    if count <= 0:
        return 0, 0
    blocks = max(1, min(max_blocks, count // MIN_BLOCK_ROWS))
    rows = -(-count // blocks)
    return -(-count // rows), rows


_P = ctypes.c_void_p
_I = ctypes.c_int
_fns: dict = {}
_max_blocks: dict = {}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load_library("small_scan"), name)
        fn.argtypes = {
            # d, B, kb, out
            "small_scan_max_blocks": [_I, _I, _I, ctypes.POINTER(_I)],
            # buf, q, inv, mask, cand, vals, ids, d, B, count, kb, blocks, rows, stream
            "small_scan_f32": [_P] * 7 + [_I] * 6 + [_P],
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _blocks_for(device: torch.device, d: int, b: int, kb: int) -> int:
    key = (device.index, d, b, kb)
    n = _max_blocks.get(key)
    if n is None:
        out = _I(0)
        err = _kernel_fn("small_scan_max_blocks")(d, b, kb, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"small_scan_max_blocks failed (cudaError {err})")
        n = _max_blocks[key] = out.value
    return n


def _check(buf, inv_norms, q, kb, mask) -> tuple[int, int, int]:
    """What the kernel takes; anything else raises (no fall-back)."""
    if buf.ndim != 2 or q.ndim != 2:
        raise ValueError("buf must be (C, d) and q (B, d)")
    c, d = buf.shape
    b = q.shape[0]
    if buf.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError(f"buf and q must be float32, not {buf.dtype} / {q.dtype}")
    if q.shape[1] != d or d == 0:
        raise ValueError(f"q has dim {q.shape[1]}, buf has {d}")
    if not 1 <= b <= MAX_QUERIES:
        raise ValueError(f"B={b} outside 1..{MAX_QUERIES}")
    if not 1 <= kb <= min(KMAX, c):
        raise ValueError(f"kb={kb} outside 1..min({KMAX}, C={c})")
    if inv_norms.shape != (c,) or inv_norms.dtype != torch.float32:
        raise ValueError("inv_norms must be (C,) float32")
    if mask is not None and (mask.shape != (c,) or mask.dtype != torch.bool):
        raise ValueError("mask must be (C,) bool")
    for name, t in (("buf", buf), ("q", q), ("inv_norms", inv_norms), ("mask", mask)):
        if t is None:
            continue
        if t.device != buf.device:
            raise ValueError(f"{name} lies on {t.device}, buf on {buf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return c, d, b


def small_scan_topk(buf, inv_norms, q, count, kb, mask=None):
    """Cosine scan + top-``kb`` of ``scan_topk`` (same arguments, same
    result) by the kernel: buf (C, d) float32 on a CUDA device, q (B, d)
    float32 raw queries (B <= 8), inv_norms (C,) float32, mask optional (C,)
    bool, kb <= min(KMAX, C). Returns (values (B, kb) float32, indices
    (B, kb) int32). Launches on the current stream and does not synchronise;
    raises on what the kernel does not take."""
    q = q.to(torch.float32).contiguous()
    c, d, b = _check(buf, inv_norms, q, kb, mask)
    if buf.device.type != "cuda":
        raise ValueError("the small-scan kernel runs on a CUDA device")
    count = max(0, min(int(count), c))
    with torch.cuda.device(buf.device):
        blocks, rows = plan(count, _blocks_for(buf.device, d, b, kb))
        cand = torch.empty((b, max(blocks, 1), kb), dtype=torch.int64, device=buf.device)
        vals = torch.empty((b, kb), dtype=torch.float32, device=buf.device)
        ids = torch.empty((b, kb), dtype=torch.int32, device=buf.device)
        err = _kernel_fn("small_scan_f32")(
            buf.data_ptr(), q.data_ptr(), inv_norms.data_ptr(),
            None if mask is None else mask.data_ptr(), cand.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), d, b, count, kb, blocks, rows,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"small_scan_f32: kernel launch failed (cudaError {err})")
    if blocks:
        LAUNCHES["small_scan_f32" if mask is None else "small_scan_f32_mask"] += 1
    LAUNCHES["small_scan_merge"] += 1
    return vals, ids


def _keys(scores: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit keys of (B, n) scores of rows 0 .. n-1, as signed
    int64 in the same order: the order-preserving int32 of score + 0.0 in
    the high word, 2^32 - 1 - row in the low."""
    bits = (scores + 0.0).contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    rows = torch.arange(scores.shape[-1], device=scores.device, dtype=torch.int64)
    return (ordered.to(torch.int64) << 32) | (0xFFFFFFFF - rows)


def small_scan_plain(buf, inv_norms, q, count, kb, mask=None, rows_per_block=None):
    """The kernel's arithmetic in plain PyTorch, on either device: scores
    as ``scan_topk`` computes them (the same expression), each block of
    ``rows_per_block`` rows of [0, count) keeps its top ``kb`` keys, the
    merge keeps the top ``kb`` of the blocks' lists, and the slots past the
    rows that exist get ``_MASKED_SCORE`` and their own slot number.
    ``rows_per_block`` defaults to ``plan``'s at ``_PLAIN_BLOCKS`` blocks.
    Returns (values (B, kb) float32, indices (B, kb) int32)."""
    c = buf.shape[0]
    b = q.shape[0]
    count = max(0, min(int(count), c))
    qn = scan_ops._normalize(q.to(torch.float32))
    scores = scan_ops.dots_f32(qn, buf) * inv_norms[None, :]
    valid = scan_ops._valid_rows(c, count, mask, buf.device)
    scores = scores.masked_fill(~valid[None, :], float(scan_ops._MASKED_SCORE))
    merged = torch.full((b, kb), _EMPTY, dtype=torch.int64, device=buf.device)
    if count > 0:
        rows = rows_per_block or plan(count, _PLAIN_BLOCKS)[1]
        blocks = -(-count // rows)
        keys = torch.full((b, blocks * rows), _EMPTY, dtype=torch.int64, device=buf.device)
        keys[:, :count] = _keys(scores[:, :count])
        lists = torch.topk(keys.view(b, blocks, rows), min(kb, rows), dim=-1).values
        top = torch.topk(lists.reshape(b, -1), min(kb, lists.shape[1] * lists.shape[2]),
                         dim=-1).values
        merged[:, :top.shape[1]] = top
    empty = merged == _EMPTY
    hi = (merged >> 32).to(torch.int32)
    vals = (hi ^ ((hi >> 31) & 0x7FFFFFFF)).view(torch.float32)
    ids = (0xFFFFFFFF - (merged & 0xFFFFFFFF)).to(torch.int32)
    slot = torch.arange(kb, device=buf.device, dtype=torch.int32).expand(b, kb)
    vals = vals.masked_fill(empty, float(scan_ops._MASKED_SCORE))
    return vals, torch.where(empty, slot, ids)
