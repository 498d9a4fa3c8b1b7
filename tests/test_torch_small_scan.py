"""ops/small_scan.py: the small-batch float32 scan with its top-k inside
(csrc/small_scan.cu), its plain version, its route and its plan.

On the CPU the plain version (per-block top-k of the kernel's 64-bit keys,
then the merge) is held to ``topk_last_axis`` over the plain scores, which
both compute with the same expression, so values and ids are equal exactly.
The tests marked ``cuda`` hold the kernel to its plain version and to a
float64 top-k on the card; they skip elsewhere (chip_smoke.py's kernel row
checks the kernel at the benchmark's shape too). No JAX here: the card tests
run where JAX is absent."""

import os
import tempfile

import numpy as np
import pytest
import torch

from minivectordb_tpu_torch import VectorDatabase
from minivectordb_tpu_torch.core import store as tstore
from minivectordb_tpu_torch.ops import fused_scan as tfused
from minivectordb_tpu_torch.ops import scan as tscan
from minivectordb_tpu_torch.ops import small_scan

MASKED = float(tscan._MASKED_SCORE)


def _plain_route(buf, inv, q, count, kb, mask=None):
    """scan_topk's plain route, whatever the device (what a CPU tensor takes)."""
    c = buf.shape[0]
    qn = tscan._normalize(q.to(torch.float32))
    scores = tscan.dots_f32(qn, buf) * inv[None, :]
    valid = tscan._valid_rows(c, count, mask, buf.device)
    scores = scores.masked_fill(~valid[None, :], MASKED)
    vals, idx = tscan.topk_last_axis(scores, kb)
    return vals, idx.to(torch.int32)


def _case(seed, c, d, b, dup=(), masked_share=0.0):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((c, d)).astype(np.float32)
    for a, z in dup:
        buf[z] = buf[a]
    q = rng.standard_normal((b, d)).astype(np.float32)
    buf_t = torch.from_numpy(buf)
    mask = None
    if masked_share:
        mask = torch.from_numpy(rng.random(c) >= masked_share)
    return buf_t, tscan.row_inv_norms(buf_t), torch.from_numpy(q), mask


def _same(got, want):
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    assert torch.equal(got[0], want[0])  # -0.0 == +0.0 here, as in the ranking


@pytest.mark.parametrize("b", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("kb,count,rows", [
    (1, 3000, 256),      # one key a block
    (16, 3000, 300),     # count not a whole number of blocks
    (128, 2999, 1000),   # kb wider than nothing, several blocks
    (128, 100, 37),      # kb above the live rows: sentinel slots by row
    (64, 0, 256),        # no live row: the merge alone
    (200, 3072, 3072),   # one block
])
@pytest.mark.parametrize("masked", [0.0, 0.6])
def test_plain_version_equals_topk_last_axis(b, kb, count, rows, masked):
    buf, inv, q, mask = _case(b * 7 + kb + count, 3072, 24, b, masked_share=masked)
    want = _plain_route(buf, inv, q, count, kb, mask)
    got = small_scan.small_scan_plain(buf, inv, q, count, kb, mask, rows_per_block=rows)
    _same(got, want)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    # and the scan_topk entry point on the CPU keeps its plain route
    _same(tscan.scan_topk(buf, inv, q, count, kb, mask), want)


def test_ties_across_blocks_and_the_kth_place():
    """Rows duplicated across block boundaries score alike: the lower row
    wins, also where the tie straddles the kb-th place."""
    c, d, rows = 2048, 16, 100
    dup = [(5, 5 + rows * j) for j in range(1, 12)] + [(7, 7 + rows * j) for j in range(1, 12)]
    buf, inv, q, _ = _case(3, c, d, 2, dup=dup)
    q[0] = buf[5]  # the 12 copies of row 5 tie at the top
    q[1] = buf[7]
    for kb in (4, 12, 13, 30):
        want = _plain_route(buf, inv, q, c, kb)
        got = small_scan.small_scan_plain(buf, inv, q, c, kb, rows_per_block=rows)
        _same(got, want)
    top = small_scan.small_scan_plain(buf, inv, q, c, 4, rows_per_block=rows)[1]
    assert top[0].tolist() == [5, 105, 205, 305]


def test_signed_zero_scores_rank_as_one():
    """-0.0 and +0.0 are the same score: rows scored 0 with either sign rank
    by row (row scales of 0 give dot * 0, signed like the dot)."""
    c, d = 1024, 8
    buf, inv, q, _ = _case(4, c, d, 1)
    inv = torch.zeros_like(inv)  # every score is +0.0 or -0.0
    inv[900:] = 1.0  # these rows score their cosine: some above 0, some below
    scores = tscan.dots_f32(tscan._normalize(q), buf) * inv[None, :]
    assert bool((scores[0, :900] == 0).all())
    assert bool(torch.signbit(scores[0, :900]).any()) and not bool(
        torch.signbit(scores[0, :900]).all())
    n_pos = int((scores[0] > 0).sum())
    for kb in (n_pos + 5, n_pos + 300):
        want = _plain_route(buf, inv, q, c, kb)
        got = small_scan.small_scan_plain(buf, inv, q, c, kb, rows_per_block=128)
        _same(got, want)
        assert got[1][0, n_pos:].tolist() == list(range(kb - n_pos))


def test_wholly_masked_block_and_count_inside_a_block():
    c, d, rows = 4096, 12, 512
    buf, inv, q, _ = _case(5, c, d, 3)
    mask = torch.ones(c, dtype=torch.bool)
    mask[512:1024] = False   # the second block wholly masked
    mask[3000:3100] = False  # part of another
    for count, kb in ((3333, 64), (700, 1024), (40, 64)):
        want = _plain_route(buf, inv, q, count, kb, mask)
        got = small_scan.small_scan_plain(buf, inv, q, count, kb, mask, rows_per_block=rows)
        _same(got, want)
    # count 700 < kb 1024: rows 0-511 score, then the masked rows 512-699 and
    # the rows past count as the sentinel, by row
    vals, ids = small_scan.small_scan_plain(buf, inv, q, 700, 1024, mask, rows_per_block=rows)
    assert bool((vals[:, :512] > MASKED).all()) and bool((vals[:, 512:] == MASKED).all())
    assert ids[0, 512:].tolist() == list(range(512, 1024))


@pytest.mark.parametrize("device_type,dtype,batch,kb,want", [
    ("cuda", torch.float32, 1, 128, True),
    ("cuda", torch.float32, 8, 1024, True),
    ("cuda", torch.float32, 8, 1, True),
    ("cuda", torch.float32, 9, 128, False),     # the fused route's, or the plain one's
    ("cuda", torch.float32, 0, 128, False),
    ("cuda", torch.float32, 4, 2048, False),    # wider than the kernel's lists
    ("cuda", torch.bfloat16, 1, 128, False),    # bfloat16 / int8 small batches: plain
    ("cuda", torch.int8, 1, 128, False),
    ("cpu", torch.float32, 1, 128, False),      # CPU tensors: plain
])
def test_route(device_type, dtype, batch, kb, want):
    assert small_scan.takes_kernel(device_type, dtype, batch, kb) is want


@pytest.mark.parametrize("count,max_blocks", [
    (1, 264), (255, 264), (257, 264), (1_000_000, 264), (1_000_000, 132),
    (67_589, 264), (264 * 256, 264), (5_000_000, 1024), (300, 1),
])
def test_plan(count, max_blocks):
    blocks, rows = small_scan.plan(count, max_blocks)
    assert 1 <= blocks <= max_blocks
    assert blocks * rows >= count and (blocks - 1) * rows < count  # none empty
    assert rows >= min(count, small_scan.MIN_BLOCK_ROWS)
    assert small_scan.plan(0, max_blocks) == (0, 0)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    buf, inv, q, _ = _case(6, 512, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        small_scan.small_scan_topk(buf, inv, q, 512, 8)
    with pytest.raises(ValueError, match="kb"):
        small_scan.small_scan_topk(buf, inv, q, 512, 513)
    with pytest.raises(ValueError, match="B="):
        small_scan.small_scan_topk(buf, inv, torch.zeros((9, 8)), 512, 8)
    with pytest.raises(TypeError):
        small_scan.small_scan_topk(buf.to(torch.bfloat16), inv, q, 512, 8)


def test_small_batches_reach_the_scan_unpadded(monkeypatch):
    """The small route takes the real queries alone; batches of 9-15 still
    pad to 16 and take the fused route, as the route is chosen on the padded
    size."""
    small, fused = [], []
    real_scan, real_fused = tscan.scan_topk, tfused.fused_scan_topk

    def spy_scan(buf, inv, q, *a, **kw):
        small.append(q.shape[0])
        return real_scan(buf, inv, q, *a, **kw)

    def spy_fused(buf, inv, q, *a, **kw):
        fused.append(q.shape[0])
        return real_fused(buf, inv, q, *a, **kw)

    monkeypatch.setattr(tstore.scan_ops, "scan_topk", spy_scan)
    monkeypatch.setattr(tstore.fused_scan, "fused_scan_topk", spy_fused)
    rng = np.random.default_rng(7)
    ts = tstore.VectorStore(8, device="cpu")
    rows = rng.standard_normal((4096, 8)).astype(np.float32)
    ts.append(rows)
    snap = ts.snapshot()
    for b in (1, 3, 8, 9, 15):
        qs = rng.standard_normal((b, 8)).astype(np.float32)
        for queries in (qs, torch.from_numpy(qs)):
            vals, ids = snap._device_search(queries, 4)
            assert vals.shape == (b, 4)
            want = _plain_route(torch.from_numpy(rows), tscan.row_inv_norms(
                torch.from_numpy(rows)), torch.from_numpy(qs), 4096, 4)
            assert np.array_equal(np.asarray(ids), want[1].numpy())
    one = snap._device_search(rows[3], 4)  # a single 1-D query
    assert one[1][0][0] == 3
    assert small == [1, 1, 3, 3, 8, 8, 1]
    assert fused == [16, 16, 16, 16]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs these checks")
    return torch.device("cuda")


def _hold(got, want, scores, what, tol=2e-6):
    """Kernel against plain where the two sum each dot in another order:
    values position by position within tol; every id distinct, its score
    what the kernel says; each kernel hit at least the plain kb-th score
    less tol (near-ties may trade places across the kb-th)."""
    gv, gi = got[0].cpu(), got[1].cpu().long()
    wv = want[0].cpu()
    assert float((gv - wv).abs().max()) <= tol, (what, float((gv - wv).abs().max()))
    for row in range(gi.shape[0]):
        assert len(set(gi[row].tolist())) == gi.shape[1], (what, "repeated id")
    own = torch.gather(scores.cpu(), 1, gi)
    assert float((own - gv).abs().max()) <= tol, what
    assert bool((own >= wv[:, -1:] - tol).all()), what


def _card_case(dev, c, d, b, count, masked, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn((c, d), device=dev, generator=g)
    buf[count:] = 0.0
    q = torch.randn((b, d), device=dev, generator=g)
    mask = (torch.rand(c, device=dev, generator=g) >= 0.5) if masked else None
    return buf, tscan.row_inv_norms(buf), q, mask


@pytest.mark.cuda
@pytest.mark.parametrize("d", [25, 384, 1024, 1100])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_equals_plain_on_the_card(d, b, masked):
    dev = _card()
    c, count, kb = 65_536, 60_001, 128
    buf, inv, q, mask = _card_case(dev, c, d, b, count, masked, d + b)
    got = small_scan.small_scan_topk(buf, inv, q, count, kb, mask)
    want = small_scan.small_scan_plain(buf, inv, q, count, kb, mask)
    scores = tscan.dots_f32(tscan._normalize(q), buf) * inv[None, :]
    scores = scores.masked_fill(~tscan._valid_rows(c, count, mask, dev)[None, :], MASKED)
    _hold(got, want, scores, f"d={d} b={b} masked={masked}")


@pytest.mark.cuda
def test_kernel_ties_and_sentinels_exact_on_the_card():
    """Integer rows against queries of norm 4 score exactly in any summation
    order, so the kernel's ids and values equal the plain route's bit for
    bit: duplicates across blocks, ties at the kb-th place, rows scaled by 0
    (+0.0 / -0.0), a masked block, kb above the live rows."""
    dev = _card()
    rng = np.random.default_rng(11)
    c, d = 8192, 16
    rows = rng.integers(-3, 4, size=(c, d)).astype(np.float32)
    rows[1000::700] = rows[3]
    q = rng.choice([-1.0, 1.0], size=(8, d)).astype(np.float32)
    q[0] = np.sign(rows[3]) + (rows[3] == 0)
    buf = torch.from_numpy(rows).to(dev)
    inv = torch.full((c,), 0.5, device=dev)
    inv[4000:4100] = 0.0
    mask = torch.ones(c, dtype=torch.bool, device=dev)
    mask[300:600] = False
    qt = torch.from_numpy(q).to(dev)
    for b, count, kb, m in ((8, c, 128, None), (8, 7777, 1024, mask), (1, 50, 64, mask),
                            (3, 5000, 300, None), (2, 0, 16, None)):
        got = small_scan.small_scan_topk(buf, inv, qt[:b], count, kb, m)
        want = _plain_route(buf, inv, qt[:b], count, kb, m)
        torch.cuda.synchronize()
        assert torch.equal(got[1].cpu(), want[1].cpu()), (b, count, kb)
        assert torch.equal(got[0].cpu(), want[0].cpu()), (b, count, kb)


@pytest.mark.cuda
def test_kernel_at_the_benchmark_shape_against_float64():
    """1M x 768, k = 100 (kb = 128), B = 1 and 8: the kernel against its
    plain version and the float64 top-k."""
    dev = _card()
    c, d, count, kb = 1 << 20, 768, 1_000_000, 128
    buf, inv, q, _ = _card_case(dev, c, d, 8, count, False, 5)
    for b in (1, 8):
        got = small_scan.small_scan_topk(buf, inv, q[:b], count, kb)
        want = small_scan.small_scan_plain(buf, inv, q[:b], count, kb)
        s64 = (tscan._normalize(q[:b]).double() @ buf[:count].double().T) * inv[:count].double()
        scores = tscan.dots_f32(tscan._normalize(q[:b]), buf) * inv[None, :]
        _hold(got, want, scores, f"1M x 768 b={b}")
        best = torch.topk(s64, 100, dim=1).values
        gap = (got[0][:, :100].double() - best).abs().max()
        assert float(gap) <= 1e-6, float(gap)
        del s64, scores


@pytest.mark.cuda
def test_serial_search_launches_the_kernel_on_the_card():
    """find_most_similar over a float32 database past the host route's
    bound: every call launches the small scan's two kernels, the scan (its
    masked form under a filter) and the merge."""
    dev = _card()
    rng = np.random.default_rng(12)
    n, d = 400_000, 768  # 1.2 GB: over the 1 GiB host-scan bound
    corpus = rng.standard_normal((n, d), dtype=np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        db = VectorDatabase(storage_file=os.path.join(tmp, "s.pkl"), device=str(dev))
        db.store_embeddings_batch(list(range(n)), corpus, [{"i": i} for i in range(n)])
        db.find_most_similar(corpus[0], k=100)
        small_scan.reset_launches()
        for j in range(5):
            ids, scores, _ = db.find_most_similar(corpus[j], k=100)
            assert ids[0] == j
        assert small_scan.LAUNCHES == {"small_scan_f32": 5, "small_scan_f32_mask": 0,
                                       "small_scan_merge": 5}
        db.find_most_similar(corpus[1], k=10, metadata_filter={"i": {"$lt": 1000}})
        assert small_scan.LAUNCHES == {"small_scan_f32": 5, "small_scan_f32_mask": 1,
                                       "small_scan_merge": 6}
