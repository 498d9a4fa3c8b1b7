"""The yardstick against shapes worked out by hand."""

import pytest

from portbench import counts


def test_least_seconds_takes_the_larger_bound():
    # 495 GFLOP take 1 ms at the float32 (TF32) peak; 3.35 GB take 1 ms
    assert counts.least_seconds(495e9, 0) == pytest.approx(1e-3)
    assert counts.least_seconds(0, 3.35e9) == pytest.approx(1e-3)
    assert counts.least_seconds(495e9, 6.7e9) == pytest.approx(2e-3)
    assert counts.least_seconds(989e9, 0, "bfloat16") == pytest.approx(1e-3)
    assert counts.least_seconds(1979e9, 0, "int8") == pytest.approx(1e-3)


def test_phase1_of_the_1m_768_search():
    flops, nbytes = counts.phase1_work(1_000_000, 768, 256)
    assert flops == 2 * 1_000_000 * 768 * 256                   # 393.2 GFLOP
    # rows, their norms, the queries, one max a (query, 32-row subtile)
    assert nbytes == 1_000_000 * 768 * 4 + 1_000_000 * 4 + 256 * 768 * 4 + 256 * 31_250 * 4
    # bytes bound it: 3.108 GB at 3.35 TB/s = 0.928 ms; operations 0.794 ms
    assert counts.least_seconds(flops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert counts.least_seconds(flops, nbytes) == pytest.approx(0.9277e-3, rel=1e-3)


def test_scan_of_one_query_reads_the_corpus_once():
    flops, nbytes = counts.scan_work(1_000_000, 768, 1, 100)
    assert flops == 2 * 768 * 1_000_000
    assert nbytes == 1_000_000 * 768 * 4 + 1_000_000 * 4 + 768 * 4 + 100 * 12
    assert counts.least_seconds(flops, nbytes) == pytest.approx(0.9183e-3, rel=1e-3)


@pytest.mark.parametrize("kernel,products,tensors,stats", [
    ("forward", 2, 4, 0), ("forward_lse", 2, 4, 1), ("dkv", 4, 6, 2), ("dq", 3, 5, 2)])
def test_attention_counts_real_pairs_and_real_rows(kernel, products, tensors, stats):
    lengths = [512, 100]
    flops, nbytes = counts.attention_work(kernel, lengths, 16, 64)
    pairs = 512 * 512 + 100 * 100
    assert flops == 2 * products * 16 * 64 * pairs
    assert nbytes == tensors * 612 * 16 * 64 * 4 + stats * 612 * 16 * 4


def test_attention_of_an_embed_call():
    # 24 full chunks and 8 tails of 100 tokens: 26.1 GFLOP (52.7 us at the
    # TF32 peak) against q, k, v and o of 13,088 real tokens, 214 MB (64.0
    # us): the bytes bound it
    lengths = [512] * 24 + [100] * 8
    flops, nbytes = counts.attention_work("forward", lengths, 16, 64)
    assert flops == 4096 * (24 * 512 ** 2 + 8 * 100 ** 2)
    assert nbytes == 4 * 13_088 * 1024 * 4
    assert counts.least_seconds(flops, nbytes) == pytest.approx(64.01e-6, rel=1e-3)


def test_encoder_forward_flops_of_e5_large():
    assert counts.dense_weights(1024, 4096, 24) == 24 * (4 * 1024 ** 2 + 2 * 1024 * 4096)
    assert counts.dense_weights(1024, 4096, 24) == 301_989_888
    flops = counts.encoder_forward_flops([512], 1024, 4096, 24)
    assert flops == 2 * 301_989_888 * 512 + 4 * 1024 * 512 ** 2 * 24
    # one full chunk a second at the peak would be 0.13% of it
    assert counts.mfu_share(flops, 1.0) == pytest.approx(100 * flops / 495e12)


def test_roofline_share_is_least_over_measured():
    assert counts.roofline_share(1e-3, 4e-3) == pytest.approx(25.0)
