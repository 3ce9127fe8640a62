"""The yardstick's arithmetic against hand counts."""

import pytest

from perfbench import counting

MPT125M = dict(d_model=768, n_layers=12, n_heads=12, expansion_ratio=4, vocab_size=50368)


def _brute_pairs(s_q, s_k):
    return sum(min(s_k, max(0, q + (s_k - s_q) + 1)) for q in range(s_q))


@pytest.mark.parametrize("s_q,s_k", [(1, 1), (1, 9), (5, 5), (16, 40), (40, 16), (64, 64),
                                     (3, 2048), (2048, 2048)])
def test_causal_pairs(s_q, s_k):
    assert counting.causal_pairs(s_q, s_k) == _brute_pairs(s_q, s_k)
    assert counting.causal_pairs(s_q, s_k, causal=False) == s_q * s_k


def test_train_flops_per_token_at_mpt_125m():
    # 6 x (84,934,656 block + 38,682,624 tied head) + 6 x 12 x 768 x 2048
    assert counting.train_flops_per_token(MPT125M, 2048) == 854_949_888
    assert counting.train_flops_per_token(MPT125M, 2048) / 1e6 == pytest.approx(854.9, abs=0.05)


def test_k1_bound_at_the_125m_train_shape():
    """K1 at B=16 S=2048 H=12 D=64 causal, bf16: bound by operations,
    0.1043 ms (PERF.md's kernel table)."""
    n_bytes, flops = counting.flash_work("flash_fwd", 16, 2048, 2048, 12, 12, 64, True, 2)
    assert flops == 4.0 * 2048 * 2049 // 2 * 16 * 12 * 64
    assert counting.least_seconds(n_bytes, flops) * 1e3 == pytest.approx(0.1043, abs=5e-5)
    assert flops / counting.PEAK_FLOPS["bfloat16"] > n_bytes / counting.HBM_BYTES_PER_S
    k2 = counting.least_seconds(*counting.flash_work("flash_bwd_dq", 16, 2048, 2048, 12, 12,
                                                     64, True, 2))
    k3 = counting.least_seconds(*counting.flash_work("flash_bwd_dkv", 16, 2048, 2048, 12, 12,
                                                     64, True, 2))
    assert (k2 * 1e3, k3 * 1e3) == pytest.approx((0.1564, 0.2086), abs=5e-5)


def test_rpa_work_by_hand():
    # two decode rows at positions 15 and 16 (one and two live blocks of 16)
    n_bytes, flops = counting.rpa_work([(1, 15), (1, 16)], 1, 16, 16, 128, 2, 8, 16)
    kv = (16 + 32) * 16 * 128 * 2 * 2
    io = 2 * 2 * 16 * 128 * 2 + 2 * (8 * 4 + 4)
    assert n_bytes == kv + io and flops == 4.0 * (16 + 17) * 16 * 128
    # a chunk row of 4 queries at 30..33: 34 keys for the last, 3 blocks
    n_bytes, flops = counting.rpa_work([(4, 33)], 4, 16, 16, 128, 2, 8, 16)
    assert flops == 4.0 * (31 + 32 + 33 + 34) * 16 * 128
    assert n_bytes == 48 * 16 * 128 * 4 + 2 * 4 * 16 * 128 * 2 + 8 * 4 + 4 * 4


def test_forward_flops():
    p = counting.matmul_params(MPT125M)
    assert counting.forward_flops(MPT125M, 1, 0, 0) == 2 * p["blocks"]
    assert counting.forward_flops(MPT125M, 0, 10, 1) == 4 * 12 * 768 * 10 + 2 * p["head"]
