"""Attention helpers shared by the serving step."""

from __future__ import annotations

import math

import torch


def alibi_slopes(n_heads: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Standard ALiBi head slopes ``2^(-8i/H)`` for i = 1..H, fp32 (the
    same closed form as ``photon_tpu/ops/attention.py:alibi_slopes``,
    including its rule for head counts that are not a power of two)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        slopes = pow2_slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        slopes = pow2_slopes(closest)
        slopes += pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32, device=device)
