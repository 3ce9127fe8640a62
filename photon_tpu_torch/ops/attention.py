"""Attention helpers: ALiBi slopes, the dense attention oracle and the
``attn_impl`` dispatch of the training path."""

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


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, alibi: bool = False) -> torch.Tensor:
    """Plain softmax attention over ``[B, S, H, D]`` inputs (the port of
    ``photon_tpu/ops/attention.py:xla_attention``, the kernels' dense
    oracle): fp32 scores, the ALiBi bias ``-slope_h * (q_pos - k_pos)``
    with query positions aligned to the end of the keys (``s_k - s_q``),
    probabilities cast to V's dtype for the second product. k/v carry as
    many heads as q."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    q_pos = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
    k_pos = torch.arange(s_k, device=q.device)[None, :]
    if alibi:
        dist = (q_pos - k_pos).float()
        scores = scores - alibi_slopes(h, q.device)[None, :, None, None] * dist
    if causal:
        scores = scores.masked_fill(k_pos > q_pos, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        impl: str = "pallas", causal: bool = True,
                        alibi: bool = False) -> torch.Tensor:
    """Dispatch on ``impl`` (the JAX package's ``attn_impl`` values):
    ``pallas`` → the flash kernels K1–K3 (their plain versions for CPU
    tensors), which take grouped-query k/v natively; ``xla`` → the dense
    :func:`xla_attention`, with kv heads repeated up to the q heads here.
    ``ring`` needs a multi-device mesh, which this package does not have."""
    h_q, h_kv = q.shape[2], k.shape[2]
    if h_q % h_kv:
        raise ValueError(f"q heads ({h_q}) must be a multiple of kv heads ({h_kv})")
    if impl == "pallas":
        from photon_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, alibi=alibi)
    if impl == "xla":
        if h_kv != h_q:
            k = k.repeat_interleave(h_q // h_kv, dim=2)
            v = v.repeat_interleave(h_q // h_kv, dim=2)
        return xla_attention(q, k, v, causal=causal, alibi=alibi)
    if impl == "ring":
        raise NotImplementedError("attn_impl 'ring' (context parallelism) is not ported")
    raise ValueError(f"unknown attention impl {impl!r}")
