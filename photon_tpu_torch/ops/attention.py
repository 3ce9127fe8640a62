"""Attention helpers: ALiBi slopes, the dense attention oracle and the
``attn_impl`` dispatch of the training path."""

from __future__ import annotations

import math

import torch

from photon_tpu_torch.ops import flash_attention as _flash
from photon_tpu_torch.ops.ring_attention import ring_attention
from photon_tpu_torch.parallel.context import current_mesh


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


def _rep(x: torch.Tensor, h_q: int) -> torch.Tensor:
    return x.repeat_interleave(h_q // x.shape[2], dim=2) if x.shape[2] != h_q else x


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        impl: str = "pallas", causal: bool = True,
                        alibi: bool = False) -> torch.Tensor:
    """Dispatch on ``impl`` (the JAX package's ``attn_impl`` values):
    ``pallas`` → the flash kernels K1–K3 (their plain versions for CPU
    tensors), which take grouped-query k/v natively; ``xla`` → the dense
    :func:`xla_attention`, with kv heads repeated up to the q heads here;
    ``ring`` → ring attention over the ambient mesh's ``sequence`` axis
    (``parallel/context.py``), ``pallas`` when that axis is 1.

    Under an ambient mesh whose batch (``data``, ``fsdp``, ``expert``) or
    ``tensor`` axis is larger than 1, ``pallas`` runs the kernels on each
    position's batch rows and heads, on its device
    (:func:`sharded_flash_attention`): exact, as attention is independent
    per row and per head. Where the kv heads do not split over ``tensor``,
    kv is repeated up to the q heads first (ring and flash alike)."""
    h_q, h_kv = q.shape[2], k.shape[2]
    if h_q % h_kv:
        raise ValueError(f"q heads ({h_q}) must be a multiple of kv heads ({h_kv})")
    if impl in ("pallas", "ring"):
        mesh = current_mesh()
        if impl == "ring" and mesh is not None and mesh.shape["sequence"] > 1:
            if h_kv % mesh.shape["tensor"]:
                k, v = _rep(k, h_q), _rep(v, h_q)
            return ring_attention(q, k, v, mesh, causal=causal, impl="pallas", alibi=alibi)
        if mesh is not None and any(mesh.shape[a] > 1 for a in ("data", "fsdp", "expert",
                                                                "tensor")):
            return sharded_flash_attention(q, k, v, mesh, causal=causal, alibi=alibi)
        return _flash.flash_attention(q, k, v, causal=causal, alibi=alibi)
    if impl == "xla":
        return xla_attention(q, _rep(k, h_q), _rep(v, h_q), causal=causal, alibi=alibi)
    raise ValueError(f"unknown attention impl {impl!r}")


def sharded_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                            causal: bool = True, alibi: bool = False) -> torch.Tensor:
    """Flash attention over global ``[B, S, H, D]`` tensors on ``mesh``:
    the batch rows split over ``data × fsdp × expert`` and the heads over
    ``tensor``, each slice through K1–K3 on its position's device. It is
    :func:`~photon_tpu_torch.ops.ring_attention.ring_attention` without a
    ring axis (the sequence is not split: a replica over that axis would
    compute the same slice), so the split, the global ALiBi slopes and the
    per-group kernels are the ring's and the meshed train step's
    (``parallel/spmd.py`` calls the same ``ring_chunks``). kv is repeated
    up to the q heads where its heads do not split over ``tensor``. The
    output comes back on q's device."""
    if k.shape[2] % mesh.shape["tensor"]:
        k, v = _rep(k, q.shape[2]), _rep(v, q.shape[2])
    return ring_attention(q, k, v, mesh, causal=causal, impl="pallas", axis_name=None,
                          batch_axes=("data", "fsdp", "expert"), alibi=alibi)
