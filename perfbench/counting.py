"""The yardstick's arithmetic: the card's peaks, the operations and bytes
each kernel call needs, and the model's FLOPs a token.

A roofline share is the least time the card could take for a call's work
(the larger of its operations over the peak rate and its bytes over the
memory bandwidth) over the call's device time. Bytes count each input
read once and each output written once; operations count only the
(query, key) pairs a causal mask lets through. ``flash_work`` is
``chip_smoke.py::_flash_work`` and ``rpa_work`` its ``_bound``, both
copied here so that the yardstick stays with the benchmark.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, fp32 on CUDA
#: cores, HBM3 bandwidth (at the card's 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(n_bytes: float, flops: float, dtype: str = "bfloat16") -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def causal_pairs(s_q: int, s_k: int, causal: bool = True) -> int:
    """(query, key) pairs visible when queries ``0 .. s_q - 1`` sit at key
    positions ``s_k - s_q ..``: query q sees ``clamp(q + s_k - s_q + 1, 0,
    s_k)`` keys."""
    if not causal:
        return s_q * s_k
    lo, hi = s_k - s_q + 1, s_k  # the unclamped counts of the first and last query
    inner_lo, inner_hi = max(lo, 0), min(hi, s_k)
    inner = (inner_lo + inner_hi) * (inner_hi - inner_lo + 1) // 2 if inner_hi >= inner_lo else 0
    return inner + max(0, hi - max(lo, s_k + 1) + 1) * s_k


def flash_work(kind: str, b: int, s_q: int, s_k: int, h: int, n_kv: int, d: int,
               causal: bool, elem: int) -> tuple[float, float]:
    """``(bytes, flops)`` of one K1 (``flash_fwd``), K2 (``flash_bwd_dq``) or
    K3 (``flash_bwd_dkv``) launch: q, k, v (and o, dO, LSE, Delta where the
    kernel reads them) read once, outputs written once; 2 products of 2·D
    flops a visible pair in K1, 3 in K2, 4 in K3."""
    pairs = causal_pairs(s_q, s_k, causal) * b * h
    qb, kb = b * s_q * h * d * elem, b * s_k * n_kv * d * elem
    rows = b * h * s_q * 4  # one fp32 LSE or Delta per query row
    if kind == "flash_fwd":
        return qb + 2 * kb + qb + rows, 4.0 * pairs * d
    if kind == "flash_bwd_dq":
        return qb + 2 * kb + qb + 2 * rows + qb, 6.0 * pairs * d
    if kind == "flash_bwd_dkv":
        return qb + 2 * kb + qb + 2 * rows + 2 * kb, 8.0 * pairs * d
    raise ValueError(f"unknown flash kernel {kind!r}")


def rpa_work(rows: list[tuple[int, int]], t: int, h: int, n_kv: int, d: int, elem: int,
             n_ctx: int, bs: int) -> tuple[float, float]:
    """``(bytes, flops)`` of one K4 call of ``t`` query columns a row.
    ``rows`` holds ``(queries, last position)`` of each row's real queries
    (consecutive positions ending at the last). Each row's live blocks up
    to its last position are read once as K and V, its queries read and
    its outputs written once, with the block table and the positions;
    flops count the causally visible (query, key) pairs."""
    kv_bytes = io_bytes = pairs = 0
    for n_q, last in rows:
        blocks = min(n_ctx, last // bs + 1)
        kv_bytes += blocks * bs * n_kv * d * elem * 2
        io_bytes += 2 * n_q * h * d * elem
        pairs += causal_pairs(n_q, last + 1)
    io_bytes += len(rows) * (n_ctx * 4 + t * 4)
    return float(kv_bytes + io_bytes), 4.0 * pairs * h * d


def matmul_params(m: dict) -> dict[str, float]:
    """Weights that enter a matrix product, by part, for an MPT config
    (``d_model``, ``n_layers``, ``n_heads``, ``expansion_ratio``,
    ``vocab_size``; a tied head is the embedding)."""
    d, L = m["d_model"], m["n_layers"]
    hidden = m.get("expansion_ratio", 4) * d
    block = d * 3 * d + d * d + 2 * d * hidden
    return {"blocks": float(L * block), "head": float(d * m["vocab_size"])}


def train_flops_per_token(m: dict, seq: int) -> float:
    """Training FLOPs a token, recomputation not counted: 6 × the matmul
    weights (the tied head included) + 6·L·d·S for causal attention (half
    the square, forward and backward). 854.9 MFLOP at mpt-125m, S = 2048."""
    p = matmul_params(m)
    return 6.0 * (p["blocks"] + p["head"]) + 6.0 * m["n_layers"] * m["d_model"] * seq


def forward_flops(m: dict, n_tokens: int, visible_keys: int, n_logits: int) -> float:
    """Forward FLOPs of ``n_tokens`` tokens through the blocks, attention
    over ``visible_keys`` (query, key) pairs summed over the tokens, and the
    head for ``n_logits`` rows."""
    p = matmul_params(m)
    attn = 4.0 * m["n_layers"] * m["d_model"] * visible_keys
    return 2.0 * p["blocks"] * n_tokens + attn + 2.0 * p["head"] * n_logits
