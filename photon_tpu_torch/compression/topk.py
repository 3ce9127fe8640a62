"""Top-k magnitude sparsification of flat delta vectors (the port's copy
of ``photon_tpu/compression/topk.py``).

Keeps the ``ratio`` fraction of entries with the largest magnitude —
``np.argpartition`` (O(n)) rather than a full sort; the kept indices are
returned sorted so the dense scatter on decode is cache-friendly and the
uint32 index stream compresses well downstream if anyone ever entropy-codes
it. Everything dropped is the caller's (error-feedback's) problem.
"""

from __future__ import annotations

import math

import numpy as np

INDEX_DTYPE = np.uint32


def topk_count(n: int, ratio: float) -> int:
    """Number of kept entries for an ``n``-element layer (always ≥ 1)."""
    if not 0.0 < ratio <= 1.0:
        raise ValueError(f"topk ratio must be in (0, 1], got {ratio}")
    return max(1, min(n, math.ceil(ratio * n)))


def topk_sparsify(flat: np.ndarray, ratio: float) -> tuple[np.ndarray, np.ndarray]:
    """Flat vector → ``(sorted uint32 indices, values at those indices)``."""
    flat = np.asarray(flat).reshape(-1)
    if flat.size > np.iinfo(INDEX_DTYPE).max:
        raise ValueError(f"layer of {flat.size} elements exceeds uint32 indexing")
    k = topk_count(flat.size, ratio)
    if k >= flat.size:
        idx = np.arange(flat.size, dtype=INDEX_DTYPE)
        return idx, flat.copy()
    part = np.argpartition(np.abs(flat), flat.size - k)[flat.size - k:]
    idx = np.sort(part).astype(INDEX_DTYPE)
    return idx, flat[idx]


def topk_densify(n: int, idx: np.ndarray, vals: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Inverse scatter: ``(indices, values)`` → dense flat vector of ``n``."""
    out = np.zeros(n, dtype=dtype)
    out[np.asarray(idx, dtype=np.int64)] = vals
    return out
