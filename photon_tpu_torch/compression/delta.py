"""Round-delta encoding: transmit ``w_new − w_global``, not ``w_new`` (the
port's copy of ``photon_tpu/compression/delta.py``).

The deltas are computed and carried in float64. For float32 inputs the
subtraction ``float64(a) − float64(r)`` is exact (both operands embed
exactly, and the difference of two float32 values is representable in
float64), and so is the decode-side ``float64(r) + delta``; casting the sum
back to float32 recovers ``a`` bit-for-bit. That makes the delta-only policy
*lossless* — the substrate the lossy stages (top-k, int8) build on, and the
reason error-feedback residual accounting balances to zero when they are
off.
"""

from __future__ import annotations

import numpy as np


def encode_delta(array: np.ndarray, reference: np.ndarray | None) -> np.ndarray:
    """Flat float64 delta (or the flat float64 values when no reference)."""
    a = np.asarray(array, dtype=np.float64).reshape(-1)
    if reference is None:
        return a
    r = np.asarray(reference, dtype=np.float64).reshape(-1)
    if r.shape != a.shape:
        raise ValueError(f"delta reference shape {r.shape} != array {a.shape}")
    return a - r


def decode_delta(delta: np.ndarray, reference: np.ndarray | None,
                 shape: tuple[int, ...], dtype: str) -> np.ndarray:
    """Inverse of :func:`encode_delta`: dense flat delta → decoded array."""
    d = np.asarray(delta, dtype=np.float64)
    if reference is not None:
        d = d + np.asarray(reference, dtype=np.float64).reshape(-1)
    return d.reshape(shape).astype(np.dtype(dtype))
