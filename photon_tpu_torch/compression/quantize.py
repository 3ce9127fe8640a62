"""Blockwise int8 quantization with per-block fp32 absmax scales (the
port's copy of ``photon_tpu/compression/quantize.py``).

Split a flat value vector into blocks of ``block`` elements, scale each
block by its absmax so the largest magnitude maps to ±127, and round to
int8. One fp32 scale per block keeps the overhead
at ``4 / block`` bytes per value (≈1.6% at the default block of 256).

Error bound: per element, ``|x − dequant(quant(x))| ≤ scale/2 =
absmax(block)/254`` — all-zero blocks get scale 0 and reproduce exactly.
"""

from __future__ import annotations

import numpy as np

DEFAULT_BLOCK = 256
_QMAX = 127.0


def quantize_q8(values: np.ndarray, block: int = DEFAULT_BLOCK) -> tuple[np.ndarray, np.ndarray]:
    """Flat fp vector → ``(int8 codes, fp32 per-block scales)``."""
    if block < 1:
        raise ValueError(f"q8 block must be >= 1, got {block}")
    flat = np.asarray(values, dtype=np.float32).reshape(-1)
    n = flat.size
    n_blocks = max(1, -(-n // block))
    aligned = bool(n) and n % block == 0
    if aligned:
        # block-aligned input (every wire-encode of a pow2-sized layer):
        # reshape is a view — the full-size padded fp32 copy never exists
        grid = flat.reshape(n_blocks, block)
    else:
        padded = np.zeros(n_blocks * block, dtype=np.float32)
        padded[:n] = flat
        grid = padded.reshape(n_blocks, block)
    absmax = np.abs(grid).max(axis=1)
    scales = (absmax / _QMAX).astype(np.float32)
    # all-zero blocks: scale 0; divide guarded so codes stay 0
    safe = np.where(scales > 0, scales, 1.0)[:, None]
    codes = np.clip(np.rint(grid / safe), -_QMAX, _QMAX).astype(np.int8)
    # codes is freshly allocated either way; only the ragged tail needs the
    # defensive copy (slicing a view of the padded grid)
    return (codes.reshape(-1) if aligned else codes.reshape(-1)[:n].copy()), scales


def dequantize_q8(codes: np.ndarray, scales: np.ndarray, block: int = DEFAULT_BLOCK) -> np.ndarray:
    """Inverse of :func:`quantize_q8`; returns a flat fp32 vector."""
    codes = np.asarray(codes, dtype=np.int8).reshape(-1)
    n = codes.size
    n_blocks = max(1, -(-n // block))
    scales = np.asarray(scales, dtype=np.float32)
    if scales.size != n_blocks:
        raise ValueError(f"expected {n_blocks} scales for {n} codes, got {scales.size}")
    if n and n % block == 0:
        # aligned: astype already allocates the fresh fp32 buffer — skip the
        # extra zero-filled copy the ragged path pays for the padding
        out = codes.astype(np.float32).reshape(n_blocks, block) * scales[:, None]
        return out.reshape(-1)
    padded = np.zeros(n_blocks * block, dtype=np.float32)
    padded[:n] = codes.astype(np.float32)
    out = padded.reshape(n_blocks, block) * scales[:, None]
    return out.reshape(-1)[:n].copy()
