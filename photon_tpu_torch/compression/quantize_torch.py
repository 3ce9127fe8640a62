"""The blockwise-int8 quantizer as torch ops, for the collective plane (the
port of ``photon_tpu/compression/quantize_jnp.py``).

The device aggregation plane (``parallel/collective_agg.py``) quantizes
each client's contribution before the cross-client exchange. It must be
the same codec as the host wire path (:mod:`.quantize`), so that the
error analysis carries over: these functions give the same int8 codes and
fp32 scales as :func:`~.quantize.quantize_q8`, byte for byte, on CPU and
CUDA tensors, the ragged last block and all-zero blocks (scale 0)
included.

Port parity: ``torch.round`` rounds half to even, as ``np.rint`` does; the
clip bound is the float ``±127.0``; both divisions divide by a tensor on
the input's device, never by a Python scalar, because on a CUDA tensor
PyTorch turns division by a CPU scalar into a multiply by its reciprocal,
which rounds differently.
"""

from __future__ import annotations

import torch

from photon_tpu_torch.compression.quantize import _QMAX, DEFAULT_BLOCK


def quantize_q8_torch(values: torch.Tensor, block: int = DEFAULT_BLOCK
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat fp vector → ``(int8 codes, fp32 per-block scales)`` on the
    input's device."""
    if block < 1:
        raise ValueError(f"q8 block must be >= 1, got {block}")
    flat = values.reshape(-1).to(torch.float32)
    n = flat.numel()
    n_blocks = max(1, -(-n // block))
    pad = n_blocks * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    grid = flat.reshape(n_blocks, block)
    absmax = grid.abs().amax(dim=1)
    scales = absmax / torch.full_like(absmax, _QMAX)
    # all-zero blocks: scale 0; the divisor is guarded so codes stay 0
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))[:, None]
    codes = torch.clamp(torch.round(grid / safe), -_QMAX, _QMAX).to(torch.int8)
    return codes.reshape(-1)[:n], scales


def dequantize_q8_torch(codes: torch.Tensor, scales: torch.Tensor,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Inverse of :func:`quantize_q8_torch`; a flat fp32 vector."""
    codes = codes.reshape(-1)
    n = codes.numel()
    n_blocks = max(1, -(-n // block))
    if scales.numel() != n_blocks:
        raise ValueError(f"expected {n_blocks} scales for {n} codes, got {scales.numel()}")
    flat = codes.to(torch.float32)
    pad = n_blocks * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = flat.reshape(n_blocks, block) * scales.to(torch.float32)[:, None]
    return out.reshape(-1)[:n]
