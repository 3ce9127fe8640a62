"""Parameter-payload manipulation on the codec's (metadata, flat array
list) form: momenta piggybacking and per-round layer personalization or
re-randomization.

The port of the parts of ``photon_tpu/train/param_ops.py`` the client
runtime uses. These are numpy, as in the JAX package, so a seeded
:func:`randomize_layers` draws the same values in both packages.
"""

from __future__ import annotations

import re

import numpy as np

from photon_tpu_torch.codec.params import M1_PREFIX, ParamsMetadata

M2_PREFIX = "__momenta_2__/"


def extend_with_momenta(
    metadata: ParamsMetadata,
    params: list[np.ndarray],
    m1: list[np.ndarray] | None = None,
    m2: list[np.ndarray] | None = None,
) -> tuple[ParamsMetadata, list[np.ndarray]]:
    """Append first/second momenta (zeros when not given) to a parameter
    payload: ``[params | m1 | m2]``."""
    m1 = m1 if m1 is not None else [np.zeros_like(p, dtype=np.float32) for p in params]
    m2 = m2 if m2 is not None else [np.zeros_like(p, dtype=np.float32) for p in params]
    if len(m1) != len(params) or len(m2) != len(params):
        raise ValueError("momenta length mismatch")
    names = (
        list(metadata.names)
        + [M1_PREFIX + n for n in metadata.names]
        + [M2_PREFIX + n for n in metadata.names]
    )
    arrays = list(params) + list(m1) + list(m2)
    return ParamsMetadata.from_ndarrays(names, arrays), arrays


def has_momenta(metadata: ParamsMetadata) -> bool:
    return any(n.startswith(M1_PREFIX) for n in metadata.names)


def split_momenta(
    metadata: ParamsMetadata, arrays: list[np.ndarray]
) -> tuple[ParamsMetadata, list[np.ndarray], list[np.ndarray], list[np.ndarray]]:
    """Inverse of :func:`extend_with_momenta`."""
    if len(arrays) % 3 or not has_momenta(metadata):
        raise ValueError("payload does not carry momenta")
    n = len(arrays) // 3
    base = ParamsMetadata.from_ndarrays(metadata.names[:n], arrays[:n])
    for name, expect in zip(metadata.names[n: 2 * n], base.names):
        if name != M1_PREFIX + expect:
            raise ValueError(f"momenta section misaligned at {name!r}")
    return base, arrays[:n], arrays[n: 2 * n], arrays[2 * n:]


def match_indices(metadata: ParamsMetadata, patterns: list[str]) -> list[int]:
    regs = [re.compile(p) for p in patterns]
    return [i for i, n in enumerate(metadata.names) if any(r.search(n) for r in regs)]


def randomize_layers(
    metadata: ParamsMetadata,
    arrays: list[np.ndarray],
    patterns: list[str],
    seed: int,
    stddev: float = 0.02,
) -> list[np.ndarray]:
    """Fresh values for the matching layers: 1-D ``scale`` tensors reset to
    ones, everything else drawn from N(0, stddev) with
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    out = list(arrays)
    for i in match_indices(metadata, patterns):
        a = arrays[i]
        if a.ndim <= 1 and "scale" in metadata.names[i]:
            out[i] = np.ones_like(a)
        else:
            out[i] = rng.normal(0.0, stddev, a.shape).astype(a.dtype)
    return out


def personalize_layers(
    metadata: ParamsMetadata,
    incoming: list[np.ndarray],
    local: list[np.ndarray] | None,
    patterns: list[str],
) -> list[np.ndarray]:
    """Keep the client's own values for the matching layers instead of
    the server's."""
    if local is None:
        return list(incoming)
    out = list(incoming)
    for i in match_indices(metadata, patterns):
        out[i] = local[i]
    return out
