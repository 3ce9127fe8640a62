"""The codec pipeline: delta → error feedback → top-k → int8, per policy
(the port's copy of ``photon_tpu/compression/codec.py``: host numpy, the
same payload bytes for the same arrays and residual history).

Policies (``photon_tpu_torch.compression.POLICIES``):

- ``off``            — transport ships raw tensors (no codec object at all);
- ``delta``          — float64 round-deltas, *lossless* (see ``delta.py``);
- ``delta_q8``       — deltas, blockwise int8 (≈3.9× on fp32 payloads);
- ``delta_topk_q8``  — deltas, top-k sparsification, int8 on the kept
  values (ratio ``≈ 4 / (ratio·(5 + 4/block))`` — e.g. ≥6× at ratio ⅛).

Encoding always round-trips its own output locally to settle the
error-feedback residual, so the residual is exactly what the wire lost.
Non-float layers (none today; future-proofing for integer state riding a
payload) pass through uncompressed as ``raw`` blocks.

The codec is direction-agnostic: the *encoder* (client) sets its reference
to the round's broadcast before packaging results; the *decoder* (server)
sets its reference to the same arrays — its own pre-round global params —
when it broadcasts them. Both ends hold the reference already, so it never
travels with the payload.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Hashable

import numpy as np

if TYPE_CHECKING:  # annotation only — compression stays importable standalone
    from photon_tpu_torch.utils.hostpool import HostPool

from photon_tpu_torch.compression.delta import decode_delta, encode_delta
from photon_tpu_torch.compression.error_feedback import ErrorFeedback
from photon_tpu_torch.compression.payload import CompressedPayload, LayerBlock
from photon_tpu_torch.compression.quantize import DEFAULT_BLOCK, dequantize_q8, quantize_q8
from photon_tpu_torch.compression.topk import topk_densify, topk_sparsify


def policy_flags(policy: str) -> tuple[bool, bool, bool]:
    """``policy`` → ``(delta, topk, q8)`` stage switches."""
    table = {
        "off": (False, False, False),
        "delta": (True, False, False),
        "delta_q8": (True, False, True),
        "delta_topk_q8": (True, True, True),
    }
    if policy not in table:
        raise ValueError(f"unknown compression policy {policy!r} (want one of {sorted(table)})")
    return table[policy]


def make_codec(compression: Any) -> "Codec | None":
    """Build a :class:`Codec` from a policy string, a ``CompressionConfig``-
    shaped object (``policy`` / ``topk_ratio`` / ``q8_block_size`` /
    ``error_feedback`` attributes), an existing codec, or None. Returns None
    for policy ``off``."""
    if compression is None or isinstance(compression, Codec):
        return compression
    if isinstance(compression, str):
        return None if compression == "off" else Codec(policy=compression)
    if compression.policy == "off":
        return None
    return Codec(
        policy=compression.policy,
        topk_ratio=compression.topk_ratio,
        q8_block=compression.q8_block_size,
        error_feedback=compression.error_feedback,
        ef_max_clients=getattr(compression, "ef_max_clients", 16),
    )


class Codec:
    def __init__(
        self,
        policy: str = "delta_q8",
        # defaults mirror config.schema.CompressionConfig exactly, so the
        # string-policy construction path (make_codec("delta_topk_q8"))
        # behaves identically to the config path
        topk_ratio: float = 0.125,
        q8_block: int = DEFAULT_BLOCK,
        error_feedback: bool = True,
        ef_max_clients: int = 16,
    ) -> None:
        self.delta, self.topk, self.q8 = policy_flags(policy)
        if policy == "off":
            raise ValueError("policy 'off' means no codec — use make_codec()")
        self.policy = policy
        self.topk_ratio = topk_ratio
        self.q8_block = q8_block
        self.ef = ErrorFeedback(max_entries=ef_max_clients) if error_feedback else None
        self._reference: list[np.ndarray] | None = None

    # -- reference -------------------------------------------------------
    def set_reference(self, arrays: list[np.ndarray] | None) -> None:
        """Pin the round's global params as the delta base (both directions:
        the client encodes against the broadcast it received, the server
        decodes against the broadcast it sent)."""
        self._reference = None if arrays is None else [np.asarray(a) for a in arrays]

    def _matching_reference(self, arrays: list[np.ndarray]) -> list[np.ndarray] | None:
        ref = self._reference
        if ref is None or len(ref) != len(arrays):
            return None
        if any(r.shape != np.asarray(a).shape for r, a in zip(ref, arrays)):
            return None
        return ref

    # -- encode ----------------------------------------------------------
    def encode(self, metadata, arrays: list[np.ndarray],
               key: Hashable | None = None,
               pool: "HostPool | None" = None) -> CompressedPayload:
        """(metadata, arrays) → :class:`CompressedPayload`.

        ``key`` identifies the error-feedback residual stream (the client
        id); None disables residual accounting for this payload.

        Each float layer's float64 delta is compensated, encoded, locally
        round-tripped for its residual, and released: serially the peak
        fp64 working set is ONE layer, not a second full model copy. With
        ``pool`` (a :class:`~photon_tpu_torch.utils.hostpool.HostPool`) layers
        encode in parallel — the peak working set grows to at most
        ``pool.threads`` layers, still far below a model copy, and the
        layer/residual ORDER of the result is identical to the serial path
        (ordered map), so the wire bytes don't depend on threading.
        """
        metadata.validate_arrays(arrays)
        ref = self._matching_reference(arrays) if self.delta else None
        if ref is None and self.topk:
            # without a delta base, top-k would zero (1 − ratio) of the
            # ABSOLUTE weights — a destroyed model the server would decode
            # without error. Always a caller bug (the broadcast precedes
            # every fit), so refuse instead of degrading silently.
            raise RuntimeError(
                f"policy {self.policy!r} needs a matching delta reference "
                "(set_reference with the round's broadcast) — top-k over "
                "absolute weights would silently zero most of the model"
            )
        payload = CompressedPayload(policy=self.policy, has_delta=ref is not None)

        is_float = [np.issubdtype(np.dtype(d), np.floating) for d in metadata.dtypes]
        # lossless policies (no top-k, no quantization) have identically
        # zero residuals — don't burn a model-sized fp32 copy tracking them
        track_ef = (self.ef is not None and key is not None
                    and (self.topk or self.q8))
        old_res = None
        if track_ef:
            old_res = self.ef.matching_residual(
                key,
                [int(np.prod(s, dtype=np.int64))
                 for s, f in zip(metadata.shapes, is_float) if f],
            )
        # float-layer index per layer (residual streams cover float layers only)
        j_of: list[int] = []
        j = 0
        for f in is_float:
            j_of.append(j)
            if f:
                j += 1

        def _encode_layer(i: int) -> tuple[LayerBlock, np.ndarray | None]:
            name, shape, dtype = metadata.names[i], metadata.shapes[i], metadata.dtypes[i]
            if not is_float[i]:
                # non-float passthrough: raw bytes, no delta/quant
                return LayerBlock(
                    name=name, shape=tuple(shape), dtype=dtype,
                    encoding="raw", quant="none",
                    segments={"raw": np.ascontiguousarray(arrays[i]).reshape(-1)},
                ), None
            delta = encode_delta(arrays[i], ref[i] if ref is not None else None)
            if old_res is not None:
                delta = delta + old_res[j_of[i]].astype(np.float64)
            block = self._encode_float_layer(name, tuple(shape), dtype, delta)
            res = None
            if track_ef:
                res = (delta - self._decode_float_layer(block)).astype(np.float32)
            return block, res

        if pool is not None and pool.pipelined:
            encoded = pool.map(_encode_layer, range(len(arrays)))
        else:
            encoded = [_encode_layer(i) for i in range(len(arrays))]
        payload.layers.extend(block for block, _ in encoded)
        if track_ef:
            self.ef.store(key, [r for _, r in encoded if r is not None])
        return payload

    def _encode_float_layer(self, name: str, shape: tuple[int, ...], dtype: str,
                            delta: np.ndarray) -> LayerBlock:
        segments: dict[str, np.ndarray] = {}
        if self.topk:
            idx, vals = topk_sparsify(delta, self.topk_ratio)
            segments["idx"] = idx
            encoding = "topk"
        else:
            vals = delta
            encoding = "dense"
        quant = "none"
        if self.q8:
            codes, scales = quantize_q8(vals, self.q8_block)
            segments["q"] = codes
            segments["scales"] = scales
            quant = "q8"
        elif self.topk:
            segments["vals"] = vals.astype(np.float32)
        else:
            # pure delta mode: float64 keeps the round-trip exact
            segments["vals"] = vals.astype(np.float64)
        return LayerBlock(
            name=name, shape=shape, dtype=dtype, encoding=encoding,
            quant=quant, q8_block=self.q8_block if quant == "q8" else 0,
            segments=segments,
        )

    # -- decode ----------------------------------------------------------
    def decode(self, payload: CompressedPayload,
               pool: "HostPool | None" = None) -> list[np.ndarray]:
        """Payload → full arrays, one layer at a time (the aggregation path
        calls this per client, so at most one dense decode is live). With
        ``pool``, layers dequantize in parallel (all reads: the reference
        and the payload's wire segments are never mutated); the output
        order matches the serial path exactly."""
        ref = self._reference
        if payload.has_delta:
            if ref is None:
                raise RuntimeError(
                    "payload is delta-encoded but the codec has no reference "
                    "(set_reference with the round's broadcast params first)"
                )
            if len(ref) != len(payload.layers):
                raise ValueError(
                    f"reference has {len(ref)} arrays, payload {len(payload.layers)}"
                )

        def _decode_layer(i: int) -> np.ndarray:
            block = payload.layers[i]
            if block.encoding == "raw":
                return block.segments["raw"].reshape(block.shape).copy()
            dense = self._decode_float_layer(block)
            r = ref[i] if payload.has_delta else None
            return decode_delta(dense, r, block.shape, block.dtype)

        if pool is not None and pool.pipelined:
            return pool.map(_decode_layer, range(len(payload.layers)))
        return [_decode_layer(i) for i in range(len(payload.layers))]

    def _decode_float_layer(self, block: LayerBlock) -> np.ndarray:
        """One layer's flat float64 dense delta from its wire segments."""
        if block.quant == "q8":
            vals = dequantize_q8(
                block.segments["q"], block.segments["scales"], block.q8_block
            ).astype(np.float64)
        else:
            vals = block.segments["vals"].astype(np.float64)
        if block.encoding == "topk":
            return topk_densify(block.size, block.segments["idx"], vals)
        return vals


def decode_payload(payload: CompressedPayload,
                   reference: list[np.ndarray] | None) -> list[np.ndarray]:
    """One-shot decode without holding a codec (e.g. offline inspection)."""
    codec = Codec(policy=payload.policy if payload.policy != "off" else "delta",
                  error_feedback=False)
    codec.set_reference(reference)
    return codec.decode(payload)
