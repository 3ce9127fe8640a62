"""Versioned, self-describing container for compressed parameter payloads
(the port's copy of ``photon_tpu/compression/payload.py``: the same bytes).

Layout: ``b"PCMP" | u16 version | u32 header_len | header JSON | segments``.
The header describes the policy, whether the payload is a delta against a
reference, and one entry per layer: name, shape, logical dtype, the encoding
stages applied, and the (kind, dtype, nbytes) manifest of its wire segments
— so a reader needs nothing but these bytes to reconstruct every array
(the reference for delta decoding travels out of band, by design: it is the
round's broadcast, which both ends already hold).

Segment kinds: ``idx`` (top-k indices, uint32), ``vals`` (uncompressed
values), ``q`` (int8 codes), ``scales`` (fp32 per-block scales), ``raw``
(non-float passthrough bytes).
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np

MAGIC = b"PCMP"
PAYLOAD_VERSION = 1
_HEAD = struct.Struct("<4sHI")

#: segment kinds a layer may carry, in serialization order
SEGMENT_KINDS = ("idx", "vals", "q", "scales", "raw")


@dataclasses.dataclass
class LayerBlock:
    """One layer's encoded form: metadata + named wire segments."""

    name: str
    shape: tuple[int, ...]
    dtype: str  # logical dtype of the decoded array
    encoding: str  # "dense" | "topk" | "raw"
    quant: str  # "none" | "q8"
    q8_block: int = 0  # values per scale block (quant == "q8")
    segments: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def raw_nbytes(self) -> int:
        return self.size * np.dtype(self.dtype).itemsize

    @property
    def wire_nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.segments.values())


@dataclasses.dataclass
class CompressedPayload:
    """The whole-payload container written to the transport plane."""

    policy: str
    has_delta: bool  # arrays are deltas against the round's broadcast
    layers: list[LayerBlock] = dataclasses.field(default_factory=list)
    version: int = PAYLOAD_VERSION

    @property
    def raw_nbytes(self) -> int:
        """Bytes the payload would occupy uncompressed (from the metadata)."""
        return sum(b.raw_nbytes for b in self.layers)

    @property
    def wire_nbytes(self) -> int:
        """Bytes actually on the wire (header + segments)."""
        return _HEAD.size + len(self._header_bytes()) + sum(
            b.wire_nbytes for b in self.layers
        )

    @property
    def compression_ratio(self) -> float:
        return self.raw_nbytes / max(self.wire_nbytes, 1)

    # -- serialization ---------------------------------------------------
    def _header_bytes(self) -> bytes:
        head = {
            "policy": self.policy,
            "has_delta": self.has_delta,
            "layers": [
                {
                    "name": b.name,
                    "shape": list(b.shape),
                    "dtype": b.dtype,
                    "encoding": b.encoding,
                    "quant": b.quant,
                    "q8_block": b.q8_block,
                    "segments": [
                        [kind, str(b.segments[kind].dtype), int(b.segments[kind].nbytes)]
                        for kind in SEGMENT_KINDS
                        if kind in b.segments
                    ],
                }
                for b in self.layers
            ],
        }
        return json.dumps(head).encode()

    def to_bytes(self) -> bytes:
        head = self._header_bytes()
        parts = [_HEAD.pack(MAGIC, self.version, len(head)), head]
        for b in self.layers:
            for kind in SEGMENT_KINDS:
                if kind in b.segments:
                    parts.append(np.ascontiguousarray(b.segments[kind]).tobytes())
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "CompressedPayload":
        if len(data) < _HEAD.size:
            raise ValueError("compressed payload truncated before header")
        magic, version, head_len = _HEAD.unpack_from(data, 0)
        if magic != MAGIC:
            raise ValueError(f"bad compressed-payload magic {magic!r}")
        if version != PAYLOAD_VERSION:
            raise ValueError(
                f"compressed payload version {version} != supported {PAYLOAD_VERSION}"
            )
        head = json.loads(data[_HEAD.size : _HEAD.size + head_len].decode())
        off = _HEAD.size + head_len
        layers: list[LayerBlock] = []
        for entry in head["layers"]:
            segs: dict[str, np.ndarray] = {}
            for kind, dtype, nbytes in entry["segments"]:
                # read-only views into `data` (kept alive via .base): a
                # 125M-recipe uplink is ~100 MB/client — no second copy on
                # the server's per-client decode path
                segs[kind] = np.frombuffer(
                    data, dtype=np.dtype(dtype), count=nbytes // np.dtype(dtype).itemsize,
                    offset=off,
                )
                off += nbytes
            layers.append(
                LayerBlock(
                    name=entry["name"],
                    shape=tuple(entry["shape"]),
                    dtype=entry["dtype"],
                    encoding=entry["encoding"],
                    quant=entry["quant"],
                    q8_block=int(entry.get("q8_block", 0)),
                    segments=segs,
                )
            )
        if off != len(data):
            raise ValueError(
                f"compressed payload has {len(data) - off} trailing bytes"
            )
        return cls(policy=head["policy"], has_delta=bool(head["has_delta"]),
                   layers=layers, version=version)
