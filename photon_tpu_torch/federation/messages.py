"""Federation message schema (the port of ``photon_tpu/federation/messages.py``).

Control-plane messages carry round metadata and *pointer records* to bulk
tensors, never the tensors themselves (except the ``inline`` transport,
for tests and tiny models): a :class:`ParamPointer` names a shm segment or
an object-store key, and the transport plane resolves it. Messages are
plain dataclasses, pickled between the port's own processes (a pipe or
a socket; the trust model is the JAX package's: a private network). An
:class:`Envelope` carries each message with its correlation id. The JAX
package's telemetry fields (piggybacked spans and events, the envelope's
trace context) are left out: telemetry is not ported.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ParamPointer:
    """Where the bulk tensors live. ``metadata_json`` is the payload's
    ``ParamsMetadata`` (names, shapes, dtypes); a payload that went through
    the wire codec adds a ``codec`` key (``policy``, ``version``,
    ``wire_nbytes``) that ``ParamsMetadata.from_json`` ignores."""

    kind: str  # "shm" | "objstore" | "inline"
    locator: str  # shm segment name or store key ("" for inline)
    metadata_json: str
    inline: list | None = None  # only for kind="inline"

    def codec_info(self) -> dict | None:
        """The codec header, or None for a raw payload."""
        return json.loads(self.metadata_json).get("codec")


@dataclass
class ClientState:
    """Per-cid cumulative progress, merged server-side each round."""

    cid: int
    steps_cumulative: int = 0
    samples_cumulative: int = 0
    last_round: int = -1
    wall_time_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ClientState":
        return cls(**d)


@dataclass
class FitIns:
    """Server → node: train these cids this round."""

    server_round: int
    cids: list[int]
    params: ParamPointer | None  # None = use the last broadcast
    local_steps: int
    server_steps_cumulative: int
    client_states: dict[int, dict] = field(default_factory=dict)
    config: dict[str, Any] = field(default_factory=dict)  # FitRoundConfig knobs


@dataclass
class FitRes:
    server_round: int
    cid: int
    params: ParamPointer | None
    n_samples: int = 0
    metrics: dict[str, float] = field(default_factory=dict)
    client_state: dict | None = None
    error: str | None = None  # non-None = failure


@dataclass
class EvaluateIns:
    server_round: int
    cids: list[int]
    params: ParamPointer | None
    max_batches: int = 0
    config: dict[str, Any] = field(default_factory=dict)  # EvaluateRoundConfig knobs


@dataclass
class EvaluateRes:
    server_round: int
    cid: int
    loss: float = 0.0
    n_samples: int = 0
    metrics: dict[str, float] = field(default_factory=dict)
    error: str | None = None


@dataclass
class Broadcast:
    """Server → all nodes: new global params."""

    server_round: int
    params: ParamPointer


@dataclass
class Ack:
    ok: bool = True
    detail: str = ""
    node_id: str = ""


@dataclass
class Query:
    """Control query: ``free_resources`` | ``ping`` | ``shutdown`` | ``refresh``."""

    action: str


@dataclass
class Envelope:
    """A message and its correlation id on a pipe or socket; the reply
    carries the request's ``msg_id``."""

    msg: Any
    msg_id: int
    sent_at: float = field(default_factory=time.time)
