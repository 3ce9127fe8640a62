"""NodeAgent: the per-node agent that runs federation tasks on a
:class:`ClientRuntime` (the port of ``NodeAgent.handle`` and ``_query`` of
``photon_tpu/federation/node.py``). FitIns / EvaluateIns / Broadcast /
Query in, results and Acks out; ``Query("refresh")`` rebuilds the
runtime. The child-process serving loop waits for the multiprocess
driver, which is not ported.
"""

from __future__ import annotations

from typing import Any, Callable

from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation.client_runtime import ClientRuntime
from photon_tpu_torch.federation.messages import (
    Ack,
    Broadcast,
    EvaluateIns,
    FitIns,
    Query,
)
from photon_tpu_torch.federation.transport import ParamTransport


class NodeAgent:
    def __init__(self, cfg: Config, node_id: str, make_transport: Callable[[], ParamTransport],
                 make_ckpt_mgr: Callable[[], Any] | None = None,
                 device: str | None = None) -> None:
        self.cfg = cfg
        self.node_id = node_id
        self.device = device
        self._make_transport = make_transport
        self._make_ckpt_mgr = make_ckpt_mgr
        self.runtime = self._build_runtime()

    def _build_runtime(self) -> ClientRuntime:
        return ClientRuntime(
            self.cfg, self._make_transport(), node_id=self.node_id,
            ckpt_mgr=self._make_ckpt_mgr() if self._make_ckpt_mgr else None,
            device=self.device,
        )

    def handle(self, msg: Any) -> Any:
        if isinstance(msg, FitIns):
            return [self.runtime.fit(msg, cid) for cid in msg.cids]
        if isinstance(msg, EvaluateIns):
            return [self.runtime.evaluate(msg, cid) for cid in msg.cids]
        if isinstance(msg, Broadcast):
            try:
                self.runtime.set_broadcast_params(msg.params)
                return Ack(ok=True, node_id=self.node_id)
            except Exception as e:  # noqa: BLE001 — reported to the server
                return Ack(ok=False, detail=f"{type(e).__name__}: {e}", node_id=self.node_id)
        if isinstance(msg, Query):
            return self._query(msg)
        return Ack(ok=False, detail=f"unknown message {type(msg).__name__}", node_id=self.node_id)

    def _query(self, q: Query) -> Ack:
        if q.action == "ping":
            return Ack(ok=True, node_id=self.node_id)
        if q.action == "refresh":
            # drop the runtime (trainer, loaders) and rebuild it; loaders
            # rebuild from the client states the next FitIns carries
            self.runtime.close()
            self.runtime = self._build_runtime()
            return Ack(ok=True, node_id=self.node_id)
        if q.action == "free_resources":
            self.runtime.transport.cleanup()
            return Ack(ok=True, node_id=self.node_id)
        if q.action == "shutdown":
            self.runtime.close()
            return Ack(ok=True, detail="bye", node_id=self.node_id)
        return Ack(ok=False, detail=f"unknown query {q.action!r}", node_id=self.node_id)
