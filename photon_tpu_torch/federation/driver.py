"""Drivers: the control-plane link between the server and its nodes (the
port of ``Driver`` and ``InProcessDriver`` of
``photon_tpu/federation/driver.py``).

``send`` returns a message id and ``recv_any`` the next completed reply
from any node, which is what the sliding-window scheduler needs. The
in-process driver runs each node's agent in the server's process (every
node's trainer on the one card). The multiprocess and TCP drivers are not
ported: each spawned process would open its own CUDA context on the card.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable

from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation.messages import Ack
from photon_tpu_torch.federation.node import NodeAgent


class Driver:
    def node_ids(self) -> list[str]:
        raise NotImplementedError

    def send(self, node_id: str, msg: Any) -> int:
        raise NotImplementedError

    def recv_any(self, timeout: float | None = None) -> tuple[str, int, Any]:
        """→ (node_id, msg_id, reply). Raises TimeoutError."""
        raise NotImplementedError

    def hello_stats(self) -> dict[str, dict]:
        """Node-reported reconnect stats per node id (none in process)."""
        return {}

    def broadcast(self, msg: Any, timeout: float = 300.0, on_stale=None) -> dict[str, Ack]:
        """Send one message to every node and wait for every ack; a reply
        with an unknown id is a stale one, handed to ``on_stale``."""
        pending = {self.send(nid, msg): nid for nid in self.node_ids()}
        acks: dict[str, Ack] = {}
        deadline = time.monotonic() + timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"broadcast: no ack from {sorted(pending.values())}")
            nid, mid, reply = self.recv_any(timeout=left)
            if mid in pending:
                del pending[mid]
                acks[nid] = reply if isinstance(reply, Ack) else Ack(ok=True, node_id=nid)
            elif on_stale is not None:
                on_stale(reply)
        return acks

    def shutdown(self) -> None:
        raise NotImplementedError


class InProcessDriver(Driver):
    def __init__(self, cfg: Config, make_agent: Callable[[str], NodeAgent],
                 n_nodes: int = 1) -> None:
        self._agents = {f"node{i}": make_agent(f"node{i}") for i in range(n_nodes)}
        self._mid = itertools.count()
        self._replies: list[tuple[str, int, Any]] = []
        del cfg

    def node_ids(self) -> list[str]:
        return sorted(self._agents)

    def send(self, node_id: str, msg: Any) -> int:
        mid = next(self._mid)
        self._replies.append((node_id, mid, self._agents[node_id].handle(msg)))
        return mid

    def recv_any(self, timeout: float | None = None) -> tuple[str, int, Any]:
        if not self._replies:
            raise TimeoutError("no pending replies")
        return self._replies.pop(0)

    def shutdown(self) -> None:
        for agent in self._agents.values():
            agent.runtime.close()
