"""Drivers: the control-plane link between the server and its nodes (the
port of ``photon_tpu/federation/driver.py``).

``send`` returns a message id and ``recv_any`` the next completed reply
from any node, which is what the sliding-window scheduler needs.

- :class:`InProcessDriver`: every node's agent in the server's process.
- :class:`MultiprocessDriver`: one spawned process per node over a pipe.
  Each node opens its own CUDA context (several processes time-slice one
  card). A dead node's in-flight requests come back at once as
  synthesized failures, and the node is started again.
- ``tcp.TcpServerDriver``: nodes on other hosts dial in.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import time
from multiprocessing.connection import wait as mp_wait
from typing import Any, Callable

from photon_tpu_torch import telemetry
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation.messages import Ack, Envelope, Query
from photon_tpu_torch.federation.node import NodeAgent, node_process_main


class Driver:
    def node_ids(self) -> list[str]:
        raise NotImplementedError

    def send(self, node_id: str, msg: Any) -> int:
        raise NotImplementedError

    def recv_any(self, timeout: float | None = None) -> tuple[str, int, Any]:
        """→ (node_id, msg_id, reply). Raises TimeoutError."""
        raise NotImplementedError

    def hello_stats(self) -> dict[str, dict]:
        """Node-reported supervisor stats (``{"reconnects", "backoff_s"}``
        per node id): TCP nodes report their redial backoff, the
        multiprocess driver its respawns (no backoff); in-process nodes
        never leave."""
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


def _died(node_id: str) -> Ack:
    return Ack(ok=False, detail="node died", node_id=node_id)


class MultiprocessDriver(Driver):
    """One spawned process per node (``spawn``: a forked child cannot use
    CUDA), each serving :meth:`NodeAgent.serve` over a pipe with its
    trainer on ``device``."""

    def __init__(self, cfg: Config, n_nodes: int, device: str | None = None) -> None:
        self.cfg = cfg
        self.device = device
        self._mid = itertools.count()
        self._ctx = mp.get_context("spawn")
        self._nodes: dict[str, tuple[Any, Any]] = {}  # node_id -> (process, conn)
        self._inflight: dict[str, list[int]] = {}
        self._respawns: dict[str, int] = {}
        # replies synthesized for a dead node's 2nd..nth in-flight request
        # (the first returns at once); drained before the pipes
        self._dead_letters: list[tuple[str, int, Any]] = []
        for i in range(n_nodes):
            self._start(f"node{i}")

    def _start(self, node_id: str) -> None:
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(target=node_process_main,
                                 args=(self.cfg.to_json(), node_id, child, self.device),
                                 daemon=True, name=f"photon-{node_id}")
        proc.start()
        child.close()
        self._nodes[node_id] = (proc, parent)
        self._inflight[node_id] = []

    def node_ids(self) -> list[str]:
        return sorted(self._nodes)

    def send(self, node_id: str, msg: Any) -> int:
        mid = next(self._mid)
        _, conn = self._nodes[node_id]
        try:
            # the sending span's context rides the envelope, so node-side
            # spans parent to it (None with telemetry off)
            conn.send(Envelope(msg, mid, trace=telemetry.current_context()))
        except (OSError, ValueError):
            # the node died while idle (nothing in flight, so recv_any never
            # read its EOF): start it again here and fail this message now
            self._respawn(node_id)
            self._dead_letters.append((node_id, mid, _died(node_id)))
            return mid
        self._inflight[node_id].append(mid)
        return mid

    def recv_any(self, timeout: float | None = None) -> tuple[str, int, Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._dead_letters:
                return self._dead_letters.pop(0)
            conns = {conn: nid for nid, (_, conn) in self._nodes.items() if self._inflight[nid]}
            if not conns:
                raise TimeoutError("recv_any: nothing in flight")
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            ready = mp_wait(list(conns), timeout=left)
            if not ready:
                raise TimeoutError("recv_any: timeout")
            for conn in ready:
                nid = conns[conn]
                try:
                    env: Envelope = conn.recv()
                except (EOFError, OSError):
                    # a dead node: every request in flight there fails now
                    # (one timeout per orphan would stall the window), then
                    # the node starts again
                    mids = self._inflight[nid]
                    self._inflight[nid] = []
                    self._respawn(nid)
                    if mids:
                        self._dead_letters.extend((nid, m, _died(nid)) for m in mids[1:])
                        return nid, mids[0], _died(nid)
                    continue
                self._inflight[nid].remove(env.msg_id)
                return nid, env.msg_id, env.msg

    def _respawn(self, node_id: str) -> None:
        proc, conn = self._nodes[node_id]
        try:
            conn.close()
        except OSError:
            pass
        if proc.is_alive():
            proc.terminate()
        proc.join(timeout=10)
        self._respawns[node_id] = self._respawns.get(node_id, 0) + 1
        self._start(node_id)

    def hello_stats(self) -> dict[str, dict]:
        return {nid: {"reconnects": n, "backoff_s": 0.0} for nid, n in self._respawns.items()}

    def shutdown(self) -> None:
        for proc, conn in self._nodes.values():
            try:
                conn.send(Envelope(Query("shutdown"), next(self._mid)))
            except (OSError, ValueError):
                pass
        for proc, conn in self._nodes.values():
            proc.join(timeout=15)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
            try:
                conn.close()
            except OSError:
                pass
        self._nodes.clear()
