"""NodeAgent: the per-node agent that runs federation tasks on a
:class:`ClientRuntime` (the port of ``photon_tpu/federation/node.py``,
without its chaos hooks and telemetry piggyback). FitIns / EvaluateIns /
Broadcast / Query in, results and Acks out; ``Query("refresh")`` rebuilds
the runtime.

:meth:`NodeAgent.serve` is the request loop over a pipe or a socket (any
object with ``send``/``recv``); :func:`node_process_main` is the entry of
a node process the multiprocess driver spawns.
"""

from __future__ import annotations

import traceback
from collections import deque
from typing import Any, Callable

from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation.client_runtime import ClientRuntime
from photon_tpu_torch.federation.messages import (
    Ack,
    Broadcast,
    Envelope,
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

    def serve(self, conn) -> bool:
        """The request loop over a connection with ``send``/``recv``.
        Returns True after a ``shutdown`` query, False when the peer
        vanished (EOF, or a corrupt frame, which is an ``EOFError``): the
        TCP supervisor redials on False and stops on True.

        Requests are de-duplicated by ``msg_id`` (the drivers' ids are
        unique and increasing): a repeated FitIns must not run the fit
        twice, which would advance the cid's loader and optimizer twice."""
        recent: deque[int] = deque(maxlen=256)
        recent_set: set[int] = set()
        while True:
            try:
                env: Envelope = conn.recv()
            except EOFError:
                return False
            if env.msg_id in recent_set:
                continue  # a repeated delivery: the first reply stands
            if len(recent) == recent.maxlen:
                recent_set.discard(recent[0])
            recent.append(env.msg_id)
            recent_set.add(env.msg_id)
            try:
                reply = self.handle(env.msg)
            except Exception as e:  # noqa: BLE001 — never end the loop silently
                reply = Ack(ok=False, detail=f"{type(e).__name__}: {e}\n{traceback.format_exc()}",
                            node_id=self.node_id)
            conn.send(Envelope(reply, env.msg_id))
            if isinstance(env.msg, Query) and env.msg.action == "shutdown":
                return True


def make_node_agent(cfg: Config, node_id: str, device: str | None) -> NodeAgent:
    """A node agent outside the server's process: the bulk plane the config
    names (``objstore`` or ``shm``; the server normalizes the config of
    record first), the run's codec, and client checkpoints in the run's
    store when ``photon.checkpoint`` is on."""
    from photon_tpu_torch.checkpoint import ClientCheckpointManager, FileStore

    objstore = cfg.photon.comm_stack.objstore
    store = FileStore(cfg.photon.save_path + "/store") \
        if objstore or cfg.photon.checkpoint else None

    def make_transport() -> ParamTransport:
        return ParamTransport("objstore" if objstore else "shm", store=store,
                              compression=cfg.photon.compression,
                              host_threads=cfg.photon.host_threads)

    make_ckpt = None
    if store is not None and cfg.photon.checkpoint:
        def make_ckpt():
            return ClientCheckpointManager(store, cfg.run_uuid)

    return NodeAgent(cfg, node_id, make_transport, make_ckpt, device=device)


def node_process_main(cfg_json: str, node_id: str, conn, device: str | None = None) -> None:
    """Entry of a spawned node process. ``device`` is where its trainer
    runs (``cuda`` unless the caller asks for ``cpu``); a node that cannot
    get it fails each fit with the reason, and never trains elsewhere."""
    agent = make_node_agent(Config.from_json(cfg_json), node_id, device)
    agent.serve(conn)
