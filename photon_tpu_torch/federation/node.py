"""NodeAgent: the per-node agent that runs federation tasks on a
:class:`ClientRuntime` (the port of ``photon_tpu/federation/node.py``).
FitIns / EvaluateIns / Broadcast / Query in, results and Acks out;
``Query("refresh")`` rebuilds the runtime. Each request runs under the
envelope's trace context, and with ``photon.telemetry`` on a node process
drains its spans and events onto the reply (the server merges them). Under
``photon.chaos`` a node can crash before a fit (``pre-fit``) or with its
fit results done but not yet sent (``pre-reply``).

:meth:`NodeAgent.serve` is the request loop over a pipe or a socket (any
object with ``send``/``recv``); :func:`node_process_main` is the entry of
a node process the multiprocess driver spawns.
"""

from __future__ import annotations

import traceback
from collections import deque
from typing import Any, Callable

from photon_tpu_torch import chaos, telemetry
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation.client_runtime import ClientRuntime
from photon_tpu_torch.federation.messages import (
    Ack,
    Broadcast,
    Envelope,
    EvaluateIns,
    EvaluateRes,
    FitIns,
    FitRes,
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
            chaos.crash_point("pre-fit", msg.server_round, self.node_id)
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

    def _piggyback_telemetry(self, reply: Any) -> None:
        """Drain this process's completed spans and buffered events onto the
        outgoing reply (the server ingests them into the merged timeline).
        Fit/eval results are the main channel; a single Ack (broadcast,
        ping, shutdown) carries the buffers too, so a node never sampled
        for a fit still flushes its reconnect events and transport spans
        on every ping sweep. Only for piggyback tracers: an in-process node
        shares the server's tracer, where a drain would pull server spans
        out of the export buffer."""
        tr = telemetry.active()
        if tr is None or not tr.piggyback:
            return
        if isinstance(reply, list):
            carriers = [r for r in reply if isinstance(r, (FitRes, EvaluateRes))]
            carrier = carriers[-1] if carriers else None
        elif isinstance(reply, Ack):
            carrier = reply
        else:
            carrier = None
        if carrier is None:
            return
        carrier.spans = tr.drain()
        carrier.events = telemetry.drain_events()

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
                # the sending server span: spans opened while handling parent
                # to it across the process boundary (a no-op with telemetry off)
                with telemetry.attach(env.trace):
                    reply = self.handle(env.msg)
            except Exception as e:  # noqa: BLE001 — never end the loop silently
                reply = Ack(ok=False, detail=f"{type(e).__name__}: {e}\n{traceback.format_exc()}",
                            node_id=self.node_id)
            self._piggyback_telemetry(reply)
            if isinstance(reply, list) and any(isinstance(r, FitRes) for r in reply):
                # the work done, the result not yet on the wire: the server
                # must charge the cid to its budget, and the restarted
                # node must not report it twice
                chaos.crash_point("pre-reply", getattr(env.msg, "server_round", 0),
                                  self.node_id)
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
    cfg = Config.from_json(cfg_json)
    chaos.install(cfg.photon.chaos, scope=node_id)
    # a spawned node buffers its spans and events and ships them back on
    # its replies (the server holds the merged timeline)
    telemetry.install(cfg.photon.telemetry, scope=node_id, piggyback=True)
    agent = make_node_agent(cfg, node_id, device)
    agent.serve(conn)
