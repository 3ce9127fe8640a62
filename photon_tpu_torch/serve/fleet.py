"""The replica side of a serving fleet, and two ways to run N replicas
(the port of ``photon_tpu/serve/fleet.py``).

A replica's :class:`ReplicaAgent` dials the router's control port
(``serve/router.py``) and says HELLO as a federation node does
(``federation/tcp.py``), then answers ``Query`` actions over the framed
socket:

- ``ping``: an ack;
- ``fleet_report``: the data port, cohorts, round and the batcher's
  :meth:`~photon_tpu_torch.serve.scheduler.ContinuousBatcher.load_report`
  (the router's placement signal and its liveness ping in one exchange);
- ``drain``: the frontend turns to draining and the batcher drains on a
  thread of its own (the ack does not wait: a blocked control loop would
  look like a dead replica);
- ``restart``: a soft restart in place, the batcher's
  :meth:`~photon_tpu_torch.serve.scheduler.ContinuousBatcher.recycle`
  while the frontend answers 503, on a thread of its own;
- ``hotswap``: one poll of the replica's hot-swap watcher, answered with
  whether it swapped and the round. The agent is the watcher's only
  caller: a replica under ``--fleet-connect`` starts no polling loop of
  its own, so a rolling pass is the only way a round reaches it and no
  two threads stage one round twice. The JAX replica keeps its watcher's
  loop, so every replica also swaps on its own timer, all within one
  ``hotswap_poll_s`` of the manifest;
- ``shutdown``: an ack, and the agent's loop ends.

A lost connection is redialed with jittered backoff and a new HELLO.
The connected socket blocks with TCP keepalive on, as a federation
node's does, so an idle replica (the router busy swapping another) keeps
its connection; the JAX agent keeps its 10 s dial timeout on the socket
it then reads from, and so redials whenever the router is quiet longer.

:class:`InProcessFleet` runs N replicas as threads of one process behind
a router (tests). :class:`FleetSupervisor` runs N ``python -m
photon_tpu_torch.serve --fleet-connect`` daemons as child processes; it
reads each child's output on a thread, so a child never blocks on a full
pipe, and keeps the last lines.

Not ported yet: the agent's telemetry (its reconnect event, and the
report's ``health`` and ``compiles`` fields, which the router's restart
autopilot reads) waits for the telemetry port.
"""

from __future__ import annotations

import collections
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import zlib
from typing import Any

from photon_tpu_torch.federation import tcp
from photon_tpu_torch.federation.membership import ReconnectPolicy
from photon_tpu_torch.federation.messages import Ack, Envelope, Query

#: lines of each supervised child's output kept
_LOG_LINES = 200
#: how long :meth:`ReplicaAgent.stop` waits for the agent's thread
_STOP_JOIN_S = 5.0


class ReplicaAgent:
    """The control-plane agent thread inside one serving replica. It owns
    only its socket: the batcher, frontend and watcher are the daemon's.
    ``drain_timeout_s`` bounds the drain a ``drain`` or ``restart`` starts."""

    def __init__(self, control_addr: str, replica_id: str, *, batcher: Any, frontend: Any,
                 watcher: Any = None, drain_timeout_s: float = 30.0) -> None:
        self.control_addr = control_addr
        self.replica_id = replica_id
        self.batcher = batcher
        self.frontend = frontend
        self.watcher = watcher
        self.drain_timeout_s = drain_timeout_s
        self.policy = ReconnectPolicy(
            base_s=0.1, max_s=2.0, jitter=0.25,
            rng=random.Random(zlib.crc32(replica_id.encode())))
        self._stop = threading.Event()
        self._conn: tcp.SocketConn | None = None
        self._thread: threading.Thread | None = None
        #: redials after a lost connection (a clean shutdown is not one)
        self.reconnects = 0

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ReplicaAgent":
        self._thread = threading.Thread(target=self._supervise,
                                        name=f"photon-fleet-agent-{self.replica_id}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Leave the fleet (the router's ``shutdown`` query is the clean
        path; this one serves a router that is already gone)."""
        self.kill()
        if self._thread is not None:
            self._thread.join(timeout=_STOP_JOIN_S)
            self._thread = None

    def kill(self) -> None:
        """An emulated SIGKILL (in-process fleets): the socket dies
        mid-stream and the loop never redials."""
        self._stop.set()
        conn = self._conn
        if conn is not None:
            # a close alone would leave the loop's blocking read (and the
            # connection) open until the router next spoke
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()

    # -- the supervisor loop ----------------------------------------------
    def _supervise(self) -> None:
        host, _, port = self.control_addr.rpartition(":")
        attempt = 0
        backoff_total = 0.0
        while not self._stop.is_set():
            try:
                sock = socket.create_connection((host, int(port)), timeout=tcp._DIAL_TIMEOUT_S)
            except OSError:
                attempt += 1
                if self.policy.exhausted(attempt):
                    return
                d = self.policy.delay(attempt - 1)
                backoff_total += d
                self._stop.wait(d)
                continue
            attempt = 0
            # the dial's timeout must not outlive the dial: the router may
            # be quiet for longer (a rolling swap holds its control lock
            # while another replica swaps). Keepalive finds a dead router
            sock.settimeout(None)
            tcp._keep_alive(sock)
            conn = tcp.SocketConn(sock)
            self._conn = conn
            clean = False
            try:
                conn.send({"kind": tcp.HELLO_KIND, "node_id": self.replica_id,
                           "reconnects": self.reconnects, "backoff_s": backoff_total})
                clean = self._serve(conn)
            except OSError:
                clean = False
            finally:
                conn.close()
                self._conn = None
            if clean or self._stop.is_set():
                return
            self.reconnects += 1
            d = self.policy.delay(0)
            backoff_total += d
            self._stop.wait(d)

    def _serve(self, conn: tcp.SocketConn) -> bool:
        while True:
            try:
                env: Envelope = conn.recv()
            except EOFError:
                return False  # a torn stream (a corrupt frame too): redial
            msg = env.msg
            if isinstance(msg, Query):
                try:
                    reply = self._handle(msg)
                except Exception as e:  # noqa: BLE001 — never kill the loop
                    reply = Ack(ok=False, detail=f"{type(e).__name__}: {e}",
                                node_id=self.replica_id)
            else:
                reply = Ack(ok=False, detail=f"unexpected {type(msg).__name__}",
                            node_id=self.replica_id)
            conn.send(Envelope(reply, env.msg_id))
            if isinstance(msg, Query) and msg.action == "shutdown":
                return True

    # -- the actions -------------------------------------------------------
    def _handle(self, q: Query) -> Ack:
        if q.action in ("ping", "shutdown"):
            return Ack(ok=True, node_id=self.replica_id)
        if q.action == "fleet_report":
            return Ack(ok=True, node_id=self.replica_id, detail=json.dumps(self.report()))
        if q.action == "drain":
            self.frontend.mark_draining()
            threading.Thread(target=self.batcher.drain, args=(self.drain_timeout_s,),
                             name=f"photon-fleet-drain-{self.replica_id}", daemon=True).start()
            return Ack(ok=True, node_id=self.replica_id)
        if q.action == "restart":
            # quiesce in place: the frontend answers 503 while the batcher
            # recycles, then serving resumes on the same engine
            self.frontend.mark_draining()
            threading.Thread(target=self._recycle, name=f"photon-fleet-restart-{self.replica_id}",
                             daemon=True).start()
            return Ack(ok=True, node_id=self.replica_id)
        if q.action == "hotswap":
            if self.watcher is None:
                return Ack(ok=False, detail="no hot-swap watcher", node_id=self.replica_id)
            outcome = self.watcher.poll_once()
            return Ack(ok=True, node_id=self.replica_id, detail=json.dumps({
                "swapped": outcome == "swapped", "outcome": outcome,
                "round": self.batcher.engine.loaded_round}))
        return Ack(ok=False, detail=f"unknown action {q.action!r}", node_id=self.replica_id)

    def _recycle(self) -> None:
        try:
            self.batcher.recycle(self.drain_timeout_s)
        finally:
            self.frontend.draining = False

    def report(self) -> dict:
        eng = self.batcher.engine
        rep = {"host": self.frontend.host, "port": self.frontend.port,
               "cohorts": eng.adapter_pool.cohorts() if eng.adapter_pool is not None else [],
               "round": eng.loaded_round if eng.loaded_round is not None else -1}
        rep.update(self.batcher.load_report())
        return rep


class InProcessFleet:
    """N replicas (engine, batcher, HTTP frontend and agent each) as
    threads of one process behind a router. Every replica serves the same
    ``params`` on ``device`` (``cuda`` unless the caller asks for the
    CPU): placement must never change an output."""

    def __init__(self, cfg, params, *, device: str | None = None) -> None:
        from photon_tpu_torch.serve.engine import PagedEngine
        from photon_tpu_torch.serve.frontend import ServeFrontend
        from photon_tpu_torch.serve.router import FleetRouter
        from photon_tpu_torch.serve.scheduler import ContinuousBatcher

        sc = cfg.photon.serve
        fc = sc.fleet
        self.router = FleetRouter(fc, block_size=sc.block_size)
        control_addr = f"{fc.host}:{self.router.control_port}"
        self.replicas: dict[str, dict] = {}
        for i in range(fc.replicas):
            rid = f"replica{i}"
            engine = PagedEngine(cfg, params, device=device)
            batcher = ContinuousBatcher(
                engine, max_queue=sc.max_queue, prefill_token_budget=sc.prefill_token_budget,
                default_eos_id=sc.eos_id if sc.eos_id >= 0 else None,
                speculative=sc.speculative).start()
            frontend = ServeFrontend(batcher, host=fc.host, port=0,
                                     max_new_tokens_cap=sc.max_new_tokens)
            frontend.start()
            agent = ReplicaAgent(control_addr, rid, batcher=batcher, frontend=frontend,
                                 drain_timeout_s=sc.drain_timeout_s).start()
            self.replicas[rid] = {"engine": engine, "batcher": batcher, "frontend": frontend,
                                  "agent": agent, "killed": False}

    def start(self, timeout: float = 60.0) -> int:
        """Start the router, wait until every replica reported, and return
        the router's HTTP port."""
        port = self.router.start()
        self.router.wait_for_replicas(timeout=timeout)
        return port

    def kill_replica(self, rid: str) -> None:
        """An emulated SIGKILL: the frontend closes (connections are
        refused), the agent's socket dies without a goodbye, nothing
        drains. Requests in flight on this replica are lost."""
        rep = self.replicas.get(rid)
        if rep is None or rep["killed"]:
            return
        rep["killed"] = True
        rep["agent"].kill()
        rep["frontend"].close()
        rep["batcher"].close(timeout=1.0)

    def close(self) -> None:
        self.router.close()
        for rep in self.replicas.values():
            if rep["killed"]:
                continue
            rep["agent"].stop()
            rep["frontend"].close()
            rep["batcher"].close()


class FleetSupervisor:
    """N serving daemons as child processes. Each child is ``python -m
    photon_tpu_torch.serve --config CONFIG --enable --port 0
    --fleet-connect HOST:PORT --replica-id rN`` plus ``extra_args``
    (``--device``, ``--store``, ``--round``): its bound port reaches the
    router over the control plane, so no two children race for a port.
    :meth:`kill_replica` is a real SIGKILL; :meth:`close` sends each child
    SIGTERM, its own graceful drain."""

    def __init__(self, config_path: str, control_addr: str, n_replicas: int, *,
                 extra_args: tuple = (), env: dict | None = None) -> None:
        self.procs: dict[str, subprocess.Popen] = {}
        #: each child's last output lines (stdout and stderr together)
        self.logs: dict[str, collections.deque] = {}
        self._readers: list[threading.Thread] = []
        for i in range(n_replicas):
            rid = f"replica{i}"
            cmd = [sys.executable, "-m", "photon_tpu_torch.serve", "--config", config_path,
                   "--enable", "--port", "0", "--fleet-connect", control_addr,
                   "--replica-id", rid, *extra_args]
            proc = subprocess.Popen(cmd, env=dict(os.environ, **(env or {})),
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            self.procs[rid] = proc
            self.logs[rid] = collections.deque(maxlen=_LOG_LINES)
            t = threading.Thread(target=self._read, args=(proc, self.logs[rid]),
                                 name=f"photon-fleet-log-{rid}", daemon=True)
            t.start()
            self._readers.append(t)

    @staticmethod
    def _read(proc: subprocess.Popen, lines: collections.deque) -> None:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))

    def kill_replica(self, rid: str) -> None:
        """SIGKILL: no drain, no goodbye; the router's liveness ladder
        notices."""
        p = self.procs.get(rid)
        if p is not None and p.poll() is None:
            p.kill()

    def alive(self) -> list[str]:
        return sorted(r for r, p in self.procs.items() if p.poll() is None)

    def close(self, timeout: float = 30.0) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout
        for p in self.procs.values():
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
        for t in self._readers:
            t.join(timeout=5)
        for p in self.procs.values():
            if p.stdout is not None:
                p.stdout.close()
