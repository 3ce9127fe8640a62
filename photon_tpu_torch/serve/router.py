"""The fleet router: N serving replicas behind one front door (the port
of ``photon_tpu/serve/router.py``).

Each replica is the serving daemon unchanged (``python -m
photon_tpu_torch.serve --fleet-connect HOST:PORT``), on a port of its own.
The router only places requests; it never touches tokens, so a routed
greedy stream is the stream one engine gives the same request. It runs
on the host alone: it builds no engine and opens no CUDA context.

Placement, in order (:class:`AffinityRouter`):

1. **cohort affinity**: a request with a ``cohort`` goes to the replica
   its cohort is pinned to (the first placement pins it by rendezvous
   hashing over the live set), so that replica's adapter pool stays warm
   for it. A pin on a dead replica moves to a survivor.
2. **prefix affinity**: the chain hash of the prompt's first
   ``prefix_affinity_blocks`` full blocks (``serve/prefix.py``, with no
   cohort: the JAX package's bytes) is rendezvous-hashed over the live
   replicas, so prompts that share that prefix meet on the replica whose
   prefix cache holds it. Removing a replica moves only its own keys.
3. **power-of-two choices**: with no key, two live replicas are sampled
   and the one with the shorter queue (then the lower live-slot
   fraction, then the id) takes the request.

The control plane is the port's TCP transport (``federation/tcp.py``):
replicas dial in and HELLO like federation nodes, and one poll sends
each a ``fleet_report`` query, whose reply carries the replica's data
port, cohorts, round and load report. The poll is the liveness ping: a
missed report walks the :class:`LivenessTracker` ladder (live → suspect
→ dead). A dead replica leaves placement and its cohorts re-pin; requests
in flight on the survivors are untouched. A proxy that fails before the
first response byte is placed again on another replica, and so is one
that a replica refuses with 503 (draining, or its engine failed), which
it sends before it generates anything; the JAX router passes that 503 to
the client, so a replica's graceful restart failed requests the
survivors could serve. Once bytes flow, an error reaches the client
(generation is not replayed: it is not idempotent under sampling).

The data plane proxies ``/generate`` with ``http.client``, passing a
chunked stream through chunk by chunk.

``/metrics`` renders the router's KPI History (and the typed hub with
``photon.telemetry`` on); ``/statusz`` is the health monitor's rollup
with the fleet's counts. With telemetry on, a replica's registration, its
death, each cohort re-pin and each leg of a rolling swap are events, and a
dead replica degrades the ``fleet`` health plane until every tracked
replica is live again. With ``telemetry.autopilot`` on, the poll is the
replica-restart autopilot's eye: a replica whose report shows its kernel
build count rising on ``replica_compile_streak`` consecutive polls, or its
serve plane degraded by ``alert/hbm_growth``, is put to the autopilot
(:meth:`~photon_tpu_torch.telemetry.autopilot.Autopilot.request_replica_restart`,
a cooldown per replica and a decision record), and an approved restart is
sent as the agent's ``restart`` action after the poll has released the
control lock (the action drains the replica and recycles it in place; its
503s are placed again). ``/statusz`` then carries the autopilot's
decisions. Under ``photon.chaos``,
:meth:`FleetRouter.place` asks the injector whether to kill a replica
after N placements and hands the victim to ``kill_hook``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import http.client
import json
import random
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from photon_tpu_torch import chaos, telemetry
from photon_tpu_torch.federation.membership import DEAD, LivenessTracker
from photon_tpu_torch.federation.messages import Ack, Query
from photon_tpu_torch.federation.tcp import TcpServerDriver
from photon_tpu_torch.metrics.history import History
from photon_tpu_torch.serve.prefix import prefix_hashes
from photon_tpu_torch.telemetry.prom import negotiate_exposition, render_exposition
from photon_tpu_torch.utils.profiling import (
    ALERT_HBM_GROWTH,
    EVENT_FLEET_COHORT_REPIN,
    EVENT_FLEET_REPLICA_DEAD,
    EVENT_FLEET_REPLICA_UP,
    EVENT_FLEET_ROLLING_SWAP,
    ROUTER_COHORT_REPINS,
    ROUTER_PROXY_ERRORS,
    ROUTER_REPLICAS_DEAD,
    ROUTER_REPLICAS_LIVE,
    ROUTER_REPLICAS_SUSPECT,
    ROUTER_REQUESTS_TOTAL,
    ROUTER_REROUTES,
    ROUTER_ROUTED_COHORT,
    ROUTER_ROUTED_P2C,
    ROUTER_ROUTED_PREFIX,
    SERVE_FLEET_REPLICAS,
    SERVE_FLEET_ROLLING_SWAPS,
)


#: how long the router waits on a replica's reply to one proxied request
REQUEST_TIMEOUT_S = 120.0
#: how long :meth:`FleetRouter.drain_fleet` waits on each replica's ack
DRAIN_ACK_S = 5.0


class NoReplicasError(RuntimeError):
    """No live replica can take a placement."""


def rendezvous_pick(key: bytes, candidates: list[str]) -> str:
    """Highest-random-weight hashing: every caller picks the same winner
    for ``key``, and removing a candidate moves only the keys it won."""
    if not candidates:
        raise NoReplicasError("rendezvous over an empty replica set")
    return max(candidates,
               key=lambda rid: hashlib.blake2b(key + b"|" + rid.encode(), digest_size=8).digest())


@dataclasses.dataclass
class ReplicaState:
    """What the router knows of one replica, from its reports."""

    replica_id: str
    host: str = ""
    port: int = 0  # the replica's HTTP port; 0 = not reported yet
    cohorts: tuple = ()
    loaded_round: int = -1
    queue_depth: int = 0
    live_slot_frac: float = 0.0
    draining: bool = False

    def to_dict(self) -> dict:
        return {"host": self.host, "port": self.port, "cohorts": list(self.cohorts),
                "round": self.loaded_round, "queue_depth": self.queue_depth,
                "live_slot_frac": self.live_slot_frac, "draining": self.draining}


class AffinityRouter:
    """The placement policy alone (no sockets). Callers pass the current
    live set and loads; the only state kept is the cohort → replica pins.
    ``mode="random"`` places uniformly and bypasses affinity (the control
    a locality measurement compares against)."""

    def __init__(self, *, block_size: int, prefix_affinity_blocks: int = 4,
                 cohort_affinity: bool = True, mode: str = "affinity",
                 rng: random.Random | None = None) -> None:
        self.block_size = block_size
        self.prefix_affinity_blocks = prefix_affinity_blocks
        self.cohort_affinity = cohort_affinity
        self.mode = mode
        self.rng = rng or random.Random(0x5EED)
        self.pins: dict[str, str] = {}  # cohort -> replica id

    def prefix_key(self, prompt: list[int] | None) -> bytes | None:
        """The routing key: the last chain hash of the prompt's first
        ``prefix_affinity_blocks`` full blocks, which names that whole
        prefix. None without a full block (or with prefix affinity off)."""
        if self.prefix_affinity_blocks <= 0 or prompt is None or len(prompt) < self.block_size:
            return None
        hashes = prefix_hashes(list(prompt), self.block_size, limit=self.prefix_affinity_blocks)
        return hashes[-1] if hashes else None

    def route(self, prompt: list[int] | None, cohort: str | None, live: list[str],
              loads: dict[str, ReplicaState]) -> tuple[str, str]:
        """``(replica id, reason)``, the reason ``cohort``, ``prefix``,
        ``p2c`` or ``random``. ``live`` is the current live set, sorted."""
        if not live:
            raise NoReplicasError("no live replicas")
        if self.mode == "random":
            return self.rng.choice(live), "random"
        if cohort and self.cohort_affinity:
            pinned = self.pins.get(cohort)
            if pinned not in live:
                pinned = rendezvous_pick(b"cohort|" + cohort.encode(), live)
                self.pins[cohort] = pinned
            return pinned, "cohort"
        key = self.prefix_key(prompt)
        if key is not None:
            return rendezvous_pick(b"prefix|" + key, live), "prefix"
        return self._p2c(live, loads), "p2c"

    def _p2c(self, live: list[str], loads: dict[str, ReplicaState]) -> str:
        if len(live) == 1:
            return live[0]
        a, b = self.rng.sample(live, 2)

        def load_key(rid: str) -> tuple:
            st = loads.get(rid)
            return (0, 0.0, rid) if st is None else (st.queue_depth, st.live_slot_frac, rid)

        return min(a, b, key=load_key)

    def repin_dead(self, dead: str, live: list[str]) -> list[tuple[str, str]]:
        """Move every cohort pinned to ``dead`` onto a survivor; returns
        ``[(cohort, new replica), ...]``. With no survivor the pins drop."""
        moved: list[tuple[str, str]] = []
        for cohort, rid in list(self.pins.items()):
            if rid != dead:
                continue
            if live:
                new = rendezvous_pick(b"cohort|" + cohort.encode(), live)
                self.pins[cohort] = new
                moved.append((cohort, new))
            else:
                del self.pins[cohort]
        return moved


class FleetRouter:
    """The control plane and the HTTP front door.

    One poll thread owns every send and receive on the control driver
    (load reports double as pings); the HTTP handler threads proxy.
    :meth:`rolling_hotswap` and :meth:`drain_fleet` take turns with the
    poll on ``_ctl_lock``."""

    def __init__(self, fleet_cfg, *, block_size: int,
                 kill_hook: Callable[[str], None] | None = None) -> None:
        self.fc = fleet_cfg
        #: kills a replica by id for chaos's replica kill (the in-process
        #: fleet passes its emulated SIGKILL); None: no kill capability
        self.kill_hook = kill_hook
        self.driver = TcpServerDriver(fleet_cfg.host, fleet_cfg.control_port,
                                      expected_nodes=fleet_cfg.replicas)
        self.tracker = LivenessTracker(ping_timeout_s=fleet_cfg.report_timeout_s)
        self.policy = AffinityRouter(block_size=block_size,
                                     prefix_affinity_blocks=fleet_cfg.prefix_affinity_blocks,
                                     cohort_affinity=fleet_cfg.cohort_affinity)
        self.replicas: dict[str, ReplicaState] = {}
        self.history = History()
        # cumulative counters, mirrored into the History each poll
        self.requests_total = 0
        self.routed_prefix = 0
        self.routed_cohort = 0
        self.routed_p2c = 0
        self.reroutes = 0
        self.proxy_errors = 0
        self.cohort_repins = 0
        self.rolling_swaps = 0
        self._lock = threading.Lock()  # replicas, pins and counters
        self._ctl_lock = threading.Lock()  # the control driver, one user at a time
        self._last_states: dict[str, str] = {}
        # the restart autopilot's state: each replica's last reported build
        # count and its streak of polls on which it grew, and the restarts
        # approved in a poll, sent after the control lock is released (the
        # restart query takes it)
        self._compiles: dict[str, float] = {}
        self._compile_streaks: dict[str, int] = {}
        self._pending_restarts: list[str] = []
        #: replica id -> the times its approved restarts were acknowledged
        self.restarts: dict[str, list[float]] = {}
        self._tick = 0
        self._stop = threading.Event()
        self._poll_thread: threading.Thread | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self.port = fleet_cfg.port
        self.draining = False

    # -- control plane ----------------------------------------------------
    @property
    def control_port(self) -> int:
        return self.driver.port

    def wait_for_replicas(self, timeout: float = 60.0) -> None:
        """Block until ``fleet.replicas`` replicas said HELLO and reported
        a data port."""
        self.driver.wait_for_nodes(timeout=timeout)
        deadline = time.monotonic() + timeout
        ready: list[ReplicaState] = []
        while time.monotonic() < deadline:
            self.poll_once()
            with self._lock:
                ready = [r for r in self.replicas.values() if r.port]
            if len(ready) >= self.fc.replicas:
                return
            time.sleep(0.05)
        raise TimeoutError(f"only {len(ready)}/{self.fc.replicas} replicas reported a data port")

    def poll_once(self) -> None:
        """One control cycle: a ``fleet_report`` query to each registered
        replica. A reply refreshes its state and counts as alive; a miss
        walks the liveness ladder."""
        with self._ctl_lock:
            present = self.driver.node_ids()
            self.tracker.register_present(present)
            pending = {self.driver.send(nid, Query("fleet_report")): nid for nid in present}
            deadline = time.monotonic() + self.fc.report_timeout_s
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    _, mid, reply = self.driver.recv_any(timeout=left)
                except TimeoutError:
                    break
                if mid not in pending:
                    continue  # a late reply to an earlier cycle
                pnid = pending.pop(mid)
                if isinstance(reply, Ack) and reply.ok:
                    self._ingest_report(pnid, reply)
                    self.tracker.observe_alive(pnid)
                else:
                    self.tracker.observe_miss(pnid)
            for nid in pending.values():
                self.tracker.observe_miss(nid)
            for nid in set(self.tracker.nodes) - set(present):
                self.tracker.observe_miss(nid)
        self._apply_transitions()
        self._record_kpis()
        self._drain_restarts()

    def _drain_restarts(self) -> None:
        """Send the poll's approved restarts, outside the poll's hold of
        the control lock (each query takes it again)."""
        pending, self._pending_restarts = self._pending_restarts, []
        for nid in pending:
            ack = self._query(nid, "restart", self.fc.report_timeout_s)
            if ack is None or not ack.ok:
                warnings.warn(f"fleet restart of {nid} was not acknowledged", stacklevel=2)
                continue
            with self._lock:
                self.restarts.setdefault(nid, []).append(time.time())

    def _ingest_report(self, nid: str, reply: Ack) -> None:
        try:
            rep = json.loads(reply.detail or "{}")
        except json.JSONDecodeError:
            return
        with self._lock:
            first = nid not in self.replicas or not self.replicas[nid].port
            st = self.replicas.setdefault(nid, ReplicaState(replica_id=nid))
            st.host = str(rep.get("host", st.host or self.fc.host))
            st.port = int(rep.get("port", st.port))
            st.cohorts = tuple(rep.get("cohorts") or ())
            st.loaded_round = int(rep.get("round", -1))
            st.queue_depth = int(rep.get("queue_depth", 0))
            st.live_slot_frac = float(rep.get("live_slot_frac", 0.0))
            st.draining = bool(rep.get("draining", False))
        if first and st.port:
            telemetry.emit_event(EVENT_FLEET_REPLICA_UP, replica=nid, port=st.port,
                                 round=st.loaded_round)
        # restart triggers: a streak of polls on which the build count grew,
        # or a serve plane degraded by HBM growth. The autopilot decides
        # (a cooldown per replica, the decision record); _drain_restarts acts
        ap = telemetry.autopilot_active()
        if ap is not None:
            reason = None
            observed = 1.0
            compiles = rep.get("compiles")
            if compiles is not None:
                prev = self._compiles.get(nid)
                self._compiles[nid] = float(compiles)
                streak = (self._compile_streaks.get(nid, 0) + 1
                          if prev is not None and float(compiles) > prev else 0)
                self._compile_streaks[nid] = streak
                limit = int(getattr(ap.cfg, "replica_compile_streak", 0))
                if limit > 0 and streak >= limit:
                    reason, observed = "compile_growth", float(streak)
            health = rep.get("health") or {}
            if health.get("status") not in (None, "ok") \
                    and health.get("reason") == ALERT_HBM_GROWTH:
                reason, observed = ALERT_HBM_GROWTH, 1.0
            if reason is not None and ap.request_replica_restart(nid, reason, observed=observed):
                self._compile_streaks[nid] = 0
                self._pending_restarts.append(nid)

    def _apply_transitions(self) -> None:
        """A replica newly dead re-pins its cohorts and degrades the fleet
        plane; a fleet all live resolves it."""
        states = {nid: h.state for nid, h in self.tracker.nodes.items()}
        newly_dead = [nid for nid, s in states.items()
                      if s == DEAD and self._last_states.get(nid) != DEAD]
        self._last_states = states
        for nid in newly_dead:
            self._on_replica_dead(nid)
        if states and all(s != DEAD for s in states.values()):
            h = telemetry.health_active()
            if h is not None:
                h.resolve("fleet", reason="all replicas live")

    def _on_replica_dead(self, nid: str) -> None:
        live = self.live_replicas(exclude=(nid,))
        with self._lock:
            moved = self.policy.repin_dead(nid, live)
            self.cohort_repins += len(moved)
        telemetry.emit_event(EVENT_FLEET_REPLICA_DEAD, replica=nid, survivors=len(live))
        for cohort, new in moved:
            telemetry.emit_event(EVENT_FLEET_COHORT_REPIN, cohort=cohort,
                                 **{"from": nid, "to": new})
        h = telemetry.health_active()
        if h is not None:
            h.note_fleet_replica_dead(replica=nid, survivors=len(live), repinned=len(moved))

    def live_replicas(self, exclude: tuple = ()) -> list[str]:
        """The replicas a placement may target: not dead, data port known,
        not draining. Sorted, so placement is deterministic."""
        states = {nid: h.state for nid, h in self.tracker.nodes.items()}
        with self._lock:
            return sorted(nid for nid, st in self.replicas.items()
                          if st.port and not st.draining and nid not in exclude
                          and states.get(nid, DEAD) != DEAD)

    def _record_kpis(self) -> None:
        counts = self.tracker.counts()
        with self._lock:
            self._tick += 1
            self.history.record(self._tick, {
                ROUTER_REQUESTS_TOTAL: float(self.requests_total),
                ROUTER_ROUTED_PREFIX: float(self.routed_prefix),
                ROUTER_ROUTED_COHORT: float(self.routed_cohort),
                ROUTER_ROUTED_P2C: float(self.routed_p2c),
                ROUTER_REROUTES: float(self.reroutes),
                ROUTER_PROXY_ERRORS: float(self.proxy_errors),
                ROUTER_COHORT_REPINS: float(self.cohort_repins),
                ROUTER_REPLICAS_LIVE: float(counts["live"]),
                ROUTER_REPLICAS_SUSPECT: float(counts["suspect"]),
                ROUTER_REPLICAS_DEAD: float(counts["dead"]),
                SERVE_FLEET_REPLICAS: float(len(self.replicas)),
                SERVE_FLEET_ROLLING_SWAPS: float(self.rolling_swaps),
            })

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — a poll must not kill the router
                warnings.warn(f"fleet poll failed: {type(e).__name__}: {e}", stacklevel=2)
            self._stop.wait(self.fc.report_poll_s)

    def _query(self, nid: str, action: str, timeout: float) -> Ack | None:
        """One request and its reply, taking turns with the poll; a late
        reply to an earlier query is told apart by its message id."""
        with self._ctl_lock:
            mid = self.driver.send(nid, Query(action))
            deadline = time.monotonic() + timeout
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                try:
                    _, rmid, reply = self.driver.recv_any(timeout=left)
                except TimeoutError:
                    return None
                if rmid == mid:
                    return reply if isinstance(reply, Ack) else None

    # -- fleet operations --------------------------------------------------
    def rolling_hotswap(self, timeout_s: float = 60.0) -> list[dict]:
        """One hot-swap pass, a replica at a time: each polls its store and,
        when a newer verified round is there, quiesces and swaps before the
        next is asked. So at most one replica is ever mid-swap, and no
        request is dropped (the swap point waits for running slots)."""
        results: list[dict] = []
        for nid in self.live_replicas():
            reply = self._query(nid, "hotswap", timeout=timeout_s)
            res = {"replica": nid, "ok": False}
            if reply is not None and reply.ok:
                try:
                    res.update(json.loads(reply.detail or "{}"))
                except json.JSONDecodeError:
                    pass
                res["ok"] = True
                telemetry.emit_event(EVENT_FLEET_ROLLING_SWAP, replica=nid,
                                     swapped=bool(res.get("swapped")),
                                     round=res.get("round", -1))
            results.append(res)
        with self._lock:
            self.rolling_swaps += 1
        return results

    def drain_fleet(self) -> None:
        """Turn every replica to draining (new work is refused at each
        while in-flight slots finish) and stop accepting at the router."""
        self.draining = True
        for nid in self.live_replicas():
            self._query(nid, "drain", timeout=DRAIN_ACK_S)

    # -- placement and proxy (data plane) ----------------------------------
    def place(self, prompt: list[int] | None, cohort: str | None,
              exclude: tuple = ()) -> tuple[str, str]:
        """Pick a replica for one request and count the reason."""
        live = self.live_replicas(exclude=exclude)
        with self._lock:
            rid, reason = self.policy.route(prompt, cohort, live, self.replicas)
            if not exclude:
                self.requests_total += 1
            if reason == "prefix":
                self.routed_prefix += 1
            elif reason == "cohort":
                self.routed_cohort += 1
            elif reason == "p2c":
                self.routed_p2c += 1
            n_requests = self.requests_total
        inj = chaos.active()
        if inj is not None and self.kill_hook is not None and not exclude:
            victim = inj.replica_kill_plan(n_requests, live)
            if victim is not None:
                self.kill_hook(victim)
        return rid, reason

    # -- HTTP front door ---------------------------------------------------
    def start(self) -> int:
        """Start the HTTP front door and the poll thread; returns the port."""
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def _json(self, code: int, obj: dict, extra_headers: dict | None = None) -> None:
                body = (json.dumps(obj) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _discard_body(self) -> None:
                try:
                    n = int(self.headers.get("Content-Length", 0) or 0)
                except ValueError:
                    n = 0
                if n > 0:
                    self.rfile.read(n)

            def do_GET(self) -> None:  # noqa: N802 — http.server API
                path = self.path.rstrip("/")
                if path == "/healthz":
                    self._json(200, router.fleet_status())
                elif path == "/metrics":
                    want_om, ctype = negotiate_exposition(self.headers.get("Accept"))
                    body = render_exposition(router.history, telemetry.metrics_active(),
                                             exemplars=want_om).encode()
                    if want_om:
                        body += b"# EOF\n"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/statusz":
                    h = telemetry.health_active()
                    payload = (h.statusz() if h is not None
                               else {"status": "ok", "planes": {}, "alerts": [],
                                     "telemetry": "off"})
                    payload["fleet"] = router.fleet_status()["fleet"]
                    ap = telemetry.autopilot_active()
                    if ap is not None:
                        payload["autopilot"] = ap.statusz()
                    self._json(200, payload)
                else:
                    self._discard_body()
                    self._json(404, {"error": f"no route {self.path!r}"})

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                if self.path.rstrip("/") != "/generate":
                    self._discard_body()
                    self._json(404, {"error": f"no route {self.path!r}"})
                    return
                if router.draining:
                    self._discard_body()
                    self._json(503, {"error": "fleet draining"}, {"Retry-After": "5"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n)
                    body = json.loads(raw or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad JSON body: {e}"})
                    return
                tokens = body.get("tokens")
                if not (isinstance(tokens, list) and all(isinstance(t, int) for t in tokens)):
                    tokens = None  # a text prompt routes by cohort or p2c
                cohort = body.get("cohort")
                if cohort is not None and not isinstance(cohort, str):
                    self._json(400, {"error": "'cohort' must be a string"})
                    return
                router._proxy(self, raw, tokens, cohort)

        self._httpd = ThreadingHTTPServer((self.fc.host, self.fc.port), Handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(target=self._httpd.serve_forever,
                                             name="photon-router-http", daemon=True)
        self._http_thread.start()
        self._poll_thread = threading.Thread(target=self._poll_loop, name="photon-router-poll",
                                             daemon=True)
        self._poll_thread.start()
        return self.port

    def fleet_status(self) -> dict:
        counts = self.tracker.counts()
        states = {nid: h.state for nid, h in self.tracker.nodes.items()}
        with self._lock:
            replicas = {nid: dict(st.to_dict(), state=states.get(nid, "unknown"))
                        for nid, st in self.replicas.items()}
            routed = {"requests": self.requests_total, "prefix": self.routed_prefix,
                      "cohort": self.routed_cohort, "p2c": self.routed_p2c,
                      "reroutes": self.reroutes, "proxy_errors": self.proxy_errors,
                      "cohort_repins": self.cohort_repins, "rolling_swaps": self.rolling_swaps}
            pins = dict(self.policy.pins)
        return {"status": "draining" if self.draining else "ok",
                "fleet": {"replicas": replicas, "live": counts["live"],
                          "suspect": counts["suspect"], "dead": counts["dead"],
                          "pins": pins, "routed": routed}}

    def _proxy(self, handler, raw_body: bytes, tokens: list[int] | None,
               cohort: str | None) -> None:
        """Place and forward one ``/generate``. A failure before any
        response byte places it again (up to ``route_retries`` other
        replicas), and so does a 503: a draining replica (one that left
        the fleet on SIGTERM, before the router marks it dead) or a failed
        engine refuses before it generates anything, and the refusing
        replica takes no placement until its next report. Once the
        response flows, errors reach the client."""
        tried: list[str] = []
        for _ in range(self.fc.route_retries + 1):
            try:
                rid, _ = self.place(tokens, cohort, exclude=tuple(tried))
            except NoReplicasError:
                break
            with self._lock:
                st = self.replicas.get(rid)
                dest = (st.host or self.fc.host, st.port) if st else None
            if dest is None:
                tried.append(rid)
                continue
            conn = http.client.HTTPConnection(dest[0], dest[1], timeout=REQUEST_TIMEOUT_S)
            try:
                conn.request("POST", "/generate", body=raw_body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                if resp.status == 503:
                    resp.read()
                    with self._lock:
                        st.draining = True
            except OSError:
                resp = None
            if resp is None or resp.status == 503:
                # no generated byte yet: place it on a survivor
                conn.close()
                tried.append(rid)
                with self._lock:
                    self.reroutes += 1
                continue
            try:
                self._relay(handler, resp)
            finally:
                conn.close()
            return
        with self._lock:
            self.proxy_errors += 1
        handler._json(503, {"error": "no live replica accepted the request"},
                      {"Retry-After": "5"})

    @staticmethod
    def _relay(handler, resp) -> None:
        """Copy a replica's response to the client, a chunked stream chunk
        by chunk as the replica flushes it."""
        chunked = (resp.getheader("Transfer-Encoding") or "").lower() == "chunked"
        handler.send_response(resp.status)
        ctype = resp.getheader("Content-Type")
        if ctype:
            handler.send_header("Content-Type", ctype)
        ra = resp.getheader("Retry-After")
        if ra:
            handler.send_header("Retry-After", ra)
        if chunked:
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()
            while True:
                data = resp.read1(65536)
                if not data:
                    break
                handler.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            handler.wfile.write(b"0\r\n\r\n")
        else:
            data = resp.read()
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop the poll and the HTTP server, then shut the control plane
        down: its ``shutdown`` query ends each replica agent's loop, so no
        agent redials a router that is gone."""
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=self.fc.report_timeout_s + 5)
            self._poll_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=5)
            self._http_thread = None
        self.driver.shutdown()
