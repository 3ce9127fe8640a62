"""Elastic membership (the port of ``photon_tpu/federation/membership.py``).

- :class:`LivenessTracker` (server side): a ping sweep between rounds
  moves each node through ``live → suspect → dead``; a dead node whose id
  reappears in the driver's registry (a TCP re-HELLO, a multiprocess
  respawn), or that answers a ping, is readmitted, and the sliding window
  readmits a node that died mid-round and came back. The tracker talks to
  nodes only through the driver interface.
- :class:`ReconnectPolicy` (node side): jittered exponential backoff for
  the TCP node's redial supervisor (``tcp.run_node``), deterministic under
  a seeded rng.

Every state-machine edge, first registration (``new → live``) included,
is a ``membership/transition`` telemetry event (a ``None`` check with
telemetry off); ping acks are the flush channel for the spans and events
of nodes that are never sampled for a fit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

from photon_tpu_torch import telemetry
from photon_tpu_torch.federation.messages import Ack, Query
from photon_tpu_torch.utils.profiling import (
    EVENT_MEMBERSHIP_TRANSITION,
    NODES_DEAD,
    NODES_LIVE,
    NODES_READMITTED,
    NODES_SUSPECT,
    RECONNECT_BACKOFF_S,
)

LIVE = "live"
SUSPECT = "suspect"
DEAD = "dead"


def _transition_event(nid: str, old: str, new: str, **attrs) -> None:
    """One membership edge in the event log, correlated with the round
    span that observed it (a None check with telemetry off)."""
    telemetry.emit_event(EVENT_MEMBERSHIP_TRANSITION, node=nid,
                         **{"from": old, "to": new}, **attrs)


@dataclasses.dataclass
class ReconnectPolicy:
    """``delay(k) = min(max_s, base_s · 2^k) · (1 ± jitter)``. ``rng`` needs
    only ``.random()``; ``max_attempts`` bounds consecutive failed dials
    (0 = unlimited); a successful dial resets the count."""

    base_s: float = 0.5
    max_s: float = 30.0
    jitter: float = 0.25
    max_attempts: int = 0
    rng: object = None  # .random() in [0, 1); default: the random module

    @classmethod
    def from_config(cls, mem, rng=None) -> "ReconnectPolicy":
        return cls(base_s=mem.reconnect_backoff_base_s, max_s=mem.reconnect_backoff_max_s,
                   jitter=mem.reconnect_backoff_jitter,
                   max_attempts=mem.reconnect_max_attempts, rng=rng)

    def delay(self, attempt: int) -> float:
        """Backoff before dial ``attempt`` (0-based); the exponent is
        clamped so an unlimited supervisor never overflows a float."""
        raw = min(self.max_s, self.base_s * (2.0 ** min(max(0, attempt), 63)))
        if not self.jitter:
            return raw
        rng = self.rng
        if rng is None:
            import random as rng
        return raw * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))

    def exhausted(self, attempt: int) -> bool:
        return self.max_attempts > 0 and attempt >= self.max_attempts


@dataclasses.dataclass
class NodeHealth:
    state: str = LIVE
    misses: int = 0
    readmissions: int = 0
    # seen GONE from the registry since last live: the condition for a
    # readmission by presence (a wedged node whose id stays must not
    # oscillate dead → readmitted)
    absent: bool = False


class LivenessTracker:
    def __init__(self, suspect_after_misses: int = 1, dead_after_misses: int = 2,
                 ping_timeout_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.suspect_after = suspect_after_misses
        self.dead_after = dead_after_misses
        self.ping_timeout_s = ping_timeout_s
        self.clock = clock
        self.nodes: dict[str, NodeHealth] = {}
        self.readmitted_total = 0
        self._readmitted_round = 0

    def _track(self, nid: str, announce: bool = True) -> NodeHealth:
        """Get-or-create a node record; a new id emits its ``new → live``
        event, unless its first observation is a miss (``announce=False``:
        a never-seen node that failed its first ping was never live)."""
        h = self.nodes.get(nid)
        if h is None:
            h = self.nodes[nid] = NodeHealth()
            if announce:
                _transition_event(nid, "new", LIVE)
        return h

    def observe_alive(self, nid: str) -> None:
        h = self._track(nid)
        old = h.state
        if h.state == DEAD:
            self._readmit(h)
        h.state = LIVE
        h.misses = 0
        if old != LIVE:
            _transition_event(nid, old, LIVE, readmitted=old == DEAD)

    def observe_miss(self, nid: str) -> None:
        h = self._track(nid, announce=False)
        old = h.state
        h.misses += 1
        if h.misses >= self.dead_after:
            h.state = DEAD
        elif h.misses >= self.suspect_after:
            h.state = SUSPECT
        if h.state != old:
            _transition_event(nid, old, h.state, misses=h.misses)

    def touch(self, nid: str) -> None:
        """Start tracking an id (a new node joining mid-round) without the
        absence bookkeeping of :meth:`register_present`."""
        self._track(nid)

    def note_readmitted(self, nid: str) -> None:
        """A node died mid-round and came back (respawn or re-HELLO), got
        the broadcast again and is back in rotation. Always counts: the
        scheduler sees a death before the ping sweep moves its state."""
        h = self._track(nid)
        old = h.state
        self._readmit(h)
        h.state = LIVE
        h.misses = 0
        _transition_event(nid, old, LIVE, readmitted=True)

    def _readmit(self, h: NodeHealth) -> None:
        h.readmissions += 1
        self.readmitted_total += 1
        self._readmitted_round += 1

    def register_present(self, ids: Iterable[str]) -> list[str]:
        """Record the driver's registry; a dead id that left it and came
        back is readmitted. Returns the readmitted ids."""
        id_set = set(ids)
        for nid in set(self.nodes) - id_set:
            self.nodes[nid].absent = True
        readmitted: list[str] = []
        for nid in id_set:
            h = self._track(nid)
            if h.state == DEAD and h.absent:
                self._readmit(h)
                h.state = LIVE
                h.misses = 0
                readmitted.append(nid)
                _transition_event(nid, DEAD, LIVE, readmitted=True, reappeared=True)
            h.absent = False
        return readmitted

    def counts(self) -> dict[str, int]:
        out = {LIVE: 0, SUSPECT: 0, DEAD: 0}
        for h in self.nodes.values():
            out[h.state] += 1
        return out

    def sweep(self, driver, on_stale: Callable[[object], None] | None = None) -> list[str]:
        """Ping every registered node; returns the ids this sweep
        readmitted. A non-ping reply that drains here is a stale late
        reply, handed to ``on_stale``."""
        present = list(driver.node_ids())
        readmitted = self.register_present(present)
        pending = {driver.send(nid, Query("ping")): nid for nid in present}
        deadline = self.clock() + self.ping_timeout_s
        while pending:
            left = deadline - self.clock()
            if left <= 0:
                break
            try:
                nid, mid, reply = driver.recv_any(timeout=left)
            except TimeoutError:
                break
            if mid not in pending:
                if on_stale is not None:
                    on_stale(reply)
                continue
            pnid = pending.pop(mid)
            # the flush channel of nodes never sampled for a fit
            telemetry.ingest(getattr(reply, "spans", None), getattr(reply, "events", None))
            if isinstance(reply, Ack) and reply.ok:
                if self._track(pnid).state == DEAD:
                    readmitted.append(pnid)
                self.observe_alive(pnid)
            else:
                self.observe_miss(pnid)
        for nid in pending.values():
            self.observe_miss(nid)
        for nid in set(self.nodes) - set(present):
            self.observe_miss(nid)
        return readmitted

    def round_metrics(self, hello_backoff_s: float = 0.0) -> dict[str, float]:
        """This round's liveness metrics; resets the round's readmissions."""
        c = self.counts()
        out = {
            NODES_LIVE: float(c[LIVE]),
            NODES_SUSPECT: float(c[SUSPECT]),
            NODES_DEAD: float(c[DEAD]),
            NODES_READMITTED: float(self._readmitted_round),
            RECONNECT_BACKOFF_S: float(hello_backoff_s),
        }
        self._readmitted_round = 0
        return out


def hello_backoff_total(hello_stats: dict[str, dict] | None) -> float:
    """Sum of node-reported cumulative redial backoff seconds."""
    if not hello_stats:
        return 0.0
    return float(sum(float(s.get("backoff_s", 0.0)) for s in hello_stats.values()))


def iter_new_nodes(current: Iterable[str], tracked: Iterable[str]) -> list[str]:
    """Node ids the driver lists that the scheduler does not track: a
    mid-round join or readmission."""
    tracked_set = set(tracked)
    return [nid for nid in current if nid not in tracked_set]
