"""Node liveness between rounds (the port of ``LivenessTracker`` and
``hello_backoff_total`` of ``photon_tpu/federation/membership.py``).

A ping sweep between rounds moves each node through ``live → suspect →
dead``; a dead node whose id reappears in the driver's registry, or that
answers a ping, is readmitted. The tracker talks to nodes only through
the driver interface. The JAX package's membership events are telemetry,
which is not ported; the round metrics are.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

from photon_tpu_torch.federation.messages import Ack, Query
from photon_tpu_torch.utils.profiling import (
    NODES_DEAD,
    NODES_LIVE,
    NODES_READMITTED,
    NODES_SUSPECT,
    RECONNECT_BACKOFF_S,
)

LIVE = "live"
SUSPECT = "suspect"
DEAD = "dead"


@dataclasses.dataclass
class NodeHealth:
    state: str = LIVE
    misses: int = 0
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
        self._readmitted_round = 0

    def _track(self, nid: str) -> NodeHealth:
        h = self.nodes.get(nid)
        if h is None:
            h = self.nodes[nid] = NodeHealth()
        return h

    def observe_alive(self, nid: str) -> None:
        h = self._track(nid)
        if h.state == DEAD:
            self._readmitted_round += 1
        h.state = LIVE
        h.misses = 0

    def observe_miss(self, nid: str) -> None:
        h = self._track(nid)
        h.misses += 1
        if h.misses >= self.dead_after:
            h.state = DEAD
        elif h.misses >= self.suspect_after:
            h.state = SUSPECT

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
                self._readmitted_round += 1
                h.state = LIVE
                h.misses = 0
                readmitted.append(nid)
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
