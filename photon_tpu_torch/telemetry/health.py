"""Health monitors + structured alerts: the machinery that NOTICES a bad run
(the port of ``photon_tpu/telemetry/health.py``, whole).

Conditions become registry-named ``alert/*`` events (with trace
correlation, via :func:`telemetry.emit_event`) rolled up into a per-plane
status served at ``/statusz`` by :class:`~photon_tpu_torch.telemetry.prom.PromServer`,
the serve frontend and the fleet router.

Planes and their watchers:

- **federation** — NaN/Inf sentinel over the round's aggregated KPI dict
  (:meth:`HealthMonitor.check_round_metrics`): a non-finite aggregated
  delta norm or server loss latches the plane ``failing`` (NaN params
  don't heal themselves).
- **collective** — straggler-percentile and degraded-round-budget
  watchers (:meth:`HealthMonitor.check_collective_round`, for the
  collective round loop): one degraded round marks the plane
  ``degraded`` (it recovers after clean rounds); a degraded-round
  fraction over budget, or a zero-landed *failed* round, latches
  ``failing``.
- **serve** — queue-saturation watcher
  (:meth:`HealthMonitor.check_serve_tick`): a queue at >= 80% of its bound
  for 16 consecutive ticks is ``degraded`` (clients are already eating
  429s); it clears once depth falls under 50%.
- **store** — corruption notices from the checkpoint plane
  (:meth:`HealthMonitor.note_store_corruption`): a skipped corrupt round
  marks the plane ``degraded`` (the run survived, the storage didn't).
- **fleet** — a replica the router's liveness ladder declared dead.

Plus a cross-plane device-memory growth watcher (:meth:`note_hbm_sample`):
live bytes growing monotonically across a full sample window is the
classic leak signature a latest-value gauge can't show.

Install discipline: module-global via ``telemetry.install`` (OFF by
default); every product hook is ``h = telemetry.health_active()`` + one
``None`` check.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Any

from photon_tpu_torch.utils.profiling import (
    ALERT_ADAPTER_COHORT,
    ALERT_DEGRADED_ROUNDS,
    ALERT_FLEET_REPLICA_DEAD,
    ALERT_HBM_GROWTH,
    ALERT_NONFINITE,
    ALERT_QUEUE_SATURATION,
    ALERT_STORE_CORRUPT,
    ALERT_STRAGGLERS,
)

OK = "ok"
DEGRADED = "degraded"
FAILING = "failing"
_LEVEL = {OK: 0, DEGRADED: 1, FAILING: 2}

#: every plane /statusz reports, present even before its first check
PLANES = ("federation", "collective", "serve", "store", "fleet")


@dataclasses.dataclass
class Alert:
    kind: str  # registry constant, always "alert/..."
    plane: str
    severity: str  # degraded | failing
    ts: float
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "plane": self.plane,
            "severity": self.severity,
            "ts": self.ts,
            "attrs": dict(self.attrs),
        }


@dataclasses.dataclass
class _PlaneState:
    status: str = OK
    reason: str = ""
    ts: float = 0.0
    latched: bool = False  # failing states don't auto-clear


class HealthMonitor:
    """Per-plane status + watcher state + the bounded alert tail.

    Thresholds are class attributes (override per instance in tests) —
    deliberately NOT config knobs: they encode what "unhealthy" means for
    this system, and a knob per threshold is how alerting rots into
    silence.
    """

    # collective: straggler percentile over a rolling round window
    straggler_window = 16
    straggler_pctile = 0.9
    straggler_frac_threshold = 0.25
    # collective: degraded-round budget (fraction of rounds on the ladder)
    degraded_budget_frac = 0.25
    degraded_budget_min_rounds = 4
    # collective: clean rounds before a non-latched degraded mark clears
    collective_clear_rounds = 2
    # serve: queue saturation enter/exit hysteresis
    queue_saturation_frac = 0.8
    queue_saturation_ticks = 16
    queue_clear_frac = 0.5
    # HBM growth: strictly-monotone growth across the window by this much
    hbm_window = 12
    hbm_growth_frac = 0.20
    max_alerts = 256

    def __init__(self, clock=time.time) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._planes: dict[str, _PlaneState] = {p: _PlaneState() for p in PLANES}
        self.alerts: deque[Alert] = deque(maxlen=self.max_alerts)
        # watcher state
        self._straggler_fracs: deque[float] = deque(maxlen=self.straggler_window)
        self._collective_rounds = 0
        self._collective_degraded = 0
        self._collective_clean_streak = 0
        self._sat_ticks = 0
        self._hbm: deque[float] = deque(maxlen=self.hbm_window)

    # -- core --------------------------------------------------------------
    def alert(self, kind: str, plane: str, severity: str = DEGRADED,
              **attrs: Any) -> Alert:
        """Record an alert, escalate its plane, and emit the registry-named
        event with trace correlation from the current span (if any)."""
        a = Alert(kind=kind, plane=plane, severity=severity,
                  ts=self._clock(), attrs=attrs)
        with self._lock:
            self.alerts.append(a)
            st = self._planes.setdefault(plane, _PlaneState())
            if _LEVEL.get(severity, 1) >= _LEVEL[st.status]:
                st.status = severity
                st.reason = kind
                st.ts = a.ts
            if severity == FAILING:
                st.latched = True
        # the event is emitted OUTSIDE the lock (the event log has its own);
        # emit_event is itself a None check when only health is somehow live
        from photon_tpu_torch import telemetry

        telemetry.emit_event(kind, plane=plane, severity=severity, **attrs)
        return a

    def resolve(self, plane: str, reason: str = "") -> None:
        """Return a plane to ``ok`` — unless a ``failing`` state latched it
        (a NaN'd aggregate doesn't heal because the next round was quiet)."""
        with self._lock:
            st = self._planes.setdefault(plane, _PlaneState())
            if st.latched:
                return
            if st.status != OK:
                st.status = OK
                st.reason = reason
                st.ts = self._clock()

    def plane_status(self, plane: str) -> str:
        with self._lock:
            st = self._planes.get(plane)
            return st.status if st is not None else OK

    def overall(self) -> str:
        with self._lock:
            worst = max(
                (st.status for st in self._planes.values()),
                key=lambda s: _LEVEL[s],
                default=OK,
            )
        return worst

    def statusz(self) -> dict:
        """The /statusz payload: overall + per-plane status + alert tail."""
        with self._lock:
            planes = {
                p: {"status": st.status, "reason": st.reason, "ts": st.ts}
                for p, st in self._planes.items()
            }
            alerts = [a.to_dict() for a in list(self.alerts)[-32:]]
        return {
            "status": max((p["status"] for p in planes.values()),
                          key=lambda s: _LEVEL[s], default=OK),
            "planes": planes,
            "alerts": alerts,
            "ts": self._clock(),
        }

    # -- watchers ----------------------------------------------------------
    def check_round_metrics(self, server_round: int,
                            metrics: dict[str, float]) -> list[Alert]:
        """NaN/Inf sentinel over a fit round's aggregated KPI dict — the
        aggregated delta norm, server/eval loss, client losses: ANY
        non-finite value means a poisoned aggregate reached the optimizer
        this round, which only gets worse. Latches federation failing."""
        bad = sorted(
            k for k, v in metrics.items()
            if isinstance(v, float) and not math.isfinite(v)
        )
        if not bad:
            return []
        return [self.alert(
            ALERT_NONFINITE, plane="federation", severity=FAILING,
            round=server_round, keys=bad,
        )]

    def check_collective_round(self, server_round: int, *, stragglers: int,
                               n_total: int, degraded: bool,
                               failed: bool = False) -> list[Alert]:
        """Straggler-percentile + degraded-round-budget watchers over the
        degradation ladder (one call per collective round, from the runner's
        record site)."""
        out: list[Alert] = []
        frac = stragglers / n_total if n_total > 0 else 0.0
        with self._lock:
            self._straggler_fracs.append(frac)
            self._collective_rounds += 1
            if degraded or failed:
                self._collective_degraded += 1
                self._collective_clean_streak = 0
            else:
                self._collective_clean_streak += 1
            fracs = sorted(self._straggler_fracs)
            pct = fracs[min(len(fracs) - 1,
                            int(self.straggler_pctile * (len(fracs) - 1) + 0.5))]
            window_full = len(self._straggler_fracs) == self._straggler_fracs.maxlen
            degraded_frac = self._collective_degraded / self._collective_rounds
            budget_ripe = self._collective_rounds >= self.degraded_budget_min_rounds
            clean_streak = self._collective_clean_streak
        if failed:
            out.append(self.alert(
                ALERT_DEGRADED_ROUNDS, plane="collective", severity=FAILING,
                round=server_round, detail="zero landed deltas: round failed",
            ))
        elif degraded:
            out.append(self.alert(
                ALERT_DEGRADED_ROUNDS, plane="collective", severity=DEGRADED,
                round=server_round, stragglers=stragglers,
                degraded_frac=round(degraded_frac, 4),
            ))
        if budget_ripe and degraded_frac > self.degraded_budget_frac:
            out.append(self.alert(
                ALERT_DEGRADED_ROUNDS, plane="collective", severity=FAILING,
                round=server_round, degraded_frac=round(degraded_frac, 4),
                budget=self.degraded_budget_frac,
                detail="degraded-round budget exhausted",
            ))
        if window_full and pct > self.straggler_frac_threshold:
            out.append(self.alert(
                ALERT_STRAGGLERS, plane="collective", severity=DEGRADED,
                round=server_round, pctile=self.straggler_pctile,
                straggler_frac=round(pct, 4),
            ))
        if not out and not degraded and not failed \
                and clean_streak >= self.collective_clear_rounds:
            self.resolve("collective", reason="clean rounds")
        return out

    def check_serve_tick(self, *, queue_depth: int, max_queue: int) -> Alert | None:
        """Queue-saturation watcher, one call per scheduler tick."""
        if max_queue <= 0:
            return None
        frac = queue_depth / max_queue
        fire = clear = False
        with self._lock:
            if frac >= self.queue_saturation_frac:
                self._sat_ticks += 1
                # fire exactly when the streak CROSSES the bound — a pinned
                # queue must not emit an alert per tick forever
                fire = self._sat_ticks == self.queue_saturation_ticks
            elif frac < self.queue_clear_frac:
                clear = self._sat_ticks >= self.queue_saturation_ticks
                self._sat_ticks = 0
        if fire:
            return self.alert(
                ALERT_QUEUE_SATURATION, plane="serve", severity=DEGRADED,
                queue_depth=queue_depth, max_queue=max_queue,
            )
        if clear:
            self.resolve("serve", reason="queue drained")
        return None

    def note_hbm_sample(self, bytes_in_use: float,
                        plane: str = "federation") -> Alert | None:
        """HBM-growth watcher: strictly-monotone growth across the whole
        sample window totalling > ``hbm_growth_frac`` is the leak
        signature (a stable sawtooth never fires). ``plane`` is the
        caller's plane — the serve scheduler's samples must not blame
        federation on /statusz."""
        with self._lock:
            self._hbm.append(float(bytes_in_use))
            if len(self._hbm) < self._hbm.maxlen:
                return None
            samples = list(self._hbm)
        monotone = all(b > a for a, b in zip(samples, samples[1:]))
        if not monotone or samples[0] <= 0:
            return None
        growth = (samples[-1] - samples[0]) / samples[0]
        if growth <= self.hbm_growth_frac:
            return None
        with self._lock:
            self._hbm.clear()  # re-arm: one alert per observed window
        return self.alert(
            ALERT_HBM_GROWTH, plane=plane, severity=DEGRADED,
            growth_frac=round(growth, 4), window=self.hbm_window,
            bytes_in_use=samples[-1],
        )

    def note_store_corruption(self, **attrs: Any) -> Alert:
        """Checkpoint-plane corruption notice (corrupt round skipped at
        resume, failed async write): the run survived, the storage didn't."""
        return self.alert(
            ALERT_STORE_CORRUPT, plane="store", severity=DEGRADED, **attrs
        )

    def note_fleet_replica_dead(self, **attrs: Any) -> Alert:
        """Fleet-plane degradation: the liveness ladder declared
        a serving replica dead — the fleet serves on at (N-1)/N capacity
        and the dead replica's cohorts re-pin to survivors. Degrades (never
        latches): the router resolves the plane when every tracked replica
        is live again."""
        return self.alert(
            ALERT_FLEET_REPLICA_DEAD, plane="fleet", severity=DEGRADED,
            **attrs,
        )

    def note_cohort_degraded(self, **attrs: Any) -> Alert:
        """Personalization-plane degradation: an adapter cohort
        lost every member for a round — that cohort's adapter stayed
        frozen while the rest of the round proceeded. Degrades the
        federation plane (it recovers when the cohort returns; a
        whole-round failure still comes from the collective watchers)."""
        return self.alert(
            ALERT_ADAPTER_COHORT, plane="federation", severity=DEGRADED,
            **attrs,
        )
