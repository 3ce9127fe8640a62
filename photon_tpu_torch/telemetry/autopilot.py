"""SLO autopilot: the feedback controller that closes observe→actuate (the
port of ``photon_tpu/telemetry/autopilot.py``, pure Python).

The telemetry plane sees every failure mode (straggler p90, queue
saturation, HBM growth, wire-byte growth, TPOT regression); this module
drives declared SLOs using only actuators that already exist:

==================  =======================  ==============================
observed breach     windowed reduction       actuator
==================  =======================  ==============================
queue saturation    EWMA(queue depth)/bound  shrink ``prefill_token_budget``
TPOT p50 over SLO   p50 over window          lower ``SpecController`` K max
straggler p90 high  p90(straggler frac)      tighten collective stage timeout
wire bytes ramping  slope(wire counter)      escalate quantization off→q8
HBM watcher latch   alert-tail scan          prefix/adapter reclaim action
async rejects high  rejects per version      widen ``max_staleness``
replica latched     report-poll streak       drain + restart via control plane
==================  =======================  ==============================

The port has hook sites for the serve rules (the scheduler registers the
budget, the speculation ceiling and the reclaim action, and ticks the
``serve`` plane), the HBM reclaim and the fleet restart (the router asks
:meth:`Autopilot.request_replica_restart`). The collective and async rules
are here whole, and run against any knob registered under their names;
their planes (the collective and async runners) are not ported yet, so in
a run of the port nothing registers those knobs and, as in the JAX
package, an unregistered knob disables its rule.

Mechanics:

- **Registration, not imports.** Owning subsystems register a thin
  :class:`Actuator` (getter + setter) at install time; the controller
  never reaches into a subsystem it was not handed.
- **Declared optimum + bounds.** The knob's value at registration is the
  *declared* value; bounds come from ``AutopilotConfig``. Every actuation
  is reversible: after ``relax_after`` consecutive clean evaluations a
  rule probes back toward the declared value (hysteresis: the clean
  threshold sits below the breach threshold, so the controller can't
  chatter across one boundary).
- **Bounded actuation.** A breach actuates at most once per
  ``cooldown_s``; a breach with the knob already at its bound emits one
  ``autopilot/saturated`` event per episode, never a repeat actuation.
- **Audit trail.** Every decision is a registry-named ``autopilot/*``
  event carrying the rule, the observed metric, and the old/new knob
  values; the same record lands on a bounded ring surfaced at
  ``/statusz``, and every knob is mirrored as a typed hub gauge.

One deliberate difference from the JAX controller: an action rule (the
HBM reclaim) does not read its trigger inside its cooldown, so an alert
that lands there reclaims once the cooldown ends; JAX's reads it, marks it
seen and drops it.

Hook sites read ``telemetry.autopilot_active()`` and do nothing on
``None``: the disabled cost is one ``None`` check per site. The clock is
injectable so the tests drive cooldown and hysteresis deterministically.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable, Protocol

from photon_tpu_torch.utils.profiling import (
    ALERT_HBM_GROWTH,
    AUTOPILOT_ACTION_RECLAIM,
    AUTOPILOT_ACTION_RESTART,
    AUTOPILOT_ACTUATIONS,
    AUTOPILOT_KNOB_MAX_STALENESS,
    AUTOPILOT_KNOB_PREFILL_BUDGET,
    AUTOPILOT_KNOB_QUANT_LEVEL,
    AUTOPILOT_KNOB_SPEC_K_MAX,
    AUTOPILOT_KNOB_STAGE_TIMEOUT_S,
    AUTOPILOT_RELAXES,
    AUTOPILOT_RULES_BREACHED,
    AUTOPILOT_SATURATIONS,
    COLLECTIVE_STRAGGLER_FRAC,
    COLLECTIVE_WIRE_BYTES,
    EVENT_AUTOPILOT_ACTUATION,
    EVENT_AUTOPILOT_RELAX,
    EVENT_AUTOPILOT_SATURATED,
    SERVE_QUEUE_DEPTH,
    SERVE_TPOT_S,
)

#: decision event -> controller KPI counter
_DECISION_COUNTERS = {
    EVENT_AUTOPILOT_ACTUATION: AUTOPILOT_ACTUATIONS,
    EVENT_AUTOPILOT_RELAX: AUTOPILOT_RELAXES,
    EVENT_AUTOPILOT_SATURATED: AUTOPILOT_SATURATIONS,
}


class Actuator(Protocol):
    """What a subsystem registers: read + write one runtime knob."""

    def get(self) -> Any: ...

    def set(self, value: Any) -> None: ...


class KnobActuator:
    """A registered knob: getter/setter + numeric bounds + the declared
    value relax probes back toward. ``levels`` makes the knob an ordered
    enum (collective quantization ``("off", "q8")``) — get/set speak level
    strings while the controller moves an index."""

    def __init__(self, name: str, getter: Callable[[], Any],
                 setter: Callable[[Any], None], *, integer: bool = False,
                 levels: tuple[str, ...] | None = None) -> None:
        self.name = name
        self.get = getter
        self.set = setter
        self.levels = tuple(levels) if levels else None
        self.integer = bool(integer) or self.levels is not None
        self.declared = self.value()
        # bounds are resolved by Autopilot.register_knob from its config
        self.lo = self.declared
        self.hi = self.declared

    def value(self) -> float:
        """Current knob value, numerically (enum knobs: the level index)."""
        v = self.get()
        if self.levels is not None:
            return float(self.levels.index(v))
        return float(v)

    def clamp(self, num: float) -> float:
        num = min(self.hi, max(self.lo, num))
        if self.integer:
            num = float(int(round(num)))
        return num

    def display(self, num: float) -> Any:
        """The user-facing value a decision record carries."""
        if self.levels is not None:
            return self.levels[int(num)]
        if self.integer:
            return int(num)
        return round(float(num), 6)

    def apply(self, num: float) -> None:
        self.set(self.display(num) if self.levels is not None or self.integer
                 else float(num))


@dataclasses.dataclass
class _Rule:
    """One SLO rule: observe a windowed reduction, map a breach to a knob
    tighten (or a one-shot action), relax toward declared when clean.
    ``plane=None`` evaluates on every plane's tick (the HBM scan)."""

    name: str
    plane: str | None
    observe: Callable[["Autopilot"], float | None]
    knob: str | None = None
    action: str | None = None
    breach: Callable[["Autopilot", float], bool] = lambda ap, o: True
    clear: Callable[["Autopilot", float], bool] = lambda ap, o: False
    tighten: Callable[["Autopilot", float], float] | None = None


@dataclasses.dataclass
class _RuleState:
    breached: bool = False
    saturated: bool = False
    clean_streak: int = 0
    last_ts: float = float("-inf")  # last actuation (cooldown anchor)


class Autopilot:
    """The controller. One instance per process, installed with the
    telemetry plane; subsystems register knobs/actions at construction
    time, hook sites call :meth:`tick` from their existing observation
    points (serve tick, collective round tail, async event loop, fleet
    report poll)."""

    #: quantization ladder the wire rule escalates along
    QUANT_LEVELS = ("off", "q8")

    def __init__(self, cfg, clock: Callable[[], float] = time.time) -> None:
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        self._knobs: dict[str, KnobActuator] = {}
        self._actions: dict[str, Callable[[], Any]] = {}
        self._ctx: dict[str, dict[str, Any]] = {}
        self._last_eval: dict[str, float] = {}
        self._hbm_seen = 0.0
        self._async_prev: tuple[float, float] | None = None
        self._restart_ts: dict[str, float] = {}
        self.decisions: deque[dict] = deque(maxlen=int(cfg.decisions))
        self._rules = self._build_rules()
        self._state = {r.name: _RuleState() for r in self._rules}

    # -- registration (subsystems, at install time) ------------------------
    def register_knob(self, name: str, getter: Callable[[], Any],
                      setter: Callable[[Any], None], *,
                      integer: bool = False,
                      levels: tuple[str, ...] | None = None) -> KnobActuator:
        """Register a runtime-mutable knob. The current value becomes the
        declared optimum; bounds come from the config block. Re-registering
        a name replaces the previous actuator (a rebuilt subsystem owns its
        knob)."""
        k = KnobActuator(name, getter, setter, integer=integer, levels=levels)
        k.lo, k.hi = self._bounds(k)
        with self._lock:
            self._knobs[name] = k
        self._mirror_knob(k, k.declared)
        return k

    def register_action(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a one-shot actuation (reclaim, restart). The callable
        returns ``(before, after)`` — the observation the decision record
        carries as old/new."""
        with self._lock:
            self._actions[name] = fn

    def _bounds(self, k: KnobActuator) -> tuple[float, float]:
        c = self.cfg
        d = k.declared
        if k.name == AUTOPILOT_KNOB_PREFILL_BUDGET:
            return (min(float(c.prefill_budget_min), d), d)
        if k.name == AUTOPILOT_KNOB_SPEC_K_MAX:
            return (min(float(c.spec_k_min), d), d)
        if k.name == AUTOPILOT_KNOB_STAGE_TIMEOUT_S:
            return (min(float(c.stage_timeout_min_s), d), d)
        if k.name == AUTOPILOT_KNOB_QUANT_LEVEL:
            return (0.0, float(len(k.levels or ()) - 1))
        if k.name == AUTOPILOT_KNOB_MAX_STALENESS:
            return (d, max(d, float(c.max_staleness_hi)))
        return (d, d)

    # -- hook-site entry ---------------------------------------------------
    def tick(self, plane: str, **ctx: Any) -> None:
        """Evaluate ``plane``'s rules if ``period_s`` has elapsed. Never
        raises: controller trouble must not kill the driver thread that
        hosts the hook site."""
        try:
            now = self._clock()
            with self._lock:
                if ctx:
                    self._ctx.setdefault(plane, {}).update(ctx)
                last = self._last_eval.get(plane)
                if last is not None and now - last < float(self.cfg.period_s):
                    return
                self._last_eval[plane] = now
                for rule in self._rules:
                    if rule.plane is None or rule.plane == plane:
                        self._evaluate(rule, now)
                self._mirror_breached()
        except Exception as exc:  # pragma: no cover - defensive
            warnings.warn(f"autopilot tick failed: {exc!r}", stacklevel=2)

    def request_replica_restart(self, replica_id: str, reason: str,
                                observed: float = 1.0) -> bool:
        """Fleet-scope actuation: the router asks to drain + restart a
        replica whose compile/HBM watchers latched. Applies a per-replica
        cooldown and records the decision; the CALLER performs the restart
        through the control plane (it owns the control-socket lock).
        Returns approval."""
        now = self._clock()
        with self._lock:
            last = self._restart_ts.get(replica_id, float("-inf"))
            if now - last < float(self.cfg.cooldown_s):
                return False
            self._restart_ts[replica_id] = now
            self._decide(EVENT_AUTOPILOT_ACTUATION, "replica_restart",
                         AUTOPILOT_ACTION_RESTART, observed, "live",
                         "restarting", now, replica=replica_id,
                         reason=reason)
        return True

    # -- evaluation --------------------------------------------------------
    def _evaluate(self, rule: _Rule, now: float) -> None:
        st = self._state[rule.name]
        if rule.action is not None and now - st.last_ts < float(self.cfg.cooldown_s):
            # an action's trigger waits out the cooldown unread. The JAX
            # controller reads it first (the HBM scan marks the alert seen)
            # and then drops it inside the cooldown, so that alert never
            # reclaims; here it reclaims once the cooldown ends
            return
        obs = rule.observe(self)
        if obs is None:
            return
        if rule.breach(self, obs):
            st.breached = True
            st.clean_streak = 0
            if now - st.last_ts < float(self.cfg.cooldown_s):
                return
            self._tighten(rule, st, obs, now)
        elif rule.clear(self, obs):
            st.breached = False
            st.saturated = False
            knob = self._knobs.get(rule.knob) if rule.knob else None
            if knob is not None and knob.value() != knob.declared:
                st.clean_streak += 1
                if st.clean_streak >= int(self.cfg.relax_after):
                    st.clean_streak = 0
                    self._relax(rule, st, knob, obs, now)
        else:
            # dead band between clear and breach: stop tightening, but no
            # relax credit either — that's the hysteresis
            st.breached = False
            st.clean_streak = 0

    def _tighten(self, rule: _Rule, st: _RuleState, obs: float,
                 now: float) -> None:
        if rule.action is not None:
            fn = self._actions.get(rule.action)
            if fn is None:
                return
            result = fn()
            old, new = result if isinstance(result, tuple) else (None, result)
            st.last_ts = now
            self._decide(EVENT_AUTOPILOT_ACTUATION, rule.name, rule.action,
                         obs, old, new, now)
            return
        knob = self._knobs.get(rule.knob) if rule.knob else None
        if knob is None or rule.tighten is None:
            return
        cur = knob.value()
        new = knob.clamp(rule.tighten(self, cur))
        if new == cur:
            if not st.saturated:
                st.saturated = True
                self._decide(EVENT_AUTOPILOT_SATURATED, rule.name, knob.name,
                             obs, knob.display(cur), knob.display(cur), now)
            return
        st.saturated = False
        knob.apply(new)
        st.last_ts = now
        self._mirror_knob(knob, new)
        self._decide(EVENT_AUTOPILOT_ACTUATION, rule.name, knob.name, obs,
                     knob.display(cur), knob.display(new), now)

    def _relax(self, rule: _Rule, st: _RuleState, knob: KnobActuator,
               obs: float, now: float) -> None:
        cur = knob.value()
        new = knob.clamp(self._relax_step(knob, cur))
        if new == cur:
            return
        st.saturated = False
        knob.apply(new)
        st.last_ts = now
        self._mirror_knob(knob, new)
        self._decide(EVENT_AUTOPILOT_RELAX, rule.name, knob.name, obs,
                     knob.display(cur), knob.display(new), now)

    @staticmethod
    def _relax_step(knob: KnobActuator, cur: float) -> float:
        """One probe back toward the declared optimum: integer/enum knobs
        move one unit, continuous knobs halve the remaining gap (each
        probe is smaller than the last, so a re-breach near the declared
        value costs little)."""
        d = knob.declared
        if cur == d:
            return cur
        if knob.integer:
            return cur + (1.0 if d > cur else -1.0)
        return cur + (d - cur) * 0.5

    # -- decision plumbing -------------------------------------------------
    def _decide(self, kind: str, rule: str, knob: str, observed: Any,
                old: Any, new: Any, now: float, **attrs: Any) -> None:
        from photon_tpu_torch import telemetry

        rec = {"ts": now, "event": kind, "rule": rule, "knob": knob,
               "observed": observed, "old": old, "new": new}
        rec.update(attrs)
        self.decisions.append(rec)
        telemetry.emit_event(kind, rule=rule, knob=knob, observed=observed,
                             old=old, new=new, **attrs)
        hub = telemetry.metrics_active()
        if hub is not None:
            hub.counter(_DECISION_COUNTERS[kind]).inc()

    def _mirror_knob(self, knob: KnobActuator, num: float) -> None:
        from photon_tpu_torch import telemetry

        hub = telemetry.metrics_active()
        if hub is not None:
            hub.gauge(knob.name).set(float(num))

    def _mirror_breached(self) -> None:
        from photon_tpu_torch import telemetry

        hub = telemetry.metrics_active()
        if hub is not None:
            n = sum(1 for st in self._state.values() if st.breached)
            hub.gauge(AUTOPILOT_RULES_BREACHED).set(float(n))

    def statusz(self) -> dict:
        """The decision ring + per-rule/per-knob state merged into the
        ``/statusz`` payload by the serve frontend and PromServer."""
        with self._lock:
            return {
                "decisions": [dict(d) for d in self.decisions],
                "rules": {
                    r.name: {
                        "breached": self._state[r.name].breached,
                        "saturated": self._state[r.name].saturated,
                        "clean_streak": self._state[r.name].clean_streak,
                    }
                    for r in self._rules
                },
                "knobs": {
                    name: {
                        "value": k.display(k.value()),
                        "declared": k.display(k.declared),
                        "lo": k.lo,
                        "hi": k.hi,
                    }
                    for name, k in self._knobs.items()
                },
            }

    # -- rule observers ----------------------------------------------------
    def _hub(self):
        from photon_tpu_torch import telemetry

        return telemetry.metrics_active()

    def _obs_queue_frac(self) -> float | None:
        hub = self._hub()
        max_queue = self._ctx.get("serve", {}).get("max_queue")
        if hub is None or not max_queue:
            return None
        ewma = hub.gauge(SERVE_QUEUE_DEPTH).ewma(0.5, float(self.cfg.window_s))
        return None if ewma is None else ewma / float(max_queue)

    def _obs_tpot_p50(self) -> float | None:
        hub = self._hub()
        if hub is None:
            return None
        return hub.histogram(SERVE_TPOT_S).percentile(
            0.5, float(self.cfg.window_s))

    def _obs_straggler_p90(self) -> float | None:
        hub = self._hub()
        if hub is None:
            return None
        return hub.gauge(COLLECTIVE_STRAGGLER_FRAC).percentile(
            0.9, float(self.cfg.window_s))

    def _obs_wire_slope(self) -> float | None:
        hub = self._hub()
        if hub is None:
            return None
        return hub.counter(COLLECTIVE_WIRE_BYTES).slope(
            float(self.cfg.window_s))

    def _obs_hbm_alert(self) -> float | None:
        """A NEW HBM-growth alert since the last scan (any plane), or
        None. The health watcher already debounces (monotone growth across
        a full window), so one alert == one reclaim trigger."""
        from photon_tpu_torch import telemetry

        h = telemetry.health_active()
        if h is None:
            return None
        latest = None
        for a in list(h.alerts):
            if a.kind == ALERT_HBM_GROWTH and a.ts > self._hbm_seen:
                latest = a
        if latest is None:
            return None
        self._hbm_seen = latest.ts
        return float(latest.attrs.get("growth_frac", 1.0))

    def _obs_async_reject_rate(self) -> float | None:
        ctx = self._ctx.get("async", {})
        rejected = ctx.get("rejected_total")
        version = ctx.get("version")
        if rejected is None or version is None:
            return None
        prev = self._async_prev
        if prev is None or version < prev[1]:
            self._async_prev = (float(rejected), float(version))
            return None
        d_v = float(version) - prev[1]
        if d_v <= 0:
            return None
        rate = (float(rejected) - prev[0]) / d_v
        self._async_prev = (float(rejected), float(version))
        return rate

    def _build_rules(self) -> list[_Rule]:
        c = self.cfg
        rules = [
            _Rule(
                name="queue_budget", plane="serve",
                knob=AUTOPILOT_KNOB_PREFILL_BUDGET,
                observe=lambda ap: ap._obs_queue_frac(),
                breach=lambda ap, o: o >= float(c.queue_high_frac),
                clear=lambda ap, o: o <= float(c.queue_clear_frac),
                tighten=lambda ap, cur: cur * float(c.prefill_shrink),
            ),
            _Rule(
                name="hbm_reclaim", plane=None,
                action=AUTOPILOT_ACTION_RECLAIM,
                observe=lambda ap: ap._obs_hbm_alert(),
            ),
        ]
        if float(c.tpot_p50_slo_s) > 0:
            slo = float(c.tpot_p50_slo_s)
            rules.append(_Rule(
                name="tpot_spec_k", plane="serve",
                knob=AUTOPILOT_KNOB_SPEC_K_MAX,
                observe=lambda ap: ap._obs_tpot_p50(),
                breach=lambda ap, o: o > slo,
                clear=lambda ap, o: o <= slo * float(c.clear_frac),
                tighten=lambda ap, cur: cur - 1.0,
            ))
        if float(c.straggler_p90) > 0:
            tgt = float(c.straggler_p90)
            rules.append(_Rule(
                name="straggler_deadline", plane="collective",
                knob=AUTOPILOT_KNOB_STAGE_TIMEOUT_S,
                observe=lambda ap: ap._obs_straggler_p90(),
                breach=lambda ap, o: o > tgt,
                clear=lambda ap, o: o <= tgt * float(c.clear_frac),
                tighten=lambda ap, cur: cur * float(c.stage_timeout_shrink),
            ))
        if float(c.wire_slope_bytes_per_s) > 0:
            tgt = float(c.wire_slope_bytes_per_s)
            rules.append(_Rule(
                name="wire_quantization", plane="collective",
                knob=AUTOPILOT_KNOB_QUANT_LEVEL,
                observe=lambda ap: ap._obs_wire_slope(),
                breach=lambda ap, o: o > tgt,
                clear=lambda ap, o: o <= tgt * float(c.clear_frac),
                tighten=lambda ap, cur: cur + 1.0,
            ))
        if float(c.async_reject_per_version) > 0:
            tgt = float(c.async_reject_per_version)
            rules.append(_Rule(
                name="async_staleness", plane="async",
                knob=AUTOPILOT_KNOB_MAX_STALENESS,
                observe=lambda ap: ap._obs_async_reject_rate(),
                breach=lambda ap, o: o > tgt,
                clear=lambda ap, o: o <= tgt * float(c.clear_frac),
                tighten=lambda ap, cur: cur + 1.0,
            ))
        return rules
