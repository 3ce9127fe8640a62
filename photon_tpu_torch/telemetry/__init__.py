"""Distributed round tracing + structured telemetry plane (``photon.telemetry``;
the port of ``photon_tpu/telemetry/``).

It attributes a run's seconds to phases, nodes and rounds:

- :mod:`spans` — a thread-safe :class:`Tracer`; trace context rides every
  :class:`~photon_tpu_torch.federation.messages.Envelope` so client
  fit/eval spans parent to the server's round span across process
  boundaries, and nodes ship completed spans back piggybacked on
  ``FitRes``/``EvaluateRes``/``Ack``;
- :mod:`events` — a structured JSONL event log (membership transitions,
  chaos injections, reconnects, corrupt-frame teardowns, alerts), each
  with trace correlation;
- :mod:`export` — a Perfetto/Chrome-trace exporter merging server + node
  spans into one per-run timeline file;
- :mod:`metrics`, :mod:`prom`, :mod:`health`, :mod:`introspect` — the
  run-health observatory: typed counters, gauges and histograms served at
  ``/metrics``, per-plane health at ``/statusz``, on-demand
  ``torch.profiler`` captures through ``POST /debug/profile``, and the
  device-memory and kernel-build samplers;
- :mod:`autopilot` — the SLO controller (``telemetry.autopilot``),
  installed with the plane: it reads the hub and the health monitor and
  drives the knobs and actions the subsystems register with it.

Installation discipline matches ``photon_tpu_torch.chaos``: hook sites read
one module global and do nothing when it is ``None`` — with
``photon.telemetry.enabled=false`` (the default) the whole plane costs a
``None`` check per site, no rng, no locks, no I/O; with the plane on and
``telemetry.autopilot.enabled=false`` (its default), every autopilot hook
site is one ``None`` check on :func:`autopilot_active`.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Any, Iterator

from photon_tpu_torch.telemetry import introspect
from photon_tpu_torch.telemetry.events import EventLog, read_events_jsonl
from photon_tpu_torch.telemetry.health import HealthMonitor
from photon_tpu_torch.telemetry.introspect import ProfileController
from photon_tpu_torch.telemetry.metrics import MetricsHub
from photon_tpu_torch.telemetry.spans import Span, TraceContext, Tracer, new_id
from photon_tpu_torch.utils.profiling import SPANS_DROPPED

__all__ = [
    "EventLog",
    "HealthMonitor",
    "MetricsHub",
    "ProfileController",
    "Span",
    "TraceContext",
    "Tracer",
    "active",
    "attach",
    "autopilot_active",
    "current_context",
    "drain_events",
    "emit_event",
    "events_active",
    "health_active",
    "ingest",
    "install",
    "metric_inc",
    "metric_observe",
    "metric_set",
    "metrics_active",
    "new_id",
    "profile_tick",
    "profiler_active",
    "read_events_jsonl",
    "span",
    "timed_add",
    "uninstall",
]

_TRACER: Tracer | None = None
_EVENTS: EventLog | None = None
_METRICS: MetricsHub | None = None
_HEALTH: HealthMonitor | None = None
_PROFILER: ProfileController | None = None
_AUTOPILOT = None  # telemetry.autopilot.Autopilot | None (lazy import)

#: shared do-nothing context manager — the disabled-path ``span()`` return
#: value, allocated once so the hook sites stay allocation-free
_NULL_CM = contextlib.nullcontext()


def install(cfg, scope: str = "", events_path: str | None = None,
            piggyback: bool = False,
            profile_dir: str | None = None) -> Tracer | None:
    """Install (or clear) the process-global tracer + event log — and,
    with them, the run-health observatory (typed-metric hub, health
    monitor, compile counter, on-demand profile controller) — from a
    ``TelemetryConfig``.

    ``cfg=None`` or ``cfg.enabled=False`` uninstalls — constructing a
    ServerApp with telemetry off always leaves a clean process (the same
    contract as ``chaos.install``). ``events_path`` switches the event log
    to write-through JSONL (the server); without it events buffer and ride
    the piggyback plane (nodes). ``piggyback`` marks the tracer's buffer as
    drained-and-shipped by the node agent. ``profile_dir`` is where
    on-demand ``torch.profiler`` artifacts land (defaults to ``cfg.dir`` or
    the events file's directory).
    """
    global _TRACER, _EVENTS, _METRICS, _HEALTH, _PROFILER, _AUTOPILOT
    if cfg is None or not getattr(cfg, "enabled", False):
        uninstall()
        return None
    max_spans = int(getattr(cfg, "max_buffered_spans", 4096))
    tracer = Tracer(scope, max_buffered_spans=max_spans, piggyback=piggyback)
    if _EVENTS is not None:
        _EVENTS.close()
    _EVENTS = EventLog(scope, path=events_path, max_buffered=max_spans)
    _METRICS = MetricsHub(retention=int(getattr(cfg, "metrics_retention", 512)))
    _HEALTH = HealthMonitor()
    if profile_dir is None:
        profile_dir = getattr(cfg, "dir", "") or (
            str(pathlib.Path(events_path).parent) if events_path else "."
        )
    if _PROFILER is not None:
        _PROFILER.close()
    _PROFILER = ProfileController(profile_dir)
    introspect.install_compile_counter()
    # the SLO autopilot is installed with the plane it reads; subsystems
    # register their knobs against it as they construct
    ap_cfg = getattr(cfg, "autopilot", None)
    if ap_cfg is not None and getattr(ap_cfg, "enabled", False):
        from photon_tpu_torch.telemetry.autopilot import Autopilot

        _AUTOPILOT = Autopilot(ap_cfg)
    else:
        _AUTOPILOT = None
    # span-drop accounting: the bounded buffer's discards feed a counter,
    # and the FIRST drop of the run emits one warning event
    warned = [False]

    def _on_drop(total: int) -> None:
        hub = _METRICS
        if hub is not None:
            hub.counter(SPANS_DROPPED).inc()
        if not warned[0]:
            warned[0] = True
            emit_event(SPANS_DROPPED, dropped_total=total, scope=scope)

    tracer.on_drop = _on_drop
    _TRACER = tracer
    return _TRACER


def uninstall() -> None:
    global _TRACER, _EVENTS, _METRICS, _HEALTH, _PROFILER, _AUTOPILOT
    if _EVENTS is not None:
        _EVENTS.close()
    if _PROFILER is not None:
        _PROFILER.close()
    introspect.uninstall_compile_counter()
    _TRACER = None
    _EVENTS = None
    _METRICS = None
    _HEALTH = None
    _PROFILER = None
    _AUTOPILOT = None


def active() -> Tracer | None:
    """The installed tracer, or None — the single check every hook makes."""
    return _TRACER


def events_active() -> EventLog | None:
    return _EVENTS


def metrics_active() -> MetricsHub | None:
    """The installed typed-metric hub, or None (the one check per site)."""
    return _METRICS


def health_active() -> HealthMonitor | None:
    return _HEALTH


def profiler_active() -> ProfileController | None:
    return _PROFILER


def autopilot_active():
    """The installed SLO autopilot, or None (one check per hook site)."""
    return _AUTOPILOT


# -- hook-site helpers (each is a None check when disabled) ---------------

def span(name: str, parent: TraceContext | None = None, **attrs: Any):
    """Context manager: a span under the installed tracer, or a shared
    no-op when telemetry is off."""
    tr = _TRACER
    if tr is None:
        return _NULL_CM
    return tr.span(name, parent=parent, **attrs)


def current_context() -> TraceContext | None:
    tr = _TRACER
    return tr.current_context() if tr is not None else None


def attach(ctx: TraceContext | None):
    """Adopt a remote parent context (``Envelope.trace``) for a block."""
    tr = _TRACER
    if tr is None or not ctx:
        return _NULL_CM
    return tr.attach(ctx)


def emit_event(kind: str, **attrs: Any) -> None:
    """Record a structured event with trace correlation from the current
    span (if any). No-op when telemetry is off."""
    log = _EVENTS
    if log is None:
        return
    log.emit(kind, attrs, ctx=current_context())


def drain_events() -> list[dict]:
    log = _EVENTS
    return log.drain() if log is not None else []


def ingest(spans: list[dict] | None = None,
           events: list[dict] | None = None) -> None:
    """Fold spans/events shipped from another process into this process's
    tracer + event log (the server's merge points: fit/eval results,
    broadcast acks, ping acks, stale drains). A None check when off."""
    tr = _TRACER
    if tr is not None and spans:
        tr.ingest(spans)
    log = _EVENTS
    if log is not None and events:
        log.ingest(events)


def timed_add(name: str, **attrs: Any):
    """Measure a block and record it as a completed span WITHOUT pushing it
    on the context stack (transport legs: children should not parent to
    them). Returns the shared no-op context when disabled — a single None
    check, no generator allocation on the hot path."""
    tr = _TRACER
    if tr is None:
        return _NULL_CM
    return _timed_add_cm(tr, name, attrs)


@contextlib.contextmanager
def _timed_add_cm(tr: Tracer, name: str, attrs: dict) -> Iterator[None]:
    t_wall = time.time()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        tr.add_span(name, t_wall, time.perf_counter() - t0, **attrs)


# -- typed-metric hook helpers (each a single None check when disabled) ----

def metric_inc(name: str, n: float = 1.0) -> None:
    """Increment a counter on the installed hub; no-op when telemetry is
    off. ``name`` must be a registry constant."""
    hub = _METRICS
    if hub is None:
        return
    hub.counter(name).inc(n)


def metric_set(name: str, value: float) -> None:
    """Set a gauge on the installed hub; no-op when telemetry is off."""
    hub = _METRICS
    if hub is None:
        return
    hub.gauge(name).set(value)


def metric_observe(name: str, value: float) -> None:
    """Observe into a histogram on the installed hub, attaching the active
    span's trace context as the bucket exemplar; no-op when off."""
    hub = _METRICS
    if hub is None:
        return
    tr = _TRACER
    ctx = tr.current_context() if tr is not None else None
    hub.histogram(name).observe(value, exemplar=ctx)


def profile_tick(label: str) -> None:
    """Round/tick unit boundary for the on-demand profile controller
    (server round loop, serve scheduler loop): one None check when no
    controller is installed, two int reads when idle."""
    p = _PROFILER
    if p is not None:
        p.tick(label)
