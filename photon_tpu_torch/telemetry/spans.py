"""Distributed round tracing: spans, the thread-safe Tracer, wire context
(the port of ``photon_tpu/telemetry/spans.py``, unchanged in behaviour).

Model (a deliberately tiny subset of OpenTelemetry's):

- a :class:`Span` is a named wall-clock window with ``trace_id`` /
  ``span_id`` / ``parent_id`` and free-form ``attrs`` (round, cid,
  node_id, nbytes, ...). ``proc`` labels the process that produced it
  (``"server"`` or a node id) so a merged timeline groups by process.
- the :class:`Tracer` keeps a per-thread context stack; ``span()`` nests
  naturally, :meth:`Tracer.attach` pushes a *remote* parent received over
  the wire (``Envelope.trace``) so client-side spans parent to the server's
  round span across process boundaries.
- completed spans land in a bounded buffer (``max_buffered_spans``;
  overflow drops the oldest and counts the drop — tracing must never OOM
  the run it observes). Node processes :meth:`drain` the buffer and
  piggyback the spans on ``FitRes``/``EvaluateRes``; the server
  :meth:`ingest` s them, so ONE process holds the merged per-run
  timeline.

Timestamps: ``t_start`` is ``time.time()`` (wall epoch — the only clock
processes on one host share well enough for a merged timeline);
``duration_s`` is measured with ``time.perf_counter`` deltas.

Span names reuse the KPI constants in ``utils/profiling.py``
(``server/round_time``, ``client/fit_time``, ...) so the metrics plane and
the trace plane agree on vocabulary.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import deque
from typing import Any, Iterator

#: wire form of a span context: ``(trace_id, span_id)`` — small enough to
#: ride every Envelope, stable under pickle across versions
TraceContext = tuple


# id generation: ids only need to be unique within a run — no determinism
# contract. A per-process Mersenne stream seeded from os.urandom is far
# cheaper than a syscall per id (the span hot path makes 1-2 id draws per
# span, and in sandboxed containers even getpid costs ~8us — so the
# fork-safety hook re-seeds via os.register_at_fork instead of a per-call
# pid check). getrandbits is a single C call — atomic under the GIL, so no
# lock is needed.
import random as _random

_ID_RNG = _random.Random()


def _reseed_id_rng() -> None:
    _ID_RNG.seed(int.from_bytes(os.urandom(16), "big"))


_reseed_id_rng()
if hasattr(os, "register_at_fork"):  # POSIX only; spawn contexts re-import
    os.register_at_fork(after_in_child=_reseed_id_rng)


def new_id() -> str:
    """64-bit random hex id, unique within a run."""
    return f"{_ID_RNG.getrandbits(64):016x}"


@dataclasses.dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    proc: str
    t_start: float  # wall epoch seconds
    duration_s: float
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    # producing thread (threading.get_ident()): Chrome-trace complete events
    # must strictly NEST within one (pid, tid) row, and spans from different
    # threads of one process (decode-ahead pool workers, the async
    # checkpoint writer) partially overlap — each thread gets its own row
    tid: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(
            name=d["name"],
            trace_id=d["trace_id"],
            span_id=d["span_id"],
            parent_id=d.get("parent_id"),
            proc=d.get("proc", ""),
            t_start=float(d["t_start"]),
            duration_s=float(d["duration_s"]),
            attrs=dict(d.get("attrs", {})),
            tid=int(d.get("tid", 0)),
        )


class Tracer:
    """Thread-safe span factory + bounded completed-span buffer.

    ``piggyback=True`` (node processes) marks the buffer as meant to be
    drained and shipped back on fit/eval results; ``False`` (the server, and
    in-process nodes sharing the server's tracer) keeps spans local for the
    end-of-run export.
    """

    def __init__(self, scope: str, max_buffered_spans: int = 4096,
                 piggyback: bool = False) -> None:
        self.scope = scope
        self.piggyback = piggyback
        self.max_buffered_spans = max(1, int(max_buffered_spans))
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque()
        self.dropped = 0
        #: drop-accounting hook: called OUTSIDE the
        #: buffer lock with the cumulative drop count whenever the bounded
        #: buffer discards a span — the telemetry plane wires it to the
        #: ``telemetry/spans_dropped`` counter + a once-per-run warning
        #: event, so overflow is observable instead of silent
        self.on_drop = None
        self._tls = threading.local()
        # ingest dedup: a chaos-duplicated reply frame can drain in a LATER
        # scheduling window than its twin, where per-window mid dedup can't
        # see it — the span_ids inside are identical, so the merge point
        # drops repeats here (bounded memory, same cap as the span buffer)
        self._ingested_ids: set[str] = set()
        self._ingested_order: deque[str] = deque(maxlen=self.max_buffered_spans)

    # -- context stack ---------------------------------------------------
    def _stack(self) -> list[TraceContext]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_context(self) -> TraceContext | None:
        """``(trace_id, span_id)`` of the innermost open span on THIS
        thread (or an attached remote parent), else None."""
        st = self._stack()
        return st[-1] if st else None

    @contextlib.contextmanager
    def attach(self, ctx: TraceContext | None) -> Iterator[None]:
        """Adopt a remote parent context (``Envelope.trace``) for the
        duration of the block: spans opened inside parent to it."""
        if not ctx:
            yield
            return
        st = self._stack()
        st.append((str(ctx[0]), str(ctx[1])))
        try:
            yield
        finally:
            st.pop()

    # -- spans -----------------------------------------------------------
    def span(self, name: str, parent: TraceContext | None = None,
             **attrs: Any) -> "_OpenSpan":
        """Context manager opening a span; ``with ... as sp`` yields the
        (mutable) :class:`Span` so callers can add attrs mid-flight.
        ``parent`` overrides the thread's context stack (used by background
        threads that captured a context at enqueue time). A plain class CM
        rather than a generator: span() sits on per-round hot paths and
        the generator machinery roughly doubles its cost."""
        ctx = parent if parent is not None else self.current_context()
        sp = Span(
            name=name,
            trace_id=str(ctx[0]) if ctx else new_id(),
            span_id=new_id(),
            parent_id=str(ctx[1]) if ctx else None,
            proc=self.scope,
            t_start=time.time(),
            duration_s=0.0,
            attrs=attrs,  # **kwargs is already a fresh dict — no copy
            tid=threading.get_ident(),
        )
        return _OpenSpan(self, sp)

    def add_span(self, name: str, t_start: float, duration_s: float,
                 parent: TraceContext | None = None, **attrs: Any) -> Span:
        """Record an already-measured window (transport legs, pool workers
        — places where a context-manager around the hot path would be
        noise). ``t_start`` is wall epoch seconds."""
        ctx = parent if parent is not None else self.current_context()
        sp = Span(
            name=name,
            trace_id=str(ctx[0]) if ctx else new_id(),
            span_id=new_id(),
            parent_id=str(ctx[1]) if ctx else None,
            proc=self.scope,
            t_start=t_start,
            duration_s=duration_s,
            attrs=attrs,  # **kwargs is already a fresh dict — no copy
            tid=threading.get_ident(),
        )
        self._append(sp)
        return sp

    def _append(self, sp: Span) -> None:
        dropped = 0
        with self._lock:
            if len(self._spans) >= self.max_buffered_spans:
                self._spans.popleft()
                self.dropped += 1
                dropped = self.dropped
            self._spans.append(sp)
        if dropped:
            cb = self.on_drop
            if cb is not None:
                cb(dropped)

    # -- buffer ----------------------------------------------------------
    def drain(self) -> list[dict]:
        """Pop every completed span as a plain dict (the piggyback payload
        attached to ``FitRes.spans``)."""
        with self._lock:
            out = [s.to_dict() for s in self._spans]
            self._spans.clear()
        return out

    def ingest(self, span_dicts: list[dict] | None) -> int:
        """Append spans shipped from another process (keeps their ``proc``
        label), skipping span_ids already ingested — a chaos-duplicated
        reply must not double-emit its spans into the merged trace. Returns
        how many were accepted."""
        if not span_dicts:
            return 0
        n = 0
        for d in span_dicts:
            try:
                sp = Span.from_dict(d)
            except (KeyError, TypeError, ValueError):
                continue  # a malformed shipped span must never kill a round
            with self._lock:
                if sp.span_id in self._ingested_ids:
                    continue
                if len(self._ingested_order) == self._ingested_order.maxlen:
                    self._ingested_ids.discard(self._ingested_order[0])
                self._ingested_order.append(sp.span_id)
                self._ingested_ids.add(sp.span_id)
            self._append(sp)
            n += 1
        return n

    def snapshot(self) -> list[dict]:
        """Copy of the buffer (end-of-run export) without clearing it."""
        with self._lock:
            return [s.to_dict() for s in self._spans]

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


class _OpenSpan:
    """In-flight span handle: pushes its context on enter, completes and
    buffers the span on exit (including the exception path, so a failing
    phase still shows its true cost on the timeline)."""

    __slots__ = ("_tracer", "span", "_t0")

    def __init__(self, tracer: Tracer, span: Span) -> None:
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        sp = self.span
        self._tracer._stack().append((sp.trace_id, sp.span_id))
        self._t0 = time.perf_counter()
        return sp

    def __exit__(self, exc_type, exc, tb) -> None:
        sp = self.span
        sp.duration_s = time.perf_counter() - self._t0
        self._tracer._stack().pop()
        self._tracer._append(sp)
