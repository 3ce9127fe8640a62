"""Structured telemetry events: the JSONL log of discrete happenings.
(the port of ``photon_tpu/telemetry/events.py``)

Spans cover *durations*; events cover *moments* — the membership state
machine moving a node live→suspect→dead→readmitted, a chaos injection
firing, a TCP supervisor redialing, a corrupt frame tearing a connection
down. Each event carries the emitting process, a wall timestamp, free-form
attrs, and — when a tracer is installed and a span is open — the current
``trace_id``/``span_id``, so an event in the log can be correlated with the
exact round/fit window it interrupted.

Two modes, same class:

- **write-through** (server): ``path`` given — every emit appends one JSON
  line (line-buffered, under a lock) so the log survives a crash mid-run. A
  bounded in-memory tail is kept for the end-of-run Perfetto export (events
  render as instant markers on the timeline).
- **buffered** (node processes): no ``path`` — events accumulate and are
  drained alongside spans, piggybacked on ``FitRes``/``EvaluateRes``, and
  re-emitted into the server's write-through log.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any


class EventLog:
    def __init__(self, scope: str, path: str | None = None,
                 max_buffered: int = 4096) -> None:
        self.scope = scope
        self.path = path
        self.max_buffered = max(1, int(max_buffered))
        self._lock = threading.Lock()
        self._buf: deque[dict] = deque(maxlen=self.max_buffered)
        # ingest dedup by event id (chaos-duplicated reply frames can ship
        # the same drained event list twice, across scheduling windows)
        self._ingested_ids: set[str] = set()
        self._ingested_order: deque[str] = deque(maxlen=self.max_buffered)
        self._fh = None
        if path:
            import pathlib

            p = pathlib.Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(p, "a", buffering=1)  # noqa: SIM115 — long-lived log handle

    def emit(self, kind: str, attrs: dict[str, Any] | None = None,
             ctx: tuple | None = None) -> dict:
        from photon_tpu_torch.telemetry.spans import new_id

        ev = {
            # unique id: the receiver's ingest dedup key (events otherwise
            # have no natural identity, unlike spans)
            "id": new_id(),
            "ts": time.time(),
            "kind": kind,
            "proc": self.scope,
            "attrs": dict(attrs or {}),
        }
        if ctx:
            ev["trace_id"] = str(ctx[0])
            ev["span_id"] = str(ctx[1])
        self._record(ev)
        return ev

    def _record(self, ev: dict) -> None:
        with self._lock:
            self._buf.append(ev)
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(ev) + "\n")
                except (OSError, TypeError, ValueError):
                    pass  # the log must never take the run down with it

    # -- piggyback plumbing ----------------------------------------------
    def drain(self) -> list[dict]:
        """Pop buffered events (node side; write-through logs drain too so
        shipped copies aren't duplicated in the tail)."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out

    def ingest(self, events: list[dict] | None) -> int:
        """Record events shipped from another process (keeps their ``proc``
        and timestamps), skipping ids already ingested — a chaos-duplicated
        reply must not double-append to the JSONL log. Events without an
        ``id`` (foreign producers) are always accepted."""
        if not events:
            return 0
        n = 0
        for ev in events:
            if not (isinstance(ev, dict) and "kind" in ev):
                continue
            eid = ev.get("id")
            if eid is not None:
                with self._lock:
                    if eid in self._ingested_ids:
                        continue
                    if len(self._ingested_order) == self._ingested_order.maxlen:
                        self._ingested_ids.discard(self._ingested_order[0])
                    self._ingested_order.append(eid)
                    self._ingested_ids.add(eid)
            self._record(dict(ev))
            n += 1
        return n

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._buf)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_events_jsonl(path: str) -> list[dict]:
    """Parse an events JSONL file, skipping torn trailing lines (the writer
    may have been killed mid-append)."""
    out: list[dict] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return out
