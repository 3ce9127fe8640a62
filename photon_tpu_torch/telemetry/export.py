"""Perfetto / Chrome-trace export: one merged per-run timeline file.
(the port of ``photon_tpu/telemetry/export.py``)

The server's tracer ends a run holding its own spans *plus* every client
span shipped back piggybacked on fit/eval results; this module renders that
merged buffer as Chrome trace-event JSON (the ``traceEvents`` array format)
loadable in ``ui.perfetto.dev`` or ``chrome://tracing``.

Mapping:

- each distinct ``proc`` (``"server"``, ``"node0"``, ...) becomes a pid,
  named via ``process_name`` metadata events, so the timeline groups rows
  by process exactly like a real multi-process trace;
- spans are complete events (``"ph": "X"``) with microsecond ``ts``/``dur``
  on the wall-epoch clock (the only clock the processes share); ``args``
  carries the span's attrs plus its trace/span/parent ids so trace lineage
  is inspectable in the UI and assertable in tests;
- events are instant events (``"ph": "i"``, process scope) with their attrs
  and trace correlation in ``args``.

Chrome-trace complete events must strictly NEST within one ``(pid, tid)``
row, and spans from different threads of one process genuinely overlap
(decode-ahead pool workers vs the fold loop; the async checkpoint writer vs
the next round). Each span therefore carries its producing thread ident,
remapped here to small per-process tids — one timeline row per real thread,
so partial overlaps never mis-nest.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any


def chrome_trace_events(spans: list[dict], events: list[dict] | None = None) -> list[dict]:
    procs: dict[str, int] = {}
    tids: dict[tuple[str, int], int] = {}

    def pid(proc: str) -> int:
        if proc not in procs:
            procs[proc] = len(procs) + 1
        return procs[proc]

    def tid(proc: str, raw: int) -> int:
        """Remap a producing thread's ident to a small per-process tid."""
        key = (proc, int(raw))
        if key not in tids:
            tids[key] = sum(1 for p, _ in tids if p == proc) + 1
        return tids[key]

    out: list[dict[str, Any]] = []
    for sp in spans:
        args = dict(sp.get("attrs", {}))
        args["trace_id"] = sp.get("trace_id")
        args["span_id"] = sp.get("span_id")
        if sp.get("parent_id"):
            args["parent_id"] = sp["parent_id"]
        proc = sp.get("proc", "") or "unknown"
        out.append({
            "name": sp["name"],
            "cat": sp["name"].split("/", 1)[0],
            "ph": "X",
            "ts": float(sp["t_start"]) * 1e6,
            "dur": max(float(sp["duration_s"]), 0.0) * 1e6,
            "pid": pid(proc),
            "tid": tid(proc, sp.get("tid", 0)),
            "args": args,
        })
    for ev in events or []:
        args = dict(ev.get("attrs", {}))
        if ev.get("trace_id"):
            args["trace_id"] = ev["trace_id"]
        if ev.get("span_id"):
            args["span_id"] = ev["span_id"]
        out.append({
            "name": ev.get("kind", "event"),
            "cat": "event",
            "ph": "i",
            "s": "p",  # process-scoped instant marker
            "ts": float(ev.get("ts", 0.0)) * 1e6,
            "pid": pid(ev.get("proc", "") or "unknown"),
            "tid": 1,
            "args": args,
        })
    # metadata events LAST (they are position-independent): name the pids
    for proc, p in sorted(procs.items(), key=lambda kv: kv[1]):
        out.append({
            "name": "process_name",
            "ph": "M",
            "pid": p,
            "args": {"name": proc},
        })
    return out


def write_chrome_trace(path: str | pathlib.Path, spans: list[dict],
                       events: list[dict] | None = None,
                       metadata: dict | None = None) -> str:
    """Write the merged timeline; returns the path. The file is written
    whole (no append) — a per-run trace is regenerated, never extended."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    doc = {
        "traceEvents": chrome_trace_events(spans, events),
        "displayTimeUnit": "ms",
        "otherData": dict(metadata or {}),
    }
    tmp = p.with_suffix(p.suffix + ".tmp")
    # default=str: a non-JSON attr on one span (a Path, an ndarray scalar)
    # must degrade to its repr, not cost the whole timeline
    tmp.write_text(json.dumps(doc, default=str))
    tmp.replace(p)
    return str(p)


def load_chrome_trace(path: str | pathlib.Path) -> dict:
    """Parse a trace file back (test/tooling helper)."""
    return json.loads(pathlib.Path(path).read_text())


def span_index(trace: dict) -> dict[str, dict]:
    """``span_id → event`` over a loaded trace's complete events (ancestry
    checks in tests: walk ``args.parent_id`` through this index)."""
    out: dict[str, dict] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("args", {}).get("span_id"):
            out[ev["args"]["span_id"]] = ev
    return out
