"""Prometheus ``/metrics`` + ``/statusz`` + ``POST /debug/profile`` server
(the port of ``photon_tpu/telemetry/prom.py``).

Stdlib-only: a ``ThreadingHTTPServer`` on a daemon thread.

``/metrics`` serves the full observatory exposition
(:func:`render_exposition`): the typed-instrument hub first — counters,
gauges, and histograms with correct ``# TYPE`` lines, cumulative buckets,
``+Inf``, and trace-id exemplars — then the History KPIs as gauges
(:func:`render_history`, the bridge for everything the round loop records
that has no typed twin), plus ``photon_last_round`` so scrapes can tell
staleness from stall.

``/statusz`` serves the health monitor's per-plane rollup
(federation / collective / serve / store / fleet → ok / degraded /
failing) with the recent alert tail (and, beside it, the profile controller's
status: its finished captures and last error, and the SLO autopilot's
decisions, rules and knobs when one is installed); ``POST /debug/profile``
arms the on-demand ``torch.profiler`` controller for N round units (409
while one is active).

Handler hardening: early 404s consume the request body (an unread body
desyncs HTTP/1.1 keep-alive — the next request line gets parsed out of
leftover bytes), every handler socket carries a read timeout so a
byte-dripping scraper can't pin a handler thread forever, handler threads
are named + daemon, and :meth:`PromServer.close` joins them bounded.

:func:`validate_exposition` is a structural check of a scrape (families
declared once, buckets cumulative, ``+Inf`` equal to ``_count``).

Gated by ``photon.telemetry.prom_port`` (0 = off). Port 0 is also the
bind-ephemeral spelling tests use directly on this class: the actual bound
port is on :attr:`PromServer.port` after :meth:`start`.
"""

from __future__ import annotations

import json
import re
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from photon_tpu_torch import telemetry
from photon_tpu_torch.telemetry.introspect import ProfileBusyError
from photon_tpu_torch.telemetry.metrics import metric_name

__all__ = ["PromServer", "metric_name", "render_exposition", "render_history",
           "validate_exposition"]


def render_history(history, skip: frozenset = frozenset()) -> str:
    """Latest-round KPIs in Prometheus text format (the History bridge).

    ``skip`` holds KPI names the typed hub already exposes under the same
    family name (a histogram's ``# TYPE x histogram`` next to the bridge's
    ``# TYPE x gauge`` would be a duplicate-family exposition error — the
    typed view wins, it carries strictly more information)."""
    lines: list[str] = []
    last_round = -1
    # snapshot in one C-level pass: the round loop inserts NEW keys as KPIs
    # first appear, and iterating the live dict from the scrape thread would
    # raise "dictionary changed size during iteration" mid-scrape
    snapshot = list(history.rounds.items())
    for key, series in sorted(snapshot):
        if not series or key in skip:
            continue
        rnd, value = series[-1]
        last_round = max(last_round, int(rnd))
        name = metric_name(key)
        # plain gauges, no per-metric round label: a label whose value
        # advances every round would mint a brand-new Prometheus series per
        # round, fragmenting every query over time. photon_last_round below
        # carries the round.
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {float(value):.10g}")
    lines.append("# TYPE photon_last_round gauge")
    lines.append(f"photon_last_round {last_round}")
    return "\n".join(lines) + "\n"


#: classic text format — exemplars are NOT legal here
CONTENT_TYPE_TEXT = "text/plain; version=0.0.4; charset=utf-8"
#: the OpenMetrics flavor exemplars ride under (negotiated via Accept)
CONTENT_TYPE_OPENMETRICS = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def negotiate_exposition(accept_header: str | None) -> tuple[bool, str]:
    """(want_openmetrics, content_type) from a scrape's Accept header.
    Exemplars are only emitted for scrapers that ask for OpenMetrics —
    a legacy v0.0.4 parser treats the ``#`` annotation after a value as a
    parse error and fails the WHOLE scrape."""
    if accept_header and "application/openmetrics-text" in accept_header:
        return True, CONTENT_TYPE_OPENMETRICS
    return False, CONTENT_TYPE_TEXT


def render_exposition(history=None, hub=None, exemplars: bool = False) -> str:
    """The full scrape body: typed instruments first, History gauges after.

    Instrument names and KPI names share the registry vocabulary but not
    the exposition spelling (counters get ``_total``, histograms expand to
    ``_bucket``/``_sum``/``_count``), so the two sections never collide on
    a series name. ``exemplars`` follows :func:`negotiate_exposition`.
    """
    parts: list[str] = []
    skip = frozenset()
    if hub is not None:
        rendered = hub.render(exemplars=exemplars)
        if rendered:
            parts.append(rendered)
        # counters add the _total suffix, so only gauge/histogram
        # instruments — and counters already NAMED *_total — can collide
        # with the bridge's gauge families
        skip = frozenset(
            n for n in hub.names()
            if getattr(hub.get(n), "kind", "") != "counter"
            or n.endswith("_total")
        )
    if history is not None:
        parts.append(render_history(history, skip=skip))
    return "".join(parts) if parts else "\n"


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{le="([^"]+)"\})? (\S+)( # \{[^}]*\} \S+ \S+)?$')


def validate_exposition(text: str) -> dict[str, dict]:
    """A structural check of a scrape (the classic text format, or
    OpenMetrics with exemplars and ``# EOF``): every family declared once
    before its samples, every sample line parseable, each histogram's
    buckets cumulative and ending in ``+Inf`` equal to its ``_count``.
    Returns ``{family: {"kind": ..., "value": latest sample, "buckets":
    [(le, count), ...], "count": ...}}``; raises ValueError on the first
    fault."""
    fams: dict[str, dict] = {}
    for n, line in enumerate(text.splitlines(), 1):
        if not line or line == "# EOF":
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in ("counter", "gauge", "histogram"):
                raise ValueError(f"line {n}: bad TYPE line {line!r}")
            if parts[2] in fams:
                raise ValueError(f"line {n}: family {parts[2]} declared twice")
            fams[parts[2]] = {"kind": parts[3], "buckets": []}
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {n}: unparseable sample {line!r}")
        name, le, raw = m.group(1), m.group(3), m.group(4)
        try:
            value = float(raw)
        except ValueError:
            raise ValueError(f"line {n}: bad value {raw!r}") from None
        fam = next((f for f in (name, name.rsplit("_", 1)[0]) if f in fams), None)
        if fam is None:
            raise ValueError(f"line {n}: sample {name} before its TYPE line")
        rec = fams[fam]
        if rec["kind"] == "histogram":
            if name == fam + "_bucket" and le is not None:
                rec["buckets"].append((le, value))
            elif name in (fam + "_sum", fam + "_count"):
                rec[name[len(fam) + 1:]] = value
            else:
                raise ValueError(f"line {n}: {name} is not a sample of histogram {fam}")
        else:
            if name != fam or le is not None:
                raise ValueError(f"line {n}: {name} is not a sample of {rec['kind']} {fam}")
            rec["value"] = value
    for fam, rec in fams.items():
        if rec["kind"] != "histogram":
            if "value" not in rec:
                raise ValueError(f"{fam}: declared without a sample")
            continue
        counts = [c for _, c in rec["buckets"]]
        if not counts or rec["buckets"][-1][0] != "+Inf":
            raise ValueError(f"{fam}: no +Inf bucket")
        if counts != sorted(counts):
            raise ValueError(f"{fam}: buckets not cumulative {counts}")
        if "count" not in rec or "sum" not in rec or counts[-1] != rec["count"]:
            raise ValueError(f"{fam}: +Inf {counts[-1]} != _count {rec.get('count')}")
    return fams


class PromServer:
    """Serve the observatory's HTTP face for a live :class:`History` (and,
    when installed, the typed-metric hub / health monitor / profile
    controller) on a daemon thread. All state is read under the GIL per
    scrape — record() appends are atomic enough for a monitoring read."""

    #: per-request socket timeout (seconds): a byte-dripping or silent
    #: scraper gets dropped instead of pinning its handler thread past
    #: close()'s bounded join
    handler_timeout_s = 10.0

    def __init__(self, history, port: int, host: str = "127.0.0.1", *,
                 hub=None, health=None, profiler=None) -> None:
        self.history = history
        self.host = host
        self.port = port
        self.hub = hub
        self.health = health
        self.profiler = profiler
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> int:
        srv = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive needs correct Content-Length on every response,
            # which _respond sets; 1.1 also gives curl-friendly reuse
            protocol_version = "HTTP/1.1"
            timeout = srv.handler_timeout_s  # socket read timeout

            def log_message(self, *args) -> None:  # silence per-scrape stderr
                pass

            # ---- helpers ----
            def _respond(self, code: int, body: bytes,
                         ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj: dict) -> None:
                self._respond(code, (json.dumps(obj) + "\n").encode())

            def _discard_body(self) -> None:
                # HTTP/1.1 keep-alive: an early reject must still consume
                # the request body or the connection desyncs — the peer's
                # next request line would be parsed out of leftover bytes
                try:
                    n = int(self.headers.get("Content-Length", 0) or 0)
                except ValueError:
                    n = 0
                if n > 0:
                    self.rfile.read(n)

            def _not_found(self) -> None:
                self._discard_body()
                self._json(404, {"error": f"no route {self.path!r}"})

            # ---- routes ----
            def do_GET(self) -> None:  # noqa: N802 — http.server API
                path = self.path.rstrip("/")
                if path in ("", "/metrics"):
                    want_om, ctype = negotiate_exposition(
                        self.headers.get("Accept")
                    )
                    body = render_exposition(
                        srv.history, srv.hub, exemplars=want_om
                    ).encode()
                    if want_om:
                        body += b"# EOF\n"
                    self._respond(200, body, ctype)
                elif path == "/statusz":
                    h = srv.health
                    payload = (h.statusz() if h is not None
                               else {"status": "ok", "planes": {},
                                     "alerts": [], "telemetry": "off"})
                    if srv.profiler is not None:
                        payload["profile"] = srv.profiler.status()
                    ap = telemetry.autopilot_active()
                    if ap is not None:
                        payload["autopilot"] = ap.statusz()
                    self._json(200, payload)
                else:
                    self._not_found()

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                if self.path.rstrip("/") != "/debug/profile":
                    self._not_found()
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad JSON body: {e}"})
                    return
                if not isinstance(body, dict):
                    # valid JSON that isn't an object (null, a list) must
                    # be a 400, not an AttributeError-killed handler
                    self._json(400, {"error": "body must be a JSON object"})
                    return
                p = srv.profiler
                if p is None:
                    self._json(503, {"error": "no profiler installed "
                                              "(telemetry disabled?)"})
                    return
                try:
                    armed = p.request(int(body.get("units", 1)),
                                      tag=str(body.get("tag", "ondemand")))
                except ProfileBusyError as e:
                    self._json(409, {"error": str(e), "status": p.status()})
                    return
                except (TypeError, ValueError) as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(202, {"armed": armed, "status": p.status()})

        class _Server(ThreadingHTTPServer):
            # named daemon handler threads + a bounded join at close: the
            # stdlib only tracks/joins NON-daemon handlers, and an unjoined
            # daemon mid-write would be truncated at interpreter exit
            def process_request(self, request, client_address):
                t = threading.Thread(
                    target=self.process_request_thread,
                    args=(request, client_address),
                    name="photon-prom-handler", daemon=True,
                )
                self._handler_threads.add(t)
                t.start()

            def join_handlers(self, timeout_s: float) -> bool:
                deadline = time.monotonic() + timeout_s
                for t in list(self._handler_threads):
                    t.join(timeout=max(0.0, deadline - time.monotonic()))
                return all(not t.is_alive() for t in self._handler_threads)

        self._httpd = _Server((self.host, self.port), Handler)
        self._httpd._handler_threads = weakref.WeakSet()
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="photon-prom", daemon=True
        )
        self._thread.start()
        return self.port

    def close(self, handler_join_s: float = 2.0) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            if handler_join_s > 0:
                # bounded even against a wedged scraper: each handler's
                # socket read times out within handler_timeout_s
                self._httpd.join_handlers(handler_join_s)
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
