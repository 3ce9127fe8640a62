"""The run-health observatory of the port, one case for each case of
``tests/test_observatory.py``, plus:

- parity with the JAX package's pure classes under an injected clock: the
  same instrument sequences render the same exposition text, byte for
  byte, in both formats (golden), and the same watcher calls give the
  same ``HealthMonitor.statusz()``;
- the five cases earlier slices owed: the prefix cache's and speculative
  decoding's KPIs recorded and registered, the hot-swap's event and
  histogram, the router's names in the registry and its ``/metrics``;
- the serve watcher's ``hotswap_statusz_url`` gate read against the port's
  own ``PromServer`` ``/statusz``;
- the port's own surfaces: ``device_memory`` never opening a CUDA
  context, the kernel-build counter, a real ``torch.profiler`` capture
  on the CPU, the fleet report's build count;
- ``chip_smoke.py``'s phase 16 rehearsed on the CPU.

The JAX package's telemetry is never installed here (its ``uninstall``
raises on jax 0.9.0); its side of each parity case drives the pure
classes, whose hook calls are ``None`` checks without an install.
"""

import http.client
import json
import math
import pathlib
import re
import threading
import time
import urllib.request

import numpy as np
import pytest

from photon_tpu_torch import chaos, telemetry
from photon_tpu_torch.config.schema import TelemetryConfig
from photon_tpu_torch.metrics.history import History
from photon_tpu_torch.telemetry import introspect
from photon_tpu_torch.telemetry.health import DEGRADED, FAILING, OK, PLANES, HealthMonitor
from photon_tpu_torch.telemetry.introspect import ProfileBusyError, ProfileController
from photon_tpu_torch.telemetry.metrics import DEFAULT_BYTES_BUCKETS, MetricsHub, metric_name
from photon_tpu_torch.telemetry.prom import (
    PromServer,
    render_exposition,
    validate_exposition,
)
from photon_tpu_torch.utils.profiling import (
    AGG_DECODE_TIME,
    ALERT_DEGRADED_ROUNDS,
    ALERT_HBM_GROWTH,
    ALERT_NONFINITE,
    ALERT_QUEUE_SATURATION,
    COMPILES_TOTAL,
    HBM_BYTES_IN_USE,
    HBM_PEAK_BYTES,
    ROUND_TIME,
    SERVE_QUEUE_WAIT_S,
    SERVE_TPOT_S,
    SERVE_TTFT_S,
    SPANS_DROPPED,
    TCP_SEND_BYTES,
    registered_metric_names,
)
from tests.test_torch_telemetry import make_app
from tests.test_torch_tcp import make_cfg
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_planes():
    telemetry.uninstall()
    chaos.uninstall()
    yield
    telemetry.uninstall()
    chaos.uninstall()


class _Clock:
    """An injected clock: 1000.0, then +0.5 per read."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.5
        return self.t


# ---------------------------------------------------------------------------
# typed instruments: golden exposition format
# ---------------------------------------------------------------------------


def test_counter_exposition_type_line_and_total_suffix():
    hub = MetricsHub()
    hub.counter(SPANS_DROPPED).inc()
    hub.counter(SPANS_DROPPED).inc(2)
    text = hub.render()
    name = metric_name(SPANS_DROPPED) + "_total"
    assert f"# TYPE {name} counter" in text and f"{name} 3" in text
    with pytest.raises(ValueError):
        hub.counter(SPANS_DROPPED).inc(-1)


def test_gauge_exposition():
    hub = MetricsHub()
    hub.gauge(HBM_BYTES_IN_USE).set(123456)
    text = hub.render()
    assert f"# TYPE {metric_name(HBM_BYTES_IN_USE)} gauge" in text
    assert f"{metric_name(HBM_BYTES_IN_USE)} 123456" in text


def test_histogram_golden_format():
    hub = MetricsHub()
    h = hub.histogram(ROUND_TIME, buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.7, 5.0, 100.0):
        h.observe(v)
    name = metric_name(ROUND_TIME)
    assert [ln for ln in hub.render().splitlines() if ln] == [
        f"# TYPE {name} histogram",
        f'{name}_bucket{{le="0.1"}} 1',
        f'{name}_bucket{{le="1"}} 3',
        f'{name}_bucket{{le="10"}} 4',
        f'{name}_bucket{{le="+Inf"}} 5',
        f"{name}_sum 106.25",
        f"{name}_count 5",
    ]


def test_histogram_exemplar_carries_trace_context():
    telemetry.install(TelemetryConfig(enabled=True), scope="t")
    hub = telemetry.metrics_active()
    with telemetry.span("server/round", round=1) as sp:
        telemetry.metric_observe(SERVE_TTFT_S, 0.03)
    m = re.search(r'_bucket\{le="0\.05"\} 1 # \{trace_id="([0-9a-f]{16})",'
                  r'span_id="([0-9a-f]{16})"\} 0\.03 \d+\.\d+', hub.render())
    assert m and m.group(1) == sp.trace_id and m.group(2) == sp.span_id


def test_exposition_content_negotiation():
    from photon_tpu_torch.telemetry.prom import negotiate_exposition

    telemetry.install(TelemetryConfig(enabled=True), scope="t")
    with telemetry.span("server/round", round=1):
        telemetry.metric_observe(SERVE_TTFT_S, 0.03)
    hub = telemetry.metrics_active()
    assert "trace_id" in hub.render(exemplars=True)
    assert "trace_id" not in hub.render(exemplars=False)
    assert negotiate_exposition(None) == (False, "text/plain; version=0.0.4; charset=utf-8")
    want, ctype = negotiate_exposition("application/openmetrics-text;version=1.0.0,"
                                       "text/plain;q=0.5")
    assert want and ctype.startswith("application/openmetrics-text")
    srv = PromServer(History(), port=0, hub=hub)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        plain = urllib.request.urlopen(url, timeout=5)
        assert plain.headers["Content-Type"].startswith("text/plain")
        assert b"trace_id" not in plain.read()
        om = urllib.request.urlopen(urllib.request.Request(
            url, headers={"Accept": "application/openmetrics-text"}), timeout=5)
        assert om.headers["Content-Type"].startswith("application/openmetrics-text")
        body = om.read()
        assert b"trace_id" in body and body.endswith(b"# EOF\n")
        validate_exposition(body.decode())
    finally:
        srv.close()


def test_scrape_twice_counters_cumulative_histograms_monotone():
    hub = MetricsHub()
    hub.counter(COMPILES_TOTAL).inc(5)
    h = hub.histogram(ROUND_TIME, buckets=(1.0, 10.0))
    h.observe(0.5)

    def parse(text):
        counts = {}
        for ln in text.splitlines():
            m = re.match(r"(\S+?)\{le=\"([^\"]+)\"\} (\d+)", ln)
            if m:
                counts[m.group(2)] = int(m.group(3))
            m = re.match(r"(\S+_total) (\S+)", ln)
            if m:
                counts["total"] = float(m.group(2))
        return counts

    first = parse(hub.render())
    hub.counter(COMPILES_TOTAL).inc(1)
    h.observe(2.0)
    h.observe(50.0)
    second = parse(hub.render())
    assert first == {"1": 1, "10": 1, "+Inf": 1, "total": 5.0}
    assert second == {"1": 1, "10": 2, "+Inf": 3, "total": 6.0}
    assert all(second[k] >= first[k] for k in first)


def test_instrument_kind_clash_raises():
    hub = MetricsHub()
    hub.counter(COMPILES_TOTAL)
    with pytest.raises(ValueError, match="already registered"):
        hub.histogram(COMPILES_TOTAL)


def test_bytes_named_histograms_get_bytes_buckets():
    assert MetricsHub().histogram(TCP_SEND_BYTES).buckets == DEFAULT_BYTES_BUCKETS


def test_ring_buffer_retention_and_percentile():
    hub = MetricsHub(retention=4)
    h = hub.histogram(AGG_DECODE_TIME)
    for v in range(10):
        h.observe(float(v))
    assert h.recent_values() == [6.0, 7.0, 8.0, 9.0]
    assert h.percentile(1.0) == 9.0 and h.percentile(0.0) == 6.0
    c = hub.counter(COMPILES_TOTAL)
    for _ in range(10):
        c.inc()
    assert len(c.series()) == 4


def test_windowed_reducers_match_jax():
    """percentile, rate, slope and ewma over an injected clock: the JAX
    package's numbers."""
    from photon_tpu.telemetry.metrics import MetricsHub as JaxHub

    got, want = MetricsHub(retention=8, clock=_Clock()), JaxHub(retention=8, clock=_Clock())
    for hub in (got, want):
        g = hub.gauge(HBM_BYTES_IN_USE)
        for v in (1.0, 3.0, 2.0, 5.0, 8.0, 7.0, 9.0, 12.0, 11.0, 15.0):
            g.set(v)
    a, b = got.gauge(HBM_BYTES_IN_USE), want.gauge(HBM_BYTES_IN_USE)
    for w in (None, 2.0, 3.5):
        assert a.percentile(0.9, w) == b.percentile(0.9, w)
        assert a.rate(w) == b.rate(w) and a.slope(w) == b.slope(w)
        assert a.ewma(0.3, w) == b.ewma(0.3, w)


def test_counter_inc_to_is_monotone():
    c = MetricsHub().counter(COMPILES_TOTAL)
    c.inc_to(7)
    c.inc_to(3)
    assert c.value == 7.0
    c.inc_to(9)
    assert c.value == 9.0


def test_render_exposition_skips_colliding_history_gauges():
    hub = MetricsHub()
    hub.histogram(ROUND_TIME).observe(1.0)
    hub.counter(COMPILES_TOTAL).inc(2)
    hub.counter("serve/evictions").inc(3)
    hist = History()
    hist.record(1, {ROUND_TIME: 1.0, COMPILES_TOTAL: 2.0, "serve/evictions": 3.0,
                    "server/n_clients": 4.0})
    text = render_exposition(hist, hub)
    name = metric_name(ROUND_TIME)
    assert text.count(f"# TYPE {name} ") == 1 and f"# TYPE {name} histogram" in text
    assert text.count(f"# TYPE {metric_name(COMPILES_TOTAL)} ") == 1
    assert f"# TYPE {metric_name(COMPILES_TOTAL)} counter" in text
    assert f"# TYPE {metric_name('serve/evictions')}_total counter" in text
    assert f"# TYPE {metric_name('serve/evictions')} gauge" in text
    assert f"# TYPE {metric_name('server/n_clients')} gauge" in text
    assert "photon_last_round" in text
    validate_exposition(text)


def test_full_exposition_validates_structurally():
    hub = MetricsHub()
    hub.counter(COMPILES_TOTAL).inc(3)
    hub.gauge(HBM_BYTES_IN_USE).set(1e9)
    for v in (0.01, 0.2, 3.0):
        hub.histogram(SERVE_TTFT_S).observe(v)
    fams = validate_exposition(hub.render())
    assert fams[metric_name(COMPILES_TOTAL)]["kind"] == "counter"
    assert fams[metric_name(HBM_BYTES_IN_USE)]["kind"] == "gauge"
    ttft = fams[metric_name(SERVE_TTFT_S)]
    assert ttft["kind"] == "histogram" and ttft["buckets"][-1] == ("+Inf", 3.0)
    assert ttft["count"] == 3.0


def test_exposition_validator_gates_malformed_scrapes():
    """The counterpart of the JAX suite's bench-report gate case (the port
    has no ``bench.py``): the scrape gate of phase 16 refuses a family
    declared twice, buckets that are not cumulative, a ``+Inf`` bucket
    other than ``_count``, a sample before its TYPE line and a garbled
    line, and passes the hub's own renderings."""
    good = MetricsHub()
    good.histogram(ROUND_TIME, buckets=(1.0,)).observe(0.5)
    text = good.render()
    validate_exposition(text)
    name = metric_name(ROUND_TIME)
    for bad, why in (
        (text + text, "declared twice"),
        (text.replace(f'{name}_bucket{{le="1"}} 1', f'{name}_bucket{{le="1"}} 2'),
         "not cumulative"),
        (text.replace(f"{name}_count 1", f"{name}_count 2"), "_count"),
        ("photon_x 1\n", "before its TYPE"),
        ("# TYPE photon_x gauge\nphoton_x one\n", "bad value"),
        ("# TYPE photon_x gauge\nphoton x 1\n", "unparseable"),
    ):
        with pytest.raises(ValueError, match=why):
            validate_exposition(bad)


def test_new_kpi_names_are_registered():
    names = registered_metric_names()
    for expect in (SERVE_TPOT_S, SERVE_QUEUE_WAIT_S, HBM_BYTES_IN_USE, HBM_PEAK_BYTES,
                   COMPILES_TOTAL, "serve/hbm_bytes_in_use", "serve/backend_compiles_total"):
        assert expect in names, expect


def _drive_hub(hub_cls, history_cls):
    hub = hub_cls(retention=16, clock=_Clock())
    hub.counter(COMPILES_TOTAL).inc(2)
    hub.counter(COMPILES_TOTAL).inc_to(5)
    hub.counter("serve/evictions").inc(3)
    hub.gauge(HBM_BYTES_IN_USE).set(123456789)
    hub.gauge("serve/slot_occupancy").set(0.375)
    for v, ex in ((0.004, ("a" * 16, "b" * 16)), (0.3, None), (2.0, ("c" * 16, "d" * 16)),
                  (75.0, ("e" * 16, ""))):
        hub.histogram(SERVE_TTFT_S).observe(v, exemplar=ex)
    for v in (300.0, 70000.0):
        hub.histogram(TCP_SEND_BYTES).observe(v)
    hub.histogram(ROUND_TIME, buckets=(0.1, 1.0)).observe(0.5)
    hist = history_cls()
    hist.record(1, {ROUND_TIME: 0.5, COMPILES_TOTAL: 5.0, "serve/evictions": 3.0,
                    "server/n_clients": 2.0})
    hist.record(2, {"server/n_clients": 3.0})
    return hub, hist


@pytest.mark.parametrize("exemplars", [False, True], ids=["text", "openmetrics"])
def test_exposition_text_matches_jax_golden(exemplars):
    """The same instrument sequence under an injected clock renders the
    JAX package's exposition, byte for byte, in both formats."""
    from photon_tpu.metrics.history import History as JaxHistory
    from photon_tpu.telemetry.metrics import MetricsHub as JaxHub
    from photon_tpu.telemetry.prom import render_exposition as jax_render

    ours = render_exposition(*reversed(_drive_hub(MetricsHub, History)), exemplars=exemplars)
    theirs = jax_render(*reversed(_drive_hub(JaxHub, JaxHistory)), exemplars=exemplars)
    assert ours == theirs
    assert ("# {trace_id=" in ours) == exemplars
    fams = validate_exposition(ours)
    assert fams[metric_name(SERVE_TTFT_S)]["count"] == 4.0
    assert fams["photon_last_round"]["value"] == 2.0


def _drive_health(cls):
    h = cls(clock=_Clock())
    h.queue_saturation_ticks = 3
    h.check_round_metrics(1, {"server/round_time": 1.0})
    for _ in range(3):
        h.check_serve_tick(queue_depth=60, max_queue=64)
    h.check_collective_round(1, stragglers=1, n_total=4, degraded=True)
    h.note_store_corruption(round=2, run_uuid="r", stage="resume")
    h.note_fleet_replica_dead(replica="replica1", survivors=2, repinned=1)
    h.check_round_metrics(2, {"server/pseudo_grad_norm": float("nan"),
                              "server/eval_loss": 1.0})
    h.resolve("fleet", reason="all replicas live")
    return h.statusz()


def test_statusz_matches_jax_health_monitor():
    """The same watcher calls under an injected clock give JAX's
    ``HealthMonitor.statusz()``: planes, reasons, alert tail and times."""
    from photon_tpu.telemetry.health import HealthMonitor as JaxHealth

    ours, theirs = _drive_health(HealthMonitor), _drive_health(JaxHealth)
    assert ours == theirs
    assert ours["status"] == FAILING and ours["planes"]["fleet"]["status"] == OK
    assert [a["kind"] for a in ours["alerts"]] == [
        ALERT_QUEUE_SATURATION, ALERT_DEGRADED_ROUNDS, "alert/store_corrupt",
        "alert/fleet_replica_dead", ALERT_NONFINITE]


# ---------------------------------------------------------------------------
# health monitor + watchers
# ---------------------------------------------------------------------------


def test_nonfinite_sentinel_latches_federation_failing():
    h = HealthMonitor()
    assert h.check_round_metrics(3, {"server/round_time": 1.0}) == [] and h.overall() == OK
    alerts = h.check_round_metrics(4, {"server/pseudo_grad_norm": float("nan"),
                                       "server/eval_loss": float("inf"),
                                       "server/round_time": 1.0})
    assert len(alerts) == 1 and alerts[0].kind == ALERT_NONFINITE
    assert alerts[0].attrs["keys"] == ["server/eval_loss", "server/pseudo_grad_norm"]
    assert h.plane_status("federation") == FAILING
    h.resolve("federation")
    assert h.plane_status("federation") == FAILING
    z = h.statusz()
    assert z["status"] == FAILING and set(z["planes"]) == set(PLANES)


def test_collective_degraded_and_budget_watchers():
    h = HealthMonitor()
    h.degraded_budget_min_rounds = 4
    h.check_collective_round(1, stragglers=1, n_total=4, degraded=True)
    assert h.plane_status("collective") == DEGRADED
    h.check_collective_round(2, stragglers=0, n_total=4, degraded=False)
    h.check_collective_round(3, stragglers=0, n_total=4, degraded=False)
    assert h.plane_status("collective") == OK
    h.check_collective_round(4, stragglers=2, n_total=4, degraded=True)
    assert h.plane_status("collective") == FAILING
    assert ALERT_DEGRADED_ROUNDS in [a.kind for a in h.alerts]


def test_collective_failed_round_is_failing():
    h = HealthMonitor()
    h.check_collective_round(1, stragglers=4, n_total=4, degraded=False, failed=True)
    assert h.plane_status("collective") == FAILING


def test_straggler_percentile_watcher_needs_full_window():
    h = HealthMonitor()
    h.straggler_window = 4
    h._straggler_fracs = type(h._straggler_fracs)(maxlen=4)
    for r in range(3):
        h.check_collective_round(r, stragglers=2, n_total=4, degraded=False)
    assert all(a.kind != "alert/stragglers" for a in h.alerts)
    h.check_collective_round(3, stragglers=2, n_total=4, degraded=False)
    assert any(a.kind == "alert/stragglers" for a in h.alerts)
    assert h.plane_status("collective") == DEGRADED


def test_queue_saturation_hysteresis():
    h = HealthMonitor()
    h.queue_saturation_ticks = 4
    for _ in range(3):
        assert h.check_serve_tick(queue_depth=60, max_queue=64) is None
    a = h.check_serve_tick(queue_depth=60, max_queue=64)
    assert a is not None and a.kind == ALERT_QUEUE_SATURATION
    assert h.plane_status("serve") == DEGRADED
    assert h.check_serve_tick(queue_depth=64, max_queue=64) is None
    h.check_serve_tick(queue_depth=10, max_queue=64)
    assert h.plane_status("serve") == OK
    assert sum(a.kind == ALERT_QUEUE_SATURATION for a in h.alerts) == 1


def test_hbm_growth_watcher_monotone_window_only():
    h = HealthMonitor()
    h.hbm_window = 4
    h._hbm = type(h._hbm)(maxlen=4)
    base = 1_000_000.0
    for v in (base, base * 1.2, base, base * 1.2, base):
        assert h.note_hbm_sample(v) is None
    h._hbm.clear()
    out = [h.note_hbm_sample(base * f) for f in (1.0, 1.1, 1.2, 1.35)]
    assert out[-1] is not None and out[-1].kind == ALERT_HBM_GROWTH


def test_alert_event_has_trace_correlation():
    telemetry.install(TelemetryConfig(enabled=True), scope="server")
    h = telemetry.health_active()
    with telemetry.span("server/round", round=7):
        h.alert(ALERT_NONFINITE, plane="federation", severity=FAILING, round=7)
    ev = next(e for e in telemetry.events_active().snapshot() if e["kind"] == ALERT_NONFINITE)
    assert ev["trace_id"] and ev["span_id"] and ev["attrs"]["plane"] == "federation"


# ---------------------------------------------------------------------------
# PromServer: exposition + statusz + debug/profile + handler hardening
# ---------------------------------------------------------------------------


class FakeProfiler:
    def __init__(self):
        self.calls = []

    def start_trace(self, out):
        self.calls.append(("start", out))

    def stop_trace(self):
        self.calls.append(("stop",))


def _prom(tmp_path, with_profiler=True):
    hub = MetricsHub()
    hub.histogram(SERVE_TTFT_S).observe(0.02)
    prof = ProfileController(str(tmp_path), profiler=FakeProfiler()) if with_profiler else None
    hist = History()
    hist.record(1, {"server/round_time": 0.5})
    srv = PromServer(hist, port=0, hub=hub, health=HealthMonitor(), profiler=prof)
    srv.start()
    return srv


def test_prom_serves_typed_exposition_and_statusz(tmp_path):
    srv = _prom(tmp_path)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(base + "/metrics", timeout=5).read().decode()
        assert f"# TYPE {metric_name(SERVE_TTFT_S)} histogram" in body
        assert 'le="+Inf"' in body and "photon_server_round_time 0.5" in body
        z = json.loads(urllib.request.urlopen(base + "/statusz", timeout=5).read())
        assert z["status"] == "ok" and set(z["planes"]) == set(PLANES)
        assert z["profile"]["completed"] == [] and z["profile"]["last_error"] is None
        srv.health.alert(ALERT_NONFINITE, plane="federation", severity=FAILING)
        z = json.loads(urllib.request.urlopen(base + "/statusz", timeout=5).read())
        assert z["status"] == "failing" and z["planes"]["federation"]["status"] == "failing"
        assert z["alerts"][-1]["kind"] == ALERT_NONFINITE
    finally:
        srv.close()


def test_prom_debug_profile_endpoint(tmp_path):
    srv = _prom(tmp_path)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        payload = json.dumps({"units": 2, "tag": "t"}).encode()
        conn.request("POST", "/debug/profile", body=payload,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 202
        assert json.loads(r.read())["armed"] == {"armed_units": 2, "tag": "t"}
        conn.request("POST", "/debug/profile", body=payload,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 409
        r.read()
        conn.close()
    finally:
        srv.close()


def test_prom_profile_503_when_no_profiler(tmp_path):
    srv = _prom(tmp_path, with_profiler=False)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        conn.request("POST", "/debug/profile", body=b"{}")
        assert conn.getresponse().status == 503
        conn.close()
    finally:
        srv.close()


def test_prom_keepalive_404_with_body_does_not_desync(tmp_path):
    srv = _prom(tmp_path)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        for _ in range(2):
            conn.request("POST", "/no/such/route", body=b"x" * 4096)
            r = conn.getresponse()
            assert r.status == 404
            r.read()
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        assert r.status == 200 and b"# TYPE" in r.read()
        conn.close()
    finally:
        srv.close()


def test_prom_handler_has_socket_timeout_and_close_is_bounded(tmp_path):
    import socket

    srv = _prom(tmp_path)
    assert srv.handler_timeout_s > 0
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
    s.sendall(b"GET /metr")  # a partial request line, then a stall
    t0 = time.monotonic()
    srv.close(handler_join_s=2.0)
    assert time.monotonic() - t0 < 8.0
    s.close()


# ---------------------------------------------------------------------------
# on-demand profiling controller
# ---------------------------------------------------------------------------


def test_profile_controller_lifecycle(tmp_path):
    fake = FakeProfiler()
    pc = ProfileController(str(tmp_path), profiler=fake)
    pc.tick("x")
    assert fake.calls == []
    pc.request(2, tag="bench")
    with pytest.raises(ProfileBusyError):
        pc.request(1)
    pc.tick("server/round")
    assert fake.calls[0][0] == "start" and "profile-bench-1" in fake.calls[0][1]
    pc.tick("server/round")
    assert len(fake.calls) == 1
    pc.tick("server/round")
    assert fake.calls[-1] == ("stop",)
    st = pc.status()
    assert st["armed_units"] == 0 and st["active_units_left"] == 0
    assert len(st["completed"]) == 1 and pathlib.Path(st["completed"][0]["dir"]).is_dir()
    pc.request(1)


def test_profile_controller_close_flushes_active(tmp_path):
    fake = FakeProfiler()
    pc = ProfileController(str(tmp_path), profiler=fake)
    pc.request(10)
    pc.tick("r")
    pc.close()
    assert fake.calls[-1] == ("stop",)
    with pytest.raises(ValueError):
        pc.request(0)


def test_torch_profiler_capture_writes_a_chrome_trace(tmp_path):
    """The default profiler on the CPU: a capture over two units writes a
    Chrome trace (CPU activity only: this process never initialised
    CUDA) that parses and holds the ops run inside it."""
    import torch

    pc = ProfileController(str(tmp_path))
    pc.request(2, tag="cpu")
    pc.tick("u")
    for _ in range(3):
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
        pc.tick("u")
    st = pc.status()
    assert st["last_error"] is None and len(st["completed"]) == 1
    trace = json.loads((pathlib.Path(st["completed"][0]["dir"]) / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert not torch.cuda.is_initialized()


def test_prom_profile_rejects_non_object_json_body(tmp_path):
    srv = _prom(tmp_path)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        for bad in (b"null", b"[1,2]", b'"units"'):
            conn.request("POST", "/debug/profile", body=bad)
            r = conn.getresponse()
            assert r.status == 400, bad
            r.read()
        conn.close()
    finally:
        srv.close()


def test_over_armed_startup_profile_flushes_at_run_end(tmp_path):
    cfg = make_cfg(tmp_path, n_rounds=2, n_clients_per_round=2)
    cfg.photon.telemetry.enabled = True
    cfg.photon.telemetry.profile_rounds = 10
    app = make_app(cfg.validate())
    fake = FakeProfiler()
    telemetry.profiler_active()._profiler = fake
    app.run()
    app.driver.shutdown()
    assert fake.calls[0][0] == "start" and fake.calls[-1] == ("stop",)


def test_hbm_growth_alert_carries_callers_plane():
    h = HealthMonitor()
    h.hbm_window = 3
    h._hbm = type(h._hbm)(maxlen=3)
    out = [h.note_hbm_sample(v, plane="serve") for v in (1e6, 1.2e6, 1.5e6)]
    assert out[-1] is not None and out[-1].plane == "serve"
    assert h.plane_status("serve") == DEGRADED and h.plane_status("federation") == OK


def test_profile_rounds_config_validation(tmp_path):
    cfg = make_cfg(tmp_path)
    cfg.photon.telemetry.profile_rounds = -1
    with pytest.raises(ValueError, match="profile_rounds"):
        cfg.validate()
    cfg.photon.telemetry.profile_rounds = 2
    with pytest.warns(UserWarning, match="profile_rounds"):
        cfg.validate()
    cfg.photon.telemetry.enabled = True
    cfg.photon.telemetry.metrics_retention = 0
    with pytest.raises(ValueError, match="metrics_retention"):
        cfg.validate()


# ---------------------------------------------------------------------------
# span-drop accounting, disabled hooks
# ---------------------------------------------------------------------------


def test_span_buffer_drops_are_counted_and_warned_once():
    telemetry.install(TelemetryConfig(enabled=True, max_buffered_spans=4), scope="t")
    for i in range(10):
        with telemetry.span("server/round", i=i):
            pass
    c = telemetry.metrics_active().get(SPANS_DROPPED)
    assert c is not None and c.value == 6.0
    warned = [e for e in telemetry.events_active().snapshot() if e["kind"] == SPANS_DROPPED]
    assert len(warned) == 1 and warned[0]["attrs"]["dropped_total"] == 1


def test_disabled_hooks_are_none_checks():
    """With telemetry off every plane is None and every hook returns at
    its first check: no span, event, instrument or profile is made, and
    a run's sites cost one module-global read each."""
    assert telemetry.active() is None and telemetry.events_active() is None
    assert telemetry.metrics_active() is None and telemetry.health_active() is None
    assert telemetry.profiler_active() is None and telemetry.autopilot_active() is None
    assert introspect.compile_count() is None
    telemetry.metric_inc(SPANS_DROPPED)
    telemetry.metric_set(HBM_BYTES_IN_USE, 1.0)
    telemetry.metric_observe(SERVE_TTFT_S, 0.1)
    telemetry.profile_tick("server/round")
    telemetry.emit_event("membership/transition", node="n")
    telemetry.ingest([{"name": "x"}], [{"kind": "y"}])
    assert telemetry.drain_events() == [] and telemetry.current_context() is None
    # the shared no-op context: no allocation per span site
    assert telemetry.span("a") is telemetry.span("b") is telemetry.timed_add("c")
    assert telemetry.attach(("t", "s")) is telemetry.span("a")


# ---------------------------------------------------------------------------
# device-plane sampling
# ---------------------------------------------------------------------------


def test_sample_device_plane_feeds_metrics_and_hub(monkeypatch):
    monkeypatch.setattr(introspect, "device_memory",
                        lambda device=None: {"bytes_in_use": 1000, "peak_bytes_in_use": 2000})
    monkeypatch.setattr(introspect, "compile_count", lambda: 7)
    hub = MetricsHub()
    metrics: dict = {}
    introspect.sample_device_plane(metrics, hub, hbm_key=HBM_BYTES_IN_USE,
                                   peak_key=HBM_PEAK_BYTES, compiles_key=COMPILES_TOTAL)
    assert metrics == {HBM_BYTES_IN_USE: 1000.0, HBM_PEAK_BYTES: 2000.0, COMPILES_TOTAL: 7.0}
    assert hub.get(HBM_BYTES_IN_USE).value == 1000.0 and hub.get(COMPILES_TOTAL).value == 7.0


def test_device_memory_never_opens_a_cuda_context(monkeypatch):
    """None for a CPU device and in a process that has not initialised
    CUDA (the ``--tcp-listen`` server holds no context); the allocator's
    live and peak bytes where it has."""
    import torch

    assert introspect.device_memory() is None and introspect.device_memory("cpu") is None
    assert not torch.cuda.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: {
        "allocated_bytes.all.current": 300, "allocated_bytes.all.peak": 500})
    assert introspect.device_memory() == {"bytes_in_use": 300, "peak_bytes_in_use": 500}
    assert introspect.device_memory("cuda:0") == {"bytes_in_use": 300, "peak_bytes_in_use": 500}


def test_compile_counter_counts_kernel_library_loads(tmp_path, monkeypatch):
    """The port's counterpart of the JAX compile listener: every kernel
    library ``_build.load`` builds or loads counts once per source, a
    second load of a source counts nothing, and the counter reads None
    once uninstalled. (nvcc and the loader are fakes here.)"""
    from photon_tpu_torch.ops import _build

    built = []

    def fake_compile(source, out):
        built.append(source)
        out.write_bytes(b"lib")
        return out

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    introspect.install_compile_counter()
    try:
        assert introspect.compile_count() == 0
        _build.load("ragged_paged_attention.cu")
        _build.load("ragged_paged_attention.cu")
        assert introspect.compile_count() == 1
        _build.load("flash_attention.cu")
        assert introspect.compile_count() == 2 and len(built) == 2
    finally:
        introspect.uninstall_compile_counter()
    assert introspect.compile_count() is None


# ---------------------------------------------------------------------------
# serve-plane request histograms (a fake engine)
# ---------------------------------------------------------------------------


class FakeEngine:
    """Every prompt prefills in one chunk that emits token 1; decode rows
    emit token 2."""

    n_slots = 2
    failed = None
    prefix_cache = None

    def __init__(self):
        self._active, self._pending = {}, {}

    @property
    def n_active(self):
        return len(self._active)

    def fits(self, n_prompt, max_new):
        return True

    def has_cohort(self, cohort):
        return cohort is None

    def can_admit(self, n_prompt, max_new, prompt=None, cohort=None):
        return True

    def free_slot(self):
        return next((s for s in range(self.n_slots) if s not in self._active), None)

    def begin(self, slot, prompt, max_new, temperature=0.0, seed=0, cohort=None):
        self._active[slot] = True
        self._pending[slot] = len(prompt)

    def pending_tokens(self, slot):
        return self._pending.get(slot, 0)

    def mixed_step(self, chunk=None):
        nxt = np.zeros(self.n_slots, np.int32)
        emitted = np.zeros(self.n_slots, bool)
        chunk_slot = None
        if chunk is not None:
            chunk_slot = chunk[0]
            self._pending.pop(chunk_slot, None)
            nxt[chunk_slot], emitted[chunk_slot] = 1, True
        for s in list(self._active):
            if s != chunk_slot and s not in self._pending:
                nxt[s], emitted[s] = 2, True
        return nxt, emitted

    def evict(self, slot):
        self._active.pop(slot, None)
        self._pending.pop(slot, None)


def test_scheduler_observes_request_histograms():
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    telemetry.install(TelemetryConfig(enabled=True), scope="serve")
    batcher = ContinuousBatcher(FakeEngine(), max_queue=8).start()
    try:
        for r in [batcher.submit([1, 2, 3], 3) for _ in range(4)]:
            r.result(timeout=30)
    finally:
        batcher.close()
    hub = telemetry.metrics_active()
    assert hub.get(SERVE_TTFT_S).count == 4 and hub.get(SERVE_QUEUE_WAIT_S).count == 4
    assert hub.get(SERVE_TPOT_S).count == 4
    assert any(ex.trace_id for ex in hub.get(SERVE_TTFT_S)._exemplars.values())
    assert hub.get("serve/queue_depth") is not None
    assert hub.get("serve/evictions").value == 4.0
    names = [s["name"] for s in telemetry.active().snapshot()]
    assert names.count("serve/request") == 4 and names.count("serve/decode") == 4
    assert all(n.startswith("serve/") for n in batcher.history.rounds)


# ---------------------------------------------------------------------------
# end to end: chaos-injected NaN delta → alert + /statusz
# ---------------------------------------------------------------------------


def _observatory_cfg(tmp_path, nan_round=0):
    cfg = make_cfg(tmp_path, n_rounds=2, n_clients_per_round=2)
    cfg.photon.telemetry.enabled = True
    if nan_round:
        cfg.photon.chaos.enabled = True
        cfg.photon.chaos.nan_delta_round = nan_round
    return cfg.validate()


def test_clean_run_stays_ok_end_to_end(tmp_path):
    app = make_app(_observatory_cfg(tmp_path))
    app.run()
    app.driver.shutdown()
    z = telemetry.health_active().statusz()
    assert z["status"] == OK and z["alerts"] == []
    # the build counter samples every round (0 on the CPU: no kernel
    # library loads); device memory only where CUDA reports
    assert [v for _, v in app.history.series(COMPILES_TOTAL)] == [0.0, 0.0]
    assert app.history.series(HBM_BYTES_IN_USE) == []
    assert telemetry.metrics_active().get(ROUND_TIME).count == 2


def test_nan_delta_round_fires_alert_and_degrades_statusz(tmp_path):
    cfg = _observatory_cfg(tmp_path, nan_round=2)
    app = make_app(cfg)
    history = app.run()
    app.driver.shutdown()
    assert chaos.active().counts["nan_delta"] >= 1
    r2 = dict(history.series("server/pseudo_grad_norm"))
    assert math.isnan(r2[2]) and not math.isnan(r2[1])
    health = telemetry.health_active()
    assert health.statusz()["planes"]["federation"]["status"] == FAILING
    alert = next(a for a in health.alerts if a.kind == ALERT_NONFINITE)
    assert alert.attrs["round"] == 2
    tdir = pathlib.Path(app.telemetry_dir)
    events = [json.loads(ln) for ln in
              (tdir / f"events-{cfg.run_uuid}.jsonl").read_text().splitlines()]
    ev = next(e for e in events if e["kind"] == ALERT_NONFINITE)
    assert ev["trace_id"]
    assert any(e["kind"] == "chaos/nan_delta" and e.get("trace_id") for e in events)
    trace = json.loads(pathlib.Path(app.export_telemetry()).read_text())
    round_spans = [e for e in trace["traceEvents"] if e.get("name") == "server/round"
                   and e.get("args", {}).get("round") == 2]
    assert any(e["args"]["trace_id"] == ev["trace_id"] for e in round_spans)


# ---------------------------------------------------------------------------
# the cases earlier slices owed
# ---------------------------------------------------------------------------


def test_prefix_kpis_recorded_and_registered():
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher
    from photon_tpu_torch.utils.profiling import (
        SERVE_PREFIX_HIT_RATE,
        SERVE_PREFIX_SHARED_BLOCKS,
        is_registered_metric,
    )
    from tests.test_torch_prefix import _cfg

    cfg = _cfg()
    batcher = ContinuousBatcher(PagedEngine(cfg, init_params(cfg.model, seed=4), device="cpu"),
                                max_queue=8).start()
    try:
        p = list(range(1, 11))
        batcher.submit(p, 3).result(timeout=120)
        batcher.submit(p + [1, 2], 3).result(timeout=120)
        recorded = set(batcher.history.rounds)
        assert SERVE_PREFIX_HIT_RATE in recorded and SERVE_PREFIX_SHARED_BLOCKS in recorded
        assert all(is_registered_metric(k) for k in recorded), recorded
        assert batcher.history.latest(SERVE_PREFIX_HIT_RATE) > 0.0
    finally:
        batcher.close()


def test_spec_kpis_registered_and_recorded():
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher
    from photon_tpu_torch.utils.profiling import (
        SERVE_SPEC_ACCEPT_RATE,
        SERVE_SPEC_ACCEPTED,
        SERVE_SPEC_DRAFTED,
        SERVE_SPEC_K,
        SERVE_SPEC_STEPS,
    )
    from tests.test_torch_spec import _cfg, _engine, _params

    names = registered_metric_names()
    for n in (SERVE_SPEC_DRAFTED, SERVE_SPEC_ACCEPTED, SERVE_SPEC_STEPS,
              SERVE_SPEC_ACCEPT_RATE, SERVE_SPEC_K):
        assert n in names
    cfg = _cfg()
    cfg.photon.serve.speculative.enabled = True
    batcher = ContinuousBatcher(_engine(cfg, _params(cfg)), max_queue=4,
                                speculative=cfg.photon.serve.speculative).start()
    try:
        batcher.submit([5, 9, 2], 8).result(timeout=120)
        st = batcher.kpis()
        assert st[SERVE_SPEC_DRAFTED] >= st[SERVE_SPEC_ACCEPTED] >= 0
        assert 0.0 <= st[SERVE_SPEC_ACCEPT_RATE] <= 1.0
        assert SERVE_SPEC_K in batcher.history.rounds
    finally:
        batcher.close()


def test_hotswap_events_and_metrics(tmp_path):
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher
    from photon_tpu_torch.utils.profiling import (
        EVENT_HOTSWAP_SKIPPED,
        EVENT_HOTSWAP_SWAPPED,
        SERVE_HOTSWAP_REJECTED_CORRUPT,
        SERVE_HOTSWAP_SWAP_LATENCY_S,
        SERVE_HOTSWAP_SWAPS_TOTAL,
        is_registered_metric,
    )
    from tests.test_torch_hotswap import _cfg, _save_round, _watcher

    cfg = _cfg()
    store = FileStore(tmp_path)
    mgr = ServerCheckpointManager(store, "hs")
    _save_round(mgr, cfg, 1, seed=1)
    batcher = ContinuousBatcher(PagedEngine.from_checkpoint(
        cfg, store=store, resume_round=-1, device="cpu"), max_queue=16).start()
    w = _watcher(batcher, mgr, cfg, poll_s=0.05)
    telemetry.install(TelemetryConfig(enabled=True), scope="serve")
    try:
        _save_round(mgr, cfg, 2, seed=2)
        assert w.poll_once() == "swapped"
        batcher.submit([5, 9, 2], 2).result(timeout=120)
        _save_round(mgr, cfg, 3, seed=3)
        obj = next(p for p in (tmp_path / "hs/server/3").iterdir() if p.suffix == ".npz")
        data = bytearray(obj.read_bytes())
        data[len(data) // 2] ^= 0xFF
        obj.write_bytes(bytes(data))
        with pytest.warns(UserWarning, match="corrupt"):
            assert w.poll_once() == "skipped-corrupt"
        events = telemetry.drain_events()
        assert any(e["kind"] == EVENT_HOTSWAP_SWAPPED and e["attrs"]["round"] == 2
                   for e in events), events
        assert any(e["kind"] == EVENT_HOTSWAP_SKIPPED and e["attrs"]["reason"] == "corrupt"
                   for e in events)
        hub = telemetry.metrics_active()
        assert hub.histogram(SERVE_HOTSWAP_SWAP_LATENCY_S).count >= 1
        assert hub.get(SERVE_HOTSWAP_REJECTED_CORRUPT).value == 1.0
        assert telemetry.health_active().plane_status("store") == DEGRADED
        assert "serve/hotswap_swap" in {s["name"] for s in telemetry.active().snapshot()}
    finally:
        telemetry.uninstall()
        batcher.close()
    recorded = set(batcher.history.rounds)
    assert SERVE_HOTSWAP_SWAPS_TOTAL in recorded
    assert not sorted(k for k in recorded if not is_registered_metric(k))


def test_registry_covers_router_names():
    names = registered_metric_names()
    for expect in ("router/requests_total", "router/routed_prefix_total",
                   "router/routed_cohort_total", "router/routed_p2c_total",
                   "router/reroutes_total", "router/proxy_errors_total",
                   "router/replicas_live", "router/replicas_dead",
                   "router/cohort_repins_total", "serve/fleet_replicas",
                   "serve/fleet_rolling_swaps_total"):
        assert expect in names, expect


def test_fleet_metrics_plane_and_events(tmp_path):
    """The ``/metrics`` half of the JAX router's status-and-metrics case,
    with telemetry on: the router's exposition carries its KPIs and passes
    the structural check, each replica's registration is an event, a
    replica report carries its serve-plane health and its build count
    (the serve counter: JAX's agent reads the server one), and a killed
    replica degrades the fleet plane on ``/statusz``."""
    from photon_tpu_torch.serve.fleet import InProcessFleet
    from photon_tpu_torch.utils.profiling import SERVE_COMPILES_TOTAL
    from tests.test_torch_router import _fleet_cfg, _get, _jax_fleet_cfg, _weights

    telemetry.install(TelemetryConfig(enabled=True), scope="router")
    telemetry.metrics_active().counter(SERVE_COMPILES_TOTAL).inc_to(2)
    _, params = _weights(_jax_fleet_cfg())
    fleet = InProcessFleet(_fleet_cfg(), params, device="cpu")
    try:
        port = fleet.start(timeout=60)
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        c.request("GET", "/metrics")
        text = c.getresponse().read().decode()
        c.close()
        fams = validate_exposition(text)
        assert "photon_router_requests_total" in fams
        assert fams["photon_serve_fleet_replicas"]["value"] == 3.0
        kinds = [e["kind"] for e in telemetry.events_active().snapshot()]
        assert kinds.count("fleet/replica_up") == 3
        rep = fleet.replicas["replica0"]["agent"].report()
        assert rep["health"] == {"status": "ok", "reason": ""} and rep["compiles"] == 2.0
        fleet.kill_replica("replica1")
        deadline = time.monotonic() + 20
        while _get("127.0.0.1", port, "/statusz")["planes"]["fleet"]["status"] != DEGRADED:
            assert time.monotonic() < deadline, "the fleet plane never degraded"
            time.sleep(0.05)
        assert "fleet/replica_dead" in [e["kind"] for e in telemetry.events_active().snapshot()]
    finally:
        fleet.close()


def test_hotswap_statusz_gate_reads_the_ports_prom_server(tmp_path):
    """``serve.hotswap_statusz_url`` pointed at the port's own PromServer:
    a healthy training run lets the swap through; once the federation
    plane fails, the next round is skipped for health."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher
    from tests.test_torch_hotswap import _cfg, _save_round, _watcher

    health = HealthMonitor()
    srv = PromServer(History(), port=0, health=health)
    srv.start()
    cfg = _cfg()
    store = FileStore(tmp_path)
    mgr = ServerCheckpointManager(store, "hs")
    _save_round(mgr, cfg, 1, seed=1)
    batcher = ContinuousBatcher(PagedEngine.from_checkpoint(
        cfg, store=store, resume_round=-1, device="cpu"), max_queue=4).start()
    try:
        w = _watcher(batcher, mgr, cfg, poll_s=0.05,
                     statusz_url=f"http://127.0.0.1:{srv.port}/statusz")
        _save_round(mgr, cfg, 2, seed=2)
        assert w.poll_once() == "swapped"
        health.alert(ALERT_NONFINITE, plane="federation", severity=FAILING, round=2)
        _save_round(mgr, cfg, 3, seed=3)
        with pytest.warns(UserWarning, match="federation-failing"):
            assert w.poll_once() == "skipped-health"
        assert batcher.engine.loaded_round == 2
    finally:
        batcher.close()
        srv.close()


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 16, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_telemetry_phase_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.telemetry_phase`` (phase 16) with ``--device cpu``
    children on a small model: (a) a traced ``--tcp-listen`` run whose
    merged trace holds the three processes with every node fit and eval
    under its round's server span, mid-run scrapes that pass the
    exposition check with TCP frames counted, ``/statusz`` ok to the end,
    the round-1 profile parsed, no CUDA context in the server; (b) the
    serve CLI with telemetry on: every request 200, the TTFT histogram's
    count and trace-id exemplars, ``/statusz`` ok, a flat build counter
    and a completed on-demand capture. The launch counts, the device bytes
    and the K4 records in the capture are card-only."""
    from photon_tpu_torch.config.schema import Config
    from tests.test_torch_compression import _chip_smoke

    smoke = _chip_smoke()
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(smoke, "TEL_PROMPTS", (4, 9, 14, 19, 24, 29, 34, 39) * 2)
    monkeypatch.setattr(smoke, "TEL_NEW", 8)
    monkeypatch.setattr(smoke, "TEL_PROFILE_PROMPTS", (10,) * 8)
    cfg = make_cfg(tmp_path, n_total_clients=2, n_clients_per_round=2, eval_interval_rounds=2)
    m = cfg.model
    m.d_model, m.n_heads, m.max_seq_len = 64, 4, 64
    cfg.train.global_batch_size = cfg.train.device_microbatch_size = 8
    cfg.photon.checkpoint = True
    scfg = Config.from_dict(cfg.to_dict())
    s = scfg.photon.serve
    s.n_slots, s.block_size, s.n_blocks, s.prefill_token_budget = 8, 4, 0, 16
    s.max_new_tokens, s.max_queue = 64, 64
    rec = smoke.telemetry_phase(np, cfg=cfg, scfg=scfg, device="cpu", work=tmp_path / "tel")
    fed, serve = rec["fed"], rec["serve"]
    assert fed["processes"] == ["node0", "node1", "server"] and not fed["orphans"]
    assert fed["spans_by_name"] == {"client/fit": 4, "client/evaluate": 4}
    assert fed["membership_nodes"] == ["node0", "node1"] and fed["statusz_end"] == "ok"
    assert fed["profile"]["records"] > 0 and not fed["server_cuda_initialized"]
    assert fed["rounds"] == [1, 2] and fed["scrapes"] >= 1
    assert serve["ttft_count"] == 16 and serve["exemplar_trace_ids"] >= 1
    assert serve["statusz"] == "ok" and serve["compiles"] == serve["compiles_after"] == 0.0
    assert serve["profile"]["records"] > 0 and serve["profile"]["last_error"] is None
    assert not (tmp_path / "tel").exists()
