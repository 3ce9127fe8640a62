"""The telemetry plane of the port (``photon_tpu_torch/telemetry``), one case
for each case of ``tests/test_telemetry.py``, plus parity with the JAX
package's pure classes and the port's own pins:

- tracer semantics, the JSONL event log, the Perfetto export, the
  Prometheus endpoint and the name registry;
- trace context across process boundaries (in process, a spawned node, TCP
  node threads, and ``--tcp-listen`` with two ``--connect`` processes),
  where dropped and duplicated envelopes must neither corrupt nor
  double-emit spans;
- the same span, event and instrument sequences give the JAX package's
  Chrome-trace structure (``export.chrome_trace_events``);
- a traced run's parameters equal an untraced run's bit for bit;
- a refill the fold's decode-ahead worker sends still parents its node
  spans to the round (the JAX package sends it without a context).

JAX's own ``telemetry.install`` is never called here: on jax 0.9.0 its
``uninstall`` raises (``_unregister_event_duration_listener_by_callback``
is gone), so the JAX side of every parity case drives its pure classes.
"""

import json
import pathlib
import socket
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from photon_tpu_torch import telemetry
from photon_tpu_torch.config.schema import TelemetryConfig
from photon_tpu_torch.telemetry.events import EventLog, read_events_jsonl
from photon_tpu_torch.telemetry.export import (
    chrome_trace_events,
    load_chrome_trace,
    span_index,
    write_chrome_trace,
)
from photon_tpu_torch.telemetry.spans import Tracer
from tests.test_torch_tcp import _free_port, _thread_node, make_cfg
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Every case starts and ends with no process-global tracer."""
    from photon_tpu_torch import chaos

    telemetry.uninstall()
    chaos.uninstall()
    yield
    telemetry.uninstall()
    chaos.uninstall()


def make_app(cfg, with_ckpt=False, n_nodes=2):
    """An in-process ServerApp over ``n_nodes`` node agents on the CPU."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.federation import InProcessDriver, NodeAgent, ParamTransport, ServerApp

    driver = InProcessDriver(cfg, lambda nid: NodeAgent(
        cfg, nid, lambda: ParamTransport("inline"), device="cpu"), n_nodes=n_nodes)
    ckpt = (ServerCheckpointManager(FileStore(cfg.photon.save_path + "/store"), cfg.run_uuid)
            if with_ckpt else None)
    return ServerApp(cfg, driver, ParamTransport("inline"), ckpt_mgr=ckpt)


def _walk_to_round(idx, span_ev):
    cur = span_ev
    while cur["args"].get("parent_id") in idx:
        cur = idx[cur["args"]["parent_id"]]
        if cur["name"] == "server/round":
            return cur
    return None


# ---------------------------------------------------------------------------
# Tracer unit semantics
# ---------------------------------------------------------------------------


def test_span_nesting_parents_and_trace_id():
    tr = Tracer("server")
    with tr.span("server/round_time", round=1) as outer:
        with tr.span("server/fit_round_time") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
    spans = tr.drain()
    assert [s["name"] for s in spans] == ["server/fit_round_time", "server/round_time"]
    assert spans[1]["parent_id"] is None
    assert spans[0]["attrs"] == {} and spans[1]["attrs"] == {"round": 1}
    assert all(s["duration_s"] >= 0 for s in spans)


def test_attach_adopts_remote_parent():
    tr = Tracer("node0")
    with tr.attach(("deadbeef", "cafe0001")):
        with tr.span("client/fit_time") as sp:
            assert sp.trace_id == "deadbeef" and sp.parent_id == "cafe0001"
    with tr.span("client/fit_time") as sp2:  # the stack unwound: a new trace
        assert sp2.trace_id != "deadbeef"
    assert len(tr.drain()) == 2


def test_buffer_cap_drops_oldest_and_counts():
    tr = Tracer("server", max_buffered_spans=3)
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    assert tr.dropped == 2
    assert [s["name"] for s in tr.drain()] == ["s2", "s3", "s4"]


def test_drain_ingest_roundtrip_preserves_proc():
    node = Tracer("node0", piggyback=True)
    with node.span("client/fit_time", cid=3):
        pass
    shipped = node.drain()
    assert node.drain() == []
    server = Tracer("server")
    assert server.ingest(shipped) == 1
    merged = server.snapshot()
    assert merged[0]["proc"] == "node0" and merged[0]["attrs"]["cid"] == 3
    assert server.ingest([{"bogus": 1}, None]) == 0  # malformed: skipped, never raises


def test_ingest_dedups_duplicated_shipments():
    node = Tracer("node0", piggyback=True)
    with node.span("client/fit_time", cid=1):
        pass
    shipped = node.drain()
    server = Tracer("server")
    assert server.ingest(shipped) == 1
    assert server.ingest(list(shipped)) == 0  # a duplicated frame
    assert len(server.snapshot()) == 1
    nlog = EventLog("node0")
    nlog.emit("tcp/reconnect", {"reconnects": 1})
    sev = nlog.drain()
    slog = EventLog("server")
    assert slog.ingest(sev) == 1 and slog.ingest(list(sev)) == 0
    assert len(slog.snapshot()) == 1


def test_span_threads_have_independent_stacks():
    tr = Tracer("server")
    seen = {}

    def worker():
        with tr.span("t2") as sp:
            seen["t2"] = (sp.trace_id, sp.parent_id)

    with tr.span("t1") as sp1:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert seen["t2"][0] != sp1.trace_id and seen["t2"][1] is None


def test_install_disabled_is_none_and_span_is_noop():
    assert telemetry.install(TelemetryConfig(enabled=False), scope="x") is None
    assert telemetry.active() is None
    with telemetry.span("anything", round=1):
        assert telemetry.current_context() is None
    telemetry.emit_event("nothing")
    assert telemetry.autopilot_active() is None


# ---------------------------------------------------------------------------
# Event log + exporter
# ---------------------------------------------------------------------------


def test_event_log_write_through_and_correlation(tmp_path):
    path = tmp_path / "tel" / "events.jsonl"
    log = EventLog("server", path=str(path))
    log.emit("membership/transition", {"node": "node0", "from": "new", "to": "live"})
    log.emit("chaos/tcp_drop", {"scope": "node1"}, ctx=("abcd", "ef01"))
    log.close()
    events = read_events_jsonl(str(path))
    assert [e["kind"] for e in events] == ["membership/transition", "chaos/tcp_drop"]
    assert events[0]["proc"] == "server"
    assert events[1]["trace_id"] == "abcd" and events[1]["span_id"] == "ef01"
    assert all("ts" in e for e in events)


def test_event_log_buffered_drain_ingest():
    node = EventLog("node0")
    node.emit("tcp/reconnect", {"reconnects": 1})
    shipped = node.drain()
    assert node.drain() == []
    server = EventLog("server")
    assert server.ingest(shipped) == 1
    assert server.snapshot()[0]["proc"] == "node0"


def test_chrome_trace_export_structure(tmp_path):
    tr = Tracer("server")
    with tr.span("server/round_time", round=2):
        with tr.span("server/fit_round_time"):
            pass
    events = [{"ts": 123.0, "kind": "chaos/tcp_drop", "proc": "node0",
               "attrs": {}, "trace_id": "t", "span_id": "s"}]
    doc = load_chrome_trace(write_chrome_trace(tmp_path / "trace.json", tr.snapshot(), events))
    evs = doc["traceEvents"]
    complete = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in complete} == {"server/round_time", "server/fit_round_time"}
    assert all(e["ts"] > 0 and e["dur"] >= 0 for e in complete)
    idx = span_index(doc)
    child = next(e for e in complete if e["name"] == "server/fit_round_time")
    assert idx[child["args"]["parent_id"]]["name"] == "server/round_time"
    assert any(e["ph"] == "i" and e["name"] == "chaos/tcp_drop" for e in evs)
    assert {"server", "node0"} <= {e["args"]["name"] for e in evs if e["ph"] == "M"}


def _structure(spans: list[dict]) -> list[tuple]:
    """A span list without its ids and clocks: name, proc, attrs and the
    index of the parent span (or None)."""
    pos = {s["span_id"]: i for i, s in enumerate(spans)}
    return [(s["name"], s["proc"], s["attrs"], pos.get(s["parent_id"])) for s in spans]


def test_chrome_trace_structure_matches_jax():
    """The same span and event sequences through the port's Tracer and
    EventLog and through JAX's: equal structure, and the same span dicts
    render to the same Chrome-trace events in both exporters."""
    from photon_tpu.telemetry.events import EventLog as JaxEventLog
    from photon_tpu.telemetry.export import chrome_trace_events as jax_chrome
    from photon_tpu.telemetry.spans import Tracer as JaxTracer

    def drive(tracer_cls, log_cls):
        server, node = tracer_cls("server"), tracer_cls("node0", piggyback=True)
        slog, nlog = log_cls("server"), log_cls("node0")
        with server.span("server/round", round=1):
            with server.span("server/broadcast_pre_time", round=1):
                pass
            with server.span("server/fit_round_time", round=1) as fr:
                ctx = (fr.trace_id, fr.span_id)
                with node.attach(ctx):
                    with node.span("client/fit", round=1, cid=0, node="node0"):
                        with node.span("client/train", cid=0, local_steps=2):
                            nlog.emit("chaos/tcp_delay", {"delay_s": 0.5},
                                      ctx=node.current_context())
                server.ingest(node.drain())
                slog.ingest(nlog.drain())
            server.add_span("server/agg_fold_time", 5.0, 0.25, client_index=0)
        return server.snapshot(), slog.snapshot()

    ours, our_events = drive(Tracer, EventLog)
    theirs, their_events = drive(JaxTracer, JaxEventLog)
    assert _structure(ours) == _structure(theirs)
    assert [(e["kind"], e["proc"], e["attrs"]) for e in our_events] == \
           [(e["kind"], e["proc"], e["attrs"]) for e in their_events]
    assert chrome_trace_events(ours, our_events) == jax_chrome(ours, our_events)
    assert chrome_trace_events(theirs, their_events) == jax_chrome(theirs, their_events)


# ---------------------------------------------------------------------------
# Prometheus endpoint, History, SpeedMonitor
# ---------------------------------------------------------------------------


def test_prom_metrics_endpoint():
    from photon_tpu_torch.metrics.history import History
    from photon_tpu_torch.telemetry.prom import PromServer

    h = History()
    h.record(3, {"server/round_time": 1.5, "server/n_clients": 2.0})
    srv = PromServer(h, port=0)
    port = srv.start()
    try:
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
    finally:
        srv.close()
    assert "# TYPE photon_server_round_time gauge" in body
    assert "photon_server_round_time 1.5" in body and "photon_last_round 3" in body


def test_history_wandb_mirrors_only_coerced_floats():
    """The port's History keeps the float-coercible values; it mirrors
    nothing to wandb (there is none in this package), so a run handle
    passed in sees no call."""
    from photon_tpu_torch.metrics.history import History

    logged = []

    class FakeWandb:
        def log(self, d, step=None):
            logged.append((step, d))

    h = History(FakeWandb())
    h.record(1, {"server/round_time": 2.0, "server/junk": None,
                 "server/name": "not-a-float", "server/ok": "3.5"})
    assert logged == []
    assert h.latest("server/junk") is None and h.latest("server/name") is None
    assert h.latest("server/round_time") == 2.0 and h.latest("server/ok") == 3.5


def test_speed_monitor_auto_detects_peak_from_device_kind():
    from photon_tpu_torch.config.schema import ModelConfig
    from photon_tpu_torch.utils.profiling import SpeedMonitor

    sm = SpeedMonitor(ModelConfig(), device_name="NVIDIA H100 80GB HBM3", n_devices=2)
    assert sm.peak_flops_per_device == 989e12
    assert SpeedMonitor(ModelConfig(), device_name="cpu").peak_flops_per_device is None
    out = sm.update(tokens=1000, seconds=0.5)
    assert out["throughput/tokens_per_sec"] == 2000.0 and out["throughput/mfu"] > 0
    assert "throughput/mfu" not in SpeedMonitor(ModelConfig(), device_name="cpu").update(1, 1.0)


# ---------------------------------------------------------------------------
# Duplicate and dropped envelopes
# ---------------------------------------------------------------------------


class _ScriptedConn:
    """Feeds a fixed envelope sequence to NodeAgent.serve."""

    def __init__(self, envelopes):
        self._in = list(envelopes)
        self.sent = []

    def recv(self):
        if not self._in:
            raise EOFError("script exhausted")
        return self._in.pop(0)

    def send(self, obj):
        self.sent.append(obj)


def _node_and_fit(tmp_path):
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.federation import NodeAgent, ParamTransport
    from photon_tpu_torch.federation.messages import FitIns
    from photon_tpu_torch.models.mpt import init_params

    cfg = make_cfg(tmp_path, n_rounds=1)
    cfg.photon.telemetry.enabled = True
    agent = NodeAgent(cfg, "node0", lambda: ParamTransport("inline"), device="cpu")
    telemetry.install(cfg.photon.telemetry, scope="node0", piggyback=True)
    ptr = agent.runtime.transport.put("bcast", *params_to_ndarrays(init_params(cfg.model, seed=0)))
    return agent, FitIns(server_round=1, cids=[0], params=ptr, local_steps=1,
                         server_steps_cumulative=0)


def test_duplicate_envelope_single_span_emission(tmp_path):
    """The same FitIns delivered twice runs ONE fit: one reply, one set of
    client spans piggybacked, parented to the envelope's context."""
    from photon_tpu_torch.federation.messages import Envelope

    agent, fit = _node_and_fit(tmp_path)
    env = Envelope(fit, msg_id=7, trace=("feedc0de", "00000001"))
    conn = _ScriptedConn([env, env])
    assert agent.serve(conn) is False
    assert len(conn.sent) == 1
    res = conn.sent[0].msg[0]
    assert res.error is None, res.error
    fit_spans = [s for s in res.spans if s["name"] == "client/fit"]
    assert len(fit_spans) == 1
    assert fit_spans[0]["trace_id"] == "feedc0de" and fit_spans[0]["parent_id"] == "00000001"
    ids = [s["span_id"] for s in res.spans]
    assert len(ids) == len(set(ids))
    assert {"client/resolve_params", "client/train", "client/encode",
            "client/package"} <= {s["name"] for s in res.spans}


def test_dropped_envelope_then_retry_keeps_spans_clean(tmp_path):
    from photon_tpu_torch.federation.messages import Envelope

    agent, fit = _node_and_fit(tmp_path)
    conn = _ScriptedConn([Envelope(fit, msg_id=8, trace=("feedc0de", "2"))])
    agent.serve(conn)
    res = conn.sent[0].msg[0]
    assert res.error is None, res.error
    assert len([s for s in res.spans if s["name"] == "client/fit"]) == 1
    ids = [s["span_id"] for s in res.spans]
    assert len(ids) == len(set(ids))
    assert telemetry.active().current_context() is None


def test_socketconn_drop_emits_no_send_span():
    from photon_tpu_torch import chaos
    from photon_tpu_torch.config.schema import ChaosConfig
    from photon_tpu_torch.federation.messages import Envelope, Query
    from photon_tpu_torch.federation.tcp import SocketConn

    telemetry.install(TelemetryConfig(enabled=True), scope="server")
    a, b = socket.socketpair()
    tx, rx = SocketConn(a), SocketConn(b)
    try:
        chaos.install(ChaosConfig(enabled=True, seed=1234, tcp_drop_p=1.0), scope="t")
        tx.send(Envelope(Query("ping"), 1))  # dropped
        assert [s["name"] for s in telemetry.active().snapshot()] == []
        # the injector's firing is an event
        assert [e["kind"] for e in telemetry.events_active().snapshot()] == ["chaos/tcp_drop"]
        chaos.uninstall()
        tx.send(Envelope(Query("ping"), 2))
        assert rx.recv().msg_id == 2
        names = [s["name"] for s in telemetry.active().snapshot()]
        assert names.count("tcp/send") == 1 and names.count("tcp/recv") == 1
        hub = telemetry.metrics_active()
        assert hub.get("tcp/send_bytes").count == 1 and hub.get("tcp/recv_bytes").count == 1
    finally:
        tx.close()
        rx.close()


# ---------------------------------------------------------------------------
# In-process end to end: merged trace + event log + registry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    telemetry.uninstall()
    tmp = tmp_path_factory.mktemp("traced_run")
    cfg = make_cfg(tmp, n_rounds=1, eval_interval_rounds=1)
    cfg.photon.telemetry.enabled = True
    cfg.photon.checkpoint = True
    cfg.validate()
    app = make_app(cfg, with_ckpt=True)
    history = app.run()
    app.driver.shutdown()
    tdir = pathlib.Path(app.telemetry_dir)
    trace = load_chrome_trace(tdir / f"trace-{cfg.run_uuid}.json")
    events = read_events_jsonl(str(tdir / f"events-{cfg.run_uuid}.jsonl"))
    telemetry.uninstall()
    return cfg, history, trace, events


def test_traced_run_merged_timeline(traced_run):
    _, _, trace, events = traced_run
    complete = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in complete}
    assert {"server/round", "server/fit_round_time", "server/broadcast_pre_time",
            "server/checkpoint_time", "server/ckpt_async_write_s", "server/eval_round",
            "server/agg_fold_time", "client/fit", "client/train", "client/encode",
            "client/evaluate"} <= names
    idx = span_index(trace)
    round_ids = {e["args"]["span_id"] for e in complete if e["name"] == "server/round"}
    fits = [e for e in complete if e["name"] == "client/fit"]
    assert fits
    for f in fits:
        rnd = _walk_to_round(idx, f)
        assert rnd is not None and rnd["args"]["span_id"] in round_ids
    assert "membership/transition" in {e["kind"] for e in events}
    assert any(e["kind"] == "speed_monitor/peak" for e in events)


def test_traced_run_parses_as_perfetto_json(traced_run):
    _, _, trace, _ = traced_run
    assert isinstance(trace["traceEvents"], list)
    for ev in trace["traceEvents"]:
        assert "ph" in ev and "name" in ev
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
    assert json.dumps(trace)


def test_metric_registry_covers_runtime_names(traced_run):
    from photon_tpu_torch.utils.profiling import is_registered_metric

    _, history, _, _ = traced_run
    runtime = [k for k in history.rounds if k.startswith(("server/", "client/"))]
    assert runtime
    unregistered = sorted(k for k in runtime if not is_registered_metric(k))
    assert not unregistered, unregistered


def test_registry_constants_are_unique():
    from photon_tpu_torch.utils import profiling

    names = [v for k, v in vars(profiling).items()
             if isinstance(v, str) and not k.startswith("_")
             and v.startswith(("server/", "client/", "serve/", "router/"))]
    assert len(names) == len(set(names)), "duplicate KPI constants"


def test_registry_covers_serve_names():
    from photon_tpu_torch.utils.profiling import registered_metric_names

    names = registered_metric_names()
    for expect in ("serve/ttft_s", "serve/tokens_per_s", "serve/queue_depth",
                   "serve/slot_occupancy", "serve/evictions", "serve/rejected"):
        assert expect in names, expect


def test_registry_covers_fleet_router_names():
    from photon_tpu_torch.utils.profiling import registered_metric_names

    names = registered_metric_names()
    for expect in ("router/requests_total", "router/reroutes_total", "router/replicas_live",
                   "serve/fleet_replicas", "serve/fleet_rolling_swaps_total"):
        assert expect in names, expect


def test_registry_is_jaxs_plus_the_ports_own_names():
    """Every name of JAX's registry is the port's, string for string, and
    the port's extra names are the four phases only it times."""
    from photon_tpu.utils import profiling as jax_prof
    from photon_tpu_torch.utils import profiling as port_prof

    jax_names, ours = jax_prof.registered_metric_names(), port_prof.registered_metric_names()
    assert jax_names <= ours
    assert ours - jax_names == {"server/eval_round_time", "server/server_update_time",
                                "client/get_parameters_time", "client/put_time"}
    for k, v in vars(jax_prof).items():
        if k.isupper() and isinstance(v, str) and "/" in v:
            assert getattr(port_prof, k) == v, k


def test_telemetry_disabled_run_writes_nothing(tmp_path):
    cfg = make_cfg(tmp_path, n_rounds=1)
    app = make_app(cfg)
    app.run()
    app.driver.shutdown()
    assert telemetry.active() is None
    assert not pathlib.Path(app.telemetry_dir).exists()


def test_traced_run_params_equal_untraced_bit_for_bit(tmp_path):
    """Telemetry observes; it changes no number: 2 rounds with an eval and
    checkpoints give the same parameters, bit for bit, traced or not."""
    out = {}
    for traced in (False, True):
        cfg = make_cfg(tmp_path / str(traced), n_rounds=2, eval_interval_rounds=2)
        cfg.photon.checkpoint = True
        cfg.photon.telemetry.enabled = traced
        app = make_app(cfg.validate(), with_ckpt=True)
        history = app.run()
        app.driver.shutdown()
        out[traced] = ([a.copy() for a in app.strategy.current_parameters],
                       history.latest("server/eval_loss"))
        telemetry.uninstall()
    (p0, l0), (p1, l1) = out[False], out[True]
    assert len(p0) == len(p1) and all(np.array_equal(a, b) for a, b in zip(p0, p1))
    assert l0 == l1
    assert (tmp_path / "True" / "save" / "telemetry").is_dir()
    assert not (tmp_path / "False" / "save" / "telemetry").exists()


def test_refill_sent_from_decode_ahead_worker_parents_to_round(tmp_path):
    """Four cids on one node with a pipelined host pool: the first FitIns
    leaves from the round's thread, the refills from the fold's decode-
    ahead worker. Every fit still parents to the round span (the JAX
    package sends the refills with an empty context, so their spans start
    traces of their own)."""
    cfg = make_cfg(tmp_path, n_rounds=1, n_total_clients=4, n_clients_per_round=4,
                   local_steps=1)
    cfg.photon.host_threads = 2
    cfg.photon.telemetry.enabled = True
    app = make_app(cfg.validate(), n_nodes=1)
    assert app.host_pool.pipelined
    app.run()
    app.driver.shutdown()
    trace = load_chrome_trace(pathlib.Path(app.telemetry_dir) / f"trace-{cfg.run_uuid}.json")
    complete = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    idx = span_index(trace)
    (rnd,) = [e for e in complete if e["name"] == "server/round"]
    fits = [e for e in complete if e["name"] == "client/fit"]
    assert len(fits) == 4
    assert len({f["tid"] for f in fits}) >= 2  # the round's thread and a pool worker
    for f in fits:
        assert f["args"]["trace_id"] == rnd["args"]["trace_id"]
        assert _walk_to_round(idx, f) is rnd


# ---------------------------------------------------------------------------
# Across processes: a spawned node, TCP node threads, two --connect processes
# ---------------------------------------------------------------------------


def test_multiprocess_trace_propagation_with_chaos(tmp_path):
    """2 rounds over a spawned node process with store faults: node fits
    (proc node0) parent to the server's round spans across the process
    boundary; the event log has a membership transition and chaos events
    with trace correlation."""
    from photon_tpu_torch.checkpoint import FileStore
    from photon_tpu_torch.federation import MultiprocessDriver, ParamTransport, ServerApp

    cfg = make_cfg(tmp_path, n_rounds=2, n_total_clients=2, n_clients_per_round=2,
                   local_steps=1)
    cfg.photon.comm_stack.shm = False
    cfg.photon.comm_stack.objstore = True
    cfg.photon.telemetry.enabled = True
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.store_slow_p = 1.0
    cfg.photon.chaos.store_slow_max_s = 0.01
    cfg.validate()
    driver = MultiprocessDriver(cfg, n_nodes=1, device="cpu")
    store = FileStore(cfg.photon.save_path + "/store")
    app = ServerApp(cfg, driver, ParamTransport("objstore", store=store))
    try:
        app.run()
    finally:
        driver.shutdown()
    tdir = pathlib.Path(app.telemetry_dir)
    trace = load_chrome_trace(tdir / f"trace-{cfg.run_uuid}.json")
    pid_names = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"] if e.get("ph") == "M"}
    complete = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    idx = span_index(trace)
    fits = [e for e in complete if e["name"] == "client/fit"]
    assert len(fits) == 4
    for f in fits:
        assert pid_names[f["pid"]] == "node0"
        rnd = _walk_to_round(idx, f)
        assert rnd is not None and pid_names[rnd["pid"]] == "server"
        assert f["args"]["trace_id"] == rnd["args"]["trace_id"]
    events = read_events_jsonl(str(tdir / f"events-{cfg.run_uuid}.jsonl"))
    assert "membership/transition" in {e["kind"] for e in events}
    chaos_events = [e for e in events if e["kind"].startswith("chaos/")]
    assert chaos_events and any(e.get("trace_id") for e in chaos_events)
    assert {e["proc"] for e in chaos_events} == {"server", "node0"}


def test_tcp_trace_propagation_under_duplicate_chaos(tmp_path):
    """Trace context rides real socket envelopes, and with every frame
    duplicated the node's msg_id dedup and the window's stale-mid guard
    keep the span stream clean: one fit span per cid, under the round."""
    from photon_tpu_torch import chaos
    from photon_tpu_torch.federation import ParamTransport, ServerApp
    from photon_tpu_torch.federation.tcp import TcpServerDriver

    cfg = make_cfg(tmp_path, n_rounds=1, n_total_clients=2, n_clients_per_round=2,
                   local_steps=1, fit_timeout_s=30.0)
    cfg.photon.telemetry.enabled = True
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.tcp_duplicate_p = 1.0
    cfg.validate()
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=2)
    threads = [_thread_node(cfg, f"node{i}", driver.port) for i in range(2)]
    driver.wait_for_nodes(timeout=30)
    app = ServerApp(cfg, driver, ParamTransport("inline"))
    try:
        assert app.run().latest("server/n_clients") == 2.0
    finally:
        driver.shutdown()
        chaos.uninstall()
    for t in threads:
        t.join(timeout=10)
    trace = load_chrome_trace(pathlib.Path(app.telemetry_dir) / f"trace-{cfg.run_uuid}.json")
    complete = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    idx = span_index(trace)
    rounds = [e for e in complete if e["name"] == "server/round"]
    assert len(rounds) == 1
    fits = [e for e in complete if e["name"] == "client/fit"]
    assert len(fits) == 2
    for f in fits:
        assert f["args"]["trace_id"] == rounds[0]["args"]["trace_id"]
        assert _walk_to_round(idx, f) is not None
    ids = [e["args"]["span_id"] for e in complete]
    assert len(ids) == len(set(ids))
    assert {"tcp/send", "tcp/recv"} <= {e["name"] for e in complete}


def _env() -> dict:
    return {"PATH": "/usr/bin:/bin", "PYTHONPATH": ":".join(sys.path), "HOME": str(ROOT)}


def test_tcp_listen_cli_trace_parents_node_spans_to_server(tmp_path):
    """``federated --tcp-listen`` with two ``federation.tcp --connect``
    processes, telemetry on: ONE merged trace with spans from the three
    processes, every node fit and eval under the server's fit-round or
    eval-round span of its round in the same trace, and each node's
    membership transition in the event log."""
    cfg = make_cfg(tmp_path, n_total_clients=2, n_clients_per_round=2, n_rounds=2,
                   local_steps=1, eval_interval_rounds=2)
    cfg.photon.comm_stack.objstore, cfg.photon.comm_stack.shm = True, False
    cfg.photon.telemetry.enabled = True
    cfg.run_uuid = "tcp-traced"
    cfg_path = str(tmp_path / "run.yaml")
    cfg.validate().to_yaml(cfg_path)
    port = _free_port()
    nodes = [subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.federation.tcp", "--connect",
         f"127.0.0.1:{port}", "--node-id", f"node{i}", "--config", cfg_path, "--device", "cpu"],
        cwd=ROOT, env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for i in range(2)]
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "photon_tpu_torch.federated", "--config", cfg_path,
             "--tcp-listen", f"127.0.0.1:{port}", "--nodes", "2"],
            cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    finally:
        for p in nodes:
            try:
                p.wait(timeout=60)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    tdir = pathlib.Path(cfg.photon.save_path) / "telemetry"
    trace = load_chrome_trace(tdir / "trace-tcp-traced.json")
    pid_names = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"] if e.get("ph") == "M"}
    complete = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert {pid_names[e["pid"]] for e in complete} == {"server", "node0", "node1"}
    idx = span_index(trace)
    for name, parent in (("client/fit", "server/fit_round_time"),
                         ("client/evaluate", "server/eval_round")):
        spans = [e for e in complete if e["name"] == name]
        assert spans, name
        for sp in spans:
            up = idx[sp["args"]["parent_id"]]
            assert up["name"] == parent and pid_names[up["pid"]] == "server"
            assert up["args"]["round"] == sp["args"]["round"]
            assert up["args"]["trace_id"] == sp["args"]["trace_id"]
    events = read_events_jsonl(str(tdir / "events-tcp-traced.jsonl"))
    seen = {e["attrs"]["node"] for e in events if e["kind"] == "membership/transition"}
    assert seen == {"node0", "node1"}
