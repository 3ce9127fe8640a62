"""``photon_tpu_torch.chaos`` and its hook sites, against ``photon_tpu.chaos``.

1. Parity: for several seeds and scopes, the JAX package's
   ``FaultInjector`` and the port's draw the same plans from every plan
   method, in one interleaved schedule, and end on the same stream state;
   ``corrupt_bytes`` flips the same bit.
2. One port case for each of the 23 cases of ``tests/test_chaos.py``, on
   the port's own store, ``SocketConn``, node agent, client runtime and
   ``MultiprocessDriver`` (a crash mid-fit, then readmission). The JAX
   file's two ``slow`` cases run here in tier-1. The soak keeps its
   federation half; its retrace-sentinel and lock-order half
   (``photon_tpu.analysis``) waits for that package's port.
3. ``tests/test_router.py::test_chaos_replica_kill_mid_traffic`` on the
   port's in-process fleet (its router's ``kill_hook``; the fleet's
   telemetry events are cases of ``tests/test_torch_observatory.py``); the scheduler's
   ``serve_stall`` and the client runtime's ``nan_delta`` and
   ``fit_delay``; the schema: ``photon.chaos`` validates with JAX's
   texts, telemetry's autopilot validates with the plane, and so do async
   rounds and the collective plane (JAX's texts for their bad values).

With chaos off, TCP frames and store bytes are what they were before the
hooks (``test_tcp_frames_unchanged_with_chaos_off``,
``test_store_roundtrip_identical_with_chaos_off``).
"""

import dataclasses
import pickle
import random
import socket
import struct
import time
import zlib

import numpy as np
import pytest

from photon_tpu import chaos as jax_chaos
from photon_tpu.config.schema import ChaosConfig as JaxChaosConfig
from photon_tpu_torch import chaos
from photon_tpu_torch.config.schema import ChaosConfig
from photon_tpu_torch.federation.messages import Envelope, FitRes, Query
from tests.test_torch_tcp import make_cfg
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


@pytest.fixture(autouse=True)
def _clean_injector():
    """Never leave a process-global injector to another test."""
    yield
    chaos.uninstall()
    jax_chaos.uninstall()


def _chaos_cfg(**kw) -> ChaosConfig:
    return ChaosConfig(enabled=True, seed=1234, **kw)


def _make_app(cfg, n_nodes: int = 2):
    from photon_tpu_torch.federation import InProcessDriver, NodeAgent, ParamTransport, ServerApp

    driver = InProcessDriver(cfg, lambda nid: NodeAgent(cfg, nid, lambda: ParamTransport("inline"),
                                                        device="cpu"), n_nodes=n_nodes)
    return ServerApp(cfg, driver, ParamTransport("inline"))


# ---------------------------------------------------------------------------
# 1. the same plans as the JAX package's injector
# ---------------------------------------------------------------------------

PARITY_KNOBS = dict(
    tcp_drop_p=0.15, tcp_delay_p=0.3, tcp_delay_max_s=0.05, tcp_duplicate_p=0.25,
    tcp_corrupt_p=0.2, store_slow_p=0.4, store_slow_max_s=0.05, store_partial_p=0.2,
    store_bitflip_p=0.3, store_fault_max=5, nan_delta_round=2, nan_delta_cid=-1,
    replica_kill_after_requests=7, fit_delay_factor=4.0, fit_delay_cid=-1,
    serve_stall_per_token_s=0.001, serve_hbm_ramp_frac=0.05,
    crash_phase="mid-fit", crash_round=2,
)


def _draw(inj, op: str, arg: int):
    """One plan call, its result as plain data."""
    if op == "tcp":
        return dataclasses.astuple(inj.tcp_plan())
    if op == "corrupt":
        return inj.corrupt_bytes(bytes(range(arg % 200 + 1)))
    if op == "store":
        return dataclasses.astuple(inj.store_plan())
    if op == "store_read":
        return dataclasses.astuple(inj.store_read_plan())
    if op == "nan":
        return inj.nan_delta_plan(arg % 4, arg % 3)
    if op == "fit_delay":
        return inj.fit_delay_plan(arg % 5)
    if op == "stall":
        return inj.serve_stall_plan(arg % 7)
    if op == "hbm":
        return inj.hbm_ramp_plan()
    if op == "kill":
        return inj.replica_kill_plan(arg % 10, [f"replica{i}" for i in (2, 0, 1)])
    if op == "crash":
        return inj.maybe_crash("mid-fit", arg % 3, f"node{arg % 2}")
    raise AssertionError(op)


OPS = ("tcp", "corrupt", "store", "store_read", "nan", "fit_delay", "stall", "hbm", "kill",
       "crash")


@pytest.mark.parametrize("seed", [0, 1234, 987654321])
@pytest.mark.parametrize("scope", ["server", "node0", "node1", "fleet"])
def test_plans_match_jax(seed, scope):
    ours = chaos.FaultInjector(ChaosConfig(enabled=True, seed=seed, **PARITY_KNOBS), scope=scope,
                               crash_fn=lambda code: None)
    theirs = jax_chaos.FaultInjector(JaxChaosConfig(enabled=True, seed=seed, **PARITY_KNOBS),
                                     scope=scope, crash_fn=lambda code: None)
    schedule = random.Random(seed ^ 77)
    for step in range(600):
        op, arg = schedule.choice(OPS), schedule.randrange(1000)
        assert _draw(ours, op, arg) == _draw(theirs, op, arg), (step, op)
    assert ours.counts == theirs.counts
    assert ours.rng.getstate() == theirs.rng.getstate()
    assert all(ours.counts[k] for k in ("tcp_drop", "tcp_corrupt", "store_read_bitflip", "crash",
                                       "replica_kill", "nan_delta", "fit_delay", "hbm_ramp"))
    # the fields, defaults and checks are the JAX package's
    assert [f.name for f in dataclasses.fields(ChaosConfig)] == \
        [f.name for f in dataclasses.fields(JaxChaosConfig)]
    assert dataclasses.asdict(ChaosConfig()) == dataclasses.asdict(JaxChaosConfig())


# ---------------------------------------------------------------------------
# 2. the injector (tests/test_chaos.py)
# ---------------------------------------------------------------------------

def test_disabled_chaos_is_a_noop():
    assert chaos.active() is None
    assert chaos.install(ChaosConfig()) is None  # enabled=False clears
    assert chaos.install(None) is None
    chaos.crash_point("mid-fit", 1, "node0")  # must not raise or exit


def test_injector_schedule_is_deterministic():
    cfg = _chaos_cfg(tcp_drop_p=0.3, tcp_delay_p=0.3, tcp_duplicate_p=0.3, tcp_corrupt_p=0.3)
    a = chaos.FaultInjector(cfg, scope="node0")
    b = chaos.FaultInjector(cfg, scope="node0")
    plans_a = [a.tcp_plan() for _ in range(64)]
    assert plans_a == [b.tcp_plan() for _ in range(64)]
    assert a.counts == b.counts
    c = chaos.FaultInjector(cfg, scope="node1")  # another scope, another stream
    assert [c.tcp_plan() for _ in range(64)] != plans_a


def test_corrupt_bytes_flips_exactly_one_bit():
    inj = chaos.FaultInjector(_chaos_cfg(), scope="x")
    ref = jax_chaos.FaultInjector(JaxChaosConfig(enabled=True, seed=1234), scope="x")
    data = bytes(range(256))
    out = inj.corrupt_bytes(data)
    assert len(out) == len(data) and out == ref.corrupt_bytes(data)
    diff = [(x ^ y) for x, y in zip(data, out) if x != y]
    assert len(diff) == 1 and bin(diff[0]).count("1") == 1
    assert inj.corrupt_bytes(b"") == b""


def test_crash_point_matching_and_marker(tmp_path):
    marker = tmp_path / "crashed"
    crashes = []
    cfg = _chaos_cfg(crash_phase="mid-fit", crash_round=2, crash_node_id="node1",
                     crash_marker=str(marker))
    chaos.install(cfg, scope="node1", crash_fn=crashes.append)
    chaos.crash_point("pre-fit", 2, "node1")  # wrong phase
    chaos.crash_point("mid-fit", 1, "node1")  # wrong round
    chaos.crash_point("mid-fit", 2, "node0")  # wrong node
    assert crashes == [] and not marker.exists()
    chaos.crash_point("mid-fit", 2, "node1")
    assert crashes == [137] and marker.exists()
    chaos.crash_point("mid-fit", 2, "node1")  # the marker disarms a repeat
    assert crashes == [137]
    assert chaos.active().counts["crash"] == 1


# ---------------------------------------------------------------------------
# TCP envelope faults and the CRC framing
# ---------------------------------------------------------------------------

def _pair():
    from photon_tpu_torch.federation.tcp import SocketConn

    a, b = socket.socketpair()
    return SocketConn(a), SocketConn(b)


def test_tcp_corrupt_frame_detected_by_crc():
    from photon_tpu_torch.federation.tcp import CorruptFrameError

    tx, rx = _pair()
    chaos.install(_chaos_cfg(tcp_corrupt_p=1.0), scope="t")
    tx.send(Envelope(Query("ping"), 1))
    with pytest.raises(CorruptFrameError, match="CRC"):
        rx.recv()
    assert issubclass(CorruptFrameError, EOFError)  # every teardown path applies
    tx.close(); rx.close()


def test_tcp_duplicate_and_drop():
    tx, rx = _pair()
    chaos.install(_chaos_cfg(tcp_duplicate_p=1.0), scope="t")
    tx.send(Envelope(Query("ping"), 7))
    first, second = rx.recv(), rx.recv()
    assert first.msg_id == second.msg_id == 7

    chaos.install(_chaos_cfg(tcp_drop_p=1.0), scope="t")
    tx.send(Envelope(Query("ping"), 8))
    rx.sock.settimeout(0.2)
    with pytest.raises(OSError):  # nothing ever arrives
        rx.recv()
    tx.close(); rx.close()


def test_tcp_chaos_exempts_non_envelopes():
    """HELLO frames are never faulted: membership cannot be wedged."""
    tx, rx = _pair()
    chaos.install(_chaos_cfg(tcp_drop_p=1.0, tcp_corrupt_p=1.0), scope="t")
    tx.send({"kind": "__hello__", "node_id": "n0"})
    assert rx.recv()["node_id"] == "n0"
    tx.close(); rx.close()


def test_tcp_frames_unchanged_with_chaos_off():
    """With chaos off a frame is the ``<QI`` header and the pickle, exactly
    the bytes the port sent before its hooks."""
    tx, rx = _pair()
    env = Envelope(Query("ping"), 42)
    tx.send(env)
    data = pickle.dumps(env, protocol=pickle.HIGHEST_PROTOCOL)
    want = struct.pack("<QI", len(data), zlib.crc32(data)) + data
    got = b""
    while len(got) < len(want):
        got += rx.sock.recv(len(want) - len(got))
    assert got == want
    tx.send(env)
    back = rx.recv()
    assert back.msg_id == 42 and back.msg.action == "ping"
    tx.close(); rx.close()


# ---------------------------------------------------------------------------
# object-store faults
# ---------------------------------------------------------------------------

def test_store_bitflip_lands_corrupt_object(tmp_path):
    from photon_tpu_torch.checkpoint.store import FileStore

    s = FileStore(tmp_path)
    data = bytes(1000)
    chaos.install(_chaos_cfg(store_bitflip_p=1.0), scope="srv")
    s.put("obj.bin", data)
    chaos.uninstall()
    got = s.get("obj.bin")
    assert len(got) == len(data) and got != data  # well formed, wrong bytes


def test_store_partial_write_never_lands(tmp_path):
    from photon_tpu_torch.checkpoint.store import FileStore

    s = FileStore(tmp_path)
    chaos.install(_chaos_cfg(store_partial_p=1.0), scope="srv")
    s.put("obj.bin", b"x" * 100)
    assert not s.exists("obj.bin")
    assert s.list("") == []  # the torn .tmp is not a listable object
    leaked = [p for p in tmp_path.rglob("*") if ".tmp-" in p.name]
    assert len(leaked) == 1 and leaked[0].stat().st_size == 50


def test_store_slow_write_still_correct(tmp_path):
    from photon_tpu_torch.checkpoint.store import FileStore

    s = FileStore(tmp_path)
    inj = chaos.install(_chaos_cfg(store_slow_p=1.0, store_slow_max_s=0.01), scope="srv")
    s.put("obj.bin", b"payload")
    assert s.get("obj.bin") == b"payload"
    assert inj.counts["store_slow"] == 1 and inj.counts["store_read_slow"] == 1


def test_store_roundtrip_identical_with_chaos_off(tmp_path):
    from photon_tpu_torch.checkpoint.store import FileStore

    s = FileStore(tmp_path)
    data = np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    s.put("obj.bin", data)
    s.put("t.bin", data, durable=False)
    assert s.get("obj.bin") == data and (tmp_path / "obj.bin").read_bytes() == data
    assert (tmp_path / "t.bin").read_bytes() == data
    assert sorted(s.list("")) == ["obj.bin", "t.bin"]


def test_store_read_faults_honor_the_plan(tmp_path):
    from photon_tpu_torch.checkpoint.store import FileStore

    s = FileStore(tmp_path)
    data = np.random.default_rng(7).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    s.put("obj.bin", data)  # written clean: chaos installs after

    inj = chaos.install(_chaos_cfg(store_bitflip_p=1.0), scope="srv")
    got = s.get("obj.bin")
    assert len(got) == len(data) and got != data
    assert inj.counts["store_read_bitflip"] == 1
    chaos.uninstall()
    assert s.get("obj.bin") == data  # a fault of the read, not of the disk

    inj = chaos.install(_chaos_cfg(store_partial_p=1.0), scope="srv")
    assert s.get("obj.bin") == data[: len(data) // 2]  # a short read
    assert inj.counts["store_read_partial"] == 1
    chaos.uninstall()

    inj = chaos.install(_chaos_cfg(store_slow_p=1.0, store_slow_max_s=0.01), scope="srv")
    assert s.get("obj.bin") == data  # slow but right
    assert inj.counts["store_read_slow"] == 1


def test_store_get_to_file_routes_through_read_faults(tmp_path):
    from photon_tpu_torch.checkpoint.store import FileStore

    s = FileStore(tmp_path / "store")
    s.put("obj.bin", b"a" * 1000)
    chaos.install(_chaos_cfg(store_bitflip_p=1.0), scope="srv")
    dst = tmp_path / "out" / "out.bin"
    s.get_to_file("obj.bin", dst)
    fetched = dst.read_bytes()
    assert len(fetched) == 1000 and fetched != b"a" * 1000


def test_store_fault_max_corrupts_exactly_one_object(tmp_path):
    from photon_tpu_torch.checkpoint.store import FileStore

    s = FileStore(tmp_path)
    objs = {f"o{i}.bin": bytes([i]) * 512 for i in range(8)}
    for k, v in objs.items():
        s.put(k, v)
    inj = chaos.install(_chaos_cfg(store_bitflip_p=1.0, store_fault_max=1), scope="srv")
    corrupted = [k for k, v in objs.items() if s.get(k) != v]
    assert len(corrupted) == 1
    assert inj.counts["store_read_bitflip"] == 1


def test_store_fault_max_gates_corruption_not_delays(tmp_path):
    from photon_tpu_torch.checkpoint.store import FileStore

    s = FileStore(tmp_path)
    objs = {f"o{i}.bin": bytes([i]) * 64 for i in range(4)}
    for k, v in objs.items():
        s.put(k, v)
    inj = chaos.install(_chaos_cfg(store_slow_p=1.0, store_slow_max_s=0.001,
                                   store_bitflip_p=1.0, store_fault_max=1), scope="srv")
    corrupted = [k for k, v in objs.items() if s.get(k) != v]
    assert len(corrupted) == 1
    assert inj.counts["store_read_bitflip"] == 1
    assert inj.counts["store_read_slow"] == 4  # delays are never capped


# ---------------------------------------------------------------------------
# chaos → integrity: a corrupt checkpoint is skipped at resume
# ---------------------------------------------------------------------------

def _ckpt_fixture(tmp_path):
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.codec.params import ParamsMetadata

    arrays = [np.ones((8, 8), dtype=np.float32)]
    meta = ParamsMetadata.from_ndarrays(["w"], arrays)
    return FileStore, ServerCheckpointManager, meta, arrays


def test_chaos_bitflip_checkpoint_skipped_at_resume(tmp_path):
    """A bit flipped in round 3's write (after the manifest's CRCs were
    taken over the true bytes) is caught; resume falls back to round 2."""
    FileStore, Mgr, meta, arrays = _ckpt_fixture(tmp_path)
    mgr = Mgr(FileStore(tmp_path), "run1")
    mgr.save_round(1, meta, arrays, {}, {"round": 1})
    mgr.save_round(2, meta, arrays, {}, {"round": 2})
    chaos.install(_chaos_cfg(store_bitflip_p=1.0), scope="srv")
    mgr.save_round(3, meta, arrays, {}, {"round": 3})
    chaos.uninstall()
    assert not mgr.verify_round(3)
    with pytest.warns(UserWarning, match="checksum"):
        assert mgr.resolve_resume_round(-1) == 2


def test_chaos_bitflipped_read_skipped_at_resume(tmp_path):
    """Every checkpoint at rest is valid, but one read comes back
    bit-flipped (capped to exactly one): a checksum skip, never a garbage
    load."""
    FileStore, Mgr, meta, arrays = _ckpt_fixture(tmp_path)
    mgr = Mgr(FileStore(tmp_path), "run1")
    for r in (1, 2, 3):
        mgr.save_round(r, meta, arrays, {}, {"round": r})
    resumer = Mgr(FileStore(tmp_path), "run1")
    inj = chaos.install(_chaos_cfg(store_bitflip_p=1.0, store_fault_max=1), scope="srv")
    with pytest.warns(UserWarning, match="checksum"):
        resumed = resumer.resolve_resume_round(-1)
    assert resumed == 2
    assert inj.counts["store_read_bitflip"] == 1
    _, params, _, server_state = resumer.load_round(resumed)
    np.testing.assert_array_equal(params[0], arrays[0])
    assert server_state == {"round": 2}
    chaos.uninstall()
    assert Mgr(FileStore(tmp_path), "run1").verify_round(3)


# ---------------------------------------------------------------------------
# crash hooks (a recording crash_fn; no process exits)
# ---------------------------------------------------------------------------

def test_crash_hooks_fire_pre_and_mid_fit(tmp_path):
    for phase in ("pre-fit", "mid-fit"):
        cfg = make_cfg(tmp_path, n_rounds=1)
        cfg.photon.chaos.enabled = True
        cfg.photon.chaos.crash_phase = phase
        cfg.photon.chaos.crash_round = 1
        with pytest.warns(UserWarning, match="crash injection disabled"):
            app = _make_app(cfg)
        assert chaos.active() is not None and chaos.active().scope == "server"
        recorded = []
        # in-process agents share the server's injector: one with a
        # recording crash_fn replaces the neutered one
        chaos.install(cfg.photon.chaos, scope="server", crash_fn=recorded.append)
        app.run()
        app.driver.shutdown()
        assert recorded and set(recorded) == {137}, phase


class _StubConn:
    def __init__(self, envs):
        self.envs = list(envs)
        self.sent = []

    def recv(self):
        if not self.envs:
            raise EOFError
        return self.envs.pop(0)

    def send(self, obj):
        self.sent.append(obj)


def test_serve_deduplicates_repeated_envelopes(tmp_path):
    """A duplicated FitIns must not run the fit twice."""
    from photon_tpu_torch.federation import NodeAgent, ParamTransport

    agent = NodeAgent(make_cfg(tmp_path), "node0", lambda: ParamTransport("inline"),
                      device="cpu")
    handled = []
    orig = agent.handle
    agent.handle = lambda msg: (handled.append(msg), orig(msg))[1]
    ping = Envelope(Query("ping"), 5)
    conn = _StubConn([ping, ping, Envelope(Query("ping"), 6)])
    agent.serve(conn)
    agent.runtime.close()
    assert len(handled) == 2  # mids 5 and 6 once each; the repeat dropped
    assert [e.msg_id for e in conn.sent] == [5, 6]


def test_pre_reply_crash_hook_fires_in_serve(tmp_path):
    """pre-reply: the work done, the result not on the wire yet. An error
    FitRes counts: the reply is what matters."""
    from photon_tpu_torch.federation import NodeAgent, ParamTransport
    from photon_tpu_torch.federation.messages import FitIns

    cfg = make_cfg(tmp_path)
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.crash_phase = "pre-reply"
    recorded = []
    chaos.install(cfg.photon.chaos, scope="node0", crash_fn=recorded.append)
    agent = NodeAgent(cfg, "node0", lambda: ParamTransport("inline"), device="cpu")
    # params=None with no broadcast yet: an error FitRes, cheaply
    ins = FitIns(server_round=1, cids=[0], params=None, local_steps=1, server_steps_cumulative=0)
    conn = _StubConn([Envelope(ins, 1)])
    agent.serve(conn)
    agent.runtime.close()
    assert recorded == [137]
    assert len(conn.sent) == 1 and isinstance(conn.sent[0].msg[0], FitRes)


# ---------------------------------------------------------------------------
# the end to end: a node killed mid-fit, absorbed by the budget, readmitted
# ---------------------------------------------------------------------------

def test_chaos_crash_midfit_node_readmitted_e2e(tmp_path):
    """A spawned node ``os._exit``s mid-fit in round 1. The round finishes
    within its failure budget, the driver starts the node again, the
    server re-broadcasts and readmits it, and later rounds run at full
    strength."""
    from photon_tpu_torch.checkpoint import FileStore
    from photon_tpu_torch.federation import MultiprocessDriver, ParamTransport, ServerApp

    cfg = make_cfg(tmp_path, n_rounds=3, n_total_clients=2, n_clients_per_round=2,
                   local_steps=1, accept_failures_cnt=1)
    cfg.photon.comm_stack.shm, cfg.photon.comm_stack.objstore = False, True
    ch = cfg.photon.chaos
    ch.enabled, ch.crash_phase, ch.crash_round, ch.crash_node_id = True, "mid-fit", 1, "node0"
    ch.crash_marker = str(tmp_path / "crash_marker")
    cfg.validate()

    driver = MultiprocessDriver(cfg, n_nodes=2, device="cpu")
    app = ServerApp(cfg, driver, ParamTransport(
        "objstore", store=FileStore(cfg.photon.save_path + "/store")))
    try:
        history = app.run()
        stats = driver.hello_stats()
    finally:
        driver.shutdown()
    assert (tmp_path / "crash_marker").exists(), "the chaos crash never fired"
    n_clients = dict(history.series("server/n_clients"))
    assert n_clients == {1: 2.0, 2: 2.0, 3: 2.0}  # round 1 retried the cid
    assert history.cumulative("server/nodes_readmitted") >= 1.0
    assert history.latest("server/nodes_live") == 2.0
    assert stats.get("node0", {}).get("reconnects", 0) >= 1
    assert not history.series("server/round_failed")


def test_soak_random_failures_across_rounds(tmp_path):
    """Seeded failures over 6 rounds: one cid flakes once every round (it
    must be retried and folded), some rounds lose one cid for good (the
    budget absorbs it), and blackout rounds lose three of four (the budget
    is exceeded and ``ignore_failed_rounds`` carries the run on). The JAX
    case also runs photon-lint's retrace sentinel and lock-order recorder,
    which wait for ``photon_tpu.analysis``'s port."""
    n_rounds = 6
    cfg = make_cfg(tmp_path, n_rounds=n_rounds, n_total_clients=4, n_clients_per_round=3,
                   accept_failures_cnt=1, ignore_failed_rounds=True)
    app = _make_app(cfg)

    rng = random.Random(1234)
    plan = {"first_attempt_fails": set(), "hard_fails": set()}
    blackout_rounds = set()
    for rnd in range(1, n_rounds + 1):
        plan["first_attempt_fails"].add((rnd, rng.randrange(4)))
        roll = rng.random()
        if roll < 0.3:
            blackout_rounds.add(rnd)
            for cid in rng.sample(range(4), 3):
                plan["hard_fails"].add((rnd, cid))
        elif roll < 0.6:
            plan["hard_fails"].add((rnd, rng.randrange(4)))
    assert blackout_rounds, "the seed must schedule a blackout round"

    attempts: dict[tuple[int, int], int] = {}
    for agent in app.driver._agents.values():
        orig_fit = agent.runtime.fit

        def fit(ins, cid, _orig=orig_fit):
            key = (ins.server_round, cid)
            attempts[key] = attempts.get(key, 0) + 1
            if key in plan["hard_fails"]:
                return FitRes(ins.server_round, cid, None, error="chaos-hard")
            if key in plan["first_attempt_fails"] and attempts[key] == 1:
                return FitRes(ins.server_round, cid, None, error="chaos-flaky")
            return _orig(ins, cid)

        agent.runtime.fit = fit

    history = app.run()
    app.driver.shutdown()

    rounds_failed = {r for r, _ in history.series("server/round_failed")}
    rounds_ok = [r for r, _ in history.series("server/n_clients")]
    assert len(rounds_ok) + len(rounds_failed) == n_rounds
    assert blackout_rounds <= rounds_failed, (blackout_rounds, rounds_failed)
    assert rounds_ok
    for rnd in range(1, n_rounds + 1):
        if not any(r == rnd for r, _ in plan["hard_fails"]):
            assert rnd in rounds_ok, f"round {rnd} had only flaky failures"
    for _, norm in history.series("server/pseudo_grad_norm"):
        assert np.isfinite(norm) and norm > 0
    steps = dict(history.series("server/steps_cumulative"))
    assert app.server_steps_cumulative == len(rounds_ok) * cfg.fl.local_steps
    assert steps[rounds_ok[-1]] == app.server_steps_cumulative
    for (rnd, cid) in plan["first_attempt_fails"]:
        if rnd in rounds_ok and (rnd, cid) not in plan["hard_fails"] and (rnd, cid) in attempts:
            assert attempts[(rnd, cid)] >= 2, (rnd, cid)


# ---------------------------------------------------------------------------
# 3. the other sites and the schema
# ---------------------------------------------------------------------------

def test_nan_delta_and_fit_delay_in_the_client_runtime(tmp_path):
    """``nan_delta`` poisons the shipped copy of round 1's result, never
    the trainer's arrays; ``fit_delay`` rides the fit metrics under
    ``client/fit_delay_factor``, with the JAX injector's factor."""
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.federation import ParamTransport
    from photon_tpu_torch.federation.client_runtime import ClientRuntime
    from photon_tpu_torch.federation.messages import FitIns
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.utils.profiling import CLIENT_FIT_DELAY_FACTOR

    cfg = make_cfg(tmp_path)
    knobs = dict(nan_delta_round=1, nan_delta_cid=1, fit_delay_factor=4.0, fit_delay_cid=-1)
    inj = chaos.install(_chaos_cfg(**knobs), scope="node0")
    rt = ClientRuntime(cfg, ParamTransport("inline"), node_id="node0", device="cpu")
    try:
        rt.set_broadcast_params(rt.transport.put("b", *params_to_ndarrays(
            init_params(cfg.model, seed=cfg.seed))))
        res = {cid: rt.fit(FitIns(1, [cid], None, 1, 0), cid) for cid in (0, 1)}
        for cid, r in res.items():
            assert r.error is None, r.error
            arrays = rt.transport.get(r.params)[1]
            assert np.isnan(arrays[0].reshape(-1)[0]) == (cid == 1)
            assert all(np.isfinite(a).all() for a in arrays[1:])
            ref = jax_chaos.FaultInjector(JaxChaosConfig(enabled=True, seed=1234, **knobs),
                                          scope="node0")
            assert r.metrics[CLIENT_FIT_DELAY_FACTOR] == ref.fit_delay_plan(cid) > 1.0
        assert all(np.isfinite(a).all() for a in rt.trainer.get_parameters()[1])
        assert inj.counts["nan_delta"] == 1 and inj.counts["fit_delay"] == 2
    finally:
        rt.close()


def test_serve_stall_per_token_in_the_scheduler():
    """Each scheduler step stalls ``serve_stall_per_token_s`` per token it
    carried (the prompt chunk and the emissions)."""
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher
    from tests.test_torch_router import _fleet_cfg, _jax_fleet_cfg, _weights

    cfg = _fleet_cfg()
    _, params = _weights(_jax_fleet_cfg())
    inj = chaos.install(_chaos_cfg(serve_stall_per_token_s=0.01), scope="serve")
    batcher = ContinuousBatcher(PagedEngine(cfg, params, device="cpu"),
                                prefill_token_budget=64).start()
    try:
        t0 = time.monotonic()
        out = batcher.submit([3, 4, 5, 6, 7], 4).result(timeout=60)
        wall = time.monotonic() - t0
    finally:
        batcher.close()
    assert len(out) == 4
    # 5 prompt tokens with the first emission, then 3 emissions: 9 tokens
    assert inj.counts["serve_stall"] == 4 and wall >= 0.09


def test_chaos_replica_kill_mid_traffic():
    """The seeded injector kills one replica after 3 placements, once,
    through the in-process fleet's ``kill_hook``; the survivors drop
    nothing (``tests/test_router.py``'s case without its telemetry
    events)."""
    from photon_tpu_torch.serve.fleet import InProcessFleet
    from tests.test_torch_router import _fleet_cfg, _jax_fleet_cfg, _post_generate, _wait_dead
    from tests.test_torch_router import _weights as fleet_weights

    cfg = _fleet_cfg()
    _, params = fleet_weights(_jax_fleet_cfg())
    chaos.install(ChaosConfig(enabled=True, seed=77, replica_kill_after_requests=3),
                  scope="fleet")
    fleet = InProcessFleet(cfg, params, device="cpu")
    try:
        port = fleet.start(timeout=60)
        for i in range(8):
            status, out = _post_generate(port, {"tokens": [2 + i, 3, 4, 5, 6],
                                                "max_new_tokens": 4})
            assert status == 200, f"request {i} dropped around the kill"
            assert len(out["tokens"]) == 4
        inj = chaos.active()
        assert inj is not None and inj.counts["replica_kill"] == 1
        killed = [r for r, rep in fleet.replicas.items() if rep["killed"]]
        # the JAX injector picks the same victim from the same stream
        ref = jax_chaos.FaultInjector(JaxChaosConfig(enabled=True, seed=77,
                                                     replica_kill_after_requests=3),
                                      scope="fleet")
        assert killed == [ref.replica_kill_plan(3, sorted(fleet.replicas))]
        _wait_dead(fleet.router, killed[0])
        st = fleet.router.fleet_status()["fleet"]
        assert st["dead"] == 1 and st["live"] == 2
    finally:
        fleet.close()


def test_chaos_config_validates_with_jax_texts(tmp_path):
    """``photon.chaos`` validates (the JAX package's texts and its warning
    for knobs set while off); telemetry's autopilot validates with the plane,
    and so do the collective plane and async rounds on it (without it,
    async rounds raise JAX's text)."""
    from photon_tpu.config.schema import Config as JaxConfig
    from photon_tpu_torch.config.schema import Config

    cfg = make_cfg(tmp_path)
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.crash_phase = "mid-fit"
    cfg.validate()
    back = JaxConfig.from_yaml(_yaml(cfg, tmp_path / "c.yaml"))
    assert dataclasses.asdict(back.photon.chaos) == dataclasses.asdict(cfg.photon.chaos)
    for field, value in (("tcp_drop_p", 1.5), ("store_bitflip_p", -0.1), ("tcp_delay_max_s", -1.0),
                         ("crash_phase", "mid-air"), ("crash_round", -1), ("nan_delta_round", -1),
                         ("store_fault_max", -1), ("replica_kill_after_requests", -1),
                         ("fit_delay_factor", 0.5), ("fit_delay_cid", -2),
                         ("serve_stall_per_token_s", -1.0), ("serve_hbm_ramp_frac", -0.5)):
        ours, theirs = make_cfg(tmp_path), JaxConfig.from_yaml(_yaml(make_cfg(tmp_path),
                                                                      tmp_path / "j.yaml"))
        setattr(ours.photon.chaos, field, value)
        setattr(theirs.photon.chaos, field, value)
        with pytest.raises(ValueError) as got:
            ours.validate()
        with pytest.raises(ValueError) as want:
            theirs.validate()
        assert str(got.value) == str(want.value), field
    off = make_cfg(tmp_path)
    off.photon.chaos.tcp_drop_p = 0.1
    with pytest.warns(UserWarning, match="chaos.enabled=False"):
        off.validate()
    for feature in ("telemetry", "async_rounds"):
        d = make_cfg(tmp_path).to_dict()
        d["photon"][feature]["enabled"] = True
        if feature == "telemetry":  # ported, its SLO autopilot too
            d["photon"][feature]["autopilot"] = {"enabled": True}
            Config.from_dict(d).validate()
            continue
        # async rounds need the collective plane, in both packages' words
        with pytest.raises(ValueError) as got:
            Config.from_dict(d).validate()
        with pytest.raises(ValueError) as want:
            JaxConfig.from_dict(d).validate()
        assert str(got.value) == str(want.value)
        d["photon"]["comm_stack"].update(collective=True, shm=False)
        Config.from_dict(d).validate()
    collective = make_cfg(tmp_path)
    collective.photon.comm_stack.collective = True
    collective.validate()


def _yaml(cfg, path):
    cfg.to_yaml(path)
    return str(path)


def test_chip_smoke_chaos_phase_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.chaos_phase`` (phase 15) with ``--device cpu``
    children on a small model: the seed's drop and corrupt land, node1
    crashes once and comes back, and every gate but the card-only launch
    count holds. Each fit takes long enough (~1 s) that node1's redial
    after the corrupt frame lands inside round 1's window, as it does at
    full width on the card. On a loaded host the three children's fits
    can outlast the phase's 60 s reply bound, so it is widened here, and
    each child keeps to 2 threads."""
    import torch

    from photon_tpu_torch.ops import flash_attention as fa
    from tests.test_torch_compression import _chip_smoke

    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "CHAOS_TIMEOUT_S", 300.0)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert smoke.chaos_seed_plan(smoke.CHAOS_SEED) == smoke.CHAOS_PLAN
    cfg = make_cfg(tmp_path, n_total_clients=2, n_clients_per_round=2, local_steps=40,
                   eval_interval_rounds=2)
    m = cfg.model
    m.d_model, m.n_heads, m.max_seq_len = 64, 4, 64
    cfg.train.global_batch_size = cfg.train.device_microbatch_size = 8
    cfg.photon.checkpoint = True
    rec = smoke.chaos_phase(torch, np, fa, cfg=cfg, device="cpu", work=tmp_path / "chaos")
    assert rec["node1_first_exit"] == 137 and rec["nodes_readmitted_total"] >= 1
    assert rec["chaos_counts"]["total"]["tcp_drop"] == 1
    assert rec["chaos_counts"]["total"]["tcp_corrupt"] == 1
    assert rec["audit"]["refused"] == rec["audit"]["corrupted"] == 1
    assert not rec["audit"]["corrupted_and_decoded"] and rec["params_finite"]
    assert [r for r, _ in rec["n_clients"]] == [1, 2, 3]
