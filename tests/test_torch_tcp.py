"""The port's TCP control plane (``photon_tpu_torch.federation.tcp``).

One case for each case of ``tests/test_tcp_driver.py`` (framing,
registration, deadlines, malformed and unpicklable HELLOs, a federated
round over localhost sockets with node agents on threads, re-HELLO dead
letters, the ``run_node`` supervisor's redial and crash recovery, a dead
node's synthesized failure; an idle node that keeps its connection, and a
node that redials a server gone silent),
of ``tests/test_tcp_e2e.py`` (a server CLI and
two ``--connect`` node processes: fit, eval, checkpoints, then a resume),
and the TCP case of ``tests/test_round_loop_bugs.py`` (a send to an unknown
node). The JAX originals are marked ``slow``; these run in tier-1, so
every wait (socket, join, subprocess) is bounded and fails instead of
hanging. Nodes train on the CPU. The frame layout is the JAX package's:
a JAX ``SocketConn`` reads a port frame.
"""

import json
import pathlib
import socket
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest

from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation import NodeAgent, ParamTransport, ServerApp
from photon_tpu_torch.federation.messages import Ack, Envelope, Query
from photon_tpu_torch.federation.tcp import (
    _FRAME,
    HELLO_KIND,
    CorruptFrameError,
    SocketConn,
    TcpServerDriver,
    run_node,
)
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

ROOT = pathlib.Path(__file__).resolve().parent.parent


def make_cfg(tmp_path, **fl_kw) -> Config:
    """The JAX suite's ``make_cfg`` (``tests/test_federation.py``) in the
    port's schema; the flash kernels' plain versions run on the CPU."""
    cfg = Config()
    cfg.run_uuid = "testrun"
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size = 32, 2, 2, 16, 64
    m.compute_dtype = "float32"
    cfg.optimizer.lr = 1e-3
    cfg.scheduler.t_warmup, cfg.scheduler.t_max = 2, 1000
    cfg.train.global_batch_size = cfg.train.device_microbatch_size = 4
    cfg.train.eval_batches = 2
    fl = dict(n_total_clients=4, n_clients_per_round=2, n_rounds=3, local_steps=2,
              strategy_name="nesterov", server_learning_rate=1.0, server_momentum=0.0,
              eval_interval_rounds=0, sample_seed=99)
    fl.update(fl_kw)
    for k, v in fl.items():
        setattr(cfg.fl, k, v)
    cfg.photon.save_path, cfg.photon.checkpoint = str(tmp_path / "save"), False
    cfg.photon.host_threads = 1
    cfg.dataset.synthetic = True
    return cfg.validate()


def _wait(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout}s waiting for {what}")
        time.sleep(0.02)


def _thread_node(cfg, node_id, port):
    """A node agent on a thread (the socket path of a node process)."""

    def run():
        agent = NodeAgent(cfg, node_id, lambda: ParamTransport("inline"), device="cpu")
        conn = SocketConn(socket.create_connection(("127.0.0.1", port), timeout=10))
        conn.send({"kind": HELLO_KIND, "node_id": node_id})
        try:
            agent.serve(conn)
        except (EOFError, OSError):
            pass
        finally:
            conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_socket_framing_roundtrip():
    from photon_tpu.federation.tcp import SocketConn as JaxConn

    a, b = socket.socketpair()
    ca, cb = SocketConn(a), JaxConn(b)
    payload = {"x": np.arange(5), "s": "hi"}
    ca.send(payload)  # a port frame, read by the JAX package's framing
    got = cb.recv()
    np.testing.assert_array_equal(got["x"], payload["x"])
    cb.send(payload)
    np.testing.assert_array_equal(ca.recv()["x"], payload["x"])
    ca.close()
    cb.close()


def test_wait_for_nodes_times_out():
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=1)
    with pytest.raises(TimeoutError):
        driver.wait_for_nodes(timeout=0.3)
    driver.shutdown()


def test_recv_deadline_defeats_slow_drip():
    """The deadline bounds a whole recv: a peer dripping one byte at a time
    still trips it."""
    a, b = socket.socketpair()
    conn = SocketConn(a)
    conn.deadline = time.monotonic() + 0.4
    stop = threading.Event()

    def drip():
        b.sendall(b"\x40" + b"\x00" * 11)  # a plausible 64-byte frame header
        while not stop.is_set():
            try:
                b.sendall(b"x")
            except OSError:
                return
            time.sleep(0.05)

    t = threading.Thread(target=drip, name="drip", daemon=True)
    t.start()
    start = time.monotonic()
    try:
        with pytest.raises(socket.timeout):
            conn.recv()
        assert time.monotonic() - start < 5.0
    finally:
        stop.set()
        conn.close()
        b.close()
        t.join(timeout=5)


def test_malformed_hello_does_not_kill_accept_loop():
    """A HELLO without a node id, or not a dict, drops one connection; one
    with garbage stats registers with the stats at 0; the accept thread
    lives on."""
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=1)
    try:
        for bad in ({"kind": HELLO_KIND}, "not even a dict",
                    {"kind": HELLO_KIND, "node_id": "n9", "reconnects": "garbage"}):
            sock = socket.create_connection(("127.0.0.1", driver.port), timeout=10)
            conn = SocketConn(sock)
            conn.send(bad)
            if isinstance(bad, dict) and bad.get("node_id") is None:
                sock.settimeout(5)
                with pytest.raises((EOFError, OSError)):
                    conn.recv()
            conn.close()
        good = SocketConn(socket.create_connection(("127.0.0.1", driver.port), timeout=10))
        good.send({"kind": HELLO_KIND, "node_id": "n1"})
        _wait(lambda: "n1" in driver.node_ids(), 10, "n1 to register")
        assert set(driver.node_ids()) == {"n1", "n9"}
        assert driver.hello_stats()["n9"] == {"reconnects": 0, "backoff_s": 0.0}
        good.close()
    finally:
        driver.shutdown()


#: a protocol-0 pickle naming a missing module: ``pickle.loads`` raises
#: ModuleNotFoundError, as a peer of another version would make it
_UNPICKLABLE = b"cnosuchmodule_photon\nNoSuchCls\n."


def test_unpicklable_frame_is_corrupt_frame_error():
    a, b = socket.socketpair()
    ca, cb = SocketConn(a), SocketConn(b)
    a.sendall(_FRAME.pack(len(_UNPICKLABLE), zlib.crc32(_UNPICKLABLE)) + _UNPICKLABLE)
    with pytest.raises(CorruptFrameError):
        cb.recv()
    ca.close()
    cb.close()


def test_unpicklable_hello_does_not_kill_accept_loop():
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=1)
    try:
        sock = socket.create_connection(("127.0.0.1", driver.port), timeout=10)
        sock.sendall(_FRAME.pack(len(_UNPICKLABLE), zlib.crc32(_UNPICKLABLE)) + _UNPICKLABLE)
        sock.settimeout(5)
        assert sock.recv(1) == b""  # the server dropped the connection
        sock.close()
        good = SocketConn(socket.create_connection(("127.0.0.1", driver.port), timeout=10))
        good.send({"kind": HELLO_KIND, "node_id": "n1"})
        _wait(lambda: "n1" in driver.node_ids(), 10, "n1 to register")
        assert driver.node_ids() == ["n1"]
        good.close()
    finally:
        driver.shutdown()


def test_tcp_fed_round(tmp_path):
    cfg = make_cfg(tmp_path, n_rounds=1, n_total_clients=2, n_clients_per_round=2, local_steps=1)
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=2)
    threads = [_thread_node(cfg, f"node{i}", driver.port) for i in range(2)]
    driver.wait_for_nodes(timeout=30)
    assert driver.node_ids() == ["node0", "node1"]
    app = ServerApp(cfg, driver, ParamTransport("inline"))
    try:
        history = app.run()
        assert history.latest("server/n_clients") == 2.0
        assert history.latest("server/round_time") is not None
    finally:
        driver.shutdown()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


def test_reconnect_dead_letters_inflight_promptly():
    """A re-HELLO that replaces a socket fails its in-flight requests at
    once, and an EOF on the old socket noticed later neither evicts the
    replacement nor fails its requests."""
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=1)
    conn1 = SocketConn(socket.create_connection(("127.0.0.1", driver.port), timeout=10))
    conn1.send({"kind": HELLO_KIND, "node_id": "ghost"})
    driver.wait_for_nodes(timeout=10)
    mid1 = driver.send("ghost", Query("ping"))
    mid2 = driver.send("ghost", Query("ping"))
    conn2 = SocketConn(socket.create_connection(("127.0.0.1", driver.port), timeout=10))
    conn2.send({"kind": HELLO_KIND, "node_id": "ghost", "reconnects": 1, "backoff_s": 0.7})
    _wait(lambda: driver.hello_stats().get("ghost", {}).get("reconnects") == 1, 10, "re-HELLO")
    assert driver.hello_stats()["ghost"]["backoff_s"] == 0.7

    t0 = time.monotonic()
    replies = [driver.recv_any(timeout=5) for _ in range(2)]
    assert time.monotonic() - t0 < 2.0, "dead letters must drain without a timeout"
    assert {mid for _, mid, _ in replies} == {mid1, mid2}
    for _, _, reply in replies:
        assert not reply.ok and "node died" in reply.detail
    assert driver.node_ids() == ["ghost"]
    conn1.close()
    mid3 = driver.send("ghost", Query("ping"))
    conn2.sock.settimeout(10)
    env = conn2.recv()
    assert env.msg_id == mid3
    conn2.send(Envelope(Ack(ok=True, node_id="ghost"), env.msg_id))
    nid, mid, reply = driver.recv_any(timeout=10)
    assert (nid, mid) == ("ghost", mid3) and reply.ok
    assert driver.node_ids() == ["ghost"]
    conn2.close()
    driver.shutdown()


def test_run_node_supervisor_redials_with_backoff(tmp_path):
    """Sever the node's socket server-side: the supervisor backs off once
    (the injected sleep records the jittered delay), redials and
    re-HELLOs with its cumulative stats, and serves again."""
    cfg = make_cfg(tmp_path, n_rounds=1, n_total_clients=1, n_clients_per_round=1)
    cfg.photon.membership.reconnect_backoff_base_s = 0.25
    cfg.photon.membership.reconnect_backoff_jitter = 0.25
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=1)
    delays: list[float] = []
    t = threading.Thread(target=run_node, args=(f"127.0.0.1:{driver.port}", "n0", cfg.to_json()),
                         kwargs={"sleep": delays.append, "device": "cpu"}, daemon=True)
    t.start()
    driver.wait_for_nodes(timeout=60)
    assert driver.hello_stats()["n0"]["reconnects"] == 0
    with driver._lock:
        stale = driver._nodes["n0"]
    stale.close()  # a lost connection
    _wait(lambda: driver.hello_stats().get("n0", {}).get("reconnects") == 1, 30, "the redial")
    stats = driver.hello_stats()["n0"]
    assert len(delays) == 1
    assert 0.25 * 0.75 <= delays[0] <= 0.25 * 1.25
    assert stats["backoff_s"] == pytest.approx(delays[0])
    mid = driver.send("n0", Query("ping"))
    nid, got, reply = driver.recv_any(timeout=10)
    assert (nid, got) == ("n0", mid) and reply.ok
    driver.shutdown()
    t.join(timeout=15)
    assert not t.is_alive()


def test_run_node_redials_after_agent_loop_crash(tmp_path, monkeypatch):
    """A crash that escapes the agent loop is a torn connection: one
    backoff, a redial, a re-HELLO, and the node serves a whole round."""
    cfg = make_cfg(tmp_path, n_rounds=1, n_total_clients=1, n_clients_per_round=1, local_steps=1)
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=1)
    real_serve = NodeAgent.serve
    crashes = []

    def crash_once(self, conn):
        if not crashes:
            crashes.append(1)
            raise RuntimeError("simulated crash outside per-message handling")
        return real_serve(self, conn)

    monkeypatch.setattr(NodeAgent, "serve", crash_once)
    delays: list[float] = []
    t = threading.Thread(target=run_node, args=(f"127.0.0.1:{driver.port}", "n0", cfg.to_json()),
                         kwargs={"sleep": delays.append, "device": "cpu"}, daemon=True)
    with pytest.warns(UserWarning, match="agent loop crashed"):
        t.start()
        _wait(lambda: driver.hello_stats().get("n0", {}).get("reconnects") == 1, 60, "the redial")
    assert crashes == [1] and len(delays) == 1
    app = ServerApp(cfg, driver, ParamTransport("inline"))
    try:
        history = app.run()
        assert history.latest("server/n_clients") == 1.0
        assert history.latest("server/round_failed") in (None, 0.0)
    finally:
        driver.shutdown()
    t.join(timeout=15)
    assert not t.is_alive()


def test_idle_node_keeps_its_connection(tmp_path, monkeypatch):
    """A node waits for its next message as long as the server's round
    takes: idle past its dial's timeout it stays connected (the JAX
    supervisor keeps the dial's 10 s timeout on the socket, so an idle node
    redials) and a clean shutdown ends it."""
    import photon_tpu_torch.federation.tcp as tcp_mod

    monkeypatch.setattr(tcp_mod, "_DIAL_TIMEOUT_S", 0.3)
    cfg = make_cfg(tmp_path, n_rounds=1, n_total_clients=1, n_clients_per_round=1)
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=1)
    delays: list[float] = []
    t = threading.Thread(target=run_node, args=(f"127.0.0.1:{driver.port}", "n0", cfg.to_json()),
                         kwargs={"sleep": delays.append, "device": "cpu"}, daemon=True)
    t.start()
    driver.wait_for_nodes(timeout=60)
    time.sleep(1.5)  # five dial timeouts without a message
    assert driver.hello_stats()["n0"]["reconnects"] == 0 and delays == []
    mid = driver.send("n0", Query("ping"))
    assert driver.recv_any(timeout=10)[1:] == (mid, Ack(ok=True, node_id="n0"))
    driver.shutdown()
    t.join(timeout=15)
    assert not t.is_alive()


def test_silent_server_is_redialed(tmp_path, monkeypatch):
    """A server host that vanishes without a FIN or RST (a crash, a
    partition) leaves the node's read blocked until TCP keepalive gives up
    and the read fails with ETIMEDOUT; the node then redials and serves
    the server's next registration. Keepalive cannot expire over loopback
    (the kernel answers the probes of an open socket, read or not), so the
    test reads the keepalive options off the node's socket and raises the
    kernel's verdict from the read of the registration the server stopped
    answering."""
    import errno

    import photon_tpu_torch.federation.tcp as tcp_mod

    cfg = make_cfg(tmp_path, n_rounds=1, n_total_clients=1, n_clients_per_round=1)
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=1)
    options, silent = [], threading.Event()
    real_keep_alive = tcp_mod._keep_alive

    def keep_alive(sock):
        real_keep_alive(sock)
        options.append([sock.getsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE) != 0] + [
            sock.getsockopt(socket.IPPROTO_TCP, o)
            for o in (socket.TCP_KEEPIDLE, socket.TCP_KEEPINTVL, socket.TCP_KEEPCNT)])

    class KeepaliveExpires(SocketConn):
        first = True

        def recv(self):
            # the node's first read (the server's accept loop reads too)
            if KeepaliveExpires.first and self.sock.getpeername()[1] == driver.port:
                KeepaliveExpires.first = False
                assert silent.wait(timeout=30)
                raise TimeoutError(errno.ETIMEDOUT, "Connection timed out")
            return super().recv()

    monkeypatch.setattr(tcp_mod, "_keep_alive", keep_alive)
    monkeypatch.setattr(tcp_mod, "SocketConn", KeepaliveExpires)
    delays: list[float] = []
    t = threading.Thread(target=run_node, args=(f"127.0.0.1:{driver.port}", "n0", cfg.to_json()),
                         kwargs={"sleep": delays.append, "device": "cpu"}, daemon=True)
    t.start()
    driver.wait_for_nodes(timeout=60)
    want = [True, tcp_mod._KEEPALIVE_IDLE_S, tcp_mod._KEEPALIVE_INTERVAL_S,
            tcp_mod._KEEPALIVE_PROBES]
    assert options == [want]
    silent.set()  # the server's host went quiet: no byte, no FIN, no RST
    _wait(lambda: driver.hello_stats().get("n0", {}).get("reconnects") == 1, 30, "the redial")
    assert len(delays) == 1 and options == [want, want]
    mid = driver.send("n0", Query("ping"))
    assert driver.recv_any(timeout=10)[1:] == (mid, Ack(ok=True, node_id="n0"))
    driver.shutdown()
    t.join(timeout=15)
    assert not t.is_alive()


def test_tcp_dead_node_synthesizes_failure():
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=1)
    conn = SocketConn(socket.create_connection(("127.0.0.1", driver.port), timeout=10))
    conn.send({"kind": HELLO_KIND, "node_id": "ghost"})
    driver.wait_for_nodes(timeout=10)
    mid = driver.send("ghost", Query("ping"))
    conn.close()
    t0 = time.monotonic()
    nid, got_mid, reply = driver.recv_any(timeout=10)
    assert time.monotonic() - t0 < 5.0
    assert (nid, got_mid) == ("ghost", mid)
    assert not reply.ok and "died" in reply.detail
    assert "ghost" not in driver.node_ids()
    driver.shutdown()


def test_tcp_send_to_unknown_node_synthesizes_failure():
    """A send to a node already dropped from the registry (its id still in
    the window's free list) fails that message, not the round loop."""
    driver = TcpServerDriver("127.0.0.1", 0, expected_nodes=0)
    try:
        mid = driver.send("ghost", {"kind": "fit"})
        nid, got_mid, reply = driver.recv_any(timeout=5)
        assert (nid, got_mid) == ("ghost", mid)
        assert isinstance(reply, Ack) and not reply.ok and "died" in reply.detail
    finally:
        driver.shutdown()


# ---------------------------------------------------------------------------
# server CLI + two node processes over real sockets and the objstore
# ---------------------------------------------------------------------------


def _env() -> dict:
    return {"PATH": "/usr/bin:/bin", "PYTHONPATH": ":".join(sys.path), "HOME": str(ROOT)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_nodes(cfg_path, port, log_dir, run) -> list[subprocess.Popen]:
    procs = []
    for i in range(2):
        with (log_dir / f"{run}_node{i}.log").open("w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "photon_tpu_torch.federation.tcp", "--connect",
                 f"127.0.0.1:{port}", "--node-id", f"node{i}", "--config", cfg_path,
                 "--device", "cpu"],
                cwd=ROOT, env=_env(), stdout=out, stderr=subprocess.STDOUT))
    return procs


def _run_server(cfg_path, port, extra) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "photon_tpu_torch.federated", "--config", cfg_path,
         "--tcp-listen", f"127.0.0.1:{port}", "--nodes", "2", *extra],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])


def _reap(procs) -> None:
    for p in procs:
        try:
            assert p.wait(timeout=60) == 0
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_tcp_two_process_fit_eval_checkpoint_resume(tmp_path):
    """``python -m photon_tpu_torch.federated --tcp-listen`` and two
    ``python -m photon_tpu_torch.federation.tcp --connect`` processes: 2
    rounds of fit and eval with checkpoints, then a resume to round 3 over
    fresh processes; every node exits on the server's shutdown."""
    cfg = make_cfg(tmp_path, n_total_clients=2, n_clients_per_round=2, n_rounds=2,
                   eval_interval_rounds=2)
    cfg.photon.checkpoint = True
    # the nodes load this YAML as it is: it names the bulk plane
    cfg.photon.comm_stack.objstore, cfg.photon.comm_stack.shm = True, False
    cfg.run_uuid = "tcp-e2e"
    cfg_path = str(tmp_path / "run.yaml")
    cfg.validate().to_yaml(cfg_path)

    port = _free_port()
    nodes = _spawn_nodes(cfg_path, port, tmp_path, "run1")
    try:
        out = _run_server(cfg_path, port, [])
        assert out["server/round_time"] > 0 and out["server/eval_loss"] > 0
    finally:
        _reap(nodes)
    server = pathlib.Path(cfg.photon.save_path) / "store" / "tcp-e2e" / "server"
    assert sorted(r.name for r in server.iterdir()) == ["0", "1", "2"]

    port2 = _free_port()
    nodes2 = _spawn_nodes(cfg_path, port2, tmp_path, "run2")
    try:
        out2 = _run_server(cfg_path, port2, ["--rounds", "3", "--set", "photon.resume_round=-1"])
        assert out2["server/round_time"] > 0
    finally:
        _reap(nodes2)
    assert "3" in {r.name for r in server.iterdir()}
