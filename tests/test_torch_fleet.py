"""The replica side of the port's serving fleet (``photon_tpu_torch.serve.fleet``,
``ContinuousBatcher.recycle``, ``AdapterPool.shrink``, the serve CLI's
``--fleet-connect``).

All CPU, fp32, tiny configs (d 32, 2 layers, block 4):

1. ``recycle`` quiesces, reclaims the prefix cache and the unpinned
   adapter pages, and serves again; ``shrink`` skips pinned pages, as the
   JAX pool does (``tests/test_autopilot.py``'s case, run on both);
2. the agent keeps an idle connection (blocking read, TCP keepalive),
   where the JAX agent, which keeps its dial's timeout on the socket,
   redials;
3. ``FleetSupervisor`` with two ``python -m photon_tpu_torch.serve
   --fleet-connect --device cpu`` children behind a ``FleetRouter``: the
   replica id on each first stdout line, routed streams equal to the
   contiguous decoder, a rolling hot-swap that moves one replica at a
   time (at the default ``hotswap_poll_s``: a replica polls only when the
   router asks), a SIGKILL after which the survivor serves every
   request, and a SIGTERM under traffic that fails no request;
4. the CLI's flags go together, a SIGTERM that another thread takes
   still drains the server, and a replica without its card exits non-zero
   before it joins.

Every socket and subprocess wait has its own timeout.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from photon_tpu_torch.federation.messages import Ack, Query
from photon_tpu_torch.federation.tcp import TcpServerDriver

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _wait(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} not reached in {timeout} s")
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# 1. recycle and shrink
# ---------------------------------------------------------------------------

def test_adapter_pool_shrink_skips_pinned_pages_as_jax():
    from photon_tpu.adapters.lora import AdapterSpec as JaxSpec
    from photon_tpu.serve.adapter_pool import AdapterPool as JaxPool
    from photon_tpu_torch.adapters.lora import AdapterSpec
    from photon_tpu_torch.serve.adapter_pool import AdapterPool

    entries = (("blocks/block/up_proj", (4, 2), (2, 4)),)
    bank = {c: [np.zeros((4, 2), np.float32), np.zeros((2, 4), np.float32)] for c in "ab"}
    seen = []
    for pool in (AdapterPool(AdapterSpec(2, 4.0, entries), pool_size=2),
                 JaxPool(JaxSpec(rank=2, alpha=4.0, entries=entries), pool_size=2)):
        pool.install_bank(bank)
        pa = pool.acquire("a")  # pinned by a live slot
        pool.release(pool.acquire("b"))  # resident, unpinned
        steps = [pool.shrink()]  # only b is evictable
        assert pool.has_cohort("a") and pool.can_acquire("a")
        assert "b" not in pool._pages and "a" in pool._pages
        pool.release(pa)  # the pin is still valid after the shrink
        steps += [pool.shrink(), pool.evictions, pool.shrink()]
        seen.append(steps)
    assert seen[0] == seen[1] == [1, 1, 2, 0]


def test_recycle_quiesces_reclaims_and_serves_again():
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher, DrainingError
    from tests.test_torch_adapter_serve import _bank, _cfg, _spec, _weights

    jcfg, cfg = _cfg(prefix=True)
    _, params = _weights(jcfg)
    engine = PagedEngine(cfg, params, device="cpu", adapter_bank=_bank(_spec(cfg, params)))
    batcher = ContinuousBatcher(engine).start()
    try:
        prompt = list(range(1, 14))  # 3 full blocks to cache
        first = {c: batcher.submit(prompt, 6, cohort=c).result(timeout=60) for c in ("a", None)}
        assert len(engine.prefix_cache) > 0 and engine.adapter_pool.stats()["residents"] == 1
        long = batcher.submit(prompt, cfg.photon.serve.max_new_tokens)  # in flight
        done = []
        t = threading.Thread(target=lambda: done.append(batcher.recycle(timeout_s=30)))
        t.start()
        _wait(lambda: batcher.load_report()["draining"] or done, 10, "the recycle's quiesce")
        if not done:
            with pytest.raises(DrainingError):
                batcher.submit(prompt, 2)
        t.join(timeout=30)
        assert done == [True] and len(long.result(timeout=60)) == cfg.photon.serve.max_new_tokens
        assert len(engine.prefix_cache) == 0
        assert engine.adapter_pool.stats()["residents"] == 0
        assert engine.adapter_pool.evictions >= 1
        assert batcher.load_report()["draining"] is False
        assert {c: batcher.submit(prompt, 6, cohort=c).result(timeout=60)
                for c in ("a", None)} == first
    finally:
        batcher.close()
    assert batcher.recycle(timeout_s=1) is False  # a stopped batcher


def test_idle_check_sees_a_request_mid_admission():
    """A request the scheduler has taken off the queue but not yet put in
    a slot is neither queued nor running unless the two happen in one
    step; ``recycle`` (and ``drain``) would then take the batcher for idle
    and flush under it. Here ``begin`` is held open while the check runs."""
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher
    from tests.test_torch_adapter_serve import _cfg, _weights

    jcfg, cfg = _cfg(prefix=True)
    engine = PagedEngine(cfg, _weights(jcfg)[1], device="cpu")
    inside, release = threading.Event(), threading.Event()
    begin = engine.begin

    def slow_begin(*a, **kw):
        inside.set()
        assert release.wait(timeout=30)
        return begin(*a, **kw)

    engine.begin = slow_begin
    batcher = ContinuousBatcher(engine).start()
    try:
        req = batcher.submit(list(range(1, 9)), 4)
        assert inside.wait(timeout=30)
        assert batcher._wait_idle(0.1) is False
        release.set()
        assert len(req.result(timeout=60)) == 4
        assert batcher._wait_idle(10) is True
    finally:
        release.set()
        batcher.close()


# ---------------------------------------------------------------------------
# 2. the agent's idle connection
# ---------------------------------------------------------------------------

def test_idle_replica_keeps_its_connection_parts_from_jax(monkeypatch):
    """Idle past its dial's timeout (0.3 s here), the port's agent stays
    connected and answers; the JAX agent, whose dial timeout stays on the
    socket it reads from, redials every time the router is quiet that
    long (a rolling swap is quiet for a whole replica's swap)."""
    import photon_tpu.serve.fleet as jax_fleet
    import photon_tpu_torch.federation.tcp as tcp_mod
    from photon_tpu.federation.tcp import TcpServerDriver as JaxDriver
    from photon_tpu_torch.serve.fleet import ReplicaAgent

    monkeypatch.setattr(tcp_mod, "_DIAL_TIMEOUT_S", 0.3)
    monkeypatch.setattr(jax_fleet, "socket", types.SimpleNamespace(
        create_connection=lambda addr, timeout: socket.create_connection(addr, timeout=0.3)))
    driver, jdriver = TcpServerDriver("127.0.0.1", 0, 1), JaxDriver("127.0.0.1", 0, 1)
    agent = ReplicaAgent(f"127.0.0.1:{driver.port}", "r0", batcher=None, frontend=None).start()
    jagent = jax_fleet.ReplicaAgent(f"127.0.0.1:{jdriver.port}", "r0", batcher=None,
                                    frontend=None).start()
    try:
        driver.wait_for_nodes(timeout=30)
        jdriver.wait_for_nodes(timeout=30)
        time.sleep(1.5)  # five dial timeouts without a message
        assert agent.reconnects == 0 and driver.hello_stats()["r0"]["reconnects"] == 0
        mid = driver.send("r0", Query("ping"))
        assert driver.recv_any(timeout=10)[1:] == (mid, Ack(ok=True, node_id="r0"))
        _wait(lambda: jdriver.hello_stats().get("r0", {}).get("reconnects", 0) >= 2, 10,
              "the JAX agent's redials")
        driver.shutdown()  # its shutdown query ends the agent's loop
        agent._thread.join(timeout=15)
        assert not agent._thread.is_alive() and agent.reconnects == 0
    finally:
        agent.stop()
        jagent.stop()
        driver.shutdown()
        jdriver.shutdown()


# ---------------------------------------------------------------------------
# 3. a supervised fleet of CLI replicas
# ---------------------------------------------------------------------------

def _fleet_cfg():
    from photon_tpu_torch.config.schema import Config

    cfg = Config()
    cfg.run_uuid = "fleet"
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.vocab_size, m.max_seq_len = 32, 2, 4, 96, 32
    m.attn_impl, m.compute_dtype = "xla", "float32"
    s = cfg.photon.serve
    s.enabled, s.n_slots, s.block_size, s.max_new_tokens = True, 2, 4, 8
    s.prefix_cache, s.hotswap = True, True  # at the default hotswap_poll_s
    f = s.fleet
    f.enabled, f.replicas, f.prefix_affinity_blocks = True, 2, 2
    f.report_poll_s, f.report_timeout_s = 0.1, 1.0
    return cfg.validate("cpu", serving=True)


def _save_round(mgr, cfg, rnd):
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.models.mpt import init_params

    params = init_params(cfg.model, seed=rnd)
    mgr.save_round(rnd, *params_to_ndarrays(params), server_state={"server_round": rnd})
    return params


def _offline_greedy(cfg, params, prompt, n):
    from photon_tpu_torch.models.decode import make_cached_generate_fn

    buf = torch.zeros((1, len(prompt) + n), dtype=torch.long)
    buf[0, : len(prompt)] = torch.tensor(prompt)
    toks, _ = make_cached_generate_fn(cfg.model, params).many(
        buf, torch.tensor([len(prompt)]), n)
    return [int(x) for x in toks[0, len(prompt):]]


def _healthz(router, rid):
    import http.client

    st = router.replicas[rid]
    c = http.client.HTTPConnection(st.host, st.port, timeout=10)
    try:
        c.request("GET", "/healthz")
        return json.loads(c.getresponse().read())
    finally:
        c.close()


def test_supervised_replicas_swap_in_turn_and_survive_a_sigkill(tmp_path):
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.serve.fleet import FleetSupervisor
    from photon_tpu_torch.serve.router import FleetRouter
    from tests.test_torch_router import _post_generate, _wait_dead

    cfg = _fleet_cfg()
    cfg.to_yaml(tmp_path / "resolved.yaml")
    mgr = ServerCheckpointManager(FileStore(tmp_path / "store"), cfg.run_uuid)
    params1 = _save_round(mgr, cfg, 1)
    fc = cfg.photon.serve.fleet
    router = FleetRouter(fc, block_size=cfg.photon.serve.block_size)
    port = router.start()
    sup = FleetSupervisor(str(tmp_path / "resolved.yaml"), f"127.0.0.1:{router.control_port}",
                          fc.replicas, extra_args=("--device", "cpu", "--store",
                                                   str(tmp_path / "store")), env=_env())
    try:
        router.wait_for_replicas(timeout=120)
        for rid in ("replica0", "replica1"):
            _wait(lambda: len(sup.logs[rid]) > 0, 30, f"{rid}'s first line")
            info = json.loads(sup.logs[rid][0])
            assert info["replica_id"] == rid and info["round"] == 1 and info["hotswap"]
        prompts = [[7, 1, 2, 3, 9, 9, 9, 9] + [i] for i in range(3)] + [[5, 3]]
        for p in prompts:
            status, out = _post_generate(port, {"tokens": p, "max_new_tokens": 6})
            assert status == 200 and out["tokens"] == _offline_greedy(cfg, params1, p, 6)
        # a rolling hot-swap to round 2: one replica at a time. A replica's
        # watcher polls only when the router asks (a loop of its own would
        # have polled at its start, and would swap on its own timer)
        assert [_healthz(router, r)["hotswap"]["polls"] for r in sup.alive()] == [0, 0]
        params2 = _save_round(mgr, cfg, 2)
        results = router.rolling_hotswap(timeout_s=60)
        assert [(r["replica"], r["swapped"], r["round"]) for r in results] == \
            [("replica0", True, 2), ("replica1", True, 2)]
        windows = sorted((h["last_swap_at"] - h["last_swap_s"], h["last_swap_at"])
                         for h in (_healthz(router, r)["hotswap"] for r in sup.alive()))
        assert windows[0][1] <= windows[1][0], windows
        assert [_healthz(router, r)["hotswap"]["polls"] for r in sup.alive()] == [1, 1]
        # SIGKILL one: the survivor serves every request
        sup.kill_replica("replica0")
        _wait_dead(router, "replica0")
        for p in prompts:
            status, out = _post_generate(port, {"tokens": p, "max_new_tokens": 6})
            assert status == 200 and out["tokens"] == _offline_greedy(cfg, params2, p, 6)
        st = router.fleet_status()["fleet"]
        assert st["live"] == 1 and st["dead"] == 1 and st["routed"]["proxy_errors"] == 0
        sup.close(timeout=60)
        assert sup.procs["replica0"].returncode == -9
        assert sup.procs["replica1"].returncode == 0, "\n".join(sup.logs["replica1"])
    finally:
        sup.close(timeout=30)
        router.close()


def test_sigterm_replica_under_traffic_fails_no_request(tmp_path):
    """A SIGTERMed replica leaves the fleet, then drains: requests placed on
    it before the router marks it dead get its 503 (or a refused
    connection) and are placed again, so every request answers 200 and
    the replica exits 0."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.serve.fleet import FleetSupervisor
    from photon_tpu_torch.serve.router import FleetRouter
    from tests.test_torch_router import _post_generate, _wait_dead

    cfg = _fleet_cfg()
    cfg.to_yaml(tmp_path / "resolved.yaml")
    _save_round(ServerCheckpointManager(FileStore(tmp_path / "store"), cfg.run_uuid), cfg, 1)
    fc = cfg.photon.serve.fleet
    router = FleetRouter(fc, block_size=cfg.photon.serve.block_size)
    port = router.start()
    sup = FleetSupervisor(str(tmp_path / "resolved.yaml"), f"127.0.0.1:{router.control_port}",
                          fc.replicas, extra_args=("--device", "cpu", "--store",
                                                   str(tmp_path / "store")), env=_env())
    statuses: list = []
    stop = threading.Event()

    def client(k):
        n = 0
        while not stop.is_set():
            try:  # short prompts: power-of-two choices over both replicas
                status, out = _post_generate(port, {"tokens": [1 + k, 1 + n % 90],
                                                    "max_new_tokens": 8})
                statuses.append((status, out.get("error")))
            except OSError as e:
                statuses.append((-1, repr(e)))
            n += 1

    threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(3)]
    try:
        router.wait_for_replicas(timeout=120)
        for t in threads:
            t.start()
        _wait(lambda: len(statuses) >= 30, 60, "traffic before the SIGTERM")
        sup.procs["replica1"].terminate()
        assert sup.procs["replica1"].wait(timeout=60) == 0, "\n".join(sup.logs["replica1"])
        _wait_dead(router, "replica1")
        n_after = len(statuses)
        _wait(lambda: len(statuses) >= n_after + 30, 60, "traffic after the SIGTERM")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sup.close(timeout=30)
        router.close()
    assert statuses and all(s == 200 for s, _ in statuses), \
        [x for x in statuses if x[0] != 200][:4]
    assert router.fleet_status()["fleet"]["routed"]["proxy_errors"] == 0


# ---------------------------------------------------------------------------
# 4. the CLI
# ---------------------------------------------------------------------------

def test_serve_cli_fleet_flags_go_together():
    from photon_tpu_torch.serve.__main__ import main

    for argv in (["--fleet-connect", "127.0.0.1:1"], ["--replica-id", "r0"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2


def test_sigterm_taken_by_another_thread_still_drains(tmp_path):
    """The kernel may hand a process's SIGTERM to any thread that does not
    block it. Its Python handler runs only in the main thread, and only
    when that thread executes: the serve CLI's main thread waits in a
    timed loop, so a SIGTERM taken by another thread still starts the
    drain (an untimed wait would sleep through it, as the JAX CLI's
    does). Here a helper thread sends the signal to itself."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    cfg = _fleet_cfg()
    cfg.photon.serve.fleet.enabled = False
    cfg.to_yaml(tmp_path / "resolved.yaml")
    _save_round(ServerCheckpointManager(FileStore(tmp_path / "store"), cfg.run_uuid), cfg, 1)
    script = (
        "import signal, sys, threading, time\n"
        "from photon_tpu_torch.serve.__main__ import main\n"
        "def hit():\n"
        "    while signal.getsignal(signal.SIGTERM) == signal.SIG_DFL:\n"
        "        time.sleep(0.05)\n"
        "    time.sleep(0.5)\n"
        "    signal.pthread_kill(threading.get_ident(), signal.SIGTERM)\n"
        "threading.Thread(target=hit, daemon=True).start()\n"
        "main(sys.argv[1:])\n")
    proc = subprocess.run(
        [sys.executable, "-c", script, "--config", str(tmp_path / "resolved.yaml"), "--store",
         str(tmp_path / "store"), "--enable", "--port", "0", "--device", "cpu"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[0])["round"] == 1


def test_replica_without_its_card_exits_before_joining(tmp_path):
    """Without ``--device cpu`` a replica asks for the card; on a host
    without one it exits non-zero and never says HELLO."""
    cfg = _fleet_cfg()
    cfg.to_yaml(tmp_path / "resolved.yaml")
    driver = TcpServerDriver("127.0.0.1", 0, 1)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "photon_tpu_torch.serve", "--config",
             str(tmp_path / "resolved.yaml"), "--store", str(tmp_path / "store"),
             "--fleet-connect", f"127.0.0.1:{driver.port}", "--replica-id", "r0"],
            cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "CUDA" in proc.stderr, proc.stderr[-2000:]
        assert proc.stdout == "" and driver.node_ids() == []
    finally:
        driver.shutdown()


# ---------------------------------------------------------------------------
# 5. the card phase's gates, rehearsed at a small size
# ---------------------------------------------------------------------------

def test_chip_smoke_fleet_phase_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.fleet_phase`` (phase 13) with ``--device cpu`` children
    on a tiny adapter run: its gates (a), (c), (d) and (e) hold, so a
    fault in the phase's own logic shows here before it costs a card
    run. The card-only gate (b) counts kernel launches and is skipped by
    the phase itself off the card."""
    from photon_tpu_torch.adapters.checkpoint import adapter_key
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.ops import ragged_paged_attention as rpa
    from tests.test_torch_adapter_serve import _nonzero_adapter, _spec
    from tests.test_torch_compression import _chip_smoke

    smoke = _chip_smoke()
    for name, value in [("FLEET_NEW", 8), ("FLEET_COHORT_PROMPT", (4, 12)),
                        ("FLEET_KILL_AFTER_S", 0.5), ("FLEET_KILL_STREAM_AGE_S", 0.0)]:
        monkeypatch.setattr(smoke, name, value)
    cfg = Config()
    cfg.run_uuid = "fleet-smoke"
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.vocab_size, m.max_seq_len = 32, 2, 4, 96, 64
    m.attn_impl, m.compute_dtype = "xla", "float32"
    ad = cfg.photon.adapters
    ad.enabled, ad.rank, ad.pool_size, ad.cohorts = True, 4, 2, {"a": [], "b": [], "c": []}
    s = cfg.photon.serve
    s.block_size, s.max_new_tokens = 4, 8
    # a loaded host may answer a poll late: the death bound is 2 × (poll + timeout)
    s.fleet.report_poll_s, s.fleet.report_timeout_s = 0.1, 3.0
    cfg.validate("cpu", serving=True)
    cfg.to_yaml(tmp_path / "resolved.yaml")
    base = init_params(m, seed=3)
    spec = _spec(cfg, base)
    mgr = ServerCheckpointManager(FileStore(tmp_path / "store"), cfg.run_uuid)
    for rnd in (1, 2):
        mgr.save_round(rnd, *params_to_ndarrays(base), strategy_state={
            adapter_key(c): _nonzero_adapter(spec, 10 * rnd + i) for i, c in enumerate("abc")},
            server_state={"server_round": rnd})
    rec = smoke.fleet_phase(torch, rpa, np, {"store": str(tmp_path / "store"),
                                             "run": cfg.run_uuid,
                                             "config": str(tmp_path / "resolved.yaml")},
                            tie=1e-5, device="cpu")
    assert rec["traffic"]["routed"]["cohort"] == 16 and rec["traffic"]["routed"]["prefix"] >= 16
    assert rec["random_pass"]["scattered_templates"] and not rec["affinity_pass"][
        "scattered_templates"]
    assert rec["affinity_pass"]["hit_rate"] > rec["random_pass"]["hit_rate"]
    assert rec["kill"]["lost"] <= rec["kill"]["inflight_on_victim"]
    assert rec["kill"]["new_pin"] != rec["kill"]["victim"]
    assert rec["rolling_swap"]["dropped"] == 0 and len(rec["rolling_swap"]["windows"]) == 2
    assert not (tmp_path / "fleet").exists()
