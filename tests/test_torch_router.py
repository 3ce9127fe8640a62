"""The port's fleet router (``photon_tpu_torch.serve.router`` and
``serve.fleet``) against the JAX package's.

All CPU, fp32, the JAX test's sizes (d 32, 2 layers, 3 replicas, block 4),
weights from the JAX ``init_params`` carried across as numpy:

1. against the JAX package: ``rendezvous_pick``, ``prefix_key`` and
   ``route`` give JAX's picks and bytes over a seeded set of prompts,
   cohorts and live sets, the p2c and random streams included; the
   ``serve.fleet`` checks raise JAX's texts; routed greedy streams equal
   JAX's contiguous decoder, and a single port engine's bit for bit;
2. one port case for each case of ``tests/test_router.py``, apart from
   ``test_registry_covers_router_names``, the ``/metrics`` half of
   ``test_fleet_status_and_metrics_planes`` (both wait for the telemetry
   port) and ``test_chaos_replica_kill_mid_traffic`` (the chaos port).

Every socket wait has its own timeout, so a hang fails its test.
"""

import http.client
import json
import random
import threading
import time

import numpy as np
import pytest

from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu_torch.serve.router import (
    AffinityRouter,
    NoReplicasError,
    ReplicaState,
    rendezvous_pick,
)


def _jax_fleet_cfg(*, replicas=3, n_slots=2, block_size=4, max_seq=32, max_new=8,
                   prefix_blocks=2) -> JaxConfig:
    cfg = JaxConfig()
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.vocab_size = 32, 2, 4, 96
    m.attn_impl, m.compute_dtype, m.max_seq_len = "xla", "float32", max_seq
    s = cfg.photon.serve
    s.n_slots, s.block_size, s.max_new_tokens = n_slots, block_size, max_new
    f = s.fleet
    f.enabled, f.replicas, f.prefix_affinity_blocks = True, replicas, prefix_blocks
    f.report_poll_s, f.report_timeout_s = 0.1, 1.0
    return cfg.validate()


def _fleet_cfg(**kw):
    from photon_tpu_torch.config.schema import Config

    return Config.from_dict(_jax_fleet_cfg(**kw).to_dict()).validate("cpu")


def _weights(jcfg):
    """(JAX params, port params) holding the same numbers."""
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.codec.params import params_from_numpy

    jp = init_params(jcfg.model, seed=4)
    meta, arrays = params_to_ndarrays(jp)
    return jp, params_from_numpy(meta.names, arrays, _fleet_cfg().model, "cpu")


def _post_generate(port, payload, timeout=60):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", "/generate", body=json.dumps(payload).encode(),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def _get(host, port, path, timeout=10):
    c = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        c.request("GET", path)
        return json.loads(c.getresponse().read())
    finally:
        c.close()


def _jax_offline_greedy(jcfg, params, prompt, n):
    """JAX's oracle: its contiguous cached decoder, one row."""
    import jax.numpy as jnp

    from photon_tpu.models.decode import make_cached_generate_fn

    buf = np.zeros((1, len(prompt) + n), np.int32)
    buf[0, : len(prompt)] = prompt
    fn = make_cached_generate_fn(jcfg.model, params)
    t, _ = fn.many(jnp.asarray(buf), jnp.asarray([len(prompt)], np.int32), n)
    return [int(x) for x in np.asarray(t)[0, len(prompt):]]


def _wait_dead(router, rid, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        h = router.tracker.nodes.get(rid)
        if rid not in router.live_replicas() and h is not None and h.state == "dead":
            return
        time.sleep(0.05)
    raise AssertionError(f"{rid} never went dead on the router")


# ---------------------------------------------------------------------------
# 1. placement against the JAX package
# ---------------------------------------------------------------------------

def _seeded_traffic(seed, n=200):
    """(prompt, cohort, live set) triples: prompts of 0-20 tokens (some
    sharing prefixes), cohorts or none, live sets of 1-5 replicas."""
    rng = np.random.default_rng(seed)
    shared = [list(map(int, rng.integers(0, 96, 12))) for _ in range(4)]
    ids = [f"replica{i}" for i in range(5)]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        if k == 0:
            prompt = None
        elif k == 1:
            prompt = shared[int(rng.integers(0, 4))][: int(rng.integers(4, 13))] + \
                list(map(int, rng.integers(0, 96, int(rng.integers(0, 6)))))
        else:
            prompt = list(map(int, rng.integers(0, 96, int(rng.integers(0, 21)))))
        cohort = [None, "", "a", "b", "tenant-c"][int(rng.integers(0, 5))]
        live = sorted(rng.choice(ids, int(rng.integers(1, 6)), replace=False).tolist())
        out.append((prompt, cohort, live))
    return out


def test_rendezvous_and_prefix_key_bytes_match_jax():
    from photon_tpu.serve.router import AffinityRouter as JaxRouter
    from photon_tpu.serve.router import rendezvous_pick as jax_pick

    for prompt, cohort, live in _seeded_traffic(0):
        key = (cohort or "k").encode() + bytes(prompt or [])
        assert rendezvous_pick(key, live) == jax_pick(key, live)
    for bs, blocks in [(4, 2), (4, 4), (16, 4), (3, 0), (5, 1)]:
        ours = AffinityRouter(block_size=bs, prefix_affinity_blocks=blocks)
        ref = JaxRouter(block_size=bs, prefix_affinity_blocks=blocks)
        for prompt, _, _ in _seeded_traffic(1):
            assert ours.prefix_key(prompt) == ref.prefix_key(prompt), (bs, blocks, prompt)


@pytest.mark.parametrize("mode,cohort_affinity", [("affinity", True), ("affinity", False),
                                                  ("random", True)])
def test_route_stream_matches_jax(mode, cohort_affinity):
    """The same calls give JAX's (replica, reason) pairs and pins, the
    seeded p2c and random draws included, with loads and deaths between."""
    from photon_tpu.serve.router import AffinityRouter as JaxRouter
    from photon_tpu.serve.router import ReplicaState as JaxState

    ours = AffinityRouter(block_size=4, prefix_affinity_blocks=2, mode=mode,
                          cohort_affinity=cohort_affinity)
    ref = JaxRouter(block_size=4, prefix_affinity_blocks=2, mode=mode,
                    cohort_affinity=cohort_affinity)
    rng = np.random.default_rng(2)
    for i, (prompt, cohort, live) in enumerate(_seeded_traffic(3, n=300)):
        depth = {rid: (int(rng.integers(0, 4)), float(rng.integers(0, 5)) / 4) for rid in live}
        got = ours.route(prompt, cohort, live, {r: ReplicaState(r, queue_depth=q,
                                                                live_slot_frac=f)
                                                for r, (q, f) in depth.items()})
        want = ref.route(prompt, cohort, live, {r: JaxState(r, queue_depth=q, live_slot_frac=f)
                                                for r, (q, f) in depth.items()})
        assert got == want, (i, prompt, cohort, live)
        if i % 37 == 36:  # a death between placements
            dead = live[0]
            survivors = [r for r in live if r != dead]
            assert ours.repin_dead(dead, survivors) == ref.repin_dead(dead, survivors)
        assert ours.pins == ref.pins


def test_fleet_config_texts_match_jax():
    from photon_tpu_torch.config.schema import Config

    for attr, bad in [("replicas", 0), ("port", 70000), ("control_port", -1),
                      ("prefix_affinity_blocks", -1), ("report_poll_s", 0.0),
                      ("report_timeout_s", -1.0), ("route_retries", -1)]:
        d = JaxConfig().to_dict()
        d["photon"]["serve"]["fleet"][attr] = bad
        with pytest.raises(ValueError) as jax_err:
            JaxConfig.from_dict(d).validate()
        with pytest.raises(ValueError) as port_err:
            Config.from_dict(d).validate("cpu")
        assert str(port_err.value) == str(jax_err.value)
    assert Config().photon.serve.fleet.__dict__ == JaxConfig().photon.serve.fleet.__dict__


# ---------------------------------------------------------------------------
# 2. the placement policy alone (tests/test_router.py, layer 1)
# ---------------------------------------------------------------------------

def test_rendezvous_stable_and_minimal_churn():
    live = [f"r{i}" for i in range(5)]
    keys = [f"key{i}".encode() for i in range(64)]
    before = {k: rendezvous_pick(k, live) for k in keys}
    assert before == {k: rendezvous_pick(k, live) for k in keys}
    shrunk = [r for r in live if r != "r2"]
    for k, old in before.items():
        new = rendezvous_pick(k, shrunk)
        if old != "r2":
            assert new == old, "churn moved a key off a surviving replica"
        else:
            assert new in shrunk
    with pytest.raises(NoReplicasError):
        rendezvous_pick(b"x", [])


def test_p2c_prefers_lower_queue_depth():
    r = AffinityRouter(block_size=4, prefix_affinity_blocks=0)
    loads = {"a": ReplicaState("a", queue_depth=7, live_slot_frac=1.0),
             "b": ReplicaState("b", queue_depth=0, live_slot_frac=0.0)}
    for _ in range(16):
        assert r.route([1, 2], None, ["a", "b"], loads) == ("b", "p2c")


def test_cohort_pin_sticks_and_repins_on_death():
    r = AffinityRouter(block_size=4)
    live = ["r0", "r1", "r2"]
    first, reason = r.route([1] * 16, "tenant-a", live, {})
    assert reason == "cohort"
    for _ in range(8):
        assert r.route([9] * 16, "tenant-a", live, {})[0] == first
    survivors = [x for x in live if x != first]
    moved = r.repin_dead(first, survivors)
    assert moved and moved[0][0] == "tenant-a" and moved[0][1] in survivors
    assert r.route([1] * 16, "tenant-a", survivors, {})[0] == moved[0][1]
    # the empty string is no cohort
    assert r.route([1, 2], "", live, {"r0": ReplicaState("r0")})[1] == "p2c"
    assert r.repin_dead(moved[0][1], []) == [] and not r.pins


def test_prefix_key_follows_chain_property():
    r = AffinityRouter(block_size=4, prefix_affinity_blocks=2)
    assert r.prefix_key(None) is None
    assert r.prefix_key([1, 2, 3]) is None
    base = [7, 1, 2, 3, 9, 9, 9, 9]
    k1 = r.prefix_key(base + [5, 5, 5])
    assert k1 is not None and k1 == r.prefix_key(base + [6, 6, 6, 6, 6])
    assert r.prefix_key([8] + base[1:]) != k1
    live = ["r0", "r1", "r2", "r3"]
    assert len({r.route(base + [i], None, live, {})[0] for i in range(8)}) == 1
    assert r.route(base, None, live, {})[1] == "prefix"


def test_random_mode_bypasses_affinity():
    r = AffinityRouter(block_size=4, mode="random", rng=random.Random(0))
    live = ["r0", "r1", "r2", "r3"]
    assert len({r.route([1] * 16, "tenant-a", live, {})[0] for _ in range(64)}) > 1
    assert r.route([1] * 16, "tenant-a", live, {})[1] == "random"
    assert not r.pins


# ---------------------------------------------------------------------------
# 3. one fleet (layers 2-3 of tests/test_router.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_fleet():
    """One 3-replica in-process fleet on the CPU, shared by the cases below."""
    from photon_tpu_torch.serve.fleet import InProcessFleet

    jcfg = _jax_fleet_cfg()
    cfg = _fleet_cfg()
    jp, params = _weights(jcfg)
    fleet = InProcessFleet(cfg, params, device="cpu")
    port = fleet.start(timeout=60)
    yield jcfg, jp, cfg, params, fleet, port
    fleet.close()


def test_load_report_is_cheap_and_truthful(served_fleet):
    *_, fleet, _ = served_fleet
    rep = fleet.replicas["replica0"]["batcher"].load_report()
    assert set(rep) == {"queue_depth", "live_slot_frac", "draining"}
    assert rep["queue_depth"] == 0 and 0.0 <= rep["live_slot_frac"] <= 1.0
    assert rep["draining"] is False


def test_replica_healthz_serves_load(served_fleet):
    *_, fleet, _ = served_fleet
    fe = fleet.replicas["replica0"]["frontend"]
    body = _get(fe.host, fe.port, "/healthz")
    assert body["load"]["queue_depth"] == 0 and body["load"]["draining"] is False


def test_routed_greedy_bitexact_vs_single_engine(served_fleet):
    """Routed streams equal JAX's contiguous decoder, and a single port
    engine's (one batcher on the same weights) bit for bit."""
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    jcfg, jp, cfg, params, fleet, port = served_fleet
    rng = np.random.default_rng(7)
    shared = list(map(int, rng.integers(1, 96, 8)))  # 2 full routed blocks
    prompts = [shared + list(map(int, rng.integers(1, 96, rng.integers(2, 6))))
               for _ in range(5)]
    prompts.append(list(map(int, rng.integers(1, 96, 3))))  # the p2c path
    before = fleet.router.fleet_status()["fleet"]["routed"]
    routed = []
    for p in prompts:
        status, out = _post_generate(port, {"tokens": p, "max_new_tokens": 6})
        assert status == 200
        routed.append(out["tokens"])
    assert routed == [_jax_offline_greedy(jcfg, jp, p, 6) for p in prompts]
    batcher = ContinuousBatcher(PagedEngine(cfg, params, device="cpu"))
    reqs = [batcher.submit(p, 6) for p in prompts]
    batcher.start()
    try:
        assert routed == [r.result(timeout=60) for r in reqs]
    finally:
        batcher.close()
    after = fleet.router.fleet_status()["fleet"]["routed"]
    assert after["requests"] - before["requests"] == len(prompts)
    assert after["prefix"] - before["prefix"] == 5 and after["p2c"] - before["p2c"] == 1


def test_fleet_status_planes(served_fleet):
    """``/healthz`` and ``/statusz`` (as the JAX router serves it with
    telemetry off); the History holds the router's KPIs."""
    from photon_tpu_torch.utils.profiling import ROUTER_REPLICAS_LIVE, SERVE_FLEET_REPLICAS

    *_, fleet, port = served_fleet
    body = _get("127.0.0.1", port, "/healthz")
    assert body["status"] == "ok"
    assert body["fleet"]["live"] == 3 and body["fleet"]["dead"] == 0
    assert set(body["fleet"]["replicas"]) == {"replica0", "replica1", "replica2"}
    status = _get("127.0.0.1", port, "/statusz")
    assert status["telemetry"] == "off" and status["fleet"]["live"] == 3
    assert fleet.router.history.latest(ROUTER_REPLICAS_LIVE) == 3.0
    assert fleet.router.history.latest(SERVE_FLEET_REPLICAS) == 3.0


def test_rolling_hotswap_one_replica_at_a_time(served_fleet):
    *_, fleet, _ = served_fleet
    windows = {}
    lock = threading.Lock()

    class _FakeWatcher:
        def __init__(self, rid):
            self.rid = rid

        def poll_once(self):
            t0 = time.monotonic()
            time.sleep(0.05)
            with lock:
                windows[self.rid] = (t0, time.monotonic())
            return "swapped"

    for rid, rep in fleet.replicas.items():
        rep["agent"].watcher = _FakeWatcher(rid)
    try:
        results = fleet.router.rolling_hotswap(timeout_s=10)
    finally:
        for rep in fleet.replicas.values():
            rep["agent"].watcher = None
    assert len(results) == 3 and all(r["ok"] and r["swapped"] for r in results)
    spans = sorted(windows.values())
    for (_, end_a), (start_b, _) in zip(spans, spans[1:]):
        assert end_a <= start_b, "two replicas were mid-swap at once"
    assert fleet.router.rolling_swaps == 1


# ---------------------------------------------------------------------------
# 4. failover
# ---------------------------------------------------------------------------

def test_replica_death_zero_drops_on_survivors():
    """An emulated SIGKILL: the fleet degrades to 2/3, every later request
    completes, the victim's cohort pin moves to a survivor, and the
    router's History counts it."""
    from photon_tpu_torch.serve.fleet import InProcessFleet
    from photon_tpu_torch.utils.profiling import ROUTER_COHORT_REPINS, ROUTER_REPLICAS_DEAD

    cfg = _fleet_cfg()
    _, params = _weights(_jax_fleet_cfg())
    fleet = InProcessFleet(cfg, params, device="cpu")
    try:
        port = fleet.start(timeout=60)
        victim = "replica1"
        fleet.router.policy.pins["tenant-a"] = victim
        fleet.kill_replica(victim)
        _wait_dead(fleet.router, victim)
        for i in range(6):
            status, out = _post_generate(port, {"tokens": [1 + i, 2, 3, 4, 5],
                                                "max_new_tokens": 4})
            assert status == 200, f"request {i} dropped after the replica died"
            assert len(out["tokens"]) == 4
        st = fleet.router.fleet_status()["fleet"]
        assert st["dead"] == 1 and st["live"] == 2
        assert st["pins"]["tenant-a"] in ("replica0", "replica2")
        assert st["routed"]["cohort_repins"] == 1 and st["routed"]["proxy_errors"] == 0
        deadline = time.monotonic() + 10
        while fleet.router.history.latest(ROUTER_REPLICAS_DEAD) != 1.0:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert fleet.router.history.latest(ROUTER_COHORT_REPINS) == 1.0
        # drain_fleet: the router refuses new work, the survivors drain
        fleet.router.drain_fleet()
        status, out = _post_generate(port, {"tokens": [1, 2, 3], "max_new_tokens": 4})
        assert status == 503 and out["error"] == "fleet draining"
        assert _get("127.0.0.1", port, "/healthz")["status"] == "draining"
        for rid in ("replica0", "replica2"):
            assert fleet.replicas[rid]["frontend"].draining
    finally:
        fleet.close()


def test_proxy_reroutes_a_refused_connection():
    """A request placed on a replica whose port refuses (dead, but not
    yet marked so) is placed again on a survivor and answers 200."""
    from photon_tpu_torch.serve.fleet import InProcessFleet

    cfg = _fleet_cfg()
    cfg.photon.serve.fleet.report_poll_s = 30.0  # no poll marks the victim dead
    _, params = _weights(_jax_fleet_cfg())
    fleet = InProcessFleet(cfg, params, device="cpu")
    try:
        port = fleet.start(timeout=60)
        live = fleet.router.live_replicas()
        prompt = next([i, 2, 3, 4, 5, 6, 7, 8, 9] for i in range(96)
                      if fleet.router.policy.route([i, 2, 3, 4, 5, 6, 7, 8, 9], None, live,
                                                   {})[0] == "replica1")
        fleet.replicas["replica1"]["frontend"].close()  # its port now refuses
        status, out = _post_generate(port, {"tokens": prompt, "max_new_tokens": 4})
        assert status == 200 and len(out["tokens"]) == 4
        routed = fleet.router.fleet_status()["fleet"]["routed"]
        assert routed["reroutes"] == 1 and routed["proxy_errors"] == 0
    finally:
        fleet.close()


def test_proxy_reroutes_a_draining_replica():
    """A replica that left the fleet on SIGTERM (its agent gone, its
    frontend draining, not yet marked dead) refuses with 503 before it
    generates anything: the request is placed again on a survivor and
    answers 200, and the draining replica takes no further placement.
    The JAX router passes the 503 to the client."""
    from photon_tpu_torch.serve.fleet import InProcessFleet

    cfg = _fleet_cfg()
    cfg.photon.serve.fleet.report_poll_s = 30.0  # no poll marks the victim dead
    _, params = _weights(_jax_fleet_cfg())
    fleet = InProcessFleet(cfg, params, device="cpu")
    try:
        port = fleet.start(timeout=60)
        live = fleet.router.live_replicas()
        prompts = [[i, 2, 3, 4, 5, 6, 7, 8, 9] for i in range(96)
                   if fleet.router.policy.route([i, 2, 3, 4, 5, 6, 7, 8, 9], None, live,
                                                {})[0] == "replica1"][:2]
        victim = fleet.replicas["replica1"]
        victim["agent"].stop()  # the serve CLI's SIGTERM order
        victim["frontend"].mark_draining()
        for p in prompts:
            status, out = _post_generate(port, {"tokens": p, "max_new_tokens": 4})
            assert status == 200 and len(out["tokens"]) == 4
        routed = fleet.router.fleet_status()["fleet"]["routed"]
        assert routed["reroutes"] == 1 and routed["proxy_errors"] == 0
        assert "replica1" not in fleet.router.live_replicas()
        assert victim["batcher"].stats()["completed"] == 0
    finally:
        fleet.close()
