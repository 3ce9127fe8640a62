"""The port's elastic membership (``photon_tpu_torch.federation.membership``)
and the sliding window's failure paths (``ServerApp._sliding_window``).

One case for each ``ReconnectPolicy`` and readmission case of
``tests/test_membership.py`` and each sliding-window case of
``tests/test_round_loop_bugs.py`` (a dead node dropped and its cid retried
elsewhere, every node dead within or over the budget, timeouts counted
against the budget, a stale reply's payload freed), run against the port
with the JAX suite's scripted drivers where they fit; plus the backoff
schedule and the readmission counts against the JAX package's on the same
inputs.
"""

import types
from collections import deque

import pytest

from photon_tpu.federation.membership import ReconnectPolicy as JaxPolicy
from photon_tpu_torch.federation import ParamTransport, ServerApp, TooManyFailuresError
from photon_tpu_torch.federation.driver import Driver
from photon_tpu_torch.federation.membership import (
    DEAD,
    LIVE,
    SUSPECT,
    LivenessTracker,
    ReconnectPolicy,
    iter_new_nodes,
)
from photon_tpu_torch.federation.messages import Ack, Query
from tests.test_torch_tcp import make_cfg
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


class _FixedRng:
    """An rng whose ``.random()`` replays a fixed sequence."""

    def __init__(self, vals):
        self.vals, self.i = list(vals), 0

    def random(self):
        v = self.vals[self.i % len(self.vals)]
        self.i += 1
        return v


# ---------------------------------------------------------------------------
# ReconnectPolicy
# ---------------------------------------------------------------------------


def test_backoff_exponential_and_capped():
    p = ReconnectPolicy(base_s=0.5, max_s=8.0, jitter=0.0)
    assert [p.delay(k) for k in range(6)] == [0.5, 1.0, 2.0, 4.0, 8.0, 8.0]


def test_backoff_jitter_bounds_and_determinism():
    lo = ReconnectPolicy(base_s=1.0, max_s=64.0, jitter=0.25, rng=_FixedRng([0.0]))
    hi = ReconnectPolicy(base_s=1.0, max_s=64.0, jitter=0.25, rng=_FixedRng([1.0 - 1e-12]))
    for k in range(5):
        raw = min(64.0, 2.0**k)
        assert lo.delay(k) == pytest.approx(raw * 0.75)
        assert hi.delay(k) == pytest.approx(raw * 1.25, rel=1e-6)
    seq = [0.3, 0.9, 0.1]
    a = ReconnectPolicy(base_s=1.0, max_s=64.0, jitter=0.25, rng=_FixedRng(seq))
    b = JaxPolicy(base_s=1.0, max_s=64.0, jitter=0.25, rng=_FixedRng(seq))
    assert [a.delay(k) for k in range(6)] == [b.delay(k) for k in range(6)]  # JAX's schedule


def test_backoff_huge_attempt_never_overflows():
    p = ReconnectPolicy(base_s=0.5, max_s=30.0, jitter=0.0, max_attempts=0)
    assert p.delay(5000) == 30.0


def test_backoff_exhaustion():
    p = ReconnectPolicy(max_attempts=3)
    assert not p.exhausted(2)
    assert p.exhausted(3)
    assert not ReconnectPolicy(max_attempts=0).exhausted(10_000)


def test_backoff_from_config(tmp_path):
    cfg = make_cfg(tmp_path)
    mem = cfg.photon.membership
    mem.reconnect_backoff_base_s, mem.reconnect_backoff_max_s = 0.1, 1.0
    mem.reconnect_backoff_jitter, mem.reconnect_max_attempts = 0.0, 7
    p = ReconnectPolicy.from_config(mem)
    assert (p.base_s, p.max_s, p.jitter, p.max_attempts) == (0.1, 1.0, 0.0, 7)


def test_membership_config_validation(tmp_path):
    cfg = make_cfg(tmp_path)
    cfg.photon.membership.dead_after_misses = 0
    with pytest.raises(ValueError, match="suspect_after_misses"):
        cfg.validate()
    cfg = make_cfg(tmp_path)
    cfg.photon.membership.reconnect_backoff_jitter = 1.5
    with pytest.raises(ValueError, match="jitter"):
        cfg.validate()


# ---------------------------------------------------------------------------
# readmission
# ---------------------------------------------------------------------------


def test_liveness_state_machine():
    t = LivenessTracker(suspect_after_misses=1, dead_after_misses=3)
    t.register_present(["n0"])
    assert t.nodes["n0"].state == LIVE
    t.observe_miss("n0")
    assert t.nodes["n0"].state == SUSPECT
    t.observe_miss("n0")
    assert t.nodes["n0"].state == SUSPECT
    t.observe_miss("n0")
    assert t.nodes["n0"].state == DEAD
    t.observe_alive("n0")
    assert t.nodes["n0"].state == LIVE and t.nodes["n0"].misses == 0
    assert t.readmitted_total == 1


def test_register_present_readmits_dead_id_after_absence():
    t = LivenessTracker(suspect_after_misses=1, dead_after_misses=2)
    t.register_present(["n0"])
    t.observe_miss("n0")
    t.observe_miss("n0")
    assert t.counts()[DEAD] == 1
    assert t.register_present([]) == []  # the id leaves the registry...
    assert t.register_present(["n0"]) == ["n0"]  # ...and comes back
    assert t.counts() == {LIVE: 1, SUSPECT: 0, DEAD: 0}
    m = t.round_metrics(hello_backoff_s=2.5)
    assert m["server/nodes_live"] == 1.0
    assert m["server/nodes_readmitted"] == 1.0
    assert m["server/reconnect_backoff_s"] == 2.5
    assert t.round_metrics()["server/nodes_readmitted"] == 0.0


class _ScriptedDriver:
    """Driver double with scripted ping behaviour per node (``ok`` or
    ``silent``), no sockets."""

    def __init__(self, behaviors):
        self.behaviors = dict(behaviors)
        self._pending, self._mid = deque(), 0

    def node_ids(self):
        return sorted(self.behaviors)

    def send(self, nid, msg):
        self._mid += 1
        if self.behaviors[nid] == "ok":
            self._pending.append((nid, self._mid, Ack(ok=True, node_id=nid)))
        return self._mid

    def recv_any(self, timeout=None):
        if not self._pending:
            raise TimeoutError
        return self._pending.popleft()


def test_wedged_but_connected_node_stays_dead():
    """A node whose socket stays open but never answers goes dead and stays
    dead; answering a ping readmits it."""
    t = LivenessTracker(suspect_after_misses=1, dead_after_misses=2, ping_timeout_s=0.05)
    d = _ScriptedDriver({"n0": "silent"})
    t.sweep(d)
    t.sweep(d)
    assert t.nodes["n0"].state == DEAD
    for _ in range(3):
        assert t.register_present(d.node_ids()) == []
        assert t.sweep(d) == []
        assert t.nodes["n0"].state == DEAD
    assert t.readmitted_total == 0
    d.behaviors["n0"] = "ok"
    assert t.sweep(d) == ["n0"]
    assert t.nodes["n0"].state == LIVE and t.readmitted_total == 1


def test_note_readmitted_always_counts():
    t = LivenessTracker()
    t.register_present(["n0"])
    t.note_readmitted("n0")
    assert t.readmitted_total == 1
    assert t.round_metrics()["server/nodes_readmitted"] == 1.0
    t.touch("n1")  # a new node mid-round is scale-up, not a readmission
    assert t.readmitted_total == 1 and t.nodes["n1"].state == LIVE
    assert iter_new_nodes(["n0", "n1", "n2"], ["n1"]) == ["n0", "n2"]


def test_readmission_counts_match_jax():
    """The same sequence of registry changes, misses, pings and mid-round
    rejoins through both packages' trackers: the same states, totals and
    per-round counts."""
    from photon_tpu.federation.membership import LivenessTracker as JaxTracker

    def drive(tracker):
        out = []
        tracker.register_present(["n0", "n1"])
        for _ in range(2):
            tracker.observe_miss("n1")
        out.append(tracker.register_present(["n0"]))
        out.append(tracker.register_present(["n0", "n1"]))
        tracker.note_readmitted("n0")
        tracker.touch("n2")
        out.append(tracker.round_metrics())
        tracker.observe_miss("n2")
        tracker.observe_miss("n2")
        tracker.observe_alive("n2")
        out.append(tracker.round_metrics())
        out.append({n: (h.state, h.misses, h.readmissions) for n, h in tracker.nodes.items()})
        out.append(tracker.readmitted_total)
        return out

    assert drive(LivenessTracker()) == drive(JaxTracker())


# ---------------------------------------------------------------------------
# the sliding window's failure paths
# ---------------------------------------------------------------------------


class ScriptedDriver(Driver):
    """``behavior[nid]``: ``ok`` answers each fit, ``die`` fails it as a
    dead node and leaves the registry."""

    def __init__(self, nodes):
        self.behavior = dict(nodes)
        self.alive = set(nodes)
        self.sends = []
        self._replies = deque()
        self._mid = iter(range(10**6))

    def node_ids(self):
        return sorted(self.alive)

    def send(self, node_id, msg):
        mid = next(self._mid)
        self.sends.append((node_id, msg))
        if node_id not in self.alive or self.behavior[node_id] == "die":
            self.alive.discard(node_id)
            self._replies.append((node_id, mid, Ack(ok=False, detail="node died",
                                                    node_id=node_id)))
        else:
            cid = msg[1][0] if isinstance(msg, tuple) else -1
            self._replies.append((node_id, mid, types.SimpleNamespace(error=None, cid=cid)))
        return mid

    def recv_any(self, timeout=None):
        if not self._replies:
            raise TimeoutError("scripted: nothing pending")
        return self._replies.popleft()

    def broadcast(self, msg, timeout=300.0, on_stale=None):
        return {nid: Ack(ok=True) for nid in self.alive}

    def shutdown(self):
        pass


class StalledDriver(ScriptedDriver):
    """Takes sends, never replies: every recv_any times out."""

    def send(self, node_id, msg):
        self.sends.append((node_id, msg))
        return next(self._mid)

    def recv_any(self, timeout=None):
        raise TimeoutError("stalled")


def _window_app(tmp_path, driver, **fl_kw):
    return ServerApp(make_cfg(tmp_path, **fl_kw), driver, ParamTransport("inline"))


def make_ins(cids):
    return ("fit", cids)


def test_sliding_window_drops_dead_node_and_retries_elsewhere(tmp_path):
    driver = ScriptedDriver({"n0": "ok", "n1": "die"})
    app = _window_app(tmp_path, driver, accept_failures_cnt=0)
    got = list(app._sliding_window(1, [0, 1], make_ins, timeout=5.0))
    assert sorted(r.cid for r in got) == [0, 1]
    assert sum(1 for nid, _ in driver.sends if nid == "n1") == 1  # dropped after it died


def test_sliding_window_all_nodes_dead_respects_budget(tmp_path):
    app = _window_app(tmp_path, ScriptedDriver({"n0": "die"}), accept_failures_cnt=0)
    with pytest.raises(TooManyFailuresError):
        list(app._sliding_window(1, [0, 1, 2], make_ins, timeout=5.0))
    app2 = _window_app(tmp_path, ScriptedDriver({"n0": "die"}), accept_failures_cnt=8)
    assert list(app2._sliding_window(1, [0, 1, 2], make_ins, timeout=5.0)) == []


def test_sliding_window_timeout_counts_against_budget(tmp_path):
    app = _window_app(tmp_path, StalledDriver({"n0": "ok"}), accept_failures_cnt=0)
    with pytest.raises(TooManyFailuresError) as ei:
        list(app._sliding_window(1, [0, 1], make_ins, timeout=0.01))
    assert "timeout" in str(ei.value) or "no live nodes" in str(ei.value)
    app2 = _window_app(tmp_path, StalledDriver({"n0": "ok"}), accept_failures_cnt=8)
    assert list(app2._sliding_window(1, [0, 1], make_ins, timeout=0.01)) == []


def test_stale_reply_params_are_freed(tmp_path):
    """A reply whose message id nobody waits for (its cid was written off)
    has its payload freed, not leaked."""

    class StaleReplyDriver(ScriptedDriver):
        def __init__(self):
            super().__init__({"n0": "ok"})
            self._injected = False

        def recv_any(self, timeout=None):
            if not self._injected:
                self._injected = True
                return "n0", 999_999, types.SimpleNamespace(error=None, cid=7, params="stale-ptr")
            return super().recv_any(timeout)

    app = _window_app(tmp_path, StaleReplyDriver(), accept_failures_cnt=0)
    freed = []
    app.transport.free = freed.append
    got = list(app._sliding_window(1, [0], make_ins, timeout=5.0))
    assert sorted(r.cid for r in got) == [0]
    assert freed == ["stale-ptr"]


def test_sliding_window_readmits_a_node_that_comes_back(tmp_path):
    """A node that dies mid-round and re-registers under its id while the
    window runs gets the round's broadcast again, is readmitted, and takes
    work; the killed cid is retried."""

    class Rejoin(ScriptedDriver):
        def __init__(self):
            super().__init__({"n0": "ok", "n1": "die"})

        def recv_any(self, timeout=None):
            reply = super().recv_any(timeout)
            if reply[0] == "n0" and "n1" not in self.alive:
                self.alive.add("n1")  # n1 dialed back in
                self.behavior["n1"] = "ok"
            return reply

    driver = Rejoin()
    app = _window_app(tmp_path, driver, accept_failures_cnt=0)
    app.membership.register_present(driver.node_ids())
    app._last_broadcast = "round-broadcast"
    got = list(app._sliding_window(1, [0, 1, 2], make_ins, timeout=5.0))
    assert sorted(r.cid for r in got) == [0, 1, 2]
    assert ("n1", "round-broadcast") in driver.sends
    assert app.membership.readmitted_total == 1
    assert driver.sends[0] == ("n0", ("fit", [0])) and driver.sends[1] == ("n1", ("fit", [1]))
    assert Query("ping") not in [m for _, m in driver.sends]
