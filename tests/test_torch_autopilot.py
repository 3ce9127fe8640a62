"""The port's SLO autopilot (``photon_tpu_torch/telemetry/autopilot.py``),
one case for each case of ``tests/test_autopilot.py`` but the two that
need the collective and async runners (``test_collective_setters_loud_rejects``
and ``test_async_staleness_setter_rejects_negative``, owed with them), plus:

- parity with the JAX package's ``Autopilot``: one scripted series of
  queue depth, TPOT, straggler fraction, wire bytes, HBM alerts, async
  rejects and replica restarts, on one injected clock and the same fake
  knobs, gives the same decision sequence, decision for decision;
- the validation texts of every ``telemetry.autopilot`` bound, equal to
  JAX's;
- the hook sites: the scheduler's registrations and its tick, the prefix
  cache's and the adapter pool's pin rules under ``reclaim_memory``, the
  router's restart leg (compile streak, HBM latch, cooldown, the
  ``restart`` action sent after the poll), ``/statusz`` on the frontend,
  the router and ``PromServer``, and each hook one ``None`` check off;
- the queue storm through the port's real scheduler on the CPU (unmarked:
  a tiny model, a few seconds);
- ``dump_memory_profile``'s contract and its two callers' texts.

The JAX package's telemetry is never installed here (its ``uninstall``
raises on jax 0.9.0); its side drives ``Autopilot`` with the module's
hub and health globals set through ``monkeypatch``.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from photon_tpu_torch import chaos, telemetry
from photon_tpu_torch.config.schema import (
    AutopilotConfig,
    ChaosConfig,
    Config,
    TelemetryConfig,
)
from photon_tpu_torch.telemetry.autopilot import Autopilot
from photon_tpu_torch.telemetry.health import HealthMonitor
from photon_tpu_torch.telemetry.metrics import MetricsHub
from photon_tpu_torch.utils.profiling import (
    ALERT_HBM_GROWTH,
    AUTOPILOT_ACTION_RECLAIM,
    AUTOPILOT_ACTION_RESTART,
    AUTOPILOT_ACTUATIONS,
    AUTOPILOT_KNOB_MAX_STALENESS,
    AUTOPILOT_KNOB_PREFILL_BUDGET,
    AUTOPILOT_KNOB_QUANT_LEVEL,
    AUTOPILOT_KNOB_SPEC_K_MAX,
    AUTOPILOT_KNOB_STAGE_TIMEOUT_S,
    COLLECTIVE_STRAGGLER_FRAC,
    COLLECTIVE_WIRE_BYTES,
    EVENT_AUTOPILOT_ACTUATION,
    EVENT_AUTOPILOT_RELAX,
    EVENT_AUTOPILOT_SATURATED,
    SERVE_QUEUE_DEPTH,
    SERVE_TPOT_S,
)
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


class _Clock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Tiny models gain nothing from every core; other test files share
    the host's cores with this one's scheduler threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_planes():
    telemetry.uninstall()
    chaos.uninstall()
    yield
    telemetry.uninstall()
    chaos.uninstall()


def _install(clk, **ap_kw):
    """The telemetry plane with an injected-clock hub and health monitor,
    and a controller on the same clock (the install path is its own case)."""
    telemetry.install(TelemetryConfig(enabled=True), scope="t")
    telemetry._METRICS = MetricsHub(clock=clk)
    telemetry._HEALTH = HealthMonitor(clock=clk)
    ap = Autopilot(AutopilotConfig(enabled=True, **ap_kw), clock=clk)
    telemetry._AUTOPILOT = ap
    return ap


def _event_kinds():
    return [e["kind"] for e in telemetry.drain_events()]


def _budget_knob(ap, state, key="budget"):
    ap.register_knob(AUTOPILOT_KNOB_PREFILL_BUDGET, lambda: state[key],
                     lambda v: state.__setitem__(key, v), integer=True)


# ---------------------------------------------------------------------------
# 1. windowed reducers — exact values on hand-built series
# ---------------------------------------------------------------------------


def test_percentile_nearest_rank_exact():
    clk = _Clock(0.0)
    g = MetricsHub(clock=clk).gauge(SERVE_QUEUE_DEPTH)
    for i in range(10):
        clk.t = float(i)
        g.set(float(i))
    clk.t = 9.0
    assert g.percentile(0.0) == 0.0
    assert g.percentile(0.5) == 5.0  # int(0.5*9 + 0.5) == 5
    assert g.percentile(0.9) == 8.0
    assert g.percentile(1.0) == 9.0
    assert g.percentile(0.5, window_s=4.5) == 7.0  # values 5..9


def test_rate_endpoint_delta_exact():
    clk = _Clock(0.0)
    c = MetricsHub(clock=clk).counter(COLLECTIVE_WIRE_BYTES)
    c.inc(0.0)
    clk.t = 10.0
    c.inc(50.0)
    assert c.rate() == 5.0
    assert c.latest() == 50.0


def test_slope_least_squares_exact():
    clk = _Clock(0.0)
    g = MetricsHub(clock=clk).gauge(SERVE_QUEUE_DEPTH)
    for i in range(5):
        clk.t = float(i)
        g.set(1.0 + 2.0 * i)
    assert g.slope() == 2.0
    assert g.slope(window_s=1.0) == 2.0


def test_ewma_seeded_from_first_sample():
    clk = _Clock(0.0)
    g = MetricsHub(clock=clk).gauge(SERVE_QUEUE_DEPTH)
    g.set(0.0)
    clk.t = 1.0
    g.set(10.0)
    assert g.ewma(alpha=0.5) == 5.0
    assert g.ewma(alpha=0.5, window_s=0.5) == 10.0  # re-seeded from the second


def test_reducers_empty_and_degenerate_windows_are_none():
    clk = _Clock(0.0)
    g = MetricsHub(clock=clk).gauge(SERVE_QUEUE_DEPTH)
    assert g.latest() is None and g.percentile(0.5) is None
    assert g.rate() is None and g.slope() is None and g.ewma() is None
    g.set(3.0)
    assert g.rate() is None and g.slope() is None  # one sample: no timespan
    g.set(4.0)
    assert g.rate() is None and g.slope() is None  # zero timespan


# ---------------------------------------------------------------------------
# 2. runtime-mutable knobs — loud rejects, pressure-safe reclaim
# ---------------------------------------------------------------------------


def test_batcher_budget_setter_rejects_below_one():
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    b = object.__new__(ContinuousBatcher)
    b._lock = threading.Lock()
    b.prefill_token_budget = 64
    b.set_prefill_token_budget(8)
    assert b.prefill_token_budget == 8
    with pytest.raises(ValueError, match=">= 1"):
        b.set_prefill_token_budget(0)
    assert b.prefill_token_budget == 8  # a reject leaves the knob untouched


def test_spec_controller_k_max_zero_silences_probe():
    from photon_tpu.serve.draft import SpecController as JaxSpecController
    from photon_tpu_torch.serve.draft import SpecController

    seen = []
    for cls in (SpecController, JaxSpecController):
        sc = cls(4, probe_ticks=2)
        with pytest.raises(ValueError, match=">= 0"):
            sc.set_k_max(-1)
        sc.set_k_max(0)
        steps = [sc.k_effective()] + [sc.next_k() for _ in range(5)]
        sc.set_k_max(2)
        seen.append(steps + [sc.k_effective()])
    # the probe is clamped to the ceiling: fully off stays off; a raised
    # ceiling re-engages at once (the EWMA is optimistic)
    assert seen[0] == seen[1] == [0, 0, 0, 0, 0, 0, 2]


def test_adapter_pool_shrink_skips_pinned_pages():
    """The reclaim action's two halves skip what a running slot holds, as
    JAX's do: the adapter pool's ``shrink`` and the prefix cache's
    ``ensure_free`` (one op stream through both packages' caches)."""
    from photon_tpu.serve.cache import BlockAllocator as JaxAllocator
    from photon_tpu.serve.prefix import PrefixCache as JaxPrefixCache
    from photon_tpu_torch.adapters.lora import AdapterSpec
    from photon_tpu_torch.serve.adapter_pool import AdapterPool
    from photon_tpu_torch.serve.cache import BlockAllocator
    from photon_tpu_torch.serve.prefix import PrefixCache

    entries = (("blocks/block/up_proj", (4, 2), (2, 4)),)
    pool = AdapterPool(AdapterSpec(2, 4.0, entries), pool_size=2)
    pool.install_bank({c: [np.zeros((4, 2), np.float32), np.zeros((2, 4), np.float32)]
                       for c in "ab"})
    pa = pool.acquire("a")  # pinned by a live slot
    pool.release(pool.acquire("b"))  # resident, unpinned
    assert pool.shrink() == 1  # only b is evictable
    assert pool.has_cohort("a") and pool.can_acquire("a")
    assert "b" not in pool._pages and "a" in pool._pages
    pool.release(pa)
    assert pool.shrink() == 1  # a unpinned: evictable now

    seen = []
    for alloc_cls, cache_cls in ((BlockAllocator, PrefixCache),
                                 (JaxAllocator, JaxPrefixCache)):
        alloc = alloc_cls(9)
        cache = cache_cls(alloc)
        blocks = alloc.alloc(6)
        cache.insert([bytes([i]) * 8 for i in range(6)], blocks)
        alloc.free(blocks[:4])  # four cached blocks left to the cache alone
        steps = [alloc.free_blocks, cache.ensure_free(6), alloc.free_blocks,
                 cache.ensure_free(8), alloc.free_blocks, len(cache)]
        alloc.free(blocks[4:])  # the pinned two unpin
        steps += [cache.ensure_free(8), alloc.free_blocks, len(cache)]
        seen.append(steps)
    # pinned entries stay indexed and never count toward the target
    assert seen[0] == seen[1] == [3, True, 6, False, 7, 2, True, 8, 1]


# ---------------------------------------------------------------------------
# 3. the controller, on an injected clock
# ---------------------------------------------------------------------------


def test_breach_actuates_once_per_cooldown_then_saturates_once():
    clk = _Clock(100.0)
    ap = _install(clk, period_s=0.25, cooldown_s=2.0, queue_high_frac=0.75,
                  queue_clear_frac=0.25, prefill_budget_min=16, prefill_shrink=0.5)
    state = {"budget": 64}
    _budget_knob(ap, state)
    telemetry.metrics_active().gauge(SERVE_QUEUE_DEPTH).set(100.0)  # frac 1.0: breach
    telemetry.drain_events()

    ap.tick("serve", max_queue=100)
    assert state["budget"] == 32
    assert _event_kinds().count(EVENT_AUTOPILOT_ACTUATION) == 1
    d = ap.decisions[-1]
    assert (d["rule"], d["knob"], d["old"], d["new"], d["observed"]) == \
        ("queue_budget", AUTOPILOT_KNOB_PREFILL_BUDGET, 64, 32, 1.0)
    assert telemetry.metrics_active().counter(AUTOPILOT_ACTUATIONS).value == 1.0
    assert telemetry.metrics_active().gauge(AUTOPILOT_KNOB_PREFILL_BUDGET).latest() == 32.0

    clk.advance(0.3)  # period elapsed, cooldown not
    ap.tick("serve", max_queue=100)
    assert state["budget"] == 32
    clk.advance(2.0)  # cooldown elapsed: one more shrink, to the bound
    ap.tick("serve", max_queue=100)
    assert state["budget"] == 16
    for _ in range(2):  # at the bound: saturated, once per episode
        clk.advance(2.1)
        ap.tick("serve", max_queue=100)
    assert state["budget"] == 16
    assert sum(d["event"] == EVENT_AUTOPILOT_SATURATED for d in ap.decisions) == 1
    assert ap.statusz()["rules"]["queue_budget"]["saturated"] is True


def test_hysteresis_relax_probes_back_toward_declared():
    clk = _Clock(0.0)
    ap = _install(clk, period_s=0.25, cooldown_s=0.5, relax_after=3, window_s=30.0,
                  queue_high_frac=0.75, queue_clear_frac=0.25, prefill_budget_min=16,
                  prefill_shrink=0.5)
    state = {"budget": 64}
    _budget_knob(ap, state)
    hub = telemetry.metrics_active()
    hub.gauge(SERVE_QUEUE_DEPTH).set(100.0)
    ap.tick("serve", max_queue=100)
    assert state["budget"] == 32
    clk.advance(31.0)  # the saturated samples leave the window
    for _ in range(3):
        hub.gauge(SERVE_QUEUE_DEPTH).set(5.0)  # frac 0.05 <= 0.25: clean
        ap.tick("serve", max_queue=100)
        clk.advance(0.3)
    assert state["budget"] == 33  # one integer step toward 64
    relax = [d for d in ap.decisions if d["event"] == EVENT_AUTOPILOT_RELAX]
    assert [(d["old"], d["new"]) for d in relax] == [(32, 33)]


def test_dead_band_neither_tightens_nor_earns_relax_credit():
    clk = _Clock(0.0)
    ap = _install(clk, period_s=0.1, cooldown_s=0.0, relax_after=2, window_s=1.0,
                  queue_high_frac=0.75, queue_clear_frac=0.25, prefill_budget_min=16,
                  prefill_shrink=0.5)
    state = {"budget": 64}
    _budget_knob(ap, state)
    hub = telemetry.metrics_active()
    hub.gauge(SERVE_QUEUE_DEPTH).set(100.0)
    ap.tick("serve", max_queue=100)
    assert state["budget"] == 32
    for _ in range(4):  # frac 0.5: between clear 0.25 and breach 0.75
        clk.advance(1.1)
        hub.gauge(SERVE_QUEUE_DEPTH).set(50.0)
        ap.tick("serve", max_queue=100)
    assert state["budget"] == 32
    assert ap.statusz()["rules"]["queue_budget"]["clean_streak"] == 0


def test_quantization_enum_escalates_then_saturates():
    clk = _Clock(0.0)
    ap = _install(clk, period_s=0.1, cooldown_s=0.0, wire_slope_bytes_per_s=10.0)
    state = {"q": "off"}
    ap.register_knob(AUTOPILOT_KNOB_QUANT_LEVEL, lambda: state["q"],
                     lambda v: state.__setitem__("q", v), levels=("off", "q8"))
    c = telemetry.metrics_active().counter(COLLECTIVE_WIRE_BYTES)
    c.inc(1.0)
    clk.advance(1.0)
    c.inc(100.0)  # ~100 B/s > 10
    ap.tick("collective")
    assert state["q"] == "q8"
    d = [d for d in ap.decisions if d["event"] == EVENT_AUTOPILOT_ACTUATION][-1]
    assert (d["old"], d["new"]) == ("off", "q8")
    clk.advance(0.2)
    c.inc(100.0)
    ap.tick("collective")  # still breaching at the ladder's top
    assert state["q"] == "q8"
    assert any(d["event"] == EVENT_AUTOPILOT_SATURATED for d in ap.decisions)


def test_async_reject_rate_widens_staleness_bound():
    clk = _Clock(0.0)
    ap = _install(clk, period_s=0.1, cooldown_s=0.0, async_reject_per_version=0.5,
                  max_staleness_hi=8)
    state = {"s": 2}
    ap.register_knob(AUTOPILOT_KNOB_MAX_STALENESS, lambda: state["s"],
                     lambda v: state.__setitem__("s", v), integer=True)
    ap.tick("async", rejected_total=0, version=1)  # primes the delta
    assert state["s"] == 2
    clk.advance(0.2)
    ap.tick("async", rejected_total=3, version=2)  # 3 rejects a version
    assert state["s"] == 3
    z = ap.statusz()["knobs"][AUTOPILOT_KNOB_MAX_STALENESS]
    assert (z["lo"], z["hi"]) == (2.0, 8.0)  # declared floor, configured ceiling


def test_hbm_alert_latch_fires_reclaim_once_per_alert():
    clk = _Clock(50.0)
    ap = _install(clk, period_s=0.1, cooldown_s=0.0)
    calls = []
    ap.register_action(AUTOPILOT_ACTION_RECLAIM, lambda: (calls.append(1), (10.0, 26.0))[1])
    health = telemetry.health_active()
    health.alert(ALERT_HBM_GROWTH, plane="serve", growth_frac=0.4)
    ap.tick("serve", max_queue=8)
    assert calls == [1]
    d = ap.decisions[-1]
    assert (d["rule"], d["knob"], d["old"], d["new"], d["observed"]) == \
        ("hbm_reclaim", AUTOPILOT_ACTION_RECLAIM, 10.0, 26.0, 0.4)
    clk.advance(0.2)
    ap.tick("serve", max_queue=8)  # the same alert: no second reclaim
    assert calls == [1]
    clk.advance(0.2)
    health.alert(ALERT_HBM_GROWTH, plane="serve", growth_frac=0.6)
    ap.tick("serve", max_queue=8)  # a new alert fires again
    assert calls == [1, 1]


def test_hbm_alert_inside_cooldown_is_deferred_parts_from_jax(monkeypatch):
    """A new HBM alert that lands inside the reclaim rule's cooldown: JAX's
    controller reads it (marking it seen) and then drops it, so it never
    reclaims; the port's leaves it unread until the cooldown ends, then
    reclaims once. A reference fault not copied (ROADMAP Queue 3)."""
    import photon_tpu.telemetry as jax_telemetry
    from photon_tpu.config.schema import AutopilotConfig as JaxAutopilotConfig
    from photon_tpu.telemetry.autopilot import Autopilot as JaxAutopilot
    from photon_tpu.telemetry.health import HealthMonitor as JaxHealthMonitor

    counts = []
    for tel, ap_cls, health_cls, cfg_cls in (
            (telemetry, Autopilot, HealthMonitor, AutopilotConfig),
            (jax_telemetry, JaxAutopilot, JaxHealthMonitor, JaxAutopilotConfig)):
        clk = _Clock(10.0)
        monkeypatch.setattr(tel, "_HEALTH", health_cls(clock=clk))
        ap = ap_cls(cfg_cls(enabled=True, period_s=0.1, cooldown_s=5.0), clock=clk)
        calls = []
        ap.register_action(AUTOPILOT_ACTION_RECLAIM, lambda: (calls.append(clk.t), (1.0, 2.0))[1])
        tel.health_active().alert(ALERT_HBM_GROWTH, plane="serve", growth_frac=0.3)
        ap.tick("serve")
        clk.advance(1.0)
        tel.health_active().alert(ALERT_HBM_GROWTH, plane="serve", growth_frac=0.4)
        for _ in range(10):  # ticks through and past the cooldown
            ap.tick("serve")
            clk.advance(1.0)
        counts.append(calls)
    assert counts[1] == [10.0]  # JAX: the second alert is gone
    assert counts[0] == [10.0, 15.0]  # the port: once the cooldown ended


def test_replica_restart_cooldown_is_per_replica():
    clk = _Clock(0.0)
    ap = _install(clk, cooldown_s=5.0)
    assert ap.request_replica_restart("r0", "compile_growth") is True
    assert ap.request_replica_restart("r0", "compile_growth") is False
    assert ap.request_replica_restart("r1", ALERT_HBM_GROWTH) is True
    clk.advance(6.0)
    assert ap.request_replica_restart("r0", "compile_growth") is True
    d = ap.decisions[-1]
    assert (d["knob"], d["old"], d["new"], d["replica"]) == \
        (AUTOPILOT_ACTION_RESTART, "live", "restarting", "r0")


def test_tick_never_raises_out_of_the_hook_site():
    clk = _Clock(0.0)
    ap = _install(clk, period_s=0.1, cooldown_s=0.0)

    def _bad_setter(v):
        raise RuntimeError("actuator wired wrong")

    ap.register_knob(AUTOPILOT_KNOB_PREFILL_BUDGET, lambda: 64, _bad_setter, integer=True)
    telemetry.metrics_active().gauge(SERVE_QUEUE_DEPTH).set(100.0)
    with pytest.warns(UserWarning, match="autopilot tick failed"):
        ap.tick("serve", max_queue=100)


def test_install_path_and_disabled_is_one_none_check():
    from photon_tpu_torch.analysis import runtime as rt

    # nothing installed by default: every hook site is one None check
    assert telemetry.autopilot_active() is None
    assert rt.retrace_active() is None and rt.lock_order_active() is None
    tel = TelemetryConfig(enabled=True)
    telemetry.install(tel, scope="t")
    assert telemetry.autopilot_active() is None  # the autopilot is off by default
    tel.autopilot.enabled = True
    telemetry.install(tel, scope="t")
    ap = telemetry.autopilot_active()
    assert ap is not None and ap.cfg is tel.autopilot
    assert {r.name for r in ap._rules} == {"queue_budget", "hbm_reclaim"}
    telemetry.uninstall()
    assert telemetry.autopilot_active() is None


def test_config_validation_rejects_bad_autopilot_blocks():
    """The bounds and their texts are JAX's, field for field; a YAML from
    either package carries the block both ways."""
    from photon_tpu.config.schema import Config as JaxConfig

    cfg = Config()
    cfg.photon.telemetry.enabled = True
    cfg.photon.telemetry.autopilot.enabled = True
    cfg.validate()  # the defaults are legal
    cfg.validate(serving=True)
    back = JaxConfig.from_dict(cfg.to_dict())
    assert back.photon.telemetry.autopilot.__dict__ == cfg.photon.telemetry.autopilot.__dict__
    for field, bad in (("period_s", 0.0), ("cooldown_s", -1.0), ("relax_after", 0),
                       ("window_s", 0.0), ("decisions", 0), ("clear_frac", 0.0),
                       ("queue_high_frac", 1.5), ("queue_clear_frac", 0.9),
                       ("prefill_budget_min", 0), ("prefill_shrink", 1.0),
                       ("tpot_p50_slo_s", -1.0), ("spec_k_min", 0),
                       ("reclaim_free_blocks", -1), ("straggler_p90", 1.5),
                       ("stage_timeout_min_s", 0.0), ("stage_timeout_shrink", 1.0),
                       ("wire_slope_bytes_per_s", -1.0), ("async_reject_per_version", -1.0),
                       ("max_staleness_hi", -1), ("replica_compile_streak", -1)):
        ours, theirs = Config(), JaxConfig()
        for c in (ours, theirs):
            c.photon.telemetry.enabled = True
            c.photon.telemetry.autopilot.enabled = True
            setattr(c.photon.telemetry.autopilot, field, bad)
        with pytest.raises(ValueError) as got:
            ours.validate()
        with pytest.raises(ValueError) as want:
            theirs.validate()
        assert str(got.value) == str(want.value), field
    cfg.photon.telemetry.enabled = False  # the autopilot needs the plane
    with pytest.raises(ValueError, match="needs telemetry.enabled=true"):
        cfg.validate()


def test_statusz_surfaces_decisions_rules_and_knob_bounds():
    clk = _Clock(0.0)
    ap = _install(clk, prefill_budget_min=16)
    state = {"budget": 64}
    _budget_knob(ap, state)
    z = ap.statusz()
    assert set(z) == {"decisions", "rules", "knobs"}
    k = z["knobs"][AUTOPILOT_KNOB_PREFILL_BUDGET]
    assert (k["value"], k["declared"], k["lo"], k["hi"]) == (64, 64, 16.0, 64.0)
    assert set(z["rules"]) == {"queue_budget", "hbm_reclaim"}


def test_prom_statusz_merges_autopilot_payload():
    from photon_tpu_torch.metrics.history import History
    from photon_tpu_torch.telemetry.prom import PromServer

    _install(_Clock(0.0))
    srv = PromServer(History(), port=0, hub=telemetry.metrics_active(),
                     health=telemetry.health_active())
    srv.start()
    try:
        z = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/statusz", timeout=5).read())
        assert set(z["autopilot"]) == {"decisions", "rules", "knobs"}
        assert "queue_budget" in z["autopilot"]["rules"]
        telemetry._AUTOPILOT = None  # off: no autopilot object
        z = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/statusz", timeout=5).read())
        assert "autopilot" not in z
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# 3b. parity with the JAX package's controller
# ---------------------------------------------------------------------------


_PARITY_CFG = dict(period_s=0.25, cooldown_s=0.6, relax_after=2, window_s=3.0,
                   queue_high_frac=0.6, queue_clear_frac=0.2, prefill_budget_min=8,
                   prefill_shrink=0.5, tpot_p50_slo_s=0.05, spec_k_min=1,
                   straggler_p90=0.3, stage_timeout_min_s=5.0, stage_timeout_shrink=0.75,
                   wire_slope_bytes_per_s=1e6, async_reject_per_version=0.5,
                   max_staleness_hi=6, decisions=512)


def _scripted_decisions(tel, autopilot_cls, hub_cls, health_cls, cfg_cls, monkeypatch):
    """One scripted minute of signals through one package's controller:
    returns its decision ring as (event, rule, knob, observed, old, new,
    replica) tuples. The hub and health monitor are that package's, on the
    controller's clock, set into its telemetry module's globals."""
    clk = _Clock(5000.0)
    monkeypatch.setattr(tel, "_METRICS", hub_cls(clock=clk))
    monkeypatch.setattr(tel, "_HEALTH", health_cls(clock=clk))
    ap = autopilot_cls(cfg_cls(enabled=True, **_PARITY_CFG), clock=clk)
    knobs = {"budget": 64, "k": 4, "timeout": 30.0, "q": "off", "stale": 2}
    free = [10.0]

    def reclaim():
        before = free[0]
        free[0] += 7.0
        return before, free[0]

    ap.register_knob(AUTOPILOT_KNOB_PREFILL_BUDGET, lambda: knobs["budget"],
                     lambda v: knobs.__setitem__("budget", v), integer=True)
    ap.register_knob(AUTOPILOT_KNOB_SPEC_K_MAX, lambda: knobs["k"],
                     lambda v: knobs.__setitem__("k", v), integer=True)
    ap.register_knob(AUTOPILOT_KNOB_STAGE_TIMEOUT_S, lambda: knobs["timeout"],
                     lambda v: knobs.__setitem__("timeout", v))
    ap.register_knob(AUTOPILOT_KNOB_QUANT_LEVEL, lambda: knobs["q"],
                     lambda v: knobs.__setitem__("q", v), levels=("off", "q8"))
    ap.register_knob(AUTOPILOT_KNOB_MAX_STALENESS, lambda: knobs["stale"],
                     lambda v: knobs.__setitem__("stale", v), integer=True)
    ap.register_action(AUTOPILOT_ACTION_RECLAIM, reclaim)
    hub, health = tel.metrics_active(), tel.health_active()
    rng = np.random.default_rng(2024)
    rejected, version, wire = 0, 0, 0.0
    for step in range(240):
        storm = step < 60 or 150 <= step < 170
        hub.gauge(SERVE_QUEUE_DEPTH).set(float(rng.integers(60, 100) if storm
                                               else rng.integers(0, 10)))
        slow = 40 <= step < 110
        hub.histogram(SERVE_TPOT_S).observe(float(rng.uniform(0.06, 0.2) if slow
                                                  else rng.uniform(0.005, 0.03)))
        hub.gauge(COLLECTIVE_STRAGGLER_FRAC).set(
            float(rng.uniform(0.4, 0.9) if 20 <= step < 90 else rng.uniform(0.0, 0.1)))
        wire += float(rng.uniform(2e5, 6e5) if 100 <= step < 130 else rng.uniform(0, 1e4))
        hub.counter(COLLECTIVE_WIRE_BYTES).inc_to(wire)
        if step in (30, 95, 200):  # apart: an alert inside the cooldown parts (below)
            health.alert(ALERT_HBM_GROWTH, plane="serve", growth_frac=round(0.2 + step / 1e3, 4))
        if step % 3 == 0:
            version += 1
            rejected += int(rng.integers(2, 5)) if 50 <= step < 120 else 0
        ap.tick("serve", max_queue=100)
        ap.tick("collective")
        ap.tick("async", rejected_total=rejected, version=version)
        if step in (12, 13, 120, 121):
            ap.request_replica_restart(f"r{step % 2}", ALERT_HBM_GROWTH)
        clk.advance(0.1 if step % 4 else 0.3)
    return ([(d["event"], d["rule"], d["knob"], d["observed"], d["old"], d["new"],
              d.get("replica")) for d in ap.decisions], ap.statusz()["rules"])


def test_decision_sequences_match_jax(monkeypatch):
    import photon_tpu.telemetry as jax_telemetry
    from photon_tpu.config.schema import AutopilotConfig as JaxAutopilotConfig
    from photon_tpu.telemetry.autopilot import Autopilot as JaxAutopilot
    from photon_tpu.telemetry.health import HealthMonitor as JaxHealthMonitor
    from photon_tpu.telemetry.metrics import MetricsHub as JaxMetricsHub

    ours, our_rules = _scripted_decisions(telemetry, Autopilot, MetricsHub, HealthMonitor,
                                          AutopilotConfig, monkeypatch)
    theirs, their_rules = _scripted_decisions(jax_telemetry, JaxAutopilot, JaxMetricsHub,
                                              JaxHealthMonitor, JaxAutopilotConfig, monkeypatch)
    assert ours == theirs
    assert our_rules == their_rules
    # every rule and every kind of decision took part
    assert {d[1] for d in ours} == {"queue_budget", "tpot_spec_k", "straggler_deadline",
                                    "wire_quantization", "async_staleness", "hbm_reclaim",
                                    "replica_restart"}
    assert {d[0] for d in ours} == {EVENT_AUTOPILOT_ACTUATION, EVENT_AUTOPILOT_RELAX,
                                    EVENT_AUTOPILOT_SATURATED}


# ---------------------------------------------------------------------------
# 3c. the hook sites
# ---------------------------------------------------------------------------


def _tiny_serve_cfg(*, spec=False, prefix=False, n_slots=2, max_seq=64, max_new=4):
    from photon_tpu.config.schema import Config as JaxConfig

    jcfg = JaxConfig()
    m = jcfg.model
    m.d_model, m.n_layers, m.n_heads, m.vocab_size = 32, 2, 4, 96
    m.attn_impl, m.compute_dtype, m.max_seq_len = "xla", "float32", max_seq
    s = jcfg.photon.serve
    s.n_slots, s.block_size, s.max_new_tokens = n_slots, 4, max_new
    s.prefix_cache = prefix
    s.speculative.enabled = spec
    return Config.from_dict(jcfg.validate().to_dict()).validate("cpu")


def _engine(cfg, seed=4):
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.serve.engine import PagedEngine

    return PagedEngine(cfg, init_params(cfg.model, seed=seed), device="cpu")


def test_scheduler_registers_knobs_and_reclaims_cached_blocks():
    """With the autopilot on, the batcher registers the budget, the
    speculation ceiling and the reclaim action at construction; the
    reclaim frees the prefix cache's unpinned blocks; with it off, the
    batcher registers nothing and reads one None."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _tiny_serve_cfg(spec=True, prefix=True)
    off = ContinuousBatcher(_engine(cfg), speculative=cfg.photon.serve.speculative)
    assert telemetry.autopilot_active() is None and off.prefill_token_budget == 2048
    tel = TelemetryConfig(enabled=True)
    tel.autopilot.enabled, tel.autopilot.reclaim_free_blocks = True, 10_000
    telemetry.install(tel, scope="serve")
    ap = telemetry.autopilot_active()
    eng = _engine(cfg)
    b = ContinuousBatcher(eng, prefill_token_budget=48,
                          speculative=cfg.photon.serve.speculative).start()
    try:
        knobs = ap.statusz()["knobs"]
        assert knobs[AUTOPILOT_KNOB_PREFILL_BUDGET]["declared"] == 48
        assert knobs[AUTOPILOT_KNOB_SPEC_K_MAX]["declared"] == cfg.photon.serve.speculative.k
        rng = np.random.default_rng(5)
        shared = [int(x) for x in rng.integers(1, 96, 12)]
        for r in [b.submit(shared + [int(x) for x in rng.integers(1, 96, 3)], 3)
                  for _ in range(3)]:
            r.result(timeout=60)
        held = len(eng.prefix_cache)
        assert held > 0
        before, after = b.reclaim_memory(10_000)  # the action's own call
        assert after - before == held and len(eng.prefix_cache) == 0
        assert ap._actions[AUTOPILOT_ACTION_RECLAIM]() == (after, after)  # nothing left
        with pytest.raises(ValueError, match=">= 1"):
            ap._knobs[AUTOPILOT_KNOB_PREFILL_BUDGET].set(0)
    finally:
        b.close()


def _report(compiles=None, health=None, port=1):
    from photon_tpu_torch.federation.messages import Ack

    rep = {"host": "127.0.0.1", "port": port, "round": 1}
    if compiles is not None:
        rep["compiles"] = compiles
    if health is not None:
        rep["health"] = health
    return Ack(ok=True, detail=json.dumps(rep))


def _router(**ap_kw):
    from photon_tpu_torch.config.schema import FleetConfig
    from photon_tpu_torch.serve.router import FleetRouter

    if ap_kw:
        tel = TelemetryConfig(enabled=True)
        tel.autopilot.enabled = True
        for k, v in ap_kw.items():
            setattr(tel.autopilot, k, v)
        telemetry.install(tel, scope="router")
    return FleetRouter(FleetConfig(enabled=True, replicas=2, control_port=0), block_size=4)


def test_router_restart_triggers_and_cooldown():
    """The router's restart leg: a compile streak of
    ``replica_compile_streak`` polls, or a serve plane degraded by HBM
    growth, asks the autopilot; approvals wait for the poll's end, and the
    per-replica cooldown holds a latched replica to one restart."""
    router = _router(replica_compile_streak=2, cooldown_s=60.0)
    try:
        ap = telemetry.autopilot_active()
        for c in (1, 1, 2, 3):  # grows on the 3rd and 4th poll: streak 2
            router._ingest_report("r0", _report(compiles=c))
        assert router._pending_restarts == ["r0"]
        assert router._compile_streaks["r0"] == 0
        degraded = {"status": "degraded", "reason": ALERT_HBM_GROWTH}
        for _ in range(3):
            router._ingest_report("r1", _report(compiles=1, health=degraded))
        router._ingest_report("r0", _report(compiles=9))
        router._ingest_report("r0", _report(compiles=10))  # streak again, in cooldown
        assert router._pending_restarts == ["r0", "r1"]  # one each
        router._ingest_report("r1", _report(health={"status": "degraded",
                                                    "reason": "alert/queue_saturation"}))
        acts = [(d["replica"], d["reason"], d["observed"]) for d in ap.decisions]
        assert acts == [("r0", "compile_growth", 2.0), ("r1", ALERT_HBM_GROWTH, 1.0)]
    finally:
        router.close()


def test_router_without_autopilot_decides_nothing():
    router = _router()
    try:
        assert telemetry.autopilot_active() is None
        for c in range(5):
            router._ingest_report("r0", _report(
                compiles=c, health={"status": "degraded", "reason": ALERT_HBM_GROWTH}))
        assert router._pending_restarts == [] and router._compiles == {}
    finally:
        router.close()


def test_router_sends_restart_after_the_poll_and_statusz_carries_it():
    """An approved restart goes to the agent as its ``restart`` action once
    the poll released the control lock; the router's ``/statusz`` carries
    the autopilot's decision."""
    from photon_tpu_torch.federation.messages import Ack

    router = _router(cooldown_s=60.0)
    sent = []

    def fake_query(nid, action, timeout):
        assert not router._ctl_lock.locked()  # never inside the poll's hold
        sent.append((nid, action))
        return Ack(ok=True)

    router._query = fake_query
    router.start()
    try:
        router._ingest_report("r1", _report(health={"status": "degraded",
                                                    "reason": ALERT_HBM_GROWTH}))
        router._drain_restarts()
        assert sent == [("r1", "restart")] and list(router.restarts) == ["r1"]
        z = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{router.port}/statusz", timeout=5).read())
        d = z["autopilot"]["decisions"]
        assert [(x["rule"], x["replica"]) for x in d] == [("replica_restart", "r1")]
    finally:
        router.close()


def test_frontend_statusz_carries_the_autopilot_only_when_on():
    from photon_tpu_torch.serve.frontend import ServeFrontend
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _tiny_serve_cfg()
    for on in (False, True):
        tel = TelemetryConfig(enabled=True)
        tel.autopilot.enabled = on
        telemetry.install(tel, scope="serve")
        b = ContinuousBatcher(_engine(cfg)).start()
        fe = ServeFrontend(b)
        port = fe.start()
        try:
            z = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/statusz", timeout=5).read())
            assert ("autopilot" in z) is on
            if on:
                assert AUTOPILOT_KNOB_PREFILL_BUDGET in z["autopilot"]["knobs"]
        finally:
            fe.close()
            b.close()


# ---------------------------------------------------------------------------
# 4. the queue storm through the port's real scheduler (CPU, tiny)
# ---------------------------------------------------------------------------


def _storm_cfg() -> Config:
    cfg = _tiny_serve_cfg(n_slots=2, max_new=4)
    cfg.photon.telemetry.enabled = True
    apc = cfg.photon.telemetry.autopilot
    apc.enabled, apc.period_s, apc.cooldown_s = True, 0.05, 0.1
    apc.queue_high_frac, apc.queue_clear_frac = 0.3, 0.1
    apc.prefill_budget_min, apc.prefill_shrink, apc.relax_after = 4, 0.5, 2
    apc.window_s = 0.5
    cfg.photon.chaos = ChaosConfig(enabled=True, seed=1234, serve_stall_per_token_s=0.002)
    return cfg.validate("cpu")


def test_storm_autopilot_shrinks_budget_and_surfaces_decisions():
    """Fat prompts under a per-token stall saturate the queue: the budget
    shrinks from its declared 32 before any 429, the decisions reach the
    frontend's ``/statusz``, and a trickle after the backlog relaxes the
    budget back."""
    from photon_tpu_torch.serve.frontend import ServeFrontend
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _storm_cfg()
    telemetry.install(cfg.photon.telemetry, scope="serve")
    chaos.install(cfg.photon.chaos, scope="serve")
    batcher = ContinuousBatcher(_engine(cfg), max_queue=8, prefill_token_budget=32).start()
    fe = ServeFrontend(batcher)
    fe_port = fe.start()
    ap = telemetry.autopilot_active()
    assert ap.statusz()["knobs"][AUTOPILOT_KNOB_PREFILL_BUDGET]["declared"] == 32
    try:
        rng = np.random.default_rng(0)
        handles = [batcher.submit([int(x) for x in rng.integers(1, 96, 24)], max_new_tokens=2)
                   for _ in range(6)]  # 6 < max_queue: admission never rejects
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if all(h.finished for h in handles) and batcher.prefill_token_budget < 32:
                break
            time.sleep(0.05)
        assert batcher.rejected == 0
        assert all(h.error is None for h in handles)
        acts = [d for d in ap.statusz()["decisions"]
                if d["event"] == EVENT_AUTOPILOT_ACTUATION
                and d["knob"] == AUTOPILOT_KNOB_PREFILL_BUDGET]
        assert acts and acts[0]["rule"] == "queue_budget" and acts[0]["old"] == 32
        assert 4 <= min(d["new"] for d in acts) < 32
        assert chaos.active().counts["serve_stall"] > 0
        z = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{fe_port}/statusz", timeout=30).read())
        assert any(d["event"] == EVENT_AUTOPILOT_ACTUATION for d in z["autopilot"]["decisions"])
        # the trickle: ticks go on with the backlog gone, and the budget
        # relaxes a unit a probe back toward 32
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and batcher.prefill_token_budget < 32:
            batcher.submit([5, 9, 2], max_new_tokens=4).result(timeout=30)
        assert batcher.prefill_token_budget == 32
        assert any(d["event"] == EVENT_AUTOPILOT_RELAX for d in ap.decisions)
    finally:
        fe.close()
        batcher.close()


# ---------------------------------------------------------------------------
# 5. the OOM memory snapshot
# ---------------------------------------------------------------------------


def test_dump_memory_profile_is_none_on_a_cpu_device(tmp_path):
    from photon_tpu_torch.utils.profiling import dump_memory_profile

    assert dump_memory_profile(str(tmp_path), "oom", device="cpu") is None
    assert dump_memory_profile(str(tmp_path), "oom", device=torch.device("cpu")) is None
    if not torch.cuda.is_available():  # no context in this process: nothing to snapshot
        assert dump_memory_profile(str(tmp_path), "oom") is None
    assert list(tmp_path.iterdir()) == []


def test_oom_error_texts_name_the_memory_profile(tmp_path, monkeypatch):
    """The client runtime's error text (``[memory profile: PATH]``, JAX's
    spelling) and the ``auto`` probe's (``(memory profile: PATH)``) name the
    snapshot when one was written, and say nothing of it when none was or
    the error is not an OOM."""
    from photon_tpu_torch.federation import client_runtime
    from photon_tpu_torch.federation.client_runtime import ClientRuntime

    calls = []

    def fake_dump(save_dir, tag="oom", device=None):
        calls.append((save_dir, tag, str(device)))
        return f"{save_dir}/memory_{tag}_T.pickle"

    cfg = Config()
    cfg.photon.save_path = str(tmp_path)
    rt = ClientRuntime(cfg, transport=None, device="cpu")
    oom = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert rt._error(oom, "fit_cid3") == f"RuntimeError: {oom}"  # the real dump: None on CPU
    monkeypatch.setattr(client_runtime, "dump_memory_profile", fake_dump)
    assert rt._error(oom, "fit_cid3") == (f"RuntimeError: {oom} [memory profile: "
                                          f"{tmp_path}/memory_fit_cid3_T.pickle]")
    assert rt._error(ValueError("bad"), "fit_cid3") == "ValueError: bad"
    assert calls == [(str(tmp_path), "fit_cid3", "cpu")]


def test_auto_probe_raise_names_the_memory_profile(tmp_path, monkeypatch):
    import photon_tpu_torch.train.trainer as trainer_mod
    from tests.test_torch_train import _auto_cfg, _oom_above

    err = RuntimeError("RESOURCE_EXHAUSTED: Out of memory (simulated)")
    monkeypatch.setattr(trainer_mod, "make_train_step",
                        _oom_above(trainer_mod.make_train_step, 0, [], err))
    cfg = _auto_cfg()
    cfg.photon.save_path = str(tmp_path)
    with pytest.raises(RuntimeError) as plain:  # the real dump: None on the CPU
        trainer_mod.Trainer(cfg, init_seed=0, device="cpu")
    assert str(plain.value) == f"auto microbatch: even microbatch 1 exhausts device memory: {err}"
    seen = []
    monkeypatch.setattr(trainer_mod, "dump_memory_profile",
                        lambda d, tag="oom", device=None: seen.append(str(device))
                        or f"{d}/memory_{tag}_T.pickle")
    with pytest.raises(RuntimeError) as named:
        trainer_mod.Trainer(cfg, init_seed=0, device="cpu")
    assert str(named.value) == (
        "auto microbatch: even microbatch 1 exhausts device memory (memory profile: "
        f"{tmp_path}/memory_auto_microbatch_T.pickle): {err}")
    assert seen == ["cpu"]


# ---------------------------------------------------------------------------
# 6. phase 17 of chip_smoke.py, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _smoke_serve_cfg():
    cfg = Config()
    cfg.run_uuid = "autopilot-smoke"
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.vocab_size, m.max_seq_len = 32, 2, 4, 96, 128
    m.attn_impl, m.compute_dtype = "xla", "float32"
    s = cfg.photon.serve
    s.n_slots, s.block_size, s.n_blocks, s.prefill_token_budget = 8, 4, 0, 512
    s.max_new_tokens, s.max_queue = 32, 64
    return cfg


def test_chip_smoke_autopilot_phase_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.autopilot_phase`` (phase 17 (a)-(c)) on a tiny round:
    the storm's actuation from 512 and its relax back, 0 rejected, streams
    equal to the autopilot off, the guards green and the planted load
    caught; ``spec_k_max`` 4 → 1 with one ``saturated``; one reclaim per
    HBM alert with free blocks rising. Launch counts and the OOM snapshot
    (e) are card-only."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.ops import ragged_paged_attention as rpa
    from tests.test_torch_compression import _chip_smoke

    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "AP_STORM_PROMPT", (40, 100))
    monkeypatch.setattr(smoke, "AP_TRICKLE_PROMPT", 6)
    monkeypatch.setattr(smoke, "AP_TPOT_TEMPLATE", (8, 4, 4))
    # enough TPOT traffic to outlast the three 0.1 s cooldowns and the
    # saturated tick after them: 64 prompts end in 0.31-0.57 s here
    monkeypatch.setattr(smoke, "AP_TPOT_PROMPTS", 128)
    monkeypatch.setattr(smoke, "AP_HBM_TEMPLATE", (8, 3, 2))
    # a higher floor: the relax back to 512 is 64 one-unit probes, not 448
    monkeypatch.setattr(smoke, "AP_STORM_AUTOPILOT",
                        dict(smoke.AP_STORM_AUTOPILOT, prefill_budget_min=448))
    cfg = _smoke_serve_cfg()
    mgr = ServerCheckpointManager(FileStore(tmp_path / "store"), cfg.run_uuid)
    mgr.save_round(3, *params_to_ndarrays(init_params(cfg.model, seed=3)),
                   server_state={"server_round": 3})
    fed = {"store": str(tmp_path / "store"), "run_uuid": cfg.run_uuid, "served_round": 3}
    rec = smoke.autopilot_phase(torch, rpa, np, fed, tie=1e-5, cfg=cfg, device="cpu",
                                work=tmp_path / "ap")
    storm, tpot, hbm = rec["storm"], rec["tpot"], rec["hbm"]
    assert storm["first_actuation"]["old"] == 512 and 448 <= storm["lowest_budget"] < 512
    assert storm["final_budget"] == 512 and storm["relaxes"] >= 1 and storm["rejected"] == 0
    assert storm["retrace"]["violations"] == [] and storm["tick_warnings"] == []
    assert storm["planted"]["violations"] == [("serve/tick", 1)]
    assert storm["statusz_decisions"] > 0 and storm["lock_order"]["tracked_locks"] > 0
    assert tpot["actuations"] == [(4, 3), (3, 2), (2, 1)]
    assert tpot["saturated"] == 1 and tpot["final_k_max"] == 1
    assert len(hbm["episodes"]) == 2
    for ep in hbm["episodes"]:
        assert len(ep["alerts"]) == len(ep["reclaims"]) == 1 and ep["cached_blocks_before"] > 0
        assert ep["reclaims"][0]["new"] > ep["reclaims"][0]["old"]
    assert not (tmp_path / "ap").exists()


def test_chip_smoke_autopilot_fleet_leg_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.autopilot_fleet_leg`` (phase 17 (d)) with two
    ``--device cpu`` replica children: the ramped replica reports its serve
    plane degraded by ``alert/hbm_growth`` (the serve CLI installs
    ``photon.chaos``), the router approves one restart for it and none for
    the other, the replica recycles and reports live again, no request
    fails, and the router's ``/statusz`` carries the decision."""
    from photon_tpu_torch.adapters.checkpoint import adapter_key
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.models.mpt import init_params
    from tests.test_torch_adapter_serve import _nonzero_adapter, _spec
    from tests.test_torch_compression import _chip_smoke

    smoke = _chip_smoke()
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the replica children's
    monkeypatch.setattr(smoke, "FLEET_NEW", 8)
    monkeypatch.setattr(smoke, "FLEET_COHORT_PROMPT", (4, 12))
    cfg = _smoke_serve_cfg()
    cfg.run_uuid = "autopilot-fleet"
    cfg.model.max_seq_len = 64
    ad = cfg.photon.adapters
    ad.enabled, ad.rank, ad.pool_size, ad.cohorts = True, 4, 2, {"a": [], "b": [], "c": []}
    cfg.photon.serve.fleet.report_poll_s, cfg.photon.serve.fleet.report_timeout_s = 0.2, 3.0
    cfg.validate("cpu", serving=True)
    cfg.to_yaml(tmp_path / "resolved.yaml")
    base = init_params(cfg.model, seed=3)
    spec = _spec(cfg, base)
    mgr = ServerCheckpointManager(FileStore(tmp_path / "store"), cfg.run_uuid)
    mgr.save_round(1, *params_to_ndarrays(base), strategy_state={
        adapter_key(c): _nonzero_adapter(spec, 10 + i) for i, c in enumerate("abc")},
        server_state={"server_round": 1})
    rec = smoke.autopilot_fleet_leg(np, {"store": str(tmp_path / "store"),
                                         "run": cfg.run_uuid,
                                         "config": str(tmp_path / "resolved.yaml")},
                                    device="cpu", work=tmp_path / "apf")
    assert rec["approvals"] == {"ramp": 1, "steady": 0}
    assert rec["recycles"] == {"ramp": 1.0, "steady": 0.0} and not rec["failed"]
    assert rec["ramp_health"][0]["reason"] == ALERT_HBM_GROWTH
    assert rec["approval_to_live_s"] > 0 and rec["requests"] > 0
    assert not (tmp_path / "apf").exists()
