"""Elastic collective rounds on the port: stage deadlines, gang
reconfiguration, quorum and the host-fallback floor, chaos crash phases
(``photon_tpu_torch/federation/collective_round.py``). One case for each
of ``tests/test_collective_elastic.py``'s, on the same configs (d32, 1
layer, fp32), under the port's lock-order recorder and retrace sentinel
where JAX's run under its own.

Tolerances: degraded rounds bit for bit against the survivors-only host
oracle (``aggregate_inplace`` and the FedAvg step); a reconfigured round
against it rtol 1e-5 / atol 1e-6 (fp32 sums against the fp64 fold); the
port's runner against JAX's on the same crash rtol 1e-3 / atol 5e-5.
"""

import pathlib
import time

import numpy as np
import pytest
import torch

from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu_torch import chaos, telemetry
from photon_tpu_torch.config.schema import Config, TelemetryConfig
from photon_tpu_torch.federation.collective_round import CollectiveFedRunner, StageDeadlineError
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

RUN_TOL = dict(rtol=1e-3, atol=5e-5)


@pytest.fixture(autouse=True)
def _clean_planes():
    yield
    chaos.uninstall()
    telemetry.uninstall()


def _jcfg(tmp_path, strategy="fedavg", n_clients=4, quantization="off", device_opt=False,
          n_rounds=3, name="run") -> JaxConfig:
    cfg = JaxConfig()
    cfg.model.d_model = 32
    cfg.model.n_layers = 1
    cfg.model.n_heads = 2
    cfg.model.max_seq_len = 16
    cfg.model.vocab_size = 64
    cfg.model.attn_impl = "xla"
    cfg.model.compute_dtype = "float32"
    cfg.train.global_batch_size = 2
    cfg.train.device_microbatch_size = 2
    cfg.fl.n_total_clients = n_clients
    cfg.fl.n_clients_per_round = n_clients
    cfg.fl.n_rounds = n_rounds
    cfg.fl.local_steps = 1
    cfg.fl.eval_interval_rounds = 0
    cfg.fl.strategy_name = strategy
    cfg.fl.server_learning_rate = 1.0 if strategy == "fedavg" else 0.01
    cfg.dataset.synthetic = True
    cfg.photon.checkpoint = False
    cfg.photon.comm_stack.collective = True
    cfg.photon.comm_stack.shm = False
    cfg.photon.comm_stack.collective_quantization = quantization
    cfg.photon.comm_stack.collective_q8_block = 64
    cfg.photon.comm_stack.collective_device_optimizer = device_opt
    cfg.photon.save_path = str(tmp_path / name)
    cfg.run_uuid = "collective-elastic"
    return cfg.validate()


def _cfg(tmp_path, **kw) -> Config:
    return Config.from_dict(_jcfg(tmp_path, **kw).to_dict()).validate()


def _runner(cfg, cids=None):
    return CollectiveFedRunner(cfg, cids if cids is not None else
                               list(range(cfg.fl.n_total_clients)), device="cpu")


def _oracle_params(params_before, lr, landed, cohort):
    from photon_tpu_torch.strategy.aggregation import aggregate_inplace
    from photon_tpu_torch.strategy.optimizers import FedAvgEff

    avg, n_total = aggregate_inplace(([a.copy() for a in landed[cid][0]], landed[cid][1])
                                     for cid in cohort)
    oracle = FedAvgEff(server_learning_rate=lr)
    oracle.initialize([p.copy() for p in params_before])
    oracle.apply_average(0, avg, n_total, len(cohort))
    return oracle.current_parameters


def _bare_runner(clock=time.monotonic, timeout=0.0):
    r = object.__new__(CollectiveFedRunner)
    r.clock = clock
    r.stage_timeout_s = timeout
    r._abandoned_workers = []
    return r


def _spy(monkeypatch, name):
    """Record what the runner's ``name`` got (the cohort and a copy of the
    landed deltas) and run it."""
    seen = {}
    real = getattr(CollectiveFedRunner, name)

    def spy(self, server_round, *args):
        landed = args[-1]
        if len(args) == 2:
            seen["cohort"] = args[0]
        seen["landed"] = {cid: ([a.copy() for a in arrs], n) for cid, (arrs, n) in landed.items()}
        return real(self, server_round, *args)

    monkeypatch.setattr(CollectiveFedRunner, name, spy)
    return seen


def _fail_fits(monkeypatch, runner, cids, rnd=2):
    from photon_tpu_torch.federation.messages import FitRes

    real = runner.runtime.fit

    def fit(ins, cid):
        if ins.server_round == rnd and cid in cids:
            return FitRes(server_round=ins.server_round, cid=cid, params=None,
                          error="simulated node loss")
        return real(ins, cid)

    monkeypatch.setattr(runner.runtime, "fit", fit)


# -- stage deadlines ------------------------------------------------------------------


def test_stage_deadline_derived_from_injected_clock():
    r = _bare_runner(clock=lambda: 100.0, timeout=7.0)
    assert r._stage_deadline() == 107.0
    r.stage_timeout_s = 0.0
    assert r._stage_deadline() is None


def test_expired_deadline_preempts_without_running_the_stage():
    now = [0.0]
    r = _bare_runner(clock=lambda: now[0], timeout=5.0)
    deadline = r._stage_deadline()
    now[0] = 6.0
    ran = []
    with pytest.raises(StageDeadlineError) as ei:
        r._run_stage("exchange", lambda: ran.append(1), deadline)
    assert ei.value.stage == "exchange" and not ran


def test_wedged_stage_abandoned_at_the_deadline():
    r = _bare_runner(timeout=0.3)
    t0 = time.monotonic()
    with pytest.raises(StageDeadlineError):
        r._run_stage("exchange", lambda: time.sleep(5.0), r._stage_deadline())
    assert time.monotonic() - t0 < 2.0
    assert len(r._abandoned_workers) == 1


def test_stage_errors_propagate_and_no_deadline_runs_inline():
    r = _bare_runner(timeout=0.5)
    with pytest.raises(ValueError, match="boom"):
        r._run_stage("update", lambda: (_ for _ in ()).throw(ValueError("boom")),
                     r._stage_deadline())
    r.stage_timeout_s = 0.0
    assert r._run_stage("stack", lambda: 42, r._stage_deadline()) == 42


def test_surviving_cohort_is_global_across_controllers():
    from photon_tpu_torch.federation.membership import LivenessTracker

    r = object.__new__(CollectiveFedRunner)
    cfg = Config()
    cfg.fl.n_total_clients = 4
    r.cfg = cfg
    r._local_cids = frozenset([0, 1])
    r.liveness = LivenessTracker()
    row = ([np.zeros(2, np.float32)], 1)
    assert r._surviving_cohort({0: row, 1: row}) == (0, 1, 2, 3)
    assert r._surviving_cohort({0: row}) == (0, 2, 3)
    for _ in range(2):
        r.liveness.observe_miss("client3")
    assert r._surviving_cohort({0: row, 1: row}) == (0, 1, 2)
    r._local_cids = frozenset([0, 1, 2, 3])
    assert r._surviving_cohort({0: row, 2: row}) == (0, 2)


# -- reconfiguration -------------------------------------------------------------------


def test_fit_crash_reconfigures_then_readmits_full_strength(tmp_path):
    """A client crashed mid-fit in round 2 (chaos, one-shot) leaves the
    cohort; the round folds over the survivors and the device plane is
    reseeded; round 3 runs the full cohort. The same crash in JAX's runner
    gives the same paths and, from the same start, parameters within the
    run tolerance."""
    from photon_tpu import chaos as jchaos
    from photon_tpu.federation.collective_round import CollectiveFedRunner as JaxRunner
    from photon_tpu_torch.analysis import runtime as rt

    def _client_crash(code):
        raise RuntimeError(f"simulated SIGKILL ({code})")

    jcfg = _jcfg(tmp_path, strategy="fedadam", n_clients=3, device_opt=True, name="jax")
    jcfg.photon.chaos.enabled = True
    jcfg.photon.chaos.crash_phase = "mid-fit"
    jcfg.photon.chaos.crash_round = 2
    jcfg.photon.chaos.crash_marker = str(tmp_path / "jax.marker")
    jcfg.validate()
    jchaos.install(jcfg.photon.chaos, scope="collective0", crash_fn=_client_crash)
    try:
        jrunner = JaxRunner(jcfg, [0, 1, 2])
        initial = [p.copy() for p in jrunner.strategy.current_parameters]
        with pytest.warns(UserWarning, match="dropped from the round's cohort"):
            for rnd in (1, 2, 3):
                jrunner.run_round(rnd)
    finally:
        jchaos.uninstall()

    cfg = Config.from_dict(jcfg.to_dict())
    cfg.photon.save_path = str(tmp_path / "port")
    cfg.photon.chaos.crash_marker = str(tmp_path / "port.marker")
    cfg.validate()
    import photon_tpu_torch.federation.collective_round as cr

    windows = []
    real_absorb = cr.absorb_compiles

    def absorb(label):
        windows.append(label)
        return real_absorb(label)

    cr.absorb_compiles = absorb
    recorder = rt.install_lock_order()
    sentinel = rt.install_retrace_sentinel()
    try:
        chaos.install(cfg.photon.chaos, scope="collective0", crash_fn=_client_crash)
        runner = _runner(cfg)
        runner.load_server_state(initial)
        sentinel.mark_steady_after(1)
        with pytest.warns(UserWarning, match="dropped from the round's cohort"):
            m1 = runner.run_round(1)
            m2 = runner.run_round(2)
        m3 = runner.run_round(3)
        sentinel.check("collective/elastic-e2e")
        recorder.check()
    finally:
        cr.absorb_compiles = real_absorb
        rt.uninstall_retrace_sentinel()
        rt.uninstall_lock_order()
    assert m1["server/collective_stragglers"] == 0.0
    assert m2["server/collective_stragglers"] == 1.0
    assert m2["server/collective_degraded_rounds"] == 0.0 and m2["server/n_clients"] == 2.0
    assert m3["server/collective_stragglers"] == 0.0 and m3["server/n_clients"] == 3.0
    assert runner.aggregation_paths == jrunner.aggregation_paths == {
        1: "collective", 2: "collective_reconfigured", 3: "collective"}
    # the survivors' attempt and the reseed ran inside absorb windows (a
    # kernel library built there would be forgiven; none is on the CPU)
    assert windows == ["collective/reconfig", "collective/reseed"]
    assert sentinel.violations == []
    assert runner.device_plane.t == 3
    h = runner.liveness.nodes["client0"]
    assert h.state == "live" and h.misses == 0
    for name in ("server/collective_stragglers", "server/collective_degraded_rounds",
                 "server/collective_reconfig_time"):
        assert len(runner.history.series(name)) == 3, name
    for a, b in zip(runner.strategy.current_parameters, jrunner.strategy.current_parameters):
        np.testing.assert_allclose(a, b, **RUN_TOL)


class SimKill(BaseException):
    """In-process stand-in for ``os._exit(137)``: a BaseException the
    ladder must not absorb."""


@pytest.mark.parametrize("quantization", ["off", "q8"])
def test_sigkill_mid_collective_degrades_bitexact_and_readmits(tmp_path, quantization,
                                                               monkeypatch):
    import photon_tpu_torch.federation.collective_round as cr

    cfg = _cfg(tmp_path, n_clients=4, quantization=quantization)
    cfg.photon.comm_stack.collective_retry_budget = 0
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.crash_phase = "mid-fit"
    cfg.photon.chaos.crash_round = 2
    cfg.photon.chaos.crash_marker = str(tmp_path / "crash.marker")
    cfg.validate()
    events = tmp_path / "events.jsonl"
    telemetry.install(TelemetryConfig(enabled=True), scope="server", events_path=str(events))

    def _client_crash(code):
        raise RuntimeError(f"simulated SIGKILL ({code})")

    inj = chaos.install(cfg.photon.chaos, scope="collective0", crash_fn=_client_crash)
    runner = _runner(cfg)
    real_fold = cr.hierarchical_weighted_average
    state = {"round": 0}

    def wedging_fold(*args, **kwargs):
        if state["round"] == 2:
            time.sleep(5.0)
        return real_fold(*args, **kwargs)

    monkeypatch.setattr(cr, "hierarchical_weighted_average", wedging_fold)
    state["round"] = 1
    m1 = runner.run_round(1)
    runner.stage_timeout_s = 0.5
    before = [p.copy() for p in runner.strategy.current_parameters]
    seen = _spy(monkeypatch, "_host_fallback")
    state["round"] = 2
    with pytest.warns(UserWarning, match="degrading to the host-plane fold"):
        m2 = runner.run_round(2)
    degraded = [p.copy() for p in runner.strategy.current_parameters]
    state["round"] = 3
    m3 = runner.run_round(3)
    # the ladder did not stall to the wedge's 5 s: the 0.5 s deadline cut it
    assert m2["server/collective_agg_time"] < 4.0 and inj.counts["crash"] == 1
    assert m2["server/collective_stragglers"] == 1.0
    assert m2["server/collective_degraded_rounds"] == 1.0
    assert m2["server/collective_reconfig_time"] > 0.0
    assert m2["server/n_clients"] == 3.0 and m2["server/collective_wire_bytes"] == 0.0
    assert runner.aggregation_paths[2] == "host_fallback" and runner.degraded_rounds_total == 1
    cohort = seen["cohort"]
    assert len(cohort) == 3 and 0 not in cohort
    for got, want in zip(degraded, _oracle_params(before, 1.0, seen["landed"], cohort)):
        np.testing.assert_array_equal(got, want)
    for m in (m1, m3):
        assert m["server/collective_stragglers"] == 0.0
        assert m["server/collective_degraded_rounds"] == 0.0
    assert m3["server/n_clients"] == 4.0 and runner.aggregation_paths[3] == "collective"
    control = runner.control_state_for_checkpoint()
    assert control["aggregation_paths"] == {1: "collective", 2: "host_fallback", 3: "collective"}
    resumed = _runner(_cfg(tmp_path / "resumed", n_clients=4, quantization=quantization))
    resumed.load_server_state(runner.strategy.current_parameters,
                              runner.state_for_checkpoint(), control)
    assert resumed.aggregation_paths[2] == "host_fallback"
    assert resumed.server_steps_cumulative == runner.server_steps_cumulative
    telemetry.uninstall()
    kinds = [e["kind"] for e in telemetry.read_events_jsonl(str(events))]
    assert {"collective/straggler", "collective/reconfig", "collective/degraded"} <= set(kinds)
    assert any(k.startswith("chaos/") for k in kinds)


def test_liveness_edge_mid_round_excludes_client_with_parity(tmp_path, monkeypatch):
    runner = _runner(_cfg(tmp_path, n_clients=4))
    runner.run_round(1)
    before = [p.copy() for p in runner.strategy.current_parameters]
    seen = {}
    real = CollectiveFedRunner._aggregate_elastic

    def edge_then_agg(self, server_round, landed):
        if not seen:
            self.liveness.observe_miss(self._client_node_id(2))
            seen.update({cid: ([a.copy() for a in arrs], n) for cid, (arrs, n) in landed.items()})
        return real(self, server_round, landed)

    monkeypatch.setattr(CollectiveFedRunner, "_aggregate_elastic", edge_then_agg)
    m2 = runner.run_round(2)
    assert m2["server/collective_stragglers"] == 1.0
    assert m2["server/collective_degraded_rounds"] == 0.0 and m2["server/n_clients"] == 3.0
    assert runner.aggregation_paths[2] == "collective_reconfigured"
    for got, want in zip(runner.strategy.current_parameters,
                         _oracle_params(before, 1.0, seen, (0, 1, 3))):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    m3 = runner.run_round(3)
    assert m3["server/collective_stragglers"] == 0.0 and m3["server/n_clients"] == 4.0
    assert runner.liveness.nodes["client2"].state == "live"


def test_survivors_only_fold_parity_off_and_q8_bound():
    import jax.numpy as jnp

    from photon_tpu.parallel import collective_agg as jca
    from photon_tpu_torch.parallel.collective_agg import (
        hierarchical_weighted_average,
        make_hierarchical_mesh,
        stack_for_clients,
    )
    from photon_tpu_torch.strategy.aggregation import aggregate_inplace
    from tests.test_torch_collective_agg import _client_params, _expected_q8_bound

    block = 16
    clients = [_client_params(90 + i) for i in range(4)]
    counts = np.asarray([5, 11, 2, 31], np.int32)
    survivors = [0, 2, 3]
    surv = [clients[i] for i in survivors]
    sc = counts[survivors]
    mesh = make_hierarchical_mesh(3, 1, device="cpu")
    stacked = stack_for_clients(surv, mesh)
    off = hierarchical_weighted_average(stacked, sc, mesh)
    host_avg, host_total = aggregate_inplace(([c["b"], c["w"]], int(n)) for c, n in zip(surv, sc))
    assert host_total == int(sc.sum())
    np.testing.assert_allclose(off["w"].numpy(), host_avg[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(off["b"].numpy(), host_avg[0], rtol=1e-5, atol=1e-6)
    q8 = hierarchical_weighted_average(stacked, sc, mesh, quantization="q8", block=block)
    jmesh = jca.make_hierarchical_mesh(3, 1)
    jq8 = jca.hierarchical_weighted_average(jca.stack_for_clients(surv, jmesh), jnp.asarray(sc),
                                            jmesh, quantization="q8", block=block)
    for key in ("w", "b"):
        bound = _expected_q8_bound(surv, sc, key, 1, block)
        err = np.abs(q8[key].numpy().astype(np.float64) - off[key].numpy())
        assert np.all(err <= bound + 1e-7), key
        np.testing.assert_allclose(q8[key].numpy(), np.asarray(jq8[key]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("phase", ["pre-exchange", "mid-exchange", "pre-update"])
def test_collective_crash_phase_kills_controller_then_respawn_resumes(tmp_path, phase):
    cfg = _cfg(tmp_path, n_clients=2)
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.crash_phase = phase
    cfg.photon.chaos.crash_round = 2
    cfg.photon.chaos.crash_marker = str(tmp_path / "crash.marker")
    cfg.validate()

    def _exit(code):
        raise SimKill(code)

    inj = chaos.install(cfg.photon.chaos, scope="collective0", crash_fn=_exit)
    runner = _runner(cfg)
    runner.run_round(1)
    params_r1 = [p.copy() for p in runner.strategy.current_parameters]
    state_r1 = runner.state_for_checkpoint()
    control_r1 = runner.control_state_for_checkpoint()
    with pytest.raises(SimKill):
        runner.run_round(2)
    assert inj.counts["crash"] == 1 and pathlib.Path(cfg.photon.chaos.crash_marker).exists()
    respawn = _runner(cfg)
    respawn.load_server_state(params_r1, state_r1, control_r1)
    m2 = respawn.run_round(2)
    assert m2["server/collective_stragglers"] == 0.0
    assert inj.counts["crash"] == 1 and respawn.aggregation_paths[2] == "collective"


# -- quorum and zero-landed floors --------------------------------------------------------


def test_below_quorum_degrades_directly_bitexact(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, n_clients=4)
    cfg.photon.comm_stack.collective_quorum = 0.75
    runner = _runner(cfg.validate())
    runner.run_round(1)
    _fail_fits(monkeypatch, runner, (1, 2))
    before = [p.copy() for p in runner.strategy.current_parameters]
    seen = _spy(monkeypatch, "_host_fallback")
    with pytest.warns(UserWarning, match="below quorum"):
        m2 = runner.run_round(2)
    assert m2["server/collective_stragglers"] == 2.0
    assert m2["server/collective_degraded_rounds"] == 1.0
    assert m2["server/collective_reconfig_time"] == 0.0
    assert seen["cohort"] == (0, 3)
    for got, want in zip(runner.strategy.current_parameters,
                         _oracle_params(before, 1.0, seen["landed"], (0, 3))):
        np.testing.assert_array_equal(got, want)


def test_zero_landed_round_recorded_failed_never_aborts(tmp_path, monkeypatch):
    runner = _runner(_cfg(tmp_path, n_clients=2))
    runner.run_round(1)
    before = [p.copy() for p in runner.strategy.current_parameters]
    steps = runner.server_steps_cumulative
    _fail_fits(monkeypatch, runner, (0, 1))
    with pytest.warns(UserWarning, match="no client deltas landed"):
        m2 = runner.run_round(2)
    assert m2["server/round_failed"] == 1.0 and m2["server/collective_stragglers"] == 2.0
    assert runner.aggregation_paths[2] == "failed"
    for got, want in zip(runner.strategy.current_parameters, before):
        np.testing.assert_array_equal(got, want)
    assert runner.server_steps_cumulative == steps
    m3 = runner.run_round(3)
    assert m3["server/collective_stragglers"] == 0.0 and m3["server/n_clients"] == 2.0


def test_eval_survives_client_failure_and_wedged_exchange(tmp_path, monkeypatch):
    import photon_tpu_torch.federation.collective_round as cr
    from photon_tpu_torch.federation.messages import EvaluateRes

    runner = _runner(_cfg(tmp_path, n_clients=2))
    runner.run_round(1)
    e0 = runner.evaluate_round(1)
    assert e0["server/eval_samples"] > 0
    real_eval = runner.runtime.evaluate

    def failing_eval(ins, cid):
        if cid == 0:
            return EvaluateRes(server_round=ins.server_round, cid=cid,
                               error="simulated eval node loss")
        return real_eval(ins, cid)

    monkeypatch.setattr(runner.runtime, "evaluate", failing_eval)
    with pytest.warns(UserWarning, match="scored with zero weight"):
        e1 = runner.evaluate_round(1)
    assert 0 < e1["server/eval_samples"] < e0["server/eval_samples"]
    assert np.isfinite(e1["server/eval_loss"])
    runner.stage_timeout_s = 0.4
    real_fold = cr.hierarchical_weighted_average

    def wedging_fold(*args, **kwargs):
        time.sleep(3.0)
        return real_fold(*args, **kwargs)

    monkeypatch.setattr(cr, "hierarchical_weighted_average", wedging_fold)
    with pytest.warns(UserWarning, match="local weighted mean"):
        e2 = runner.evaluate_round(1)
    assert e2["server/eval_samples"] == e1["server/eval_samples"]
    assert e2["server/eval_loss"] == pytest.approx(e1["server/eval_loss"], rel=1e-5)


def test_update_stage_wedge_never_double_applies(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, strategy="fedadam", n_clients=2, device_opt=True)
    ref = _runner(cfg)
    ref.run_round(1)
    ref.run_round(2)
    runner = _runner(cfg)
    runner.run_round(1)
    assert runner.device_plane.t == 1
    real_fetch = runner.device_plane.params_host
    wedges = []

    def wedge_once():
        if not wedges:
            wedges.append(1)
            time.sleep(3.0)
        return real_fetch()

    monkeypatch.setattr(runner.device_plane, "params_host", wedge_once)
    runner.stage_timeout_s = 0.4
    with pytest.warns(UserWarning, match="reconfiguring"):
        m2 = runner.run_round(2)
    assert runner.device_plane.t == 2
    assert m2["server/collective_degraded_rounds"] == 0.0
    assert m2["server/collective_stragglers"] == 0.0
    assert runner.aggregation_paths[2] == "collective"
    for got, want in zip(runner.strategy.current_parameters, ref.strategy.current_parameters):
        np.testing.assert_array_equal(got, want)
    time.sleep(3.2)  # the abandoned fetch finishes: the strategy stays
    for got, want in zip(runner.strategy.current_parameters, ref.strategy.current_parameters):
        np.testing.assert_array_equal(got, want)


def test_transient_wedge_retries_within_budget(tmp_path, monkeypatch):
    import photon_tpu_torch.federation.collective_round as cr

    cfg = _cfg(tmp_path, n_clients=2)
    assert cfg.photon.comm_stack.collective_retry_budget == 1
    runner = _runner(cfg)
    runner.run_round(1)
    runner.stage_timeout_s = 0.4
    real_fold = cr.hierarchical_weighted_average
    wedges = []

    def wedge_once(*args, **kwargs):
        if not wedges:
            wedges.append(1)
            time.sleep(3.0)
        return real_fold(*args, **kwargs)

    monkeypatch.setattr(cr, "hierarchical_weighted_average", wedge_once)
    with pytest.warns(UserWarning, match="reconfiguring"):
        m2 = runner.run_round(2)
    assert m2["server/collective_degraded_rounds"] == 0.0
    assert m2["server/collective_stragglers"] == 0.0
    assert m2["server/collective_reconfig_time"] > 0.0
    assert runner.aggregation_paths[2] == "collective" and runner.reconfigs_total == 1


def test_group_timeouts_and_an_abandoned_group_is_never_reused(tmp_path):
    """The port's own rule (no JAX twin): a cohort group gets a timeout no
    longer than the stage deadline, and the group of a failed attempt is
    set aside and replaced, never used again."""
    import datetime

    r = object.__new__(CollectiveFedRunner)
    r.stage_timeout_s = 10.0
    assert r._group_timeout() == datetime.timedelta(seconds=10.0)
    r.stage_timeout_s = 0.0
    assert r._group_timeout() is None
    from photon_tpu_torch.parallel.collective_agg import make_client_mesh

    mesh = make_client_mesh(2, devices=["cpu", None], owners=[0, 1], rank=0)
    sentinel = object()
    mesh.group = sentinel
    r._abandoned_groups = []
    r._abandon_group(mesh)
    assert mesh.group is None and r._abandoned_groups == [sentinel]
    with pytest.raises(RuntimeError, match="no process group is bound"):
        from photon_tpu_torch.parallel.collective_agg import _all_reduce

        _all_reduce(mesh, torch.ones(1))


@pytest.mark.parametrize("keys,want", [
    ([("h", "cuda", 0), ("h", "cuda", 1)], "nccl"),
    ([("h", "cuda", 0), ("h", "cuda", 0)], "gloo"),
    ([("h", "cuda", 0), ("g", "cuda", 0)], "nccl"),
    ([("h", "cpu", 0), ("h", "cpu", 0)], "gloo"),
    ([("h", "cuda", 0), ("h", "cpu", 0)], "gloo"),
], ids=["own-cards", "shared-card", "two-hosts", "cpu", "mixed"])
def test_backend_rule(monkeypatch, keys, want):
    """The port's rule (no JAX twin): NCCL when every process of the group
    drives a card no other of its processes drives, gloo otherwise (the
    CPU, or two ranks on one GPU, which NCCL refuses)."""
    import torch.distributed as dist

    from photon_tpu_torch.parallel.collective_agg import group_backend

    def gather(out, mine, group=None):
        out[:] = keys

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: len(keys))
    monkeypatch.setattr(dist, "all_gather_object", gather)
    assert group_backend(torch.device("cpu")) == want
