"""The port's asynchronous runner against the JAX package's, and adapter
round checkpoints across the packages.

On jax 0.9.0, ``photon_tpu``'s telemetry ``uninstall`` calls
``jax._src.monitoring._unregister_event_duration_listener_by_callback``,
which that release renamed ``unregister_event_duration_listener`` (the
same one-callback function). The fixture here aliases the old name for the
duration of each case (``monkeypatch``), so JAX's runners and their
telemetry teardown run; nothing under ``photon_tpu/`` changes.

Each async case starts the port's ``AsyncFedRunner`` from the JAX
runner's initial parameters (the packages draw their random inits
differently) on the same config (d32, 2 layers, fp32), and holds it to
JAX's on the version clock: versions, rejects, drops and stalls exactly;
each version's staleness and discount; the parameters within the
collective plane's run tolerance (rtol 1e-3 / atol 5e-5, JAX's
``tests/test_collective_round.py``). The simulated delivery clock is
deterministic in both packages, so the two runs fold the same deltas in
the same order.
"""

import numpy as np
import pytest

from photon_tpu.config.schema import Config as JaxConfig
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

RUN_TOL = dict(rtol=1e-3, atol=5e-5)


@pytest.fixture(autouse=True)
def _jax_telemetry_alias(monkeypatch):
    """Let JAX's telemetry ``uninstall`` run on jax 0.9.0, and leave both
    packages' chaos and telemetry planes as they were found."""
    import jax._src.monitoring as mon

    from photon_tpu import chaos as jax_chaos
    from photon_tpu import telemetry as jax_telemetry
    from photon_tpu_torch import chaos, telemetry

    if not hasattr(mon, "_unregister_event_duration_listener_by_callback"):
        monkeypatch.setattr(mon, "_unregister_event_duration_listener_by_callback",
                            mon.unregister_event_duration_listener, raising=False)
    yield
    for plane in (chaos, telemetry, jax_chaos, jax_telemetry):
        plane.uninstall()


def test_jax_telemetry_uninstall_runs_with_the_alias(tmp_path):
    from photon_tpu import telemetry as jax_telemetry
    from photon_tpu.config.schema import TelemetryConfig

    jax_telemetry.install(TelemetryConfig(enabled=True), scope="server",
                          events_path=str(tmp_path / "events.jsonl"))
    jax_telemetry.uninstall()
    assert jax_telemetry.active() is None


def _cfg_dict(tmp_path, name, n_clients=2, K=0, min_arrivals=1, max_staleness=4,
              n_rounds=3, chaos=None) -> dict:
    cfg = JaxConfig()
    cfg.model.d_model, cfg.model.n_layers, cfg.model.n_heads = 32, 2, 2
    cfg.model.max_seq_len, cfg.model.vocab_size = 16, 64
    cfg.model.attn_impl, cfg.model.compute_dtype = "xla", "float32"
    cfg.train.global_batch_size = cfg.train.device_microbatch_size = 4
    cfg.fl.n_total_clients = cfg.fl.n_clients_per_round = n_clients
    cfg.fl.n_rounds, cfg.fl.local_steps, cfg.fl.eval_interval_rounds = n_rounds, 2, 0
    cfg.fl.strategy_name, cfg.fl.server_learning_rate = "fedavg", 1.0
    cfg.dataset.synthetic = True
    cfg.photon.checkpoint = False
    cs = cfg.photon.comm_stack
    cs.collective, cs.shm, cs.collective_replica = True, False, 2
    cs.collective_q8_block, cs.collective_device_optimizer = 64, True
    ar = cfg.photon.async_rounds
    ar.enabled, ar.buffer_size, ar.min_arrivals = True, K, min_arrivals
    ar.max_staleness, ar.staleness_power = max_staleness, 1.0
    if chaos:
        cfg.photon.chaos.enabled = True
        for k, v in chaos.items():
            setattr(cfg.photon.chaos, k, v)
    cfg.photon.save_path = str(tmp_path / name)
    cfg.run_uuid = "async-parity"
    return cfg.validate().to_dict()


def _crash(code):
    raise RuntimeError(f"simulated SIGKILL ({code})")


def _pair(tmp_path, cids, **kw):
    """(JAX's runner, the port's from JAX's initial parameters); chaos, if
    configured, installed in both packages (each its own crash marker)."""
    from photon_tpu import chaos as jax_chaos
    from photon_tpu.federation.async_round import AsyncFedRunner as JaxAsync
    from photon_tpu_torch import chaos
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.federation.async_round import AsyncFedRunner

    jd, pd = _cfg_dict(tmp_path, "jax", **kw), _cfg_dict(tmp_path, "port", **kw)
    if kw.get("chaos", {}).get("crash_marker"):
        jd["photon"]["chaos"]["crash_marker"] = str(tmp_path / "jax.marker")
        pd["photon"]["chaos"]["crash_marker"] = str(tmp_path / "port.marker")
    jcfg, pcfg = JaxConfig.from_dict(jd).validate(), Config.from_dict(pd).validate()
    if kw.get("chaos"):
        jax_chaos.install(jcfg.photon.chaos, scope="collective0", crash_fn=_crash)
        chaos.install(pcfg.photon.chaos, scope="collective0", crash_fn=_crash)
    jrunner = JaxAsync(jcfg, cids)
    runner = AsyncFedRunner(pcfg, cids, device="cpu")
    runner.load_server_state([p.copy() for p in jrunner.strategy.current_parameters])
    return jrunner, runner


def _same_clock(jrunner, runner):
    for attr in ("version", "rejected_total", "dropped_total", "stalls_total",
                 "server_steps_cumulative"):
        assert getattr(runner, attr) == getattr(jrunner, attr), attr
    for key in ("server/async_staleness_max", "server/async_discount_mean"):
        want = [v for _, v in jrunner.history.to_dict().get(key, [])]
        got = [v for _, v in runner.history.to_dict().get(key, [])]
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
    for g, j in zip(runner.strategy.current_parameters, jrunner.strategy.current_parameters):
        np.testing.assert_allclose(g, j, **RUN_TOL)


def test_zero_staleness_versions_match_jax(tmp_path):
    """The buffer the whole cohort, equal speeds: 3 versions at staleness 0."""
    jrunner, runner = _pair(tmp_path, [0, 1])
    jrunner.run_versions(3, eval_every=0)
    runner.run_versions(3, eval_every=0)
    assert runner.version == 3
    _same_clock(jrunner, runner)


def test_stale_reject_matches_jax(tmp_path):
    """K=1, max staleness 0, client 1 four times slower: one reject (at
    staleness 3) and a fresh re-dispatch in both packages."""
    jrunner, runner = _pair(tmp_path, [0, 1], K=1, max_staleness=0, n_rounds=5,
                            chaos={"fit_delay_factor": 4.0, "fit_delay_cid": 1})
    jrunner.run_versions(5, eval_every=0)
    runner.run_versions(5, eval_every=0)
    assert runner.version == 5 and runner.rejected_total == 1
    _same_clock(jrunner, runner)


def test_sigkill_drop_matches_jax(tmp_path):
    """3 clients, K=2, one fit killed mid-fit at version 2: the delta is
    dropped and the clock reaches 4 on the survivors in both packages."""
    crash = {"crash_phase": "mid-fit", "crash_round": 2, "crash_marker": "set per package"}
    jrunner, runner = _pair(tmp_path, [0, 1, 2], n_clients=3, K=2, n_rounds=4, chaos=crash)
    with pytest.warns(UserWarning, match="delta is dropped"):
        jrunner.run_versions(4, eval_every=0)
    with pytest.warns(UserWarning, match="delta is dropped"):
        runner.run_versions(4, eval_every=0)
    assert runner.version == 4 and runner.dropped_total == 1
    _same_clock(jrunner, runner)


def test_min_arrivals_stall_matches_jax(tmp_path):
    """K=2, min arrivals 2, one client killed at its first fit: the clock
    holds at 0 with a stall and a drop in both packages."""
    crash = {"crash_phase": "mid-fit", "crash_round": 1, "crash_marker": "set per package"}
    jrunner, runner = _pair(tmp_path, [0, 1], K=2, min_arrivals=2, n_rounds=2, chaos=crash)
    with pytest.warns(UserWarning):
        jrunner.run_versions(2, eval_every=0)
    with pytest.warns(UserWarning):
        runner.run_versions(2, eval_every=0)
    assert runner.version == 0 and runner.stalls_total >= 1 and runner.dropped_total == 1
    _same_clock(jrunner, runner)


def _adapter_dict(tmp_path, name) -> dict:
    d = _cfg_dict(tmp_path, name, n_clients=4, n_rounds=2)
    d["photon"]["async_rounds"]["enabled"] = False
    d["fl"].update(strategy_name="fedadam", server_learning_rate=0.01, server_tau=1e-3)
    d["train"].update(global_batch_size=2, device_microbatch_size=2)
    d["photon"]["comm_stack"].update(collective_replica=1, collective_device_optimizer=False)
    d["photon"]["adapters"].update(enabled=True, rank=4,
                                   cohorts={"alpha": [0, 1], "beta": [2, 3]})
    d["run_uuid"] = "adapters-e2e"
    return d


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adapter_checkpoint_resume_continuity_across_packages(tmp_path, writer):
    """The port's case of ``tests/test_adapters.py::test_adapter_checkpoint_
    resume_continuity``, across the packages: one package runs an adapter
    round and saves it, a fresh runner of the other resumes it with the
    base, each cohort's adapter and optimizer state (``_t`` included) bit
    for bit, and trains on; the writer's own fresh runner resumes it too."""
    from photon_tpu.checkpoint import FileStore as JaxStore
    from photon_tpu.checkpoint.server import ServerCheckpointManager as JaxManager
    from photon_tpu.federation.collective_round import CollectiveFedRunner as JaxRunner
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.federation.collective_round import CollectiveFedRunner

    def jax_runner(name):
        return JaxRunner(JaxConfig.from_dict(_adapter_dict(tmp_path, name)).validate(),
                         [0, 1, 2, 3])

    def port_runner(name):
        return CollectiveFedRunner(Config.from_dict(_adapter_dict(tmp_path, name)).validate(),
                                   [0, 1, 2, 3], device="cpu")

    store = str(tmp_path / "store")
    jmgr, pmgr = JaxManager(JaxStore(store), "adapters-e2e"), \
        ServerCheckpointManager(FileStore(store), "adapters-e2e")
    first = jax_runner("w") if writer == "jax" else port_runner("w")
    first.run_round(1)
    first.save_checkpoint(jmgr if writer == "jax" else pmgr, 1)
    assert pmgr.latest_complete_round() == 1 and jmgr.verify_round(1)
    for reader, mgr in ((port_runner("r"), pmgr), (jax_runner("r"), jmgr)):
        assert reader.resume_from(mgr, -1) == 1
        p1, p2 = first.adapter_plane, reader.adapter_plane
        for x, y in zip(p1.base_arrays, p2.base_arrays):
            np.testing.assert_array_equal(x, y)
        for name in p1.cohort_names:
            for x, y in zip(p1.strategies.params(name), p2.strategies.params(name)):
                np.testing.assert_array_equal(x, y)
            s1, s2 = p1.strategies[name], p2.strategies[name]
            assert getattr(s1, "_t", 0) == getattr(s2, "_t", 0) == 1
            for key in s1.state_keys:
                for x, y in zip(s1.state[key], s2.state[key]):
                    np.testing.assert_array_equal(x, y)
        assert reader.server_steps_cumulative == first.server_steps_cumulative
        assert reader.run_round(2)["server/adapter_cohorts"] == 2.0
