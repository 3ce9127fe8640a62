"""Asynchronous federated rounds on the port
(``photon_tpu_torch/federation/async_round.py``): one case for each of
``tests/test_async_round.py``'s, on the same configs (d32, 2 layers, fp32).

JAX's async runner is red on this image (jax 0.9.0 lacks the telemetry
listener its module hooks), so these cases hold the port to the sync-parity
property instead: with the buffer the full cohort and equal client speeds,
N async versions equal N rounds of the port's synchronous runner bit for
bit (parameters and optimizer state), and the sync runner is held to JAX's
``CollectiveFedRunner`` in ``test_torch_collective_round.py``. The weight
math is held to JAX's functions directly. The grouped burst against
sequential folds: rtol 1e-6 / atol 1e-7 (JAX's own).
"""

import threading
import time

import numpy as np
import pytest

from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu_torch import chaos, telemetry
from photon_tpu_torch.config.schema import Config, TelemetryConfig
from photon_tpu_torch.federation.async_round import AsyncFedRunner
from photon_tpu_torch.federation.collective_round import CollectiveFedRunner
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


@pytest.fixture(autouse=True)
def _clean_planes():
    yield
    chaos.uninstall()
    telemetry.uninstall()


def _cfg(tmp_path, strategy="fedavg", n_clients=2, quantization="off", device_opt=True,
         n_rounds=3) -> Config:
    cfg = Config()
    cfg.model.d_model = 32
    cfg.model.n_layers = 2
    cfg.model.n_heads = 2
    cfg.model.max_seq_len = 16
    cfg.model.vocab_size = 64
    cfg.model.attn_impl = "xla"
    cfg.model.compute_dtype = "float32"
    cfg.train.global_batch_size = 4
    cfg.train.device_microbatch_size = 4
    cfg.fl.n_total_clients = n_clients
    cfg.fl.n_clients_per_round = n_clients
    cfg.fl.n_rounds = n_rounds
    cfg.fl.local_steps = 2
    cfg.fl.eval_interval_rounds = 0
    cfg.fl.strategy_name = strategy
    cfg.fl.server_learning_rate = 1.0 if strategy == "fedavg" else 0.01
    if strategy in ("fedadam", "fedyogi"):
        cfg.fl.server_tau = 1e-3
    cfg.dataset.synthetic = True
    cfg.photon.checkpoint = False
    cfg.photon.comm_stack.collective = True
    cfg.photon.comm_stack.shm = False
    cfg.photon.comm_stack.collective_replica = 2
    cfg.photon.comm_stack.collective_quantization = quantization
    cfg.photon.comm_stack.collective_q8_block = 64
    cfg.photon.comm_stack.collective_device_optimizer = device_opt
    cfg.photon.save_path = str(tmp_path / "run")
    cfg.run_uuid = "async-round"
    return cfg


def _async_cfg(tmp_path, K=0, min_arrivals=1, max_staleness=4, power=1.0, **kw) -> Config:
    cfg = _cfg(tmp_path, **kw)
    ar = cfg.photon.async_rounds
    ar.enabled = True
    ar.buffer_size = K
    ar.min_arrivals = min_arrivals
    ar.max_staleness = max_staleness
    ar.staleness_power = power
    return cfg.validate()


def _async(cfg, cids):
    return AsyncFedRunner(cfg, cids, device="cpu")


def _assert_bit_identical(a, s):
    assert a.server_steps_cumulative == s.server_steps_cumulative
    for pa, ps in zip(a.strategy.current_parameters, s.strategy.current_parameters):
        assert np.array_equal(pa, ps)
    sa, ss = a.state_for_checkpoint(), s.state_for_checkpoint()
    assert set(sa) == set(ss)
    for k in sa:
        for xa, xs in zip(sa[k], ss[k]):
            assert np.array_equal(xa, xs), k


@pytest.mark.parametrize("strategy,quantization", [
    ("fedavg", "off"), ("fedadam", "q8"), ("fedavg", "q8"), ("nesterov", "off"),
    ("nesterov", "q8"), ("fedmom", "off"), ("fedmom", "q8"), ("fedadam", "off"),
    ("fedyogi", "off"), ("fedyogi", "q8")])
def test_zero_staleness_is_bitexact_sync(tmp_path, strategy, quantization):
    sync = CollectiveFedRunner(_cfg(tmp_path / "sync", strategy=strategy,
                                    quantization=quantization).validate(), [0, 1], device="cpu")
    for r in (1, 2, 3):
        sync.run_round(r)
    runner = _async(_async_cfg(tmp_path / "async", strategy=strategy,
                               quantization=quantization), [0, 1])
    runner.run_versions(3, eval_every=0)
    assert runner.version == 3
    assert all(runner.aggregation_paths[v] == "async" for v in (1, 2, 3))
    _assert_bit_identical(runner, sync)
    assert runner.history.latest("server/async_staleness_max") == 0.0
    assert runner.history.latest("server/async_discount_mean") == 1.0


def test_zero_staleness_bitexact_host_path(tmp_path):
    sync = CollectiveFedRunner(_cfg(tmp_path / "sync", device_opt=False).validate(), [0, 1],
                               device="cpu")
    for r in (1, 2, 3):
        sync.run_round(r)
    runner = _async(_async_cfg(tmp_path / "async", device_opt=False), [0, 1])
    runner.run_versions(3, eval_every=0)
    _assert_bit_identical(runner, sync)
    assert runner.history.latest("server/n_samples") == sync.history.latest("server/n_samples")


def test_async_steady_state_is_compile_free(tmp_path):
    from photon_tpu_torch.analysis.runtime import (
        install_retrace_sentinel,
        uninstall_retrace_sentinel,
    )

    sentinel = install_retrace_sentinel()
    try:
        runner = _async(_async_cfg(tmp_path, strategy="fedadam", n_rounds=4), [0, 1])
        sentinel.mark_steady_after(1)
        runner.run_versions(4, eval_every=0)
        sentinel.check("async/steady-state")
    finally:
        uninstall_retrace_sentinel()
    assert runner.version == 4


def test_staleness_discount_policies():
    from photon_tpu.parallel.collective_agg import staleness_discount as jax_discount
    from photon_tpu_torch.parallel.collective_agg import staleness_discount

    np.testing.assert_allclose(staleness_discount([0, 1, 3], "poly", 1.0), [1.0, 0.5, 0.25])
    np.testing.assert_allclose(staleness_discount([0, 1, 3], "poly", 2.0), [1.0, 0.25, 0.0625])
    np.testing.assert_allclose(staleness_discount([0, 5, 9], "const"), [1.0, 1.0, 1.0])
    for args in (([0, 1, 3], "poly", 1.0), ([0, 2, 7], "poly", 0.5), ([4, 5], "const", 1.0)):
        np.testing.assert_array_equal(staleness_discount(*args), jax_discount(*args))
    with pytest.raises(ValueError, match="staleness"):
        staleness_discount([-1], "poly")
    with pytest.raises(ValueError):
        staleness_discount([0], "exp")


def test_discounted_fold_weights_dtype_signature():
    from photon_tpu.parallel.collective_agg import discounted_fold_weights as jax_weights
    from photon_tpu_torch.parallel.collective_agg import discounted_fold_weights

    w = discounted_fold_weights([10, 20], [0, 0])
    assert w.dtype == np.int32 and list(w) == [10, 20]
    w = discounted_fold_weights([10, 20], [0, 1], "poly", 1.0)
    assert w.dtype == np.float32
    np.testing.assert_allclose(w, [10.0, 10.0])
    assert discounted_fold_weights([10, 20], [0, 7], "const").dtype == np.int32
    for args in (([10, 20], [0, 0]), ([10, 20], [0, 1], "poly", 1.0), ([3, 9], [2, 5], "poly", 0.7)):
        got, want = discounted_fold_weights(*args), jax_weights(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_max_staleness_reject_rebroadcasts_fresh_version(tmp_path):
    events = tmp_path / "events.jsonl"
    telemetry.install(TelemetryConfig(enabled=True), scope="server", events_path=str(events))
    cfg = _async_cfg(tmp_path, K=1, max_staleness=0, n_rounds=5)
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.fit_delay_factor = 4.0
    cfg.photon.chaos.fit_delay_cid = 1
    cfg.validate()
    chaos.install(cfg.photon.chaos, scope="collective0")
    runner = _async(cfg, [0, 1])
    runner.run_versions(5, eval_every=0)
    assert runner.version == 5 and runner.rejected_total == 1
    assert runner.history.latest("server/async_rejected_total") == 1.0
    telemetry.uninstall()
    log = telemetry.read_events_jsonl(str(events))
    rejects = [e for e in log if e["kind"] == "async/stale_reject"]
    assert len(rejects) == 1
    assert rejects[0]["attrs"]["cid"] == 1 and rejects[0]["attrs"]["staleness"] == 3
    assert any(e["kind"] == "chaos/fit_delay" for e in log)
    assert any(e["kind"] == "async/version_advance" for e in log)


def _client_crash(code):
    raise RuntimeError(f"simulated SIGKILL ({code})")


def test_min_arrivals_stall_holds_clock_never_aborts(tmp_path):
    events = tmp_path / "events.jsonl"
    telemetry.install(TelemetryConfig(enabled=True), scope="server", events_path=str(events))
    cfg = _async_cfg(tmp_path, K=2, min_arrivals=2, n_rounds=2)
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.crash_phase = "mid-fit"
    cfg.photon.chaos.crash_round = 1
    cfg.photon.chaos.crash_marker = str(tmp_path / "crash.marker")
    cfg.validate()
    chaos.install(cfg.photon.chaos, scope="collective0", crash_fn=_client_crash)
    runner = _async(cfg, [0, 1])
    with pytest.warns(UserWarning):
        hist = runner.run_versions(2, eval_every=0)
    assert runner.version == 0 and runner.stalls_total >= 1
    assert runner.dropped_total == 1 and hist is runner.history
    telemetry.uninstall()
    kinds = [e["kind"] for e in telemetry.read_events_jsonl(str(events))]
    assert "async/min_arrivals_stall" in kinds and "async/delta_dropped" in kinds


def test_liveness_edge_drops_inflight_delta(tmp_path):
    runner = _async(_async_cfg(tmp_path, K=2), [0, 1])
    assert runner._dispatch(0) and runner._dispatch(1)
    runner.liveness.observe_miss("client1")
    runner.liveness.observe_miss("client1")
    survivors = [cid for cid, arrays, n, base in runner._pop_burst()
                 if runner._admit(cid, arrays, n, base)]
    assert survivors == [0] and runner.dropped_total == 1
    assert [e.cid for e in runner.buffer] == [0]


def test_sigkill_mid_fit_drops_cleanly_clock_advances(tmp_path):
    cfg = _async_cfg(tmp_path, n_clients=3, K=2, n_rounds=4)
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.crash_phase = "mid-fit"
    cfg.photon.chaos.crash_round = 2
    cfg.photon.chaos.crash_marker = str(tmp_path / "crash.marker")
    cfg.validate()
    inj = chaos.install(cfg.photon.chaos, scope="collective0", crash_fn=_client_crash)
    runner = _async(cfg, [0, 1, 2])
    with pytest.warns(UserWarning, match="delta is dropped"):
        runner.run_versions(4, eval_every=0)
    assert inj.counts["crash"] == 1 and runner.version == 4 and runner.dropped_total == 1
    for p in runner.strategy.current_parameters:
        assert np.all(np.isfinite(p))
    control = runner.control_state_for_checkpoint()
    assert control["async_version"] == 4 and control["async_dropped_total"] == 1


def test_grouped_burst_matches_sequential_folds(tmp_path):
    ra = _async(_async_cfg(tmp_path / "a", K=1, device_opt=False), [0, 1])
    rb = _async(_async_cfg(tmp_path / "b", K=1, device_opt=False), [0, 1])
    for p, q in zip(ra.strategy.current_parameters, rb.strategy.current_parameters):
        assert np.array_equal(p, q)
    assert ra._dispatch(0) and ra._dispatch(1)
    for cid, arrays, n, base in ra._pop_burst():
        assert ra._admit(cid, arrays, n, base)
    buffers = [[ra.buffer[0]], [ra.buffer[1]]]
    ra.buffer = []
    ra._fold_grouped(buffers)
    rb._fold_one([buffers[0][0]])
    rb._fold_one([buffers[1][0]])
    assert ra.version == rb.version == 2
    for p, q in zip(ra.strategy.current_parameters, rb.strategy.current_parameters):
        np.testing.assert_allclose(p, q, rtol=1e-6, atol=1e-7)


def test_fold_failure_rolls_back_and_continues(tmp_path, monkeypatch):
    runner = _async(_async_cfg(tmp_path, device_opt=False), [0, 1])
    assert runner._dispatch(0) and runner._dispatch(1)
    for cid, arrays, n, base in runner._pop_burst():
        runner._admit(cid, arrays, n, base)
    before = [p.copy() for p in runner.strategy.current_parameters]

    def _boom(*a, **k):
        raise RuntimeError("torn fold")

    monkeypatch.setattr(runner.strategy, "apply_average", _boom)
    entries = runner.buffer[:runner.K]
    del runner.buffer[:runner.K]
    with pytest.warns(UserWarning, match="rolled back"):
        runner._fold_one(entries)
    assert runner.version == 0 and runner.folds_failed_total == 1
    for p, q in zip(before, runner.strategy.current_parameters):
        assert np.array_equal(p, q)
    assert runner.history.latest("server/round_failed") == 1.0


def test_fit_delay_plan_deterministic_and_scoped(tmp_path):
    from photon_tpu.chaos.injector import FaultInjector as JaxInjector
    from photon_tpu_torch.chaos.injector import FaultInjector, validate_chaos_config

    cfg = Config().photon.chaos
    cfg.enabled = True
    cfg.fit_delay_factor = 4.0
    validate_chaos_config(cfg)
    a = FaultInjector(cfg, scope="nodeA")
    f0, f1 = a.fit_delay_plan(0), a.fit_delay_plan(1)
    assert a.fit_delay_plan(0) == f0 and a.fit_delay_plan(1) == f1
    assert FaultInjector(cfg, scope="nodeA").fit_delay_plan(0) == f0
    assert 1.0 <= f0 < 4.0 and 1.0 <= f1 < 4.0 and f0 != f1
    assert FaultInjector(cfg, scope="nodeB").fit_delay_plan(0) != f0
    assert a.counts["fit_delay"] >= 2
    jcfg = JaxConfig().photon.chaos
    jcfg.enabled = True
    jcfg.fit_delay_factor = 4.0
    assert JaxInjector(jcfg, scope="nodeA").fit_delay_plan(0) == f0  # JAX's draw
    cfg.fit_delay_cid = 1
    b = FaultInjector(cfg, scope="nodeA")
    assert b.fit_delay_plan(1) == 4.0 and b.fit_delay_plan(0) == 1.0
    cfg.fit_delay_factor = 0.0
    assert FaultInjector(cfg, scope="x").fit_delay_plan(3) == 1.0
    cfg.fit_delay_factor = 0.5
    with pytest.raises(ValueError, match="fit_delay_factor"):
        validate_chaos_config(cfg)


def test_fit_delay_rides_fit_metrics(tmp_path):
    cfg = _async_cfg(tmp_path, K=1, n_rounds=1)
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.fit_delay_factor = 4.0
    cfg.photon.chaos.fit_delay_cid = 1
    cfg.validate()
    chaos.install(cfg.photon.chaos, scope="collective0")
    runner = _async(cfg, [0, 1])
    assert runner._dispatch(0) and runner._dispatch(1)
    times = {runner._inflight[seq][0]: t for t, seq in runner._heap}
    assert times[1] == pytest.approx(4.0 * times[0])


def test_async_config_validation(tmp_path):
    """The port's checks and texts are JAX's: the same bad configs raise
    the same messages in both packages."""
    cases = [
        (lambda c: (setattr(c.photon.async_rounds, "enabled", True),
                    setattr(c.photon.comm_stack, "collective", False),
                    setattr(c.photon.comm_stack, "shm", True),
                    setattr(c.photon.comm_stack, "collective_replica", 1)), "collective"),
        (lambda c: (setattr(c.photon.async_rounds, "enabled", True),
                    setattr(c.photon.async_rounds, "staleness_policy", "exp")), "staleness_policy"),
        (lambda c: (setattr(c.photon.async_rounds, "enabled", True),
                    setattr(c.photon.async_rounds, "buffer_size", 1),
                    setattr(c.photon.async_rounds, "min_arrivals", 2)), "min_arrivals"),
        (lambda c: (setattr(c.photon.async_rounds, "enabled", True),
                    setattr(c.photon.async_rounds, "buffer_size", 3)), "exceeds"),
        (lambda c: setattr(c.photon.async_rounds, "fit_time_s", 0.0), "fit_time_s"),
    ]
    for edit, text in cases:
        ours = _cfg(tmp_path)
        theirs = JaxConfig.from_dict(ours.to_dict())
        edit(ours)
        edit(theirs)
        with pytest.raises(ValueError, match=text) as got:
            ours.validate()
        with pytest.raises(ValueError) as want:
            theirs.validate()
        assert str(got.value) == str(want.value)
    cfg = _cfg(tmp_path)
    cfg.photon.async_rounds.buffer_size = 3
    with pytest.warns(UserWarning, match="async_rounds"):
        cfg.validate()


def test_async_runner_requires_enabled(tmp_path):
    with pytest.raises(ValueError, match="async_rounds.enabled"):
        _async(_cfg(tmp_path).validate(), [0, 1])


def test_chaos_stream_hotswap_consumes_versions_mid_traffic(tmp_path):
    """One client crashed and another 4x slow mid-stream: the clock
    advances on survivors, every advance streams a checkpoint, and a live
    engine + batcher + watcher on the CPU swaps to streamed versions with
    zero dropped requests."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.hotswap import CheckpointWatcher
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher, DrainingError, QueueFullError

    cfg = _async_cfg(tmp_path, n_clients=3, K=2, n_rounds=3)
    cfg.photon.serve.n_slots = 2
    cfg.photon.serve.block_size = 4
    cfg.photon.serve.max_new_tokens = 4
    cfg.photon.chaos.enabled = True
    cfg.photon.chaos.crash_phase = "mid-fit"
    cfg.photon.chaos.crash_round = 2
    cfg.photon.chaos.crash_marker = str(tmp_path / "crash.marker")
    cfg.photon.chaos.fit_delay_factor = 4.0
    cfg.photon.chaos.fit_delay_cid = 2
    cfg.validate()
    chaos.install(cfg.photon.chaos, scope="collective0", crash_fn=_client_crash)
    store = FileStore(tmp_path / "store")
    mgr = ServerCheckpointManager(store, cfg.run_uuid)
    runner = _async(cfg, [0, 1, 2])
    runner.save_checkpoint(mgr, 0)
    engine = PagedEngine.from_checkpoint(cfg, store=store, resume_round=-1, device="cpu")
    batcher = ContinuousBatcher(engine, max_queue=16).start()
    watcher = CheckpointWatcher(batcher, mgr, cfg, poll_s=0.01)
    assert engine.loaded_round == 0
    err: list[BaseException] = []

    def _train():
        try:
            runner.run_versions(3, ckpt_mgr=mgr, ckpt_every=1, eval_every=0)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            err.append(e)

    t = threading.Thread(target=_train)
    futures = []
    with pytest.warns(UserWarning):
        t.start()
        try:
            while t.is_alive():
                try:
                    futures.append(batcher.submit([5, 9, 2], 4))
                except (DrainingError, QueueFullError):
                    pass
                watcher.poll_once()
                time.sleep(0.02)
            t.join()
            for _ in range(100):
                if engine.loaded_round >= 3:
                    break
                watcher.poll_once()
                time.sleep(0.02)
            futures.append(batcher.submit([5, 9, 2], 4))
            assert futures
            for f in futures:
                assert len(f.result(timeout=120)) == 4
        finally:
            batcher.close()
    assert not err, err
    assert runner.version == 3 and runner.dropped_total == 1
    assert engine.loaded_round == 3 and watcher.swaps_applied >= 1
    _, _, _, server_state = mgr.load_round(3)
    assert server_state["async_version"] == 3
