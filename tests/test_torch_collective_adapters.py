"""The collective cases of ``tests/test_adapters.py`` on the port: the
grouped reduction (``grouped_weighted_average``) against the per-cohort
host fold, and the collective runner's per-cohort adapter rounds
(``_run_round_adapters``) against the host oracle and JAX's runner, on the
same configs (d32, 2 layers, fp32, 4 clients, cohorts alpha = {0, 1} and
beta = {2, 3}).

JAX's ``test_adapter_checkpoint_resume_continuity`` is red on this image
(jax 0.9.0's telemetry hook); the port's case holds the save → resume
round trip bit for bit and the port's first round to JAX's runner (rtol
1e-3 / atol 5e-5). Grouped averages against the host fold rtol 1e-5 /
atol 1e-6; the degraded folds bit for bit.
"""

import numpy as np
import pytest
import torch

from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu_torch.config.schema import Config
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

RUN_TOL = dict(rtol=1e-3, atol=5e-5)


def _adapter_cfg(tmp_path, strategy="fedavg", name="run"):
    cfg = JaxConfig()
    cfg.model.d_model = 32
    cfg.model.n_layers = 2
    cfg.model.n_heads = 2
    cfg.model.max_seq_len = 16
    cfg.model.vocab_size = 64
    cfg.model.attn_impl = "xla"
    cfg.model.compute_dtype = "float32"
    cfg.train.global_batch_size = 2
    cfg.train.device_microbatch_size = 2
    cfg.fl.n_total_clients = 4
    cfg.fl.n_clients_per_round = 4
    cfg.fl.n_rounds = 2
    cfg.fl.local_steps = 2
    cfg.fl.strategy_name = strategy
    cfg.fl.server_learning_rate = 1.0 if strategy == "fedavg" else 0.01
    if strategy == "fedadam":
        cfg.fl.server_tau = 1e-3
    cfg.dataset.synthetic = True
    cfg.photon.checkpoint = False
    cfg.photon.comm_stack.collective = True
    cfg.photon.comm_stack.shm = False
    cfg.photon.comm_stack.collective_q8_block = 64
    cfg.photon.adapters.enabled = True
    cfg.photon.adapters.rank = 4
    cfg.photon.adapters.cohorts = {"alpha": [0, 1], "beta": [2, 3]}
    cfg.photon.save_path = str(tmp_path / name)
    cfg.run_uuid = "adapters-e2e"
    return cfg.validate()


def _runner(jcfg, **kw):
    from photon_tpu_torch.federation.collective_round import CollectiveFedRunner

    return CollectiveFedRunner(Config.from_dict(jcfg.to_dict()).validate(), [0, 1, 2, 3],
                               device="cpu", **kw)


def _seeded_from_jax(runner, jrunner):
    runner.load_server_state([a.copy() for a in jrunner.adapter_plane.base_arrays],
                             {k: [a.copy() for a in v]
                              for k, v in jrunner.state_for_checkpoint().items()},
                             {"adapter_t": jrunner.adapter_plane.strategies.t_counters()})
    return runner


def _grouped_fixture(seed=0, shapes=((6, 4), (9,))):
    rng = np.random.default_rng(seed)
    clients = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(4)]
    ns = rng.integers(1, 30, 4).astype(np.int32)
    stacked = [torch.stack([torch.from_numpy(c[i]) for c in clients]) for i in range(len(shapes))]
    return clients, ns, stacked


def _mesh():
    from photon_tpu_torch.parallel.collective_agg import make_hierarchical_mesh

    return make_hierarchical_mesh(4, 1, device="cpu")


def test_grouped_fused_matches_per_cohort_aggregate_inplace_off():
    from photon_tpu_torch.parallel.collective_agg import grouped_weighted_average
    from photon_tpu_torch.strategy.aggregation import aggregate_inplace

    clients, ns, stacked = _grouped_fixture()
    onehot = np.zeros((4, 3), np.float32)
    onehot[0, 0] = onehot[1, 0] = 1.0
    onehot[3, 1] = 1.0
    avgs, totals = grouped_weighted_average(stacked, ns, onehot, _mesh())
    totals = totals.numpy()
    assert totals[0] == ns[0] + ns[1] and totals[1] == ns[3] and totals[2] == 0.0
    for k, members in ((0, [0, 1]), (1, [3])):
        host, n_host = aggregate_inplace((clients[m], int(ns[m])) for m in members)
        assert n_host == int(totals[k])
        for li in range(2):
            np.testing.assert_allclose(avgs[li][k].numpy(), host[li], rtol=1e-5, atol=1e-6)
    for li in range(2):
        assert not avgs[li][2].any()


def test_grouped_q8_error_within_documented_blockwise_bound():
    from photon_tpu_torch.compression.quantize import quantize_q8
    from photon_tpu_torch.parallel.collective_agg import grouped_weighted_average

    block = 16
    clients, ns, stacked = _grouped_fixture(seed=3)
    onehot = np.zeros((4, 2), np.float32)
    onehot[0, 0] = onehot[1, 0] = 1.0
    onehot[2, 1] = onehot[3, 1] = 1.0
    off, _ = grouped_weighted_average(stacked, ns, onehot, _mesh())
    q8, _ = grouped_weighted_average(stacked, ns, onehot, _mesh(), quantization="q8",
                                     block=block)
    totals = onehot.T @ ns.astype(np.float64)
    for li, shape in enumerate(((6, 4), (9,))):
        n = int(np.prod((2,) + shape))
        chunk = -(-n // block) * block
        bound = np.zeros(chunk, np.float64)
        for c in range(4):
            w = onehot[c] * (ns[c] / np.maximum(totals, 1.0))
            contrib = (w.reshape((2,) + (1,) * len(shape)).astype(np.float32)
                       * clients[c][li][None].astype(np.float32))
            flat = np.zeros(chunk, np.float32)
            flat[:n] = contrib.reshape(-1)
            _, scales = quantize_q8(flat, block=block)
            bound += np.repeat(scales.astype(np.float64), block) / 2.0
        err = np.abs(q8[li].numpy() - off[li].numpy()).reshape(-1)
        assert (err <= bound[:n] + 1e-6).all()
        assert err.max() > 0


def test_grouped_program_cached_no_steady_state_recompile():
    from photon_tpu_torch.analysis.runtime import retrace_guard
    from photon_tpu_torch.parallel.collective_agg import grouped_weighted_average

    _, ns, stacked = _grouped_fixture(seed=5)
    onehot = np.zeros((4, 2), np.float32)
    onehot[:2, 0] = 1.0
    onehot[2:, 1] = 1.0
    first, _ = grouped_weighted_average(stacked, ns, onehot, _mesh())
    with retrace_guard(steady=True):
        for _ in range(3):
            again, _ = grouped_weighted_average(stacked, ns, onehot, _mesh())
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_adapter_rounds_base_frozen_cohorts_diverge_and_steady(tmp_path):
    from photon_tpu_torch.analysis import runtime as rt
    from photon_tpu_torch.parallel.collective_agg import modeled_cross_slice_bytes

    sentinel = rt.install_retrace_sentinel()
    try:
        runner = _runner(_adapter_cfg(tmp_path))
        plane = runner.adapter_plane
        assert plane is not None and runner.device_plane is None
        base0 = [a.copy() for a in plane.base_arrays]
        a0 = [a.copy() for a in plane.strategies.params("alpha")]
        sentinel.mark_steady_after(1)
        m1 = runner.run_round(1)
        m2 = runner.run_round(2)
        sentinel.check("adapters/rounds")
    finally:
        rt.uninstall_retrace_sentinel()
    for before, after in zip(base0, plane.base_arrays):
        np.testing.assert_array_equal(before, after)
    a2, b2 = plane.strategies.params("alpha"), plane.strategies.params("beta")
    assert any(not np.array_equal(x, y) for x, y in zip(a0, a2))
    assert any(not np.array_equal(x, y) for x, y in zip(a2, b2))
    want = float(modeled_cross_slice_bytes(plane.adapter_sizes(), 4))
    for m in (m1, m2):
        assert m["server/adapter_cohorts"] == 2.0 and m["server/adapter_cohorts_degraded"] == 0.0
        assert m["server/collective_stragglers"] == 0.0
        assert m["server/adapter_wire_bytes"] == want == m["server/collective_wire_bytes"]
    assert runner.aggregation_paths == {1: "collective", 2: "collective"}


def _spy_landed(runner, attr):
    seen = {}
    real = getattr(runner, attr)

    def spy(*args):
        landed = args[-1]
        seen.update({cid: ([a.copy() for a in arrs], n) for cid, (arrs, n) in landed.items()})
        if len(args) == 3:
            seen["cohort"] = args[1]
        return real(*args)

    setattr(runner, attr, spy)
    return seen


def test_adapter_round_fused_matches_host_oracle(tmp_path):
    """A clean grouped round equals the host oracle (per-cohort
    ``aggregate_inplace`` and the FedAvg step) and JAX's runner seeded the
    same way."""
    from photon_tpu.federation.collective_round import CollectiveFedRunner as JaxRunner
    from photon_tpu_torch.strategy.grouped import grouped_host_fold
    from photon_tpu_torch.strategy.optimizers import FedAvgEff

    jcfg = _adapter_cfg(tmp_path, name="jax")
    jrunner = JaxRunner(jcfg, [0, 1, 2, 3])
    runner = _seeded_from_jax(_runner(_adapter_cfg(tmp_path)), jrunner)
    plane = runner.adapter_plane
    before = {n: [a.copy() for a in plane.strategies.params(n)] for n in plane.cohort_names}
    landed = _spy_landed(runner, "_aggregate_elastic_adapters")
    runner.run_round(1)
    jrunner.run_round(1)
    folds = grouped_host_fold(landed, plane.cohort_of)
    for name in plane.cohort_names:
        avg, n_total, k = folds[name]
        oracle = FedAvgEff(server_learning_rate=1.0)
        oracle.initialize([a.copy() for a in before[name]])
        oracle.apply_average(1, avg, n_total, k)
        for got, want, j in zip(plane.strategies.params(name), oracle.current_parameters,
                                jrunner.adapter_plane.strategies.params(name)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got, j, **RUN_TOL)


def _fail_fits(monkeypatch, runner, cids, rnd=2, error="simulated cohort loss"):
    from photon_tpu_torch.federation.messages import FitRes

    real = runner.runtime.fit

    def fit(ins, cid):
        if ins.server_round == rnd and cid in cids:
            return FitRes(server_round=ins.server_round, cid=cid, params=None, error=error)
        return real(ins, cid)

    monkeypatch.setattr(runner.runtime, "fit", fit)


def test_cohort_death_degrades_that_cohort_only(tmp_path, monkeypatch):
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.config.schema import TelemetryConfig

    events = tmp_path / "events.jsonl"
    telemetry.install(TelemetryConfig(enabled=True), scope="server", events_path=str(events))
    try:
        runner = _runner(_adapter_cfg(tmp_path))
        plane = runner.adapter_plane
        runner.run_round(1)
        _fail_fits(monkeypatch, runner, (2, 3))
        alpha1 = [a.copy() for a in plane.strategies.params("alpha")]
        beta1 = [a.copy() for a in plane.strategies.params("beta")]
        with pytest.warns(UserWarning, match="no surviving members"):
            m2 = runner.run_round(2)
        for x, y in zip(beta1, plane.strategies.params("beta")):
            np.testing.assert_array_equal(x, y)
        assert any(not np.array_equal(x, y)
                   for x, y in zip(alpha1, plane.strategies.params("alpha")))
        assert m2["server/adapter_cohorts"] == 1.0
        assert m2["server/adapter_cohorts_degraded"] == 1.0
        assert m2["server/collective_stragglers"] == 2.0
        assert runner.aggregation_paths[2] == "collective_reconfigured"
        assert telemetry.health_active().plane_status("federation") == "degraded"
        m3 = runner.run_round(3)
        assert m3["server/adapter_cohorts"] == 2.0
    finally:
        telemetry.uninstall()
    kinds = [e["kind"] for e in telemetry.read_events_jsonl(str(events))]
    assert {"adapter/cohort_degraded", "alert/adapter_cohort",
            "collective/straggler"} <= set(kinds)


def test_all_cohorts_dead_records_failed_round(tmp_path, monkeypatch):
    runner = _runner(_adapter_cfg(tmp_path))
    plane = runner.adapter_plane
    runner.run_round(1)
    state1 = {n: [a.copy() for a in plane.strategies.params(n)] for n in plane.cohort_names}
    steps1 = runner.server_steps_cumulative
    _fail_fits(monkeypatch, runner, (0, 1, 2, 3), error="total loss")
    with pytest.warns(UserWarning, match="no client deltas landed"):
        m2 = runner.run_round(2)
    assert m2["server/round_failed"] == 1.0 and runner.server_steps_cumulative == steps1
    for name in plane.cohort_names:
        for x, y in zip(state1[name], plane.strategies.params(name)):
            np.testing.assert_array_equal(x, y)
    assert runner.aggregation_paths[2] == "failed"


def test_below_quorum_degrades_to_per_cohort_host_fold(tmp_path, monkeypatch):
    from photon_tpu_torch.strategy.grouped import grouped_host_fold
    from photon_tpu_torch.strategy.optimizers import FedAvgEff

    jcfg = _adapter_cfg(tmp_path)
    jcfg.photon.comm_stack.collective_quorum = 0.75
    runner = _runner(jcfg.validate())
    plane = runner.adapter_plane
    runner.run_round(1)
    _fail_fits(monkeypatch, runner, (1, 2), error="simulated node loss")
    before = {n: [a.copy() for a in plane.strategies.params(n)] for n in plane.cohort_names}
    seen = _spy_landed(runner, "_grouped_host_fallback")
    with pytest.warns(UserWarning, match="below quorum"):
        m2 = runner.run_round(2)
    assert m2["server/collective_degraded_rounds"] == 1.0
    assert runner.aggregation_paths[2] == "host_fallback"
    assert seen["cohort"] == (0, 3)
    folds = grouped_host_fold({cid: seen[cid] for cid in (0, 3)}, plane.cohort_of)
    for name, (avg, n_total, k) in folds.items():
        oracle = FedAvgEff(server_learning_rate=1.0)
        oracle.initialize([a.copy() for a in before[name]])
        oracle.apply_average(2, avg, n_total, k)
        for got, want in zip(plane.strategies.params(name), oracle.current_parameters):
            np.testing.assert_array_equal(got, want)


def test_adapter_checkpoint_resume_continuity(tmp_path):
    """Round → save → fresh runner → resume: base, adapters and optimizer
    state (``_t`` included) bit-equal and training goes on; the round
    itself held to JAX's runner from the same start."""
    from photon_tpu.federation.collective_round import CollectiveFedRunner as JaxRunner
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    jrunner = JaxRunner(_adapter_cfg(tmp_path, "fedadam", name="jax"), [0, 1, 2, 3])
    runner = _seeded_from_jax(_runner(_adapter_cfg(tmp_path, "fedadam")), jrunner)
    mgr = ServerCheckpointManager(FileStore(str(tmp_path / "store")), "adapters-e2e")
    runner.run_round(1)
    jrunner.run_round(1)
    for name in runner.adapter_plane.cohort_names:
        for a, b in zip(runner.adapter_plane.strategies.params(name),
                        jrunner.adapter_plane.strategies.params(name)):
            np.testing.assert_allclose(a, b, **RUN_TOL)
    runner.save_checkpoint(mgr, 1)
    assert mgr.latest_complete_round() == 1 and mgr.verify_round(1)
    runner2 = _runner(_adapter_cfg(tmp_path, "fedadam", name="again"))
    assert runner2.resume_from(mgr, -1) == 1
    p1, p2 = runner.adapter_plane, runner2.adapter_plane
    for x, y in zip(p1.base_arrays, p2.base_arrays):
        np.testing.assert_array_equal(x, y)
    for name in p1.cohort_names:
        for x, y in zip(p1.strategies.params(name), p2.strategies.params(name)):
            np.testing.assert_array_equal(x, y)
        s1, s2 = p1.strategies[name], p2.strategies[name]
        assert s1._t == s2._t == 1
        for key in s1.state_keys:
            for x, y in zip(s1.state[key], s2.state[key]):
                np.testing.assert_array_equal(x, y)
    assert runner2.server_steps_cumulative == runner.server_steps_cumulative
    assert runner2.run_round(2)["server/adapter_cohorts"] == 2.0
