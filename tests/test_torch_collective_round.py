"""The port's collective runner (``photon_tpu_torch/federation/collective_round.py``)
held to the JAX package's ``CollectiveFedRunner`` and to the port's own
driver topology, on the CPU with the same configs (d32, 2 layers, fp32).

One case for each of ``tests/test_collective_round.py``'s in-process
cases: rounds against the driver topology and JAX's runner, the retrace
discipline, the device and host paths, q8 momenta and a resume. The cases
across processes, the CLI, checkpoints carried across the two packages,
the autopilot's setters and phase 18's rehearsals are in
``tests/test_torch_collective_procs.py`` (split off so that the driver's
``--dist loadfile`` can run the two halves side by side).

Tolerances: the port against JAX's runner and against the driver topology
rtol 1e-3 / atol 5e-5 after 2 rounds (``tests/test_collective_round.py``'s
own); inside the port the device path, the host path, every controller
and a resumed run are bit for bit.
"""

import numpy as np
import pytest

from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu_torch.config.schema import Config
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

RUN_TOL = dict(rtol=1e-3, atol=5e-5)


def _jax_cfg(tmp_path, strategy="fedavg", momenta=False, n_clients=4, name="run") -> JaxConfig:
    cfg = JaxConfig()
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
    cfg.fl.n_rounds = 2
    cfg.fl.local_steps = 2
    cfg.fl.eval_interval_rounds = 2
    cfg.fl.strategy_name = strategy
    cfg.fl.server_learning_rate = 1.0 if strategy == "fedavg" else 0.01
    cfg.fl.aggregate_momenta = momenta
    if strategy == "fedadam":
        cfg.fl.server_tau = 1e-3
    cfg.dataset.synthetic = True
    cfg.photon.checkpoint = False
    cfg.photon.comm_stack.collective = True
    cfg.photon.comm_stack.shm = False
    cfg.photon.save_path = str(tmp_path / name)
    cfg.run_uuid = "collective-round"
    return cfg


def _port(jcfg) -> Config:
    return Config.from_dict(jcfg.to_dict()).validate()


def _plane_cfg(tmp_path, quantization, n_rounds=3, name="plane"):
    cfg = _jax_cfg(tmp_path, strategy="fedadam", n_clients=2, name=name)
    cfg.fl.n_rounds = n_rounds
    cfg.fl.eval_interval_rounds = 0
    cfg.photon.comm_stack.collective_replica = 2
    cfg.photon.comm_stack.collective_quantization = quantization
    cfg.photon.comm_stack.collective_q8_block = 64
    cfg.photon.comm_stack.collective_device_optimizer = True
    return cfg.validate()


def _runner(jcfg, cids=None, **kw):
    from photon_tpu_torch.federation.collective_round import CollectiveFedRunner

    cfg = _port(jcfg)
    return CollectiveFedRunner(cfg, cids if cids is not None else
                               list(range(cfg.fl.n_total_clients)), device="cpu", **kw)


def _jax_runner(jcfg, cids=None):
    from photon_tpu.federation.collective_round import CollectiveFedRunner

    return CollectiveFedRunner(jcfg, cids if cids is not None else
                               list(range(jcfg.fl.n_total_clients)))


def _seeded(runner, jrunner):
    """Start the port's runner from the JAX runner's initial parameters
    (the packages draw their random inits differently)."""
    runner.load_server_state([p.copy() for p in jrunner.strategy.current_parameters])
    return runner


def _port_driver(cfg, initial):
    """The port's driver topology (one in-process node) from ``initial``."""
    from photon_tpu_torch.codec.params import ParamsMetadata
    from photon_tpu_torch.federation import InProcessDriver, NodeAgent, ParamTransport, ServerApp

    driver = InProcessDriver(cfg, lambda nid: NodeAgent(cfg, nid, lambda: ParamTransport("inline"),
                                                        device="cpu"), n_nodes=1)
    meta, arrays = initial
    return ServerApp(cfg, driver, ParamTransport("inline"),
                     initial_params=(ParamsMetadata(meta.names, meta.shapes, meta.dtypes),
                                     [a.copy() for a in arrays]))


@pytest.mark.parametrize("strategy,momenta", [("fedavg", False), ("fedadam", True)],
                         ids=["fedavg", "fedadam-momenta"])
def test_collective_rounds_match_driver_topology(tmp_path, strategy, momenta):
    """Two rounds of 4 clients in one process: the port's runner against
    the port's driver topology and JAX's runner (parameters and the eval
    loss)."""
    jrunner = _jax_runner(_jax_cfg(tmp_path, strategy, momenta, name="jax").validate())
    initial = (jrunner.meta, [p.copy() for p in jrunner.strategy.current_parameters])
    ocfg = _port(_jax_cfg(tmp_path, strategy, momenta, name="oracle"))
    ocfg.photon.comm_stack.collective = False
    app = _port_driver(ocfg.validate(), initial)
    oracle_hist = app.run()
    oracle = app.strategy.current_parameters
    app.driver.shutdown()

    runner = _seeded(_runner(_jax_cfg(tmp_path, strategy, momenta, name="port")), jrunner)
    hist = runner.run()
    jhist = jrunner.run()
    assert runner.server_steps_cumulative == 4 == jrunner.server_steps_cumulative
    for g, o, j in zip(runner.strategy.current_parameters, oracle,
                       jrunner.strategy.current_parameters):
        np.testing.assert_allclose(g, o, **RUN_TOL)
        np.testing.assert_allclose(g, j, **RUN_TOL)
    np.testing.assert_allclose(hist.latest("server/eval_loss"),
                               oracle_hist.latest("server/eval_loss"), rtol=1e-3)
    np.testing.assert_allclose(hist.latest("server/eval_loss"),
                               jhist.latest("server/eval_loss"), rtol=1e-3)


@pytest.mark.parametrize("quantization", ["off", "q8"])
def test_collective_round_e2e_retrace_free_from_round_2(tmp_path, quantization):
    """Fits → hierarchical exchange → device FedAdam, 3 rounds under the
    port's sentinel (no kernel library built from round 2), the per-round
    KPIs, the modeled wire bytes, and JAX's runner on the same config."""
    from photon_tpu_torch.analysis.runtime import (
        install_retrace_sentinel,
        uninstall_retrace_sentinel,
    )
    from photon_tpu_torch.parallel.collective_agg import modeled_cross_slice_bytes

    jcfg = _plane_cfg(tmp_path, quantization)
    sentinel = install_retrace_sentinel()
    try:
        runner = _runner(jcfg)
        assert runner.device_plane is not None
        sentinel.mark_steady_after(1)
        for rnd in range(1, 4):
            metrics = runner.run_round(rnd)
        sentinel.check("collective/e2e")
    finally:
        uninstall_retrace_sentinel()
    for name in ("server/collective_agg_time", "server/collective_stack_time",
                 "server/collective_exchange_time", "server/collective_update_time",
                 "server/collective_wire_bytes"):
        assert len(runner.history.series(name)) == 3, name
    sizes = [int(np.prod(p.shape)) for p in runner.strategy.current_parameters]
    assert metrics["server/collective_wire_bytes"] == float(
        modeled_cross_slice_bytes(sizes, 2, replica=2, quantization=quantization, block=64))
    for a, b in zip(runner.strategy.current_parameters, runner.device_plane.params_host()):
        np.testing.assert_array_equal(a, b)
    assert runner.device_plane.t == 3 and "_t" in runner.state_for_checkpoint()
    jrunner = _jax_runner(_plane_cfg(tmp_path, quantization, name="jplane"))
    seeded = _seeded(_runner(_plane_cfg(tmp_path, quantization, name="seeded")), jrunner)
    for rnd in range(1, 3):
        jm = jrunner.run_round(rnd)
        sm = seeded.run_round(rnd)
    assert jm["server/collective_wire_bytes"] == sm["server/collective_wire_bytes"]
    if quantization == "off":
        # at q8 a ~1e-7 difference in a contribution can move a value
        # across a rounding boundary, and FedAdam's step turns one code
        # into ~lr: the two packages agree there in the bytes only
        for a, b in zip(seeded.strategy.current_parameters, jrunner.strategy.current_parameters):
            np.testing.assert_allclose(a, b, **RUN_TOL)


def test_collective_round_device_path_matches_host_path(tmp_path):
    """The device optimizer and the host strategy give the same parameters
    bit for bit: the average is the same and the rules are the host's
    operations."""
    dev = _runner(_plane_cfg(tmp_path, "off", n_rounds=2, name="dev"))
    dev.run(2)
    hcfg = _plane_cfg(tmp_path, "off", n_rounds=2, name="host")
    hcfg.photon.comm_stack.collective_device_optimizer = False
    host = _runner(hcfg.validate())
    host.run(2)
    assert dev.device_plane is not None and host.device_plane is None
    for a, b in zip(dev.strategy.current_parameters, host.strategy.current_parameters):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("device_opt", [True, False], ids=["device-opt", "host-opt"])
def test_collective_round_q8_momenta_stays_finite(tmp_path, device_opt):
    from photon_tpu_torch.train.param_ops import M2_PREFIX

    cfg = _jax_cfg(tmp_path, strategy="fedadam", momenta=True)
    cfg.fl.n_rounds = 3
    cfg.fl.eval_interval_rounds = 0
    cfg.photon.comm_stack.collective_replica = 2
    cfg.photon.comm_stack.collective_quantization = "q8"
    cfg.photon.comm_stack.collective_device_optimizer = device_opt
    runner = _runner(cfg.validate())
    assert runner._nonneg_rows
    for rnd in range(1, 4):
        assert np.isfinite(runner.run_round(rnd)["server/pseudo_grad_norm"]), rnd
    for name, p in zip(runner.meta.names, runner.strategy.current_parameters):
        assert np.all(np.isfinite(p)), name
        if name.startswith(M2_PREFIX):
            assert float(p.min()) >= 0.0, name


def test_collective_runner_resume_via_load_server_state(tmp_path):
    def resume_cfg(name):
        cfg = _plane_cfg(tmp_path, "off", n_rounds=3, name=name)
        cfg.fl.fit_config = {"reset_optimizer": True}
        return cfg

    cont = _runner(resume_cfg("cont"))
    for rnd in range(1, 4):
        cont.run_round(rnd)
    part = _runner(resume_cfg("parta"))
    for rnd in range(1, 3):
        part.run_round(rnd)
    params = [p.copy() for p in part.strategy.current_parameters]
    state = {k: [a.copy() for a in v] for k, v in part.state_for_checkpoint().items()}
    resumed = _runner(resume_cfg("partb"))
    resumed.load_server_state(params, state, part.control_state_for_checkpoint())
    assert resumed.device_plane.t == 2
    assert resumed.server_steps_cumulative == part.server_steps_cumulative
    resumed.run_round(3)
    for a, b in zip(cont.strategy.current_parameters, resumed.strategy.current_parameters):
        np.testing.assert_array_equal(a, b)


# -- across processes (gloo on the CPU) ---------------------------------------------
