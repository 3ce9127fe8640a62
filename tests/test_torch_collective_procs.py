"""The port's collective runner across processes, its CLI, checkpoints
carried across the two packages, the autopilot's setters, and phase 18 of
``chip_smoke.py`` rehearsed on the CPU (the second half of what was
``tests/test_torch_collective_round.py``, split off so that the driver's
``--dist loadfile`` can run the two halves side by side).

One case for each of ``tests/test_collective_multiprocess.py``'s (the
port's processes use gloo on the CPU, spawned children on a free port) and
of ``tests/test_collective_round.py``'s checkpoint and setter cases, on the
same configs (d32, 2 layers, fp32). Tolerances: against JAX's runner rtol
1e-3 / atol 5e-5 (``tests/test_collective_round.py``'s own); inside the
port bit for bit.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_collective_round import (
    RUN_TOL,
    _jax_cfg,
    _port,
    _plane_cfg,
    _runner,
    _jax_runner,
)
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


CHILD = r"""
import json, sys
import numpy as np
import torch.distributed as dist

pid = int(sys.argv[1]); port = sys.argv[2]; cfg_path = sys.argv[3]; out = sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=pid)
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation.collective_round import CollectiveFedRunner, partition_cids
from photon_tpu_torch.parallel.collective_agg import (
    collective_weighted_average, make_client_mesh)

cfg = Config.from_yaml(cfg_path)
cfg.photon.save_path += f"/proc{pid}"
cfg.validate()
cids = partition_cids(cfg.fl.n_total_clients, 2, pid)
# the plain average over a 2-process, 4-client mesh
mesh = make_client_mesh(4, devices=["cpu" if c in cids else None for c in range(4)],
                        owners=[0, 0, 1, 1], rank=pid, group=dist.group.WORLD, backend="gloo")
def client(c):
    rng = np.random.default_rng(c)
    return [rng.normal(size=(6, 4)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)]
import torch
stacked = [[torch.from_numpy(client(c)[i]) for c in cids] for i in range(2)]
avg = collective_weighted_average(stacked, [[10, 20, 5, 65][c] for c in cids], mesh)
runner = CollectiveFedRunner(cfg, cids, device="cpu")
history = runner.run()
np.savez(out, *runner.strategy.current_parameters)
json.dump({"avg": [a.numpy().tolist() for a in avg], "backend": runner.backend,
           "eval_loss": history.latest("server/eval_loss"),
           "steps": runner.server_steps_cumulative},
          open(out + ".json", "w"))
dist.destroy_process_group()
"""


def _spawn(tmp_path, script_text, argv_of, n=2, timeout=240):
    from tests._helpers import subprocess_env

    script = tmp_path / "child.py"
    script.write_text(script_text)
    procs, logs = [], [tmp_path / f"child_{i}.log" for i in range(n)]
    for i in range(n):
        with logs[i].open("w") as f:
            procs.append(subprocess.Popen([sys.executable, str(script), *argv_of(i)],
                                          env=subprocess_env(), stdout=f,
                                          stderr=subprocess.STDOUT, text=True))
    for i, p in enumerate(procs):
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"child {i} timed out: {logs[i].read_text()[-2000:]}")
        assert p.returncode == 0, logs[i].read_text()[-3000:]
    return logs


def test_collective_average_across_two_processes(tmp_path):
    """Two gloo processes, 2 clients each: the plain average equals the
    host fold on both, and two runner rounds give both controllers the
    same parameters bit for bit, within the run tolerance of an in-process
    run and of JAX's runner."""
    from tests._helpers import free_port

    from photon_tpu_torch.strategy.aggregation import aggregate_inplace

    jcfg = _jax_cfg(tmp_path, name="mp").validate()
    cfg_path = tmp_path / "mp.yaml"
    _port(jcfg).to_yaml(cfg_path)
    port = free_port()
    outs = [tmp_path / f"params_{i}.npz" for i in range(2)]
    _spawn(tmp_path, CHILD, lambda i: [str(i), str(port), str(cfg_path), str(outs[i])])

    def client(c):
        rng = np.random.default_rng(c)
        return [rng.normal(size=(6, 4)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)]

    oracle, total = aggregate_inplace((client(c), [10, 20, 5, 65][c]) for c in range(4))
    got = [np.load(o) for o in outs]
    meta = [json.loads(pathlib.Path(str(o) + ".json").read_text()) for o in outs]
    for m in meta:
        assert m["backend"] == "gloo" and m["steps"] == 4
        for a, o in zip(m["avg"], oracle):
            np.testing.assert_allclose(np.asarray(a), o, rtol=1e-5, atol=1e-6)
    for k in got[0].files:
        np.testing.assert_array_equal(got[0][k], got[1][k])
    inproc = _runner(_jax_cfg(tmp_path, name="inproc"))
    inproc.run()
    for k, p in zip(got[0].files, inproc.strategy.current_parameters):
        np.testing.assert_allclose(got[0][k], p, **RUN_TOL)
    assert meta[0]["eval_loss"] == meta[1]["eval_loss"]
    np.testing.assert_allclose(meta[0]["eval_loss"],
                               inproc.history.latest("server/eval_loss"), rtol=1e-3)


def test_collective_round_cli_on_the_cpu(tmp_path, capsys):
    """``python -m photon_tpu_torch.federation.collective_round`` with one
    process and ``--device cpu`` runs its rounds and prints the JSON line;
    the driver CLI refuses ``comm_stack.collective`` and points at it."""
    from photon_tpu_torch.federated import build_app
    from photon_tpu_torch.federation.collective_round import main

    cfg = _port(_jax_cfg(tmp_path, n_clients=2, name="cli"))
    cfg.to_yaml(tmp_path / "cli.yaml")
    main(["--coordinator", "127.0.0.1:1", "--num-processes", "1", "--process-id", "0",
          "--config", str(tmp_path / "cli.yaml"), "--rounds", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rounds"] == 2 and out["server/steps_cumulative"] == 4.0
    assert out["backend"] is None and out["paths"] == {"1": "collective", "2": "collective"}
    with pytest.raises(ValueError, match="photon_tpu_torch.federation.collective_round"):
        build_app(cfg, device="cpu")


# -- state carried across the packages ---------------------------------------------------


def _ckpt_cfg(tmp_path, name, replica=2):
    cfg = _plane_cfg(tmp_path, "off", n_rounds=3, name=name)
    cfg.photon.comm_stack.collective_replica = replica
    cfg.fl.fit_config = {"reset_optimizer": True}
    return cfg.validate()


def _save_and_load(runner, tmp_path, name, mgr_cls, store_cls):
    mgr = mgr_cls(store_cls(str(tmp_path / name)), "collective-round")
    runner.save_checkpoint(mgr, 2)
    return mgr


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX ``CollectiveFedRunner`` checkpoint (device FedAdam, replica 2)
    resumes in the port through ``resume_from``: the plane's moments and
    ``_t`` equal JAX's exactly, and round 3 stays within the run tolerance
    of JAX's round 3."""
    from photon_tpu.checkpoint import FileStore as JaxStore
    from photon_tpu.checkpoint.server import ServerCheckpointManager as JaxMgr
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    jr = _jax_runner(_ckpt_cfg(tmp_path, "j"))
    for rnd in (1, 2):
        jr.run_round(rnd)
    _save_and_load(jr, tmp_path, "store", JaxMgr, JaxStore)
    pr = _runner(_ckpt_cfg(tmp_path, "p"))
    assert pr.resume_from(ServerCheckpointManager(FileStore(str(tmp_path / "store")),
                                                  "collective-round"), -1) == 2
    assert pr.device_plane.t == jr.device_plane.t == 2
    jstate = jr.device_plane.state_host()
    for key, tensors in pr.device_plane.state_host().items():
        for a, b in zip(tensors, jstate[key]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(pr.device_plane.params_host(), jr.device_plane.params_host()):
        np.testing.assert_array_equal(a, b)
    assert pr.server_steps_cumulative == jr.server_steps_cumulative
    jr.run_round(3)
    pr.run_round(3)
    for a, b in zip(pr.strategy.current_parameters, jr.strategy.current_parameters):
        np.testing.assert_allclose(a, b, **RUN_TOL)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    from photon_tpu.checkpoint import FileStore as JaxStore
    from photon_tpu.checkpoint.server import ServerCheckpointManager as JaxMgr
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    pr = _runner(_ckpt_cfg(tmp_path, "p"))
    for rnd in (1, 2):
        pr.run_round(rnd)
    _save_and_load(pr, tmp_path, "store", ServerCheckpointManager, FileStore)
    jmgr = JaxMgr(JaxStore(str(tmp_path / "store")), "collective-round")
    jr = _jax_runner(_ckpt_cfg(tmp_path, "j"))
    assert jr.resume_from(jmgr, -1) == 2
    # JAX's resume reads the state keys only: its step counter restarts (a
    # reference fault the port does not copy); with every object the port
    # wrote, JAX's load_server_state takes the counter too
    assert jr.device_plane.t == 0
    _, params, state, control = jmgr.load_round(2, ("momentum_1", "momentum_2", "_t"))
    jr.load_server_state(params, state, control)
    assert jr.device_plane.t == pr.device_plane.t == 2
    for a, b in zip(jr.device_plane.params_host(), pr.device_plane.params_host()):
        np.testing.assert_array_equal(a, b)
    pstate = pr.device_plane.state_host()
    for key, tensors in jr.device_plane.state_host().items():
        for a, b in zip(tensors, pstate[key]):
            np.testing.assert_array_equal(a, b)
    assert jr.aggregation_paths == pr.aggregation_paths == {1: "collective", 2: "collective"}


def test_checkpoint_resumes_across_resharding_bit_exact(tmp_path):
    """Saved at replica 2, resumed at replica 1 inside the port: round 3
    equals the uninterrupted replica-2 run bit for bit."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    cont = _runner(_ckpt_cfg(tmp_path, "cont"))
    for rnd in (1, 2, 3):
        cont.run_round(rnd)
    part = _runner(_ckpt_cfg(tmp_path, "part"))
    for rnd in (1, 2):
        part.run_round(rnd)
    mgr = _save_and_load(part, tmp_path, "store", ServerCheckpointManager, FileStore)
    resumed = _runner(_ckpt_cfg(tmp_path, "resumed", replica=1))
    assert resumed.resume_from(mgr, -1) == 2
    assert resumed.device_plane.replica == 1 and resumed.device_plane.t == 2
    resumed.run_round(3)
    for a, b in zip(cont.strategy.current_parameters, resumed.strategy.current_parameters):
        np.testing.assert_array_equal(a, b)


# -- the autopilot's setters ----------------------------------------------------------------


def test_collective_setters_loud_rejects():
    from photon_tpu_torch.federation.collective_round import CollectiveFedRunner

    r = object.__new__(CollectiveFedRunner)
    r.stage_timeout_s = 30.0
    r.set_stage_timeout_s(10.0)
    assert r.stage_timeout_s == 10.0
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            r.set_stage_timeout_s(bad)
    assert r.stage_timeout_s == 10.0
    r.quantization = "off"
    r.device_plane = None
    r.set_quantization("q8")
    assert r.quantization == "q8"
    r.set_quantization("q8")
    with pytest.raises(ValueError, match="unknown collective quantization"):
        r.set_quantization("int4")


def test_async_staleness_setter_rejects_negative():
    from photon_tpu_torch.federation.async_round import AsyncFedRunner

    r = object.__new__(AsyncFedRunner)
    r.max_staleness = 4
    r.set_max_staleness(0)
    assert r.max_staleness == 0
    with pytest.raises(ValueError, match=">= 0"):
        r.set_max_staleness(-1)


def test_runner_registers_knobs_and_ticks_the_collective_plane(tmp_path):
    """With the autopilot installed the runner registers both collective
    knobs; a round ticks the ``collective`` plane with the straggler
    fraction and the wire bytes in the hub; ``set_quantization`` through
    the knob rebuilds the device plane at q8."""
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.config.schema import TelemetryConfig

    tel = TelemetryConfig(enabled=True)
    tel.autopilot.enabled = True
    telemetry.install(tel, scope="server", events_path=str(tmp_path / "ev.jsonl"))
    try:
        runner = _runner(_plane_cfg(tmp_path, "off", n_rounds=1))
        ap = telemetry.autopilot_active()
        knobs = ap._knobs
        assert {"server/collective_stage_timeout_s",
                "server/collective_quantization_level"} <= set(knobs)
        runner.run_round(1)
        hub = telemetry.metrics_active()
        assert hub.gauge("server/collective_straggler_frac").value == 0.0
        assert hub.counter("server/collective_wire_bytes").value > 0
        runner.set_quantization("q8")
        assert runner.device_plane.quantization == "q8"
    finally:
        telemetry.uninstall()


# -- phase 18 of chip_smoke.py, rehearsed on the CPU ---------------------------------------


def _smoke_base(tmp_path):
    def base():
        cfg = _port(_jax_cfg(tmp_path, name="smoke"))
        cfg.dataset.synthetic = True
        return cfg

    return base


def test_chip_smoke_collective_phase_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.collective_phase`` (phase 18 (a), (e)) at d32 on the
    CPU: the runs against the driver topology and the dropped-row fault,
    ZeRO-1 against replicated, the q8 bound and its shifted-scale fault,
    the wire bytes and the registered knobs. K1–K3's launch counts are
    card-only."""
    import torch

    from tests.test_torch_compression import _chip_smoke

    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "COLL_Q8_BLOCK", 16)
    base = _smoke_base(tmp_path)
    rec = smoke.collective_phase(
        torch, np, cfg_fn=lambda **kw: smoke.collective_config(
            base=base, **{"save_path": tmp_path / "run", **kw}),
        device="cpu", work=tmp_path / "coll")
    assert rec["knobs"] == ["server/collective_quantization_level",
                            "server/collective_stage_timeout_s"]
    assert rec["vs_driver"]["round2_excess"] <= 0 < rec["vs_driver"]["dropped_row_round1_excess"]
    s = rec["server_state_bytes_per_rank"]
    assert s["replicated"] / 2 <= s["zero1"] <= s["replicated"] / 2 * 1.001
    assert rec["q8"]["bound_excess_max"] <= 1e-7 < rec["q8"]["shifted_scale_fault_excess"]
    assert rec["q8"]["ratio"] == pytest.approx(4 / (1 + 4 / 16))
    assert [r["path"] for r in rec["zero1"]["rounds"]] == ["collective", "collective"]
    assert not (tmp_path / "coll").exists()


def test_chip_smoke_collective_leg_on_the_cpu(tmp_path):
    """``chip_smoke.collective_leg`` (phase 18 (c), (d) in process) and
    ``collective_pair`` ((b) and (c) across processes) at d32 with
    ``--device cpu`` CLI children over gloo: the pair's parameters after
    round 2 bitwise equal and within the tolerance of the in-process run;
    the elastic ladder in process (the survivors-only and host folds bit
    for bit, the straggler rule's one decision) and across processes
    (process 1 gone before round 3's exchange, process 0 degrading within
    its 10 s timeout + 5 s of the crash); async at zero staleness equal to
    sync and the staleness bound at 4× skew."""
    from tests.test_torch_compression import _chip_smoke

    smoke = _chip_smoke()
    base = _smoke_base(tmp_path)
    cfg_fn = lambda **kw: smoke.collective_config(base=base, **kw)  # noqa: E731
    rec = smoke.collective_leg(np, device="cpu", cfg_fn=cfg_fn, work=tmp_path / "leg",
                               ref_out=tmp_path / "ref.npz")
    x = smoke.collective_pair(np, device="cpu", cfg_fn=cfg_fn, work=tmp_path / "pair",
                              ref=tmp_path / "ref.npz")
    assert x["cli"]["bitwise"] and x["cli"]["backend"] == ["gloo", "gloo"]
    assert x["cli"]["paths"] == [{"1": "collective", "2": "collective"}] * 2
    assert x["rcs"] == [0, 137]
    assert x["paths"] == {"1": "collective", "2": "collective", "3": "host_fallback"}
    assert x["crash_to_round_end_s"] <= smoke.COLL_TIMEOUT_S + smoke.COLL_SLACK_S
    e = rec["elastic"]
    assert e["collective_reconfigured"]["equal_to_fold"] and e["host_fallback"]["equal_to_fold"]
    assert len(e["decisions"]) == 1
    assert rec["async"]["zero_staleness_equal"] and rec["async"]["stale"]["rejected"] >= 1


def test_straggler_rule_decision_matches_jax_on_the_smoke_series(monkeypatch):
    """The decision phase 18 (c) gates on: the straggler fractions of its
    rounds (0, 1/3, 0) through the port's and JAX's autopilot, with the
    smoke's ``COLL_AP`` config and a 30 s stage timeout, give
    ``COLL_AP_DECISION`` and nothing else."""
    import photon_tpu.telemetry as jax_telemetry
    from photon_tpu.config.schema import AutopilotConfig as JaxAutopilotConfig
    from photon_tpu.telemetry.autopilot import Autopilot as JaxAutopilot
    from photon_tpu.telemetry.metrics import MetricsHub as JaxMetricsHub
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.config.schema import AutopilotConfig
    from photon_tpu_torch.telemetry.autopilot import Autopilot
    from photon_tpu_torch.telemetry.metrics import MetricsHub
    from tests.test_torch_compression import _chip_smoke

    smoke = _chip_smoke()

    def decisions(tel, ap_cls, hub_cls, cfg_cls):
        t = [1000.0]
        clock = lambda: t[0]  # noqa: E731
        monkeypatch.setattr(tel, "_METRICS", hub_cls(clock=clock))
        ap = ap_cls(cfg_cls(enabled=True, **smoke.COLL_AP), clock=clock)
        knob = {"timeout": smoke.COLL_AP_TIMEOUT_S}
        ap.register_knob("server/collective_stage_timeout_s", lambda: knob["timeout"],
                         lambda v: knob.__setitem__("timeout", v))
        for frac in smoke.COLL_AP_SERIES:
            tel.metrics_active().gauge("server/collective_straggler_frac").set(frac)
            ap.tick("collective")
            t[0] += 7.0  # a round
        return [(d["event"], d["rule"], d["knob"], d["observed"], d["old"], d["new"])
                for d in ap.decisions]

    ours = decisions(telemetry, Autopilot, MetricsHub, AutopilotConfig)
    theirs = decisions(jax_telemetry, JaxAutopilot, JaxMetricsHub, JaxAutopilotConfig)
    assert ours == theirs == [smoke.COLL_AP_DECISION]
