"""The port's federated round (``photon_tpu_torch.federation``,
``strategy``, ``shm``, ``federated``) against the JAX package's.

All CPU, fp32, a tiny model (d32, 2 layers, 2 heads, seq 16, vocab 64;
``attn_impl: xla`` on the JAX side, the flash kernels' plain versions in
the port), both packages starting from the JAX ``init_params`` carried
across as numpy, inline transport unless a case says otherwise:

1. folds: every strategy's ``aggregate_fit`` gives the JAX package's bits
   on identical client arrays, momenta payloads included; inside the port
   ``host_threads`` 1 and 4 give the same bits;
2. rounds: 2 of 4 clients × 2 rounds on 2 nodes, FedAvg and FedAdam,
   ``aggregate_momenta`` off and on: the same sampled cids, client states
   and cumulative steps; global params within 2e-5 rel L2 per tensor and
   the eval loss within 1e-5 relative after every round (the JAX runs are
   module-scoped fixtures, shared by the cases); one FedAvg round of an MoE
   model (4 experts, top-2) from the same weights;
3. resume: 4 rounds straight equal 2 + resume + 2 (port against port);
   a round checkpoint with strategy state written by either package
   resumes in the other; the two part on resume only by FedAdam's step
   counter, which the JAX server does not read back;
4. one client under FedAvg (η = 1) equals a centralized ``Trainer`` on
   the same stream, and a runtime that does not inject the cumulative
   step breaks that; the liveness tracker follows JAX's state machine;
5. transport: shm segments and objstore payloads cross the packages byte
   for byte;
6. config and CLI: a port-written ``config.yaml`` loads in JAX with equal
   ``fl``/``photon`` fields; ``python -m photon_tpu_torch.federated
   --device cpu`` prints the JAX CLI's keys, and its History times each
   phase of a round; the collective plane, async rounds and telemetry's
   autopilot validate, and a bad value raises JAX's text in both packages
   (``photon.chaos`` is ported: ``tests/test_torch_chaos.py``).
"""

import contextlib
import dataclasses
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from photon_tpu.checkpoint import FileStore as JaxStore
from photon_tpu.checkpoint import ServerCheckpointManager as JaxCkpt
from photon_tpu.codec import params_to_ndarrays as jax_to_ndarrays
from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu.config.schema import (
    FLConfig,
    ModelConfig,
    OptimizerConfig,
    PhotonConfig,
    SchedulerConfig,
    TrainConfig,
)
from photon_tpu.federation import InProcessDriver as JaxDriver
from photon_tpu.federation import NodeAgent as JaxNode
from photon_tpu.federation import ParamTransport as JaxTransport
from photon_tpu.federation import ServerApp as JaxServer
from photon_tpu.models.mpt import init_params as jax_init
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: global params after a round, relative L2 per tensor: the clients' 2
#: ADOPT steps differ by the frameworks' rounding (test_torch_train's pin)
PARAM_REL = 2e-5
EVAL_REL = 1e-5
STRATEGIES = ["fedavg", "nesterov", "fedmom", "fedadam", "fedyogi"]
#: (strategy, aggregate_momenta) of the round parity cases. FedAdam runs
#: at η = 1e-2, τ = 1e-3: at its defaults (η = 1, τ = 1e-9) the first
#: server step is η·sign(g), and the two frameworks' rounding flips the
#: sign of near-zero pseudo-gradient elements (a 2.0 jump each)
ROUND_CASES = [("fedavg", False), ("fedavg", True), ("fedadam", False), ("fedadam", True)]
FL_OPTS = {"fedavg": {}, "fedadam": {"server_learning_rate": 1e-2, "server_tau": 1e-3}}


def _jax_cfg(save_path, strategy="fedavg", momenta=False, **fl_kw) -> JaxConfig:
    fl = dict(n_total_clients=4, n_clients_per_round=2, n_rounds=2, local_steps=2,
              strategy_name=strategy, eval_interval_rounds=1, sample_seed=99,
              aggregate_momenta=momenta, **FL_OPTS.get(strategy, {}))
    fl.update(fl_kw)
    cfg = JaxConfig(
        run_uuid="fedtest",
        model=ModelConfig(d_model=32, n_layers=2, n_heads=2, max_seq_len=16, vocab_size=64,
                          attn_impl="xla", compute_dtype="float32"),
        optimizer=OptimizerConfig(name="adopt", lr=1e-3),
        scheduler=SchedulerConfig(t_warmup=2, t_max=1000),
        train=TrainConfig(global_batch_size=4, device_microbatch_size=2, eval_batches=2,
                          loss_chunk_tokens=20),
        fl=FLConfig(**fl),
        photon=PhotonConfig(save_path=str(save_path), checkpoint=False, host_threads=1),
    )
    cfg.dataset.synthetic = True
    return cfg.validate()


def _port_cfg(jcfg: JaxConfig):
    from photon_tpu_torch.config.schema import Config

    cfg = Config.from_dict(jcfg.to_dict())
    cfg.model.attn_impl = "pallas"  # the flash kernels' plain versions
    return cfg.validate()


@pytest.fixture(scope="module")
def init_arrays():
    """The JAX init, as (names, shapes, dtypes) and numpy arrays."""
    meta, arrays = jax_to_ndarrays(jax_init(_jax_cfg("/unused").model, seed=0))
    return meta, arrays


def _port_meta(meta):
    from photon_tpu_torch.codec.params import ParamsMetadata

    return ParamsMetadata(meta.names, meta.shapes, meta.dtypes)


def _app(pkg, cfg, initial, ckpt_root=None, n_nodes=2):
    if pkg == "jax":
        driver = JaxDriver(cfg, lambda nid: JaxNode(cfg, nid, lambda: JaxTransport("inline")),
                           n_nodes=n_nodes)
        ckpt = JaxCkpt(JaxStore(ckpt_root), cfg.run_uuid) if ckpt_root else None
        return JaxServer(cfg, driver, JaxTransport("inline"), ckpt_mgr=ckpt,
                         initial_params=initial)
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.federation import InProcessDriver, NodeAgent, ParamTransport, ServerApp

    driver = InProcessDriver(cfg, lambda nid: NodeAgent(cfg, nid, lambda: ParamTransport("inline"),
                                                        device="cpu"), n_nodes=n_nodes)
    ckpt = ServerCheckpointManager(FileStore(ckpt_root), cfg.run_uuid) if ckpt_root else None
    meta, arrays = initial
    return ServerApp(cfg, driver, ParamTransport("inline"), ckpt_mgr=ckpt,
                     initial_params=(_port_meta(meta), arrays))


def _drive(app, rounds, save=False):
    """Broadcast, fit, (checkpoint,) broadcast, eval per round; the record
    of each round."""
    sampled = []
    orig = app._sample_clients
    app._sample_clients = lambda: sampled.append(orig()) or sampled[-1]
    out = []
    for r in rounds:
        app.broadcast_parameters(r)
        app.fit_round(r)
        if save:
            app.save_checkpoint(r)
        params = [a.copy() for a in app.strategy.current_parameters]
        app.broadcast_parameters(r)
        loss = app.evaluate_round(r)["server/eval_loss"]
        out.append({"cids": sampled[-1], "params": params, "eval_loss": loss,
                    "client_states": json.loads(json.dumps(app.client_states)),
                    "steps": app.server_steps_cumulative})
    if app.ckpt_mgr is not None:
        app.ckpt_mgr.wait_pending()
    app.driver.shutdown()
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _same_states(got: dict, want: dict) -> None:
    """Client states equal but for their wall times."""
    drop = lambda d: {int(k): {f: v for f, v in s.items() if f != "wall_time_s"}  # noqa: E731
                      for k, s in d.items()}
    assert drop(got) == drop(want)


# ---------------------------------------------------------------------------
# 0. the port's trainer hands out arrays that later steps leave alone
# ---------------------------------------------------------------------------

def test_trainer_getters_return_owned_arrays(init_arrays):
    from photon_tpu_torch.train.trainer import Trainer

    meta, arrays = init_arrays
    trainer = Trainer(_port_cfg(_jax_cfg("/unused")), device="cpu")
    trainer.set_parameters(_port_meta(meta), arrays)
    batch = np.random.default_rng(0).integers(0, 64, (4, 16)).astype(np.int32)
    trainer.fit([batch, batch], 2)  # ADOPT's step 0 applies no update
    got = {"params": trainer.get_parameters()[1], "opt": trainer.get_opt_state_arrays()[1],
           "momenta": [a for ms in trainer.get_momenta() for a in ms]}
    kept = {k: [a.copy() for a in v] for k, v in got.items()}
    trainer.fit([batch], 1)
    trainer.set_parameters(_port_meta(meta), [a * 0 + 1 for a in arrays])
    for k in got:
        assert all(np.array_equal(a, b) for a, b in zip(got[k], kept[k])), k
    assert not np.array_equal(trainer.get_parameters()[1][0], kept["params"][0])


# ---------------------------------------------------------------------------
# 1. folds
# ---------------------------------------------------------------------------

def _client_arrays(rng, momenta):
    shapes = [(7, 5), (3,), (64, 3), (1, 2, 3)]
    arrays = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    if momenta:  # [params | m1 | m2]
        arrays += [rng.normal(0, 1e-2, s).astype(np.float32) for s in shapes]
        arrays += [np.abs(rng.normal(0, 1e-3, s)).astype(np.float32) for s in shapes]
    return arrays


def _fold_run(dispatch, result_cls, name, momenta, threads=1):
    """Two rounds of 3 clients (3, 8 and 5 samples) through a strategy of
    one package: params, state and metrics after each."""
    from photon_tpu_torch.utils.hostpool import HostPool

    rng = np.random.default_rng(3)
    strat = dispatch(FLConfig(strategy_name=name, server_learning_rate=0.7,
                              server_momentum=0.9, server_tau=1e-3))
    if threads > 1:
        strat.host_pool = HostPool(threads)
    strat.initialize(_client_arrays(rng, momenta))
    outs = []
    for rnd in (1, 2):
        clients = [(cid, _client_arrays(rng, momenta), n) for cid, n in enumerate((3, 8, 5))]
        params, metrics = strat.aggregate_fit(
            rnd, (result_cls(cid, a, n, {"m": float(n)}) for cid, a, n in clients))
        outs.append(([p.copy() for p in params],
                     {k: [a.copy() for a in v] for k, v in strat.state_for_checkpoint().items()},
                     {k: v for k, v in metrics.items() if not k.endswith("_time")}))
    if strat.host_pool is not None:
        strat.host_pool.close()
    return outs


@pytest.mark.parametrize("momenta", [False, True])
@pytest.mark.parametrize("name", STRATEGIES)
def test_fold_bits_match_jax(name, momenta):
    from photon_tpu.strategy import ClientResult as JaxResult
    from photon_tpu.strategy import dispatch_strategy as jax_dispatch
    from photon_tpu_torch.config.schema import FLConfig as PortFL
    from photon_tpu_torch.strategy import ClientResult, dispatch_strategy

    def port_dispatch(fl):
        return dispatch_strategy(PortFL(**dataclasses.asdict(fl)))

    want = _fold_run(jax_dispatch, JaxResult, name, momenta)
    for threads in (1, 4):
        got = _fold_run(port_dispatch, ClientResult, name, momenta, threads)
        for (gp, gs, gm), (wp, ws, wm) in zip(got, want):
            assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(gp, wp))
            assert gs.keys() == ws.keys()
            for k in gs:
                assert all(np.array_equal(a, b) for a, b in zip(gs[k], ws[k])), k
            assert gm == wm


# ---------------------------------------------------------------------------
# 2. rounds against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_rounds(tmp_path_factory, init_arrays):
    """The JAX package's 2 rounds for each case; the FedAdam + momenta run
    also writes its round checkpoints (the resume case reads them)."""
    out = {}
    for strategy, momenta in ROUND_CASES:
        root = tmp_path_factory.mktemp(f"jax_{strategy}_{momenta}")
        cfg = _jax_cfg(root / "save", strategy, momenta)
        ckpt = root / "ckpt" if (strategy, momenta) == ("fedadam", True) else None
        app = _app("jax", cfg, init_arrays, ckpt_root=ckpt)
        out[strategy, momenta] = {"rounds": _drive(app, (1, 2), save=ckpt is not None),
                                  "ckpt": ckpt, "cfg": cfg}
    return out


@pytest.mark.parametrize("strategy,momenta", ROUND_CASES)
def test_rounds_match_jax(tmp_path, jax_rounds, init_arrays, strategy, momenta):
    cfg = _port_cfg(_jax_cfg(tmp_path / "save", strategy, momenta))
    got = _drive(_app("port", cfg, init_arrays), (1, 2))
    want = jax_rounds[strategy, momenta]["rounds"]
    for rnd, (g, w) in enumerate(zip(got, want), start=1):
        assert g["cids"] == w["cids"] and g["steps"] == w["steps"] == 2 * rnd
        _same_states(g["client_states"], w["client_states"])
        assert len(g["params"]) == len(w["params"]) == (3 if momenta else 1) * len(init_arrays[1])
        worst = max(_rel(a, b) for a, b in zip(g["params"], w["params"]))
        assert worst <= PARAM_REL, (rnd, worst)
        assert abs(g["eval_loss"] - w["eval_loss"]) <= EVAL_REL * abs(w["eval_loss"])
    assert got[0]["cids"] != got[1]["cids"] or len(set(got[0]["cids"])) == 2


def test_moe_round_matches_jax(tmp_path):
    """One FedAvg round of 2 clients × 2 steps of a tiny MoE model (the
    loss with its aux in every client step), from the same JAX init."""
    def moe_cfg(save):
        cfg = _jax_cfg(save, "fedavg", False)
        cfg.model.mlp, cfg.model.moe_num_experts, cfg.model.moe_top_k = "moe", 4, 2
        return cfg.validate()

    jcfg = moe_cfg(tmp_path / "jax")
    init = jax_to_ndarrays(jax_init(jcfg.model, seed=0))
    assert any(n.endswith("moe_up") for n in init[0].names)
    want = _drive(_app("jax", jcfg, init), (1,))[0]
    got = _drive(_app("port", _port_cfg(moe_cfg(tmp_path / "port")), init), (1,))[0]
    assert got["cids"] == want["cids"] and got["steps"] == want["steps"] == 2
    _same_states(got["client_states"], want["client_states"])
    worst = max(_rel(a, b) for a, b in zip(got["params"], want["params"]))
    assert worst <= PARAM_REL, worst
    assert abs(got["eval_loss"] - want["eval_loss"]) <= EVAL_REL * abs(want["eval_loss"])


# ---------------------------------------------------------------------------
# 3. resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["nesterov", "fedadam"])
def test_resume_matches_uninterrupted(tmp_path, init_arrays, strategy):
    """4 rounds straight vs 2 + resume + 2 (the reference's own pin,
    rtol 1e-5 / atol 1e-7), port against port; client optimizer state is
    round-local (``reset_optimizer``) and loaders fast-forward from the
    client states. FedAdam's step counter ``_t`` resumes with its moments."""
    def cfg_at(d, **kw):
        c = _port_cfg(_jax_cfg(tmp_path / d, strategy, n_rounds=4, server_momentum=0.9,
                               fit_config={"reset_optimizer": True}, eval_interval_rounds=0))
        c.photon.checkpoint = True
        for k, v in kw.items():
            setattr(c.photon, k, v)
        return c

    def fit_rounds(app, rounds):
        for r in rounds:
            app.broadcast_parameters(r)
            app.history.record(r, app.fit_round(r))
            app.save_checkpoint(r)
        app.ckpt_mgr.wait_pending()
        out = [a.copy() for a in app.strategy.current_parameters]
        app.driver.shutdown()
        return out

    straight = fit_rounds(_app("port", cfg_at("a"), init_arrays, tmp_path / "a" / "ck"),
                          range(1, 5))
    fit_rounds(_app("port", cfg_at("b"), init_arrays, tmp_path / "b" / "ck"), (1, 2))
    app = _app("port", cfg_at("b", resume_round=-1), init_arrays, tmp_path / "b" / "ck")
    assert app.try_resume() == 2 and app.start_round == 3
    assert getattr(app.strategy, "_t", 2) == 2
    resumed = fit_rounds(app, (3, 4))
    for x, y in zip(straight, resumed):
        np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-7)


def test_round_checkpoint_resumes_across_packages(tmp_path, jax_rounds, init_arrays):
    """JAX's round-1 checkpoint (FedAdam, momenta: params, both moments and
    the step counter) resumes in the port, whose round 2 lands on JAX's;
    the port's round-1 checkpoint restores in JAX to the same state."""
    case = jax_rounds["fedadam", True]
    jcfg = dataclasses.replace(case["cfg"])
    pcfg = _port_cfg(jcfg)
    pcfg.photon.resume_round = 1
    app = _app("port", pcfg, init_arrays, case["ckpt"])
    assert app.try_resume() == 1 and app.strategy._t == 1
    got = _drive(app, (2,))[0]
    want = case["rounds"][1]
    assert got["cids"] == want["cids"] and got["steps"] == want["steps"]
    _same_states(got["client_states"], want["client_states"])
    assert max(_rel(a, b) for a, b in zip(got["params"], want["params"])) <= PARAM_REL

    # the port writes round 1; JAX resumes from it (a server without nodes)
    pcfg = _port_cfg(_jax_cfg(tmp_path / "p", "fedadam", True))
    port_app = _app("port", pcfg, init_arrays, tmp_path / "ck")
    _drive(port_app, (1,), save=True)
    jcfg = _jax_cfg(tmp_path / "j", "fedadam", True)
    jcfg.photon.resume_round = -1
    japp = JaxServer(jcfg, JaxDriver(jcfg, None, n_nodes=0), JaxTransport("inline"),
                     ckpt_mgr=JaxCkpt(JaxStore(tmp_path / "ck"), jcfg.run_uuid),
                     initial_params=init_arrays)
    assert japp.try_resume() == 1 and japp.start_round == 2
    assert japp.server_steps_cumulative == port_app.server_steps_cumulative == 2
    # the step counter is in the round (JAX's own server does not read it back)
    t = japp.ckpt_mgr.load_round(1, ("_t",))[2]["_t"]
    assert int(t[0][0]) == port_app.strategy._t == 1
    assert all(np.array_equal(a, b) for a, b in zip(japp.strategy.current_parameters,
                                                    port_app.strategy.current_parameters))
    for key in port_app.strategy.state_keys:
        assert all(np.array_equal(a, b) for a, b in zip(japp.strategy.state[key],
                                                        port_app.strategy.state[key]))
    _same_states(japp.client_states, port_app.client_states)
    assert japp._sample_clients() == port_app._sample_clients()


def test_resume_step_counter_parts_from_jax(jax_rounds, init_arrays):
    """Where the packages part on resume: both restore JAX's round-1
    FedAdam checkpoint to the same params and moments, but the JAX server
    does not read back the step counter ``_t`` (its bias correction
    restarts) and the port does. The next server step on one average then
    differs, and by ``_t`` alone: a JAX strategy given the checkpoint's
    ``_t`` lands on the port's bits."""
    import copy

    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.federation import InProcessDriver, ParamTransport, ServerApp

    case = jax_rounds["fedadam", True]

    def jax_resumed():
        jcfg = copy.deepcopy(case["cfg"])
        jcfg.photon.resume_round = 1
        app = JaxServer(jcfg, JaxDriver(jcfg, None, n_nodes=0), JaxTransport("inline"),
                        ckpt_mgr=JaxCkpt(JaxStore(case["ckpt"]), jcfg.run_uuid),
                        initial_params=init_arrays)
        assert app.try_resume() == 1
        return app.strategy

    pcfg = _port_cfg(case["cfg"])
    pcfg.photon.resume_round = 1
    papp = ServerApp(pcfg, InProcessDriver(pcfg, None, n_nodes=0), ParamTransport("inline"),
                     ckpt_mgr=ServerCheckpointManager(FileStore(case["ckpt"]), pcfg.run_uuid),
                     initial_params=(_port_meta(init_arrays[0]), init_arrays[1]))
    assert papp.try_resume() == 1
    port, jax_ = papp.strategy, jax_resumed()
    assert port._t == 1 and jax_._t == 0
    assert all(np.array_equal(a, b) for a, b in zip(port.current_parameters,
                                                    jax_.current_parameters))
    for key in port.state_keys:
        assert all(np.array_equal(a, b) for a, b in zip(port.state[key], jax_.state[key]))

    rng = np.random.default_rng(11)
    avg = [p - np.float32(1e-3) * rng.standard_normal(p.shape).astype(np.float32)
           for p in port.current_parameters]
    port.apply_average(2, [a.copy() for a in avg], 8, 2)
    jax_.apply_average(2, [a.copy() for a in avg], 8, 2)
    assert not all(np.array_equal(a, b) for a, b in zip(port.current_parameters,
                                                        jax_.current_parameters))
    fixed = jax_resumed()
    fixed._t = 1
    fixed.apply_average(2, [a.copy() for a in avg], 8, 2)
    assert port._t == fixed._t == 2
    assert all(np.array_equal(a, b) for a, b in zip(port.current_parameters,
                                                    fixed.current_parameters))
    for key in port.state_keys:
        assert all(np.array_equal(a, b) for a, b in zip(port.state[key], fixed.state[key]))


# ---------------------------------------------------------------------------
# 4. one client under FedAvg is centralized training
# ---------------------------------------------------------------------------

def _single_client_gap(tmp_path, init_arrays, plant_fault):
    """Global params after 2 rounds × 3 steps of one client (FedAvg, η = 1,
    μ = 0) against a ``Trainer`` that ran 6 steps on the same stream:
    max |Δ| over the displacement's scale."""
    from photon_tpu_torch.data import ShardedDataset, StreamingLoader
    from photon_tpu_torch.train.trainer import Trainer

    cfg = _port_cfg(_jax_cfg(tmp_path / "save", "fedavg", n_total_clients=1,
                             n_clients_per_round=1, local_steps=3, eval_interval_rounds=0))
    app = _app("port", cfg, init_arrays, n_nodes=1)
    if plant_fault:
        trainer = app.driver._agents["node0"].runtime.trainer
        sound = trainer.set_step
        trainer.set_step = lambda step: sound(0)  # the cumulative step never injected
    for r in (1, 2):
        app.broadcast_parameters(r)
        app.fit_round(r)
    fed = app.strategy.current_parameters
    app.driver.shutdown()
    central = Trainer(cfg, device="cpu")
    meta, arrays = init_arrays
    central.set_parameters(_port_meta(meta), arrays)
    ds = ShardedDataset(tmp_path / "save" / "synthetic" / "client_0" / "train")
    central.fit(StreamingLoader(ds, cfg.train.global_batch_size, seed=cfg.dataset.shuffle_seed,
                                shuffle=True), 6)
    want = central.get_parameters()[1]
    moved = np.sqrt(sum(np.sum((w - a) ** 2, dtype=np.float64) for w, a in zip(want, arrays)))
    diff = np.sqrt(sum(np.sum((f - w) ** 2, dtype=np.float64) for f, w in zip(fed, want)))
    return float(diff / moved)


def test_single_client_fedavg_is_centralized(tmp_path, init_arrays):
    sound = _single_client_gap(tmp_path / "a", init_arrays, plant_fault=False)
    fault = _single_client_gap(tmp_path / "b", init_arrays, plant_fault=True)
    assert sound <= 1e-5, sound  # fp32 rounding of x − 1·(x − y) only
    assert fault >= 0.1, fault


@pytest.mark.parametrize("fails,budget,raises", [(1, 0, False), (2, 0, True), (2, 1, False)])
def test_failed_client_retried_then_budget(tmp_path, init_arrays, fails, budget, raises):
    """A cid whose fit fails is retried once; a second failure counts
    against ``accept_failures_cnt``."""
    from photon_tpu_torch.federation import FitRes, TooManyFailuresError

    cfg = _port_cfg(_jax_cfg(tmp_path, accept_failures_cnt=budget, eval_interval_rounds=0))
    app = _app("port", cfg, init_arrays)
    left = {"n": fails}
    for agent in app.driver._agents.values():
        sound = agent.runtime.fit

        def flaky(ins, cid, _sound=sound):
            if cid == 1 and left["n"] > 0:
                left["n"] -= 1
                return FitRes(ins.server_round, cid, None, error="RuntimeError: planted")
            return _sound(ins, cid)

        agent.runtime.fit = flaky
    app._sample_clients = lambda: [1, 2]
    app.broadcast_parameters(1)
    if raises:
        with pytest.raises(TooManyFailuresError):
            app.fit_round(1)
    else:
        m = app.fit_round(1)
        assert m["server/n_clients"] == (2 if fails == 1 else 1)
    app.driver.shutdown()


def test_liveness_matches_jax():
    """The liveness state machine against the JAX package's over a scripted
    registry: pings answered, missed, a node leaving and coming back."""
    from photon_tpu.federation.membership import LivenessTracker as JaxTracker
    from photon_tpu.federation.messages import Ack as JaxAck
    from photon_tpu_torch.federation.membership import LivenessTracker
    from photon_tpu_torch.federation.messages import Ack

    script = [  # (registry, nodes that answer the ping)
        (["n0", "n1", "n2"], {"n0", "n1", "n2"}),
        (["n0", "n1", "n2"], {"n0", "n1"}),
        (["n0", "n1"], {"n0", "n1"}),
        (["n0", "n1"], {"n0"}),
        (["n0", "n1", "n2"], {"n0", "n1", "n2"}),
        (["n0", "n1", "n2"], {"n0", "n1", "n2"}),
    ]

    class Driver:
        def __init__(self, ack):
            self.ack, self.replies, self.mid, self.step = ack, [], 0, 0

        def node_ids(self):
            return script[self.step][0]

        def send(self, nid, msg):
            self.mid += 1
            if nid in script[self.step][1]:
                self.replies.append((nid, self.mid, self.ack(ok=True, node_id=nid)))
            return self.mid

        def recv_any(self, timeout=None):
            if not self.replies:
                raise TimeoutError
            return self.replies.pop(0)

    runs = []
    for tracker, ack in ((JaxTracker(ping_timeout_s=0.05), JaxAck),
                         (LivenessTracker(ping_timeout_s=0.05), Ack)):
        drv, got = Driver(ack), []
        for step in range(len(script)):
            drv.step = step
            got.append((sorted(tracker.sweep(drv)), tracker.round_metrics()))
        runs.append(got)
    assert runs[0] == runs[1]
    assert any(m["server/nodes_dead"] for _, m in runs[1])
    assert any(m["server/nodes_readmitted"] for _, m in runs[1])


# ---------------------------------------------------------------------------
# 5. transport across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["shm", "objstore"])
def test_transport_payloads_cross_packages(tmp_path, monkeypatch, writer, mode):
    import photon_tpu.shm.plane as jax_shm
    from photon_tpu_torch.checkpoint import FileStore
    from photon_tpu_torch.codec.params import ParamsMetadata
    from photon_tpu_torch.federation import ParamTransport

    monkeypatch.setattr(jax_shm, "SHM_DIR", tmp_path)
    monkeypatch.setenv("PHOTON_SHM_DIR", str(tmp_path))
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(70, 3)).astype(np.float32), np.arange(5, dtype=np.int32),
              rng.normal(size=(2, 2, 2)).astype(np.float32)]
    names = ["b/w", "a/idx", "c/t"]
    jt = JaxTransport(mode, store=JaxStore(tmp_path / "store"))
    pt = ParamTransport(mode, store=FileStore(tmp_path / "store"))
    w, r = (jt, pt) if writer == "jax" else (pt, jt)
    meta_cls = type(jax_to_ndarrays({"x": np.zeros(1)})[0]) if writer == "jax" else ParamsMetadata
    ptr = w.put("xpkg", meta_cls.from_ndarrays(names, arrays), arrays)
    meta, back = r.get(ptr)
    assert tuple(meta.names) == tuple(names)
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if mode == "shm":
        assert (tmp_path / "photon-xpkg").exists()
    w.free(ptr)
    assert not list(tmp_path.glob("photon-xpkg*"))
    assert not list((tmp_path / "store").rglob("*.npz"))


# ---------------------------------------------------------------------------
# 6. config, CLI and refusals
# ---------------------------------------------------------------------------

_CLI_SETS = ["model.d_model=32", "model.n_layers=2", "model.n_heads=2", "model.max_seq_len=16",
             "model.vocab_size=64", "model.compute_dtype=float32", "fl.local_steps=2",
             "fl.n_total_clients=2", "fl.n_clients_per_round=2", "fl.eval_interval_rounds=2",
             "fl.strategy_name=fedadam", "train.global_batch_size=4",
             "train.device_microbatch_size=2", "train.eval_batches=2", "train.loss_chunk_tokens=20",
             "dataset.synthetic=true", "optimizer.lr=0.001", "photon.host_threads=1"]


def test_cli_prints_jax_keys_and_writes_jax_config(tmp_path):
    from photon_tpu.centralized import _apply_override
    from photon_tpu.federated import main as jax_main

    def argv(save, extra=()):
        out = ["--rounds", "2", "--nodes", "2"]
        for s in [*_CLI_SETS, f"photon.save_path={save}", *extra]:
            out += ["--set", s]
        return out

    cmd = [sys.executable, "-m", "photon_tpu_torch.federated", "--device", "cpu",
           *argv(tmp_path / "port")]
    env = {"PHOTON_SHM_DIR": str(tmp_path), "PATH": "/usr/bin:/bin",
           "PYTHONPATH": ":".join(sys.path)}
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    port_line = json.loads(out.stdout.strip().splitlines()[-1])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_main(argv(tmp_path / "jax", ["photon.comm_stack.shm=false"]))
    jax_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert port_line.keys() == jax_line.keys()
    assert port_line["rounds"] == 2 and port_line["server/pseudo_grad_norm"] > 0
    assert np.isfinite(port_line["server/eval_loss"])
    assert not list(tmp_path.glob("photon-*"))  # the shm segments were freed
    # the config of record loads in JAX with the fields JAX would have set
    want = JaxConfig()
    for s in [*_CLI_SETS, f"photon.save_path={tmp_path / 'port'}"]:
        _apply_override(want, *s.split("=", 1))
    got = JaxConfig.from_yaml(tmp_path / "port" / "config.yaml")
    assert got.fl == want.fl and got.photon == want.photon and got.model == want.model
    # and a JAX config with non-default fl/photon fields survives the port
    from photon_tpu_torch.config.schema import Config

    want.fl.fit_config = {"reset_optimizer": True}
    want.photon.resume_round, want.photon.telemetry.dir = -2, "t"
    want.photon.chaos.seed, want.photon.membership.ping_timeout_s = 7, 2.5
    want.to_yaml(tmp_path / "a.yaml")
    Config.from_yaml(tmp_path / "a.yaml").to_yaml(tmp_path / "b.yaml")
    back = JaxConfig.from_yaml(tmp_path / "b.yaml")
    assert back.fl == want.fl and back.photon == want.photon


def test_cli_history_times_each_phase_of_a_round(tmp_path, monkeypatch):
    """``main`` returns the run's History, which times every phase of each
    round: the broadcast, the clients' set/train/get/put (their mean), the
    fold, the server update, eval and the checkpoint."""
    from photon_tpu_torch.federated import main

    monkeypatch.setenv("PHOTON_SHM_DIR", str(tmp_path))
    argv = ["--device", "cpu", "--rounds", "2", "--nodes", "2"]
    for s in [*_CLI_SETS, f"photon.save_path={tmp_path / 'run'}"]:
        argv += ["--set", s]
    with contextlib.redirect_stdout(io.StringIO()):
        history = main(argv)
    for key in ("server/broadcast_pre_time", "server/round_time", "server/agg_fold_time",
                "server/server_update_time", "server/checkpoint_time",
                "client/fit_set_parameters_time", "client/fit_time",
                "client/get_parameters_time", "client/put_time", "node_training_time_s"):
        got = history.series(key)
        assert {1, 2} <= {r for r, _ in got} and all(v >= 0 for _, v in got), key
    for key in ("server/eval_round_time", "server/eval_loss"):
        assert [r for r, _ in history.series(key)] == [0, 2], key
    mean = {k: history.series(k)[0][1] for k in (
        "client/fit_init_time", "client/fit_time", "client/get_parameters_time",
        "client/put_time", "node_training_time_s")}
    assert mean["node_training_time_s"] >= sum(v for k, v in mean.items()
                                               if k != "node_training_time_s")


#: federation features the port once refused and now runs: (the edit that
#: turns each on, an invalid value and the JAX package's text for it)
FEDERATION_FEATURES = {
    "collective": (lambda p: p["comm_stack"].update(collective=True, shm=False),
                   lambda p: p["comm_stack"].update(collective_quorum=0.0),
                   "comm_stack.collective_quorum must be in (0, 1]"),
    "telemetry": (lambda p: (p["telemetry"].update(enabled=True),
                             p["telemetry"]["autopilot"].update(enabled=True, straggler_p90=0.5)),
                  lambda p: p["telemetry"].update(prom_port=-1),
                  "telemetry.prom_port must be in [0, 65535]"),
    "async_rounds": (lambda p: (p["comm_stack"].update(collective=True, shm=False),
                                p["async_rounds"].update(enabled=True)),
                     lambda p: p["async_rounds"].update(min_arrivals=0),
                     "async_rounds.min_arrivals must be in [1, K=4]"),
}


@pytest.mark.parametrize("feature", ["collective", "telemetry", "async_rounds"])
def test_unported_federation_features_refused(tmp_path, feature):
    """The collective plane, async rounds and telemetry's autopilot with its
    collective rule validate in both packages when on,
    and an invalid value raises the JAX package's ValueError text in both
    (each was once refused here with NotImplementedError)."""
    from photon_tpu_torch.config.schema import Config

    on, bad, text = FEDERATION_FEATURES[feature]
    d = _jax_cfg(tmp_path).to_dict()
    on(d["photon"])
    JaxConfig.from_dict(d).validate()
    Config.from_dict(d).validate()
    bad(d["photon"])
    with pytest.raises(ValueError) as want:
        JaxConfig.from_dict(d).validate()
    with pytest.raises(ValueError, match=text.replace("[", r"\[").replace("(", r"\(")) as got:
        Config.from_dict(d).validate()
    assert str(got.value) == str(want.value)
