"""MoE on an expert mesh and a pipelined client through the port's
federated round loop (the counterparts of
``tests/test_parallel_federation.py``).

Each client trains on a mesh that repeats the CPU (``expert 2`` for the MoE
model, ``pipe 2`` for the pipelined one) inside the port's in-process
driver; the codec, the strategy and the round state stay a single
device's, so the rounds run unchanged. Beyond JAX's checks (two rounds
recorded, finite pseudo-gradient norms, the expert leaves aggregated), the
global parameters after the rounds equal those of the same rounds with
single-device clients (relative L2 2e-5 a tensor, the federation tests'
tolerance).
"""

import numpy as np
import pytest

from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu_torch.config.schema import Config
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread
from tests.test_federation import make_cfg as jax_make_cfg

PARAM_REL = 2e-5  # tests/test_torch_federation.py's


def _cfg(tmp_path, name: str, mesh: dict, **model) -> Config:
    jcfg: JaxConfig = jax_make_cfg(tmp_path / name, n_rounds=2)
    d = jcfg.to_dict()
    d["model"].update(model)
    d["mesh"].update(mesh)
    d["train"]["device_microbatch_size"] = 2 if mesh else 4
    return Config.from_dict(d).validate()


def _run(cfg: Config):
    from photon_tpu_torch.federation import InProcessDriver, NodeAgent, ParamTransport, ServerApp

    agents = []

    def agent(nid):
        agents.append(NodeAgent(cfg, nid, lambda: ParamTransport("inline"), device="cpu"))
        return agents[-1]

    app = ServerApp(cfg, InProcessDriver(cfg, agent, n_nodes=2), ParamTransport("inline"))
    try:
        history = app.run()
        meshes = [a.runtime.trainer.mesh for a in agents]
    finally:
        app.driver.shutdown()
    return app, history, meshes


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("case", ["moe_expert_mesh", "pipelined_client"])
def test_fed_rounds_with_parallel_clients(tmp_path, case):
    """``moe_expert_mesh``: an MoE model (4 experts, top-2) whose clients
    train on ``expert 2``: the router and expert leaves ride the codec and
    the aggregation. ``pipelined_client``: each client trains through the
    GPipe pipeline on ``pipe 2`` (microbatch 2; ``auto`` is refused under
    ``pipe``)."""
    if case == "moe_expert_mesh":
        mesh, model = dict(expert=2), dict(mlp="moe", moe_num_experts=4, moe_top_k=2)
    else:
        mesh, model = dict(pipe=2), {}
    app, history, meshes = _run(_cfg(tmp_path, "meshed", mesh, **model))
    assert len(history.series("server/round_time")) == 2
    assert all(np.isfinite(v) for _, v in history.series("server/pseudo_grad_norm"))
    names = list(app.metadata.names)
    if case == "moe_expert_mesh":
        assert any("moe_up" in n for n in names) and any("router" in n for n in names)
    axes = dict.fromkeys(("data", "fsdp", "tensor", "sequence", "pipe", "expert"), 1)
    assert [m.shape for m in meshes] == [{**axes, **mesh}] * 2
    one, _, _ = _run(_cfg(tmp_path, "single", {}, **model))
    worst = max(_rel(a, b) for a, b in zip(app.strategy.current_parameters,
                                           one.strategy.current_parameters))
    assert worst <= PARAM_REL, worst


def test_parallel_client_configs_validate_as_jax():
    """The two clients' configs validate in both packages; ``auto`` under
    ``pipe`` is refused by both with JAX's text."""
    for mesh, model in ((dict(expert=2), dict(mlp="moe", moe_num_experts=4)),
                        (dict(pipe=2), {})):
        d = Config().to_dict()
        d["model"].update(model)
        d["mesh"].update(mesh)
        d["train"]["device_microbatch_size"] = 2
        JaxConfig.from_dict(d).validate()
        Config.from_dict(d).validate()
    d["train"]["device_microbatch_size"] = "auto"
    with pytest.raises(ValueError) as want:
        JaxConfig.from_dict(d).validate()
    with pytest.raises(ValueError) as got:
        Config.from_dict(d).validate()
    assert str(got.value) == str(want.value)
