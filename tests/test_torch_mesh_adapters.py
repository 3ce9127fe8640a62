"""LoRA, adapters, frozen parameters, the ``auto`` probe and the collective
plane on a client's mesh, held to the JAX package.

One process drives every position of a mesh that repeats the CPU
(``parallel/spmd.py``); JAX's Trainer runs the same mesh on the conftest's
8 fake CPU devices, from the same weights (carried by the codec). Tiny
shapes (2 layers, d64, seq 32, fp32), at JAX's parallel tolerance (rtol
2e-4, atol 2e-5):

- a meshed LoRA fit (the base frozen, B made nonzero so every slice
  counts) against JAX's meshed Trainer and the port's one-device run, on
  ``data 2 × fsdp 2 × tensor 2``, ``fsdp 2 × tensor 2 × sequence 2`` with
  ``ring``, and ``tensor 2 × pipe 2`` (JAX's pipelined step runs LoRA);
- frozen leaves on a mesh: bit-equal after the steps, no optimizer state
  (JAX's masked tree, its names), the trainable ones at JAX's values;
- the ``auto`` probe on a mesh: JAX's pick on the same mesh and cap, an
  OOM halving it, JAX's ``ValueError`` text where no candidate divides;
- an adapter round on a mesh (``AdapterTrainPlane.run_round`` over a
  ``ClientRuntime`` on ``tensor 2``): its adapters equal those of the same
  round over JAX's ``ClientRuntime`` on the same mesh;
- a collective round with ``cfg.mesh`` larger than one device: JAX's
  runner within rtol 1e-3 / atol 5e-5, the port's mesh-1 run bit for bit,
  and JAX's attention route (``ring`` under ``sequence 2``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu_torch.config.schema import Config
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

RTOL, ATOL = 2e-4, 2e-5  # JAX's (tests/test_parallel.py)
RUN_TOL = dict(rtol=1e-3, atol=5e-5)  # tests/test_collective_round.py's
TARGETS = ["wqkv", "out_proj", "up_proj", "down_proj"]
BASE_FREEZE = r"^(?!.*_lora_)"
MESHES = {"dp2fsdp2tp2": (dict(data=2, fsdp=2, tensor=2), "xla", 8),
          "fsdp2tp2sp2_ring": (dict(fsdp=2, tensor=2, sequence=2), "ring", 8),
          "tp2pp2": (dict(tensor=2, pipe=2), "xla", 4)}


def _jcfg(mesh: dict, attn: str = "xla", micro: int = 8, lora: bool = True,
          freeze=(BASE_FREEZE,)) -> JaxConfig:
    cfg = JaxConfig()
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size = 64, 2, 4, 32, 256
    m.attn_impl, m.compute_dtype = attn, "float32"
    if lora:
        m.lora_rank, m.lora_alpha, m.lora_targets = 4, 8.0, tuple(TARGETS)
    for axis, size in mesh.items():
        setattr(cfg.mesh, axis, size)
    cfg.optimizer.name, cfg.optimizer.lr = "adamw", 1e-2
    cfg.optimizer.freeze_patterns = list(freeze)
    cfg.scheduler.t_warmup, cfg.scheduler.t_max = 0, 20
    cfg.train.global_batch_size, cfg.train.device_microbatch_size = 8, micro
    return cfg.validate()


def _port(jcfg: JaxConfig) -> Config:
    return Config.from_dict(jcfg.to_dict()).validate()


def _weights(jcfg: JaxConfig, seed=0):
    """JAX's init with every LoRA B made nonzero (a fresh B is zero, which
    would leave the column slices of B untested in the first step); the
    same tree for the port through the codec."""
    from photon_tpu.codec.params import params_to_ndarrays, unflatten_params
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.codec.params import params_from_numpy

    meta, arrays = params_to_ndarrays(init_params(jcfg.model, seed=seed))
    rng = np.random.default_rng(seed + 1)
    arrays = [rng.normal(0, 0.05, a.shape).astype(a.dtype) if n.endswith("_lora_b") else a
              for n, a in zip(meta.names, arrays)]
    jp = unflatten_params(init_params(jcfg.model, seed=seed), arrays)
    return jp, meta, arrays, lambda cfg: params_from_numpy(meta.names, arrays, cfg.model)


def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (8, 32)).astype(np.int32) for _ in range(n)]


def _fit(trainer, batches):
    return [trainer.fit([b], duration_steps=1) for b in batches]


@pytest.mark.parametrize("name", list(MESHES))
def test_meshed_lora_fit_matches_jax_and_one_device(name):
    """The meshed port Trainer under LoRA against JAX's meshed Trainer and
    the port's one-device Trainer: losses and param norms step by step,
    and every parameter after 3 steps; the base is bit-frozen in all
    three; the meshed optimizer state has JAX's names (the freeze
    prefix, A/B moments only)."""
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.train.trainer import Trainer

    axes, attn, micro = MESHES[name]
    jcfg = _jcfg(axes, attn, micro)
    jp, meta, arrays, port_params = _weights(jcfg)
    batches = _batches()
    jt = JaxTrainer(dataclasses.replace(jcfg), params=jp)
    pcfg = _port(jcfg)
    pt = Trainer(pcfg, params=port_params(pcfg), device="cpu")
    assert pt.mesh is not None and pt.mesh.shape == {**dict.fromkeys(pt.mesh.shape, 1), **axes}
    assert pt.model.cfg.attn_impl == jt.model.cfg.attn_impl
    one_j = _jcfg({}, "xla" if attn == "xla" else "pallas", 8 if "pipe" not in axes else 4)
    one_cfg = _port(one_j)
    one = Trainer(one_cfg, params=port_params(one_cfg), device="cpu")
    jm, pm, om = _fit(jt, batches), _fit(pt, batches), _fit(one, batches)
    for key in ("loss", "param_norm"):
        np.testing.assert_allclose([m[key] for m in pm], [m[key] for m in jm],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
        np.testing.assert_allclose([m[key] for m in pm], [m[key] for m in om],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    # under LoRA the port's grad_norm counts A/B alone, on a mesh as on one device
    np.testing.assert_allclose([m["grad_norm"] for m in pm], [m["grad_norm"] for m in om],
                               rtol=RTOL, atol=ATOL)
    (pmeta, pa), (_, ja), (_, oa) = pt.get_parameters(), jt.get_parameters(), one.get_parameters()
    assert pmeta.names == meta.names
    for n, x, y, z, a0 in zip(meta.names, pa, ja, oa, arrays):
        if "_lora_" in n:
            assert not np.array_equal(x, a0), n  # the factors trained
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=n)
            np.testing.assert_allclose(x, z, rtol=RTOL, atol=ATOL, err_msg=n)
        else:
            for got in (x, y, z):
                np.testing.assert_array_equal(got, a0, err_msg=n)
    om_meta, _ = pt.get_opt_state_arrays()
    assert om_meta.names == jt.get_opt_state_arrays()[0].names
    assert all(s.requires_grad == ("_lora_" in n)
               for n, st in pt.state.params.items() for s in st.shards.values())


def test_frozen_leaves_on_a_mesh_match_jax_masked_tree():
    """``optimizer.freeze_patterns`` without LoRA on ``data 2 × fsdp 2 ×
    tensor 2``: the frozen leaves bit-equal after 3 AdamW steps with weight
    decay (no update, no decay), no moments for them (JAX's
    ``multi_transform`` tree, name for name), the clip's norm over the
    trainable leaves only, and the rest at JAX's values; ``reset_optimizer``
    and ``set_step`` keep the layout."""
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.train.trainer import Trainer

    jcfg = _jcfg(dict(data=2, fsdp=2, tensor=2), lora=False, freeze=("wte", "ln_"))
    jcfg.optimizer.weight_decay, jcfg.optimizer.grad_clip_norm = 0.1, 0.05
    jcfg = jcfg.validate()
    jp, meta, arrays, port_params = _weights(jcfg)
    batches = _batches(seed=1)
    jt = JaxTrainer(dataclasses.replace(jcfg), params=jp)
    pcfg = _port(jcfg)
    pt = Trainer(pcfg, params=port_params(pcfg), device="cpu")
    jm, pm = _fit(jt, batches), _fit(pt, batches)
    for key in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose([m[key] for m in pm], [m[key] for m in jm],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    frozen = [n for n in meta.names if "wte" in n or "ln_" in n]
    assert frozen and len(frozen) < len(meta.names)
    (_, pa), (_, ja) = pt.get_parameters(), jt.get_parameters()
    for n, x, y, a0 in zip(meta.names, pa, ja, arrays):
        if n in frozen:
            np.testing.assert_array_equal(x, a0, err_msg=n)
            np.testing.assert_array_equal(y, a0, err_msg=n)
        else:
            assert not np.array_equal(x, a0), n
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=n)
    om, oa = pt.get_opt_state_arrays()
    jom, joa = jt.get_opt_state_arrays()
    assert om.names == jom.names and om.dtypes == jom.dtypes
    assert not any(n.endswith("/" + f) for n in om.names for f in frozen)
    for n, x, y in zip(om.names, oa, joa):
        np.testing.assert_allclose(x, y, rtol=1e-3, atol=ATOL, err_msg=n)
    pt.reset_optimizer()
    pt.set_step(7)
    assert pt.get_opt_state_arrays()[0].names == om.names
    m1, _ = pt.get_momenta()
    assert all(not a.any() for a in m1)


def _auto_pair(mesh: dict, gbs: int, cap: int = 0):
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.train.trainer import Trainer

    jcfg = _jcfg(mesh, lora=False, freeze=())
    jcfg.train.global_batch_size, jcfg.train.device_microbatch_size = gbs, "auto"
    jcfg.train.auto_microbatch_cap = cap
    jcfg = jcfg.validate()
    return JaxTrainer(dataclasses.replace(jcfg), init_seed=0), Trainer(_port(jcfg), init_seed=0,
                                                                       device="cpu")


@pytest.mark.parametrize("mesh,gbs,cap,want", [
    (dict(data=2), 8, 0, 4),
    (dict(data=2, tensor=2), 8, 2, 2),
    (dict(data=2, fsdp=2), 12, 0, 1),  # 2 × 4 rows do not divide 12
], ids=["dp2", "dp2tp2-cap2", "dp2fsdp2-b12"])
def test_auto_probe_on_a_mesh_picks_jax_microbatch(mesh, gbs, cap, want):
    jt, pt = _auto_pair(mesh, gbs, cap)
    assert pt.mesh is not None
    assert pt.device_microbatch_size == jt.device_microbatch_size == want
    assert pt._n_micro == jt._n_micro
    assert pt.auto_probe["tried"][-1] == (want, "ok")
    m = pt.train_batch(np.random.default_rng(0).integers(0, 256, (gbs, 32)))
    assert np.isfinite(float(m["loss"]))


def test_auto_probe_on_a_mesh_halves_on_oom_and_raises_jax_text(monkeypatch):
    """An OOM on the meshed step halves the candidate (the tried list in
    order, state and cache freed); where no candidate × dp divides the
    batch the probe raises JAX's ``ValueError`` text."""
    import jax

    from photon_tpu.train.train_step import init_train_state as jax_init_state
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.parallel import spmd
    from photon_tpu_torch.train.trainer import Trainer

    real = spmd.MeshModel.loss

    def loss(self, params, tokens, chunk):
        if next(iter(tokens.values())).shape[0] > 2:  # rows per microbatch over dp 2
            raise torch.cuda.OutOfMemoryError("simulated")
        return real(self, params, tokens, chunk)

    monkeypatch.setattr(spmd.MeshModel, "loss", loss)
    jcfg = _jcfg(dict(data=2), lora=False, freeze=())
    jcfg.train.device_microbatch_size = "auto"
    pt = Trainer(_port(jcfg.validate()), init_seed=0, device="cpu")
    assert pt.auto_probe["tried"] == [(4, "oom"), (2, "oom"), (1, "ok")]
    assert pt.device_microbatch_size == 1 and pt._n_micro == 4
    monkeypatch.setattr(spmd.MeshModel, "loss", real)

    jt, pt = _auto_pair(dict(data=2, fsdp=2), 8)
    jt.cfg.train.global_batch_size = pt.cfg.train.global_batch_size = 6
    with pytest.raises(ValueError) as want:
        jt._probe_microbatch(jax.device_get(jax_init_state(jt.model, jt.tx, jt.state.params)), 4)
    with pytest.raises(ValueError) as got:
        pt._probe_microbatch(init_params(pt.cfg.model, seed=0), 4)
    assert str(got.value) == str(want.value)


def test_adapter_round_on_a_mesh_matches_jax_runtime(tmp_path):
    """One adapter round (two cohorts, three clients, 2 local steps) on
    ``tensor 2``: ``AdapterTrainPlane.run_round`` over the port's
    ``ClientRuntime`` (its Trainer on ``cfg.mesh``) and over JAX's
    ``ClientRuntime`` on the same mesh; the cohorts' adapters after the
    fold agree within the adapter tests' tolerance, the base never moves,
    and the adapter lists keep the codec's order."""
    from photon_tpu.adapters import configure_adapter_training as jax_configure
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.federation.client_runtime import ClientRuntime as JaxRuntime
    from photon_tpu.federation.transport import ParamTransport as JaxTransport
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.adapters import AdapterTrainPlane, configure_adapter_training
    from photon_tpu_torch.codec.params import ParamsMetadata
    from photon_tpu_torch.federation.client_runtime import ClientRuntime
    from photon_tpu_torch.federation.transport import ParamTransport

    def cfg(name):
        c = _jcfg(dict(tensor=2), lora=False, freeze=())
        c.photon.adapters.enabled, c.photon.adapters.rank = True, 4
        c.photon.adapters.targets = list(TARGETS)
        c.photon.adapters.cohorts = {"a": [0, 1], "b": [2]}
        c.fl.local_steps, c.fl.n_total_clients, c.fl.n_clients_per_round = 2, 3, 3
        c.fl.fit_config = {"reset_optimizer": True}
        c.train.global_batch_size, c.train.device_microbatch_size = 4, 2
        c.dataset.synthetic = True
        c.photon.save_path = str(tmp_path / name)
        return c.validate()

    base = _jcfg({}, lora=False, freeze=())
    meta, arrays = params_to_ndarrays(init_params(base.model, seed=0))
    pmeta = ParamsMetadata(meta.names, meta.shapes, meta.dtypes)
    jcfg = jax_configure(cfg("jax")).validate()
    pcfg = configure_adapter_training(_port(cfg("port"))).validate()
    planes = [AdapterTrainPlane(pcfg, pmeta, arrays) for _ in range(2)]
    jrt = JaxRuntime(jcfg, JaxTransport("inline"))
    prt = ClientRuntime(pcfg, ParamTransport("inline"), device="cpu")
    planes[0].run_round(jrt, 1, [0, 1, 2])
    planes[1].run_round(prt, 1, [0, 1, 2])
    assert prt.trainer.mesh is not None and prt.trainer.mesh.shape["tensor"] == 2
    assert dict(jrt.trainer.mesh.shape)["tensor"] == 2
    assert list(planes[1].ameta.names) == sorted(planes[1].ameta.names)
    for p in planes:
        for x, y in zip(p.base_arrays, arrays):
            np.testing.assert_array_equal(x, y)
    for name in ("a", "b"):
        for n, x, y in zip(planes[1].ameta.names, planes[1].strategies.params(name),
                           planes[0].strategies.params(name)):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=f"{name} {n}")
    assert any(not np.array_equal(x, y) for x, y in zip(planes[1].strategies.params("a"),
                                                         planes[1].strategies.params("b")))


def _coll_jcfg(tmp_path, name: str, mesh: dict) -> JaxConfig:
    from tests.test_torch_collective_round import _jax_cfg

    cfg = _jax_cfg(tmp_path, name=name, n_clients=2)
    cfg.model.attn_impl = "pallas"
    for axis, size in mesh.items():
        setattr(cfg.mesh, axis, size)
    return cfg.validate()


@pytest.mark.parametrize("mesh,route", [(dict(data=2), "pallas"), (dict(sequence=2), "ring")],
                         ids=["data2", "sequence2"])
def test_collective_round_with_a_client_mesh_matches_jax(tmp_path, mesh, route):
    """The collective runner pins its client's Trainer to one device, as
    JAX's does, and derives the model from ``cfg.mesh`` as JAX's Trainer
    does (``sequence 2``: ``ring``). Two rounds: JAX's runner within rtol
    1e-3 / atol 5e-5, the port's run with a one-device ``cfg.mesh`` bit for
    bit."""
    from photon_tpu.federation.collective_round import CollectiveFedRunner as JaxRunner
    from photon_tpu_torch.federation.collective_round import CollectiveFedRunner

    jrunner = JaxRunner(_coll_jcfg(tmp_path, "jax", mesh), [0, 1])
    initial = [p.copy() for p in jrunner.strategy.current_parameters]
    runs = {}
    for tag, m in (("mesh", mesh), ("one", {})):
        r = CollectiveFedRunner(_port(_coll_jcfg(tmp_path, tag, m)), [0, 1], device="cpu")
        r.load_server_state([p.copy() for p in initial])
        r.run()
        runs[tag] = r
    jrunner.run()
    trainer = runs["mesh"].runtime.trainer
    assert trainer.mesh is None and trainer.model.cfg.attn_impl == route
    assert jrunner.runtime.trainer.model.cfg.attn_impl == route
    for g, o, j in zip(runs["mesh"].strategy.current_parameters,
                       runs["one"].strategy.current_parameters,
                       jrunner.strategy.current_parameters):
        assert g.tobytes() == o.tobytes()
        np.testing.assert_allclose(g, j, **RUN_TOL)
