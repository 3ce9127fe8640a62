"""The port's mesh, sharding rules and mesh refusals against the JAX package.

``photon_tpu_torch.parallel.mesh``, ``context`` and ``sharding`` against
``photon_tpu.parallel`` on the conftest's 8 fake CPU devices (the port's
mesh repeats the CPU): the axes, size and surplus policy
(``tests/test_parallel.py``), every parameter's spec, each position's
shard shape against JAX's ``addressable_shards`` for the same device
index, indivisible axes dropped, the optimizer-state specs (JAX's shape
lookup, quirk included), ``effective_model_config``, and the
combinations ``Config.validate()`` accepts or refuses as JAX's does.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from photon_tpu.config.schema import MeshConfig as JaxMeshConfig
from photon_tpu.config.schema import ModelConfig as JaxModelConfig
from photon_tpu.models.mpt import init_params as jax_init
from photon_tpu.parallel import make_mesh as jax_make_mesh
from photon_tpu.parallel import param_specs as jax_param_specs
from photon_tpu_torch.config.schema import Config, MeshConfig, ModelConfig
from photon_tpu_torch.parallel.context import current_mesh, use_mesh
from photon_tpu_torch.parallel.mesh import AXES, make_mesh, single_device_mesh
from photon_tpu_torch.parallel.sharding import (
    ShardedTensor,
    batch_spec,
    param_specs,
    shard_params,
    state_shardings,
)
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

TINY = dict(d_model=64, n_layers=2, n_heads=4, max_seq_len=32, vocab_size=256,
            attn_impl="xla", compute_dtype="float32")
LLAMA = dict(TINY, rope=True, learned_pos_emb=False, n_kv_heads=2, mlp="swiglu",
             norm="rmsnorm", tie_embeddings=False)
MESHES = {"fsdp4tp2": dict(fsdp=4, tensor=2), "dp2fsdp2tp2": dict(data=2, fsdp=2, tensor=2),
          "fsdp2tp2sp2": dict(fsdp=2, tensor=2, sequence=2), "tp8": dict(tensor=8)}


def _cpu(n):
    return ["cpu"] * n


def _spec(jspec, rank):
    """A JAX ``PartitionSpec`` as the port's tuple of ``rank`` entries."""
    out = tuple(jspec) + (None,) * (rank - len(tuple(jspec)))
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in out)


def _flat_jax(tree, prefix=""):
    """A JAX tree as ``{"a/b": leaf}`` in sorted name order (the codec's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_jax(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return dict(sorted(out.items()))


def test_mesh_axes_and_size():
    mesh = make_mesh(MeshConfig(data=2, fsdp=2, tensor=2), devices=_cpu(8))
    assert mesh.shape == {"data": 2, "fsdp": 2, "tensor": 2, "sequence": 1, "pipe": 1,
                          "expert": 1}
    assert mesh.axis_names == AXES == jax_make_mesh(JaxMeshConfig(data=2)).axis_names
    assert mesh.size == 8 and mesh.devices.shape == (2, 2, 2, 1, 1, 1)
    assert mesh.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="mesh needs 16 devices, have 8"):
        make_mesh(MeshConfig(data=16), devices=_cpu(8))
    # the default is the local cards; this host has none
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 0"):
        make_mesh(MeshConfig(data=2))
    one = single_device_mesh("cpu")
    assert one.size == 1 and one.shape == {a: 1 for a in AXES}
    from photon_tpu.parallel.sharding import batch_spec as jax_batch_spec

    assert batch_spec(mesh) == _spec(jax_batch_spec(jax_make_mesh(JaxMeshConfig(data=2))), 2)


def test_mesh_surplus_devices_knob():
    """JAX's surplus policy: a device list that is not a whole multiple of
    the mesh size warns (default), raises under 'error', and stays silent
    under 'ignore' or for an exact multiple."""
    with pytest.warns(UserWarning, match="2 device"):
        mesh = make_mesh(MeshConfig(data=3), devices=_cpu(8))
    assert mesh.devices.size == 3
    with pytest.raises(ValueError, match="not a whole multiple"):
        make_mesh(MeshConfig(data=3, surplus_devices="error"), devices=_cpu(8))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_mesh(MeshConfig(data=3, surplus_devices="ignore"), devices=_cpu(8))
        make_mesh(MeshConfig(data=4), devices=_cpu(8))
        make_mesh(MeshConfig(data=8), devices=_cpu(8))


def test_use_mesh_nests():
    a = make_mesh(MeshConfig(data=2), devices=_cpu(2))
    b = make_mesh(MeshConfig(tensor=2), devices=_cpu(2))
    assert current_mesh() is None
    with use_mesh(a):
        with use_mesh(b):
            assert current_mesh() is b
        assert current_mesh() is a
    assert current_mesh() is None


@pytest.mark.parametrize("model", ["mpt", "llama"])
@pytest.mark.parametrize("axes", list(MESHES.values()), ids=list(MESHES))
def test_param_specs_and_shard_shapes_match_jax(model, axes):
    """Every parameter's spec equals JAX's, and each position's shard
    shape equals the shape of JAX's addressable shard on the device of
    the same mesh index."""
    kw = TINY if model == "mpt" else LLAMA
    jmesh = jax_make_mesh(JaxMeshConfig(**axes))
    jparams = jax_init(JaxModelConfig(**kw), seed=0)
    jflat = _flat_jax(jax_param_specs(jparams, jmesh))
    mesh = make_mesh(MeshConfig(**axes), devices=_cpu(8))
    flat = {n: np.asarray(a) for n, a in _flat_jax(jparams).items()}
    specs = param_specs(flat, mesh)
    assert list(specs) == list(jflat)
    jdev_index = {d: i for i, d in enumerate(jmesh.devices.flat)}
    sharded = shard_params(flat, mesh)
    for name, a in flat.items():
        assert specs[name] == _spec(jflat[name], a.ndim), name
        placed = jax.device_put(a, jax.sharding.NamedSharding(jmesh, jflat[name]))
        st = sharded[name]
        for shard in placed.addressable_shards:
            p = jdev_index[shard.device]
            got = st.shards[st.keys[p]]
            assert tuple(got.shape) == tuple(shard.data.shape), (name, p)
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
        np.testing.assert_array_equal(st.to_full().numpy(), a)


def test_param_specs_rules():
    mesh = make_mesh(MeshConfig(fsdp=4, tensor=2), devices=_cpu(8))
    from photon_tpu_torch.models.mpt import init_params

    specs = param_specs(init_params(ModelConfig(**TINY), seed=0), mesh)
    blk = specs["blocks"]["block"]
    assert blk["wqkv"]["kernel"] == ("pipe", "fsdp", "tensor")
    assert blk["out_proj"]["kernel"] == ("pipe", "tensor", "fsdp")
    assert specs["wte"]["embedding"] == ("fsdp", "tensor")
    assert blk["ln_1"]["scale"] == ("pipe", None)
    assert specs["ln_f"]["scale"] == (None,)


def test_spec_drops_indivisible_axes():
    mesh = make_mesh(MeshConfig(fsdp=8), devices=_cpu(8))
    jmesh = jax_make_mesh(JaxMeshConfig(fsdp=8))
    for cols in (64, 60):
        a = np.zeros((2, cols))
        assert param_specs({"wpe": a}, mesh)["wpe"] == \
            _spec(jax_param_specs({"wpe": a}, jmesh)["wpe"], 2)
    assert param_specs({"wpe": np.zeros((2, 64))}, mesh)["wpe"] == (None, "fsdp")
    assert param_specs({"wpe": np.zeros((2, 60))}, mesh)["wpe"] == (None, None)


def test_state_shardings_match_jax():
    """The optimizer moments take the spec of the first parameter of
    their shape (JAX's ``setdefault``): a ``[L, d]`` norm scale's moment
    gets ``down_proj/bias``'s fsdp spec, as in JAX."""
    import optax

    from photon_tpu.parallel.sharding import state_shardings as jax_state_shardings
    from photon_tpu.train.train_step import TrainState
    from photon_tpu_torch.optim.build import build_optimizer

    kw = dict(TINY, no_bias=False)
    jmesh = jax_make_mesh(JaxMeshConfig(fsdp=4, tensor=2))
    jparams = jax_init(JaxModelConfig(**kw), seed=0)
    jstate = TrainState(step=np.zeros((), np.int32), params=jparams,
                        opt_state=optax.adamw(1e-3).init(jparams))
    jsh = jax_state_shardings(jstate, jmesh)
    jmu = _flat_jax(jsh.opt_state[0].mu)
    cfg = Config(model=ModelConfig(**kw))
    tx, _ = build_optimizer(cfg.optimizer, cfg.scheduler)
    flat = {n: np.asarray(a) for n, a in _flat_jax(jparams).items()}
    state = tx.init({n: torch.from_numpy(a) for n, a in flat.items()})
    specs = state_shardings(flat, state, make_mesh(MeshConfig(fsdp=4, tensor=2),
                                                   devices=_cpu(8)))
    for name, a in flat.items():
        m_key = tx.moment_names(name)[0]
        assert specs[m_key] == _spec(jmu[name].spec, a.ndim), name
    # the quirk: a norm scale's moment is sharded like a bias of its shape
    assert specs[tx.moment_names("blocks/block/ln_1/scale")[0]] == ("pipe", "fsdp")
    assert all(specs[c] == () for c in tx.counts)


def test_sharded_tensor_gather_is_differentiable():
    mesh = make_mesh(MeshConfig(fsdp=2, tensor=2), devices=_cpu(4))
    full = torch.arange(2 * 8 * 6, dtype=torch.float32).reshape(2, 8, 6)
    st = ShardedTensor.from_full(full, ("pipe", "fsdp", "tensor"), mesh)
    assert len(st.shards) == 4 and all(t.shape == (2, 4, 3) for t in st.shards.values())
    for t in st.shards.values():
        t.requires_grad_(True)
    (st.full(torch.device("cpu")) * full).sum().backward()
    for key, t in st.shards.items():
        np.testing.assert_array_equal(t.grad.numpy(), full[st.region(key)].numpy())
    st.copy_from_full(full + 1)
    np.testing.assert_array_equal(st.to_full().numpy(), (full + 1).numpy())


def test_effective_model_config():
    from photon_tpu.config.schema import effective_model_config as jax_effective
    from photon_tpu_torch.config.schema import effective_model_config

    for attn in ("pallas", "xla", "ring"):
        for axes in ({}, {"sequence": 2}, {"pipe": 2}, {"data": 2, "sequence": 4}):
            m = ModelConfig(**dict(TINY, attn_impl=attn))
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                eff = effective_model_config(m, MeshConfig(**axes))
            with warnings.catch_warnings(record=True) as want:
                warnings.simplefilter("always")
                jeff = jax_effective(JaxModelConfig(**dict(TINY, attn_impl=attn)),
                                     JaxMeshConfig(**axes))
            assert eff.attn_impl == jeff.attn_impl, (attn, axes)
            assert [str(w.message) for w in got] == [str(w.message) for w in want]
            assert m.attn_impl == attn  # the config of record is not changed


def _cfg(**kw) -> Config:
    d = Config(model=ModelConfig(**TINY)).to_dict()
    for section, vals in kw.items():
        d[section].update(vals)
    return Config.from_dict(d)


@pytest.mark.parametrize("axes", [dict(data=2), dict(fsdp=2, tensor=2), dict(sequence=4),
                                  dict(data=2, fsdp=2, tensor=2, sequence=2)])
def test_lifted_axes_and_ring_validate(axes):
    _cfg(mesh=axes).validate()
    _cfg(mesh=axes, model={"attn_impl": "ring"}).validate()
    _cfg(model={"attn_impl": "ring"}).validate()


@pytest.mark.parametrize("what", ["pipe", "expert", "mesh_autotune", "moe", "lora",
                                  "freeze_patterns", "auto_micro", "adapters", "collective"])
def test_refused_on_a_mesh(what):
    """On a mesh ``validate()`` refuses only what JAX's refuses, with its
    texts. The pipeline, the expert mesh, the autotuner and MoE validate
    as in JAX; LoRA, adapters, frozen parameters, the ``auto`` probe and
    the collective plane validate on one device and on a mesh in both
    packages, and ``auto`` under ``pipe`` raises JAX's text."""
    from photon_tpu.config.schema import Config as JaxConfig

    one, mesh = {}, {"mesh": {"data": 2}}
    lifted = {"pipe": ({"mesh": {"pipe": 2}}, {"mesh": {"pipe": 2, "sequence": 2}}),
              "expert": ({"mesh": {"expert": 2}, "model": {"mlp": "moe", "moe_num_experts": 4}},
                         {"mesh": {"expert": 2}}),
              "mesh_autotune": ({"photon": {"mesh_autotune": True}}, None),
              "moe": ({"mesh": {"data": 2}, "model": {"mlp": "moe", "moe_num_experts": 4}},
                      {"mesh": {"expert": 4}, "model": {"mlp": "moe", "moe_num_experts": 6}})}
    if what in lifted:
        good, bad = lifted[what]
        _cfg(**good).validate()
        JaxConfig.from_dict(_cfg(**good).to_dict()).validate()
        if bad is not None:
            with pytest.raises(ValueError) as want:
                JaxConfig.from_dict(_cfg(**bad).to_dict()).validate()
            with pytest.raises(ValueError) as got:
                _cfg(**bad).validate()
            assert str(got.value) == str(want.value)
        return
    one = {"lora": {"model": {"lora_rank": 4, "lora_targets": ["wqkv"]}},
           "freeze_patterns": {"optimizer": {"freeze_patterns": ["wte"]}},
           "auto_micro": {"train": {"device_microbatch_size": "auto"}},
           "adapters": {"photon": {"adapters": {"enabled": True, "cohorts": {"a": [0]}}}},
           "collective": {"photon": {"comm_stack": {"collective": True, "shm": False}}},
           }[what]
    _cfg(**one).validate()
    meshed = {**one, **mesh}
    JaxConfig.from_dict(_cfg(**meshed).to_dict()).validate()
    _cfg(**meshed).validate()
    _cfg(**meshed).validate(serving=True)  # a server loads weights whatever trained them
    if what == "auto_micro":  # JAX's own refusal: the probe builds the non-pipelined step
        piped = {**one, "mesh": {"pipe": 2}}
        with pytest.raises(ValueError) as want:
            JaxConfig.from_dict(_cfg(**piped).to_dict()).validate()
        with pytest.raises(ValueError) as got:
            _cfg(**piped).validate()
        assert str(got.value) == str(want.value)


def test_surplus_devices_value_checked():
    with pytest.raises(ValueError, match="surplus_devices"):
        _cfg(mesh={"surplus_devices": "sometimes"}).validate()


@pytest.mark.parametrize("leg", ["a", "b", "c", "d", "e", "f", "g"])
def test_chip_smoke_mesh_leg_on_the_cpu(leg, monkeypatch):
    """Phase 19's leg through ``chip_smoke._mesh_leg`` (``_autotune_leg``
    for (f)) itself, at d64/d128 and seq 256 in fp32 on a mesh that
    repeats the CPU (the plain K1–K3 counted here as the kernels are on
    the card): its launch rule holds exactly, the meshed run reads within
    the training gate and the leg's planted fault over it ((e): the kept
    sets equal one global route and the per-position pools break them;
    (f): the tuner picks one device, bit for bit; (g): the base bit-frozen
    on both runs, the planted decay on it caught, the ``auto`` picks
    allowed)."""
    from photon_tpu_torch.ops import flash_attention as fa
    from tests.test_torch_compression import _chip_smoke

    smoke = _chip_smoke()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        def counted(*a, _real=getattr(fa, name), _name=name, **kw):
            fa.launches[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(fa, name, counted)
    monkeypatch.setitem(smoke.MESH_LEGS, leg, smoke.MESH_LEGS[leg][:2] + (256,)
                        + smoke.MESH_LEGS[leg][3:])

    def tiny(leg, meshed):
        cfg = smoke.mesh_config(leg, meshed)
        m = cfg.model
        m.compute_dtype, m.vocab_size, m.max_seq_len = "float32", 256, 256
        m.n_layers = 4 if leg == "d" else 2
        m.d_model, m.n_heads = (128, 4) if leg == "c" else (64, 4)
        if leg == "c":
            m.n_kv_heads, m.mlp_hidden_size = 2, 256
        return cfg.validate()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if leg == "f":
            rec = smoke._autotune_leg(torch, fa, np, device="cpu", cfg_fn=tiny)
        else:
            rec = smoke._mesh_leg(torch, fa, np, leg, device="cpu", cfg_fn=tiny)
    per_step = rec["launch_rule_per_step"]
    assert rec["launches"] == {k: v * smoke.MESH_STEPS for k, v in per_step.items()}
    if leg == "f":
        assert rec["bit_equal"] and set(rec["picked"].values()) == {1}
        assert per_step["flash_fwd"] > 0
        return
    assert rec["worst"] < smoke.TRAIN_GRAD_GATE
    if leg == "d":
        assert per_step == dict.fromkeys(per_step, 0)  # the stages' xla fallback
        assert rec["params_after_steps_max_rel_l2"] < smoke.TRAIN_GRAD_GATE
    if leg == "e":
        routing = rec["routing"]
        assert all(routing["kept_sets_equal"]) and routing["layers_routed"] == 4  # remat
        assert not all(routing["planted_per_position_pool_sets_equal"])
        assert rec["fp32_xla"]["worst"] < smoke.TRAIN_GRAD_GATE
        assert rec["grads_after_step_1"]["worst"] < smoke.TRAIN_GRAD_GATE  # fp32 here
        return
    assert smoke.TRAIN_GRAD_GATE < rec["planted_fault"]["worst"]
    if leg == "b":
        assert rec["set_get_round_trip_bit_equal"]
    if leg == "g":
        assert rec["base_bit_frozen"] == {"mesh": True, "single": True}
        assert rec["planted_decay_base_bit_frozen"] is False
        assert all(p["allowed"] and p["tried"] for p in rec["auto_probe"].values())
        assert rec["params_after_steps_max_rel_l2"] < smoke.TRAIN_GRAD_GATE
        assert rec["fp32"]["worst"] < smoke.TRAIN_GRAD_GATE < rec["fp32"]["planted_fault"]["worst"]
        assert rec["fp32"]["worst"] < smoke.TRAIN_GRAD_GATE < rec["fp32"]["planted_fault"]["worst"]
