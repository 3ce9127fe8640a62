"""The port's MoE on a mesh with batch-global capacity against the JAX
package (the counterparts of ``tests/test_moe.py``'s expert-mesh cases).

On ``test_expert_parallel_matches_single_device``'s five meshes (``expert
4``; ``data 2 × expert 2``; ``fsdp 2 × tensor 2 × expert 2`` with SwiGLU
and gelu experts; ``data 2 × sequence 2 × expert 2`` through the ring) the
port's meshed loss and gradients equal JAX's at that test's tolerances
(loss 1e-5, atol 3e-5), from JAX's seeded weights carried across by
``params_from_numpy``: against JAX's single-device loss (computed once per
model for the module), which JAX's own test holds its sharded step to, and
against JAX's sharded step itself on ``expert 4``. The routing is one
capacity pool over the global microbatch: the meshed step's kept sets
equal ``ops/moe.py``'s ``route`` over the concatenated router
probabilities, and per-position pools would part from them. The parameter
specs and the expert-mesh validation are JAX's; a meshed MoE Trainer gives
the single-device trajectory.
"""

import functools
import warnings

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

from photon_tpu.codec.params import params_to_ndarrays as jax_to_ndarrays
from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu.config.schema import MeshConfig as JaxMeshConfig
from photon_tpu.models.mpt import MPTModel as JaxModel
from photon_tpu.models.mpt import init_params as jax_init
from photon_tpu.parallel import make_mesh as jax_make_mesh
from photon_tpu.parallel import param_specs as jax_param_specs
from photon_tpu.train.train_step import init_train_state as jax_init_state
from photon_tpu.train.train_step import make_loss_fn as jax_loss_fn
from photon_tpu_torch.codec.params import flatten, params_from_numpy
from photon_tpu_torch.config.schema import Config, MeshConfig, effective_model_config
from photon_tpu_torch.ops import moe
from photon_tpu_torch.parallel import spmd
from photon_tpu_torch.parallel.mesh import make_mesh
from photon_tpu_torch.parallel.sharding import param_specs, shard_params
from photon_tpu_torch.train.trainer import Trainer
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

LOSS_TOL, GRAD_ATOL = 1e-5, 3e-5  # tests/test_moe.py's
#: test_expert_parallel_matches_single_device's meshes
MESHES = {"ep4": (dict(expert=4), "gelu"),
          "dp2ep2": (dict(data=2, expert=2), "swiglu"),
          "fsdp2tp2ep2_swiglu": (dict(fsdp=2, tensor=2, expert=2), "swiglu"),
          "fsdp2tp2ep2_gelu": (dict(fsdp=2, tensor=2, expert=2), "gelu"),
          "dp2sp2ep2_ring": (dict(data=2, sequence=2, expert=2), "gelu")}


def _model(act: str, seq: int) -> dict:
    return dict(d_model=32, n_layers=2, n_heads=2, max_seq_len=seq, vocab_size=64,
                attn_impl="ring" if seq > 16 else "xla", compute_dtype="float32", mlp="moe",
                moe_num_experts=4, moe_top_k=2, moe_mlp_act=act)


def _jax_cfg(axes: dict, act: str, seq: int) -> JaxConfig:
    d = JaxConfig().to_dict()
    d["model"].update(_model(act, seq))
    d["mesh"].update(axes)
    d["train"].update(global_batch_size=8, device_microbatch_size=4)
    return JaxConfig.from_dict(d).validate()


def _tokens(seq: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, 64, (8, seq)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_single(act: str, seq: int):
    """JAX's single-device loss and gradients (flat numpy) and its init."""
    cfg = _jax_cfg({}, act, seq)
    params = jax_init(cfg.model, seed=0)
    loss, grads = jax.jit(jax.value_and_grad(jax_loss_fn(JaxModel(cfg.model), 2048)))(
        params, _tokens(seq))
    meta, arrays = jax_to_ndarrays(params)
    _, garrays = jax_to_ndarrays(grads)
    return float(loss), dict(zip(meta.names, garrays)), (meta.names, arrays)


def _port_meshed(axes: dict, act: str, seq: int):
    """The port's meshed loss and gradients from JAX's weights."""
    _, _, (names, arrays) = _jax_single(act, seq)
    cfg = Config.from_dict(_jax_cfg(axes, act, seq).to_dict()).validate()
    mesh = make_mesh(cfg.mesh, devices=["cpu"] * cfg.mesh.size)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = spmd.MeshModel(effective_model_config(cfg.model, cfg.mesh), mesh)
    sharded = shard_params(flatten(params_from_numpy(names, arrays, cfg.model)), mesh)
    for st in sharded.values():
        for t in st.shards.values():
            t.requires_grad_(True)
    loss, grads = spmd.mesh_gradients(model, sharded,
                                      {torch.device("cpu"): torch.from_numpy(_tokens(seq)).long()})
    return float(loss), {n: g.numpy() for n, g in grads.items()}


def _same(got, want_loss, want_grads):
    loss, grads = got
    assert loss == pytest.approx(want_loss, abs=LOSS_TOL)
    assert sorted(grads) == sorted(want_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want_grads[name], atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("case", list(MESHES))
def test_expert_parallel_matches_single_device(case):
    axes, act = MESHES[case]
    seq = 64 if axes.get("sequence", 1) > 1 else 16  # give the ring something to shard
    loss, grads, _ = _jax_single(act, seq)
    _same(_port_meshed(axes, act, seq), loss, grads)


def test_expert_mesh_matches_jax_sharded_step():
    """JAX's own sharded loss and gradients on ``expert 4`` (GSPMD's
    dispatch), against the port's meshed ones."""
    from photon_tpu.parallel.sharding import batch_spec, state_shardings

    cfg = _jax_cfg(dict(expert=4), "gelu", 16)
    model = JaxModel(cfg.model)
    params = jax_init(cfg.model, seed=0)
    m = jax_make_mesh(cfg.mesh)
    st = jax_init_state(model, optax.sgd(1.0), params)
    sh = state_shardings(st, m)
    ps = jax.tree.map(lambda leaf, s: jax.device_put(leaf, s), st.params, sh.params)
    tok = jax.device_put(_tokens(16), NamedSharding(m, batch_spec(m)))
    loss, grads = jax.jit(jax.value_and_grad(jax_loss_fn(model, 2048)))(ps, tok)
    meta, garrays = jax_to_ndarrays(jax.device_get(grads))
    _same(_port_meshed(dict(expert=4), "gelu", 16), float(loss), dict(zip(meta.names, garrays)))


@pytest.mark.parametrize("case", ["ep4", "dp2sp2ep2_ring"])
def test_capacity_pool_is_batch_global(case, monkeypatch):
    """Every layer's kept ``(token, expert, position)`` set equals one
    ``route`` over the router probabilities concatenated in global ``[B,
    S]`` order, with the capacity of the whole microbatch; routing each
    position's tokens in a pool of its own parts from it."""
    axes, act = MESHES[case]
    seq = 64 if axes.get("sequence", 1) > 1 else 16
    calls = []
    real = spmd._global_route

    def recording(probs, n_r, n_s, k, cf, device):
        out = real(probs, n_r, n_s, k, cf, device)
        calls.append((probs, n_r, n_s, k, cf, out))
        return out

    monkeypatch.setattr(spmd, "_global_route", recording)
    _port_meshed(axes, act, seq)
    assert len(calls) == 2  # one routing a layer

    def kept(r):
        slot, tok = r.kept.nonzero(as_tuple=True)
        return set(zip(tok.tolist(), r.expert[slot, tok].tolist(),
                       r.position[slot, tok].tolist()))

    for probs, n_r, n_s, k, cf, (routing, cap) in calls:
        whole = torch.cat([torch.cat([probs[r, s] for s in range(n_s)], 1)
                           for r in range(n_r)]).reshape(-1, 4)
        assert cap == moe.expert_capacity(8 * seq, 4, k, cf)
        assert kept(routing) == kept(moe.route(whole, k, cap))
        per_position = set()  # each group's own pool, its tokens at their global index
        for (r, s), p in probs.items():
            b, s_loc = p.shape[:2]
            pool = moe.route(p.reshape(-1, 4), k, moe.expert_capacity(b * s_loc, 4, k, cf))
            per_position |= {((r * b + i // s_loc) * seq + s * s_loc + i % s_loc, e, pos)
                             for i, e, pos in kept(pool)}
        assert per_position != kept(routing)


def test_moe_param_specs():
    """Every MoE leaf's spec equals JAX's on each of the five meshes
    (``moe_up``/``moe_down`` dim 1 over ``expert``)."""
    cfg = _jax_cfg({}, "swiglu", 16)
    params = jax_init(cfg.model, seed=0)
    names = jax_to_ndarrays(params)[0].names
    shapes = dict(zip(names, (np.shape(a) for a in jax_to_ndarrays(params)[1])))
    for axes, _ in MESHES.values():
        want = jax_param_specs(params, jax_make_mesh(JaxMeshConfig(**axes)))
        got = param_specs(shapes, make_mesh(MeshConfig(**axes), devices=["cpu"] * 8))
        flat_want = dict(zip(names, jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
        for n in names:
            spec = tuple(flat_want[n]) + (None,) * (len(shapes[n]) - len(tuple(flat_want[n])))
            assert got[n] == spec, (axes, n)
    ep = param_specs(shapes, make_mesh(MeshConfig(expert=4), devices=["cpu"] * 4))
    assert ep["blocks/block/moe_up"][1] == "expert"
    assert ep["blocks/block/moe_down"][1] == "expert"


@pytest.mark.parametrize("what", ["experts", "divisible", "requires_moe"])
def test_moe_validation(what):
    """The expert mesh's checks with JAX's texts; ``mlp: moe`` validates
    on a mesh (batch-global capacity is ported)."""
    d = Config().to_dict()
    if what == "experts":
        d["model"].update(mlp="moe", moe_num_experts=1)
    elif what == "divisible":
        d["model"].update(mlp="moe", moe_num_experts=4)
        d["mesh"].update(expert=3)
    else:
        d["mesh"].update(expert=2)
    with pytest.raises(ValueError) as want:
        JaxConfig.from_dict(d).validate()
    with pytest.raises(ValueError) as got:
        Config.from_dict(d).validate()
    assert str(got.value) == str(want.value)
    d = Config().to_dict()
    d["model"].update(mlp="moe", moe_num_experts=4)
    d["mesh"].update(data=2, expert=2)
    Config.from_dict(d).validate()


def test_meshed_moe_trainer_matches_single_device():
    """A Trainer on ``data 2 × expert 2`` (2 microbatches of the
    per-position microbatch) gives the single-device trajectory (rtol
    2e-4, atol 2e-5) with the aux in every step, and the same lists."""
    def cfg(axes, micro):
        d = Config().to_dict()
        d["model"].update(_model("gelu", 16))
        d["mesh"].update(axes)
        d["optimizer"].update(name="adamw", lr=1e-3)
        d["train"].update(global_batch_size=8, device_microbatch_size=micro)
        return Config.from_dict(d).validate()

    tokens = _tokens(16).astype(np.int64)
    one = Trainer(cfg({}, 4), init_seed=0, device="cpu")
    meshed = Trainer(cfg(dict(data=2, expert=2), 1), init_seed=0, device="cpu")
    assert one._n_micro == meshed._n_micro == 2
    want = [one.fit([tokens], duration_steps=1) for _ in range(3)]
    got = [meshed.fit([tokens], duration_steps=1) for _ in range(3)]
    for key in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose([m[key] for m in got], [m[key] for m in want],
                                   rtol=2e-4, atol=2e-5, err_msg=key)
    assert meshed.get_parameters()[0] == one.get_parameters()[0]
