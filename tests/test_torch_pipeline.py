"""The port's GPipe pipeline (``photon_tpu_torch/parallel/pipeline.py``)
against the JAX package (the counterparts of ``tests/test_pipeline.py``).

The same seeded JAX weights (carried across by ``params_from_numpy``) and
numpy tokens go through the port's pipeline on a mesh that repeats the CPU
and through JAX. On JAX's four meshes (``data 2 × pipe 4`` chunked and
unchunked, ``pipe 2 × fsdp 2``, ``tensor 2 × pipe 2``), with remat and the
llama family, and with MoE on ``pipe 2 × expert 2``, the pipeline's loss
and gradients equal JAX's non-pipelined grad accumulation over the same
microbatches at ``tests/test_pipeline.py``'s tolerances (loss 1e-5, atol
2e-5), and JAX's pipelined step itself (compiled once for the module, on
``data 2 × pipe 4``). The validation texts are JAX's; the Trainer falls
back to ``xla`` inside the stages, trains pipelined on the single-device
trajectory with the single device's state layout, and skips the bubble
ticks.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.codec.params import params_to_ndarrays as jax_to_ndarrays
from photon_tpu.config.schema import MeshConfig as JaxMeshConfig
from photon_tpu.models.mpt import init_params as jax_init
from photon_tpu_torch.codec.params import flatten, params_from_numpy
from photon_tpu_torch.config.schema import Config, effective_model_config
from photon_tpu_torch.parallel import spmd
from photon_tpu_torch.parallel.mesh import make_mesh
from photon_tpu_torch.parallel.pipeline import Pipeline
from photon_tpu_torch.parallel.sharding import shard_params
from photon_tpu_torch.train.trainer import Trainer
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread
from tests.test_pipeline import _cfg as jax_cfg
from tests.test_pipeline import _pipeline_grads, _reference_grads

LOSS_TOL, GRAD_ATOL = 1e-5, 2e-5  # tests/test_pipeline.py's
LLAMA = dict(remat=True, rope=True, norm="rmsnorm", mlp="swiglu", n_kv_heads=1,
             tie_embeddings=False, learned_pos_emb=False)
MOE = dict(mlp="moe", moe_num_experts=4, moe_top_k=2)
#: JAX's cases: (mesh axes, loss_chunk_tokens, model overrides, microbatches)
MESHES = {"dp2pp4": (dict(data=2, pipe=4), 2048, {}, 2),
          "pp2fsdp2": (dict(pipe=2, fsdp=2), 2048, {}, 2),
          "tp2pp2": (dict(tensor=2, pipe=2), 2048, {}, 2),
          "dp2pp4_unchunked": (dict(data=2, pipe=4), 0, {}, 2)}


def _tokens(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 64, (8, 16)).astype(np.int32)


def _flat_jax(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_jax(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _setup(axes, overrides, seed):
    jcfg = jax_cfg(JaxMeshConfig(**axes), **overrides)
    jparams = jax_init(jcfg.model, seed=0)
    return jcfg, jparams, _tokens(seed)


def _port_pipeline(jcfg, jparams, tokens, n_micro, chunk):
    """The port pipeline's (loss, {name: gradient}) from JAX's weights."""
    cfg = Config.from_dict(jcfg.to_dict()).validate()
    meta, arrays = jax_to_ndarrays(jparams)
    flat = flatten(params_from_numpy(meta.names, arrays, cfg.model))
    mesh = make_mesh(cfg.mesh, devices=["cpu"] * cfg.mesh.size)
    pipe = Pipeline(effective_model_config(cfg.model, cfg.mesh), mesh, n_micro)
    sharded = shard_params(flat, mesh)
    for st in sharded.values():
        for t in st.shards.values():
            t.requires_grad_(True)
    loss, grads = spmd.mesh_gradients(pipe, sharded, {torch.device("cpu"):
                                                      torch.from_numpy(tokens).long()}, chunk)
    return float(loss), {n: g.numpy() for n, g in grads.items()}


def _same(got, want):
    loss, grads = got
    want_loss, want_grads = want
    assert abs(loss - want_loss) < LOSS_TOL
    want_grads = _flat_jax(want_grads)
    assert sorted(grads) == sorted(want_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want_grads[name], atol=GRAD_ATOL, err_msg=name)


def _matches_reference(axes, chunk, overrides, n_micro, seed):
    jcfg, jparams, tokens = _setup(axes, overrides, seed)
    got = _port_pipeline(jcfg, jparams, tokens, n_micro, chunk)
    g_ref, loss_ref = _reference_grads(jcfg, jparams, jnp.asarray(tokens), n_micro, chunk)
    _same(got, (loss_ref, g_ref))
    return got


@pytest.fixture(scope="module")
def jax_pipelined():
    """JAX's pipelined step on ``data 2 × pipe 4`` (chunked), compiled once."""
    jcfg, jparams, tokens = _setup(dict(data=2, pipe=4), {}, 1)
    grads, loss = _pipeline_grads(jcfg, jparams, jnp.asarray(tokens), 2, 2048)
    return loss, grads


@pytest.mark.parametrize("case", list(MESHES))
def test_pipeline_matches_reference_grads(case):
    axes, chunk, overrides, n_micro = MESHES[case]
    _matches_reference(axes, chunk, overrides, n_micro, 1)


def test_pipeline_matches_jax_pipelined_step(jax_pipelined):
    """The port's pipeline against JAX's own pipelined step (sgd(1) on
    ``data 2 × pipe 4``: parameters before minus after are its gradients)."""
    jcfg, jparams, tokens = _setup(dict(data=2, pipe=4), {}, 1)
    _same(_port_pipeline(jcfg, jparams, tokens, 2, 2048), jax_pipelined)


def test_pipeline_matches_with_remat_and_llama_family():
    """Remat at both levels (each stage run and each layer a checkpoint)
    with RoPE, RMSNorm, SwiGLU, GQA and an untied head, 4 microbatches."""
    _matches_reference(dict(data=2, pipe=2), 2048, LLAMA, 4, 2)


def test_pipeline_matches_with_moe():
    """MoE stages on ``pipe 2 × expert 2``: each stage's Switch aux counts
    only the microbatches it ran, routed batch-globally inside the stage."""
    _matches_reference(dict(pipe=2, expert=2), 2048, MOE, 2, 3)


def _port_cfg(axes: dict, **model_kw) -> Config:
    d = Config().to_dict()
    d["model"].update(dict(d_model=32, n_layers=4, n_heads=2, max_seq_len=16, vocab_size=64,
                           attn_impl="xla", compute_dtype="float32"), **model_kw)
    d["mesh"].update(axes)
    d["train"].update(global_batch_size=8, device_microbatch_size=2)
    return Config.from_dict(d)


@pytest.mark.parametrize("axes,model_kw", [
    (dict(pipe=3), {}),
    (dict(pipe=2, sequence=2), {}),
    (dict(data=2, fsdp=2, pipe=2), {}),
    (dict(data=2, expert=2, pipe=2), dict(mlp="moe", moe_num_experts=4)),
], ids=["layers", "sequence", "two_batch_axes", "expert_batch_axis"])
def test_pipeline_validation(axes, model_kw):
    """JAX's refusals under ``pipe > 1``, with its texts; ``pallas`` under
    ``pipe`` validates and is not changed by ``validate()``."""
    with pytest.raises(ValueError) as want:
        jax_cfg(JaxMeshConfig(**axes), **model_kw)
    with pytest.raises(ValueError) as got:
        _port_cfg(axes, **model_kw).validate()
    assert str(got.value) == str(want.value)
    auto = _port_cfg(dict(pipe=2))
    auto.train.device_microbatch_size = "auto"
    with pytest.raises(ValueError, match="'auto' is not supported with mesh.pipe > 1"):
        auto.validate()
    cfg = _port_cfg(dict(pipe=2), attn_impl="pallas").validate()
    assert cfg.model.attn_impl == "pallas"


def test_trainer_defers_pallas_pipe_fallback():
    cfg = _port_cfg(dict(data=2, pipe=2), attn_impl="pallas").validate()
    with pytest.warns(UserWarning, match="falling back to"):
        trainer = Trainer(cfg, init_seed=0, device="cpu")
    assert cfg.model.attn_impl == "pallas"
    assert trainer.model.cfg.attn_impl == "xla"
    assert isinstance(trainer.mesh_model, Pipeline)


def test_trainer_runs_pipelined():
    """The Trainer takes the pipeline for ``pipe > 1``: the single-device
    trajectory and eval loss (rtol 2e-4, atol 2e-5, JAX's mesh tolerance),
    the single device's parameter and optimizer-state lists, and the loss
    falls on a repeated batch."""
    tokens = _tokens(4).astype(np.int64)
    one = Trainer(_port_cfg({}).validate(), init_seed=0, device="cpu")
    piped = Trainer(_port_cfg(dict(data=2, pipe=2)).validate(), init_seed=0, device="cpu")
    assert piped._n_micro == 2
    want = [one.fit([tokens], duration_steps=1) for _ in range(8)]
    got = [piped.fit([tokens], duration_steps=1) for _ in range(8)]
    for key in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose([m[key] for m in got], [m[key] for m in want],
                                   rtol=2e-4, atol=2e-5, err_msg=key)
    assert got[-1]["loss"] < got[0]["loss"]
    np.testing.assert_allclose(piped.evaluate([tokens])["eval/loss"],
                               one.evaluate([tokens])["eval/loss"], rtol=2e-4)
    assert piped.get_parameters()[0] == one.get_parameters()[0]
    assert piped.get_opt_state_arrays()[0] == one.get_opt_state_arrays()[0]


def test_bubble_ticks_are_skipped(monkeypatch):
    """Each stage runs each microbatch once (``n_micro × pipe`` stage runs,
    not ``(n_micro + pipe − 1) × pipe`` ticks); stage 0 alone embeds and
    the last stage alone runs the CE tail, once a microbatch."""
    calls = {"embed": [], "blocks": [], "head_ce": []}
    for name in calls:
        real = getattr(spmd.MeshModel, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            calls[_name].append(self.layers.start)
            return _real(self, *a, **kw)

        monkeypatch.setattr(spmd.MeshModel, name, spy)
    cfg = _port_cfg(dict(pipe=4)).validate()
    mesh = make_mesh(cfg.mesh, devices=["cpu"] * 4)
    pipe = Pipeline(cfg.model, mesh, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sharded = shard_params(flatten(Trainer(_port_cfg({}).validate(), init_seed=0,
                                               device="cpu").state.params), mesh)
    tokens = torch.from_numpy(_tokens(5)).long()[:6]
    pipe.loss(sharded, {torch.device("cpu"): tokens}, 2048)
    assert sorted(calls["blocks"]) == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]
    assert calls["embed"] == [0, 0, 0] and calls["head_ce"] == [3, 3, 3]
