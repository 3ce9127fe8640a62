"""The port's Trainer on a mesh (the counterparts of ``tests/test_parallel.py``'s
training cases).

One process drives every position of a mesh that repeats the CPU
(``parallel/spmd.py``). The same batch must give the port's single-device
loss trajectory on any mesh, at JAX's tolerance (rtol 2e-4, atol 2e-5),
through the dense attention (``xla``, as the JAX test) and through the
flash route (``pallas``: the plain K1–K3, the ring on a sequence mesh);
the parameters after the steps agree to the same atol. A meshed port
Trainer's losses equal JAX's Trainer on the same mesh and weights. The
parameter plane gathers and scatters in the codec's order, so a meshed
Trainer's lists are a single-device Trainer's, and ``set_step`` and
``reset_optimizer`` work on a mesh. ``centralized`` trains a config with a
mesh.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from photon_tpu_torch.config.schema import (
    Config,
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    SchedulerConfig,
    TrainConfig,
)
from photon_tpu_torch.parallel.mesh import make_mesh
from photon_tpu_torch.train.trainer import Trainer
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

TINY = dict(d_model=64, n_layers=2, n_heads=4, max_seq_len=32, vocab_size=256,
            attn_impl="xla", compute_dtype="float32")
#: rope, GQA, swiglu, rmsnorm, an untied head, remat and biases
LLAMA = dict(TINY, rope=True, learned_pos_emb=False, n_kv_heads=2, mlp="swiglu",
             norm="rmsnorm", tie_embeddings=False, remat=True, no_bias=False)
MESHES = {"dp8": dict(data=8), "fsdp8": dict(fsdp=8), "dp2xfsdp4": dict(data=2, fsdp=4),
          "dp2fsdp2tp2": dict(data=2, fsdp=2, tensor=2),
          "fsdp2tp2sp2": dict(fsdp=2, tensor=2, sequence=2)}
RTOL, ATOL = 2e-4, 2e-5  # JAX's (tests/test_parallel.py)


def _cfg(mesh: dict, model: dict = TINY, **model_kw) -> Config:
    return Config(
        model=ModelConfig(**dict(model, **model_kw)),
        mesh=MeshConfig(**mesh),
        optimizer=OptimizerConfig(name="adamw", lr=1e-3),
        scheduler=SchedulerConfig(t_warmup=2, t_max=100),
        train=TrainConfig(global_batch_size=8, device_microbatch_size=8),
    ).validate()


def _tokens(seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (8, 32), dtype=np.int64)


def _run(cfg: Config, tokens, steps=3, **kw):
    t = Trainer(cfg, init_seed=0, device="cpu", **kw)
    metrics = [t.fit([tokens], duration_steps=1) for _ in range(steps)]
    return t, metrics


def _same_trajectory(got, want):
    for key in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose([m[key] for m in got], [m[key] for m in want],
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def _same_params(a: Trainer, want: tuple):
    ma, pa = a.get_parameters()
    assert ma == want[0]
    for x, y in zip(pa, want[1]):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _single_device(attn: str):
    """The single-device run the mesh cases are held to (one per route)."""
    t, metrics = _run(_cfg({}, attn_impl=attn), _tokens())
    return metrics, t.get_parameters()


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("axes", list(MESHES.values()), ids=list(MESHES))
def test_sharded_training_matches_single_device(axes, attn):
    """The same batch gives the same trajectory on any mesh."""
    want, params = _single_device(attn)
    t, got = _run(_cfg(axes, attn_impl=attn), _tokens())
    assert t.mesh is not None and t.mesh.shape == make_mesh(
        MeshConfig(**axes), devices=["cpu"] * 8).shape
    _same_trajectory(got, want)
    _same_params(t, params)


@pytest.mark.parametrize("axes", [dict(fsdp=2, tensor=2, sequence=2), dict(tensor=4),
                                  dict(data=2, sequence=4)], ids=["fsdp2tp2sp2", "tp4", "dp2sp4"])
def test_llama_family_on_a_mesh_matches_single_device(axes):
    """RoPE at global positions, GQA (kv heads split over tensor=2; over
    tensor=4 they do not split and are repeated first), swiglu columns,
    an untied head, biases summed once after the tensor sum, remat."""
    tokens = _tokens(1)
    ref, want = _run(_cfg({}, LLAMA, attn_impl="pallas"), tokens)
    t, got = _run(_cfg(axes, LLAMA, attn_impl="pallas"), tokens)
    _same_trajectory(got, want)
    _same_params(t, ref.get_parameters())


def test_alibi_ring_and_microbatches_match_single_device():
    """ALiBi with the global slopes on a tensor x sequence mesh, 2
    microbatches a step (the per-position microbatch, as JAX's), the
    chunked loss off: the single-device trajectory and eval loss."""
    tokens = _tokens(2)
    kw = dict(attn_impl="pallas", alibi=True, learned_pos_emb=False)
    cfg_one, cfg_mesh = _cfg({}, **kw), _cfg(dict(data=2, tensor=2, sequence=2), **kw)
    cfg_one.train.device_microbatch_size = 4
    cfg_mesh.train.device_microbatch_size = 2
    for c in (cfg_one, cfg_mesh):
        c.train.loss_chunk_tokens = 0
    ref, want = _run(cfg_one, tokens)
    t, got = _run(cfg_mesh, tokens)
    assert ref._n_micro == t._n_micro == 2
    _same_trajectory(got, want)
    np.testing.assert_allclose(t.evaluate([_tokens(3)])["eval/loss"],
                               ref.evaluate([_tokens(3)])["eval/loss"], rtol=RTOL)


def test_meshed_trainer_matches_jax_trainer():
    """A meshed port Trainer against JAX's Trainer on the same mesh and the
    same weights (carried by ``params_from_numpy``)."""
    from photon_tpu.codec.params import params_to_ndarrays as jax_to_ndarrays
    from photon_tpu.config.schema import Config as JaxConfig
    from photon_tpu.models.mpt import init_params as jax_init
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.codec.params import params_from_numpy

    axes = dict(data=2, fsdp=2, tensor=2)
    cfg = _cfg(axes)
    jcfg = JaxConfig.from_dict(cfg.to_dict()).validate()
    jp = jax_init(jcfg.model, seed=0)
    meta, arrays = jax_to_ndarrays(jp)
    tokens = _tokens(4)
    jt = JaxTrainer(jcfg, params=jp)
    pt = Trainer(cfg, params=params_from_numpy(meta.names, arrays, cfg.model), device="cpu")
    jl = [jt.fit([tokens], duration_steps=1)["loss"] for _ in range(3)]
    pl = [pt.fit([tokens], duration_steps=1)["loss"] for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)


def test_get_set_parameters_roundtrip_sharded():
    t = Trainer(_cfg(dict(data=2, fsdp=2, tensor=2)), init_seed=0, device="cpu")
    one = Trainer(_cfg({}), init_seed=0, device="cpu")
    meta, arrays = t.get_parameters()
    meta1, arrays1 = one.get_parameters()
    assert meta == meta1
    for a, b in zip(arrays, arrays1):
        assert a.tobytes() == b.tobytes()  # the single-device list, byte for byte
    mutated = [a + 1.0 for a in arrays]
    t.set_parameters(meta, mutated)
    meta2, arrays2 = t.get_parameters()
    assert meta2 == meta
    for a, b in zip(mutated, arrays2):
        assert a.tobytes() == b.tobytes()
    om, oa = t.get_opt_state_arrays()
    om1, oa1 = one.get_opt_state_arrays()
    assert om == om1
    shifted = [(a + 2).astype(a.dtype) for a in oa]
    t.set_opt_state_arrays(om, shifted)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(shifted, t.get_opt_state_arrays()[1]))
    m1, m2 = t.get_momenta()
    t.set_momenta([x + 3.0 for x in m1], m2)
    assert all(np.array_equal(x + 3.0, y) for x, y in zip(m1, t.get_momenta()[0]))


def test_set_step_and_reset_optimizer():
    t = Trainer(_cfg(dict(data=2)), init_seed=0, device="cpu")
    tokens = np.zeros((8, 32), np.int64)
    t.fit([tokens], duration_steps=1)
    assert t.step == 1
    t.set_step(100)
    assert t.step == 100
    om, oa = t.get_opt_state_arrays()
    assert [int(a) for n, a in zip(om.names, oa) if n.endswith(".count")] == [100, 100]
    t.reset_optimizer()
    assert all(not np.any(x) for x in t.get_momenta()[0])
    t.fit([tokens], duration_steps=1)
    assert t.step == 101


def test_dp_degree_batch_adaptation_warns():
    """JAX's rounding: the batch to a multiple of data x fsdp, the
    per-position microbatch clamped, then to a multiple of the rows a step
    takes; the speed monitor counts distinct devices."""
    cfg = _cfg(dict(data=2, fsdp=2))
    cfg.train.global_batch_size, cfg.train.device_microbatch_size = 10, 4
    with pytest.warns(UserWarning) as rec:
        t = Trainer(cfg, init_seed=0, device="cpu")
    msgs = [str(w.message) for w in rec]
    assert any("not divisible by data-parallel degree 4; adapted to 8" in m for m in msgs)
    assert any("exceeds the per-device batch 2; clamped to 2" in m for m in msgs)
    assert t.effective_global_batch_size == 8 and t._n_micro == 1
    assert t.speed_monitor.n_devices == 1


def test_explicit_mesh_argument_and_centralized(tmp_path, capsys):
    """``Trainer(mesh=...)`` takes the mesh it is given; ``centralized``
    trains a config whose mesh is larger than one device."""
    from photon_tpu_torch.centralized import run_centralized

    mesh = make_mesh(MeshConfig(fsdp=2, sequence=2), devices=["cpu"] * 4)
    tokens = _tokens(5)
    t, got = _run(_cfg({}, attn_impl="pallas"), tokens, mesh=mesh)
    assert t.mesh is mesh and t.model.cfg.attn_impl == "ring"
    _, want = _run(_cfg({}, attn_impl="pallas"), tokens)
    _same_trajectory(got, want)

    cfg = dataclasses.replace(_cfg(dict(data=2, sequence=2)), run_uuid="mesh")
    cfg.dataset.synthetic = True
    cfg.photon.save_path = str(tmp_path)
    cfg.train.eval_batches = 1
    hist = run_centralized(cfg, total_steps=2, eval_first=True, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines[0]["eval_at"] == 0 and np.isfinite(lines[-1]["loss"])
    assert hist is not None


def test_mesh_needs_the_devices_it_names():
    """A CUDA trainer's mesh takes the local cards and refuses when there
    are fewer than the mesh's size, as JAX does."""
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 0"):
        make_mesh(MeshConfig(data=2))
    assert torch.device("cpu") in make_mesh(MeshConfig(data=2),
                                            devices=["cpu", "cpu"]).distinct_devices()
