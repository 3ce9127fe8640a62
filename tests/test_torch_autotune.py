"""The port's layout autotuner (``photon_tpu_torch/parallel/autotune.py``)
against the JAX package's (the counterparts of ``tests/test_autotune.py``).

Given the same ``HardwareModel`` values, ``rank_layouts`` returns JAX's
``MeshConfig`` order with the same estimates (rel 1e-12) over models, device
counts, batches, microbatches and the federated term. JAX's behaviours are
then restated for the port's default, the H100's published numbers: legal
enumeration, the cost model's monotonic terms, the rankings (a 125M model
data-parallel; a model whose state cannot live replicated on 80 GB, mpt-7b,
sharded), the federated term, the entry points, the Trainer built without a
mesh under ``photon.mesh_autotune`` and the collective runner's probe. JAX's
``test_hbm_estimate_brackets_aot_memory_analysis`` compiles on libtpu's
abstract TPU topology, which has no counterpart on the card's machine; it
stays JAX-only.
"""

import dataclasses
import warnings

import numpy as np
import pytest

from photon_tpu.config import load_preset as jax_preset
from photon_tpu.config.schema import ModelConfig as JaxModelConfig
from photon_tpu.parallel.autotune import HardwareModel as JaxHardwareModel
from photon_tpu.parallel.autotune import model_param_count as jax_param_count
from photon_tpu.parallel.autotune import rank_layouts as jax_rank
from photon_tpu_torch.config import load_preset
from photon_tpu_torch.config.schema import MeshConfig, ModelConfig
from photon_tpu_torch.parallel.autotune import (
    HardwareModel,
    autotune_layout,
    autotune_mesh,
    enumerate_layouts,
    estimate_layout,
    model_param_count,
    rank_layouts,
)
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

TINY = dict(d_model=64, n_layers=2, n_heads=4, max_seq_len=32, vocab_size=256,
            attn_impl="xla", compute_dtype="float32")
#: model configs of the parity sweep (dicts both packages build from)
MODELS = {"tiny": TINY, "tiny_gqa": dict(TINY, n_kv_heads=2, rope=True, learned_pos_emb=False),
          "deep": dict(TINY, n_layers=8), "125m": {}}
PRESETS = ["mpt-1b", "llama-1b", "mpt-125m-moe8", "mpt-7b"]


def _axes(e) -> tuple:
    m = e.mesh
    return (m.data, m.fsdp, m.tensor, m.sequence, m.pipe, m.expert)


def _pair(name: str):
    if name in PRESETS:
        return load_preset(name).model, jax_preset(name).model
    return ModelConfig(**MODELS[name]), JaxModelConfig(**MODELS[name])


@pytest.mark.parametrize("name", list(MODELS) + PRESETS)
def test_rankings_match_jax(name):
    """The same hardware numbers give JAX's layouts in JAX's order with
    JAX's estimates, fits, bubbles and per-collective terms."""
    port_cfg, jax_cfg = _pair(name)
    assert model_param_count(port_cfg) == jax_param_count(jax_cfg)
    for hw_kw in ({}, dict(peak_flops=989e12, hbm_bytes=80e9, ici_bytes_per_s=9e11,
                           dcn_bytes_per_s=5e10, mfu=0.2286)):
        for n_dev in (1, 2, 4, 6, 8, 16):
            for gbs, micro, fed in ((256, 0, {}), (64, 4, {}),
                                    (256, 8, dict(n_clients=8, local_steps=10)),
                                    (32, 2, dict(n_clients=4, quantization="q8"))):
                for max_pipe in (None, 1):
                    jhw = JaxHardwareModel(**hw_kw)
                    hw = HardwareModel(**dataclasses.asdict(jhw))
                    kw = dict(max_pipe=max_pipe, microbatch=micro, **fed)
                    try:
                        want = jax_rank(jax_cfg, n_dev, gbs, hw=jhw, **kw)
                    except ValueError as e:  # no legal layout: the same error
                        with pytest.raises(ValueError) as got_err:
                            rank_layouts(port_cfg, n_dev, gbs, hw=hw, **kw)
                        assert str(got_err.value) == str(e)
                        continue
                    got = rank_layouts(port_cfg, n_dev, gbs, hw=hw, **kw)
                    assert [_axes(e) for e in got] == [_axes(e) for e in want]
                    for g, w in zip(got, want):
                        np.testing.assert_allclose(g.est_step_s, w.est_step_s, rtol=1e-12)
                        np.testing.assert_allclose(g.hbm_bytes_per_device,
                                                   w.hbm_bytes_per_device, rtol=1e-12)
                        assert g.fits == w.fits and g.bubble_frac == w.bubble_frac
                        assert g.breakdown.keys() == w.breakdown.keys()
                        for k in w.breakdown:
                            np.testing.assert_allclose(g.breakdown[k], w.breakdown[k],
                                                       rtol=1e-12, atol=0)


def test_h100_hardware_model():
    """The default is the H100 SXM5's published numbers and the port's
    measured 125M MFU; a card name seeds the peak (the H100's when the
    port does not know the card)."""
    hw = HardwareModel()
    assert (hw.peak_flops, hw.hbm_bytes, hw.ici_bytes_per_s, hw.dcn_bytes_per_s,
            hw.mfu) == (989e12, 80e9, 9.0e11, 5.0e10, 0.2286)
    assert HardwareModel.for_device_kind("NVIDIA H100 80GB HBM3").peak_flops == 989e12
    assert HardwareModel.for_device_kind("cpu") == hw


# -- enumeration legality ------------------------------------------------

def test_enumerate_covers_exact_factorizations():
    tiny = ModelConfig(**TINY)
    layouts = enumerate_layouts(tiny, 8, global_batch_size=8)
    for m in layouts:
        assert m.data * m.fsdp * m.tensor * m.pipe == 8
        assert m.sequence == 1 and m.expert == 1
    assert any(m.data == 8 for m in layouts)


def test_enumerate_respects_divisibility():
    tiny = ModelConfig(**TINY)
    assert not any(m.tensor == 8 for m in enumerate_layouts(tiny, 8, 8))
    assert not any(m.pipe in (4, 8) for m in enumerate_layouts(tiny, 8, 8))
    gqa = ModelConfig(**MODELS["tiny_gqa"])
    assert not any(m.tensor == 4 for m in enumerate_layouts(gqa, 8, 8))
    assert any(m.tensor == 2 for m in enumerate_layouts(gqa, 8, 8))


def test_enumerate_pipeline_single_batch_axis():
    for m in enumerate_layouts(ModelConfig(**MODELS["deep"]), 8, 8):
        if m.pipe > 1:
            assert not (m.data > 1 and m.fsdp > 1)


def test_enumerate_max_pipe_cap():
    deep = ModelConfig(**MODELS["deep"])
    assert any(m.pipe > 1 for m in enumerate_layouts(deep, 8, 8))
    capped = enumerate_layouts(deep, 8, 8, max_pipe=1)
    assert capped and all(m.pipe == 1 for m in capped)


def test_enumerate_batch_divisibility_and_errors():
    tiny = ModelConfig(**TINY)
    assert not any(m.data * m.fsdp == 8 for m in enumerate_layouts(tiny, 8, 4))
    with pytest.raises(ValueError, match="n_devices"):
        enumerate_layouts(tiny, 0, 8)
    with pytest.raises(ValueError, match="no legal"):
        rank_layouts(tiny, 7, global_batch_size=8)


# -- the cost model's shape ------------------------------------------------

def test_param_count_tracks_presets():
    assert 1.1e8 < model_param_count(ModelConfig()) < 1.4e8
    assert 1.2e9 < model_param_count(load_preset("mpt-1b").model) < 1.5e9


def test_comm_grows_with_tensor_and_hbm_shrinks_with_fsdp():
    cfg = ModelConfig()
    t1 = estimate_layout(cfg, MeshConfig(data=8), 256, microbatch=8)
    t2 = estimate_layout(cfg, MeshConfig(data=4, tensor=2), 256, microbatch=8)
    assert t2.breakdown["tensor_s"] > t1.breakdown["tensor_s"] == 0.0
    f8 = estimate_layout(cfg, MeshConfig(fsdp=8), 256, microbatch=8)
    assert f8.hbm_bytes_per_device < t1.hbm_bytes_per_device
    deep = estimate_layout(cfg, MeshConfig(data=4, pipe=2), 256, microbatch=8)
    assert deep.bubble_frac > 0.0 and deep.compute_s > t1.compute_s


def test_ranking_small_model_prefers_data_parallel():
    best = rank_layouts(ModelConfig(), 8, 256, microbatch=8)[0]
    assert best.axes == (8, 1, 1, 1) and best.fits


def test_ranking_big_model_shards_state_to_fit():
    """mpt-7b's state (~6.7e9 parameters × 16 bytes) cannot live
    replicated on an 80 GB card: the tuner shards it. (JAX's case uses
    mpt-1b on a 16 GB chip; mpt-1b's state fits on one H100.)"""
    big = load_preset("mpt-7b").model
    ranked = rank_layouts(big, 8, 256, microbatch=4)
    best = ranked[0]
    assert best.fits
    assert best.mesh.fsdp * best.mesh.tensor * best.mesh.pipe > 1
    assert not next(e for e in ranked if e.axes == (8, 1, 1, 1)).fits
    assert rank_layouts(load_preset("mpt-1b").model, 8, 256, microbatch=4)[0].axes == (8, 1, 1, 1)


def test_federated_term_priced_with_modeled_bytes():
    cfg = ModelConfig()
    base = estimate_layout(cfg, MeshConfig(data=4), 256, microbatch=8)
    fed = estimate_layout(cfg, MeshConfig(data=4), 256, microbatch=8, n_clients=8,
                          local_steps=10)
    assert "federated_dcn_s" not in base.breakdown
    dcn = fed.breakdown["federated_dcn_s"]
    assert dcn > 0.0
    q8 = estimate_layout(cfg, MeshConfig(data=4), 256, microbatch=8, n_clients=8,
                         local_steps=10, quantization="q8")
    assert 3.0 < dcn / q8.breakdown["federated_dcn_s"] < 4.0
    more = estimate_layout(cfg, MeshConfig(data=4), 256, microbatch=8, n_clients=8,
                           local_steps=100)
    assert more.breakdown["federated_dcn_s"] < dcn


# -- the entry points and their callers ------------------------------------

def test_entry_points():
    tiny = ModelConfig(**TINY)
    mesh_cfg = autotune_mesh(tiny, n_devices=4, global_batch_size=8)
    assert isinstance(mesh_cfg, MeshConfig) and mesh_cfg.size == 4
    assert autotune_layout(tiny, devices=["cpu"] * 4, global_batch_size=8).mesh.size == 4
    with pytest.raises(ValueError, match="devices"):
        autotune_layout(tiny)


def _trainer_cfg(micro=1):
    from photon_tpu_torch.config.schema import (
        Config,
        OptimizerConfig,
        SchedulerConfig,
        TrainConfig,
    )

    cfg = Config(model=ModelConfig(**TINY), optimizer=OptimizerConfig(name="adamw", lr=1e-3),
                 scheduler=SchedulerConfig(t_warmup=2, t_max=100),
                 train=TrainConfig(global_batch_size=8, device_microbatch_size=micro))
    cfg.photon.mesh_autotune = True
    return cfg.validate()


def test_trainer_autotunes_mesh_when_enabled():
    """A Trainer built without a mesh under ``photon.mesh_autotune`` takes
    the tuner's layout over its local devices (8 CPU slots here: data
    parallel) and records the search; an explicit mesh wins; one device
    (the CPU's default) gives the single-device Trainer."""
    from photon_tpu_torch.parallel.mesh import single_device_mesh
    from photon_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_trainer_cfg(), init_seed=0, device="cpu", n_devices=8)
    tuned = trainer.layout_autotune
    assert tuned["search_s"] >= 0.0 and tuned["est_step_s"] > 0.0
    assert trainer.mesh.shape["data"] == 8 and tuned["mesh"].size == 8
    pinned = Trainer(_trainer_cfg(), init_seed=0, device="cpu",
                     mesh=single_device_mesh("cpu"))
    assert pinned.layout_autotune is None and pinned.mesh is None
    one = Trainer(_trainer_cfg(), init_seed=0, device="cpu")
    assert one.mesh is None and one.layout_autotune["mesh"].size == 1
    tokens = np.random.default_rng(0).integers(0, 256, (8, 32))
    np.testing.assert_allclose(trainer.fit([tokens], 1)["loss"], one.fit([tokens], 1)["loss"],
                               rtol=2e-4)


def test_trainer_autotune_with_auto_microbatch():
    """An ``auto`` microbatch caps ``pipe`` at 1; on one device the probe
    runs, and on a tuned mesh it runs too, picking what JAX's probe picks
    on that mesh: the largest power of 2 of at most the per-position
    batch whose rows divide the batch."""
    from photon_tpu.config.schema import Config as JaxConfig
    from photon_tpu.config.schema import MeshConfig as JaxMeshConfig
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.parallel.mesh import AXES, make_mesh
    from photon_tpu_torch.train.trainer import Trainer

    cfg = _trainer_cfg("auto")
    cfg.model.n_layers = 8
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = Trainer(cfg, init_seed=0, device="cpu")
        tuned = Trainer(cfg, init_seed=0, device="cpu", n_devices=8)
    assert one.mesh is None and one.device_microbatch_size >= 1
    mesh_cfg = tuned.layout_autotune["mesh"]
    assert tuned.mesh is not None and mesh_cfg.pipe == 1 and mesh_cfg.size == 8
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    jcfg.photon.mesh_autotune = False
    jcfg.mesh = JaxMeshConfig(**{a: getattr(mesh_cfg, a) for a in AXES})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = JaxTrainer(jcfg.validate(), init_seed=0)
    assert dict(jt.mesh.shape) == make_mesh(mesh_cfg, devices=["cpu"] * 8).shape
    assert tuned.device_microbatch_size == jt.device_microbatch_size
    assert tuned.auto_probe["tried"][-1] == (tuned.device_microbatch_size, "ok")


def test_autotune_probe_never_kills_collective_runner_config(tmp_path, monkeypatch):
    """The collective runner's probe writes ``server/layout_search_time``
    and ``server/layout_est_step_s`` into each round's metrics (the
    estimate of its client slice, ``collective_replica`` devices); a slice
    with no legal layout (JAX's ``ValueError``) only warns."""
    from photon_tpu_torch.federation.collective_round import CollectiveFedRunner
    from photon_tpu_torch.parallel import autotune
    from tests.test_torch_collective_round import _jax_cfg, _port

    odd = ModelConfig(**dict(TINY, n_layers=3))
    with pytest.raises(ValueError, match="no legal"):
        rank_layouts(odd, 7, global_batch_size=9)
    with pytest.raises(ValueError):
        autotune_layout(odd, n_devices=7, global_batch_size=9)

    jcfg = _jax_cfg(tmp_path, n_clients=2)
    jcfg.fl.n_rounds, jcfg.fl.local_steps, jcfg.fl.eval_interval_rounds = 1, 1, 0
    jcfg.photon.mesh_autotune = True
    cfg = _port(jcfg)
    runner = CollectiveFedRunner(cfg, [0, 1], device="cpu")
    metrics = runner.run_round(1)
    want = autotune_layout(cfg.model, n_devices=1,
                           global_batch_size=cfg.train.global_batch_size).est_step_s
    assert metrics["server/layout_est_step_s"] == want
    assert metrics["server/layout_search_time"] >= 0.0
    assert runner.runtime.trainer.layout_autotune is None  # pinned to its one device

    def no_layout(*a, **kw):
        raise ValueError("no legal (data, fsdp, tensor, pipe) layout")

    monkeypatch.setattr(autotune, "autotune_layout", no_layout)
    with pytest.warns(UserWarning, match="layout auto-tune probe skipped"):
        quiet = CollectiveFedRunner(cfg, [0, 1], device="cpu")
    assert quiet._layout_metrics == {}
