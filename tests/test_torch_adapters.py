"""The adapter plane's train side in the port (``photon_tpu_torch.adapters``,
``strategy/grouped.py``, the model's LoRA branch, the frozen-base fit).

All CPU, fp32, tiny configs, with weights carried across as numpy arrays
and data made with numpy; one case for each case of
``tests/test_adapters.py`` that runs without the collective plane, held
to the JAX package:

1. ``photon.adapters`` validation (the JAX package's texts; the device
   optimizer stays refused with the collective plane);
2. the ``lora.py`` helpers: names, order, shapes, ``init_adapter_arrays``'
   bits, split/merge and the merge math byte-equal to JAX's;
3. LoRA logits of the port's ``MPTModel`` against ``MPTModel.apply``
   (mpt-wpe, mpt-alibi, llama-gqa) within ``LOGIT_ATOL``;
4. two frozen-base train steps against the JAX ``Trainer``: the base
   bit-unchanged on both sides, the A/B factors within ``PARAM_REL``, the
   optimizer state's names (under the freeze prefix) equal;
5. ``grouped_host_fold`` and ``CohortStrategies`` equal to JAX's;
6. an adapter round written by either package read by the other (base,
   bank, optimizer state, step counters), and the port's host round.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_tpu.config.schema import Config as JaxConfig
from tests._helpers import tiny_llama_config

LOGIT_ATOL = 1e-5
#: A/B after optimizer steps, relative L2 per tensor (fp32 on both sides;
#: the frameworks sum matmuls in different orders)
PARAM_REL = 2e-5
ALL_TARGETS = ("wqkv", "q_proj", "k_proj", "v_proj", "out_proj", "up_proj", "down_proj",
               "gate_proj")


def _port(jcfg: JaxConfig):
    from photon_tpu_torch.config.schema import Config

    return Config.from_dict(jcfg.to_dict())


def _adapter_cfg(**ad) -> JaxConfig:
    cfg = JaxConfig()
    cfg.photon.adapters.enabled = True
    cfg.photon.adapters.cohorts = {"a": [0]}
    for k, v in ad.items():
        setattr(cfg.photon.adapters, k, v)
    return cfg


def _tiny_cfg(kind="mpt-wpe", *, lora_rank=0) -> JaxConfig:
    if kind == "llama-gqa":
        cfg = tiny_llama_config(n_kv_heads=2)
    else:
        cfg = JaxConfig()
        m = cfg.model
        m.d_model, m.n_layers, m.n_heads, m.vocab_size, m.max_seq_len = 32, 2, 4, 64, 16
        m.attn_impl, m.compute_dtype = "xla", "float32"
        m.alibi = kind == "mpt-alibi"
        m.learned_pos_emb = not m.alibi
    cfg.model.lora_rank = lora_rank
    cfg.model.lora_targets = ALL_TARGETS if lora_rank else ()
    return cfg.validate()


def _jax_payload(jcfg: JaxConfig, seed=0):
    from photon_tpu.codec import params_to_ndarrays
    from photon_tpu.models.mpt import init_params

    return params_to_ndarrays(init_params(jcfg.model, seed=seed))


# ---------------------------------------------------------------------------
# 1. validation
# ---------------------------------------------------------------------------

REJECTED = [
    ({"rank": 0}, "rank must be >= 1"),
    ({"alpha": 0.0}, "alpha must be > 0"),
    ({"targets": []}, "targets is empty"),
    ({"targets": ["wqkv", "router"]}, r"\['router'\] are not adaptable"),
    ({"pool_size": 0}, "pool_size must be >= 1"),
]


def test_adapters_config_rejects_bad_rank_alpha_targets():
    """Both packages refuse the same configs with the same texts; the
    resolved YAML with the adapters on and ``model.lora_rank: 8`` validates."""
    for ad, text in REJECTED:
        for cfg in (_adapter_cfg(**ad), _port(_adapter_cfg(**ad))):
            with pytest.raises(ValueError, match=text):
                cfg.validate()
    d = _adapter_cfg(rank=8).to_dict()
    d["model"].update(lora_rank=8, lora_targets=["wqkv", "out_proj"])
    JaxConfig.from_dict(d).validate()
    pcfg = _port(JaxConfig.from_dict(d)).validate()
    assert pcfg.photon.adapters.rank == 8 and pcfg.model.lora_rank == 8
    assert pcfg.to_dict()["photon"]["adapters"] == d["photon"]["adapters"]
    d["model"]["lora_targets"] = ["router"]
    for cfg in (JaxConfig.from_dict(d), _port_from_dict(d)):
        with pytest.raises(ValueError, match=r"model.lora_targets \['router'\]"):
            cfg.validate()


def test_adapters_config_rejects_overlapping_cohorts_and_bad_cids():
    for cohorts, text in (({"a": [0, 1], "b": [1]}, "appears in cohorts 'a' AND 'b'"),
                          ({"a": [0, -1]}, "bad client id -1"),
                          ({"a": 3}, "must be a list"),
                          ({}, "non-empty cohorts map")):
        for cfg in (_adapter_cfg(cohorts=cohorts), _port(_adapter_cfg(cohorts=cohorts))):
            with pytest.raises(ValueError, match=text):
                cfg.validate()


def test_adapters_config_rejects_moe_momenta_device_optimizer():
    for edit, text in (
        (lambda c: (setattr(c.model, "mlp", "moe"), setattr(c.model, "moe_num_experts", 2)),
         "moe"),
        (lambda c: setattr(c.fl, "aggregate_momenta", True), "aggregate_momenta"),
        (lambda c: setattr(c.photon.comm_stack, "collective_device_optimizer", True),
         "device_optimizer"),
    ):
        jcfg = _adapter_cfg()
        edit(jcfg)
        for cfg in (jcfg, _port(jcfg)):
            with pytest.raises(ValueError, match=text):
                cfg.validate()
    # the JAX package's case: the device optimizer with the collective
    # plane, which the port does not run at all
    jcfg = _adapter_cfg()
    jcfg.photon.comm_stack.collective = True
    jcfg.photon.comm_stack.collective_device_optimizer = True
    with pytest.raises(ValueError, match="device_optimizer"):
        jcfg.validate()
    with pytest.raises(NotImplementedError, match="collective"):
        _port(jcfg).validate()
    # model.lora_rank with MoE, as in JAX
    d = JaxConfig().to_dict()
    d["model"].update(mlp="moe", moe_num_experts=2, lora_rank=4, lora_targets=["wqkv"])
    for cfg in (JaxConfig.from_dict(d), _port_from_dict(d)):
        with pytest.raises(ValueError, match="lora_rank with mlp='moe'"):
            cfg.validate()


def _port_from_dict(d):
    from photon_tpu_torch.config.schema import Config

    return Config.from_dict(d)


# ---------------------------------------------------------------------------
# 2. the payload algebra
# ---------------------------------------------------------------------------

def _payloads(llama: bool):
    """(JAX metadata + arrays, port metadata + arrays) of one base tree."""
    from photon_tpu_torch.codec.params import ParamsMetadata

    jcfg = _tiny_cfg("llama-gqa" if llama else "mpt-wpe")
    jm, ja = _jax_payload(jcfg)
    return jcfg, (jm, ja), (ParamsMetadata(jm.names, jm.shapes, jm.dtypes), ja)


@pytest.mark.parametrize("llama", [False, True])
def test_spec_resolves_model_family_and_roundtrips(llama):
    from photon_tpu.adapters import lora as jl
    from photon_tpu.codec import params_to_ndarrays
    from photon_tpu.models.mpt import init_params as jax_init
    from photon_tpu_torch.adapters import lora as tl
    from photon_tpu_torch.models.mpt import init_params, param_shapes

    jcfg, (jm, ja), (tm, ta) = _payloads(llama)
    targets = ("wqkv", "q_proj", "k_proj", "v_proj", "out_proj")
    js, ts = jl.spec_from_base(jm, 4, 16.0, targets), tl.spec_from_base(tm, 4, 16.0, targets)
    assert ts.entries == js.entries and ts.scale == js.scale and ts.n_params == js.n_params
    assert ("wqkv" in ts.modules()) != llama and ("q_proj" in ts.modules()) == llama
    am = tl.adapter_metadata(ts)
    assert am.names == jl.adapter_metadata(js).names and am.shapes == jl.adapter_metadata(js).shapes
    for seed in (0, 3, tl.cohort_seed(17, "a")):
        assert tl.cohort_seed(seed, "b") == jl.cohort_seed(seed, "b")
        (_, x), (_, y) = tl.init_adapter_arrays(ts, seed), jl.init_adapter_arrays(js, seed)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(x, y))
    _, aa = tl.init_adapter_arrays(ts, seed=3)
    mm, ma = tl.merge_payload(tm, ta, am, aa)
    jmm, jma = jl.merge_payload(jm, ja, jl.adapter_metadata(js), aa)
    assert mm.names == jmm.names and all(x is y for x, y in zip(ma, jma))
    bm, ba, am2, aa2 = tl.split_adapter(mm, ma)
    assert bm.names == tm.names and am2.names == am.names
    assert all(x is y for x, y in zip(ba, ta)) and all(x is y for x, y in zip(aa2, aa))
    # the merged order is the LoRA model's canonical order, in both packages
    jcfg.model.lora_rank, jcfg.model.lora_targets = 4, targets
    full_meta, _ = params_to_ndarrays(jax_init(jcfg.model, seed=0))
    pcfg = _port(jcfg).validate()
    assert mm.names == full_meta.names == tuple(param_shapes(pcfg.model))
    assert mm.shapes == full_meta.shapes
    # spec_from_params on a live tree gives the same spec
    assert tl.spec_from_params(init_params(_port(_tiny_cfg("llama-gqa" if llama else "mpt-wpe"))
                                           .model), 4, 16.0, targets) == ts


def test_fresh_adapter_is_identity_and_merge_math():
    from photon_tpu.adapters import lora as jl
    from photon_tpu_torch.adapters import lora as tl

    _, (jm, ja), (tm, ta) = _payloads(False)
    spec = tl.spec_from_base(tm, 4, 8.0, ("wqkv",))
    am, aa = tl.init_adapter_arrays(spec, seed=1)
    for x, y in zip(tl.merge_adapter_into_base(tm, ta, spec, aa), ta):
        np.testing.assert_array_equal(x, y)  # B = 0: the delta is exactly zero
    rng = np.random.default_rng(2)
    aa = [a if n.endswith("_lora_a") else rng.normal(0, 0.1, a.shape).astype(np.float32)
          for n, a in zip(am.names, aa)]
    merged = tl.merge_adapter_into_base(tm, ta, spec, aa)
    want = jl.merge_adapter_into_base(jm, ja, jl.spec_from_base(jm, 4, 8.0, ("wqkv",)), aa)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(merged, want))
    ki = tm.names.index("blocks/block/wqkv/kernel")
    assert not np.array_equal(merged[ki], ta[ki])
    assert all(np.array_equal(x, y) for i, (x, y) in enumerate(zip(merged, ta)) if i != ki)
    tree = tl.adapter_tree(spec, aa)
    assert set(tree) == {"wqkv"} and tree["wqkv"]["a"] is aa[0] and tree["wqkv"]["b"] is aa[1]
    stacked = tl.stack_adapter_trees([tree, tree])
    jstacked = jl.stack_adapter_trees([jl.adapter_tree(spec, aa)] * 2)
    np.testing.assert_array_equal(stacked["wqkv"]["b"], jstacked["wqkv"]["b"])
    assert stacked["wqkv"]["a"].shape == (2,) + aa[0].shape


def test_spec_rejects_rankless_and_unmatched():
    from photon_tpu_torch.adapters.lora import spec_from_base

    _, _, (tm, _) = _payloads(False)
    with pytest.raises(ValueError, match="rank"):
        spec_from_base(tm, 0, 16.0, ("wqkv",))
    with pytest.raises(ValueError, match="no base parameter matches"):
        spec_from_base(tm, 4, 16.0, ("q_proj",))  # MHA has no q_proj


# ---------------------------------------------------------------------------
# 3. the LoRA model against MPTModel.apply
# ---------------------------------------------------------------------------

def _lora_weights(jcfg: JaxConfig, seed=0):
    """(JAX params, port params, payload) of a LoRA model whose B factors
    are non-zero (a fresh B would make every comparison vacuous)."""
    from photon_tpu.codec import params_from_ndarrays
    from photon_tpu.models.mpt import init_params as jax_init
    from photon_tpu_torch.codec.params import params_from_numpy

    jp = jax_init(jcfg.model, seed=seed)
    meta, arrays = _jax_payload(jcfg, seed)
    rng = np.random.default_rng(seed + 100)
    arrays = [rng.normal(0, 0.05, a.shape).astype(np.float32) if n.endswith("_lora_b") else a
              for n, a in zip(meta.names, arrays)]
    jp = params_from_ndarrays(jp, meta, arrays)
    return jp, params_from_numpy(meta.names, arrays, _port(jcfg).model, "cpu"), (meta, arrays)


@pytest.mark.parametrize("kind", ["mpt-wpe", "mpt-alibi", "llama-gqa"])
def test_lora_logits_match_jax(kind):
    from photon_tpu.models.mpt import MPTModel as JaxModel
    from photon_tpu_torch.models.mpt import MPTModel

    jcfg = _tiny_cfg(kind, lora_rank=4)
    jp, tp, (meta, _) = _lora_weights(jcfg)
    assert any(n.endswith("gate_proj_lora_a") for n in meta.names) == (kind == "llama-gqa")
    tokens = np.random.default_rng(1).integers(0, jcfg.model.vocab_size,
                                               (2, jcfg.model.max_seq_len))
    want = np.asarray(JaxModel(jcfg.model).apply({"params": jp}, tokens))
    got = MPTModel(_port(jcfg).validate().model)(tp, torch.from_numpy(tokens)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    # the factors move the logits: B = 0 gives the base model's
    base_cfg = _tiny_cfg(kind)
    from photon_tpu_torch.codec.params import flatten, unflatten

    base = unflatten({n: t for n, t in flatten(tp).items() if "_lora_" not in n})
    plain = MPTModel(_port(base_cfg).validate().model)(base, torch.from_numpy(tokens))
    assert float((plain - torch.from_numpy(got)).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# 4. the frozen-base fit against the JAX Trainer
# ---------------------------------------------------------------------------

def _fit_cfg() -> JaxConfig:
    from photon_tpu.adapters import configure_adapter_training

    cfg = _tiny_cfg()
    cfg.photon.adapters.enabled = True
    cfg.photon.adapters.rank = 4
    cfg.photon.adapters.cohorts = {"a": [0], "b": [1]}
    cfg.train.global_batch_size, cfg.train.device_microbatch_size = 4, 2
    cfg.optimizer.name, cfg.optimizer.lr = "adamw", 1e-2
    cfg.scheduler.t_warmup, cfg.scheduler.t_max = 0, 20
    return configure_adapter_training(cfg).validate()


def test_frozen_base_fit_matches_jax_trainer():
    """Two steps (AdamW, two microbatches, a real update each): the base
    bit-unchanged in both packages, A/B and their moments within
    ``PARAM_REL`` of JAX's, the loss within 2e-5, the optimizer state under
    the freeze prefix with JAX's names; no gradient is computed for the
    base (its leaves require none)."""
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.adapters import configure_adapter_training
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.optim.build import FREEZE_PREFIX
    from photon_tpu_torch.train.trainer import Trainer

    jcfg = _fit_cfg()
    pcfg = configure_adapter_training(_port(jcfg)).validate()
    assert pcfg.optimizer.freeze_patterns == jcfg.optimizer.freeze_patterns
    jp, tp, (meta, arrays) = _lora_weights(jcfg)
    jt = JaxTrainer(dataclasses.replace(jcfg), params=jp)
    pt = Trainer(pcfg, params=tp, device="cpu")
    assert [n for n, p in flatten(pt.state.params).items() if p.requires_grad] == \
        [n for n in meta.names if "_lora_" in n]
    batches = [np.random.default_rng(s).integers(0, 64, (4, 16)).astype(np.int32)
               for s in range(2)]
    jm, pm = jt.fit(batches, 2), pt.fit(batches, 2)
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=2e-5)
    np.testing.assert_allclose(pm["param_norm"], jm["param_norm"], rtol=2e-5)
    (pmeta, pa), (jmeta, ja) = pt.get_parameters(), jt.get_parameters()
    assert pmeta.names == jmeta.names == meta.names
    for name, x, y, a0 in zip(meta.names, pa, ja, arrays):
        if "_lora_" in name:
            assert not np.array_equal(x, a0), name  # the factors trained
            rel = np.linalg.norm(x - y) / np.linalg.norm(y)
            assert rel <= PARAM_REL, (name, rel)
        else:  # the base is bit-frozen on both sides
            np.testing.assert_array_equal(x, a0, err_msg=name)
            np.testing.assert_array_equal(y, a0, err_msg=name)
    om, oa = pt.get_opt_state_arrays()
    jom, joa = jt.get_opt_state_arrays()
    assert om.names == jom.names and om.dtypes == jom.dtypes
    assert all(n.startswith(FREEZE_PREFIX) for n in om.names)
    assert not any("_lora_" not in n and ".mu/" in n for n in om.names)
    for name, x, y in zip(om.names, oa, joa):
        if ".mu/" in name or ".nu/" in name:
            rel = np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30)
            assert rel <= 1e-4, (name, rel)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_lora_grad_norm_parts_from_jax():
    """Where the packages part under LoRA: the port's frozen base makes no
    gradient, so its ``grad_norm`` is the A/B factors' norm; the JAX step
    computes the base gradients too (then zeroes their updates), and its
    ``grad_norm`` counts them. Both clip on the A/B norm (JAX's clip sits
    inside ``multi_transform``'s trainable partition): with the clip
    between the two norms neither clips, and each lands its factors where
    an unclipped step does. ``eps = 1`` makes the step follow the
    gradient's scale (``g / (|g| + 1)``), so a clip on the larger norm
    would show."""
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.adapters import configure_adapter_training
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.models.mpt import MPTModel
    from photon_tpu_torch.train.train_step import make_loss_fn
    from photon_tpu_torch.train.trainer import Trainer

    jcfg = _fit_cfg()
    jcfg.optimizer.eps = 1.0
    pcfg = configure_adapter_training(_port(jcfg)).validate()
    batch = np.random.default_rng(0).integers(0, 64, (4, 16)).astype(np.int32)
    # both norms by autograd: every leaf, over the config's 2 microbatches
    _, tp, (meta, arrays) = _lora_weights(jcfg)
    leaves = [p.requires_grad_(True) for p in flatten(tp).values()]
    loss_fn = make_loss_fn(MPTModel(pcfg.model), pcfg.train.loss_chunk_tokens)
    loss = sum(loss_fn(tp, mb) for mb in torch.from_numpy(batch).long().reshape(2, 2, 16)) / 2
    grads = dict(zip(flatten(tp), torch.autograd.grad(loss, leaves)))
    ab = float(torch.sqrt(sum((g.double() ** 2).sum() for n, g in grads.items()
                              if "_lora_" in n)))
    full = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    tau = (ab * full) ** 0.5
    assert tau / full < 0.95  # a clip on the full norm would scale the step visibly

    def fit(package, clip):
        jc = dataclasses.replace(jcfg)
        jc.optimizer = dataclasses.replace(jcfg.optimizer, grad_clip_norm=clip)
        jp, tp, _ = _lora_weights(jcfg)
        if package == "jax":
            t = JaxTrainer(jc, params=jp)
        else:
            t = Trainer(configure_adapter_training(_port(jc)).validate(), params=tp,
                        device="cpu")
        m = t.fit([batch], 1)
        moved = {n: x - a0 for n, x, a0 in zip(meta.names, t.get_parameters()[1], arrays)
                 if "_lora_" in n}
        return m["grad_norm"], moved

    pn, p_moved = fit("port", tau)
    jn, j_moved = fit("jax", tau)
    np.testing.assert_allclose(pn, ab, rtol=1e-5)
    np.testing.assert_allclose(jn, full, rtol=1e-4)
    assert pn < jn
    _, free = fit("port", 1e9)  # a clip that never fires
    for name, want in free.items():
        for got in (p_moved[name], j_moved[name]):
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-3, (name, rel)


# ---------------------------------------------------------------------------
# 5. the per-cohort folds and strategies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["fedavg", "fedadam"])
def test_grouped_fold_and_cohort_strategies_match_jax(strategy):
    from photon_tpu.config.schema import FLConfig as JaxFL
    from photon_tpu.strategy.grouped import CohortStrategies as JaxCS
    from photon_tpu.strategy.grouped import cohort_of_map as jax_map
    from photon_tpu.strategy.grouped import cohort_onehot
    from photon_tpu.strategy.grouped import grouped_host_fold as jax_fold
    from photon_tpu_torch.config.schema import FLConfig
    from photon_tpu_torch.strategy.grouped import (
        CohortStrategies,
        cohort_of_map,
        grouped_host_fold,
    )

    rng = np.random.default_rng(0)
    cohorts = {"beta": [2, 3, 5], "alpha": [0, 1], "gamma": [7]}
    assert cohort_of_map(cohorts) == jax_map(cohorts)
    shapes = ((6, 4), (9,), (2, 3, 5))
    landed = {cid: ([rng.normal(size=s).astype(np.float32) for s in shapes],
                    int(rng.integers(1, 30))) for cid in (5, 0, 3, 1, 4, 2)}  # 4: no cohort
    got, want = grouped_host_fold(landed, cohort_of_map(cohorts)), jax_fold(landed,
                                                                          jax_map(cohorts))
    assert set(got) == set(want) == {"alpha", "beta"}  # gamma landed nothing
    for name in want:
        assert got[name][1:] == want[name][1:]
        assert all(x.tobytes() == y.tobytes() for x, y in zip(got[name][0], want[name][0]))
    np.testing.assert_array_equal(cohort_onehot([0, 4], jax_map(cohorts), ["alpha", "beta"]),
                                  [[1, 0], [0, 0]])
    kw = dict(strategy_name=strategy, server_learning_rate=0.5, server_tau=1e-3)
    ts, js = CohortStrategies(FLConfig(**kw), cohorts), JaxCS(JaxFL(**kw), cohorts)
    assert ts.names == js.names and ts.state_keys == js.state_keys
    init = {n: [rng.normal(size=s).astype(np.float32) for s in shapes] for n in cohorts}
    ts.initialize(init)
    js.initialize(init)
    for rnd in (1, 2):
        for name, (avg, n, k) in want.items():
            mt = ts.apply_average(rnd, name, avg, n, k)
            mj = js.apply_average(rnd, name, avg, n, k)
            assert mt == pytest.approx(mj, rel=1e-12)
    for name in cohorts:
        assert all(x.tobytes() == y.tobytes() for x, y in zip(ts.params(name), js.params(name)))
    assert ts.t_counters() == js.t_counters()
    st, sj = ts.state_for_checkpoint(), js.state_for_checkpoint()
    assert {n: sorted(v) for n, v in st.items()} == {n: sorted(v) for n, v in sj.items()}
    with pytest.raises(ValueError, match="no initial adapter"):
        CohortStrategies(FLConfig(**kw), ["a"]).initialize({})


# ---------------------------------------------------------------------------
# 6. the adapter round checkpoint across the packages, and the host round
# ---------------------------------------------------------------------------

def _planes(cfg_j: JaxConfig, seed=0):
    from photon_tpu.adapters import AdapterTrainPlane as JaxPlane
    from photon_tpu_torch.adapters import AdapterTrainPlane
    from photon_tpu_torch.codec.params import ParamsMetadata

    base_cfg = _tiny_cfg()
    jm, ja = _jax_payload(base_cfg, seed)
    return (JaxPlane(cfg_j, jm, ja),
            AdapterTrainPlane(_port(cfg_j), ParamsMetadata(jm.names, jm.shapes, jm.dtypes), ja))


def _round_cfg(strategy="fedadam") -> JaxConfig:
    cfg = _fit_cfg()
    cfg.fl.strategy_name, cfg.fl.server_learning_rate, cfg.fl.server_tau = strategy, 0.1, 1e-3
    return cfg.validate()


def _step_cohorts(plane, rnd, seed):
    rng = np.random.default_rng(seed)
    for name in plane.cohort_names:
        avg = [a + rng.normal(0, 0.01, a.shape).astype(np.float32)
               for a in plane.strategies.params(name)]
        plane.strategies.apply_average(rnd, name, avg, 8, 2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adapter_round_checkpoint_crosses_packages(tmp_path, writer):
    """A round written by one package (the JAX runner's ``save_checkpoint``
    layout: base params, ``adapter__*``, ``astate__*``, ``adapter_t``)
    resumes in the other's plane and serves its bank through the other's
    ``load_adapter_bank`` and ``PagedEngine.from_checkpoint``."""
    from photon_tpu.adapters import adapter_state_keys as jax_state_keys
    from photon_tpu.adapters import load_adapter_bank as jax_bank
    from photon_tpu.checkpoint import FileStore as JaxStore
    from photon_tpu.checkpoint.server import ServerCheckpointManager as JaxMgr
    from photon_tpu_torch.adapters import load_adapter_bank
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    cfg = _round_cfg()
    jplane, tplane = _planes(cfg)
    assert tplane.checkpoint_state_keys() == jax_state_keys(
        jplane.cohort_names, jplane.strategies.state_keys)
    jmgr = JaxMgr(JaxStore(str(tmp_path / "store")), "ad")
    tmgr = ServerCheckpointManager(FileStore(str(tmp_path / "store")), "ad")
    src = jplane if writer == "jax" else tplane
    _step_cohorts(src, 1, seed=5)
    if writer == "jax":  # CollectiveFedRunner.save_checkpoint's objects
        st = jplane.strategies
        state = {}
        for name in st.names:
            state[f"adapter__{name}"] = st.adapters_for_checkpoint()[name]
            for k, v in st.state_for_checkpoint()[name].items():
                state[f"astate__{name}__{k}"] = v
        jmgr.save_round(1, jplane.base_meta, jplane.base_arrays, strategy_state=state,
                        server_state={"server_round": 1, "adapter_t": st.t_counters()})
        dst, (rnd, _) = tplane, tplane.resume(tmgr, -1)
    else:
        tplane.server_steps_cumulative = 4
        tplane.save_round(tmgr, 1)
        keys = jplane.strategies.state_keys
        r = jmgr.resolve_resume_round(-1, jax_state_keys(jplane.cohort_names, keys))
        _, params, state, control = jmgr.load_round(
            r, jax_state_keys(jplane.cohort_names, keys))
        jplane.base_arrays = params
        jplane.strategies.initialize(
            {n: state[f"adapter__{n}"] for n in jplane.cohort_names},
            {n: {k: state[f"astate__{n}__{k}"] for k in keys} for n in jplane.cohort_names},
            t=control["adapter_t"])
        dst, rnd = jplane, r
        assert control["server_steps_cumulative"] == 4
    assert rnd == 1 and tmgr.verify_round(1)
    for x, y in zip(src.base_arrays, dst.base_arrays):
        np.testing.assert_array_equal(x, y)
    for name in src.cohort_names:
        for x, y in zip(src.strategies.params(name), dst.strategies.params(name)):
            np.testing.assert_array_equal(x, y)
        for key in src.strategies.state_keys:
            for x, y in zip(src.strategies[name].state[key], dst.strategies[name].state[key]):
                np.testing.assert_array_equal(x, y)
    assert src.strategies.t_counters() == dst.strategies.t_counters() == {"a": 1, "b": 1}
    bank, jbank = load_adapter_bank(tmgr, 1, {"a": [], "b": []}), jax_bank(jmgr, 1, ["a", "b"])
    assert sorted(bank) == ["a", "b"]
    for name in bank:
        assert all(x.tobytes() == y.tobytes() for x, y in zip(bank[name], jbank[name]))
        np.testing.assert_array_equal(bank[name][1], src.strategies.params(name)[1])
    assert load_adapter_bank(tmgr, 1, ["a"]).keys() == {"a"}


def test_host_adapter_round_folds_cohorts_like_the_oracle(tmp_path):
    """The port's host round (``AdapterTrainPlane.run_round`` over one
    ``ClientRuntime`` on the CPU): the base never moves, each cohort's
    adapter moves and the cohorts part, and each cohort's update equals a
    FedAvg oracle over the adapter rows that landed."""
    from photon_tpu_torch.adapters import configure_adapter_training
    from photon_tpu_torch.federation.client_runtime import ClientRuntime
    from photon_tpu_torch.federation.transport import ParamTransport
    from photon_tpu_torch.strategy.grouped import grouped_host_fold
    from photon_tpu_torch.strategy.optimizers import FedAvgEff

    cfg = _round_cfg("fedavg")
    cfg.fl.server_learning_rate, cfg.fl.local_steps = 1.0, 2
    cfg.photon.adapters.cohorts = {"a": [0, 1], "b": [2]}
    cfg.dataset.synthetic = True
    cfg.photon.save_path = str(tmp_path / "run")
    _, plane = _planes(cfg.validate())
    pcfg = configure_adapter_training(_port(cfg)).validate()
    runtime = ClientRuntime(pcfg, ParamTransport("inline"), device="cpu")
    base0 = [a.copy() for a in plane.base_arrays]
    before = {n: [a.copy() for a in plane.strategies.params(n)] for n in plane.cohort_names}
    spied = {}
    real = plane.extract_adapter

    def spy(meta, arrays):
        out = real(meta, arrays)
        spied[len(spied)] = ([a.copy() for a in out], 2 * 4)
        return out

    plane.extract_adapter = spy
    m = plane.run_round(runtime, 1, [0, 1, 2, 3])
    assert m["server/adapter_cohorts"] == 2.0 and sorted(plane.client_states) == [0, 1, 2, 3]
    assert m["server/steps_cumulative"] == 2.0 == plane.server_steps_cumulative
    for x, y in zip(base0, plane.base_arrays):
        np.testing.assert_array_equal(x, y)
    a1, b1 = plane.strategies.params("a"), plane.strategies.params("b")
    assert any(not np.array_equal(x, y) for x, y in zip(before["a"], a1))
    assert any(not np.array_equal(x, y) for x, y in zip(a1, b1))
    # spied in fit order: cids 0, 1 (cohort a), 2 (b), 3 (no cohort)
    folds = grouped_host_fold({c: spied[c] for c in range(4)}, {0: "a", 1: "a", 2: "b"})
    for name in ("a", "b"):
        oracle = FedAvgEff(server_learning_rate=1.0)
        oracle.initialize(before[name])
        oracle.apply_average(1, *folds[name])
        for got, want in zip(plane.strategies.params(name), oracle.current_parameters):
            np.testing.assert_array_equal(got, want)


def test_host_adapter_round_honours_fit_config_and_keeps_control_state(tmp_path):
    """The plane keeps the runner's control state as the JAX collective
    runner does: every fit gets ``fl.fit_config`` (here
    ``reset_optimizer``, so one runtime's trainer carries no moments from
    one cohort's fit into the next), the step counter advances by
    ``fl.local_steps`` a round, the clients' states ride the next round's
    fits, and ``save_round`` / ``resume`` carry both across a restart."""
    from photon_tpu_torch.adapters import configure_adapter_training
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.federation.client_runtime import ClientRuntime
    from photon_tpu_torch.federation.transport import ParamTransport

    cfg = _round_cfg("fedavg")
    cfg.fl.local_steps, cfg.fl.fit_config = 1, {"reset_optimizer": True}
    cfg.dataset.synthetic = True
    cfg.photon.save_path = str(tmp_path / "run")
    _, plane = _planes(cfg.validate())
    pcfg = configure_adapter_training(_port(cfg)).validate()
    assert pcfg.fl.fit_config == {"reset_optimizer": True}
    runtime = ClientRuntime(pcfg, ParamTransport("inline"), device="cpu")
    seen, resets = [], []
    real_fit, real_reset = runtime.fit, runtime.trainer.reset_optimizer

    def fit(ins, cid):
        seen.append((ins.server_round, cid, dict(ins.config), ins.server_steps_cumulative,
                     sorted(ins.client_states)))
        return real_fit(ins, cid)

    def reset():
        resets.append(1)
        real_reset()

    runtime.fit, runtime.trainer.reset_optimizer = fit, reset
    plane.run_round(runtime, 1, [0, 1])
    plane.run_round(runtime, 2, [0, 1])
    assert seen == [(1, 0, {"reset_optimizer": True}, 0, []),
                    (1, 1, {"reset_optimizer": True}, 0, []),
                    (2, 0, {"reset_optimizer": True}, 1, [0]),
                    (2, 1, {"reset_optimizer": True}, 1, [1])]
    assert len(resets) == 4 and plane.server_steps_cumulative == 2
    mgr = ServerCheckpointManager(FileStore(str(tmp_path / "store")), "ad")
    plane.save_round(mgr, 2)
    _, fresh = _planes(cfg)
    rnd, control = fresh.resume(mgr, -1)
    assert rnd == 2 and control["server_steps_cumulative"] == fresh.server_steps_cumulative == 2
    assert fresh.client_states == plane.client_states and sorted(fresh.client_states) == [0, 1]
