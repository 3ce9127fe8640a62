"""The port's training path (``photon_tpu_torch``) against the JAX package's.

All CPU, fp32, tiny configs (mpt-wpe, mpt-alibi, llama-gqa: rope, swiglu,
untied head, rmsnorm, remat; mpt-d128: the d_head-128 family of mpt-1b
and mpt-3b, with remat), with weights from the JAX ``init_params`` carried
across as numpy arrays and token batches made with numpy:

1. model logits and hidden states against ``MPTModel.apply``;
2. 3 train steps with 2 microbatches against ``make_train_step`` (loss,
   grad_norm, param_norm, params, optimizer state): ADOPT, AdamW, a
   binding clip, ``freeze_patterns``, full and chunked (padded) CE;
3. the schedule against ``build_schedule``; the optimizer-state names
   against ``flatten_params(tx.init(...))``;
4. a JAX-written synthetic dataset gives the same batches, and resumes
   the same way, in the port's loader;
5. ``Trainer`` against the JAX ``Trainer`` (fit metrics, ``set_step``,
   ``reset_optimizer``, ``get/set_momenta``);
6. a client checkpoint written by either package's ``run_centralized``
   resumes in the other;
7. ``python -m photon_tpu_torch.centralized --device cpu`` end to end;
   what this slice does not port is refused at ``validate()``;
8. ``device_microbatch_size: auto``: one case per case of
   ``tests/test_auto_microbatch.py`` (the largest microbatch that fits,
   halving on an OOM, no fit, a non-OOM error propagates).
"""

import dataclasses
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.codec.params import flatten_params
from photon_tpu.codec.params import params_to_ndarrays as jax_to_ndarrays
from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu.models.mpt import MPTModel as JaxModel
from photon_tpu.models.mpt import init_params as jax_init
from tests._helpers import tiny_llama_config

torch.backends.cuda.matmul.allow_tf32 = False

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: fp32 on both sides; the frameworks sum matmuls in different orders
LOGIT_ATOL = 2e-5
#: parameters after 3 optimizer steps, relative L2 per tensor: ADOPT and
#: Adam divide by the gradient's own scale, so the frameworks' rounding
#: moves a few near-zero-gradient elements by ~1e-5 (lr 1e-2)
PARAM_REL = 2e-5
#: optimizer moments, relative L2 per tensor: ADOPT's m sums g / sqrt(v_prev),
#: which amplifies the frameworks' rounding where v_prev comes from a
#: near-zero gradient (a few elements in 1e4 differ by ~1e-4 against m ~ 0.1)
MOMENT_REL = 1e-4
CONFIGS = ["mpt-wpe", "mpt-alibi", "llama-gqa", "mpt-d128"]


def _jax_cfg(kind: str) -> JaxConfig:
    if kind == "llama-gqa":
        cfg = tiny_llama_config(n_kv_heads=1)
        cfg.model.remat = True
    else:
        cfg = JaxConfig()
        m = cfg.model
        m.d_model, m.n_layers, m.n_heads, m.vocab_size, m.max_seq_len = 32, 2, 4, 96, 16
        m.attn_impl, m.compute_dtype = "xla", "float32"
        m.alibi = kind == "mpt-alibi"
        m.learned_pos_emb = not m.alibi
        if kind == "mpt-d128":  # mpt-1b's head dim at a tiny width
            m.d_model, m.n_heads, m.remat = 256, 2, True
    cfg.train.global_batch_size, cfg.train.device_microbatch_size = 4, 2
    cfg.optimizer.lr = 1e-2
    cfg.scheduler.t_warmup, cfg.scheduler.t_max = 2, 20
    return cfg.validate()


def _port_cfg(jcfg: JaxConfig, attn_impl: str = "pallas"):
    from photon_tpu_torch.config.schema import Config

    cfg = Config.from_dict(jcfg.to_dict())
    cfg.model.attn_impl = attn_impl
    return cfg.validate()


def _weights(jcfg: JaxConfig, pcfg, seed=0):
    """(JAX params, port params) holding the same numbers."""
    from photon_tpu_torch.codec.params import params_from_numpy

    jp = jax_init(jcfg.model, seed=seed)
    meta, arrays = jax_to_ndarrays(jp)
    return jp, params_from_numpy(meta.names, arrays, pcfg.model, "cpu")


def _tokens(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.model.vocab_size, (n, cfg.model.max_seq_len)).astype(np.int32)


def _close(got, want, name="", tol=MOMENT_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= tol or np.array_equal(got, want), (name, rel)


def _port_flat(params) -> dict:
    from photon_tpu_torch.codec.params import flatten

    return {k: v.detach().numpy() for k, v in flatten(params).items()}


# ---------------------------------------------------------------------------
# 1. model forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
@pytest.mark.parametrize("kind", CONFIGS)
def test_model_matches_jax(kind, attn_impl):
    from photon_tpu_torch.models.mpt import MPTModel

    jcfg = _jax_cfg(kind)
    pcfg = _port_cfg(jcfg, attn_impl)
    jp, tp = _weights(jcfg, pcfg)
    toks = _tokens(jcfg, 3)
    jm, pm = JaxModel(jcfg.model), MPTModel(pcfg.model)
    with torch.no_grad():
        logits = pm(tp, torch.from_numpy(toks).long())
        hidden = pm(tp, torch.from_numpy(toks).long(), return_hidden=True)
    np.testing.assert_allclose(logits.numpy(), jm.apply({"params": jp}, toks), atol=LOGIT_ATOL)
    np.testing.assert_allclose(hidden.numpy(),
                               jm.apply({"params": jp}, toks, return_hidden=True),
                               atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# 2. train step
# ---------------------------------------------------------------------------

STEP_CASES = {
    # name: (config kind, optimizer overrides, loss_chunk_tokens)
    "adopt_full_logits": ("mpt-wpe", {}, 0),
    "adopt_chunked_padded": ("mpt-wpe", {}, 20),  # 2 * 15 tokens: the last chunk pads
    "adamw_wd": ("llama-gqa", {"name": "adamw", "weight_decay": 0.1}, 20),
    "adopt_binding_clip": ("mpt-alibi", {"grad_clip_norm": 0.05, "weight_decay": 0.1}, 16),
    "adopt_freeze": ("mpt-wpe", {"freeze_patterns": ["blocks/.*ln_1", "wpe"]}, 20),
    "adamw_freeze_clip": ("mpt-wpe", {"name": "adamw", "freeze_patterns": ["ln_f"],
                                      "grad_clip_norm": 0.05}, 0),
    # mpt-1b's recipe: D=128 heads, remat, AdamW (0.9, 0.95), a binding clip
    "adamw_d128_remat": ("mpt-d128", {"name": "adamw", "betas": (0.9, 0.95),
                                      "grad_clip_norm": 0.05}, 20),
}


def _jax_steps(jcfg, jp, batches, chunk):
    from photon_tpu.optim import build_optimizer
    from photon_tpu.train.train_step import init_train_state, make_train_step

    model = JaxModel(jcfg.model)
    tx, _ = build_optimizer(jcfg.optimizer, jcfg.scheduler)
    state = init_train_state(model, tx, jp)
    step = jax.jit(make_train_step(model, tx, n_microbatches=2, loss_chunk_tokens=chunk))
    metrics = []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case):
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.models.mpt import MPTModel
    from photon_tpu_torch.optim import build_optimizer
    from photon_tpu_torch.train.train_step import init_train_state, make_train_step

    kind, opt, chunk = STEP_CASES[case]
    jcfg = _jax_cfg(kind)
    for k, v in opt.items():
        setattr(jcfg.optimizer, k, v)
    pcfg = _port_cfg(jcfg)
    jp, tp = _weights(jcfg, pcfg)
    batches = [_tokens(jcfg, 4, seed=s) for s in (1, 1, 2)]  # step 0 of ADOPT: no update
    jstate, jmetrics = _jax_steps(jcfg, jp, batches, chunk)
    if jcfg.optimizer.grad_clip_norm < 1.0:  # the clip binds on every step
        assert all(m["grad_norm"] > jcfg.optimizer.grad_clip_norm for m in jmetrics)

    tx, _ = build_optimizer(pcfg.optimizer, pcfg.scheduler)
    state = init_train_state(tx, tp)
    step = make_train_step(MPTModel(pcfg.model), tx, n_microbatches=2, loss_chunk_tokens=chunk)
    for b, jm in zip(batches, jmetrics):
        state, m = step(state, torch.from_numpy(b).long())
        for key in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=2e-5, err_msg=key)
    assert state.step == 3
    jflat = dict(zip(*flatten_params(jstate.params)))
    pflat = _port_flat(state.params)
    assert list(pflat) == list(jflat)
    for name, a in pflat.items():
        _close(a, jflat[name], name, PARAM_REL)
    frozen = [n for n in pflat if not tx.trainable(n)]
    assert bool(frozen) == bool(opt.get("freeze_patterns"))
    for name in frozen:  # frozen params never move
        np.testing.assert_array_equal(pflat[name], _port_flat(tp)[name])
    jopt = dict(zip(*flatten_params(jstate.opt_state)))
    assert sorted(state.opt_state) == list(jopt)
    for name, t in state.opt_state.items():
        want = np.asarray(jopt[name])
        assert t.numpy().dtype == want.dtype and t.shape == want.shape, name
        _close(t.numpy(), want, name)
    assert set(flatten(state.params)) == set(pflat)


def test_adopt_step_zero_applies_no_update():
    from photon_tpu_torch.models.mpt import MPTModel
    from photon_tpu_torch.optim import build_optimizer
    from photon_tpu_torch.train.train_step import init_train_state, make_train_step

    jcfg = _jax_cfg("mpt-wpe")
    pcfg = _port_cfg(jcfg)
    _, tp = _weights(jcfg, pcfg)
    before = _port_flat(tp)
    tx, _ = build_optimizer(pcfg.optimizer, pcfg.scheduler)
    state = init_train_state(tx, tp)
    step = make_train_step(MPTModel(pcfg.model), tx, n_microbatches=2)
    b = torch.from_numpy(_tokens(jcfg, 4)).long()
    state, m0 = step(state, b)
    assert all(np.array_equal(before[k], v) for k, v in _port_flat(state.params).items())
    state, m1 = step(state, b)
    state, m2 = step(state, b)
    assert float(m0["loss"]) == float(m1["loss"]) and float(m2["loss"]) < float(m1["loss"])


# ---------------------------------------------------------------------------
# 3. schedule, optimizer-state names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,t_max,alpha", [(100, 4800, 0.1), (0, 10, 0.0), (5, 5, 0.5)])
def test_schedule_matches_jax(warmup, t_max, alpha):
    from photon_tpu.config.schema import SchedulerConfig as JSched
    from photon_tpu.optim import build_schedule as jax_schedule
    from photon_tpu_torch.config.schema import SchedulerConfig
    from photon_tpu_torch.optim import build_schedule

    js = jax_schedule(JSched(t_warmup=warmup, t_max=t_max, alpha_f=alpha), 6e-4)
    ps = build_schedule(SchedulerConfig(t_warmup=warmup, t_max=t_max, alpha_f=alpha), 6e-4)
    counts = [0, 1, 2, 4, 5, 6, 9, 50, 99, 100, 101, 2000, 4799, 4800, 6000]
    np.testing.assert_allclose([ps(c) for c in counts], [float(js(c)) for c in counts],
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", ["adopt", "adamw"])
@pytest.mark.parametrize("freeze", [[], ["ln_f", "blocks/.*up_proj"]])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_optimizer_state_names_match_optax(name, freeze, clip):
    from photon_tpu.optim import build_optimizer as jax_build
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.optim import build_optimizer

    jcfg = _jax_cfg("llama-gqa")
    jcfg.optimizer.name, jcfg.optimizer.freeze_patterns = name, freeze
    jcfg.optimizer.grad_clip_norm = clip
    pcfg = _port_cfg(jcfg)
    jp, tp = _weights(jcfg, pcfg)
    jtx, _ = jax_build(jcfg.optimizer, jcfg.scheduler)
    jnames, jleaves = flatten_params(jtx.init(jp))
    tx, _ = build_optimizer(pcfg.optimizer, pcfg.scheduler)
    state = tx.init(flatten(tp))
    assert list(state) == jnames
    for (n, t), leaf in zip(state.items(), jleaves):
        assert tuple(t.shape) == tuple(np.shape(leaf)) and str(t.dtype)[6:] == str(leaf.dtype), n


# ---------------------------------------------------------------------------
# 4. data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_matches_jax_and_resumes(tmp_path, shuffle):
    from photon_tpu.data import StreamingLoader as JaxLoader
    from photon_tpu.data import make_synthetic_dataset as jax_make
    from photon_tpu_torch.data import ShardedDataset, StreamingLoader, make_synthetic_dataset

    jax_make(str(tmp_path / "jax"), n_samples=70, seq_len=12, vocab_size=300, seed=5,
             samples_per_shard=16)
    ds = ShardedDataset(tmp_path / "jax", validate=True)
    jl = JaxLoader(str(tmp_path / "jax"), batch_size=8, seed=3, shuffle=shuffle,
                   shuffle_block_size=32)
    pl = StreamingLoader(ds, batch_size=8, seed=3, shuffle=shuffle, shuffle_block_size=32)
    for _ in range(12):  # crosses an epoch boundary (70 samples)
        np.testing.assert_array_equal(next(pl), next(jl))
    saved = pl.state_dict()
    assert saved == jl.state_dict()
    want = [next(jl) for _ in range(3)]
    resumed = StreamingLoader(ds, batch_size=8, seed=3, shuffle=shuffle, shuffle_block_size=32)
    resumed.load_state_dict(saved)
    for w in want:
        np.testing.assert_array_equal(next(resumed), w)
    # the port writes the same bytes the JAX package reads
    make_synthetic_dataset(str(tmp_path / "port"), n_samples=70, seq_len=12, vocab_size=300,
                           seed=5, samples_per_shard=16)
    for f in sorted((tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / f.name).read_bytes() == f.read_bytes(), f.name


# ---------------------------------------------------------------------------
# 5. Trainer
# ---------------------------------------------------------------------------

def test_trainer_matches_jax_trainer():
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.train.trainer import Trainer

    jcfg = _jax_cfg("mpt-wpe")
    jcfg.train.loss_chunk_tokens = 20
    pcfg = _port_cfg(jcfg)
    jp, tp = _weights(jcfg, pcfg)
    jt = JaxTrainer(dataclasses.replace(jcfg), params=jp)
    pt = Trainer(pcfg, params=tp, device="cpu")
    assert pt._n_micro == jt._n_micro == 2
    batches = [_tokens(jcfg, 4, seed=s) for s in range(4)]
    jm = jt.fit(batches[:3], 3)
    pm = pt.fit(batches[:3], 3)
    assert set(jm) - {"throughput/mfu"} == set(pm)  # no MFU without a known peak
    for key in ("loss", "grad_norm", "param_norm", "client/final_loss", "client/lr",
                "client/steps"):
        np.testing.assert_allclose(pm[key], jm[key], rtol=2e-5, err_msg=key)
    assert pt.step == jt.step == 3
    ev_j, ev_p = jt.evaluate(batches[3:]), pt.evaluate(batches[3:])
    np.testing.assert_allclose(ev_p["eval/loss"], ev_j["eval/loss"], rtol=2e-5)
    # momenta, opt-state arrays and the step counter cross over
    for a, b in zip(pt.get_momenta(), jt.get_momenta()):
        for x, y in zip(a, b):
            _close(x, y)
    jt.set_step(10)
    pt.set_step(10)
    om, oa = pt.get_opt_state_arrays()
    jom, joa = jt.get_opt_state_arrays()
    assert om.names == jom.names and om.dtypes == jom.dtypes
    assert [int(a) for n, a in zip(om.names, oa) if n.endswith(".count")] == [10]
    m1, m2 = jt.get_momenta()
    pt.set_momenta([2 * x for x in m1], m2)
    jt.set_momenta([2 * x for x in m1], m2)
    jm, pm = jt.fit([batches[3]], 1), pt.fit([batches[3]], 1)
    for key in ("loss", "grad_norm", "param_norm", "client/lr"):
        np.testing.assert_allclose(pm[key], jm[key], rtol=2e-5, err_msg=key)
    pt.reset_optimizer()
    jt.reset_optimizer()
    assert pt.step == jt.step == 11
    assert all(not np.any(x) for x in pt.get_momenta()[0])
    jm, pm = jt.fit([batches[0]], 1), pt.fit([batches[0]], 1)  # count 0 again: no update
    np.testing.assert_allclose(pm["param_norm"], jm["param_norm"], rtol=2e-5)
    for x, y in zip(pt.get_parameters()[1], jt.get_parameters()[1]):
        _close(x, y, tol=PARAM_REL)
    # set_parameters writes in place
    meta, arrays = jt.get_parameters()
    ref = next(iter(pt.state.params.values()))
    pt.set_parameters(meta, [a * 0 for a in arrays])
    assert next(iter(pt.state.params.values())) is ref
    assert all(not np.any(a) for a in pt.get_parameters()[1])


def test_trainer_batch_rounding_warns():
    from photon_tpu_torch.train.trainer import Trainer

    jcfg = _jax_cfg("mpt-wpe")
    pcfg = _port_cfg(jcfg)
    pcfg.train.global_batch_size, pcfg.train.device_microbatch_size = 6, 4
    with pytest.warns(UserWarning, match="adapted to 4"):
        t = Trainer(pcfg, device="cpu")
    assert t.effective_global_batch_size == 4 and t._n_micro == 1
    pcfg = _port_cfg(jcfg)
    pcfg.train.global_batch_size, pcfg.train.device_microbatch_size = 2, 4
    with pytest.warns(UserWarning, match="clamped to 2"):
        assert Trainer(pcfg, device="cpu").device_microbatch_size == 2


# ---------------------------------------------------------------------------
# 6. checkpoints across packages, 7. the entry point and refusals
# ---------------------------------------------------------------------------

def _central_cfg(save_path):
    jcfg = _jax_cfg("mpt-wpe")
    jcfg.dataset.synthetic = True
    jcfg.photon.save_path = str(save_path)
    jcfg.train.eval_batches = 1
    jcfg.train.loss_chunk_tokens = 20
    jcfg.photon.keep_checkpoints = 5
    return jcfg


def _params_at(store_root, run, step):
    from photon_tpu_torch.checkpoint import ClientCheckpointManager, FileStore

    return ClientCheckpointManager(FileStore(store_root), run).load(-1, step)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_client_checkpoint_resumes_across_packages(tmp_path, writer):
    """One package trains 3 steps (a checkpoint per step); the other
    resumes from step 2 in a copy without step 3, and must land on the
    writer's step-3 parameters, optimizer state and loader position."""
    from photon_tpu.centralized import run_centralized as jax_run
    from photon_tpu_torch.centralized import run_centralized as port_run

    jcfg = _central_cfg(tmp_path / "a")
    # the two packages seed their own inits differently: start both from
    # the JAX init, written as the step-0 checkpoint of the run
    runs = {"jax": lambda c: jax_run(c, total_steps=3),
            "port": lambda c: port_run(_port_cfg(c), total_steps=3, device="cpu")}
    first, second = runs[writer], runs["port" if writer == "jax" else "jax"]
    pcfg = _port_cfg(jcfg)
    meta, arrays = jax_to_ndarrays(jax_init(jcfg.model, seed=jcfg.seed))
    from photon_tpu_torch.checkpoint import ClientCheckpointManager, FileStore

    ClientCheckpointManager(FileStore(tmp_path / "a" / "store"), pcfg.run_uuid).save(
        -1, 0, meta, arrays, extra_state={"loader": {"epoch": 0, "sample_in_epoch": 0}})
    first(jcfg)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "store" / pcfg.run_uuid / "client_-1" / "ba3")
    jcfg_b = _central_cfg(tmp_path / "b")
    second(jcfg_b)
    pa, pb = (_params_at(tmp_path / d / "store", pcfg.run_uuid, 3) for d in "ab")
    assert pa[0].names == pb[0].names and pa[3] == pb[3]  # loader state and step
    for name, x, y in zip(pa[0].names, pa[1], pb[1]):
        _close(x, y, name, PARAM_REL)
    assert pa[2][0].names == pb[2][0].names
    for name, x, y in zip(pa[2][0].names, pa[2][1], pb[2][1]):
        _close(x, y, name)


def test_centralized_cli_on_cpu(tmp_path):
    sets = ["model.d_model=32", "model.n_layers=2", "model.n_heads=2", "model.max_seq_len=16",
            "model.vocab_size=64", "model.compute_dtype=float32", "train.global_batch_size=4",
            "train.device_microbatch_size=2", "train.eval_batches=1", "dataset.synthetic=true",
            f"photon.save_path={tmp_path}"]
    cmd = [sys.executable, "-m", "photon_tpu_torch.centralized", "--device", "cpu",
           "--steps", "3", "--eval-first", "--dump-params"]
    for s in sets:
        cmd += ["--set", s]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert '"eval_at": 0' in lines[0] and '"step": 3' in lines[-1]
    assert (tmp_path / "params_init.npz").exists() and (tmp_path / "params_final.npz").exists()
    assert (tmp_path / "store" / "dev" / "client_-1" / "ba3" / "state.bin").exists()


@pytest.mark.parametrize("feature", ["mesh", "ring", "auto_micro", "mesh_autotune", "lora"])
def test_unported_training_features_refused(feature):
    from photon_tpu_torch.config.schema import Config

    d = _jax_cfg("mpt-wpe").to_dict()
    if feature == "mesh":
        d["mesh"]["data"] = 2
    elif feature == "ring":
        d["model"]["attn_impl"] = "ring"
    elif feature == "auto_micro":  # auto is ported; an expert mesh under it is not
        d["train"]["device_microbatch_size"] = "auto"
        Config.from_dict(d).validate()
        d["mesh"]["expert"] = 2
    elif feature == "mesh_autotune":
        d["photon"]["mesh_autotune"] = True
    else:
        d["model"].update(lora_rank=4, lora_targets=["wqkv"])
    with pytest.raises(NotImplementedError):
        Config.from_dict(d).validate()
    if feature in ("mesh", "auto_micro", "mesh_autotune"):
        Config.from_dict(d).validate(serving=True)  # a server loads weights whatever trained them


# ---------------------------------------------------------------------------
# 8. device_microbatch_size: auto (tests/test_auto_microbatch.py)
# ---------------------------------------------------------------------------

def _auto_cfg(**train_kw):
    from photon_tpu_torch.config.schema import Config

    jcfg = _jax_cfg("mpt-wpe")
    d = jcfg.to_dict()
    d["train"].update({"global_batch_size": 4, "device_microbatch_size": "auto", **train_kw})
    return Config.from_dict(d).validate()


def _oom_above(real_make, limit, probed, error):
    """A ``make_train_step`` whose steps raise ``error`` for microbatches
    above ``limit`` (batch 4: ``n_microbatches`` 1 → 4, 2 → 2, 4 → 1)."""
    def fake_make(model, tx, n_microbatches=1, **kw):
        micro = 4 // n_microbatches
        probed.append(micro)
        if micro > limit:
            def boom(state, tokens):
                raise error
            return boom
        return real_make(model, tx, n_microbatches=n_microbatches, **kw)

    return fake_make


def test_auto_picks_largest_fitting_microbatch():
    """No memory pressure on the CPU: auto lands on the whole batch, as
    JAX's probe does."""
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_auto_cfg(), init_seed=0, device="cpu")
    assert trainer.device_microbatch_size == 4 and trainer._n_micro == 1
    jcfg = _jax_cfg("mpt-wpe")
    jcfg.train.global_batch_size, jcfg.train.device_microbatch_size = 4, "auto"
    assert JaxTrainer(jcfg.validate(), init_seed=0).device_microbatch_size == 4
    m = trainer.train_batch(_tokens(jcfg, 4))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("error", ["resource_exhausted", "cuda_oom"])
def test_auto_halves_on_oom(monkeypatch, error):
    """An OOM (JAX's phrasing, or ``torch.cuda.OutOfMemoryError``) for
    microbatches above 1 drives the probe down in powers of two; the probe
    leaves the parameters and the optimizer as it found them."""
    import photon_tpu_torch.train.trainer as trainer_mod
    from photon_tpu_torch.models.mpt import init_params

    err = (RuntimeError("RESOURCE_EXHAUSTED: Out of memory (simulated)")
           if error == "resource_exhausted" else torch.cuda.OutOfMemoryError("simulated"))
    probed = []
    monkeypatch.setattr(trainer_mod, "make_train_step",
                        _oom_above(trainer_mod.make_train_step, 1, probed, err))
    cfg = _auto_cfg()
    cfg.optimizer.name = "adamw"  # its first step moves every parameter
    trainer = trainer_mod.Trainer(cfg, init_seed=0, device="cpu")
    assert trainer.device_microbatch_size == 1 and trainer._n_micro == 4
    assert probed[:3] == [4, 2, 1]  # descending powers of two
    fresh = _port_flat(init_params(cfg.model, seed=0))
    assert all(np.array_equal(v, fresh[k]) for k, v in _port_flat(trainer.state.params).items())
    assert trainer.step == 0
    assert all(not t.any() for n, t in trainer.state.opt_state.items() if "count" not in n)


def test_auto_raises_when_nothing_fits(monkeypatch):
    import photon_tpu_torch.train.trainer as trainer_mod

    err = RuntimeError("RESOURCE_EXHAUSTED: Out of memory (simulated)")
    monkeypatch.setattr(trainer_mod, "make_train_step",
                        _oom_above(trainer_mod.make_train_step, 0, [], err))
    with pytest.raises(RuntimeError, match="even microbatch 1"):
        trainer_mod.Trainer(_auto_cfg(), init_seed=0, device="cpu")


def test_non_oom_probe_error_propagates(monkeypatch):
    import photon_tpu_torch.train.trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "make_train_step",
                        _oom_above(trainer_mod.make_train_step, 0, [],
                                   ValueError("a real bug, not OOM")))
    with pytest.raises(ValueError, match="real bug"):
        trainer_mod.Trainer(_auto_cfg(), init_seed=0, device="cpu")


def test_schema_rejects_bad_string():
    with pytest.raises(ValueError, match="auto"):
        _auto_cfg(device_microbatch_size="Auto")


def test_auto_microbatch_cap():
    """``train.auto_microbatch_cap`` bounds the first candidate, in both
    packages; batch 6 under a cap of 4 probes 4 (no: 6 % 4), then 2."""
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.train.trainer import Trainer

    t = Trainer(_auto_cfg(global_batch_size=6, auto_microbatch_cap=4), init_seed=0, device="cpu")
    assert t.device_microbatch_size == 2 and t._n_micro == 3
    jcfg = _jax_cfg("mpt-wpe")
    jcfg.train.global_batch_size, jcfg.train.device_microbatch_size = 6, "auto"
    jcfg.train.auto_microbatch_cap = 4
    assert JaxTrainer(jcfg.validate(), init_seed=0).device_microbatch_size == 2
