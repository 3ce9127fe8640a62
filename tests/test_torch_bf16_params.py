"""``model.param_dtype: bfloat16`` in the port against the JAX package.

The JAX package builds every leaf in ``param_dtype`` but the norms' scales
and biases, which stay fp32. The port builds the same tree
(``models/mpt.py::param_dtypes``), carries a bf16 leaf on the host as its
16-bit words with the metadata dtype ``"bfloat16"`` (``codec/params.py``),
writes it to an npz as the JAX package does (a ``'<V2'`` member over the
same bytes), and trains it with optax's dtype rules: AdamW's moments in
the parameter's dtype until an fp32 gradient (the sum of several
microbatches) promotes them, ADOPT's in fp32, every update rounded into
the parameter's dtype.

Tolerances (each beside what its planted fault reads, printed by the
cases that plant one):

- ``BF16_ULPS`` (12): with fp32 compute, every element of every parameter
  after each step, in bf16 ulps at its magnitude (floored at the tensor's
  RMS). torch and XLA round the same fp32 sums to bf16 and differ in the
  last bits of a matmul or of the fused AdamW arithmetic, so an element
  near a rounding boundary lands an ulp apart and later steps carry it:
  the sound runs read at most 6 (dense) and 10 (moe8, whose router
  weights a step's rounding), a schedule read one count late 83–562.
- ``PARAM_REL_L2`` (2e-2): every parameter's relative L2 distance, in
  every case. With bf16 compute the two packages' bf16 matmuls round
  differently, and Adam's sign-like first update turns a near-zero
  gradient's rounding into up to 42 ulps on about one element in a
  thousand; so does LoRA, whose A factors see a near-zero gradient while
  B is still near zero (22 ulps). The tensors read at most 8.4e-3, the
  late schedule 4.1e-2 (ADOPT) to 0.82 (AdamW).
- ``LOSS_REL`` and ``NORM_REL``: the step's loss and the grad norm (the
  norm of bf16 gradients: JAX sums their squares in bf16).
- The opt-state and parameter dtypes are compared exactly: a moment that
  missed its promotion, or a norm scale built in bf16, breaks them.

Where the JAX package cannot finish (a federated round, an npz holding
bf16 leaves, the pipeline over ``pipe``), each case shows JAX's failure
beside the port's refusal.
"""

import dataclasses
import io
import json
import pathlib
import subprocess
import sys
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

from photon_tpu.codec.params import params_to_ndarrays as jax_to_ndarrays
from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu.models.mpt import init_params as jax_init
from tests._helpers import tiny_llama_config
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

BF16_ULPS = 12.0
PARAM_REL_L2 = 2e-2
LOSS_REL = 2e-3
NORM_REL = 2e-2


def _jax_cfg(kind: str = "mpt", **opt) -> JaxConfig:
    if kind == "llama":
        cfg = tiny_llama_config(n_kv_heads=2)
    else:
        cfg = JaxConfig()
        m = cfg.model
        m.d_model, m.n_layers, m.n_heads, m.vocab_size, m.max_seq_len = 32, 2, 4, 96, 16
        m.attn_impl, m.compute_dtype = "xla", "float32"
        if kind == "moe8":
            m.mlp, m.moe_num_experts, m.moe_top_k = "moe", 8, 2
        if kind == "lora":
            m.lora_rank, m.lora_alpha, m.lora_targets = 4, 8.0, ("wqkv", "down_proj")
        if kind == "layernorm_bias":
            m.no_bias = False
    cfg.model.param_dtype = "bfloat16"
    cfg.train.global_batch_size, cfg.train.device_microbatch_size = 4, 4
    cfg.optimizer.name, cfg.optimizer.lr = "adamw", 1e-2
    for k, v in opt.items():
        setattr(cfg.optimizer, k, v)
    cfg.scheduler.t_warmup, cfg.scheduler.t_max = 2, 20
    return cfg.validate()


def _port_cfg(jcfg: JaxConfig):
    from photon_tpu_torch.config.schema import Config

    return Config.from_dict(jcfg.to_dict()).validate()


def _weights(jcfg, pcfg, seed=0):
    """(JAX params, the port's tree holding the same bits)."""
    from photon_tpu_torch.codec.params import params_from_numpy

    jp = jax_init(jcfg.model, seed=seed)
    meta, arrays = jax_to_ndarrays(jp)
    return jp, params_from_numpy(meta.names, arrays, pcfg.model, "cpu")


def _tokens(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.model.vocab_size, (n, cfg.model.max_seq_len)).astype(np.int32)


def _bits(a: np.ndarray) -> np.ndarray:
    """The 16-bit words of a bf16 leaf, from either package's host form."""
    return np.asarray(a).view(np.uint16)


def _ulps(got: np.ndarray, want: np.ndarray, dtype: str) -> float:
    """The largest |got - want| in bf16 ulps at ``want``'s magnitude, that
    magnitude floored at the tensor's RMS (an element near zero moves by
    the update's rounding, not by its own tiny ulp). fp32 leaves (the
    norms) are read in bf16 ulps too: their drift comes from the bf16
    leaves around them."""
    got, want = _as_f64(got, dtype), _as_f64(want, dtype)
    if not got.size:
        return 0.0
    mag = np.maximum(np.abs(want), np.sqrt(np.mean(want ** 2)))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return float(np.max(np.abs(got - want) / ulp))


def _as_f64(a: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":
        return _bits(a).view(ml_dtypes.bfloat16).astype(np.float64)
    return np.asarray(a, np.float64)


# ---------------------------------------------------------------------------
# the tree, the codec and the npz
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mpt", "llama", "moe8", "lora", "layernorm_bias"])
def test_tree_matches_jax(kind):
    """Names, shapes and dtype strings equal JAX's; the norms alone are
    fp32. The port's bf16 tree is its fp32 tree of the same seed rounded."""
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.models.mpt import init_params

    jcfg = _jax_cfg(kind)
    pcfg = _port_cfg(jcfg)
    jmeta, _ = jax_to_ndarrays(jax_init(jcfg.model, seed=0))
    pmeta, parrays = params_to_ndarrays(init_params(pcfg.model, seed=0))
    assert pmeta.names == jmeta.names and pmeta.shapes == jmeta.shapes
    assert pmeta.dtypes == jmeta.dtypes
    fp32 = {n for n, d in zip(jmeta.names, jmeta.dtypes) if d == "float32"}
    assert fp32 == {n for n in jmeta.names if "/ln_" in "/" + n}
    assert set(jmeta.dtypes) == {"bfloat16", "float32"}
    pcfg.model.param_dtype = "float32"
    _, wide = params_to_ndarrays(init_params(pcfg.model, seed=0))
    for d, a, w in zip(pmeta.dtypes, parrays, wide):
        want = w.astype(ml_dtypes.bfloat16).view(np.uint16) if d == "bfloat16" else w
        np.testing.assert_array_equal(a, want)


def test_a_bf16_norm_scale_breaks_the_dtype_map(monkeypatch):
    """The planted fault of the dtype gates: the norms built in
    ``param_dtype`` too."""
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.models import mpt

    jcfg = _jax_cfg()
    jmeta, _ = jax_to_ndarrays(jax_init(jcfg.model, seed=0))
    monkeypatch.setattr(mpt, "is_norm_param", lambda name: False)
    pmeta, _ = params_to_ndarrays(mpt.init_params(_port_cfg(jcfg).model, seed=0))
    assert pmeta.dtypes != jmeta.dtypes


def test_codec_bits_and_npz_members_match_jax():
    """JAX's bf16 weights through the port's codec come back bit for bit,
    the metadata says ``bfloat16`` with itemsize 2, and each npz member's
    ``.npy`` bytes equal JAX's; both packages read such a member back as a
    ``|V2`` array."""
    from photon_tpu.checkpoint.serialization import arrays_to_npz as jax_npz
    from photon_tpu.checkpoint.serialization import npz_to_arrays as jax_from_npz
    from photon_tpu_torch.checkpoint.serialization import arrays_to_npz, npz_to_arrays
    from photon_tpu_torch.codec.params import ParamsMetadata, params_to_ndarrays

    jcfg = _jax_cfg("llama")
    pcfg = _port_cfg(jcfg)
    jp, tp = _weights(jcfg, pcfg)
    jmeta, jarrays = jax_to_ndarrays(jp)
    pmeta, parrays = params_to_ndarrays(tp)
    assert (pmeta.names, pmeta.shapes, pmeta.dtypes) == (jmeta.names, jmeta.shapes, jmeta.dtypes)
    assert pmeta.nbytes_each == jmeta.nbytes_each and pmeta.total_bytes == jmeta.total_bytes
    for d, a, b in zip(pmeta.dtypes, parrays, jarrays):
        if d == "bfloat16":
            assert a.dtype == np.uint16
            np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            np.testing.assert_array_equal(a, b)
    pmeta.validate_arrays(jarrays)  # JAX's ml_dtypes arrays are bf16 leaves too
    jmeta.validate_arrays([a.view(ml_dtypes.bfloat16) if d == "bfloat16" else a
                           for d, a in zip(pmeta.dtypes, parrays)])
    with pytest.raises(ValueError, match="expected"):  # a widened leaf is not one
        pmeta.validate_arrays([a.astype(np.float32) for a in parrays])
    mine, theirs = (zipfile.ZipFile(io.BytesIO(b)) for b in
                    (arrays_to_npz(pmeta, parrays), jax_npz(jmeta, jarrays)))
    assert mine.namelist() == theirs.namelist()
    for member in theirs.namelist():
        assert mine.read(member) == theirs.read(member), member
    pm, _ = npz_to_arrays(arrays_to_npz(pmeta, parrays))
    jm, _ = jax_from_npz(jax_npz(jmeta, jarrays))
    assert (pm.names, pm.dtypes) == (jm.names, jm.dtypes) and "|V2" in pm.dtypes
    roundtrip = ParamsMetadata.from_json(pmeta.to_json())
    assert roundtrip == pmeta


# ---------------------------------------------------------------------------
# training: 3 steps against the JAX Trainer
# ---------------------------------------------------------------------------

TRAIN_CASES = {
    # name: (config kind, optimizer overrides, microbatch, compute dtype)
    "adamw_micro1": ("mpt", {}, 4, "float32"),
    "adamw_micro2": ("mpt", {}, 2, "float32"),
    "adamw_wd_bf16_compute": ("llama", {"weight_decay": 0.1}, 4, "bfloat16"),
    "adopt": ("mpt", {"name": "adopt"}, 4, "float32"),
    "adopt_micro2": ("mpt", {"name": "adopt"}, 2, "float32"),
    "adamw_lora": ("lora", {}, 4, "float32"),
    "adamw_moe8": ("moe8", {}, 4, "float32"),
}
#: the paths besides one device that the JAX package finishes in bf16:
#: (mesh axes, config kind, train overrides, photon overrides)
MESH_CASES = {
    "fsdp2_tensor2": (dict(fsdp=2, tensor=2), "mpt", {}, {}),
    "sequence2_ring": (dict(sequence=2), "llama", {}, {}),
    "expert2_moe": (dict(expert=2), "moe8", {}, {}),
    "auto_microbatch": ({}, "mpt", {"device_microbatch_size": "auto"}, {}),
}


def _dtypes(state: dict) -> dict:
    return {n: str(np.asarray(a).dtype) for n, a in state.items()}


def _run_pair(case, fault=None):
    """3 steps of the JAX and the port Trainer from the same bf16 weights
    and batches; per step the metrics, the parameters and the opt-state
    dtypes of both."""
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.train.trainer import Trainer

    if case in MESH_CASES:
        mesh, kind, train, photon = MESH_CASES[case]
        jcfg = _jax_cfg(kind)
        for k, v in mesh.items():
            setattr(jcfg.mesh, k, v)
        for k, v in train.items():
            setattr(jcfg.train, k, v)
        for k, v in photon.items():
            setattr(jcfg.photon, k, v)
    else:
        kind, opt, micro, compute = TRAIN_CASES[case]
        jcfg = _jax_cfg(kind, **opt)
        jcfg.train.device_microbatch_size = micro
        jcfg.model.compute_dtype = compute
    jcfg.validate()
    pcfg = _port_cfg(jcfg)
    jp, tp = _weights(jcfg, pcfg)
    jt = JaxTrainer(dataclasses.replace(jcfg), params=jp)
    pt = Trainer(pcfg, params=tp, device="cpu")
    if fault is not None:
        fault(pt)
    out = []
    for s in range(3):
        batch = _tokens(jcfg, 4, seed=s)
        jm, pm = jt.fit([batch], 1), pt.fit([batch], 1)
        jmeta, jarr = jt.get_parameters()
        pmeta, parr = pt.get_parameters()
        jom, _ = jt.get_opt_state_arrays()
        pom, _ = pt.get_opt_state_arrays()
        out.append({"jm": jm, "pm": pm, "jparams": (jmeta, jarr), "pparams": (pmeta, parr),
                    "jopt": dict(zip(jom.names, jom.dtypes)),
                    "popt": dict(zip(pom.names, pom.dtypes))})
    return out


def _worst_ulps(step) -> float:
    (jmeta, jarr), (_, parr) = step["jparams"], step["pparams"]
    return max(_ulps(p, j, d) for d, p, j in zip(jmeta.dtypes, parr, jarr))


def _worst_rel(step) -> float:
    (jmeta, jarr), (_, parr) = step["jparams"], step["pparams"]
    out = 0.0
    for d, p, j in zip(jmeta.dtypes, parr, jarr):
        p, j = _as_f64(p, d), _as_f64(j, d)
        out = max(out, float(np.linalg.norm(p - j) / max(np.linalg.norm(j), 1e-30)))
    return out


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_trainer_matches_jax(case):
    """Loss, grad norm, every parameter (``BF16_ULPS``) and every
    opt-state dtype after each of 3 steps; at 2 microbatches the AdamW
    moments are fp32 from step 1 on, at 1 they stay bf16, ADOPT's are fp32
    throughout, and the parameters stay bf16."""
    steps = _run_pair(case)
    opt = TRAIN_CASES[case][1].get("name", "adamw")
    micro = TRAIN_CASES[case][2]
    for i, st in enumerate(steps):
        jm, pm = st["jm"], st["pm"]
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=LOSS_REL, err_msg=f"step {i}")
        if TRAIN_CASES[case][0] != "lora":  # under LoRA the port counts the factors alone
            np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=NORM_REL,
                                       err_msg=f"step {i}")
        pmeta, jmeta = st["pparams"][0], st["jparams"][0]
        assert (pmeta.names, pmeta.shapes, pmeta.dtypes) == (jmeta.names, jmeta.shapes,
                                                             jmeta.dtypes)
        assert set(st["pparams"][0].dtypes) == {"bfloat16", "float32"}
        assert st["popt"] == st["jopt"], f"step {i}"
        assert _worst_rel(st) <= PARAM_REL_L2, (f"step {i}", _worst_rel(st))
        if TRAIN_CASES[case][3] == "float32" and TRAIN_CASES[case][0] != "lora":
            assert _worst_ulps(st) <= BF16_ULPS, (f"step {i}", _worst_ulps(st))
        moments = {d for n, d in st["popt"].items() if not n.endswith(".count")
                   and "/ln_" not in n}
        if opt == "adamw" and micro == 4:
            assert moments == {"bfloat16"}
        else:
            assert moments == {"float32"}


def test_planted_faults_read_over_the_tolerances(monkeypatch):
    """A schedule read one count late moves the parameters by many more
    ulps than ``BF16_ULPS``; AdamW moments that skip their fp32 promotion
    at 2 microbatches break the opt-state dtype gate."""
    def late_schedule(trainer):
        sound = trainer.tx.schedule
        trainer.tx.schedule = lambda count: sound(count + 1)

    late = _run_pair("adamw_micro1", late_schedule)
    worst = max(_worst_ulps(st) for st in late)
    print(f"late schedule: {worst:.1f} bf16 ulps (tolerance {BF16_ULPS})")
    assert worst > 4 * BF16_ULPS
    rel = min(max(_worst_rel(st) for st in _run_pair(c, late_schedule))
              for c in ("adamw_micro1", "adopt"))
    print(f"late schedule: relative L2 {rel:.3e} (tolerance {PARAM_REL_L2})")
    assert rel > PARAM_REL_L2

    monkeypatch.setattr(torch, "promote_types", lambda a, b: a)  # the moments keep bf16
    kept = _run_pair("adamw_micro2")
    assert any(st["popt"] != st["jopt"] for st in kept)


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_meshed_and_tuned_trainers_match_jax(case):
    """The mesh paths the JAX package finishes in bf16 (on conftest's fake
    CPU devices; the port's mesh repeats the CPU) and the ``auto`` probe:
    loss, grad norm, parameters and the opt-state dtypes after each of 3
    steps. On a mesh the two packages sum partial products in different
    orders (GSPMD's collectives against the port's loop over positions,
    the ring's chunk merges), so more elements cross a bf16 rounding
    boundary (up to 66 ulps on the ring at step 2): there the parameters
    are held to ``PARAM_REL_L2`` alone."""
    for i, st in enumerate(_run_pair(case)):
        jm, pm = st["jm"], st["pm"]
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=LOSS_REL, err_msg=f"step {i}")
        np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=NORM_REL,
                                   err_msg=f"step {i}")
        pmeta, jmeta = st["pparams"][0], st["jparams"][0]
        assert (pmeta.names, pmeta.dtypes) == (jmeta.names, jmeta.dtypes)
        assert st["popt"] == st["jopt"], f"step {i}"
        assert _worst_rel(st) <= PARAM_REL_L2, (f"step {i}", _worst_rel(st))
        if not MESH_CASES[case][0]:
            assert _worst_ulps(st) <= BF16_ULPS, (f"step {i}", _worst_ulps(st))


def test_autotuner_refuses_a_pipe_layout_where_jax_aborts():
    """On 8 devices the autotuner (JAX's rankings) picks ``data 4 × pipe
    2`` for this model, and JAX's Trainer then aborts in XLA (the pipeline
    case below shows the abort); the port's Trainer refuses that layout.
    On one device it picks ``1×1×1×1`` and trains bit for bit as the
    Trainer without the tuner."""
    from photon_tpu.parallel.autotune import autotune_layout as jax_autotune
    from photon_tpu_torch.train.trainer import Trainer

    jcfg = _jax_cfg()
    jcfg.photon.mesh_autotune = True
    jcfg.validate()
    import jax

    picked = jax_autotune(jcfg.model, devices=jax.local_devices(), global_batch_size=4,
                          microbatch=4).mesh
    assert picked.pipe > 1
    with pytest.raises(NotImplementedError, match="mesh.pipe > 1 is refused"):
        Trainer(_port_cfg(jcfg), device="cpu", n_devices=len(jax.local_devices()))
    tuned = Trainer(_port_cfg(jcfg), device="cpu", init_seed=0)
    assert tuned.mesh is None and tuned.layout_autotune["mesh"].size == 1
    plain_cfg = _port_cfg(jcfg)
    plain_cfg.photon.mesh_autotune = False
    plain = Trainer(plain_cfg, device="cpu", init_seed=0)
    batch = _tokens(jcfg, 4)
    for t in (tuned, plain):
        t.fit([batch, batch], 2)
    for a, b in zip(tuned.get_parameters()[1], plain.get_parameters()[1]):
        assert a.tobytes() == b.tobytes()


def test_engine_on_a_bf16_tree_matches_jax():
    """The serving engine built on a bf16 tree (the JAX package serves
    one): greedy completions equal the JAX engine's on the same weights."""
    from photon_tpu.serve.engine import PagedEngine as JaxEngine
    from photon_tpu_torch.serve.engine import PagedEngine
    from tests.test_torch_serve import _drive, _prompts
    from tests.test_torch_serve import _jax_cfg as serve_cfg

    jcfg = serve_cfg("mpt-wpe")
    jcfg.model.param_dtype = "bfloat16"
    jcfg.validate()
    pcfg = _port_cfg(jcfg)
    jp, tp = _weights(jcfg, pcfg)
    prompts = _prompts(4, 5, jcfg.model.vocab_size)
    ref = _drive(JaxEngine(jcfg, jp), prompts, 6, 4)
    eng = PagedEngine(pcfg, tp, device="cpu")
    assert _drive(eng, prompts, 6, 4) == ref


# ---------------------------------------------------------------------------
# where the JAX package cannot finish: its failure beside the port's refusal
# ---------------------------------------------------------------------------

def test_federated_round_refused_where_jax_fails_at_the_broadcast(tmp_path):
    """JAX's strategy keeps the server's parameters fp32, so each client
    rejects the first broadcast and the round stops
    (``photon_tpu/federation/server.py:310``). The port refuses every
    driver up front: the config's collective, async and adapter rounds at
    ``validate()``, the in-process, multiprocess and TCP drivers in
    ``ServerApp``, a node's runtime in ``ClientRuntime``."""
    from photon_tpu_torch import federated
    from photon_tpu_torch.config.schema import Config
    from tests.test_federation import make_app, make_cfg

    jcfg = make_cfg(tmp_path / "jax", n_rounds=1)
    jcfg.model.param_dtype = "bfloat16"
    jcfg.validate()
    app = make_app(jcfg, tmp_path / "jax")
    with pytest.raises(RuntimeError, match="broadcast failed.*expected.*bfloat16, got.*float32"):
        app.run()
    app.driver.shutdown()

    d = jcfg.to_dict()
    Config.from_dict(d).validate()  # a centralized run of this config trains
    for path in (("comm_stack", "collective"), ("async_rounds", "enabled"),
                 ("adapters", "enabled")):
        bad = json.loads(json.dumps(d))
        bad["photon"][path[0]][path[1]] = True
        if path[0] == "async_rounds":
            bad["photon"]["comm_stack"]["collective"] = True
        if path[0] == "adapters":
            bad["photon"]["adapters"]["cohorts"] = {"a": [0, 1]}
        with pytest.raises(NotImplementedError, match="bfloat16.*refused"):
            Config.from_dict(bad).validate()
    cfg = Config.from_dict(d).validate()
    with pytest.raises(NotImplementedError, match="federated round is refused"):
        federated.build_app(cfg, device="cpu")
    from photon_tpu_torch.federation import ClientRuntime, ParamTransport

    with pytest.raises(NotImplementedError, match="refused"):
        ClientRuntime(cfg, ParamTransport("inline"), device="cpu")


def test_npz_of_bf16_leaves_refused_where_jax_cannot_load_it(tmp_path):
    """Both packages save a bf16 tree to an npz; neither loads it back: JAX
    raises on the ``|V2`` member, the port's Trainer and its centralized
    resume raise ``Bf16NpzError``. The dump itself works."""
    from photon_tpu.checkpoint.serialization import arrays_to_npz as jax_npz
    from photon_tpu.checkpoint.serialization import npz_to_arrays as jax_from_npz
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch import centralized
    from photon_tpu_torch.checkpoint.serialization import arrays_to_npz, npz_to_arrays
    from photon_tpu_torch.codec.params import Bf16NpzError
    from photon_tpu_torch.train.trainer import Trainer

    jcfg = _jax_cfg()
    jt = JaxTrainer(dataclasses.replace(jcfg))
    with pytest.raises(TypeError, match=r"\|V2"):
        jt.set_parameters(*jax_from_npz(jax_npz(*jt.get_parameters())))
    pt = Trainer(_port_cfg(jcfg), device="cpu")
    with pytest.raises(Bf16NpzError, match="JAX package"):
        pt.set_parameters(*npz_to_arrays(arrays_to_npz(*pt.get_parameters())))

    save = tmp_path / "run"
    args = ["--device", "cpu", "--dump-params", "--set", "dataset.synthetic=true",
            "--set", f"photon.save_path={save}", "--set", "model.param_dtype=bfloat16",
            "--set", "model.d_model=32", "--set", "model.n_layers=2", "--set",
            "model.n_heads=2", "--set", "model.max_seq_len=16", "--set", "model.vocab_size=64",
            "--set", "train.global_batch_size=4", "--set", "train.device_microbatch_size=4"]
    centralized.main(["--steps", "2"] + args)
    meta, arrays = npz_to_arrays((save / "params_final.npz").read_bytes())
    assert "|V2" in meta.dtypes and "float32" in meta.dtypes
    with pytest.raises(Bf16NpzError):
        centralized.main(["--steps", "3"] + args)


def test_pipeline_refused_where_jax_aborts():
    """JAX's pipelined step aborts in XLA's compiler with bf16 parameters
    (a CHECK failure, so it runs in a child); the port refuses ``pipe > 1``
    with bf16 at ``validate()``, and trains it in fp32."""
    script = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from photon_tpu.utils.compat import set_cpu_device_count; set_cpu_device_count(2)\n"
        "import numpy as np\n"
        "from photon_tpu.config.schema import Config\n"
        "from photon_tpu.train.trainer import Trainer\n"
        f"cfg = Config.from_dict({_pipe_cfg().to_dict()!r}).validate()\n"
        "t = Trainer(cfg)\n"
        "t.fit([np.zeros((4, 16), np.int32)], 1)\n"
        "print('TRAINED')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=str(pathlib.Path(__file__).resolve().parent.parent))
    assert proc.returncode != 0 and "TRAINED" not in proc.stdout
    assert "hlo_instruction.cc" in proc.stderr, proc.stderr[-2000:]
    with pytest.raises(NotImplementedError, match="mesh.pipe > 1 is refused"):
        _port_cfg(_pipe_cfg())
    fp32 = _pipe_cfg()
    fp32.model.param_dtype = "float32"
    _port_cfg(fp32)


def _pipe_cfg() -> JaxConfig:
    cfg = _jax_cfg()
    cfg.mesh.pipe = 2
    cfg.train.device_microbatch_size = 2
    return cfg.validate()
