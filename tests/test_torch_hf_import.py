"""``photon_tpu_torch.checkpoint.hf_import`` against
``photon_tpu.checkpoint.hf_import``: one case for each case of
``tests/test_hf_import.py``, plus the port's own safetensors reader.

The port's export imports back bit for bit; checkpoints written by
``transformers`` itself (``save_pretrained``: safetensors, one file or
sharded under an index) import to the JAX importer's tree bit for bit and
give HF's logits in the port's model (2e-4, the JAX test's tolerance).

bf16 safetensors (how most public llamas ship): the JAX importer reads
them through ``safetensors.numpy``, which holds a bf16 tensor only where
``ml_dtypes`` has given numpy a bfloat16 (importing JAX does that, so the
JAX importer reads them); in a process without it ``load_file`` raises.
The port imports neither JAX nor ``ml_dtypes``; its stdlib reader widens
bf16 to fp32 exactly (``test_bf16_safetensors_imports_without_ml_dtypes``).
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from photon_tpu.codec.params import flatten_params
from photon_tpu.codec.params import params_to_ndarrays as jax_to_ndarrays
from photon_tpu.models.mpt import init_params as jax_init

from tests._helpers import tiny_llama_config
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")


def _port_params(jcfg, seed: int):
    from photon_tpu_torch.codec.params import params_from_numpy
    from photon_tpu_torch.config.schema import Config

    pcfg = Config.from_dict(jcfg.to_dict()).validate("cpu")
    meta, arrays = jax_to_ndarrays(jax_init(jcfg.model, seed=seed))
    return params_from_numpy(meta.names, arrays, pcfg.model, "cpu"), pcfg


def _flat_port(params) -> dict:
    from photon_tpu_torch.codec.params import flatten

    return {k: v.numpy() for k, v in flatten(params).items()}


def _flat_jax(params) -> dict:
    names, leaves = flatten_params(params)
    return {k: np.asarray(v) for k, v in zip(names, leaves)}


def assert_trees_bit_equal(got: dict, want: dict) -> None:
    """Flat name → array: the same names in the same order, dtypes, shapes
    and bytes."""
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _port_logits(cfg, params, tokens) -> np.ndarray:
    from photon_tpu_torch.models.mpt import MPTModel

    with torch.no_grad():
        return MPTModel(cfg)(params, torch.from_numpy(tokens.astype(np.int64))).numpy()


def _llama_hf_config(**kw):
    base = dict(hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=16, vocab_size=96,
                attention_bias=False, mlp_bias=False, tie_word_embeddings=False)
    return transformers.LlamaConfig(**{**base, **kw})


@pytest.mark.parametrize("n_kv", [0, 2], ids=["mha", "gqa"])
def test_export_import_roundtrip_bit_identical(tmp_path, n_kv):
    from photon_tpu.checkpoint.hf_import import load_hf_llama as jax_load
    from photon_tpu_torch.checkpoint.hf_export import save_hf_llama
    from photon_tpu_torch.checkpoint.hf_import import load_hf_llama

    params, pcfg = _port_params(tiny_llama_config(n_kv), seed=5)
    out = save_hf_llama(params, pcfg.model, str(tmp_path / "hf"))
    derived, imported = load_hf_llama(str(out))
    assert derived.n_kv_heads == pcfg.model.n_kv_heads
    assert derived.mlp_hidden_size == 48 and derived.rope
    assert_trees_bit_equal(_flat_port(imported), _flat_port(params))
    # the JAX importer reads the port's export to the same tree
    jax_derived, jax_imported = jax_load(str(out))
    assert_trees_bit_equal(_flat_port(imported), _flat_jax(jax_imported))
    assert {f: getattr(derived, f) for f in ("n_kv_heads", "mlp_hidden_size", "norm_eps")} == \
        {f: getattr(jax_derived, f) for f in ("n_kv_heads", "mlp_hidden_size", "norm_eps")}


def test_mixtral_export_import_roundtrip_bit_identical(tmp_path):
    from photon_tpu_torch.checkpoint.hf_export import save_hf_mixtral
    from photon_tpu_torch.checkpoint.hf_import import load_hf_llama

    jcfg = tiny_llama_config(2)
    jcfg.model.mlp = "moe"
    jcfg.model.moe_mlp_act = "swiglu"
    jcfg.model.moe_num_experts = 4
    jcfg.model.moe_top_k = 2
    jcfg.validate()
    params, pcfg = _port_params(jcfg, seed=5)
    with pytest.warns(UserWarning, match="capacity"):  # the default factor drops
        out = save_hf_mixtral(params, pcfg.model, str(tmp_path / "hf"))
    derived, imported = load_hf_llama(str(out))
    assert derived.mlp == "moe" and derived.moe_mlp_act == "swiglu"
    assert derived.moe_num_experts == 4 and derived.moe_top_k == 2
    assert derived.moe_capacity_factor == 2.0  # E/k: drop-free like HF
    assert_trees_bit_equal(_flat_port(imported), _flat_port(params))


def test_mixtral_import_from_transformers_save_pretrained(tmp_path):
    """A checkpoint written by transformers' MixtralForCausalLM: the JAX
    importer's tree, and HF's logits in the port's model."""
    from photon_tpu.checkpoint.hf_import import load_hf_llama as jax_load
    from photon_tpu_torch.checkpoint.hf_import import load_hf_llama

    hf_cfg = transformers.MixtralConfig(
        vocab_size=96, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=16, rms_norm_eps=1e-5, rope_theta=10000.0,
        num_local_experts=4, num_experts_per_tok=2,
        tie_word_embeddings=False, torch_dtype="float32",
    )
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(hf_cfg)
    hf.eval()
    hf.save_pretrained(str(tmp_path / "hf"))

    derived, params = load_hf_llama(str(tmp_path / "hf"))
    assert_trees_bit_equal(_flat_port(params), _flat_jax(jax_load(str(tmp_path / "hf"))[1]))
    derived.attn_impl, derived.compute_dtype = "xla", "float32"
    tokens = np.random.default_rng(0).integers(0, 96, (2, 12), dtype=np.int32)
    with torch.no_grad():
        theirs = hf(torch.from_numpy(tokens.astype(np.int64))).logits.numpy()
    np.testing.assert_allclose(_port_logits(derived, params, tokens), theirs,
                               atol=2e-4, rtol=2e-4)


def test_import_from_transformers_save_pretrained(tmp_path):
    """A llama written by transformers (one safetensors file): the JAX
    importer's tree, and HF's logits in the port's model."""
    from photon_tpu.checkpoint.hf_import import load_hf_llama as jax_load
    from photon_tpu_torch.checkpoint.hf_import import load_hf_llama

    hf = transformers.LlamaForCausalLM(_llama_hf_config(
        num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-5, torch_dtype="float32"))
    hf.eval()
    hf.save_pretrained(str(tmp_path / "hf"))
    assert (tmp_path / "hf" / "model.safetensors").exists()

    model_cfg, params = load_hf_llama(str(tmp_path / "hf"))
    assert_trees_bit_equal(_flat_port(params), _flat_jax(jax_load(str(tmp_path / "hf"))[1]))
    model_cfg.attn_impl, model_cfg.compute_dtype = "xla", "float32"
    tokens = np.random.default_rng(1).integers(0, 96, (2, 12), dtype=np.int32)
    with torch.no_grad():
        theirs = hf(torch.from_numpy(tokens.astype(np.int64))).logits.numpy()
    np.testing.assert_allclose(_port_logits(model_cfg, params, tokens), theirs,
                               atol=2e-4, rtol=2e-4)


def test_import_sharded_safetensors(tmp_path):
    """Shards under ``model.safetensors.index.json`` (how large public
    llamas ship) merge to the JAX importer's tree."""
    from photon_tpu.checkpoint.hf_import import load_hf_llama as jax_load
    from photon_tpu_torch.checkpoint.hf_import import load_hf_llama

    hf = transformers.LlamaForCausalLM(_llama_hf_config())
    hf.save_pretrained(str(tmp_path / "hf"), max_shard_size="20KB")
    index = tmp_path / "hf" / "model.safetensors.index.json"
    assert index.exists(), "test setup: the shard size did not force an index"
    assert len(set(json.loads(index.read_text())["weight_map"].values())) > 1

    model_cfg, params = load_hf_llama(str(tmp_path / "hf"))
    np.testing.assert_array_equal(params["wte"]["embedding"].numpy(),
                                  hf.model.embed_tokens.weight.detach().numpy())
    assert model_cfg.n_layers == 2
    assert_trees_bit_equal(_flat_port(params), _flat_jax(jax_load(str(tmp_path / "hf"))[1]))


def test_import_cli_writes_npz_and_yaml(tmp_path):
    """The CLI's npz holds the JAX CLI's arrays; its model YAML loads in
    the JAX package with the JAX CLI's model section."""
    from photon_tpu.checkpoint import npz_to_arrays as jax_npz_to_arrays
    from photon_tpu.checkpoint.hf_import import main as jax_main
    from photon_tpu.config.schema import Config as JaxConfig
    from photon_tpu_torch.checkpoint.hf_export import save_hf_llama
    from photon_tpu_torch.checkpoint.hf_import import main
    from photon_tpu_torch.checkpoint.serialization import npz_to_arrays

    params, pcfg = _port_params(tiny_llama_config(), seed=2)
    save_hf_llama(params, pcfg.model, str(tmp_path / "hf"))
    out, jax_out = tmp_path / "imported.npz", tmp_path / "jax" / "imported.npz"
    jax_out.parent.mkdir()
    main(["--hf-dir", str(tmp_path / "hf"), "--out", str(out)])
    jax_main(["--hf-dir", str(tmp_path / "hf"), "--out", str(jax_out)])
    meta, arrays = npz_to_arrays(out.read_bytes())
    jax_meta, jax_arrays = jax_npz_to_arrays(jax_out.read_bytes())
    assert len(meta.names) == 10  # MHA: fused wqkv (GQA would be 12)
    assert meta.names == jax_meta.names and meta.dtypes == jax_meta.dtypes
    assert all(a.tobytes() == b.tobytes() for a, b in zip(arrays, jax_arrays))
    assert (tmp_path / "imported.model.yaml").exists()
    assert JaxConfig.from_yaml(str(tmp_path / "imported.model.yaml")).model == \
        JaxConfig.from_yaml(str(tmp_path / "jax" / "imported.model.yaml")).model


def test_import_rejects_mismatched_config(tmp_path):
    from photon_tpu.checkpoint.hf_import import load_hf_llama as jax_load
    from photon_tpu_torch.checkpoint.hf_export import save_hf_llama
    from photon_tpu_torch.checkpoint.hf_import import load_hf_llama

    params, pcfg = _port_params(tiny_llama_config(), seed=0)
    save_hf_llama(params, pcfg.model, str(tmp_path / "hf"))
    wrong = tiny_llama_config()
    wrong.model.n_layers = 3
    port_wrong = _port_params(wrong, seed=0)[1]
    with pytest.raises(ValueError, match="config mismatch") as ours:
        load_hf_llama(str(tmp_path / "hf"), port_wrong.model)
    with pytest.raises(ValueError) as theirs:
        jax_load(str(tmp_path / "hf"), wrong.model)
    assert str(ours.value) == str(theirs.value)


def test_import_rejects_tied_and_biased(tmp_path):
    from photon_tpu.checkpoint.hf_import import model_config_from_hf as jax_from_hf
    from photon_tpu_torch.checkpoint.hf_import import model_config_from_hf

    base = dict(model_type="llama", hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=16,
                vocab_size=96, intermediate_size=48)
    mixtral = {**base, "model_type": "mixtral", "num_local_experts": 4}
    for bad, match in (({**base, "tie_word_embeddings": True}, "tied"),
                       ({**base, "attention_bias": True}, "biased"),
                       ({**base, "model_type": "mistral"}, "model_type"),
                       ({**base, "rope_scaling": {"rope_type": "llama3", "factor": 8.0}},
                        "rope_scaling"),
                       ({**base, "head_dim": 16}, "head_dim"),
                       ({**mixtral, "sliding_window": 4096}, "sliding_window")):
        with pytest.raises(ValueError, match=match) as ours:
            model_config_from_hf(bad)
        with pytest.raises(ValueError) as theirs:
            jax_from_hf(bad)
        assert str(ours.value) == str(theirs.value)


def test_import_threads_norm_eps():
    """``rms_norm_eps`` reaches the model config instead of a fixed 1e-5."""
    from photon_tpu.checkpoint.hf_import import model_config_from_hf as jax_from_hf
    from photon_tpu_torch.checkpoint.hf_import import model_config_from_hf

    hf = dict(model_type="llama", hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, max_position_embeddings=16,
              vocab_size=96, intermediate_size=48, rms_norm_eps=1e-6)
    m = model_config_from_hf(hf)
    assert m.norm_eps == pytest.approx(1e-6)
    theirs = jax_from_hf(hf)
    for f in ("norm_eps", "d_model", "n_layers", "n_heads", "n_kv_heads", "mlp_hidden_size",
              "rope", "rope_theta", "norm", "mlp", "tie_embeddings", "learned_pos_emb",
              "max_seq_len", "vocab_size", "name"):
        assert getattr(m, f) == getattr(theirs, f), f


def test_bf16_safetensors_imports_without_ml_dtypes(tmp_path):
    """A bf16 checkpoint: ``safetensors.numpy`` raises on it in a process
    without ``ml_dtypes`` (the port's: it imports no JAX), the port's
    reader in such a process equals torch's bf16 values widened to fp32,
    and both packages' importers give the same tree."""
    from photon_tpu.checkpoint.hf_import import load_hf_llama as jax_load
    from photon_tpu_torch.checkpoint.hf_import import _load_state_dict, load_hf_llama

    hf = transformers.LlamaForCausalLM(_llama_hf_config(num_key_value_heads=2))
    hf.to(torch.bfloat16).save_pretrained(str(tmp_path / "hf"))
    st = tmp_path / "hf" / "model.safetensors"
    want = safetensors_torch.load_file(str(st))
    assert all(v.dtype == torch.bfloat16 for v in want.values())

    def fresh(code: str) -> subprocess.CompletedProcess:
        return subprocess.run([sys.executable, "-c", code, str(st)], capture_output=True,
                              text=True, timeout=120, cwd=pathlib.Path(__file__).parent.parent)

    r = fresh("import sys\nfrom safetensors.numpy import load_file\n"
              "assert 'ml_dtypes' not in sys.modules\nload_file(sys.argv[1])")
    assert r.returncode != 0 and "TypeError" in r.stderr and "bfloat16" in r.stderr, r.stderr
    r = fresh("import sys\nfrom photon_tpu_torch.checkpoint.hf_import import read_safetensors\n"
              "d = read_safetensors(sys.argv[1])\n"
              "assert 'ml_dtypes' not in sys.modules and 'jax' not in sys.modules\n"
              "print(sum(a.size for a in d.values()))")
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) == sum(v.numel() for v in want.values())

    got = _load_state_dict(tmp_path / "hf")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        assert got[k].tobytes() == v.float().numpy().tobytes(), k
    _, params = load_hf_llama(str(tmp_path / "hf"))
    assert_trees_bit_equal(_flat_port(params), _flat_jax(jax_load(str(tmp_path / "hf"))[1]))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_safetensors_reader_matches_safetensors_numpy(tmp_path, dtype):
    """The stdlib reader against ``safetensors.numpy`` on F32 and F16
    files (shapes of every rank, a metadata header); any other dtype is
    refused by name."""
    from safetensors.numpy import load_file, save_file

    from photon_tpu_torch.checkpoint.hf_import import read_safetensors

    rng = np.random.default_rng(0)
    tensors = {"scalar": np.array(1.5, dtype), "vec": rng.normal(size=7).astype(dtype),
               "mat": rng.normal(size=(5, 3)).astype(dtype),
               "cube": rng.normal(size=(2, 3, 4)).astype(dtype)}
    path = tmp_path / "t.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    got, want = read_safetensors(path), load_file(str(path))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    save_file({"ids": np.arange(4, dtype=np.int32)}, str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="'I32'"):
        read_safetensors(tmp_path / "i.safetensors")


def test_chip_smoke_interop_phase_on_the_cpu(tmp_path):
    """``chip_smoke.interop_phase`` (phase 14) on a tiny GQA llama with
    ``--device cpu``: both CLIs in children, the bit-equal round trip, the
    bf16 shards written by the phase's own writer, and the imported tree's
    streams equal to the original's; its planted fault (layer 0's q_proj
    left untransposed) reads over the phase's bound, and its files are
    gone. K4's launch count is card-only."""
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.ops import ragged_paged_attention as rpa
    from tests.test_torch_compression import _chip_smoke

    smoke = _chip_smoke()
    jcfg = tiny_llama_config(2)
    jcfg.model.max_seq_len = 64
    cfg = Config.from_dict(jcfg.to_dict())
    s = cfg.photon.serve
    s.n_slots, s.block_size, s.n_blocks, s.prefill_token_budget = 4, 4, 0, 16
    cfg.validate("cpu", serving=True)
    rec = smoke.interop_phase(torch, rpa, np, cfg=cfg, device="cpu", prompts=(3, 9, 20, 30),
                              new=6, fault_layer=0, home=tmp_path)
    assert rec["roundtrip_bit_equal"] and rec["bf16_import_equals_rounded"]
    assert rec["bf16_shards"]["shards"] == 2 and rec["bf16_shards"]["tensors"] == 21
    srv = rec["serve"]
    assert srv["streams_equal"] and srv["logits_rel_l2_sound"] == 0.0
    assert srv["logits_rel_l2_fault"] > smoke.INTEROP_FAULT_BOUND
    assert not list(tmp_path.glob("interop-*"))
