"""``photon_tpu_torch.checkpoint.hf_export`` against
``photon_tpu.checkpoint.hf_export``: one case for each case of
``tests/test_hf_export.py``.

The same seeded weights go into both packages (the JAX tree carried to the
port as numpy). The port's llama (fused MHA and GQA), mixtral and
mpt-foundry state dicts must equal the JAX package's tensor for tensor:
names, order, shapes, dtypes and bytes. ``transformers`` loads the port's
llama and mixtral exports, and their fp32 CPU logits match the port's
model at the JAX test's tolerance (2e-4).
"""

import numpy as np
import pytest

from photon_tpu.codec.params import params_to_ndarrays as jax_to_ndarrays
from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu.models.mpt import init_params as jax_init

from tests._helpers import tiny_llama_config
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")


def _port_cfg(jcfg: JaxConfig):
    from photon_tpu_torch.config.schema import Config

    return Config.from_dict(jcfg.to_dict()).validate("cpu")


def _weights(jcfg: JaxConfig, seed: int):
    """(JAX params, the port's tree, the port's config) holding the same
    numbers."""
    from photon_tpu_torch.codec.params import params_from_numpy

    pcfg = _port_cfg(jcfg)
    jp = jax_init(jcfg.model, seed=seed)
    meta, arrays = jax_to_ndarrays(jp)
    return jp, params_from_numpy(meta.names, arrays, pcfg.model, "cpu"), pcfg


def assert_same_state_dict(got: dict, want: dict) -> None:
    """Names in order, shapes, dtypes and bytes."""
    assert list(got) == list(want)
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape), k
        assert a.is_contiguous() and a.numpy().tobytes() == b.contiguous().numpy().tobytes(), k


def _port_logits(pcfg, params, tokens) -> np.ndarray:
    from photon_tpu_torch.models.mpt import MPTModel

    with torch.no_grad():
        return MPTModel(pcfg.model)(params, torch.from_numpy(tokens.astype(np.int64))).numpy()


def _tokens():
    return np.random.default_rng(0).integers(0, 96, (2, 12), dtype=np.int32)


def _mixtral_cfg() -> JaxConfig:
    cfg = tiny_llama_config(n_kv_heads=2)
    cfg.model.mlp = "moe"
    cfg.model.moe_mlp_act = "swiglu"
    cfg.model.moe_num_experts = 4
    cfg.model.moe_top_k = 2
    cfg.model.moe_capacity_factor = 2.0  # E/k: drop-free, as Mixtral routes
    return cfg.validate()


@pytest.mark.parametrize("n_kv", [0, 2], ids=["mha-fused", "gqa"])
def test_llama_export_logit_parity(tmp_path, n_kv):
    from photon_tpu.checkpoint import hf_export as jax_export
    from photon_tpu_torch.checkpoint.hf_export import (
        llama_hf_config,
        llama_state_dict,
        save_hf_llama,
    )

    jcfg = tiny_llama_config(n_kv)
    jp, params, pcfg = _weights(jcfg, seed=3)
    assert_same_state_dict(llama_state_dict(params, pcfg.model),
                           jax_export.llama_state_dict(jp, jcfg.model))
    assert llama_hf_config(pcfg.model) == jax_export.llama_hf_config(jcfg.model)

    out = save_hf_llama(params, pcfg.model, str(tmp_path / "hf"))
    hf = transformers.LlamaForCausalLM.from_pretrained(str(out), torch_dtype=torch.float32)
    hf.eval()
    tokens = _tokens()
    with torch.no_grad():
        theirs = hf(torch.from_numpy(tokens.astype(np.int64))).logits.numpy()
    np.testing.assert_allclose(_port_logits(pcfg, params, tokens), theirs, atol=2e-4, rtol=2e-4)


def test_mixtral_export_logit_parity(tmp_path):
    """Mixtral's routing is this model's (softmax, top-k, renormalize)
    with w1/w3/w2 experts; a drop-free capacity gives the same logits."""
    from photon_tpu.checkpoint import hf_export as jax_export
    from photon_tpu_torch.checkpoint.hf_export import (
        mixtral_hf_config,
        mixtral_state_dict,
        save_hf_mixtral,
    )

    jcfg = _mixtral_cfg()
    jp, params, pcfg = _weights(jcfg, seed=3)
    assert_same_state_dict(mixtral_state_dict(params, pcfg.model),
                           jax_export.mixtral_state_dict(jp, jcfg.model))
    assert mixtral_hf_config(pcfg.model) == jax_export.mixtral_hf_config(jcfg.model)

    out = save_hf_mixtral(params, pcfg.model, str(tmp_path / "hf"))
    hf = transformers.MixtralForCausalLM.from_pretrained(str(out), torch_dtype=torch.float32)
    hf.eval()
    tokens = _tokens()
    with torch.no_grad():
        theirs = hf(torch.from_numpy(tokens.astype(np.int64))).logits.numpy()
    np.testing.assert_allclose(_port_logits(pcfg, params, tokens), theirs, atol=2e-4, rtol=2e-4)


def test_mixtral_export_rejects_gelu_experts():
    from photon_tpu.checkpoint.hf_export import mixtral_state_dict as jax_sd
    from photon_tpu_torch.checkpoint.hf_export import mixtral_state_dict

    cfg = tiny_llama_config()
    cfg.model.mlp = "moe"
    cfg.model.moe_num_experts = 4
    cfg.validate()  # the default moe_mlp_act is gelu
    jp, params, pcfg = _weights(cfg, seed=0)
    with pytest.raises(ValueError, match="moe_mlp_act='swiglu'") as ours:
        mixtral_state_dict(params, pcfg.model)
    with pytest.raises(ValueError) as theirs:
        jax_sd(jp, cfg.model)
    assert str(ours.value) == str(theirs.value)


def test_llama_export_rejects_mpt_config():
    from photon_tpu.checkpoint.hf_export import llama_state_dict as jax_sd
    from photon_tpu_torch.checkpoint.hf_export import llama_state_dict

    cfg = JaxConfig()
    cfg.model.d_model, cfg.model.n_layers, cfg.model.n_heads, cfg.model.vocab_size = 32, 1, 2, 64
    cfg.validate()
    jp, params, pcfg = _weights(cfg, seed=0)
    with pytest.raises(ValueError, match="llama export") as ours:
        llama_state_dict(params, pcfg.model)
    with pytest.raises(ValueError) as theirs:
        jax_sd(jp, cfg.model)
    assert str(ours.value) == str(theirs.value)


def test_llama_export_rejects_biased_config():
    from photon_tpu.checkpoint.hf_export import llama_state_dict as jax_sd
    from photon_tpu_torch.checkpoint.hf_export import llama_state_dict

    cfg = tiny_llama_config()
    cfg.model.no_bias = False
    cfg.validate()
    jp, params, pcfg = _weights(cfg, seed=0)
    with pytest.raises(ValueError, match="no_bias") as ours:
        llama_state_dict(params, pcfg.model)
    with pytest.raises(ValueError) as theirs:
        jax_sd(jp, cfg.model)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("no_bias", [True, False], ids=["no-bias", "biased"])
def test_foundry_mpt_state_dict_structure(no_bias):
    """llm-foundry's naming with the learned ``wpe``, the biases of a
    biased config and the tied head left out: JAX's state dict exactly."""
    from photon_tpu.checkpoint.hf_export import foundry_mpt_state_dict as jax_sd
    from photon_tpu_torch.checkpoint.hf_export import foundry_mpt_state_dict

    cfg = JaxConfig()
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size = 32, 2, 2, 16, 64
    m.no_bias = no_bias
    cfg.validate()
    jp, params, pcfg = _weights(cfg, seed=0)
    sd = foundry_mpt_state_dict(params, pcfg.model)
    assert_same_state_dict(sd, jax_sd(jp, cfg.model))
    pre = "model.transformer."
    assert sd[pre + "wte.weight"].shape == (64, 32)
    assert sd[pre + "wpe.weight"].shape == (16, 32)  # learned positions kept
    for i in range(2):
        assert sd[f"{pre}blocks.{i}.attn.Wqkv.weight"].shape == (96, 32)
        assert sd[f"{pre}blocks.{i}.ffn.up_proj.weight"].shape == (128, 32)
        assert sd[f"{pre}blocks.{i}.ffn.down_proj.weight"].shape == (32, 128)
        assert (f"{pre}blocks.{i}.attn.Wqkv.bias" in sd) == (not no_bias)
    np.testing.assert_array_equal(sd[pre + "blocks.0.attn.Wqkv.weight"].numpy().T,
                                  params["blocks"]["block"]["wqkv"]["kernel"][0].numpy())
    assert "model.lm_head.weight" not in sd  # tied: no separate head


def test_export_cli_roundtrip(tmp_path):
    """The CLI: an npz dump (written by the JAX package) → the port's
    exporter → transformers loads it, and the file's tensors are the JAX
    CLI's."""
    from photon_tpu.checkpoint import arrays_to_npz
    from photon_tpu.checkpoint.hf_export import main as jax_main
    from photon_tpu_torch.checkpoint.hf_export import main

    cfg = tiny_llama_config()
    meta, arrays = jax_to_ndarrays(jax_init(cfg.model, seed=1))
    npz = tmp_path / "params.npz"
    npz.write_bytes(arrays_to_npz(meta, arrays))
    cfg_yaml = tmp_path / "cfg.yaml"
    cfg.to_yaml(str(cfg_yaml))
    args = ["--params-npz", str(npz), "--config", str(cfg_yaml), "--format", "llama"]

    main(args + ["--out", str(tmp_path / "hf")])
    jax_main(args + ["--out", str(tmp_path / "hf_jax")])
    hf = transformers.LlamaForCausalLM.from_pretrained(str(tmp_path / "hf"),
                                                       torch_dtype=torch.float32)
    assert hf.config.num_hidden_layers == 2
    assert_same_state_dict(
        torch.load(tmp_path / "hf" / "pytorch_model.bin", weights_only=True),
        torch.load(tmp_path / "hf_jax" / "pytorch_model.bin", weights_only=True))
    assert (tmp_path / "hf" / "config.json").read_text() == \
        (tmp_path / "hf_jax" / "config.json").read_text()
