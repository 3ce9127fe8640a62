"""Checkpoint interop, outbound: the port's parameters to torch ecosystems
(the port of ``photon_tpu/checkpoint/hf_export.py``).

- **llama**: a Hugging Face ``LlamaForCausalLM`` directory
  (``config.json`` and ``pytorch_model.bin``) that ``transformers`` loads
  with no custom code. RoPE (rotate-half), RMSNorm, SwiGLU, GQA and an
  untied head map onto its implementation exactly.
- **mixtral**: ``MixtralForCausalLM``, from a llama-family tree with
  SwiGLU experts (w1/w3/w2 and the router as ``block_sparse_moe.gate``).
- **mpt-foundry**: a state dict in llm-foundry's MPT naming
  (``model.transformer.blocks.{i}.attn.Wqkv.weight``, ...), the learned
  ``wpe`` and the biases included, for moving weights back into the
  reference stack (foundry's exact GELU differs from this package's tanh
  approximation by ~1e-3 in the activations).

The tree (``params_from_numpy``'s, or any nested dict of CPU tensors or
arrays with the JAX package's names) stores dense kernels ``[in, out]``
and layers stacked on a leading ``[n_layers]`` axis; the export transposes
to torch's ``Linear [out, in]`` and unstacks per layer, so the state dicts
equal the JAX package's tensor for tensor.

CLI (host work only; it opens no CUDA context)::

    python -m photon_tpu_torch.checkpoint.hf_export --params-npz params.npz \\
        --preset llama-1b --out /tmp/hf_llama [--format llama|mixtral|mpt-foundry]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import warnings
from typing import Any

import numpy as np
import torch

from photon_tpu_torch.config.schema import Config, ModelConfig


def _a(x: Any) -> np.ndarray:
    """A leaf (a CPU tensor or an array) as a numpy array, without a copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(arr: Any) -> torch.Tensor:
    """A dense kernel ``[in, out]`` → a torch ``Linear`` weight ``[out, in]``."""
    return torch.from_numpy(np.ascontiguousarray(_a(arr).T))


def _w(arr: Any) -> torch.Tensor:
    a = np.ascontiguousarray(_a(arr))
    if not a.flags.writeable:  # torch.from_numpy needs writable memory
        a = a.copy()
    return torch.from_numpy(a)


def _hf_llama_family_common(params: Any, cfg: ModelConfig, kind: str, mlp_emit) -> dict:
    """The embedding, attention, norm and head tensors of the llama and
    mixtral exports (HF ``model.layers.{i}`` naming); ``mlp_emit(sd,
    prefix, i)`` adds each layer's MLP."""
    if not cfg.rope or cfg.norm != "rmsnorm":
        raise ValueError(
            f"{kind} export needs rope=true, norm=rmsnorm "
            f"(got rope={cfg.rope}, norm={cfg.norm})"
        )
    if cfg.tie_embeddings:
        raise ValueError(f"{kind} export expects tie_embeddings=false")
    if not cfg.no_bias:
        # from_pretrained would zero-initialize the trained biases (missing
        # keys only warn): refuse instead
        raise ValueError(f"{kind} export supports no_bias=true configs only")
    blocks = params["blocks"]["block"]
    sd: dict = {"model.embed_tokens.weight": _w(params["wte"]["embedding"])}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        if "wqkv" in blocks:  # the fused MHA layout
            q, k, v = np.split(_a(blocks["wqkv"]["kernel"])[i], 3, axis=-1)
        else:
            q = _a(blocks["q_proj"]["kernel"])[i]
            k = _a(blocks["k_proj"]["kernel"])[i]
            v = _a(blocks["v_proj"]["kernel"])[i]
        sd[p + "self_attn.q_proj.weight"] = _t(q)
        sd[p + "self_attn.k_proj.weight"] = _t(k)
        sd[p + "self_attn.v_proj.weight"] = _t(v)
        sd[p + "self_attn.o_proj.weight"] = _t(_a(blocks["out_proj"]["kernel"])[i])
        mlp_emit(sd, p, i)
        sd[p + "input_layernorm.weight"] = _w(_a(blocks["ln_1"]["scale"])[i])
        sd[p + "post_attention_layernorm.weight"] = _w(_a(blocks["ln_2"]["scale"])[i])
    sd["model.norm.weight"] = _w(params["ln_f"]["scale"])
    sd["lm_head.weight"] = _t(params["lm_head"]["kernel"])
    return sd


def llama_state_dict(params: Any, cfg: ModelConfig) -> dict:
    """HF ``LlamaForCausalLM`` state dict from a llama-family tree."""
    if cfg.mlp != "swiglu":
        raise ValueError(f"llama export needs mlp=swiglu (got mlp={cfg.mlp})")
    blocks = params["blocks"]["block"]

    def mlp(sd, p, i):
        sd[p + "mlp.gate_proj.weight"] = _t(_a(blocks["gate_proj"]["kernel"])[i])
        sd[p + "mlp.up_proj.weight"] = _t(_a(blocks["up_proj"]["kernel"])[i])
        sd[p + "mlp.down_proj.weight"] = _t(_a(blocks["down_proj"]["kernel"])[i])

    return _hf_llama_family_common(params, cfg, "llama", mlp)


def llama_hf_config(cfg: ModelConfig, bos_token_id: int = 0, eos_token_id: int = 0) -> dict:
    """The HF ``config.json``. ``bos/eos_token_id`` default to 0 (the
    ``<|endoftext|>`` id of this repo's vocabulary convention); pass your
    tokenizer's ids and ship its files beside the export for generation."""
    return {
        "bos_token_id": bos_token_id,
        "eos_token_id": eos_token_id,
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": cfg.d_model,
        "intermediate_size": cfg.hidden,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.kv_heads,
        "head_dim": cfg.d_head,
        "max_position_embeddings": cfg.max_seq_len,
        "vocab_size": cfg.vocab_size,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "hidden_act": "silu",
        "attention_bias": not cfg.no_bias,
        "mlp_bias": not cfg.no_bias,
        "tie_word_embeddings": False,
        "torch_dtype": "float32",
    }


def mixtral_state_dict(params: Any, cfg: ModelConfig) -> dict:
    """HF ``MixtralForCausalLM`` state dict from a llama-family MoE tree.

    The SwiGLU experts (``moe_gate``/``moe_up``/``moe_down``) are
    Mixtral's w1/w3/w2 and the router its ``block_sparse_moe.gate``; the
    routing is the same (softmax, top-k, renormalize). Mixtral has no
    capacity, so its logits equal this model's only where routing drops
    no token (``moe_capacity_factor`` >= E / top_k, or a batch that does
    not overflow): a property of the batch, warned about, not enforced.
    """
    if cfg.mlp != "moe" or cfg.moe_mlp_act != "swiglu":
        raise ValueError(
            "mixtral export needs mlp='moe' with moe_mlp_act='swiglu' "
            f"(got mlp={cfg.mlp}, moe_mlp_act={cfg.moe_mlp_act})"
        )
    drop_free = cfg.moe_num_experts / cfg.moe_top_k
    if cfg.moe_capacity_factor < drop_free:
        warnings.warn(
            f"mixtral export: moe_capacity_factor={cfg.moe_capacity_factor} "
            f"< moe_num_experts/moe_top_k={drop_free:g}: this model was "
            "trained with capacity-dropped routing, but HF Mixtral routes "
            "drop-free — exported logits will diverge from training-time "
            "behavior on batches that overflow expert capacity",
            stacklevel=2,
        )
    blocks = params["blocks"]["block"]

    def mlp(sd, p, i):
        sd[p + "block_sparse_moe.gate.weight"] = _t(_a(blocks["router"])[i])
        for e in range(cfg.moe_num_experts):
            ep = p + f"block_sparse_moe.experts.{e}."
            sd[ep + "w1.weight"] = _t(_a(blocks["moe_gate"])[i, e])
            sd[ep + "w3.weight"] = _t(_a(blocks["moe_up"])[i, e])
            sd[ep + "w2.weight"] = _t(_a(blocks["moe_down"])[i, e])

    return _hf_llama_family_common(params, cfg, "mixtral", mlp)


def mixtral_hf_config(cfg: ModelConfig, bos_token_id: int = 0, eos_token_id: int = 0) -> dict:
    return {
        "bos_token_id": bos_token_id,
        "eos_token_id": eos_token_id,
        "architectures": ["MixtralForCausalLM"],
        "model_type": "mixtral",
        "hidden_size": cfg.d_model,
        "intermediate_size": cfg.hidden,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.kv_heads,
        "head_dim": cfg.d_head,
        "max_position_embeddings": cfg.max_seq_len,
        "vocab_size": cfg.vocab_size,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "num_local_experts": cfg.moe_num_experts,
        "num_experts_per_tok": cfg.moe_top_k,
        "router_aux_loss_coef": cfg.moe_aux_weight,
        "hidden_act": "silu",
        "attention_bias": False,
        "tie_word_embeddings": False,
        "torch_dtype": "float32",
    }


def foundry_mpt_state_dict(params: Any, cfg: ModelConfig) -> dict:
    """llm-foundry's MPT naming (the reference's checkpoint module tree)."""
    if cfg.rope or cfg.norm != "layernorm" or cfg.mlp != "gelu":
        raise ValueError("mpt-foundry export is for the MPT family config")
    blocks = params["blocks"]["block"]
    pre = "model.transformer."
    sd: dict = {pre + "wte.weight": _w(params["wte"]["embedding"])}
    if "wpe" in params:
        sd[pre + "wpe.weight"] = _w(params["wpe"])
    for i in range(cfg.n_layers):
        p = f"{pre}blocks.{i}."
        sd[p + "attn.Wqkv.weight"] = _t(_a(blocks["wqkv"]["kernel"])[i])
        sd[p + "attn.out_proj.weight"] = _t(_a(blocks["out_proj"]["kernel"])[i])
        sd[p + "ffn.up_proj.weight"] = _t(_a(blocks["up_proj"]["kernel"])[i])
        sd[p + "ffn.down_proj.weight"] = _t(_a(blocks["down_proj"]["kernel"])[i])
        sd[p + "norm_1.weight"] = _w(_a(blocks["ln_1"]["scale"])[i])
        sd[p + "norm_2.weight"] = _w(_a(blocks["ln_2"]["scale"])[i])
        if not cfg.no_bias:
            sd[p + "attn.Wqkv.bias"] = _w(_a(blocks["wqkv"]["bias"])[i])
            sd[p + "attn.out_proj.bias"] = _w(_a(blocks["out_proj"]["bias"])[i])
            sd[p + "ffn.up_proj.bias"] = _w(_a(blocks["up_proj"]["bias"])[i])
            sd[p + "ffn.down_proj.bias"] = _w(_a(blocks["down_proj"]["bias"])[i])
            sd[p + "norm_1.bias"] = _w(_a(blocks["ln_1"]["bias"])[i])
            sd[p + "norm_2.bias"] = _w(_a(blocks["ln_2"]["bias"])[i])
    sd[pre + "norm_f.weight"] = _w(params["ln_f"]["scale"])
    if not cfg.no_bias:
        sd[pre + "norm_f.bias"] = _w(params["ln_f"]["bias"])
    # foundry ties lm_head to wte: a tied config has nothing more to emit
    if not cfg.tie_embeddings:
        sd["model.lm_head.weight"] = _t(params["lm_head"]["kernel"])
    return sd


def _write(out_dir: str, hf_config: dict | None, sd: dict, name: str) -> pathlib.Path:
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if hf_config is not None:
        (out / "config.json").write_text(json.dumps(hf_config, indent=2))
    torch.save(sd, out / name)
    return out


def save_hf_llama(params: Any, cfg: ModelConfig, out_dir: str,
                  bos_token_id: int = 0, eos_token_id: int = 0) -> pathlib.Path:
    """A transformers-loadable ``LlamaForCausalLM`` directory (weights and
    config; ship tokenizer files beside it for generation)."""
    return _write(out_dir, llama_hf_config(cfg, bos_token_id, eos_token_id),
                  llama_state_dict(params, cfg), "pytorch_model.bin")


def save_hf_mixtral(params: Any, cfg: ModelConfig, out_dir: str,
                    bos_token_id: int = 0, eos_token_id: int = 0) -> pathlib.Path:
    return _write(out_dir, mixtral_hf_config(cfg, bos_token_id, eos_token_id),
                  mixtral_state_dict(params, cfg), "pytorch_model.bin")


def save_foundry_mpt(params: Any, cfg: ModelConfig, out_dir: str) -> pathlib.Path:
    return _write(out_dir, None, foundry_mpt_state_dict(params, cfg),
                  "mpt_foundry_state_dict.pt")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--params-npz", required=True)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--preset")
    src.add_argument("--config")
    ap.add_argument("--out", required=True)
    ap.add_argument("--format", default="llama", choices=["llama", "mixtral", "mpt-foundry"])
    ap.add_argument("--bos-token-id", type=int, default=0)
    ap.add_argument("--eos-token-id", type=int, default=0)
    args = ap.parse_args(argv)

    from photon_tpu_torch.checkpoint.serialization import npz_to_arrays
    from photon_tpu_torch.codec.params import params_from_numpy
    from photon_tpu_torch.config import load_preset

    cfg = Config.from_yaml(args.config) if args.config else load_preset(args.preset)
    cfg.validate(serving=True)  # the model section is all an export reads
    meta, arrays = npz_to_arrays(pathlib.Path(args.params_npz).read_bytes())
    # the tree straight from the npz's names (checked against the config):
    # no template of random weights is built for it
    params = params_from_numpy(meta.names, arrays, cfg.model)
    del arrays
    if args.format == "llama":
        out = save_hf_llama(params, cfg.model, args.out, args.bos_token_id, args.eos_token_id)
    elif args.format == "mixtral":
        out = save_hf_mixtral(params, cfg.model, args.out, args.bos_token_id, args.eos_token_id)
    else:
        out = save_foundry_mpt(params, cfg.model, args.out)
    print(json.dumps({"format": args.format, "out": str(out), "n_arrays": len(meta.names)}))


if __name__ == "__main__":
    main()
