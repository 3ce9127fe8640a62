"""Checkpoint interop, inbound: a Hugging Face ``LlamaForCausalLM`` (or
``MixtralForCausalLM``) checkpoint into the port's parameter tree (the
port of ``photon_tpu/checkpoint/hf_import.py``): the warm start from a
public llama-family base model.

The inverse of :mod:`photon_tpu_torch.checkpoint.hf_export`: torch
``Linear [out, in]`` weights transpose back to ``[in, out]`` kernels,
per-layer entries stack onto the ``[n_layers]`` axis, and separate q/k/v
stay separate (GQA) or fuse back into ``wqkv`` (MHA). Weights come from
``model.safetensors`` or ``pytorch_model.bin``, one file or shards under
an index. Safetensors are read with the stdlib and numpy (no
``safetensors`` package): ``F32``, ``F16`` and ``BF16``, the last widened
to fp32 exactly. The JAX importer reads them through
``safetensors.numpy``, which returns a bf16 tensor (the dtype most public
llamas ship) only in a process where ``ml_dtypes`` has given numpy a
bfloat16, as importing JAX does; this package imports neither.

CLI (host work only; it opens no CUDA context; writes the repo's params
npz, usable wherever ``--params-npz`` is)::

    python -m photon_tpu_torch.checkpoint.hf_import --hf-dir /path/llama \\
        --out params.npz [--config cfg.yaml]

Without ``--config`` the model config comes from the checkpoint's
``config.json`` and is written as YAML beside the npz.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import struct
from typing import Any

import numpy as np
import torch

from photon_tpu_torch.config.schema import Config, ModelConfig

#: safetensors dtypes this reader takes; BF16 is widened to fp32
_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16}


def model_config_from_hf(hf_cfg: dict) -> ModelConfig:
    """The family knobs from an HF llama or mixtral ``config.json``."""
    kind = hf_cfg.get("model_type")
    if kind not in ("llama", "mixtral"):
        raise ValueError(f"expected model_type=llama|mixtral, got {kind!r}")
    m = ModelConfig()
    m.name = f"{kind}-import"
    m.d_model = int(hf_cfg["hidden_size"])
    m.n_layers = int(hf_cfg["num_hidden_layers"])
    m.n_heads = int(hf_cfg["num_attention_heads"])
    n_kv = int(hf_cfg.get("num_key_value_heads", m.n_heads))
    m.n_kv_heads = 0 if n_kv == m.n_heads else n_kv
    m.max_seq_len = int(hf_cfg["max_position_embeddings"])
    m.vocab_size = int(hf_cfg["vocab_size"])
    m.mlp_hidden_size = int(hf_cfg["intermediate_size"])
    m.rope = True
    m.rope_theta = float(hf_cfg.get("rope_theta", 10000.0))
    m.learned_pos_emb = False
    m.norm = "rmsnorm"
    if kind == "mixtral":
        m.mlp = "moe"
        m.moe_mlp_act = "swiglu"
        m.moe_num_experts = int(hf_cfg["num_local_experts"])
        m.moe_top_k = int(hf_cfg.get("num_experts_per_tok", 2))
        m.moe_aux_weight = float(hf_cfg.get("router_aux_loss_coef", 0.001))
        if hf_cfg.get("sliding_window") is not None:
            # windowed attention would part from this model's full
            # attention past the window
            raise ValueError(
                f"sliding_window={hf_cfg['sliding_window']} is unsupported — "
                "only full-attention mixtral checkpoints import faithfully"
            )
        # Mixtral routes without capacity: a drop-free factor (E/k) keeps
        # the imported model's forward equal to HF's
        m.moe_capacity_factor = m.moe_num_experts / m.moe_top_k
    else:
        m.mlp = "swiglu"
    m.tie_embeddings = bool(hf_cfg.get("tie_word_embeddings", False))
    if m.tie_embeddings:
        raise ValueError("tied-embedding llama checkpoints are not supported yet")
    if hf_cfg.get("attention_bias") or hf_cfg.get("mlp_bias"):
        raise ValueError("biased llama checkpoints are not supported (no_bias)")
    if hf_cfg.get("head_dim") and int(hf_cfg["head_dim"]) != m.d_model // m.n_heads:
        raise ValueError(
            f"head_dim {hf_cfg['head_dim']} != d_model/n_heads "
            f"{m.d_model // m.n_heads} — decoupled head_dim is unsupported"
        )
    if hf_cfg.get("rope_scaling"):
        # llama3, linear or dynamic scaling changes the frequencies; plain
        # rope_theta would part from HF
        raise ValueError(
            f"rope_scaling={hf_cfg['rope_scaling']} is unsupported — "
            "only plain rope_theta checkpoints import faithfully"
        )
    m.norm_eps = float(hf_cfg.get("rms_norm_eps", 1.0e-5))
    return m


def read_safetensors(path: str | pathlib.Path) -> dict[str, np.ndarray]:
    """A safetensors file as numpy arrays: an 8-byte little-endian header
    length, a JSON header (``dtype``, ``shape``, ``data_offsets`` from the
    start of the data), then the raw bytes. ``F32`` and ``F16`` keep their
    dtype; ``BF16`` is widened exactly (its bits are an fp32's upper 16);
    any other dtype raises."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    (n,) = struct.unpack("<Q", raw[:8].tobytes())
    header = json.loads(raw[8:8 + n].tobytes())
    data = raw[8 + n:]
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(
                f"safetensors dtype {info['dtype']!r} of tensor {name!r} in {path} is not "
                f"supported (only {', '.join(_ST_DTYPES)})"
            )
        start, end = info["data_offsets"]
        a = data[start:end].view(dtype).reshape(info["shape"])
        if info["dtype"] == "BF16":
            out[name] = (a.astype(np.uint32) << 16).view(np.float32)
        else:
            out[name] = np.array(a)  # off the mapping
    return out


def _load_state_dict(hf_dir: pathlib.Path) -> dict:
    """Weights from safetensors (preferred) or torch ``.bin``, one file or
    shards under an index."""
    def load_one(p: pathlib.Path) -> dict:
        if p.suffix == ".safetensors":
            return read_safetensors(p)
        sd = torch.load(str(p), map_location="cpu", weights_only=True)
        # .float(): bf16 has no numpy dtype, and the tree is fp32 anyway
        return {k: sd.pop(k).float().numpy() for k in list(sd)}

    for index_name in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        idx = hf_dir / index_name
        if idx.exists():
            shards = sorted(set(json.loads(idx.read_text())["weight_map"].values()))
            out: dict = {}
            for s in shards:
                out.update(load_one(hf_dir / s))
            return out
    for name in ("model.safetensors", "pytorch_model.bin"):
        p = hf_dir / name
        if p.exists():
            return load_one(p)
    raise FileNotFoundError(f"no weights found under {hf_dir}")


def llama_params_from_hf(sd: dict, cfg: ModelConfig) -> dict:
    """An HF llama (or mixtral) state dict → the port's tree (fp32 CPU
    tensors). Entries are taken out of ``sd`` as they are used, so the host
    holds about one copy of the weights at a time."""

    def t(key: str) -> np.ndarray:  # torch [out, in] -> [in, out]
        return np.ascontiguousarray(np.asarray(sd.pop(key)).T, dtype=np.float32)

    def w(key: str) -> np.ndarray:
        return np.asarray(sd.pop(key), dtype=np.float32)

    L = cfg.n_layers
    n_kv = cfg.n_kv_heads or cfg.n_heads

    def stack(fmt: str, transpose: bool = True) -> np.ndarray:
        fn = t if transpose else w
        first = fn(fmt.format(i=0))
        out = np.empty((L, *first.shape), np.float32)
        out[0] = first
        for i in range(1, L):
            out[i] = fn(fmt.format(i=i))
        return out

    block: dict = {
        "out_proj": {"kernel": stack("model.layers.{i}.self_attn.o_proj.weight")},
        "ln_1": {"scale": stack("model.layers.{i}.input_layernorm.weight", False)},
        "ln_2": {"scale": stack("model.layers.{i}.post_attention_layernorm.weight", False)},
    }
    if cfg.mlp == "moe":
        # Mixtral's block_sparse_moe: gate = the router, experts w1/w3/w2
        E = cfg.moe_num_experts
        block["router"] = stack("model.layers.{i}.block_sparse_moe.gate.weight")
        for ours, theirs in (("moe_gate", "w1"), ("moe_up", "w3"), ("moe_down", "w2")):
            block[ours] = np.stack([
                np.stack([t(f"model.layers.{i}.block_sparse_moe.experts.{e}.{theirs}.weight")
                          for e in range(E)])
                for i in range(L)
            ])
    else:
        block["gate_proj"] = {"kernel": stack("model.layers.{i}.mlp.gate_proj.weight")}
        block["up_proj"] = {"kernel": stack("model.layers.{i}.mlp.up_proj.weight")}
        block["down_proj"] = {"kernel": stack("model.layers.{i}.mlp.down_proj.weight")}
    q = stack("model.layers.{i}.self_attn.q_proj.weight")
    k = stack("model.layers.{i}.self_attn.k_proj.weight")
    v = stack("model.layers.{i}.self_attn.v_proj.weight")
    if n_kv == cfg.n_heads:
        # MHA: fused back into the wqkv layout the model uses
        block["wqkv"] = {"kernel": np.concatenate([q, k, v], axis=-1)}
        del q, k, v
    else:
        block["q_proj"] = {"kernel": q}
        block["k_proj"] = {"kernel": k}
        block["v_proj"] = {"kernel": v}
    tree = {
        "wte": {"embedding": w("model.embed_tokens.weight")},
        "blocks": {"block": block},
        "ln_f": {"scale": w("model.norm.weight")},
        "lm_head": {"kernel": t("lm_head.weight")},
    }
    return _to_torch(tree)


def _to_torch(node):
    if isinstance(node, dict):
        return {k: _to_torch(v) for k, v in node.items()}
    return torch.from_numpy(node)


def load_hf_llama(hf_dir: str, cfg: ModelConfig | None = None) -> tuple[ModelConfig, dict]:
    """(model config, the port's tree) from an HF llama or mixtral
    directory; a given ``cfg`` must agree with the checkpoint's shape."""
    d = pathlib.Path(hf_dir)
    hf_cfg = json.loads((d / "config.json").read_text())
    derived = model_config_from_hf(hf_cfg)
    if cfg is not None:
        for field in ("d_model", "n_layers", "n_heads", "vocab_size",
                      "n_kv_heads", "mlp_hidden_size", "mlp",
                      "moe_num_experts", "moe_top_k", "moe_mlp_act"):
            if getattr(cfg, field) != getattr(derived, field):
                raise ValueError(
                    f"config mismatch on {field}: yours={getattr(cfg, field)} "
                    f"checkpoint={getattr(derived, field)}"
                )
        derived = cfg
    return derived, llama_params_from_hf(_load_state_dict(d), derived)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--hf-dir", required=True)
    ap.add_argument("--out", required=True, help="output params npz path")
    ap.add_argument("--config", help="optional photon-tpu config yaml to check against")
    args = ap.parse_args(argv)

    from photon_tpu_torch.checkpoint.serialization import arrays_to_npz
    from photon_tpu_torch.codec.params import ParamsMetadata, flatten

    # the model section is all an import reads
    cfg = Config.from_yaml(args.config).validate(serving=True).model if args.config else None
    model_cfg, params = load_hf_llama(args.hf_dir, cfg)
    flat = flatten(params)
    del params
    arrays = [t.numpy() for t in flat.values()]  # views: the tree is fp32 on the CPU
    meta = ParamsMetadata.from_ndarrays(flat, arrays)
    del flat
    out = pathlib.Path(args.out)
    out.write_bytes(arrays_to_npz(meta, arrays))
    yaml_path = out.with_suffix(".model.yaml")
    full = Config()
    full.model = model_cfg
    full.to_yaml(yaml_path)
    print(json.dumps({
        "out": str(out), "model_yaml": str(yaml_path),
        "n_arrays": len(meta.names),
        "n_params": int(sum(int(np.prod(a.shape)) for a in arrays)),
    }))


if __name__ == "__main__":
    main()
