"""The MPT/llama parameter tree, built in torch.

Only what serving needs from ``photon_tpu/models/mpt.py``: the names and
shapes of its parameter tree (:func:`param_shapes`) and a seeded
:func:`init_params` that fills the same tree with random weights. The
model forward waits for the training slice; serving runs the per-layer
helpers of ``models/decode.py`` instead.

Layout, as in the JAX package: flat ``/``-joined names, layers stacked on
a leading ``[n_layers]`` axis, dense kernels ``[in, out]``.
"""

from __future__ import annotations

import torch

from photon_tpu_torch.config.schema import ModelConfig


def _norm_shapes(cfg: ModelConfig, prefix: str, lead: tuple) -> dict:
    out = {f"{prefix}/scale": lead + (cfg.d_model,)}
    if cfg.norm == "layernorm" and not cfg.no_bias:
        out[f"{prefix}/bias"] = lead + (cfg.d_model,)
    return out


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Flat name → shape of the serving parameter tree, sorted by name
    (the codec's canonical order)."""
    d, L = cfg.d_model, cfg.n_layers
    lead = (L,)
    out: dict[str, tuple[int, ...]] = {"wte/embedding": (cfg.vocab_size, d)}
    if cfg.learned_pos_emb and not cfg.alibi and not cfg.rope:
        out["wpe"] = (cfg.max_seq_len, d)
    out.update(_norm_shapes(cfg, "ln_f", ()))
    if not cfg.tie_embeddings:
        out["lm_head/kernel"] = (d, cfg.vocab_size)
    blk = "blocks/block"
    dense: dict[str, tuple[int, int]] = {}
    if cfg.kv_heads == cfg.n_heads:
        dense["wqkv"] = (d, 3 * d)
    else:
        dense["q_proj"] = (d, cfg.n_heads * cfg.d_head)
        dense["k_proj"] = (d, cfg.kv_heads * cfg.d_head)
        dense["v_proj"] = (d, cfg.kv_heads * cfg.d_head)
    dense["out_proj"] = (d, d)
    if cfg.mlp == "swiglu":
        dense["gate_proj"] = (d, cfg.hidden)
    dense["up_proj"] = (d, cfg.hidden)
    dense["down_proj"] = (cfg.hidden, d)
    for name, (i, o) in dense.items():
        out[f"{blk}/{name}/kernel"] = lead + (i, o)
        if not cfg.no_bias:
            out[f"{blk}/{name}/bias"] = lead + (o,)
    out.update(_norm_shapes(cfg, f"{blk}/ln_1", lead))
    out.update(_norm_shapes(cfg, f"{blk}/ln_2", lead))
    return dict(sorted(out.items()))


def _init_std(cfg: ModelConfig, name: str) -> float:
    if name.endswith(("out_proj/kernel", "down_proj/kernel")):
        return cfg.emb_init_std / (2.0 * cfg.n_layers) ** 0.5
    return cfg.emb_init_std


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = "cpu") -> dict:
    """Random weights in the serving tree's names and shapes, from a
    seeded ``torch.Generator``: normal(0, std) for embeddings and dense
    kernels (the residual projections scaled by ``1/sqrt(2L)`` as in the
    JAX init), ones for norm scales, zeros for biases. fp32, like the JAX
    package's ``param_dtype``."""
    from photon_tpu_torch.codec.params import unflatten

    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("/scale"):
            flat[name] = torch.ones(shape, device=device)
        elif name.endswith("/bias"):
            flat[name] = torch.zeros(shape, device=device)
        else:
            w = torch.randn(shape, generator=gen, device=device)
            flat[name] = w.mul_(_init_std(cfg, name))
    return unflatten(flat)
