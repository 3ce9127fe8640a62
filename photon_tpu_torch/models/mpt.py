"""The MPT/llama decoder in torch: the training forward over the JAX tree.

The port of ``photon_tpu/models/mpt.py``: the names and shapes of its
parameter tree (:func:`param_shapes`), a seeded :func:`init_params`, and
:class:`MPTModel`/:class:`MPTBlock`, the forward that training runs.
Layout, as in the JAX package: flat ``/``-joined names, layers stacked on
a leading ``[n_layers]`` axis, dense kernels ``[in, out]``, fp32 masters.
An MoE block (``mlp: moe``) holds ``router [D, E]``, ``moe_up [E, D, H]``,
``moe_down [E, H, D]`` (and ``moe_gate`` for SwiGLU experts) in place of
the dense MLP, and returns its layer's aux loss beside its output. With
``lora_rank > 0`` each targeted dense module ``{name}`` also holds
``{name}_lora_a [L, d_in, r]`` and ``{name}_lora_b [L, r, d_out]``, and
its projection adds ``(h @ A) @ B · lora_alpha / lora_rank``;
``lora_rank == 0`` leaves tree and forward as they were.

:class:`MPTModel` is a module without parameters of its own: like
``MPTModel.apply`` it takes the parameter tree with the tokens, so the
trainer, the optimizer and the checkpoint codec all work on the one tree.
Each forward casts the masters to ``compute_dtype`` inside autograd (the
gradients land in fp32 on the masters), unbinds the stacked layers once,
and loops over them; ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``). The layer math is ``models/decode.py``'s,
shared with serving: norms in fp32 and cast back, dense products in the
compute dtype, logits in ``logits_dtype``. The JAX package's sharding
hints have no counterpart on one device.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from photon_tpu_torch.codec.params import flatten
from photon_tpu_torch.config.schema import ModelConfig
from photon_tpu_torch.models.decode import (
    _dense,
    _embed,
    _logits,
    _mlp,
    _norm,
    _qkv,
    _rope_at,
    compute_params,
)


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
    if cfg.mlp == "moe":  # the router and the experts: no biases
        e, h = cfg.moe_num_experts, cfg.hidden
        out[f"{blk}/router"] = lead + (d, e)
        out[f"{blk}/moe_up"] = lead + (e, d, h)
        out[f"{blk}/moe_down"] = lead + (e, h, d)
        if cfg.moe_mlp_act == "swiglu":
            out[f"{blk}/moe_gate"] = lead + (e, d, h)
    else:
        if cfg.mlp == "swiglu":
            dense["gate_proj"] = (d, cfg.hidden)
        dense["up_proj"] = (d, cfg.hidden)
        dense["down_proj"] = (cfg.hidden, d)
    for name, (i, o) in dense.items():
        out[f"{blk}/{name}/kernel"] = lead + (i, o)
        if not cfg.no_bias:
            out[f"{blk}/{name}/bias"] = lead + (o,)
        if cfg.lora_rank and name in cfg.lora_targets:
            out[f"{blk}/{name}_lora_a"] = lead + (i, cfg.lora_rank)
            out[f"{blk}/{name}_lora_b"] = lead + (cfg.lora_rank, o)
    out.update(_norm_shapes(cfg, f"{blk}/ln_1", lead))
    out.update(_norm_shapes(cfg, f"{blk}/ln_2", lead))
    return dict(sorted(out.items()))


def _init_std(cfg: ModelConfig, name: str) -> float:
    if name.endswith(("out_proj/kernel", "down_proj/kernel", "moe_down")):
        return cfg.emb_init_std / (2.0 * cfg.n_layers) ** 0.5
    return cfg.emb_init_std


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = "cpu") -> dict:
    """Random weights in the serving tree's names and shapes, from a
    seeded ``torch.Generator``: normal(0, std) for embeddings and dense
    kernels (the residual projections scaled by ``1/sqrt(2L)`` as in the
    JAX init), ones for norm scales, zeros for biases. fp32, the JAX
    package's default ``param_dtype`` (``Config.validate`` refuses any
    other). LoRA factors, drawn after every base
    tensor (so the base is the same with LoRA on or off): A from
    normal(0, ``emb_init_std``), B zero, as in the JAX init."""
    from photon_tpu_torch.codec.params import unflatten

    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = {}
    shapes = param_shapes(cfg)
    lora = [n for n in shapes if "_lora_" in n]
    for name, shape in [(n, s) for n, s in shapes.items() if n not in lora] + \
            [(n, shapes[n]) for n in lora]:
        if name.endswith("_lora_b"):
            flat[name] = torch.zeros(shape, device=device)
        elif name.endswith("/scale"):
            flat[name] = torch.ones(shape, device=device)
        elif name.endswith("/bias"):
            flat[name] = torch.zeros(shape, device=device)
        else:
            w = torch.randn(shape, generator=gen, device=device)
            flat[name] = w.mul_(_init_std(cfg, name))
    return unflatten(dict(sorted(flat.items())))


class MPTBlock(torch.nn.Module):
    """One pre-norm decoder block over one layer's slice of the tree:
    ``(x, lp) -> (x, the layer's MoE aux loss or None)``."""

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        self.cfg = cfg

    def forward(self, x: torch.Tensor, lp: dict) -> tuple[torch.Tensor, torch.Tensor | None]:
        from photon_tpu_torch.ops.attention import multihead_attention

        cfg = self.cfg
        # the layer's LoRA factors, one adapter for every row
        la = {n[: -len("_lora_a")]: {"a": lp[n], "b": lp[n[: -len("_lora_a")] + "_lora_b"]}
              for n in lp if n.endswith("_lora_a")} or None
        ls = cfg.lora_alpha / cfg.lora_rank if la else 1.0
        h = _norm(x, lp["ln_1"]["scale"], lp["ln_1"].get("bias"), cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(lp, h, cfg, la, ls)  # a fused wqkv gives strided views: the kernels read them
        if cfg.rope:  # before any kv repeat, at positions 0 .. S-1
            pos = torch.arange(x.shape[1], device=x.device)[None]
            q, k = _rope_at(q, pos, cfg.rope_theta), _rope_at(k, pos, cfg.rope_theta)
        o = multihead_attention(q, k, v, impl=cfg.attn_impl, causal=True, alibi=cfg.alibi)
        x = x + _dense(lp, "out_proj", o.reshape(x.shape), la, ls)
        return _mlp(lp, x, cfg, la=la, ls=ls)


def _layers(blocks: dict) -> list[dict]:
    """The stacked ``blocks/block`` subtree as one dict per layer; each
    stacked tensor is unbound once, so its backward is one stack."""

    def unbind(node: dict) -> dict:
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0) for k, v in node.items()}

    def pick(node: dict, i: int) -> dict:
        return {k: pick(v, i) if isinstance(v, dict) else v[i] for k, v in node.items()}

    tree = unbind(blocks)
    n_layers = len(next(iter(flatten(tree).values())))
    return [pick(tree, i) for i in range(n_layers)]


class MPTModel(torch.nn.Module):
    """Decoder-only LM: ``model(params, tokens [B, S])`` → logits
    ``[B, S, vocab]`` in ``logits_dtype``, or with ``return_hidden=True``
    the ``[B, S, d_model]`` hidden states after the final norm (the loss
    then computes logits chunk by chunk). ``return_aux=True`` returns
    ``(that, moe_aux_weight × Σ_layers aux)``, the MoE load-balance term
    the training loss adds (an fp32 zero for a dense model), as the JAX
    package's ``_apply_collecting_aux``."""

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.block = MPTBlock(cfg)

    def forward(self, params: dict, tokens: torch.Tensor, return_hidden: bool = False,
                return_aux: bool = False):
        cfg = self.cfg
        cp = compute_params(params, cfg, tokens.device)  # casts inside autograd
        x = _embed(cp, tokens, torch.arange(tokens.shape[1], device=tokens.device)[None], cfg)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for lp in _layers(cp["blocks"]["block"]):
            if cfg.remat:  # the aux is an output of the checkpointed block
                x, layer_aux = checkpoint(self.block, x, lp, use_reentrant=False)
            else:
                x, layer_aux = self.block(x, lp)
            if layer_aux is not None:
                aux = aux + layer_aux
        if return_hidden:
            out = _norm(x, cp["ln_f"]["scale"], cp["ln_f"].get("bias"), cfg.norm, cfg.norm_eps)
        else:
            out = _logits(cp, x, cfg)
        return (out, cfg.moe_aux_weight * aux) if return_aux else out
