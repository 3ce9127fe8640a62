"""Per-layer helpers of the decoder, in torch, shared by serving and training.

The port of the helpers ``photon_tpu/serve/cache.py`` imports from
``photon_tpu/models/decode.py``: norms in fp32, RoPE at explicit
positions, dense projections, the MLP, the embedding and the logits.
``models/mpt.py``'s training forward runs the same helpers.
``prefill``, ``decode_step`` and ``generate`` wait for the decode slice.

Dtypes follow the JAX functions: activations run in the compute dtype,
norms compute in fp32 and cast back, logits cast to ``logits_dtype``. The
JAX ``_dense`` casts its kernel to the activation dtype on every call; the
port casts the dense weights once, at load (:func:`compute_params`), which
gives the same numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from photon_tpu_torch.config.schema import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def compute_params(params: dict, cfg: ModelConfig,
                   device: torch.device) -> dict:
    """The compute copy of ``params`` on ``device``: dense kernels and
    biases, embeddings and the head in the compute dtype; norm scales and
    biases stay fp32 (the JAX norms multiply in fp32). Serving makes it once
    at load; training makes it in every forward, inside autograd."""
    compute = torch_dtype(cfg.compute_dtype)

    def walk(node: dict, in_norm: bool) -> dict:
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val, in_norm or key.startswith("ln_"))
            else:
                dt = torch.float32 if in_norm else compute
                out[key] = val.to(device=device, dtype=dt)
        return out

    return walk(params, False)


def layer_params(params: dict, layer: int) -> dict:
    """Views of layer ``layer`` of the stacked ``blocks/block`` subtree."""

    def pick(node):
        return {k: pick(v) if isinstance(v, dict) else v[layer] for k, v in node.items()}

    return pick(params["blocks"]["block"])


def _norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
          kind: str, eps: float) -> torch.Tensor:
    """fp32 LayerNorm (scale-only when ``bias`` is None) or RMSNorm, cast
    back to ``x``'s dtype: one fused kernel each way on the card."""
    x32 = x.float()
    shape = (x.shape[-1],)
    if kind == "rmsnorm":
        y = F.rms_norm(x32, shape, scale, eps)
    else:
        y = F.layer_norm(x32, shape, scale, bias, eps)
    return y.to(x.dtype)


def _rope_at(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``[B, T, H, D]`` vectors at positions ``pos [B, T]`` (fp32
    angles, rotate-half convention)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = pos.float()[..., None] * inv  # [B, T, half]
    cos = torch.cos(ang)[..., None, :]  # [B, T, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _dense(lp: dict, name: str, h: torch.Tensor) -> torch.Tensor:
    y = h @ lp[name]["kernel"]
    if "bias" in lp[name]:
        y = y + lp[name]["bias"]
    return y


def _qkv(lp: dict, h: torch.Tensor, cfg: ModelConfig):
    """Project hidden → (q [..., H, Dh], k/v [..., H_kv, Dh])."""
    if "wqkv" in lp:
        q, k, v = torch.chunk(_dense(lp, "wqkv", h), 3, dim=-1)
    else:
        q = _dense(lp, "q_proj", h)
        k = _dense(lp, "k_proj", h)
        v = _dense(lp, "v_proj", h)
    lead = h.shape[:-1]
    return (q.reshape(*lead, cfg.n_heads, cfg.d_head),
            k.reshape(*lead, cfg.kv_heads, cfg.d_head),
            v.reshape(*lead, cfg.kv_heads, cfg.d_head))


def _mlp(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = _norm(x, lp["ln_2"]["scale"], lp["ln_2"].get("bias"), cfg.norm, cfg.norm_eps)
    if cfg.mlp == "swiglu":
        h = F.silu(_dense(lp, "gate_proj", h)) * _dense(lp, "up_proj", h)
    elif cfg.mlp == "gelu":
        # the JAX package uses gelu(approximate=True): the tanh form
        h = F.gelu(_dense(lp, "up_proj", h), approximate="tanh")
    else:
        raise NotImplementedError(f"mlp {cfg.mlp!r} is not served here")
    return x + _dense(lp, "down_proj", h)


def _embed(params: dict, tokens: torch.Tensor, pos: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    x = params["wte"]["embedding"][tokens]
    if cfg.learned_pos_emb and not cfg.alibi and not cfg.rope:
        x = x + params["wpe"][pos]
    return x


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = _norm(x, params["ln_f"]["scale"], params["ln_f"].get("bias"), cfg.norm, cfg.norm_eps)
    compute = torch_dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        logits = x.to(compute) @ params["wte"]["embedding"].T
    else:
        logits = x.to(compute) @ params["lm_head"]["kernel"]
    return logits.to(torch_dtype(cfg.logits_dtype))
