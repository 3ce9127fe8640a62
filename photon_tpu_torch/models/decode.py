"""The decoder's layer helpers and KV-cache decoding, in torch.

The port of ``photon_tpu/models/decode.py``. The per-layer helpers (norms
in fp32, RoPE at explicit positions, dense projections, the MLP, the
embedding and the logits) are shared by ``models/mpt.py``'s training
forward and the serving engine. On top of them:

- :func:`prefill`: one pass over right-padded prompts ``[B, S]`` that
  fills a contiguous :class:`DecodeState` (caches ``[L, B, S, H_kv, Dh]``
  and each row's cursor); its attention goes through
  ``ops/attention.py::multihead_attention`` with ``cfg.attn_impl``, so
  ``pallas`` runs the flash forward kernel (K1) on the card;
- :func:`decode_step`: one token a row against the cache (GQA straight
  against the ``H_kv`` heads, ALiBi distances, keys ``j <= pos``), after
  writing the token's k/v at the row's cursor in place. It attends through
  ``ragged_reference_attention``, the same dense function the paged
  engine's gather path runs over its live view, so paged and contiguous
  decode give the same bits at the same width;
- :func:`generate` and :func:`make_cached_generate_fn` (``.many``):
  greedy at temperature 0, else temperature / top-k sampling from a
  seeded ``torch.Generator`` (other draws than JAX's threefry streams);
  an optional ``eos_id`` freezes finished rows and ends the loop early.

Per-cohort LoRA: ``prefill`` and ``decode_step`` take ``adapters``, one
adapter a row (``{module: {"a": [B, L, d_in, r], "b": [B, L, r,
d_out]}}``, scaled by ``lora_scale``), so a mixed-cohort batch decodes in
one pass; the serving step gathers the same per-row factors from its
adapter pool, and this path is its contiguous oracle. Without
``adapters`` the graph is the base model's.

An MoE MLP (``cfg.mlp == "moe"``, ``ops/moe.py``) routes every token of a
call in one capacity pool, as in JAX: ``prefill`` passes its ``pos <
lengths`` mask so padding claims no capacity, and the decode steps pass
none. A row's output therefore depends on its batch-mates, and decode
agrees with another batching of the same rows only where no expert
overflows.

The JAX module shares one jitted prefill/step pair per config
(``decode_jit_pair``); eager torch has no trace to share, so that has no
counterpart here. Dtypes follow the JAX functions: activations in the
compute dtype, norms in fp32 and cast back, logits in ``logits_dtype``.
The JAX ``_dense`` casts its kernel to the activation dtype on every
call; the port casts the dense weights once (:func:`compute_params`),
which gives the same numbers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from photon_tpu_torch.config.schema import ModelConfig
from photon_tpu_torch.ops.attention import alibi_slopes, multihead_attention
from photon_tpu_torch.ops.moe import moe_mlp
from photon_tpu_torch.ops.ragged_paged_attention import ragged_reference_attention

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
    biases, embeddings, the head and the experts in the compute dtype; norm
    scales and biases and the MoE router stay fp32 (the JAX norms multiply
    in fp32, and its router reads its weight in fp32: a rounded router
    flips top-k choices). Serving makes it once at load; training makes it
    in every forward, inside autograd."""
    compute = torch_dtype(cfg.compute_dtype)

    def walk(node: dict, in_norm: bool) -> dict:
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val, in_norm or key.startswith("ln_"))
            else:
                dt = torch.float32 if in_norm or key == "router" else compute
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


def _lora_delta(ad: dict, h: torch.Tensor, scale: float) -> torch.Tensor:
    """The LoRA delta ``(h @ A) @ B · scale``, in ``h``'s dtype. ``ad["a"]``
    is ``[d_in, r]`` (one adapter for every row: the training model) or
    ``[B, d_in, r]`` (row b uses row b's adapter: a mixed-cohort serving
    batch and its contiguous oracle, which compute the same products);
    ``h`` is ``[B, T, d_in]``."""
    a, b = ad["a"], ad["b"]
    delta = (h @ a) @ b if a.dim() == 2 else torch.bmm(torch.bmm(h, a), b)
    return delta if scale == 1.0 else delta * scale


def _dense(lp: dict, name: str, h: torch.Tensor, la: dict | None = None,
           ls: float = 1.0) -> torch.Tensor:
    y = h @ lp[name]["kernel"]
    if "bias" in lp[name]:
        y = y + lp[name]["bias"]
    if la is not None and name in la:
        y = y + _lora_delta(la[name], h, ls)
    return y


def _qkv(lp: dict, h: torch.Tensor, cfg: ModelConfig, la: dict | None = None,
         ls: float = 1.0):
    """Project hidden → (q [..., H, Dh], k/v [..., H_kv, Dh]); ``la``: the
    layer's LoRA factors (:func:`_lora_delta`), scaled by ``ls``."""
    if "wqkv" in lp:
        q, k, v = torch.chunk(_dense(lp, "wqkv", h, la, ls), 3, dim=-1)
    else:
        q = _dense(lp, "q_proj", h, la, ls)
        k = _dense(lp, "k_proj", h, la, ls)
        v = _dense(lp, "v_proj", h, la, ls)
    lead = h.shape[:-1]
    return (q.reshape(*lead, cfg.n_heads, cfg.d_head),
            k.reshape(*lead, cfg.kv_heads, cfg.d_head),
            v.reshape(*lead, cfg.kv_heads, cfg.d_head))


def _mlp(lp: dict, x: torch.Tensor, cfg: ModelConfig,
         token_mask: torch.Tensor | None = None, la: dict | None = None,
         ls: float = 1.0) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The MLP half of a block: ``(x + mlp(norm(x)), the MoE aux loss or
    None)``. An MoE layer routes every token of ``x`` in one capacity pool
    (``ops/moe.py``); ``token_mask`` (nonzero = real token) keeps padding
    from claiming capacity, as the JAX prefill and serving step pass it."""
    h = _norm(x, lp["ln_2"]["scale"], lp["ln_2"].get("bias"), cfg.norm, cfg.norm_eps)
    if cfg.mlp == "moe":
        out, aux = moe_mlp(h, lp["router"], lp["moe_up"], lp["moe_down"],
                           w_gate=lp.get("moe_gate"), top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor, token_mask=token_mask)
        return x + out, aux
    if cfg.mlp == "swiglu":
        h = F.silu(_dense(lp, "gate_proj", h, la, ls)) * _dense(lp, "up_proj", h, la, ls)
    else:
        # the JAX package uses gelu(approximate=True): the tanh form
        h = F.gelu(_dense(lp, "up_proj", h, la, ls), approximate="tanh")
    return x + _dense(lp, "down_proj", h, la, ls), None


def _embed(params: dict, tokens: torch.Tensor, pos: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    x = params["wte"]["embedding"][tokens]
    if cfg.learned_pos_emb and not cfg.alibi and not cfg.rope:
        # positions past the table read its last row, as JAX's gather
        # clamps (a buffer wider than max_seq_len holds padding there)
        x = x + params["wpe"][torch.clamp(pos, max=params["wpe"].shape[0] - 1)]
    return x


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = _norm(x, params["ln_f"]["scale"], params["ln_f"].get("bias"), cfg.norm, cfg.norm_eps)
    compute = torch_dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        logits = x.to(compute) @ params["wte"]["embedding"].T
    else:
        logits = x.to(compute) @ params["lm_head"]["kernel"]
    return logits.to(torch_dtype(cfg.logits_dtype))


# ---------------------------------------------------------------------------
# contiguous KV-cache decoding
# ---------------------------------------------------------------------------

@dataclass
class DecodeState:
    """Per-layer post-RoPE k/v caches ``[L, B, S, H_kv, Dh]`` and each
    row's write cursor (its current token count)."""

    cache_k: torch.Tensor
    cache_v: torch.Tensor
    lengths: torch.Tensor  # [B] int32


def device_of(params) -> torch.device:
    """The device of the first tensor in ``params`` (the CPU for a model
    without parameters)."""
    node = params
    while isinstance(node, dict) and node:
        node = next(iter(node.values()))
    return node.device if isinstance(node, torch.Tensor) else torch.device("cpu")


def _layers(cp: dict, cfg: ModelConfig) -> list[dict]:
    return [layer_params(cp, i) for i in range(cfg.n_layers)]


def layer_adapters(adapters: dict | None, n_layers: int, dtype: torch.dtype,
                   device: torch.device) -> list[dict | None]:
    """Per-row adapters ``{module: {"a": [B, L, d_in, r], "b": [B, L, r,
    d_out]}}`` (numpy arrays or tensors) → one ``{module: {"a": [B, d_in,
    r], "b": [B, r, d_out]}}`` a layer, in ``dtype`` on ``device``, each
    layer's factors contiguous; ``None`` → ``None`` for every layer."""
    if adapters is None:
        return [None] * n_layers
    out: list[dict] = [{} for _ in range(n_layers)]
    for module, ab in adapters.items():
        for key, leaf in ab.items():
            src = torch.as_tensor(leaf, device=device).transpose(0, 1)
            t = torch.empty(src.shape, dtype=dtype, device=device).copy_(src)  # one cast+copy
            for li in range(n_layers):
                out[li].setdefault(module, {})[key] = t[li]
    return out


def _prefill(cp: dict, layers: list[dict], tokens: torch.Tensor, lengths: torch.Tensor,
             cfg: ModelConfig, las: list | None = None,
             ls: float = 1.0) -> tuple[torch.Tensor, DecodeState]:
    b, s = tokens.shape
    tokens = tokens.long()
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    impl = "xla" if cfg.attn_impl == "ring" else cfg.attn_impl  # one device: no ring
    lengths = torch.as_tensor(lengths, device=tokens.device).to(torch.int32)
    valid = pos < lengths[:, None]  # [B, S] real tokens
    x = _embed(cp, tokens, pos, cfg)
    ks, vs = [], []
    for lp, la in zip(layers, las or [None] * len(layers)):
        h = _norm(x, lp["ln_1"]["scale"], lp["ln_1"].get("bias"), cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(lp, h, cfg, la, ls)
        if cfg.rope:
            q, k = _rope_at(q, pos, cfg.rope_theta), _rope_at(k, pos, cfg.rope_theta)
        attn = multihead_attention(q, k, v, impl=impl, causal=True, alibi=cfg.alibi)
        x = x + _dense(lp, "out_proj", attn.reshape(b, s, cfg.d_model), la, ls)
        # padding claims no expert capacity
        x, _ = _mlp(lp, x, cfg, token_mask=valid, la=la, ls=ls)
        ks.append(k)
        vs.append(v)
    idx = torch.clamp(lengths.long() - 1, 0, s - 1)
    last = x[torch.arange(b, device=x.device), idx]
    return _logits(cp, last, cfg), DecodeState(torch.stack(ks), torch.stack(vs), lengths)


def prefill(params: dict, tokens: torch.Tensor, lengths: torch.Tensor,
            cfg: ModelConfig, adapters: dict | None = None,
            lora_scale: float = 1.0) -> tuple[torch.Tensor, DecodeState]:
    """Full pass over right-padded prompts ``tokens [B, S]`` → (next-token
    logits ``[B, V]`` at each row's cursor ``lengths - 1``, the filled
    :class:`DecodeState`). ``params``: the fp32 tree or its compute copy,
    on the tokens' device. ``adapters``: per-row LoRA factors ``{module:
    {"a": [B, L, d_in, r], "b": [B, L, r, d_out]}}`` scaled by
    ``lora_scale`` (row b runs with row b's adapter: a mixed-cohort batch
    in one pass); ``None`` runs the base alone."""
    cp = compute_params(params, cfg, tokens.device)
    las = layer_adapters(adapters, cfg.n_layers, torch_dtype(cfg.compute_dtype), tokens.device)
    return _prefill(cp, _layers(cp, cfg), tokens, lengths, cfg, las, lora_scale)


def _write_cache(cache: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                 new: torch.Tensor) -> None:
    """``cache[rows[i], pos[i]] = new[i]`` in place (one layer's
    ``[B, S, H_kv, Dh]``)."""
    cache.index_put_((rows, pos), new.to(cache.dtype))


def decode_layers(cp: dict, layers: list[dict], token: torch.Tensor, pos: torch.Tensor,
                  cfg: ModelConfig, write_and_view: Callable, las: list | None = None,
                  ls: float = 1.0) -> torch.Tensor:
    """One token a row (``token [B]`` at positions ``pos [B]``) through
    every layer → the logits ``[B, V]`` for the following position. Per
    layer ``write_and_view(layer, k_new, v_new)`` stores the token's k/v
    (``[B, H_kv, Dh]``) and returns that layer's keys and values as
    ``[B, S, H_kv, Dh]`` views, which are attended over ``j <= pos``
    densely. Contiguous decode passes its cache, the paged oracle its
    gathered live blocks: one computation, so at one width they give the
    same bits."""
    b = token.shape[0]
    x = _embed(cp, token.long()[:, None], pos.long()[:, None], cfg)  # [B, 1, D]
    scale = 1.0 / math.sqrt(cfg.d_head)
    slopes = alibi_slopes(cfg.n_heads, token.device) if cfg.alibi else None
    for li, (lp, la) in enumerate(zip(layers, las or [None] * len(layers))):
        h = _norm(x, lp["ln_1"]["scale"], lp["ln_1"].get("bias"), cfg.norm, cfg.norm_eps)
        q, k_new, v_new = _qkv(lp, h, cfg, la, ls)  # [B, 1, H, Dh]
        if cfg.rope:
            q = _rope_at(q, pos[:, None], cfg.rope_theta)
            k_new = _rope_at(k_new, pos[:, None], cfg.rope_theta)
        kb, vb = write_and_view(li, k_new[:, 0], v_new[:, 0])
        out = ragged_reference_attention(q, kb, vb, pos[:, None].int(), scale=scale,
                                         slopes=slopes)
        x = x + _dense(lp, "out_proj", out.reshape(b, 1, cfg.d_model), la, ls)
        x, _ = _mlp(lp, x, cfg, la=la, ls=ls)  # no mask: every row routes, as the JAX decode step
    return _logits(cp, x[:, 0], cfg)


def _decode_step(cp: dict, layers: list[dict], state: DecodeState, token: torch.Tensor,
                 cfg: ModelConfig, las: list | None = None,
                 ls: float = 1.0) -> tuple[torch.Tensor, DecodeState]:
    rows = torch.arange(token.shape[0], device=token.device)
    # callers keep every cursor below S (``many`` checks)
    wpos = torch.clamp(state.lengths.long(), max=state.cache_k.shape[2] - 1)

    def write_and_view(li, k_new, v_new):
        ck, cv = state.cache_k[li], state.cache_v[li]
        _write_cache(ck, rows, wpos, k_new)
        _write_cache(cv, rows, wpos, v_new)
        return ck, cv

    logits = decode_layers(cp, layers, token, state.lengths, cfg, write_and_view, las, ls)
    return logits, DecodeState(state.cache_k, state.cache_v, state.lengths + 1)


def decode_step(params: dict, state: DecodeState, token: torch.Tensor,
                cfg: ModelConfig, adapters: dict | None = None,
                lora_scale: float = 1.0) -> tuple[torch.Tensor, DecodeState]:
    """Place ``token [B]`` at each row's cursor (the caches are written in
    place), attend over keys ``j <= pos``, and return (the logits for the
    following position, the state with every cursor advanced). Each
    cursor must be below the cache width ``S``. ``adapters``: per-row LoRA
    factors as in :func:`prefill`."""
    cp = compute_params(params, cfg, token.device)
    las = layer_adapters(adapters, cfg.n_layers, torch_dtype(cfg.compute_dtype), token.device)
    return _decode_step(cp, _layers(cp, cfg), state, token, cfg, las, lora_scale)


def generate(params: dict, tokens: torch.Tensor, lengths: torch.Tensor,
             cfg: ModelConfig, max_new_tokens: int, *, temperature: float = 0.0,
             top_k: int = 0, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shot :func:`make_cached_generate_fn` ``.many``: greedy argmax at
    ``temperature == 0``, else a draw from logits / temperature, cut to the
    ``top_k`` highest first when ``top_k`` is set."""
    fn = make_cached_generate_fn(cfg, params)
    return fn.many(tokens, lengths, max_new_tokens, temperature=temperature,
                   top_k=top_k, seed=seed)


class CachedGenerateFn:
    """``.many(tokens, lengths, n)`` prefills once and decodes ``n`` tokens
    through the cache; calling it runs one full-forward greedy step
    ``(tokens, lengths) -> (tokens, lengths)``, for which it needs the
    ``model_apply`` it was made with."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 model_apply: Callable | None = None) -> None:
        from photon_tpu_torch.eval.icl import make_generate_fn

        self.cfg = cfg
        self.device = device_of(params)
        self._one_step = (make_generate_fn(model_apply, params)
                          if model_apply is not None else None)
        self._cp = compute_params(params, cfg, self.device)
        self._layers = _layers(self._cp, cfg)

    def __call__(self, tokens, lengths):
        if self._one_step is None:
            raise ValueError("one-step decode needs model_apply at construction; "
                             "use .many for the cached path")
        return self._one_step(tokens, lengths)

    def _pick(self, logits: torch.Tensor, gen: torch.Generator, temperature: float,
              top_k: int) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        scaled = logits.float() / temperature
        if top_k:
            kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
            scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        return torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=gen)[:, 0]

    @torch.inference_mode()
    def many(self, tokens, lengths, n: int, *, temperature: float = 0.0, top_k: int = 0,
             seed: int = 0, eos_id: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode up to ``n`` tokens into the buffer ``tokens [B, S]`` at
        each row's cursor. Refuses ``max(lengths) + n > S``: past the
        buffer's end the cache has no room.

        ``eos_id`` arms per-row early exit: a row that emits ``eos_id``
        (the EOS is written) is frozen (no further writes, its returned
        length stops) and the loop ends once every row is done, at the
        cost of one device-to-host read a step."""
        from photon_tpu_torch.eval.icl import write_at_cursor

        tokens = torch.as_tensor(tokens).to(self.device)
        lengths = torch.as_tensor(lengths).to(self.device)
        top = int(lengths.max())
        if top + n > tokens.shape[1]:
            raise ValueError(f"decode overflow: max length {top} + {n} new tokens > "
                             f"buffer {tokens.shape[1]}")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        logits, st = _prefill(self._cp, self._layers, tokens, lengths, self.cfg)
        done = None if eos_id is None else torch.zeros(tokens.shape[0], dtype=torch.bool,
                                                       device=self.device)
        produced = torch.zeros_like(lengths)
        for i in range(n):
            nxt = self._pick(logits, gen, temperature, top_k).to(tokens.dtype)
            if done is None:
                tokens = write_at_cursor(tokens, st.lengths, nxt)
            else:
                # finished rows keep their bytes (their cache cursor still
                # advances, but nothing they produce is observable)
                tokens = torch.where(done[:, None], tokens,
                                     write_at_cursor(tokens, st.lengths, nxt))
                produced = produced + (~done).to(produced.dtype)
                done = done | (nxt == eos_id)
                if i < n - 1 and bool(done.all()):
                    break
            if i < n - 1:  # the last token's successor logits are unused
                logits, st = _decode_step(self._cp, self._layers, st, nxt, self.cfg)
        if done is None:
            produced = torch.full_like(lengths, n)
        return tokens, torch.clamp(lengths + produced, max=tokens.shape[1])


def make_cached_generate_fn(cfg: ModelConfig, params: dict,
                            model_apply: Callable | None = None) -> CachedGenerateFn:
    """The KV-cache decoder over ``params`` (on their device), with the
    one-step full-forward call when ``model_apply(params, tokens)`` is
    given."""
    return CachedGenerateFn(cfg, params, model_apply)
