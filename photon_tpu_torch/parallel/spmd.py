"""The train step over a mesh: the port's stand-in for GSPMD.

The JAX package jits one train step with sharded inputs and lets GSPMD
partition it over the mesh. This module writes the partitioned program
out by hand, for one process driving every position
(``parallel/mesh.py`` says why):

- **State.** Each parameter is a :class:`~photon_tpu_torch.parallel.
  sharding.ShardedTensor` laid out by the rule table: every distinct shard
  once, on the device of the first position that holds it. The optimizer
  moments take the specs of ``state_shardings`` (JAX's shape lookup).
- **Batch.** A microbatch's rows split over ``data × fsdp × expert``
  (the batch axes) and its tokens over ``sequence`` (``batch_spec``):
  position ``(d, f, t, s, e)`` works on row group ``r = (d·fsdp + f)·expert
  + e`` and sequence chunk ``s``. A group ``(r, s)`` keeps its residual
  stream on its home device, the device of position ``(d, f, 0, s, e)``.
- **Layers, synchronously over the positions.** For each layer the
  weights are gathered to each device that needs them (``fsdp`` and
  ``tensor`` shards concatenated, cast to the compute dtype; inside
  ``checkpoint`` under ``remat``, so whole weights are not kept across
  layers). Under ``tensor`` each position computes its slice of the heads
  and of the MLP's hidden columns; the partial products of ``out_proj``
  and ``down_proj`` are summed over the tensor positions in rank order
  (:func:`_tensor_sum`) and the bias added once. Attention runs per
  ``(r, t)`` group through ``ring_chunks`` (``ops/ring_attention.py``):
  the ring over its ``sequence`` positions, the flash kernels alone on
  one position, the dense chunks under ``xla``.
- **LoRA.** The factors ``*_lora_a [L, d_in, r]`` and ``*_lora_b [L, r,
  d_out]`` are replicated (no rule matches them, JAX's fallback) and cast
  to the compute dtype. A column-parallel target adds ``(h @ A) @ B[:,
  cols] · α/r`` on the columns its kernel takes; a row-parallel one
  (``out_proj``, ``down_proj``) adds ``(a_t @ A[rows_t]) @ B · α/r`` to
  its part before the tensor sum, so the parts sum to JAX's term.
- **MoE, batch-global.** GSPMD routes the whole microbatch as one
  capacity pool, so the groups' router probabilities are put into the
  global ``[B, S]`` order and routed once (``ops/moe.py``'s ``route``:
  one capacity, slot-major claims in global token order, one Switch aux);
  expert position ``j`` runs only its ``E / expert`` experts on the kept
  rows, each tensor position its hidden columns, and the gated outputs go
  back to each token's home device. Per-position routing would fill each
  position's pool apart.
- **Pipeline stages.** ``MeshModel(cfg, mesh, stage)`` is one stage of
  ``parallel/pipeline.py``: the positions whose ``pipe`` index is
  ``stage`` and their slab of the layers (the layer axis sharded over
  ``pipe``).
- **Positions are global.** ``wpe``, RoPE and the ALiBi distances use a
  token's position in the whole sequence (:func:`_global_positions`), and
  ALiBi a head's slope in the whole head table.
- **Loss.** Targets shift across chunk boundaries (the last token of
  chunk ``s`` predicts the first of chunk ``s + 1``), and the mean is over
  the global ``B × (S − 1)``; each group's cross entropy is computed once,
  on its home device.
- **Gradients.** ``backward`` through the gathers, the ``.to`` moves and
  the sums supplies GSPMD's transposes: the reduce-scatter to each fsdp
  shard and the data-parallel sum over the positions that share a shard.
- **Optimizer.** Each moment shard is updated with the matching region of
  its parameter and gradient, on its own device, through the optimizer's
  own ``apply`` (so clipping and the schedule are the single-device
  code's); ``grad_norm``, the clip and ``param_norm`` count each distinct
  shard once. A leaf the optimizer freezes has no moments, no update, no
  weight decay and no share of the clip's norm (optax's
  ``set_to_zero`` under ``multi_transform``); under LoRA its shards take
  no gradient at all, as on one device.

With ``cuda:0`` named at every position the card holds one copy of each
shard and one gathered copy of a layer's weights a step; positions differ
only in the slice they compute.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from photon_tpu_torch.config.schema import ModelConfig
from photon_tpu_torch.models.decode import _norm, _rope_at, torch_dtype
from photon_tpu_torch.ops.attention import alibi_slopes
from photon_tpu_torch.ops.moe import Routing, _experts, _router_probs, expert_capacity, route
from photon_tpu_torch.ops.ring_attention import ring_chunks
from photon_tpu_torch.optim.build import Optimizer, global_norm
from photon_tpu_torch.parallel.mesh import Mesh
from photon_tpu_torch.parallel.sharding import (
    ShardedTensor,
    position_coords,
    shard_params,
    shard_region,
    state_shardings,
)
from photon_tpu_torch.train.train_step import _ChunkedCE

BLK = "blocks/block/"


@dataclasses.dataclass
class MeshTrainState:
    """The meshed counterpart of ``TrainState``: ``params`` and the
    moments of ``opt_state`` are :class:`ShardedTensor`; the optimizer's
    counters are host scalars, as on one device."""

    step: int
    params: dict[str, ShardedTensor]
    opt_state: dict


def _global_positions(s: int, s_local: int, device: torch.device) -> torch.Tensor:
    """Positions ``[1, s_local]`` of sequence chunk ``s`` in the whole sequence."""
    return torch.arange(s * s_local, (s + 1) * s_local, device=device)[None]


def _tensor_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """The all-reduce over the ``tensor`` positions: their partial
    products summed in rank order (each already on the group's device)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class MeshModel:
    """The forward and loss of ``models/mpt.py`` over a mesh, position by
    position (``cfg`` is the effective model config: ``ring`` on a
    sequence mesh). ``stage`` picks the positions of one pipeline stage
    (``parallel/pipeline.py``) and their slab of the layers; with
    ``pipe = 1`` stage 0 is the whole mesh and every layer."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, stage: int = 0) -> None:
        sh = mesh.shape
        self.cfg, self.mesh = cfg, mesh
        self.n_t, self.n_s, self.n_e = sh["tensor"], sh["sequence"], sh["expert"]
        self.n_r = sh["data"] * sh["fsdp"] * sh["expert"]
        if cfg.n_heads % self.n_t or cfg.hidden % self.n_t:
            raise ValueError(f"mesh.tensor={self.n_t} must divide n_heads={cfg.n_heads} and "
                             f"the MLP width {cfg.hidden}")
        per_stage = cfg.n_layers // sh["pipe"]
        self.layers = range(stage * per_stage, (stage + 1) * per_stage)
        self.compute = torch_dtype(cfg.compute_dtype)
        #: device of position (r, t, s) of this stage
        self.dev: dict[tuple, torch.device] = {}
        for c, d in zip(position_coords(mesh), mesh.devices.flat):
            if c["pipe"] == stage:
                r = (c["data"] * sh["fsdp"] + c["fsdp"]) * sh["expert"] + c["expert"]
                self.dev[r, c["tensor"], c["sequence"]] = torch.device(d)
        self.home = {(r, s): self.dev[r, 0, s] for r in range(self.n_r) for s in range(self.n_s)}
        self.first = self.home[0, 0]
        self.devices = list(dict.fromkeys(self.dev.values()))
        self.slopes = alibi_slopes(cfg.n_heads) if cfg.alibi else None
        self.lora_scale = cfg.lora_alpha / cfg.lora_rank if cfg.lora_rank else 1.0

    # -- weights ---------------------------------------------------------
    def _cast(self, name: str) -> torch.dtype:
        """Norms and the MoE router stay fp32 (as ``compute_params``); the
        LoRA factors take the compute dtype, as JAX's ``astype(h.dtype)``."""
        return torch.float32 if "/ln_" in "/" + name or name.endswith("router") else self.compute

    def _gather(self, params: dict, names: list[str], layer: int | None) -> dict:
        """``{device: {name: whole weight}}`` for every device of the stage:
        layer ``layer`` of stacked block weights (or whole top-level ones),
        cast to the compute dtype (norms and the router fp32) before they
        move."""
        out: dict = {}
        for dev in self.devices:
            w = {}
            for n in names:
                st, dt = params[n], self._cast(n)
                if layer is None:
                    w[n] = st.full(dev, lambda t, dt=dt: t.to(dt))
                else:
                    w[n] = _layer_full(st, layer, dev, dt)
            out[dev] = w
        return out

    # -- attention pieces ------------------------------------------------
    def _qkv(self, w: dict, h: torch.Tensor, t: int):
        """Position ``t``'s q heads and the kv heads they read, from the
        gathered projections (kv repeated up to the q heads first when the
        kv heads do not split over ``tensor``)."""
        cfg = self.cfg
        H, Hkv, Dh, n_t = cfg.n_heads, cfg.kv_heads, cfg.d_head, self.n_t
        hq = H // n_t
        lead = h.shape[:-1]
        ha: dict = {}  # h @ A of each adapted projection, made once

        def proj(name, cols):
            y = h @ w[BLK + name + "/kernel"][:, cols]
            bias = w.get(BLK + name + "/bias")
            y = y if bias is None else y + bias[cols]
            return self._lora_col(w, name, y, h, cols, ha)

        if BLK + "wqkv/kernel" in w:
            d_q = H * Dh
            if n_t == 1:  # one product, as on one device
                q, k, v = torch.chunk(proj("wqkv", slice(None)), 3, dim=-1)
                return (q.reshape(*lead, H, Dh), k.reshape(*lead, H, Dh),
                        v.reshape(*lead, H, Dh))
            sl = slice(t * hq * Dh, (t + 1) * hq * Dh)
            q = proj("wqkv", sl)
            k = proj("wqkv", slice(d_q + sl.start, d_q + sl.stop))
            v = proj("wqkv", slice(2 * d_q + sl.start, 2 * d_q + sl.stop))
            return (q.reshape(*lead, hq, Dh), k.reshape(*lead, hq, Dh),
                    v.reshape(*lead, hq, Dh))
        q = proj("q_proj", slice(t * hq * Dh, (t + 1) * hq * Dh)).reshape(*lead, hq, Dh)
        if Hkv % n_t == 0:
            kv = Hkv // n_t
            cols = slice(t * kv * Dh, (t + 1) * kv * Dh)
            k = proj("k_proj", cols).reshape(*lead, kv, Dh)
            v = proj("v_proj", cols).reshape(*lead, kv, Dh)
            return q, k, v
        every = slice(0, Hkv * Dh)
        heads = slice(t * hq, (t + 1) * hq)
        k = proj("k_proj", every).reshape(*lead, Hkv, Dh).repeat_interleave(H // Hkv, 2)
        v = proj("v_proj", every).reshape(*lead, Hkv, Dh).repeat_interleave(H // Hkv, 2)
        return q, k[..., heads, :], v[..., heads, :]

    def _attend(self, qs: list, ks: list, vs: list, t: int) -> list:
        """Attention of one ``(r, t)`` group over its sequence positions:
        :func:`~photon_tpu_torch.ops.ring_attention.ring_chunks`, the
        per-group step of ``ring_attention`` and of the sharded flash path
        (one chunk: K1 at offset 0; the dense chunks under ``xla``)."""
        hq = self.cfg.n_heads // self.n_t
        slopes = None if self.slopes is None else self.slopes[t * hq:(t + 1) * hq]
        impl = "xla" if self.cfg.attn_impl == "xla" else "pallas"
        return ring_chunks(qs, ks, vs, causal=True, impl=impl, slopes=slopes)

    # -- LoRA ------------------------------------------------------------
    def _lora_col(self, w: dict, name: str, y: torch.Tensor, h: torch.Tensor, cols: slice,
                  ha: dict | None = None) -> torch.Tensor:
        """A column-parallel projection ``y`` on columns ``cols`` with its
        LoRA term: ``y + ((h @ A) @ B[:, cols]) · α/r`` (``y`` when
        ``name`` is not adapted); ``ha`` caches ``h @ A`` by name across the
        slices of one position."""
        a = w.get(BLK + name + "_lora_a")
        if a is None:
            return y
        ha = {} if ha is None else ha
        if name not in ha:
            ha[name] = h @ a
        return y + (ha[name] @ _lora_b_cols(w[BLK + name + "_lora_b"], cols)) * self.lora_scale

    def _lora_row(self, w: dict, name: str, y: torch.Tensor, a_t: torch.Tensor,
                  rows: slice) -> torch.Tensor:
        """A row-parallel projection's LoRA part at the position holding
        the input columns ``rows``, added to its kernel part ``y``:
        ``y + ((a_t @ A[rows]) @ B) · α/r`` (``y`` when ``name`` is not
        adapted). The parts join the kernel's before the tensor sum, which
        is linear, so they add up to ``(h @ A) @ B``."""
        a = w.get(BLK + name + "_lora_a")
        if a is None:
            return y
        return y + ((a_t @ a[rows]) @ w[BLK + name + "_lora_b"]) * self.lora_scale

    # -- the layer over every position -----------------------------------
    def _layer(self, params: dict, names: list[str], layer: int, *xs: torch.Tensor):
        """One layer over the stage's groups: ``(*outputs, MoE aux)`` (the
        aux an fp32 zero for a dense MLP)."""
        cfg = self.cfg
        n_t, n_s = self.n_t, self.n_s
        groups = list(self.home)
        x = dict(zip(groups, xs))
        W = self._gather(params, names, layer)
        hq, dh = cfg.n_heads // n_t, cfg.d_head
        s_loc = xs[0].shape[1]
        q, k, v = {}, {}, {}
        h1 = {g: self._ln(W[self.home[g]], "ln_1", x[g]) for g in groups}
        for (r, t, s), dev in self.dev.items():
            q[r, t, s], k[r, t, s], v[r, t, s] = self._qkv(W[dev], h1[r, s].to(dev), t)
            if cfg.rope:
                pos = _global_positions(s, s_loc, dev)
                q[r, t, s] = _rope_at(q[r, t, s], pos, cfg.rope_theta)
                k[r, t, s] = _rope_at(k[r, t, s], pos, cfg.rope_theta)
        o = {}
        for r in range(self.n_r):
            for t in range(n_t):
                outs = self._attend([q[r, t, s] for s in range(n_s)],
                                    [k[r, t, s] for s in range(n_s)],
                                    [v[r, t, s] for s in range(n_s)], t)
                for s in range(n_s):
                    o[r, t, s] = outs[s]
        xr, h2 = {}, {}
        for (r, s) in groups:
            home = W[self.home[r, s]]
            parts = []
            for t in range(n_t):
                w = W[self.dev[r, t, s]]
                a = o[r, t, s].reshape(*o[r, t, s].shape[:2], hq * dh)
                rows = _cols(t, hq * dh)
                y = self._lora_row(w, "out_proj", a @ w[BLK + "out_proj/kernel"][rows], a, rows)
                parts.append(y.to(self.home[r, s]))
            y = _tensor_sum(parts)
            if BLK + "out_proj/bias" in home:
                y = y + home[BLK + "out_proj/bias"]
            xr[r, s] = x[r, s] + y
            h2[r, s] = self._ln(home, "ln_2", xr[r, s])
        if cfg.mlp == "moe":
            y, aux = self._moe(W, h2)
        else:
            y = self._mlp(W, h2)
            aux = torch.zeros((), dtype=torch.float32, device=self.first)
        return (*[xr[g] + y[g] for g in groups], aux)

    def _ln(self, w: dict, which: str, y: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return _norm(y, w[BLK + which + "/scale"], w.get(BLK + which + "/bias"), cfg.norm,
                     cfg.norm_eps)

    def _mlp(self, W: dict, h2: dict) -> dict:
        """The dense MLP of each group: each tensor position's hidden
        columns, the down-projection's parts summed in rank order on the
        group's home device, the bias added once."""
        cfg = self.cfg
        hid = cfg.hidden // self.n_t
        out = {}
        for (r, s), h in h2.items():
            home = W[self.home[r, s]]
            parts = []
            for t in range(self.n_t):
                dev = self.dev[r, t, s]
                w, hh = W[dev], h.to(dev)

                def col(name, w=w, hh=hh, t=t):
                    cols = _cols(t, hid)
                    y = hh @ w[BLK + name + "/kernel"][:, cols]
                    bias = w.get(BLK + name + "/bias")
                    y = y if bias is None else y + bias[cols]
                    return self._lora_col(w, name, y, hh, cols)

                if cfg.mlp == "swiglu":
                    a = F.silu(col("gate_proj")) * col("up_proj")
                else:
                    a = F.gelu(col("up_proj"), approximate="tanh")
                rows = _cols(t, hid)
                y = self._lora_row(w, "down_proj", a @ w[BLK + "down_proj/kernel"][rows], a, rows)
                parts.append(y.to(self.home[r, s]))
            y = _tensor_sum(parts)
            if BLK + "down_proj/bias" in home:
                y = y + home[BLK + "down_proj/bias"]
            out[r, s] = y
        return out

    def _moe(self, W: dict, h2: dict) -> tuple[dict, torch.Tensor]:
        """The MoE MLP over the stage's microbatch as one capacity pool, as
        GSPMD computes it: each group's router probabilities, put into the
        global ``[B, S]`` order and routed once (:func:`_global_route`);
        the kept tokens copied into the ``[E·C, D]`` buffer; expert
        position ``j`` runs experts ``j·E/expert .. (j+1)·E/expert`` on
        their rows, each tensor position its hidden columns, the
        down-projection's parts summed in rank order; each token's gated
        outputs combined and sent back to its group's home device. Returns
        ``(outputs by group, the layer's Switch aux)``."""
        cfg = self.cfg
        first = self.first
        e, k = cfg.moe_num_experts, cfg.moe_top_k
        probs = {g: _router_probs(h, W[self.home[g]][BLK + "router"]) for g, h in h2.items()}
        routing, cap = _global_route(probs, self.n_r, self.n_s, k, cfg.moe_capacity_factor,
                                     first)
        x = _global_order({g: h.to(first) for g, h in h2.items()}, self.n_r, self.n_s)
        n, d = x.shape
        row = torch.where(routing.kept, routing.expert * cap + routing.position,
                          e * cap).reshape(-1)  # [k·N]
        buf = x.new_zeros((e * cap + 1, d)).index_copy(0, row, x.expand(k, n, d).reshape(k * n, d))
        per, hid = e // self.n_e, cfg.hidden // self.n_t
        rows = []
        for j in range(self.n_e):
            xin = buf[j * per * cap:(j + 1) * per * cap].view(per, cap, d)
            es = slice(j * per, (j + 1) * per)
            parts = []
            for t in range(self.n_t):
                dev = self.dev[j, t, 0]  # position (data 0, fsdp 0, expert j, tensor t)
                w, cs = W[dev], _cols(t, hid)
                gate = w.get(BLK + "moe_gate")
                parts.append(_experts(xin.to(dev), w[BLK + "moe_up"][es, :, cs],
                                      w[BLK + "moe_down"][es, cs, :],
                                      None if gate is None else gate[es, :, cs]).to(first))
            rows.append(_tensor_sum(parts).reshape(per * cap, d))
        out_rows = torch.cat(rows + [rows[0].new_zeros((1, d))])
        picked = out_rows.index_select(0, row).view(k, n, d)
        g = routing.gates.to(x.dtype).float()[..., None]
        out = (g * picked.float()).sum(dim=0).to(x.dtype)
        b_loc, s_loc = h2[0, 0].shape[:2]
        out = out.view(self.n_r * b_loc, self.n_s * s_loc, d)
        return ({(r, s): out[r * b_loc:(r + 1) * b_loc, s * s_loc:(s + 1) * s_loc]
                 .to(self.home[r, s]) for (r, s) in h2}, routing.aux)

    # -- the stage's pieces ----------------------------------------------
    def embed(self, params: dict, tokens: dict) -> tuple:
        """Each group's embedded tokens ``[b, s_local, d]`` on its home
        device (``wpe`` at global positions); ``tokens[device]`` is the
        microbatch ``[B, S]`` on that device."""
        W = self._gather(params, [n for n in ("wte/embedding", "wpe") if n in params], None)
        b, seq = next(iter(tokens.values())).shape
        if b % self.n_r or seq % self.n_s:
            raise ValueError(f"batch {b} x seq {seq} does not split over {self.n_r} row "
                             f"groups x {self.n_s} sequence positions")
        b_loc, s_loc = b // self.n_r, seq // self.n_s
        xs = []
        for (r, s), dev in self.home.items():
            tok = tokens[dev][r * b_loc:(r + 1) * b_loc, s * s_loc:(s + 1) * s_loc]
            x = W[dev]["wte/embedding"][tok]
            if "wpe" in W[dev]:
                wpe = W[dev]["wpe"]
                pos = _global_positions(s, s_loc, dev)
                x = x + wpe[torch.clamp(pos, max=wpe.shape[0] - 1)]
            xs.append(x)
        return tuple(xs)

    def blocks(self, params: dict, xs: tuple) -> tuple[tuple, torch.Tensor]:
        """The stage's layers over ``xs``: ``(outputs, Σ the layers' MoE
        aux)``; under ``remat`` each layer is a ``checkpoint``."""
        block = sorted(n for n in params if n.startswith(BLK))
        aux = torch.zeros((), dtype=torch.float32, device=self.first)
        for i in self.layers:
            if self.cfg.remat:
                *xs, a = checkpoint(self._layer, params, block, i, *xs, use_reentrant=False)
            else:
                *xs, a = self._layer(params, block, i, *xs)
            aux = aux + a
        return tuple(xs), aux

    def _output_embedding(self, params: dict, dev: torch.device) -> torch.Tensor:
        """``[vocab, d_model]`` in the compute dtype on ``dev``."""
        if self.cfg.tie_embeddings:
            return params["wte/embedding"].full(dev, lambda t: t.to(self.compute))
        return params["lm_head/kernel"].full(dev, lambda t: t.to(self.compute)).T

    def head_ce(self, params: dict, xs: tuple, tokens: dict,
                loss_chunk_tokens: int) -> torch.Tensor:
        """The final norm and the summed next-token cross entropy of the
        groups' outputs ``xs``, targets shifted across the sequence chunks,
        on the stage's first device."""
        cfg = self.cfg
        W = self._gather(params, [n for n in params if n.startswith("ln_f/")], None)
        b, seq = next(iter(tokens.values())).shape
        b_loc, s_loc = b // self.n_r, seq // self.n_s
        emb = {dev: self._output_embedding(params, dev) for dev in dict.fromkeys(self.home.values())}
        total = None
        for ((r, s), dev), x in zip(self.home.items(), xs):
            h = _norm(x, W[dev]["ln_f/scale"], W[dev].get("ln_f/bias"), cfg.norm, cfg.norm_eps)
            tgt = tokens[dev][r * b_loc:(r + 1) * b_loc, s * s_loc + 1:(s + 1) * s_loc + 1]
            h = h[:, :tgt.shape[1]]  # the last chunk's last token has no target
            if loss_chunk_tokens:
                ce = _ChunkedCE.apply(h.reshape(-1, h.shape[-1]), emb[dev].to(h.dtype),
                                      tgt.reshape(-1), loss_chunk_tokens)
            else:
                logits = (h.to(self.compute) @ emb[dev].T).to(torch_dtype(cfg.logits_dtype))
                ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                                     tgt.reshape(-1), reduction="sum")
            ce = ce.to(self.first)
            total = ce if total is None else total + ce
        return total

    def ce_sum(self, params: dict, tokens: dict,
               loss_chunk_tokens: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``(summed cross entropy, Σ the layers' MoE aux)`` of one
        microbatch over the whole mesh (``pipe = 1``), on the first
        position's device."""
        xs, aux = self.blocks(params, self.embed(params, tokens))
        return self.head_ce(params, xs, tokens, loss_chunk_tokens), aux

    def loss(self, params: dict, tokens: dict, loss_chunk_tokens: int) -> torch.Tensor:
        """Mean next-token cross entropy over the global ``B × (S − 1)``,
        plus the weighted MoE aux, as the single-device loss."""
        b, seq = next(iter(tokens.values())).shape
        ce, aux = self.ce_sum(params, tokens, loss_chunk_tokens)
        return ce / (b * (seq - 1)) + self.cfg.moe_aux_weight * aux


def _cols(t: int, width: int) -> slice:
    """Tensor position ``t``'s slice of ``width`` columns."""
    return slice(t * width, (t + 1) * width)


def _lora_b_cols(b: torch.Tensor, cols: slice) -> torch.Tensor:
    """The columns ``cols`` of a LoRA B factor ``[r, d_out]``: the same
    slice the position's kernel takes."""
    return b[:, cols]


def _global_order(parts: dict, n_r: int, n_s: int) -> torch.Tensor:
    """``{(r, s): [b_local, s_local, ...]}`` (on one device) as ``[B·S,
    ...]``, row-major over the global ``[B, S]``: row group ``r`` holds
    rows ``r·b_local ..``, sequence chunk ``s`` positions ``s·s_local ..``."""
    x = torch.cat([torch.cat([parts[r, s] for s in range(n_s)], dim=1) for r in range(n_r)])
    return x.reshape(-1, *x.shape[2:])


def _global_route(probs: dict, n_r: int, n_s: int, top_k: int, capacity_factor: float,
                  device: torch.device) -> tuple[Routing, int]:
    """One routing decision over the groups' router probabilities ``{(r,
    s): [b_local, s_local, E]}``: put into the global token order on
    ``device`` and routed with one capacity ``C`` for the whole
    microbatch (slot-major claims in global order, one Switch aux).
    Returns ``(routing over [k, B·S], C)``."""
    p = _global_order({g: v.to(device) for g, v in probs.items()}, n_r, n_s)
    cap = expert_capacity(p.shape[0], p.shape[1], top_k, capacity_factor)
    return route(p, top_k, cap), cap


def _layer_full(st: ShardedTensor, layer: int, dev: torch.device, dtype) -> torch.Tensor:
    """Layer ``layer`` of a stacked ``[L, ...]`` sharded weight, whole, on
    ``dev`` in ``dtype`` (each shard indexed and cast before it moves); the
    layer axis may be sharded over ``pipe``, a stage's slab a shard."""
    stage, local = divmod(layer, st.shape[0] // st.counts[0])

    def rec(prefix: tuple, dim: int) -> torch.Tensor:
        if dim == len(st.counts):
            return st.shards[prefix][local].to(dtype).to(dev)
        parts = [rec(prefix + (j,), dim + 1) for j in range(st.counts[dim])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim - 1)

    return rec((stage,), 1)


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------

def init_mesh_state(tx: Optimizer, params: dict, mesh: Mesh,
                    freeze_grads: bool = False) -> MeshTrainState:
    """A step-0 state: ``params`` (a flat dict or tree of whole tensors)
    sharded by the rule table, and the optimizer state's moments as zero
    shards by ``state_shardings`` (none for a leaf the optimizer freezes).
    ``freeze_grads`` (a LoRA fit): the frozen leaves' shards require no
    gradient, so none is computed for them, as on one device."""
    sharded = shard_params(params, mesh)
    for n, st in sharded.items():
        for t in st.shards.values():
            t.requires_grad_(not freeze_grads or tx.trainable(n))
    return MeshTrainState(step=0, params=sharded, opt_state=fresh_opt_state(tx, sharded, mesh))


def fresh_opt_state(tx: Optimizer, params: dict[str, ShardedTensor], mesh: Mesh) -> dict:
    """``tx.init``'s names and counters, each moment a :class:`ShardedTensor`
    of zeros laid out by ``state_shardings``."""
    shapes = {n: st.shape for n, st in params.items()}
    names, dtypes = {}, {}
    for n, st in params.items():
        if tx.trainable(n):
            for key in tx.moment_names(n):
                names[key] = shapes[n]
                dtypes[key] = tx.moment_dtype(next(iter(st.shards.values())).dtype)
    specs = state_shardings(shapes, names, mesh)
    state = {c: torch.tensor(0, dtype=torch.int32) for c in tx.counts}
    for key, shape in names.items():
        st = ShardedTensor(shape, specs[key], mesh, {})
        for k, d in zip(st.keys, mesh.devices.flat):
            if k not in st.shards:
                region = shard_region(shape, st.spec, k, mesh)
                st.shards[k] = torch.zeros([s.stop - s.start for s in region],
                                           dtype=dtypes[key], device=torch.device(d))
        state[key] = st
    return dict(sorted(state.items()))


def _intersect(a: tuple[slice, ...], b: tuple[slice, ...]):
    out = tuple(slice(max(x.start, y.start), min(x.stop, y.stop)) for x, y in zip(a, b))
    return out if all(s.start < s.stop for s in out) else None


def _local(sl: tuple[slice, ...], origin: tuple[slice, ...]) -> tuple[slice, ...]:
    return tuple(slice(s.start - o.start, s.stop - o.start) for s, o in zip(sl, origin))


def _region_of(st: ShardedTensor, values: dict, region, dev) -> torch.Tensor:
    """The slice ``region`` of the whole tensor whose shards are
    ``values[key]`` (``st``'s layout), assembled on ``dev``."""
    dtype = next(iter(values.values())).dtype
    out = torch.empty([s.stop - s.start for s in region], dtype=dtype, device=dev)
    for key in st.shards:
        src = st.region(key)
        inter = _intersect(src, region)
        if inter is not None:
            out[_local(inter, region)] = values[key][_local(inter, src)].to(dev)
    return out


@torch.no_grad()
def apply_optimizer(tx: Optimizer, state: MeshTrainState, grads: dict) -> None:
    """One optimizer step over the shards, in place. Each moment shard is a
    piece: its parameter and gradient regions (the parameter's own shard
    when the two layouts agree, else assembled from the overlapping shards
    and written back after), all on the moment shard's device."""
    pieces_g, pieces_p, tmp, moments = {}, {}, {}, {}
    writeback = []
    for name in sorted(state.params):
        p = state.params[name]
        if not tx.trainable(name):
            continue
        m_key, v_key = tx.moment_names(name)
        m, v = state.opt_state[m_key], state.opt_state[v_key]
        for key, m_shard in m.items():
            piece = f"{name}#{','.join(map(str, key))}"
            if m.spec == p.spec:
                pieces_p[piece], pieces_g[piece] = p.shards[key].data, grads[name][key]
            else:
                region, dev = m.region(key), m_shard.device
                pieces_p[piece] = _region_of(p, {k: t.data for k, t in p.shards.items()},
                                             region, dev)
                pieces_g[piece] = _region_of(p, grads[name], region, dev)
                writeback.append((p, region, pieces_p[piece]))
            for st, state_key in zip((m, v), tx.moment_names(piece)):
                tmp[state_key] = st.shards[key]
                moments[state_key] = (st, key)
    for c in tx.counts:
        tmp[c] = state.opt_state[c]
    tmp = tx.apply(pieces_g, tmp, pieces_p)
    for c in tx.counts:
        state.opt_state[c] = tmp[c]
    for state_key, (st, key) in moments.items():  # a promoted moment is a new tensor
        st.shards[key] = tmp[state_key]
    for p, region, value in writeback:
        for key, t in p.shards.items():
            inter = _intersect(p.region(key), region)
            if inter is not None:
                t.data[_local(inter, p.region(key))] = value[_local(inter, region)].to(t.device)


def leaves_of(params: dict) -> list[tuple[str, tuple, torch.Tensor]]:
    """Every shard of the state's parameters that takes a gradient (a LoRA
    fit's frozen base takes none): ``(name, key, shard)`` in name and key
    order."""
    return [(n, k, t) for n in sorted(params) for k, t in params[n].items()
            if t.requires_grad]


def _by_name(leaves: list, grads) -> dict:
    out: dict = {}
    for (n, k, _), g in zip(leaves, grads):
        out.setdefault(n, {})[k] = g
    return out


def finish_step(tx: Optimizer, state: MeshTrainState, leaves: list, loss: torch.Tensor,
                grads: list) -> tuple[MeshTrainState, dict]:
    """The step's tail after the gradients (one per shard of ``leaves``):
    ``grad_norm`` over each distinct shard once, the optimizer, the step
    counter and ``param_norm`` (over every parameter's shards)."""
    grad_norm = global_norm(grads)
    by_name = _by_name(leaves, grads)
    del grads
    apply_optimizer(tx, state, by_name)
    state.step += 1
    param_norm = global_norm([t.detach() for n in sorted(state.params)
                              for _, t in state.params[n].items()])
    return state, {"loss": loss, "grad_norm": grad_norm, "param_norm": param_norm}


def make_mesh_train_step(model: MeshModel, tx: Optimizer, n_microbatches: int = 1,
                         loss_chunk_tokens: int = 2048) -> Callable:
    """``(state, tokens) -> (state, metrics)`` over the mesh, the
    single-device step's contract: ``tokens`` is ``{device: [global_batch,
    seq]}`` (the batch on every device of the mesh), split into
    ``n_microbatches`` equal chunks whose gradients are averaged in fp32;
    then ``grad_norm``, the optimizer and ``param_norm``."""

    def train_step(state: MeshTrainState, tokens: dict):
        b = next(iter(tokens.values())).shape[0]
        if b % n_microbatches:
            raise ValueError(f"batch {b} not divisible by {n_microbatches} microbatches")
        rows = b // n_microbatches
        leaves = leaves_of(state.params)
        loss_sum, grad_sum = None, None
        for j in range(n_microbatches):
            mb = {d: t[j * rows:(j + 1) * rows] for d, t in tokens.items()}
            loss = model.loss(state.params, mb, loss_chunk_tokens)
            grads = torch.autograd.grad(loss, [t for _, _, t in leaves])
            if grad_sum is None:
                # one microbatch: the gradients in their parameters' dtypes; more are
                # summed in fp32 from zeros, as the JAX scan does
                loss_sum = loss.detach().float()
                grad_sum = list(grads) if n_microbatches == 1 else [g.float() for g in grads]
            else:
                loss_sum += loss.detach()
                for acc, g in zip(grad_sum, grads):
                    acc += g
            del grads
        if n_microbatches > 1:
            loss_sum /= n_microbatches
            for g in grad_sum:
                g /= n_microbatches
        return finish_step(tx, state, leaves, loss_sum, grad_sum)

    return train_step


def make_mesh_eval_step(model: MeshModel, loss_chunk_tokens: int = 2048) -> Callable:
    """``(params, tokens) -> (sum_ce, n_tokens)`` over the mesh (no MoE
    aux, as on one device)."""

    @torch.no_grad()
    def eval_step(params: dict, tokens: dict):
        b, seq = next(iter(tokens.values())).shape
        return model.ce_sum(params, tokens, loss_chunk_tokens)[0], b * (seq - 1)

    return eval_step


def mesh_gradients(model, params: dict, tokens: dict,
                   loss_chunk_tokens: int = 2048) -> tuple[torch.Tensor, dict]:
    """``(loss, {name: whole gradient})`` of one batch through ``model``'s
    ``loss`` (a :class:`MeshModel`, or a pipeline), the state untouched
    (the gradients gathered to each parameter's first shard's device; a
    leaf that takes no gradient is left out)."""
    loss = model.loss(params, tokens, loss_chunk_tokens)
    leaves = leaves_of(params)
    by_name = _by_name(leaves, torch.autograd.grad(loss, [t for _, _, t in leaves]))
    out = {}
    for n, grads in by_name.items():
        st = params[n]
        out[n] = ShardedTensor(st.shape, st.spec, st.mesh, grads).to_full()
    return loss.detach(), out
