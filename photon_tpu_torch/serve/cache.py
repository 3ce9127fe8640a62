"""Paged KV cache — block-pool storage for the serving plane.

The port of ``photon_tpu/serve/cache.py``. One fixed pool of KV blocks is
shared by every slot:

- **pool**: ``cache_k/cache_v`` of shape ``[n_blocks + 1, L, block_size,
  H_kv, Dh]``. The last block is the trash block: never allocated, it
  absorbs the writes of padding rows and idle slots.
- **block tables**: ``[n_slots, max_blocks]`` int32 mapping each slot's
  logical block ``j`` (tokens ``[j*bs, (j+1)*bs)``) to a physical block;
  unassigned entries point at the trash block.
- **free list**: the host-side :class:`BlockAllocator`.

The JAX step donates its state and XLA updates the pool in place; here
:func:`mixed_chunk_step` writes the pool in place (``index_put_``), which
is the same contract. Padding rows all write the trash block at the same
offsets; on CUDA that write is nondeterministic, and nothing reads it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from photon_tpu_torch.config.schema import ModelConfig
from photon_tpu_torch.models.decode import (
    _dense,
    _embed,
    _logits,
    _mlp,
    _norm,
    _qkv,
    _rope_at,
    decode_layers,
    torch_dtype,
)
from photon_tpu_torch.ops.attention import alibi_slopes
from photon_tpu_torch.ops.ragged_paged_attention import (
    live_view,
    ragged_paged_attention,
    ragged_reference_attention,
)


class BlockLeakError(RuntimeError):
    """Double-free / foreign-id free — a block-accounting bug, never user error."""


class BlockAllocator:
    """Host-side free list over physical block ids ``[0, n_blocks)``.

    LIFO recycling (a just-freed block is the next handed out). Blocks are
    refcounted: ``alloc`` hands out ids at refcount 1, :meth:`retain` adds
    a reference, :meth:`free` drops one and returns the block to the free
    list at zero. Freeing or retaining a block nobody holds raises
    :class:`BlockLeakError`.
    """

    def __init__(self, n_blocks: int) -> None:
        if n_blocks < 1:
            raise ValueError(f"need n_blocks >= 1, got {n_blocks}")
        self.n_blocks = n_blocks
        self._free: list[int] = list(range(n_blocks - 1, -1, -1))
        self._refs: dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def held_blocks(self) -> int:
        return len(self._refs)

    def refcount(self, block: int) -> int:
        """Outstanding references on ``block`` (0 = on the free list)."""
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> list[int] | None:
        """``n`` ids at refcount 1, or None (and nothing allocated) when
        the pool cannot cover the request."""
        if n < 0:
            raise ValueError(f"need n >= 0, got {n}")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._refs[b] = 1
        return ids

    def retain(self, ids: list[int]) -> None:
        for b in ids:
            if b not in self._refs:
                raise BlockLeakError(f"retaining block {b} not currently held")
        for b in ids:
            self._refs[b] += 1

    def free(self, ids: list[int]) -> None:
        for b in ids:
            refs = self._refs.get(b, 0)
            if refs < 1:
                raise BlockLeakError(f"freeing block {b} not currently held")
            if refs == 1:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = refs - 1


@dataclass
class PagedState:
    """Device-side serving state; every tensor keeps a fixed shape."""

    cache_k: torch.Tensor  # [n_blocks + 1, L, block_size, H_kv, Dh]
    cache_v: torch.Tensor
    block_tables: torch.Tensor  # [n_slots, max_blocks] int32 physical ids
    lengths: torch.Tensor  # [n_slots] int32 per-slot token counts

    @property
    def block_size(self) -> int:
        return self.cache_k.shape[2]

    @property
    def trash_block(self) -> int:
        return self.cache_k.shape[0] - 1

    def clone(self) -> "PagedState":
        return PagedState(self.cache_k.clone(), self.cache_v.clone(),
                          self.block_tables.clone(), self.lengths.clone())


def init_paged_state(cfg: ModelConfig, n_slots: int, n_blocks: int,
                     block_size: int, max_blocks: int,
                     device: torch.device) -> PagedState:
    dtype = torch_dtype(cfg.compute_dtype)
    shape = (n_blocks + 1, cfg.n_layers, block_size, cfg.kv_heads, cfg.d_head)
    return PagedState(
        cache_k=torch.zeros(shape, dtype=dtype, device=device),
        cache_v=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.full((n_slots, max_blocks), n_blocks, dtype=torch.int32, device=device),
        lengths=torch.zeros(n_slots, dtype=torch.int32, device=device),
    )


def install_row(state: PagedState, slot: int, row: torch.Tensor,
                length: int) -> PagedState:
    """Admission bookkeeping: point ``slot``'s table at its reserved
    blocks and park its cursor at ``length``. No KV moves — the chunk
    stream writes the prompt's KV as it prefills."""
    state.block_tables[slot] = row.to(state.block_tables.device)
    state.lengths[slot] = length
    return state


def _attend(impl: str, q, state: PagedState, layer: int, rows, positions,
            scale: float, slopes):
    """One attention call over layer ``layer``: the ragged walk (the
    kernel on the card, its plain version on the CPU) or the dense gather
    of the same live blocks."""
    if impl == "ragged":
        return ragged_paged_attention(q, state.cache_k, state.cache_v, layer, rows,
                                      positions, scale=scale, slopes=slopes)
    kb, vb = live_view(state.cache_k, state.cache_v, layer, rows)
    return ragged_reference_attention(q, kb, vb, positions, scale=scale, slopes=slopes)


def mixed_chunk_step(params: dict, layers: list[dict], state: PagedState,
                     tokens: torch.Tensor, positions: torch.Tensor,
                     q_valid: torch.Tensor, emit_off: torch.Tensor,
                     lengths_after: torch.Tensor, chunk_slot: int,
                     cfg: ModelConfig, *, n_ctx: int, has_chunk: bool = False,
                     impl: str = "gather", n_spec: int = 1) -> tuple[torch.Tensor, PagedState]:
    """One serving step over a mixed chunked-prefill batch: every slot
    contributes a row of ``tokens [n_slots, Tq]`` — a decode row puts its
    last emitted token in column 0 (the rest padding), the ``chunk_slot``
    row (``has_chunk``) carries its next prompt chunk, idle slots are all
    padding — and attention walks the block tables at the live width
    ``n_ctx`` blocks. Returns (logits ``[n_slots, V]`` at each slot's
    ``emit_off`` column, the state updated in place with
    ``lengths_after``).

    ``n_spec > 1`` (speculative verify): a decode row may carry up to
    ``n_spec`` tokens ``[last, d_1 .. d_K]`` at positions ``len .. len+K``,
    and the step returns logits ``[n_slots, n_spec, V]`` at every one of
    the first ``n_spec`` columns. The decode call takes those columns in
    one attention call, each query masked at its own position, so the
    keys a later column wrote this step (or a rejected draft left behind)
    stay invisible to earlier ones. The chunk row's emit column is
    replicated across the ``n_spec`` axis. ``n_spec == 1`` is the plain
    step, same call and output shape.

    MoE caveat (``cfg.mlp == "moe"``), as in JAX: expert-capacity routing
    is batch-global: every row of the step competes for one capacity pool
    of ``N = n_slots · Tq`` tokens, so neither equality with contiguous
    decode nor independence from batch-mates holds, and serving MoE is
    best-effort. ``q_valid`` is the routing's token mask, so pad and idle
    rows claim no capacity.

    ``layers`` holds the per-layer views of ``params``
    (:func:`models.decode.layer_params`). Each layer first writes every
    real token's k/v at ``(table[slot, pos // bs], pos % bs)`` (padding
    rows write the trash block) and then attends: one call for the decode
    columns of every slot (``T = n_spec``) and, with a chunk, one for the
    chunk row (``B = 1``). ``impl`` is ``"ragged"`` (the kernel wrapper) or
    ``"gather"`` (the dense reference over the gathered blocks).
    """
    n_slots, tq = tokens.shape
    bs = state.block_size
    scale = 1.0 / (cfg.d_head ** 0.5)
    slopes = alibi_slopes(cfg.n_heads, tokens.device) if cfg.alibi else None
    x = _embed(params, tokens, positions, cfg)  # [B, Tq, D]
    blk = torch.clamp(positions // bs, max=state.block_tables.shape[1] - 1).long()
    phys = torch.gather(state.block_tables, 1, blk)  # [B, Tq]
    phys = torch.where(q_valid, phys, torch.full_like(phys, state.trash_block)).long()
    off = (positions % bs).long()
    rows = state.block_tables[:, :n_ctx]
    pos_dec = positions[:, :n_spec]
    if has_chunk:
        row_c = rows[chunk_slot: chunk_slot + 1]
        pos_c = positions[chunk_slot: chunk_slot + 1]
    for li, lp in enumerate(layers):
        h = _norm(x, lp["ln_1"]["scale"], lp["ln_1"].get("bias"), cfg.norm, cfg.norm_eps)
        q, k_new, v_new = _qkv(lp, h, cfg)  # q [B, Tq, H, Dh]
        if cfg.rope:
            q = _rope_at(q, positions, cfg.rope_theta)
            k_new = _rope_at(k_new, positions, cfg.rope_theta)
        # write first: every real token's k/v lands before any row reads it
        lidx = torch.full_like(phys, li)
        state.cache_k.index_put_((phys, lidx, off), k_new.to(state.cache_k.dtype))
        state.cache_v.index_put_((phys, lidx, off), v_new.to(state.cache_v.dtype))
        out_dec = _attend(impl, q[:, :n_spec], state, li, rows, pos_dec, scale, slopes)
        attn = out_dec[:, :1].expand(n_slots, tq, cfg.n_heads, cfg.d_head)
        if n_spec > 1:
            attn = attn.clone()
            attn[:, :n_spec] = out_dec.to(attn.dtype)
        if has_chunk:
            out_c = _attend(impl, q[chunk_slot: chunk_slot + 1], state, li, row_c,
                            pos_c, scale, slopes)
            attn = attn.clone()
            attn[chunk_slot] = out_c[0].to(attn.dtype)
        x = x + _dense(lp, "out_proj", attn.reshape(n_slots, tq, cfg.d_model))
        x, _ = _mlp(lp, x, cfg, token_mask=q_valid)  # pad and idle rows claim no capacity
    state.lengths.copy_(lengths_after)
    if n_spec == 1:
        last = x[torch.arange(n_slots, device=x.device), emit_off.long()]  # [B, D]
        return _logits(params, last, cfg), state
    # the verify grid: decode rows read columns 0 .. n_spec-1; the chunk
    # row reads its emit column, replicated
    cols = torch.arange(n_spec, device=x.device).expand(n_slots, n_spec).clone()
    if has_chunk:
        cols[chunk_slot] = emit_off[chunk_slot].long()
    sel = torch.gather(x, 1, cols[:, :, None].expand(n_slots, n_spec, x.shape[-1]))
    return _logits(params, sel, cfg), state


def paged_decode_step(params: dict, layers: list[dict], state: PagedState,
                      token: torch.Tensor, cfg: ModelConfig,
                      active: torch.Tensor) -> tuple[torch.Tensor, PagedState]:
    """The full-width oracle: one decode step over all slots, placing
    ``token [n_slots]`` at each active slot's cursor (inactive slots write
    the trash block and do not advance) and attending over every table
    entry with the dense gather (``models.decode.decode_layers``, the
    contiguous decoder's computation). An MoE layer routes every slot,
    idle ones included (no token mask, as in JAX). Returns (logits
    ``[n_slots, V]``, state updated in place)."""
    m = state.block_tables.shape[1]
    bs = state.block_size
    pos = state.lengths.clone()  # [B] where this token lands
    blk = torch.clamp(pos // bs, max=m - 1).long()
    phys = torch.gather(state.block_tables, 1, blk[:, None])[:, 0]
    phys = torch.where(active, phys, torch.full_like(phys, state.trash_block)).long()
    off = (pos % bs).long()

    def write_and_view(li, k_new, v_new):
        lidx = torch.full_like(phys, li)
        state.cache_k.index_put_((phys, lidx, off), k_new.to(state.cache_k.dtype))
        state.cache_v.index_put_((phys, lidx, off), v_new.to(state.cache_v.dtype))
        return live_view(state.cache_k, state.cache_v, li, state.block_tables)

    logits = decode_layers(params, layers, token, pos, cfg, write_and_view)
    state.lengths.add_(active.to(state.lengths.dtype))
    return logits, state
