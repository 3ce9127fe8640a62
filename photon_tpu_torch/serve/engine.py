"""The serving engine: fixed-shape slot arrays over the paged pool.

The port of ``photon_tpu/serve/engine.py:PagedEngine``. One engine owns
the device state (paged KV pool, block tables, per-slot cursors) and runs
one unified mixed step (:func:`serve.cache.mixed_chunk_step` + per-slot
sampling): decode rows and at most one prompt chunk go through the same
step, and attention walks the block tables at the live width ``n_ctx``.

Shapes follow the JAX engine's buckets even though PyTorch runs eagerly:
the chunk width ``Tq`` is a power-of-two block count and the live width
is a power-of-two bucket of the longest active reservation that only
rises while any slot is live (reset when the engine goes idle). They fix
which widths the tests compare and keep the set of step shapes bounded.

Sampling follows ``_sample_rows``: argmax at temperature 0, otherwise a
categorical draw from the slot's own ``torch.Generator`` (seeded from the
request's seed), which advances only on steps where the slot emits — so
a seeded completion does not depend on its batch-mates. Draws cannot
match JAX's threefry streams; greedy streams match the JAX engine.

Each step reads its next tokens back with one device-to-host copy of
``[n_slots]``. Thread discipline: one driver thread (the scheduler loop)
calls begin/mixed_step/evict; HTTP handler threads only read counters.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
from photon_tpu_torch.codec.params import params_from_numpy, strip_momenta
from photon_tpu_torch.config.schema import Config, ModelConfig
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.models.decode import compute_params, layer_params
from photon_tpu_torch.serve.cache import (
    BlockAllocator,
    PagedState,
    init_paged_state,
    install_row,
    mixed_chunk_step,
)


def _pow2_bucket(n: int) -> int:
    """Smallest power of two covering ``n`` (minimum 1)."""
    return 1 << (max(1, n) - 1).bit_length()


def load_serving_params(cfg: Config, mgr: ServerCheckpointManager,
                        server_round: int) -> dict:
    """Params-only load of a round (no optimizer moments; aggregated
    momenta split off) into the port's fp32 tree on the CPU."""
    meta, arrays = strip_momenta(*mgr.load_round_params(server_round))
    return params_from_numpy(meta.names, arrays, cfg.model, "cpu")


@dataclass
class _Prefill:
    """Host-side chunk cursor for a prompt mid-prefill."""

    prompt: list[int] = field(default_factory=list)
    pos: int = 0  # next position to prefill
    n: int = 0  # full prompt length


class PagedEngine:
    def __init__(self, cfg: Config, params: dict, *,
                 loaded_round: int | None = None,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        cfg.validate(self.device, serving=True)
        self.cfg = cfg
        self.mc: ModelConfig = cfg.model
        sc = cfg.photon.serve
        self.block_size = sc.block_size
        self.n_slots = sc.n_slots
        self.max_blocks = -(-self.mc.max_seq_len // self.block_size)
        self.s_cap = self.max_blocks * self.block_size
        self.n_blocks = sc.n_blocks or self.n_slots * self.max_blocks
        self.loaded_round = loaded_round
        self.allocator = BlockAllocator(self.n_blocks)
        # "gather": the full-width dense gather (the oracle; cost scales
        # with pool capacity). "auto"/"ragged": the live-block walk through
        # the kernel wrapper — the CUDA kernel on the card, its plain
        # version on the CPU.
        self._ctx_full = sc.attention_impl == "gather"
        self._impl = "gather" if self._ctx_full else "ragged"
        self.attn_impl = "gather" if self._ctx_full else (
            "ragged" if self.device.type == "cuda" else "ragged-ref"
        )
        self._ctx_hw = 1  # live-width high-water mark (blocks)
        self.params = compute_params(params, self.mc, self.device)
        self._layers = [layer_params(self.params, i) for i in range(self.mc.n_layers)]
        self.state: PagedState = init_paged_state(
            self.mc, self.n_slots, self.n_blocks, self.block_size, self.max_blocks,
            self.device,
        )
        self._temps = np.zeros(self.n_slots, np.float32)
        self._gens: list[torch.Generator | None] = [None] * self.n_slots
        self._last = np.zeros(self.n_slots, np.int32)  # last emitted token
        self._lengths = np.zeros(self.n_slots, np.int32)  # host cursor mirror
        self._active = np.zeros(self.n_slots, bool)
        self._slot_blocks: list[list[int]] = [[] for _ in range(self.n_slots)]
        self._pending: dict[int, _Prefill] = {}  # slot -> chunk cursor
        #: the latest step's logits ``[n_slots, V]`` (device tensor)
        self.last_logits: torch.Tensor | None = None

    # -- checkpoint loading ----------------------------------------------
    @classmethod
    def from_checkpoint(cls, cfg: Config, store: FileStore | None = None,
                        resume_round: int = -1,
                        device: str | torch.device | None = None) -> "PagedEngine":
        """Serve a federated run: resolve the checksum-valid round, load
        its params only."""
        store = store or FileStore(cfg.photon.save_path + "/store")
        mgr = ServerCheckpointManager(store, cfg.run_uuid)
        rnd = mgr.resolve_resume_round(resume_round)
        return cls(cfg, load_serving_params(cfg, mgr, rnd), loaded_round=rnd,
                   device=device)

    # -- capacity ---------------------------------------------------------
    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new) // self.block_size)

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Can this request ever run here (context window and pool size)?"""
        return (prompt_len >= 1
                and prompt_len + max_new <= min(self.s_cap, self.mc.max_seq_len)
                and self.blocks_needed(prompt_len, max_new)
                <= min(self.max_blocks, self.n_blocks))

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        return (self.free_slot() is not None
                and self.allocator.free_blocks >= self.blocks_needed(prompt_len, max_new))

    def free_slot(self) -> int | None:
        idle = np.flatnonzero(~self._active)
        return int(idle[0]) if idle.size else None

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    def pending_tokens(self, slot: int) -> int:
        """Prompt tokens still to prefill for ``slot`` (0 = decoding)."""
        p = self._pending.get(slot)
        return 0 if p is None else p.n - p.pos

    def attn_stats(self) -> dict[str, float]:
        """The live walk width, the pool's live fraction, and whether the
        ragged walk (vs the full-width gather) is on."""
        return {
            "ctx_blocks": float(self.max_blocks if self._ctx_full else self._ctx_hw),
            "live_frac": (self.n_blocks - self.allocator.free_blocks) / self.n_blocks,
            "ragged": 0.0 if self._ctx_full else 1.0,
        }

    # -- admission / step / eviction --------------------------------------
    def _bucket(self, n_tokens: int) -> int:
        """Chunk pad width: a power-of-two block count, capped at the slot
        capacity."""
        need = max(1, -(-n_tokens // self.block_size))
        return min(_pow2_bucket(need), self.max_blocks) * self.block_size

    def _ctx_width(self) -> int:
        """The step's live attention width in blocks: pow2 bucket of the
        longest active reservation, monotone while any slot is live
        (:meth:`evict` resets it when the engine goes idle). ``gather``
        pins it at the full table width."""
        if self._ctx_full:
            return self.max_blocks
        need = max(
            (len(self._slot_blocks[s]) for s in range(self.n_slots) if self._active[s]),
            default=1,
        )
        self._ctx_hw = max(self._ctx_hw, min(_pow2_bucket(need), self.max_blocks))
        return self._ctx_hw

    def begin(self, slot: int, prompt: list[int], max_new: int,
              temperature: float = 0.0, seed: int = 0) -> None:
        """Reserve ``slot`` and its worst-case ``blocks_needed`` blocks up
        front (an admitted request never dies of pool exhaustion), install
        its table row, and stage its prompt for the chunk stream. The step
        whose chunk covers the last prompt token emits the first token."""
        if self._active[slot]:
            raise RuntimeError(f"slot {slot} is occupied")
        n = len(prompt)
        if not self.fits(n, max_new):
            raise ValueError(f"request needs {n}+{max_new} tokens > slot capacity {self.s_cap}")
        ids = self.allocator.alloc(self.blocks_needed(n, max_new))
        if ids is None:
            raise RuntimeError("paged pool exhausted (caller must can_admit first)")
        try:
            row = np.full(self.max_blocks, self.n_blocks, np.int32)
            row[: len(ids)] = ids
            install_row(self.state, slot, torch.from_numpy(row), 0)
        except BaseException:
            self.allocator.free(ids)  # a failed admission leaks no blocks
            raise
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        self._gens[slot] = gen
        self._temps[slot] = float(temperature)
        self._slot_blocks[slot] = ids
        self._active[slot] = True
        self._lengths[slot] = 0
        self._last[slot] = 0
        self._pending[slot] = _Prefill(prompt=list(prompt), pos=0, n=n)

    def mixed_step(self, chunk: tuple[int, int] | None = None, *,
                   include_decode: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """One serving step: every active non-prefilling slot decodes its
        last token; ``chunk = (slot, n_tokens)`` also advances that slot's
        prompt by up to ``n_tokens`` positions. Returns ``(next_token
        [n_slots], emitted [n_slots])`` — a decode row emits every step, a
        prefilling slot once, on the step that covers its last prompt
        token. ``include_decode=False`` runs the chunk alone."""
        B = self.n_slots
        decode_slots = [s for s in range(B)
                        if include_decode and self._active[s] and s not in self._pending]
        seg: list[int] = []
        cs, final = 0, False
        if chunk is not None:
            cs, want = chunk
            p = self._pending[cs]
            cn = min(want, p.n - p.pos)
            if cn < 1:
                raise RuntimeError(f"slot {cs} has no pending prompt tokens")
            seg = p.prompt[p.pos: p.pos + cn]
            final = p.pos + cn == p.n
        if not seg and not decode_slots:
            raise RuntimeError("mixed_step with no work")
        tq = self._bucket(len(seg)) if seg else 1
        tokens = np.zeros((B, tq), np.int32)
        positions = np.zeros((B, tq), np.int32)
        q_valid = np.zeros((B, tq), bool)
        emit_off = np.zeros(B, np.int32)
        emit_mask = np.zeros(B, bool)
        lengths_after = self._lengths.copy()
        for s in decode_slots:
            tokens[s, 0] = self._last[s]
            positions[s, 0] = self._lengths[s]
            q_valid[s, 0] = True
            emit_mask[s] = True
            lengths_after[s] += 1
        if seg:
            p = self._pending[cs]
            tokens[cs, : len(seg)] = seg
            positions[cs, : len(seg)] = np.arange(p.pos, p.pos + len(seg))
            q_valid[cs, : len(seg)] = True
            lengths_after[cs] = p.pos + len(seg)
            if final:
                emit_off[cs] = len(seg) - 1
                emit_mask[cs] = True
        dev = self.device
        logits, self.state = mixed_chunk_step(
            self.params, self._layers, self.state,
            torch.from_numpy(tokens).to(dev).long(), torch.from_numpy(positions).to(dev),
            torch.from_numpy(q_valid).to(dev), torch.from_numpy(emit_off).to(dev),
            torch.from_numpy(lengths_after).to(dev), cs, self.mc,
            n_ctx=self._ctx_width(), has_chunk=bool(seg), impl=self._impl,
        )
        self.last_logits = logits
        out = self._sample(logits, emit_mask)
        self._lengths = lengths_after
        for s in decode_slots:
            self._last[s] = out[s]
        if seg:
            p = self._pending[cs]
            p.pos += len(seg)
            if final:
                self._last[cs] = out[cs]
                del self._pending[cs]
        return out, emit_mask

    def _sample(self, logits: torch.Tensor, emit_mask: np.ndarray) -> np.ndarray:
        """Argmax rows at temperature 0; a draw from the slot's generator
        otherwise (only for rows that emit this step). One host copy."""
        nxt = torch.argmax(logits, dim=-1)
        for s in np.flatnonzero(emit_mask & (self._temps > 0.0)):
            probs = torch.softmax(logits[s].float() / max(float(self._temps[s]), 1e-6), dim=-1)
            nxt[s] = torch.multinomial(probs, 1, generator=self._gens[s])[0]
        out = nxt.to(torch.int32).cpu().numpy()
        out[~emit_mask] = 0
        return out

    def admit(self, slot: int, prompt: list[int], max_new: int,
              temperature: float = 0.0, seed: int = 0) -> int:
        """Synchronous admission: stage the request and run its whole
        prompt as one chunk, without decode rows, returning the first
        sampled token."""
        self.begin(slot, prompt, max_new, temperature=temperature, seed=seed)
        nxt, emitted = self.mixed_step((slot, self.pending_tokens(slot)),
                                       include_decode=False)
        assert emitted[slot]  # one chunk covers the prompt, so it emits
        return int(nxt[slot])

    def step(self) -> np.ndarray:
        """One decode step for every active non-prefilling slot; returns
        next token ids ``[n_slots]`` (zeros at inactive slots)."""
        if not self._active.any():
            raise RuntimeError("no active slots")
        out, _ = self.mixed_step(None)
        return out

    def evict(self, slot: int) -> None:
        """Return ``slot``'s blocks to the free list — host bookkeeping
        only: the step sends inactive slots' writes to the trash block and
        the position mask hides the stale bytes of recycled blocks."""
        if not self._active[slot]:
            raise RuntimeError(f"slot {slot} is not active")
        self.allocator.free(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._pending.pop(slot, None)
        self._gens[slot] = None
        self._temps[slot] = 0.0
        self._active[slot] = False
        self._last[slot] = 0
        self._lengths[slot] = 0
        if not self._active.any():
            self._ctx_hw = 1  # idle: one long request stops widening later batches
