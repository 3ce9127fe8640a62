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

Sampling: argmax at temperature 0. A temperature row draws one seed per
emitted token from its slot's own CPU ``torch.Generator`` (seeded from
the request's seed), and that emission's draws — the categorical sample,
or a verify's rejection uniform and residual draw — come from a
generator seeded with it. So the m-th emission of a seeded stream always
uses the same seed, however emissions group into steps: a stream does
not depend on its batch-mates' chunks or drafts, and a row without a
draft samples exactly what the plain step samples. Draws cannot match
JAX's threefry streams; greedy streams match the JAX engine.

With ``serve.prefix_cache`` on (never for MoE, whose batch-global expert
capacity makes a block's KV depend on its batch-mates), full prompt
blocks are shared across requests through :class:`serve.prefix.PrefixCache`;
a hit starts the slot's chunk stream at the cached depth.
:meth:`PagedEngine.spec_step` verifies drafted tokens of every decoding
row in one step (speculative decoding); :meth:`PagedEngine.set_params`
swaps in a new round's params while no slot is active.

An MoE model routes every token of a step in one capacity pool, whose
size is a function of the step's ``N = n_slots · Tq`` (the same buckets
as JAX's step): a request's tokens depend on its batch-mates, so serving
MoE is best-effort, as in the JAX package.

Each step reads its next tokens back with one device-to-host copy of
``[n_slots]`` (``[n_slots, n_spec]`` for a verify). Thread discipline:
one scheduler thread (the scheduler loop) calls begin/mixed_step/
spec_step/evict/set_params; HTTP handler threads only read counters.
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
from photon_tpu_torch.serve.prefix import PrefixCache, prefix_hashes


def _pow2_bucket(n: int) -> int:
    """Smallest power of two covering ``n`` (minimum 1): chunk widths, the
    live width and the verify width all bucket through it."""
    return 1 << (max(1, n) - 1).bit_length()


def _probs(logits: torch.Tensor, temp: float) -> torch.Tensor:
    """``softmax(logits / temp)`` in fp32: the one sampling distribution of
    a plain step and of a verify column."""
    return torch.softmax(logits.float() / max(temp, 1e-6), dim=-1)


def _categorical(probs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw from ``probs`` as a 0-d tensor on its device. The same
    arithmetic as ``torch.multinomial(probs, 1)``'s single-sample path
    (``argmax(probs / Exp(1))``) without its validity check, which would
    make the host wait on the device once per row."""
    return torch.argmax(probs / torch.empty_like(probs).exponential_(1, generator=gen))


def _verify_rows(logits: torch.Tensor, tokens: np.ndarray, temps: np.ndarray,
                 emit_mask: np.ndarray, n_valid: np.ndarray,
                 seeds: dict[int, list[int]]) -> tuple[np.ndarray, np.ndarray]:
    """Speculative acceptance over the verify grid: emission ``i`` reads
    the logits of column ``i`` (``logits [B, n_spec, V]``); the draft it
    tests is ``tokens[:, i + 1]``, present while ``i + 1 < n_valid``.

    - greedy rows (``temps <= 0``): the longest prefix of drafts that
      equals the argmax, plus one bonus token — the plain steps' stream;
    - temperature rows: rejection sampling against the drafter's point
      mass: accept draft ``d`` when ``u < p(d)``, else emit a draw from
      ``p`` with ``d``'s mass removed, and stop. A column without a draft
      samples as the plain step does.

    ``seeds[s][i]`` seeds the draws of emission ``i`` of temperature row
    ``s`` (one per valid column). Every column's draws are queued on the
    device and read back with the argmax in one copy. Returns ``(tokens
    [B, n_spec] — zeros past each row's count, n_emitted [B])``.
    """
    b, n_spec, _ = logits.shape
    # per temperature row and column: the token it emits, and whether
    # that token is its accepted draft
    cand = torch.zeros((b, n_spec), dtype=torch.long, device=logits.device)
    acc = torch.zeros((b, n_spec), dtype=torch.bool, device=logits.device)
    for s, row_seeds in seeds.items():
        temp = float(temps[s])
        for i, seed in enumerate(row_seeds):
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(seed)
            p = _probs(logits[s, i], temp)
            if i + 1 < n_valid[s]:
                d = int(tokens[s, i + 1])
                u = torch.rand((), generator=gen, device=p.device)
                resid = p.clone()
                resid[d] = 0.0
                acc[s, i] = u < p[d]
                cand[s, i] = torch.where(acc[s, i], d, _categorical(resid, gen))
            else:
                cand[s, i] = _categorical(p, gen)
    greedy, cand, acc = (t.cpu().numpy() for t in torch.stack(
        [torch.argmax(logits, dim=-1), cand, acc.long()]))
    out = np.zeros((b, n_spec), np.int32)
    n_em = np.zeros(b, np.int32)
    for s in np.flatnonzero(emit_mask):
        for i in range(n_spec):
            has_draft = i + 1 < n_valid[s]
            if temps[s] <= 0.0:
                tok = int(greedy[s, i])
                accept = has_draft and int(tokens[s, i + 1]) == tok
            else:
                tok, accept = int(cand[s, i]), bool(acc[s, i])
            out[s, i] = tok
            n_em[s] += 1
            if not accept:
                break
    return out, n_em


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
    pos: int = 0  # next position to prefill (starts at the prefix-hit depth)
    n: int = 0  # full prompt length
    hashes: list[bytes] = field(default_factory=list)
    row_blocks: list[int] = field(default_factory=list)


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
        self.prefix_cache: PrefixCache | None = None
        if sc.prefix_cache and self.mc.mlp != "moe":
            self.prefix_cache = PrefixCache(self.allocator, max_blocks=sc.prefix_cache_blocks)
        self._hash_memo: tuple[list[int], int, list[bytes]] | None = None
        self._install_params(params)
        self.state: PagedState = init_paged_state(
            self.mc, self.n_slots, self.n_blocks, self.block_size, self.max_blocks,
            self.device,
        )
        self._temps = np.zeros(self.n_slots, np.float32)
        #: per-slot CPU generators: one seed per emitted token of a
        #: temperature row (see :meth:`_next_seed`)
        self._gens: list[torch.Generator | None] = [None] * self.n_slots
        self._last = np.zeros(self.n_slots, np.int32)  # last emitted token
        self._lengths = np.zeros(self.n_slots, np.int32)  # host cursor mirror
        self._active = np.zeros(self.n_slots, bool)
        self._slot_blocks: list[list[int]] = [[] for _ in range(self.n_slots)]
        self._pending: dict[int, _Prefill] = {}  # slot -> chunk cursor
        #: the latest step's logits, ``[n_slots, V]`` (``[n_slots, n_spec,
        #: V]`` after a verify), on the device
        self.last_logits: torch.Tensor | None = None
        #: device bytes allocated before the last swap, and the peak across
        #: it (CUDA only)
        self.swap_bytes_before: int | None = None
        self.swap_peak_bytes: int | None = None
        #: why the engine holds no params (a swap that failed after the old
        #: tensors were released); None while it can serve
        self.failed: str | None = None

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

    def _install_params(self, params: dict) -> None:
        self.params = compute_params(params, self.mc, self.device)
        self._layers = [layer_params(self.params, i) for i in range(self.mc.n_layers)]

    def set_params(self, params: dict, loaded_round: int | None = None) -> None:
        """Install a new round's params (the hot-swap). Called from the
        scheduler thread with no slot active, so every request
        runs on one round's params. The old compute tensors are released
        before the new ones are made, and the prefix cache is flushed: KV
        computed under the old params is invalid under the new.

        If making the new tensors fails (an out-of-memory on the card), the
        old ones are already gone: the engine is left :attr:`failed`, with
        ``loaded_round`` unchanged so that the watcher retries the round,
        and refuses every step until a later swap succeeds."""
        if self._active.any():
            raise RuntimeError(
                f"param swap with {int(self._active.sum())} active slots — "
                "the scheduler must quiesce first"
            )
        cuda = self.device.type == "cuda"
        if cuda:  # the device memory before the swap, and its peak across it
            self.swap_bytes_before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.params = self._layers = self.last_logits = None
        try:
            self._install_params(params)
        except BaseException as e:
            self.params = self._layers = None
            self.failed = (f"swap to round {loaded_round} failed "
                           f"({type(e).__name__}: {e}); no params loaded")
            raise
        self.failed = None
        if cuda:
            self.swap_peak_bytes = torch.cuda.max_memory_allocated(self.device)
        self.loaded_round = loaded_round
        if self.prefix_cache is not None:
            self.prefix_cache.flush()

    # -- capacity ---------------------------------------------------------
    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new) // self.block_size)

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Can this request ever run here (context window and pool size)?"""
        return (prompt_len >= 1
                and prompt_len + max_new <= min(self.s_cap, self.mc.max_seq_len)
                and self.blocks_needed(prompt_len, max_new)
                <= min(self.max_blocks, self.n_blocks))

    def can_admit(self, prompt_len: int, max_new: int,
                  prompt: list[int] | None = None) -> bool:
        """A free slot, and blocks for the reservation. With ``prompt``
        given and the prefix cache on, cache hits need no fresh blocks and
        blocks only the cache holds count as free (:meth:`begin` evicts
        them under pressure)."""
        if self.free_slot() is None:
            return False
        hit, fresh_needed, _ = self._prefix_plan(prompt or [], prompt_len, max_new,
                                                 touch=False)
        avail = self.allocator.free_blocks
        if self.prefix_cache is not None:
            avail += self.prefix_cache.reclaimable(exclude=set(hit))
        return avail >= fresh_needed

    def _prefix_plan(self, prompt: list[int], prompt_len: int, max_new: int,
                     touch: bool = True) -> tuple[list[int], int, list[bytes]]:
        """(cached-prefix blocks, fresh blocks still needed, the prompt's
        full-block chain hashes). Lookups stop one block short of the
        prompt's end, so the final prompt token always runs. ``touch=False``
        peeks without reordering the LRU."""
        need = self.blocks_needed(prompt_len, max_new)
        if self.prefix_cache is None or not prompt:
            return [], need, []
        hashes = self._chain_hashes(prompt, prompt_len)
        hit = self.prefix_cache.lookup(hashes[: (prompt_len - 1) // self.block_size],
                                       touch=touch)
        return hit, need - len(hit), hashes

    def _chain_hashes(self, prompt: list[int], prompt_len: int) -> list[bytes]:
        """One hash sweep per prompt list object: a single-slot memo keyed
        by identity (it holds the list, so the id cannot be recycled);
        covers the can_admit → begin pair and a blocked queue head's
        retries."""
        memo = self._hash_memo
        if memo is not None and memo[0] is prompt and memo[1] == prompt_len:
            return memo[2]
        hashes = prefix_hashes(prompt, self.block_size, limit=prompt_len // self.block_size)
        self._hash_memo = (prompt, prompt_len, hashes)
        return hashes

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

    def prefix_stats(self) -> dict | None:
        """Prefix-cache counters for /healthz (None when the cache is off)."""
        pc = self.prefix_cache
        if pc is None:
            return None
        return {"entries": len(pc), "hit_rate": round(pc.hit_rate, 4),
                "evictions": pc.evictions, "tokens_cached": pc.tokens_cached}

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
        whose chunk covers the last prompt token emits the first token.

        With the prefix cache on, the longest cached full-block prefix is
        mapped into the slot's table (one reference per shared block,
        taken before any eviction can run; never written) and the chunk
        stream starts at the cached depth. A failed admission frees its
        fresh blocks and its references."""
        if self._active[slot]:
            raise RuntimeError(f"slot {slot} is occupied")
        n = len(prompt)
        if not self.fits(n, max_new):
            raise ValueError(f"request needs {n}+{max_new} tokens > slot capacity {self.s_cap}")
        hit, fresh_needed, hashes = self._prefix_plan(prompt, n, max_new)
        ids: list[int] | None = None
        retained = False
        try:
            if hit:
                self.allocator.retain(hit)
                retained = True
            if self.prefix_cache is not None and fresh_needed > self.allocator.free_blocks:
                self.prefix_cache.ensure_free(fresh_needed)
            ids = self.allocator.alloc(fresh_needed)
            if ids is None:
                raise RuntimeError("paged pool exhausted (caller must can_admit first)")
            row_blocks = hit + ids
            row = np.full(self.max_blocks, self.n_blocks, np.int32)
            row[: len(row_blocks)] = row_blocks
            start = len(hit) * self.block_size
            install_row(self.state, slot, torch.from_numpy(row), start)
        except BaseException:
            if ids is not None:
                self.allocator.free(ids)
            if retained:
                self.allocator.free(hit)
            raise
        gen = torch.Generator()
        gen.manual_seed(int(seed))
        self._gens[slot] = gen
        self._temps[slot] = float(temperature)
        self._slot_blocks[slot] = row_blocks
        self._active[slot] = True
        self._lengths[slot] = start
        self._last[slot] = 0
        self._pending[slot] = _Prefill(prompt=list(prompt), pos=start, n=n, hashes=hashes,
                                       row_blocks=row_blocks)
        if self.prefix_cache is not None:
            self.prefix_cache.tokens_seen += n
            self.prefix_cache.tokens_cached += start

    def _next_seed(self, slot: int) -> int:
        """The seed of ``slot``'s next emitted token: the next draw of the
        slot's own CPU generator (no device work)."""
        return int(torch.randint(2**62, (1,), generator=self._gens[slot])[0])

    def _peek_seeds(self, slot: int, n: int) -> list[int]:
        """The seeds of ``slot``'s next ``n`` emissions, without consuming
        them: a verify learns how many it emitted only after its draws."""
        state = self._gens[slot].get_state()
        seeds = [self._next_seed(slot) for _ in range(n)]
        self._gens[slot].set_state(state)
        return seeds

    def mixed_step(self, chunk: tuple[int, int] | None = None, *,
                   include_decode: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """One serving step: every active non-prefilling slot decodes its
        last token; ``chunk = (slot, n_tokens)`` also advances that slot's
        prompt by up to ``n_tokens`` positions. Returns ``(next_token
        [n_slots], emitted [n_slots])`` — a decode row emits every step, a
        prefilling slot once, on the step that covers its last prompt
        token. ``include_decode=False`` runs the chunk alone."""
        out, n_em = self._grid_step(chunk, include_decode, {})
        return out[:, 0], n_em > 0

    def spec_step(self, chunk: tuple[int, int] | None = None,
                  drafts: dict[int, list[int]] | None = None, *,
                  include_decode: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`mixed_step` with drafts: ``drafts`` maps decoding slots to
        proposed continuations, and every drafted row verifies its whole
        draft in this one step. Returns ``(tokens [n_slots, n_spec],
        n_emitted [n_slots])``: slot ``s`` emitted ``tokens[s, :n_emitted[s]]``
        (its accepted drafts and one model token; one token for a row
        without drafts, so ``drafts={}`` is the plain step)."""
        return self._grid_step(chunk, include_decode, drafts or {})

    def _grid_step(self, chunk: tuple[int, int] | None, include_decode: bool,
                   drafts: dict[int, list[int]]) -> tuple[np.ndarray, np.ndarray]:
        if self.failed:
            raise RuntimeError(self.failed)
        B = self.n_slots
        decode_slots = [s for s in range(B)
                        if include_decode and self._active[s] and s not in self._pending]
        # a draft never writes past the slot's reservation (the scheduler
        # already caps it by the tokens the request may still emit)
        drafts = {s: d[: max(0, len(self._slot_blocks[s]) * self.block_size
                             - int(self._lengths[s]) - 1)]
                  for s, d in drafts.items() if s in decode_slots and d}
        drafts = {s: d for s, d in drafts.items() if d}
        n_spec = _pow2_bucket(1 + max((len(d) for d in drafts.values()), default=0))
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
        tq = max(self._bucket(len(seg)) if seg else 1, n_spec)
        tokens = np.zeros((B, tq), np.int32)
        positions = np.zeros((B, tq), np.int32)
        q_valid = np.zeros((B, tq), bool)
        emit_off = np.zeros(B, np.int32)
        emit_mask = np.zeros(B, bool)
        n_valid = np.ones(B, np.int32)
        lengths_after = self._lengths.copy()
        for s in decode_slots:
            ds = drafts.get(s, [])
            nv = 1 + len(ds)
            tokens[s, 0] = self._last[s]
            tokens[s, 1:nv] = ds
            positions[s, :nv] = np.arange(self._lengths[s], self._lengths[s] + nv)
            q_valid[s, :nv] = True
            emit_mask[s] = True
            n_valid[s] = nv
            # a verify rolls a decode row forward by its emitted count
            # below; the rejected drafts' KV stays behind the position mask
            # until a later accepted write replaces it
            if n_spec == 1:
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
            n_ctx=self._ctx_width(), has_chunk=bool(seg), impl=self._impl, n_spec=n_spec,
        )
        self.last_logits = logits
        if n_spec == 1:
            out = self._sample(logits, emit_mask)[:, None]
            n_em = emit_mask.astype(np.int32)
        else:
            seeds = {int(s): self._peek_seeds(s, int(n_valid[s]))
                     for s in np.flatnonzero(emit_mask & (self._temps > 0.0))}
            out, n_em = _verify_rows(logits, tokens, self._temps, emit_mask, n_valid, seeds)
            for s in seeds:
                for _ in range(n_em[s]):
                    self._next_seed(s)
            lengths_after[decode_slots] += n_em[decode_slots]
            self.state.lengths.copy_(torch.from_numpy(lengths_after))
        self._lengths = lengths_after
        for s in decode_slots:
            self._last[s] = out[s, n_em[s] - 1]
        if seg:
            p = self._pending[cs]
            p.pos += len(seg)
            if final:
                self._last[cs] = out[cs, 0]
                self._finish_prefill(cs, p)
        return out, n_em

    def _finish_prefill(self, slot: int, p: _Prefill) -> None:
        """The prompt is prefilled: index its full blocks for later
        requests. Only now — before its last chunk a block's KV may not
        exist yet."""
        del self._pending[slot]
        if self.prefix_cache is not None:
            full = p.n // self.block_size
            self.prefix_cache.insert(p.hashes, p.row_blocks[:full])

    def _sample(self, logits: torch.Tensor, emit_mask: np.ndarray) -> np.ndarray:
        """Argmax rows at temperature 0; one draw seeded with the emission's
        seed otherwise (only for rows that emit this step). The draws stay
        on the device: one host copy for the whole step."""
        nxt = torch.argmax(logits, dim=-1)
        for s in np.flatnonzero(emit_mask & (self._temps > 0.0)):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self._next_seed(s))
            nxt[s] = _categorical(_probs(logits[s], float(self._temps[s])), gen)
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
