"""Continuous batching: bounded admission queue + slot-level scheduling.

The port of ``photon_tpu/serve/scheduler.py``. One scheduler thread makes
every engine (and so every CUDA) call, in three phases a tick:

1. **swap point** — a staged parameter swap (:meth:`request_swap`, the
   hot-swap watcher's) applies once no slot is active; while one is
   staged, admission pauses and running requests finish on the old
   params;
2. **admit** — pop FIFO from the bounded queue into free slots while the
   pool can cover each request's worst-case block reservation, counting
   prefix-cache hits and, for a request of a cohort, a page for its
   adapter (``engine.begin``: pin the page, reserve blocks, install the
   table row — no model compute);
3. **step** — one mixed engine step: every decoding slot advances and the
   oldest prefilling request's next prompt chunk, at most
   ``prefill_token_budget`` tokens, rides in the same step. With
   speculative decoding on (``serve.speculative``), each decoding row may
   also carry up to K drafted tokens, verified in the same step: the
   accepted prefix plus one model token emit at once. Rows that hit their
   EOS or ``max_new_tokens`` (mid-burst: the rest of the burst is dropped)
   are evicted at once, so the next admit phase refills their slots.

Backpressure is reject-not-buffer: :meth:`ContinuousBatcher.submit`
raises :class:`QueueFullError` when ``max_queue`` requests already wait
(the HTTP 429). Admission is strictly FIFO: a head request that does not
fit blocks later arrivals rather than being overtaken.

Every tick records the ``serve/*`` KPIs of the registry into
:attr:`ContinuousBatcher.history` (the frontend's ``/metrics``). With
``photon.telemetry`` on, a finished request is a ``serve/request`` span
with its queue, prefill and decode children, its TTFT, queue wait and
TPOT are histogram observations (the exemplar links the request's span),
a swap is a ``serve/hotswap_swap`` span, histogram observation and event,
the tick's gauges and counters land in the hub, device memory and the
kernel-build count are sampled every ``device_sample_ticks`` ticks, the
queue-saturation and memory-growth watchers run, and a tick is a unit of
an on-demand profile. ``photon.chaos``'s stall per token stepped and its
device-memory ramp land here too.

With ``telemetry.autopilot`` on, the batcher registers its knobs at
construction (``serve/prefill_token_budget``, ``serve/spec_k_max`` with
speculation on, and the ``serve/memory_reclaim`` action,
:meth:`ContinuousBatcher.reclaim_memory`), and each tick ends with the
autopilot's ``serve`` evaluation; a tick is also the retrace sentinel's
``serve/tick`` steady point. Each is one ``None`` check when off.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from photon_tpu_torch import chaos, telemetry
from photon_tpu_torch.analysis.runtime import steady_point
from photon_tpu_torch.metrics.history import History
from photon_tpu_torch.serve.draft import Drafter, NGramDrafter, SpecController
from photon_tpu_torch.serve.engine import PagedEngine
from photon_tpu_torch.utils.profiling import (
    AUTOPILOT_ACTION_RECLAIM,
    AUTOPILOT_KNOB_PREFILL_BUDGET,
    AUTOPILOT_KNOB_SPEC_K_MAX,
    EVENT_HOTSWAP_SWAPPED,
    SERVE_ADAPTER_COHORTS,
    SERVE_ADAPTER_EVICTIONS,
    SERVE_ADAPTER_HIT_RATE,
    SERVE_ADAPTER_LOADS,
    SERVE_ADAPTER_RESIDENTS,
    SERVE_ATTN_CTX_BLOCKS,
    SERVE_ATTN_LIVE_FRAC,
    SERVE_ATTN_RAGGED,
    SERVE_CHUNK_SPLIT_PROMPTS,
    SERVE_CHUNK_STEPS,
    SERVE_CHUNK_TOKENS,
    SERVE_COMPILES_TOTAL,
    SERVE_DECODE_SPAN,
    SERVE_EVICTIONS,
    SERVE_HBM_BYTES_IN_USE,
    SERVE_HBM_PEAK_BYTES,
    SERVE_HOTSWAP_ROUND,
    SERVE_HOTSWAP_SWAP_LATENCY_S,
    SERVE_HOTSWAP_SWAP_SPAN,
    SERVE_HOTSWAP_SWAPS_TOTAL,
    SERVE_PREFILL_SPAN,
    SERVE_PREFIX_EVICTIONS,
    SERVE_PREFIX_HIT_RATE,
    SERVE_PREFIX_SHARED_BLOCKS,
    SERVE_PREFIX_TOKENS_CACHED,
    SERVE_QUEUE_DEPTH,
    SERVE_QUEUE_SPAN,
    SERVE_QUEUE_WAIT_S,
    SERVE_REJECTED,
    SERVE_REQUEST_SPAN,
    SERVE_SLOT_OCCUPANCY,
    SERVE_SPEC_ACCEPT_RATE,
    SERVE_SPEC_ACCEPTED,
    SERVE_SPEC_DRAFTED,
    SERVE_SPEC_K,
    SERVE_SPEC_STEPS,
    SERVE_TOKENS_PER_S,
    SERVE_TPOT_S,
    SERVE_TTFT_S,
)

#: the tick KPIs mirrored into the typed hub as gauges (point-in-time) and
#: as counters (cumulative), when present in a tick's KPIs
_TICK_GAUGES = (SERVE_QUEUE_DEPTH, SERVE_SLOT_OCCUPANCY, SERVE_SPEC_ACCEPT_RATE, SERVE_SPEC_K,
                SERVE_ATTN_CTX_BLOCKS, SERVE_ATTN_LIVE_FRAC, SERVE_ATTN_RAGGED,
                SERVE_HOTSWAP_ROUND, SERVE_ADAPTER_RESIDENTS, SERVE_ADAPTER_COHORTS,
                SERVE_ADAPTER_HIT_RATE, SERVE_PREFIX_HIT_RATE, SERVE_PREFIX_SHARED_BLOCKS)
_TICK_COUNTERS = (SERVE_EVICTIONS, SERVE_REJECTED, SERVE_HOTSWAP_SWAPS_TOTAL, SERVE_CHUNK_STEPS,
                  SERVE_CHUNK_TOKENS, SERVE_CHUNK_SPLIT_PROMPTS, SERVE_SPEC_DRAFTED,
                  SERVE_SPEC_ACCEPTED, SERVE_SPEC_STEPS, SERVE_ADAPTER_LOADS,
                  SERVE_ADAPTER_EVICTIONS, SERVE_PREFIX_EVICTIONS, SERVE_PREFIX_TOKENS_CACHED)


class QueueFullError(RuntimeError):
    """Admission queue at ``max_queue`` — the HTTP frontend's 429."""


class DrainingError(RuntimeError):
    """The batcher is draining (SIGTERM) — the HTTP frontend's 503."""


class EngineFailedError(RuntimeError):
    """The engine holds no params after a failed swap — the HTTP
    frontend's 503 until a later swap succeeds."""


@dataclass
class ServeRequest:
    """One generation request and its streaming output channel."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: int | None = None
    #: the adapter cohort whose LoRA factors decode this request; None =
    #: the bare base model
    cohort: str | None = None
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    generated: list[int] = field(default_factory=list)
    error: str | None = None
    finished: bool = False
    _out: "queue.Queue[int | None]" = field(default_factory=queue.Queue)

    def stream(self, timeout: float = 60.0):
        """Yield generated token ids as they land; raises RuntimeError if
        the request failed server-side."""
        while True:
            tok = self._out.get(timeout=timeout)
            if tok is None:
                if self.error:
                    raise RuntimeError(self.error)
                return
            yield tok

    def result(self, timeout: float = 60.0) -> list[int]:
        """Block until completion; the full generated-token list."""
        for _ in self.stream(timeout=timeout):
            pass
        return self.generated

    @property
    def ttft_s(self) -> float:
        return max(0.0, self.t_first - self.t_submit)


class ContinuousBatcher:
    """Single-thread scheduler over a :class:`PagedEngine`."""

    def __init__(self, engine: PagedEngine, *, max_queue: int = 64,
                 prefill_token_budget: int = 2048,
                 default_eos_id: int | None = None,
                 speculative=None, drafter: Drafter | None = None,
                 history: History | None = None) -> None:
        self.engine = engine
        self.max_queue = max_queue
        self.prefill_token_budget = prefill_token_budget
        self.default_eos_id = default_eos_id
        # speculative decoding: ``speculative`` is a SpeculativeConfig;
        # ``drafter`` replaces the n-gram drafter. Silently off for MoE,
        # whose batch-global expert capacity breaks per-row verification
        # (the prefix cache makes the same call)
        self._spec: SpecController | None = None
        self._drafter: Drafter | None = None
        self._spec_budget = 0
        if speculative is not None and speculative.enabled \
                and getattr(getattr(engine, "mc", None), "mlp", None) != "moe":
            self._drafter = drafter if drafter is not None else NGramDrafter(
                speculative.max_ngram, speculative.min_ngram)
            self._spec = SpecController(
                speculative.k, accept_floor=speculative.accept_floor,
                ewma_alpha=speculative.ewma_alpha, probe_ticks=speculative.probe_ticks)
            self._spec_budget = speculative.draft_budget
        self.history = history if history is not None else History()
        self._tick = 0
        #: per-KPI History cap: /metrics renders the latest value only, so
        #: old ticks are trimmed instead of growing for the server's life
        self.max_kpi_ticks = 4096
        #: device memory and the kernel-build count are sampled every N
        #: ticks, not every tick
        self.device_sample_ticks = 64
        self._queue: deque[ServeRequest] = deque()
        self._running: dict[int, ServeRequest] = {}  # slot -> request
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stop = False
        self._draining = False
        self._thread: threading.Thread | None = None
        self._rid = itertools.count()
        # cumulative counters (read by /healthz)
        self.rejected = 0
        self.evictions = 0
        self.completed = 0
        self.swaps = 0
        self.recycles = 0  # soft restarts (:meth:`recycle`) completed
        self.last_swap_s = 0.0  # the last swap's latency, staged to applied
        self.last_swap_at = 0.0  # its wall time when applied
        #: (params, round, done event, t_request) staged by request_swap,
        #: applied by the scheduler thread with no slot active
        self._pending_swap: tuple | None = None
        self.steps = 0
        self.tokens_out = 0
        self.chunk_steps = 0
        self.chunk_tokens = 0
        self.chunk_split_prompts = 0
        self.admitted_order: deque[int] = deque(maxlen=4096)  # FIFO audit
        # the SLO autopilot's knobs, registered at construction so the
        # controller only drives a batcher that exists; their current
        # values are the declared optima a relax probes back toward
        ap = telemetry.autopilot_active()
        if ap is not None:
            ap.register_knob(AUTOPILOT_KNOB_PREFILL_BUDGET, lambda: self.prefill_token_budget,
                             self.set_prefill_token_budget, integer=True)
            if self._spec is not None:
                ap.register_knob(AUTOPILOT_KNOB_SPEC_K_MAX, lambda: self._spec.k_max,
                                 self._spec.set_k_max, integer=True)
            ap.register_action(AUTOPILOT_ACTION_RECLAIM,
                               lambda: self.reclaim_memory(int(ap.cfg.reclaim_free_blocks)))

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ContinuousBatcher":
        self._thread = threading.Thread(target=self._loop, name="photon-serve-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        with self._work:
            self._stop = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def _wait_idle(self, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue and not self._running:
                    return True
            time.sleep(0.01)
        return False

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: refuse new submissions at once, let queued
        and running requests finish within ``timeout_s``, then stop (what
        is still unfinished then fails with "server shutting down").
        A swap staged before the drain is abandoned, not applied (its
        waiter is released). Returns True when nothing was dropped."""
        with self._work:
            self._draining = True
            pending, self._pending_swap = self._pending_swap, None
            self._work.notify_all()
        if pending is not None:
            pending[2].set()
        drained = self._wait_idle(timeout_s)
        self.close()
        return drained

    # -- knobs and actions the autopilot drives ---------------------------
    def set_prefill_token_budget(self, budget: int) -> None:
        """A new chunk budget at run time (the autopilot shrinks it under a
        queue storm, so decode keeps its cadence while the backlog drains,
        and probes it back when the breach clears). A value below 1 raises
        and leaves the budget as it was."""
        b = int(budget)
        if b < 1:
            raise ValueError(f"prefill_token_budget must be >= 1, got {budget}")
        with self._lock:
            self.prefill_token_budget = b

    def reclaim_memory(self, min_free_blocks: int = 8) -> tuple[float, float]:
        """The memory-pressure action: evict unpinned prefix-cache entries
        until the block pool has ``min_free_blocks`` free, then shrink the
        adapter pool's unpinned pages. Both skip what a running slot
        references. Returns the pool's ``(free blocks before, after)``, the
        decision record's old and new. Runs on the scheduler thread (the
        autopilot's ``serve`` tick), which owns the cache and the pool."""
        eng = self.engine
        alloc = getattr(eng, "allocator", None)
        before = float(alloc.free_blocks) if alloc is not None else 0.0
        pc = getattr(eng, "prefix_cache", None)
        if pc is not None:
            pc.ensure_free(int(min_free_blocks))
        pool = getattr(eng, "adapter_pool", None)
        if pool is not None:
            pool.shrink()
        after = float(alloc.free_blocks) if alloc is not None else before
        return before, after

    def recycle(self, timeout_s: float = 30.0) -> bool:
        """Soft restart (a fleet replica's ``restart`` action): refuse new
        requests, wait at most ``timeout_s`` for queued and running work
        to finish, flush the prefix cache and shrink the adapter pool's
        unpinned pages, then take requests again. Unlike :meth:`drain`
        the scheduler thread keeps running. Returns True when the engine
        went idle within the bound (the caches are reclaimed either way:
        a block or page a running slot holds keeps its slot's reference)."""
        with self._work:
            if self._stop:
                return False
            self._draining = True
            self._work.notify_all()
        idle = self._wait_idle(timeout_s)
        try:
            if self.engine.prefix_cache is not None:
                self.engine.prefix_cache.flush()
            if self.engine.adapter_pool is not None:
                self.engine.adapter_pool.shrink()
        finally:
            with self._work:
                self._draining = False
                self.recycles += 1
                self._work.notify_all()
        return idle

    # -- live checkpoint hot-swap -----------------------------------------
    def request_swap(self, params: dict, loaded_round: int | None = None,
                     adapter_bank: dict | None = None) -> threading.Event:
        """Stage a parameter swap; the returned Event is set once the
        scheduler thread has applied it (or given it up). Admission pauses
        (queued and new requests wait, none is dropped), running slots
        finish on the old params, then the engine swaps and flushes its
        prefix cache. ``adapter_bank`` rides the same staged swap, so the
        base and the cohorts' adapters change together and no request
        decodes the new base through the old adapters. A draining or
        stopped batcher refuses (:class:`DrainingError`)."""
        with self._work:
            if self._stop or self._draining:
                raise DrainingError("batcher draining/stopped: swap refused")
            if self._pending_swap is not None:
                raise RuntimeError("a param swap is already pending")
            done = threading.Event()
            self._pending_swap = (params, loaded_round, done, time.monotonic(), adapter_bank)
            self._work.notify_all()
        return done

    @property
    def swap_pending(self) -> bool:
        with self._lock:
            return self._pending_swap is not None

    def _maybe_swap(self) -> None:
        """The swap point (scheduler thread, between steps): applies a staged
        swap once no slot is active. The swap is claimed under the lock,
        so exactly one of apply and a drain's abandon happens."""
        with self._lock:
            if self._pending_swap is None or self._running:
                return
            params, rnd, done, t0, bank = self._pending_swap
            self._pending_swap = None
        try:
            self.engine.set_params(params, loaded_round=rnd, adapter_bank=bank)
        except BaseException:
            # release the waiter (it sees the round unchanged); the loop's
            # handler fails in-flight requests loudly, and the admit phase
            # fails queued ones while the engine is left failed
            done.set()
            raise
        latency = time.monotonic() - t0
        with self._lock:
            self.swaps += 1
            self.last_swap_s = latency
            self.last_swap_at = time.time()
        tr = telemetry.active()
        if tr is not None:
            tr.add_span(SERVE_HOTSWAP_SWAP_SPAN, time.time() - latency, latency,
                        round=-1 if rnd is None else int(rnd))
        telemetry.metric_observe(SERVE_HOTSWAP_SWAP_LATENCY_S, latency)
        telemetry.emit_event(EVENT_HOTSWAP_SWAPPED, round=-1 if rnd is None else int(rnd),
                             latency_s=round(latency, 6))
        done.set()

    # -- submission (any thread) ------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int, *,
               temperature: float = 0.0, seed: int = 0,
               eos_id: int | None = None, cohort: str | None = None) -> ServeRequest:
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if not self.engine.fits(len(prompt), max_new_tokens):
            raise ValueError(
                f"request needs {len(prompt)}+{max_new_tokens} tokens — over "
                "this server's context capacity"
            )
        # an unknown cohort is refused here (the HTTP 400): queued, it could
        # never be admitted and would block the FIFO head for good
        if cohort is not None and not self.engine.has_cohort(cohort):
            pool = self.engine.adapter_pool
            raise ValueError(f"unknown adapter cohort {cohort!r} — this server serves "
                             f"{pool.cohorts() if pool is not None else []}")
        # eos_id: None → server default; negative → explicitly no EOS
        eos = self.default_eos_id if eos_id is None else (None if eos_id < 0 else int(eos_id))
        req = ServeRequest(
            rid=next(self._rid), prompt=list(prompt), max_new_tokens=max_new_tokens,
            temperature=temperature, seed=seed, eos_id=eos, cohort=cohort,
            t_submit=time.monotonic(),
        )
        with self._work:
            if self._stop:
                raise RuntimeError("batcher is shut down")
            if self._draining:
                raise DrainingError("server draining: not accepting new requests")
            if self.engine.failed:
                raise EngineFailedError(self.engine.failed)
            if len(self._queue) >= self.max_queue:
                self.rejected += 1
                raise QueueFullError(f"admission queue full ({self.max_queue} waiting)")
            self._queue.append(req)
            self._work.notify_all()
        return req

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def load_report(self) -> dict:
        """Queue length, live-slot fraction and draining flag, in one lock."""
        with self._lock:
            return {
                "queue_depth": len(self._queue),
                "live_slot_frac": len(self._running) / self.engine.n_slots,
                "draining": self._draining or self._stop,
            }

    def spec_stats(self) -> dict | None:
        """Speculative-decoding counters for /healthz (None when off)."""
        if self._spec is None:
            return None
        with self._lock:
            return {"drafted": self._spec.drafted, "accepted": self._spec.accepted,
                    "spec_steps": self._spec.spec_steps,
                    "accept_ewma": round(self._spec.ewma, 4),
                    "k": self._spec.k_effective()}

    def stats(self) -> dict[str, float]:
        with self._lock:
            out = {
                "queue_depth": float(len(self._queue)),
                "slot_occupancy": len(self._running) / self.engine.n_slots,
                "evictions": float(self.evictions),
                "rejected": float(self.rejected),
                "completed": float(self.completed),
                "steps": float(self.steps),
                "tokens_out": float(self.tokens_out),
                "chunk_steps": float(self.chunk_steps),
                "chunk_tokens": float(self.chunk_tokens),
                "chunk_split_prompts": float(self.chunk_split_prompts),
                "swaps": float(self.swaps),
                "recycles": float(self.recycles),
            }
        out.update({f"attn_{k}": v for k, v in self.engine.attn_stats().items()})
        if (a := self.engine.adapter_stats()) is not None:
            out.update({"adapter_residents": a["residents"], "adapter_cohorts": a["cohorts"],
                        "adapter_loads_total": a["loads"],
                        "adapter_evictions_total": a["evictions"],
                        "adapter_hit_rate": a["hit_rate"]})
        return out

    def kpis(self) -> dict[str, float]:
        """This tick's ``serve/*`` KPIs under the registry's names (what
        :attr:`history` records each tick and ``/metrics`` renders)."""
        with self._lock:
            out = {
                SERVE_QUEUE_DEPTH: float(len(self._queue)),
                SERVE_SLOT_OCCUPANCY: len(self._running) / self.engine.n_slots,
                SERVE_EVICTIONS: float(self.evictions),
                SERVE_REJECTED: float(self.rejected),
                SERVE_HOTSWAP_SWAPS_TOTAL: float(self.swaps),
                SERVE_CHUNK_STEPS: float(self.chunk_steps),
                SERVE_CHUNK_TOKENS: float(self.chunk_tokens),
                SERVE_CHUNK_SPLIT_PROMPTS: float(self.chunk_split_prompts),
            }
            if self._spec is not None:
                out[SERVE_SPEC_DRAFTED] = float(self._spec.drafted)
                out[SERVE_SPEC_ACCEPTED] = float(self._spec.accepted)
                out[SERVE_SPEC_STEPS] = float(self._spec.spec_steps)
                out[SERVE_SPEC_ACCEPT_RATE] = round(self._spec.ewma, 4)
                out[SERVE_SPEC_K] = float(self._spec.k_effective())
        # getattr: a minimal engine (a test's) need not carry the
        # checkpoint, attention, prefix or adapter planes
        rnd = getattr(self.engine, "loaded_round", None)
        if rnd is not None:
            out[SERVE_HOTSWAP_ROUND] = float(rnd)
        if (attn := getattr(self.engine, "attn_stats", None)) is not None:
            a = attn()
            out[SERVE_ATTN_CTX_BLOCKS] = a["ctx_blocks"]
            out[SERVE_ATTN_LIVE_FRAC] = a["live_frac"]
            out[SERVE_ATTN_RAGGED] = a["ragged"]
        if (pc := getattr(self.engine, "prefix_cache", None)) is not None:
            out[SERVE_PREFIX_HIT_RATE] = pc.hit_rate
            out[SERVE_PREFIX_SHARED_BLOCKS] = float(len(pc))
            out[SERVE_PREFIX_EVICTIONS] = float(pc.evictions)
            out[SERVE_PREFIX_TOKENS_CACHED] = float(pc.tokens_cached)
        ast = getattr(self.engine, "adapter_stats", None)
        if ast is not None and (a := ast()) is not None:
            out[SERVE_ADAPTER_RESIDENTS] = a["residents"]
            out[SERVE_ADAPTER_COHORTS] = a["cohorts"]
            out[SERVE_ADAPTER_LOADS] = a["loads"]
            out[SERVE_ADAPTER_EVICTIONS] = a["evictions"]
            out[SERVE_ADAPTER_HIT_RATE] = a["hit_rate"]
        return out

    # -- scheduler loop ----------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._work:
                while (not self._stop and not self._queue and not self._running
                       and self._pending_swap is None):
                    self._work.wait(timeout=0.5)
                if self._stop:
                    break
            try:
                self._maybe_swap()
                self._admit_phase()
                self._step_phase()
            except Exception as e:  # noqa: BLE001 — fail loudly, not silently
                self._fail_all(f"{type(e).__name__}: {e}")
            self._record_tick()
            # the retrace sentinel bills a kernel build since the last tick
            # to this one (one None check when none is installed)
            steady_point("serve/tick")
            # a tick is a unit of an on-demand profile (one None check when
            # nothing is armed)
            telemetry.profile_tick("serve/tick")
        self._drain_on_stop()

    def _admit_phase(self) -> None:
        if self.engine.failed:
            self._fail_queued(self.engine.failed)
            return
        if self.swap_pending:
            return  # quiesce toward the swap point: queued requests wait
        while True:
            with self._lock:
                head = self._queue[0] if self._queue else None
            if head is None:
                return
            slot = self.engine.free_slot()
            if slot is None or not self.engine.can_admit(
                    len(head.prompt), head.max_new_tokens, prompt=head.prompt,
                    cohort=head.cohort):
                return  # FIFO head-blocking: nobody overtakes
            # the head stays queued until it runs (only this thread pops),
            # so an idle check (drain, recycle) never sees it in neither
            req = head
            req.t_admit = time.monotonic()
            try:
                self.engine.begin(slot, req.prompt, req.max_new_tokens,
                                  temperature=req.temperature, seed=req.seed, cohort=req.cohort)
            except Exception as e:  # noqa: BLE001 — fail THIS request, keep serving
                with self._lock:
                    self._queue.popleft()
                req.finished = True
                req.error = f"admission failed: {type(e).__name__}: {e}"
                req.t_first = req.t_done = time.monotonic()
                self._emit_spans(req)
                req._out.put(None)
                continue
            self.admitted_order.append(req.rid)
            if self._drafter is not None:
                self._drafter.begin(slot, req.prompt)
            with self._lock:
                self._queue.popleft()
                self._running[slot] = req
            if self.engine.pending_tokens(slot) > self.prefill_token_budget:
                self.chunk_split_prompts += 1

    def _step_phase(self) -> None:
        """One mixed step: all decoding slots advance (a drafted row by its
        accepted drafts and one model token); the oldest prefilling
        request (by rid) contributes its next chunk."""
        with self._lock:
            running = dict(self._running)
        if not running:
            return
        chunk = None
        prefilling = [(slot, req) for slot, req in running.items()
                      if self.engine.pending_tokens(slot) > 0]
        if prefilling:
            slot, _ = min(prefilling, key=lambda it: it[1].rid)
            chunk = (slot, min(self.engine.pending_tokens(slot), self.prefill_token_budget))
            self.chunk_steps += 1
            self.chunk_tokens += chunk[1]
        t0 = time.monotonic()
        if self._spec is None:
            nxt, emitted = self.engine.mixed_step(chunk)
            out, n_em = nxt[:, None], emitted.astype(int)
        else:
            drafts = self._collect_drafts(running, chunk)
            out, n_em = self.engine.spec_step(chunk, drafts)
            with self._lock:
                self._spec.observe(sum(len(d) for d in drafts.values()),
                                   sum(max(0, int(n_em[s]) - 1) for s in drafts))
        dt = time.monotonic() - t0
        inj = chaos.active()
        if inj is not None:
            # a stall in proportion to the tokens this step carried
            stall = inj.serve_stall_plan((chunk[1] if chunk else 0) + sum(int(x) for x in n_em))
            if stall > 0.0:
                time.sleep(stall)
        self.steps += 1
        n_tokens = 0
        for slot in sorted(running):
            n = int(n_em[slot])
            if n < 1:
                continue  # mid-prefill: nothing to stream yet
            req = self._running.get(slot)
            if req is None or req.finished:
                continue
            if not req.generated:
                req.t_first = time.monotonic()
            burst = []
            for j in range(n):
                tok = int(out[slot, j])
                burst.append(tok)
                self.tokens_out += 1
                n_tokens += 1
                self._push_token(slot, req, tok)
                if req.finished:
                    break  # EOS or max_new mid-burst: the rest is dropped
            if self._drafter is not None and not req.finished:
                self._drafter.observe(slot, burst)
        if dt > 0 and n_tokens:
            self.history.record(self._tick, {SERVE_TOKENS_PER_S: n_tokens / dt})

    def _collect_drafts(self, running: dict, chunk) -> dict[int, list[int]]:
        """This step's drafts: the throttle's depth, then the drafter's
        guess for each decoding slot, under a per-step budget composed
        with the prefill budget (a step carrying a C-token chunk drafts at
        most ``min(draft_budget, prefill_token_budget - C)``); a row drafts
        at most ``remaining - 1`` tokens."""
        k_eff = self._spec.next_k()
        if k_eff < 1:
            return {}
        budget = self._spec_budget
        if chunk is not None:
            budget = min(budget, self.prefill_token_budget - chunk[1])
        if budget < 1:
            return {}
        drafts: dict[int, list[int]] = {}
        for slot, req in sorted(running.items()):
            if req.finished or self.engine.pending_tokens(slot) > 0:
                continue
            k_s = min(k_eff, req.max_new_tokens - len(req.generated) - 1, budget)
            if k_s < 1:
                continue
            d = self._drafter.propose(slot, k_s)
            if d:
                drafts[slot] = d
                budget -= len(d)
                if budget < 1:
                    break
        return drafts

    def _push_token(self, slot: int, req: ServeRequest, tok: int) -> None:
        req.generated.append(tok)
        req._out.put(tok)
        if (req.eos_id is not None and tok == req.eos_id) \
                or len(req.generated) >= req.max_new_tokens:
            self._finish(slot, req)

    def _finish(self, slot: int, req: ServeRequest, error: str | None = None) -> None:
        req.finished = True
        req.error = error
        req.t_done = time.monotonic()
        self.engine.evict(slot)
        if self._drafter is not None:
            self._drafter.end(slot)
        with self._lock:
            self._running.pop(slot, None)
            self.evictions += 1
            if error is None:
                self.completed += 1
        if error is None:
            self.history.record(self._tick, {SERVE_TTFT_S: req.ttft_s})
        ctx = self._emit_spans(req)
        self._observe_request(req, ctx, error)
        req._out.put(None)

    def _fail_all(self, msg: str) -> None:
        """An engine error poisons every in-flight request (their cache
        state is unknown): fail them loudly and keep serving the queue."""
        with self._lock:
            running = list(self._running.items())
        for slot, req in running:
            self._finish(slot, req, error=msg)

    def _fail_queued(self, msg: str) -> None:
        with self._lock:
            queued, self._queue = list(self._queue), deque()
        for req in queued:
            req.finished = True
            req.error = msg
            req._out.put(None)

    def _drain_on_stop(self) -> None:
        with self._lock:
            running = list(self._running.items())
            # a swap the stopped loop will never apply: release its waiter
            pending, self._pending_swap = self._pending_swap, None
        if pending is not None:
            pending[2].set()
        for slot, req in running:
            self._finish(slot, req, error="server shutting down")
        self._fail_queued("server shutting down")

    # -- telemetry ---------------------------------------------------------
    def _record_tick(self) -> None:
        self._tick += 1
        stats = self.kpis()
        hub = telemetry.metrics_active()
        if hub is not None:
            for k in _TICK_GAUGES:
                if k in stats:
                    hub.gauge(k).set(stats[k])
            for k in _TICK_COUNTERS:
                if k in stats:
                    hub.counter(k).inc_to(stats[k])
            if (self._tick - 1) % self.device_sample_ticks == 0:
                # sparse: a memory_stats() call every tick would tax the
                # decode cadence
                from photon_tpu_torch.telemetry.introspect import sample_device_plane

                sample_device_plane(stats, hub, hbm_key=SERVE_HBM_BYTES_IN_USE,
                                    peak_key=SERVE_HBM_PEAK_BYTES,
                                    compiles_key=SERVE_COMPILES_TOTAL)
        health = telemetry.health_active()
        if health is not None:
            health.check_serve_tick(queue_depth=int(stats[SERVE_QUEUE_DEPTH]),
                                    max_queue=self.max_queue)
            hbm = stats.get(SERVE_HBM_BYTES_IN_USE)
            # chaos's device-memory ramp: a strictly monotone inflation of
            # the sample (made up where no device reports) so the growth
            # watcher latches deterministically
            inj = chaos.active()
            if inj is not None:
                ramp = inj.hbm_ramp_plan()
                if ramp > 0.0:
                    hbm = (hbm if hbm is not None else 1.0) * (1.0 + ramp)
            if hbm is not None:
                health.note_hbm_sample(hbm, plane="serve")
        self.history.record(self._tick, stats)
        for series in self.history.rounds.values():
            if len(series) > self.max_kpi_ticks:
                del series[: len(series) - self.max_kpi_ticks]
        # the autopilot's serve-plane evaluation (one None check when off,
        # a period-gated rule sweep when on)
        ap = telemetry.autopilot_active()
        if ap is not None:
            ap.tick("serve", max_queue=self.max_queue)

    def _observe_request(self, req: ServeRequest, ctx: tuple | None,
                         error: str | None) -> None:
        """A finished request's TTFT, queue wait and TPOT (decode seconds
        per output token after the first) into the typed hub, the request's
        span as the exemplar. A failed request stays out of the latency
        histograms; one None check with telemetry off."""
        hub = telemetry.metrics_active()
        if hub is None or error is not None:
            return
        hub.histogram(SERVE_TTFT_S).observe(req.ttft_s, exemplar=ctx)
        if req.t_admit:
            hub.histogram(SERVE_QUEUE_WAIT_S).observe(max(0.0, req.t_admit - req.t_submit),
                                                      exemplar=ctx)
        n = len(req.generated)
        if n > 1 and req.t_done > req.t_first:
            hub.histogram(SERVE_TPOT_S).observe((req.t_done - req.t_first) / (n - 1),
                                                exemplar=ctx)

    def _emit_spans(self, req: ServeRequest) -> tuple | None:
        """The request's phases as completed spans: a ``serve/request``
        umbrella with queue, prefill and decode children, anchored on the
        wall clock at emit time (the phase bounds are monotonic). Returns
        the umbrella's ``(trace_id, span_id)`` for the exemplars, or None
        with telemetry off."""
        tr = telemetry.active()
        if tr is None:
            return None
        now_wall, now_mono = time.time(), time.monotonic()

        def wall(t_mono: float) -> float:
            return now_wall - (now_mono - t_mono)

        umbrella = tr.add_span(
            SERVE_REQUEST_SPAN, wall(req.t_submit), req.t_done - req.t_submit,
            rid=req.rid, n_prompt=len(req.prompt), n_generated=len(req.generated),
            error=req.error or "",
        )
        parent = (umbrella.trace_id, umbrella.span_id)
        for name, a, b in ((SERVE_QUEUE_SPAN, req.t_submit, req.t_admit or req.t_done),
                           (SERVE_PREFILL_SPAN, req.t_admit, req.t_first),
                           (SERVE_DECODE_SPAN, req.t_first, req.t_done)):
            if a and b >= a:
                tr.add_span(name, wall(a), b - a, parent=parent, rid=req.rid)
        return parent
