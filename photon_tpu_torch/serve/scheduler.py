"""Continuous batching: bounded admission queue + slot-level scheduling.

The port of ``photon_tpu/serve/scheduler.py`` without its telemetry
and autopilot hooks (``photon.chaos``'s stall per token stepped is
kept; its device-memory ramp waits for the health plane). One scheduler
thread makes every engine (and so every CUDA) call, in three phases a
tick:

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
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from photon_tpu_torch import chaos
from photon_tpu_torch.serve.draft import Drafter, NGramDrafter, SpecController
from photon_tpu_torch.serve.engine import PagedEngine


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
                 speculative=None, drafter: Drafter | None = None) -> None:
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
        with self._lock:
            self.swaps += 1
            self.last_swap_s = time.monotonic() - t0
            self.last_swap_at = time.time()
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
            }
        out.update({f"attn_{k}": v for k, v in self.engine.attn_stats().items()})
        if (a := self.engine.adapter_stats()) is not None:
            out.update({"adapter_residents": a["residents"], "adapter_cohorts": a["cohorts"],
                        "adapter_loads_total": a["loads"],
                        "adapter_evictions_total": a["evictions"],
                        "adapter_hit_rate": a["hit_rate"]})
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
        if self._spec is None:
            nxt, emitted = self.engine.mixed_step(chunk)
            out, n_em = nxt[:, None], emitted.astype(int)
        else:
            drafts = self._collect_drafts(running, chunk)
            out, n_em = self.engine.spec_step(chunk, drafts)
            with self._lock:
                self._spec.observe(sum(len(d) for d in drafts.values()),
                                   sum(max(0, int(n_em[s]) - 1) for s in drafts))
        inj = chaos.active()
        if inj is not None:
            # a stall in proportion to the tokens this step carried
            stall = inj.serve_stall_plan((chunk[1] if chunk else 0) + sum(int(x) for x in n_em))
            if stall > 0.0:
                time.sleep(stall)
        self.steps += 1
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
                self._push_token(slot, req, tok)
                if req.finished:
                    break  # EOS or max_new mid-burst: the rest is dropped
            if self._drafter is not None and not req.finished:
                self._drafter.observe(slot, burst)

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
