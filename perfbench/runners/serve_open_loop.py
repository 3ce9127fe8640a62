"""Runner ``serve_open_loop``: requests offered on a schedule to the port's
continuous batcher, in process.

Set-up makes the served weights from the seed (bf16, on the card), builds a
``serve.engine.PagedEngine`` and a ``serve.scheduler.ContinuousBatcher``
from the configuration, serves one short request (the kernels load or
build), then offers ``warm_s`` of the mix's traffic so that the slots reach
their steady occupancy. The window follows at once: the requests due in
it are measured, from when each was due. Traffic goes on after the window
until every request due in it has finished (at most ``drain_s`` past the
close); those later requests are not measured. The HTTP frontend is left
out: requests go to ``ContinuousBatcher.submit`` from a thread of this
process.

``correct``: a sample of the window's requests is drawn from the seed
before the run (the longest always among them, at least ``check_tokens``
asked-for tokens in all). While they are served, the engine's logits row
of each token they are served (the step's ``last_logits``, float32) is
copied aside on the card. Once the window has closed, the card's peak has
been read and the engine is freed, each sampled request that finished
runs through ``reference/mpt.py`` in float32, its prompt with its served
tokens, and two numbers are compared: ``logit_rel_err``, the widest
relative L2 distance, over the served positions, between the engine's
logits and the reference's; and ``logit_gap``, the widest gap by which a
served token's reference logit lies below the reference's best. Both read
the rounding of the engine's bf16 path through the paged cache; a wrong
cache entry, a dropped key block or a misplaced token reads far above it,
and an altered token reads in the second.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from perfbench import runtime, trace, traffic, weights
from perfbench.counting import forward_flops
from perfbench.reference import mpt as ref


def _rpa_shapes(q, k_pool, v_pool, layer, rows, positions, **_):
    return {"t": q.shape[1], "h": q.shape[2], "d": q.shape[3], "n_kv": k_pool.shape[3],
            "bs": k_pool.shape[2], "n_ctx": rows.shape[1], "elem": q.element_size(),
            "positions": positions.clone()}


def _plant(fault: str | None, engine):
    """The faults ``correct`` has to catch, planted in the timed path;
    returns what undoes it."""
    if fault is None:
        return lambda: None
    if fault == "state_unchanged":  # the step leaves the KV pool as it was
        import photon_tpu_torch.serve.engine as eng_mod

        step = eng_mod.mixed_chunk_step

        def frozen(params, layers, state, *args, **kwargs):
            k, v = state.cache_k.clone(), state.cache_v.clone()
            out = step(params, layers, state, *args, **kwargs)
            state.cache_k.copy_(k)
            state.cache_v.copy_(v)
            return out

        eng_mod.mixed_chunk_step = frozen
        return lambda: setattr(eng_mod, "mixed_chunk_step", step)
    if fault == "token_altered":  # a served token changed where it is sampled
        sample = engine._sample

        def altered(logits, emit_mask):
            out = sample(logits, emit_mask)
            out[emit_mask] = (out[emit_mask] + 1) % logits.shape[-1]
            return out

        engine._sample = altered
        return lambda: None
    raise ValueError(f"unknown fault {fault!r}")


class _Submitter(threading.Thread):
    """Offers each request at its due time, on the monotonic clock the
    batcher's own request times use."""

    def __init__(self, batcher, requests, origin: float, tap: "_TokenTap") -> None:
        super().__init__(name="perfbench-submitter", daemon=True)
        self.batcher, self.requests, self.origin, self.tap = batcher, requests, origin, tap
        self.sent: list[tuple] = []  # (Request, ServeRequest | None, lag_s)
        self.stop = threading.Event()

    def run(self) -> None:
        from photon_tpu_torch.serve.scheduler import QueueFullError

        for req in self.requests:
            due = self.origin + req.due
            while not self.stop.is_set() and time.monotonic() < due:
                self.stop.wait(min(0.05, max(0.0, due - time.monotonic())))
            if self.stop.is_set():
                return
            lag = time.monotonic() - due
            with self.tap.lock:  # a watched request's first token waits for its rid
                try:
                    sr = self.batcher.submit(req.prompt, req.max_new, eos_id=-1)
                except QueueFullError:
                    sr = None
                if sr is not None and id(req) in self.tap.picked:
                    self.tap.logits[sr.rid] = []
            self.sent.append((req, sr, lag))


class _TokenTap:
    """Wraps the batcher's ``_push_token`` (every emitted token passes it,
    right after its step): each request's token arrival times, and for the
    requests picked for the check (``picked``, by the ``id`` of their
    ``traffic.Request``) a copy, on the card, of the engine's logits row
    that each of their tokens was served from."""

    def __init__(self, batcher, engine, picked: set) -> None:
        self.times: dict[int, list[float]] = {}
        self.picked = picked
        self.logits: dict[int, list[torch.Tensor]] = {}  # rid -> rows
        self.lock = threading.Lock()
        push = batcher._push_token

        def wrapped(slot, req, tok):
            self.times.setdefault(req.rid, []).append(time.monotonic())
            with self.lock:
                rows = self.logits.get(req.rid)
            if rows is not None:
                rows.append(engine.last_logits[slot].float().clone())
            return push(slot, req, tok)

        batcher._push_token = wrapped


class _StepMeter:
    """Wraps the engine's ``mixed_step`` (what the batcher calls each step):
    while :attr:`on` (the traced run's window), each step's host wall and
    the forward FLOPs of the tokens it processes."""

    def __init__(self, engine, spans, m: dict) -> None:
        self.engine, self.m = engine, m
        self.on = False
        self.walls: list[float] = []
        self.flops = 0.0
        step = engine.mixed_step

        def wrapped(chunk=None, **kwargs):
            if not self.on:
                return step(chunk, **kwargs)
            self._count(chunk)
            t0 = time.perf_counter()
            with spans("engine.step"):
                out = step(chunk, **kwargs)
            self.walls.append(time.perf_counter() - t0)
            return out

        engine.mixed_step = wrapped

    def _count(self, chunk) -> None:
        eng = self.engine
        # decode rows: active slots past their prompt, one token at each cursor
        dec = [int(eng._lengths[s]) for s in np.flatnonzero(eng._active) if s not in eng._pending]
        n_tok, keys, logit_rows = len(dec), sum(p + 1 for p in dec), len(dec)
        if chunk is not None:
            slot, want = chunk
            p = eng._pending[slot]
            n = min(want, p.n - p.pos)
            n_tok += n
            keys += sum(range(p.pos + 1, p.pos + n + 1))
            logit_rows += int(p.pos + n == p.n)
        self.flops += forward_flops(self.m, n_tok, keys, logit_rows)


def _pick(window: list, seed: int, want_tokens: int) -> list:
    """The window's requests to check, chosen before the run: the longest
    (prompt and answer), then others drawn from the seed until
    ``want_tokens`` asked-for tokens are in."""
    if not window:
        return []
    order = sorted(range(len(window)), key=lambda i: -(len(window[i].prompt) + window[i].max_new))
    rng = traffic.rng_for(seed, "check")
    out, n = [], 0
    for i in [order[0]] + [int(i) for i in rng.permutation(order[1:])]:
        out.append(window[i])
        n += window[i].max_new
        if n >= want_tokens:
            break
    return out


def _compare(m: dict, p: dict, checked: list, device, precision: str) -> dict:
    """The widest relative L2 distance, over the checked positions, between
    the served logits and the reference's, and the widest gap by which the
    served token's reference logit lies below the reference's best.
    ``precision="fp8"`` puts the fp8 reference in the program's place (the
    control): its logits, and the token it puts first."""
    rel = gap = 0.0
    with ref.strict_fp32():
        for prompt, served, rows in checked:
            ids = torch.tensor(prompt + served[:-1], dtype=torch.long, device=device)
            at = torch.arange(len(prompt) - 1, len(ids), device=device)
            z = ref.token_logits(p, ids, at, m)
            if precision == "fp32":
                got = torch.stack(rows).to(device)
                tok = torch.tensor(served, dtype=torch.long, device=device)
            else:
                got = ref.token_logits(p, ids, at, m, precision)
                tok = got.argmax(dim=-1)
            err = (got - z).norm(dim=-1) / z.norm(dim=-1)
            rel = max(rel, float(err.max()))
            gap = max(gap, float((z.max(dim=-1).values - z.gather(1, tok[:, None])[:, 0]).max()))
            del got, z
    return {"logit_rel_err": rel, "logit_gap": gap}


def run(ctx: runtime.Context) -> runtime.Result:
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.serve import cache
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    conf, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    m = conf["port"]["model"]
    cfg = Config.from_dict(conf["port"])
    sc = cfg.photon.serve
    dtype = getattr(torch, cfg.model.compute_dtype)
    engine = PagedEngine(cfg, weights.nest(weights.make(m, ctx.seed, dev, dtype)), device=dev)
    batcher = ContinuousBatcher(engine, max_queue=sc.max_queue,
                                prefill_token_budget=sc.prefill_token_budget)
    undo = _plant(ctx.fault, engine)
    spans = ctx.spans
    meter = _StepMeter(engine, spans, m)
    reqs = traffic.open_loop(mix, ctx.seed, ctx.seconds, m["vocab_size"])
    picked = _pick([r for r in reqs if r.phase == "window"], ctx.seed, int(mix["check_tokens"]))
    tap = _TokenTap(batcher, engine, {id(r) for r in picked})
    recorders, record = [], None
    if ctx.trace:
        spans.on = True
        spans.wrap(batcher, "_admit_phase", "scheduler.admit")
        spans.wrap(batcher, "_step_phase", "scheduler.step")
        spans.wrap(batcher, "_record_tick", "scheduler.tick")
        recorders.append(trace.CallRecorder(cache, "ragged_paged_attention", "rpa",
                                            _rpa_shapes, kernel="rpa_"))
        record = trace.Record(conf, mix)
    batcher.start()
    submitter = None
    try:
        first = batcher.submit([1] * 16, 2, eos_id=-1)  # the kernels load
        first.result(timeout=900)
        origin = time.monotonic() + float(mix["warm_s"])
        submitter = _Submitter(batcher, reqs, origin, tap)
        submitter.start()
        time.sleep(max(0.0, origin - time.monotonic()))
        setup_s = time.perf_counter() - ctx.t_start
        backlog = {"start": batcher.load_report()}
        out0, t_open = batcher.tokens_out, time.monotonic()
        meter.on = ctx.trace
        if ctx.trace:
            with trace.profiled() as prof:
                with torch.profiler.record_function(trace.WINDOW_SPAN):
                    for r in recorders:
                        r.on = True
                    time.sleep(min(mix["trace_s"], ctx.seconds))
                    for r in recorders:
                        r.on = False
        time.sleep(max(0.0, origin + ctx.seconds - time.monotonic()))
        meter.on = False
        out1, t_close = batcher.tokens_out, time.monotonic()
        backlog["close"] = batcher.load_report()

        # the window's requests finish (load goes on), at most drain_s more
        deadline = origin + ctx.seconds + float(mix["drain_s"])
        n_window = sum(1 for r in reqs if r.phase == "window")
        while time.monotonic() < deadline:
            sent = [s for s in submitter.sent if s[0].phase == "window"]
            if len(sent) == n_window and all(s[1] is None or s[1].finished for s in sent):
                break
            time.sleep(0.05)
        submitter.stop.set()
        submitter.join(timeout=10)
        peak = runtime.peak_bytes(dev)
    finally:
        if submitter is not None:
            submitter.stop.set()
        batcher.close()
        undo()
        for r in recorders:
            r.restore()
    window = [s for s in submitter.sent if s[0].phase == "window"]
    res = _measure(window, n_window, origin, tap.times)
    # requests of any phase that finished inside the window, over its length
    res["extra"]["completed_in_window_per_s"] = sum(
        1 for _, sr, _ in submitter.sent
        if sr is not None and sr.finished and t_open <= sr.t_done <= t_close) / (t_close - t_open)
    res["extra"]["window_tokens_per_s"] = (out1 - out0) / (t_close - t_open)
    if ctx.trace:
        trace.reduce(prof, record, recorders)
        del prof
        waits = [sr.t_admit - sr.t_submit for _, sr, _ in window
                 if sr is not None and sr.t_admit > 0]
        record.host.update(queue_waits=waits, step_walls=meter.walls, flops=meter.flops,
                           seconds=ctx.seconds)
    checked = [(list(req.prompt), list(sr.generated), tap.logits[sr.rid])
               for req, sr, _ in window
               if sr is not None and sr.rid in tap.logits and sr.finished and sr.error is None
               and len(sr.generated) == len(tap.logits[sr.rid]) > 0]
    del engine, batcher, submitter, window, reqs, meter, tap
    runtime.free(dev)

    p = weights.make(m, ctx.seed, dev, dtype)
    got = _compare(m, p, checked, dev, "fp32")
    extra = {"program": got, "checked_requests": len(checked),
             "checked_tokens": sum(len(s) for _, s, _ in checked), "backlog": backlog,
             **res["extra"]}
    if ctx.control:
        extra["control"] = _compare(m, p, checked, dev, "fp8")
    del p, checked
    runtime.free(dev)
    lim = ctx.cell.limits
    checks = [(name, got[name], lim[name]) for name in lim]
    if not extra["checked_tokens"]:
        checks.append(("checked_tokens", 1.0, 0.0))  # nothing finished: nothing to judge
    return runtime.Result(attempted=n_window, failed=res["failed"], setup_s=setup_s,
                          e2e=res["e2e"], memory_peak_bytes=peak, checks=checks,
                          record=record, extra=extra)


def _measure(window: list, n_window: int, origin: float, token_times: dict) -> dict:
    """TTFT from when each request was due; the gaps between consecutive
    tokens of every request; a refused or unfinished request counts as
    failed, its TTFT and each gap it asked for as infinite."""
    inf = float("inf")
    ttft, tpot, gaps, out_tokens, last_done = [], [], [], 0, origin
    failed = n_window - len(window)
    for req, sr, _ in window:
        if sr is None or not sr.finished or sr.error is not None or not sr.generated:
            failed += 1
            ttft.append(inf)
            tpot.append(inf)
            gaps += [inf] * max(1, req.max_new - 1)
            continue
        ttft.append(sr.t_first - (origin + req.due))
        n = len(sr.generated)
        tpot.append((sr.t_done - sr.t_first) / (n - 1) if n > 1 else 0.0)
        times = token_times.get(sr.rid, [])
        gaps += [b - a for a, b in zip(times, times[1:])]
        out_tokens += n
        last_done = max(last_done, sr.t_done)
    ttft += [inf] * (n_window - len(window))
    tpot += [inf] * (n_window - len(window))
    e2e = {"ttft_p90_ms": runtime.percentile(ttft, 90) * 1e3,
           "itl_p99_ms": runtime.percentile(gaps, 99) * 1e3}
    extra = {"window_requests": n_window, "token_gaps": len(gaps),
             "ttft_p50_ms": runtime.percentile(ttft, 50) * 1e3,
             "ttft_p95_ms": runtime.percentile(ttft, 95) * 1e3,
             "tpot_p50_ms": runtime.percentile(tpot, 50) * 1e3,
             "tpot_p90_ms": runtime.percentile(tpot, 90) * 1e3,
             "tpot_p95_ms": runtime.percentile(tpot, 95) * 1e3,
             "itl_p50_ms": runtime.percentile(gaps, 50) * 1e3,
             "itl_p90_ms": runtime.percentile(gaps, 90) * 1e3,
             "itl_p95_ms": runtime.percentile(gaps, 95) * 1e3,
             "window_to_last_done_s": last_done - origin,
             "due_tokens_per_s": out_tokens / max(last_done - origin, 1e-9),
             "generator_lag_max_s": max((lag for _, _, lag in window), default=0.0)}
    return {"e2e": e2e, "failed": failed, "extra": extra}
