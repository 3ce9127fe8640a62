"""Streaming in-place weighted aggregation (the port of
``photon_tpu/strategy/aggregation.py``, host-side numpy as there).

Client results are consumed one at a time from a generator, so only one
client's tensors are resident beyond the running average, maintaining

    x_i = x_i * (n_prev / n_new) + y_i * (n_cur / n_new)

per layer in an fp64 accumulator (a fused, chunked, in-place pass: no
full-payload fp64 copy of a client). With a :class:`HostPool` of more than
one thread the per-array folds run in parallel and ONE lookahead worker
fetches (and decodes) the next result while the current one folds. A
result may be a compressed payload, decoded here one client at a time
through the ``decode`` hook, so memory stays O(1) in client count. Every
mode applies
the same per-element operations in the same order as the JAX package, so
the average is bit-identical across modes and across the two packages.
With ``photon.telemetry`` on, each client's decode and fold is a span
under the calling thread's round span and an observation in the
``server/agg_decode_time`` / ``server/agg_fold_time`` histograms.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator

import numpy as np

from photon_tpu_torch import telemetry
from photon_tpu_torch.utils.hostpool import HostPool
from photon_tpu_torch.utils.profiling import AGG_DECODE_TIME, AGG_FOLD_TIME

#: elements per fold chunk (~8 MB of fp64 transient)
_FOLD_CHUNK = 1 << 20


def _fold_into(acc: np.ndarray, y: np.ndarray, w_prev: float, w_cur: float) -> None:
    """``acc = acc * w_prev + y * w_cur`` as one chunked in-place pass."""
    flat_acc = acc.reshape(-1)
    if not np.may_share_memory(flat_acc, acc):
        # reshape copied (non-contiguous acc): the fold would be lost
        raise ValueError("_fold_into needs a C-contiguous accumulator")
    flat_y = np.asarray(y).reshape(-1)
    for off in range(0, flat_acc.size, _FOLD_CHUNK):
        sl = slice(off, off + _FOLD_CHUNK)
        a = flat_acc[sl]
        a *= w_prev
        t = flat_y[sl].astype(np.float64)
        t *= w_cur
        a += t
        del t  # else two chunk temporaries coexist across the loop boundary


def aggregate_inplace(
    results: Iterable[tuple[object, int]],
    decode: Callable[[object], list[np.ndarray]] | None = None,
    pool: HostPool | None = None,
    timings: dict[str, float] | None = None,
) -> tuple[list[np.ndarray], int]:
    """Streaming sample-weighted mean over ``(arrays, n_samples)`` results;
    returns (averaged fp32 arrays, total samples). A result's first element
    may instead be a compressed payload when ``decode`` is given.

    ``pool`` with ``threads > 1`` runs the per-array folds in parallel and
    lets one lookahead worker pull and decode the next result while the
    current one folds (only that worker advances ``results``). ``timings``
    accumulates ``decode_s`` (the decode of a result, its wait for the
    client excluded) and ``fold_s``."""

    def _arrays(item) -> list[np.ndarray]:
        if isinstance(item, (list, tuple)):
            return list(item)
        if decode is None:
            raise TypeError(
                f"aggregate_inplace got a {type(item).__name__} result but "
                "no decode callback — pass decode= to consume compressed "
                "payload streams"
            )
        return decode(item)

    t_decode = [0.0]
    t_fold = [0.0]
    it: Iterator = iter(results)
    # the decode-ahead runs on a pool worker with an empty context stack, so
    # the spans' parent is the calling thread's context, taken here
    tracer = telemetry.active()
    trace_parent = telemetry.current_context() if tracer is not None else None
    n_seen = [0]

    def _fetch() -> tuple[list[np.ndarray], int] | None:
        """The next result, decoded, or None at the end (StopIteration must
        not cross a future)."""
        try:
            item, n_cur = next(it)
        except StopIteration:
            return None
        t_wall = time.time()
        t0 = time.monotonic()
        arrays = _arrays(item)
        dt = time.monotonic() - t0
        t_decode[0] += dt
        if tracer is not None:
            tracer.add_span(AGG_DECODE_TIME, t_wall, dt, parent=trace_parent,
                            client_index=n_seen[0])
        # a client's decode seconds as a distribution: one slow payload is
        # a fat tail here, invisible in the summed KPI
        telemetry.metric_observe(AGG_DECODE_TIME, dt)
        n_seen[0] += 1
        return arrays, n_cur

    first = _fetch()
    if first is None:
        raise ValueError("aggregate_inplace: empty results")
    arrays, n_total = first
    if n_total <= 0:
        raise ValueError(f"non-positive n_samples {n_total}")

    t0 = time.monotonic()
    # order="C": _fold_into needs acc.reshape(-1) to be a view
    if pool is not None:
        acc = pool.map(lambda a: np.asarray(a, dtype=np.float64, order="C"), arrays)
    else:
        acc = [np.asarray(a, dtype=np.float64, order="C") for a in arrays]
    t_fold[0] += time.monotonic() - t0

    pipelined = pool is not None and pool.pipelined
    pending = pool.submit(_fetch) if pipelined else None
    try:
        while True:
            cur = pending.result() if pipelined else _fetch()
            if cur is None:
                pending = None
                break
            if pipelined:
                pending = pool.submit(_fetch)  # fetch-ahead: one client
            arrays, n_cur = cur
            if n_cur <= 0:
                raise ValueError(f"non-positive n_samples {n_cur}")
            if len(arrays) != len(acc):
                raise ValueError(
                    f"result has {len(arrays)} arrays, accumulator {len(acc)} "
                    "(momenta mismatch between payloads?)"
                )
            n_new = n_total + n_cur
            w_prev = n_total / n_new
            w_cur = n_cur / n_new
            t_wall = time.time()
            t0 = time.monotonic()
            if pool is not None:
                pool.map(
                    lambda i, _a=arrays, _wp=w_prev, _wc=w_cur: _fold_into(acc[i], _a[i], _wp, _wc),
                    range(len(acc)),
                )
            else:
                for a, y in zip(acc, arrays):
                    _fold_into(a, y, w_prev, w_cur)
            dt = time.monotonic() - t0
            t_fold[0] += dt
            if tracer is not None:
                tracer.add_span(AGG_FOLD_TIME, t_wall, dt, parent=trace_parent)
            telemetry.metric_observe(AGG_FOLD_TIME, dt)
            n_total = n_new
    except BaseException:
        if pending is not None:
            pending.cancel()
        raise

    t0 = time.monotonic()
    if pool is not None:
        out = pool.map(lambda a: a.astype(np.float32), acc)
    else:
        out = [a.astype(np.float32) for a in acc]
    t_fold[0] += time.monotonic() - t0
    if timings is not None:
        timings["decode_s"] = timings.get("decode_s", 0.0) + t_decode[0]
        timings["fold_s"] = timings.get("fold_s", 0.0) + t_fold[0]
    return out, n_total


def weighted_loss_avg(results: Iterable[tuple[int, float]]) -> float:
    """Sample-weighted mean loss."""
    results = list(results)
    total = sum(n for n, _ in results)
    if total == 0:
        raise ValueError("weighted_loss_avg: zero total samples")
    return float(sum(n * loss for n, loss in results) / total)


def weighted_average_metrics(results: Iterable[tuple[int, dict[str, float]]]) -> dict[str, float]:
    """Sample-weighted mean of per-client scalar metric dicts; keys carried
    only by zero-weight clients are dropped."""
    num: dict[str, float] = {}
    den: dict[str, int] = {}
    for n, m in results:
        for k, v in m.items():
            num[k] = num.get(k, 0.0) + n * v
            den[k] = den.get(k, 0) + n
    return {k: float(num[k] / den[k]) for k in num if den[k] > 0}
