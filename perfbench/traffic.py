"""The one traffic generator: it reads a mix's parameters and makes the
requests of a run.

A mix is a trace drawn once and replayed: its schedule (when each request
is due, its prompt's and its answer's length) comes from the mix's own
``schedule_seed``, and a run's ``--seed`` draws the token ids (and, in the
runners, the weights). Sizes are stratified draws (the distribution's
quantiles at ``(i + 0.5) / n``) and the gaps between arrivals the
exponential's quantiles at the same points, scaled to fill the phase; the
schedule seed permutes the prompt sizes, the output sizes and the gaps,
each apart, so the arrivals are those of a Poisson stream at the mix's
rate. Every ``--seed`` thus offers the same work at the same times: at 0.8
of the knee the order of the sizes and gaps moved a window's TTFT tail by
a fifth from one order to another, where two runs of one order agree to
about a percent.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()


@dataclasses.dataclass
class Request:
    """One open-loop request: when it is due (seconds from the window's
    start), its prompt, and how many tokens it asks for."""

    due: float
    prompt: list[int]
    max_new: int
    phase: str


def quantile(dist: dict, u: float) -> int:
    """The ``u`` quantile of a size distribution, clipped to its
    ``min``/``max``: ``{"dist": "lognormal", "median", "sigma"}``,
    or ``{"dist": "uniform", "min", "max"}``."""
    kind = dist["dist"]
    if kind == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf(u))
    elif kind == "uniform":
        x = dist["min"] + u * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown size distribution {kind!r}")
    return int(min(max(round(x), dist.get("min", 1)), dist.get("max", x)))


def stratified(dist: dict, n: int) -> list[int]:
    return [quantile(dist, (i + 0.5) / n) for i in range(n)]


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent stream of the run's seed (any non-negative integer)."""
    return np.random.default_rng([int(seed) & (2**63 - 1), *stream.encode()])


def phase_requests(mix: dict, seed: int, phase: str, start: float, length: float,
                   vocab: int) -> list[Request]:
    """The requests due in ``[start, start + length)`` at the mix's rate:
    the mix's schedule, the run's token ids."""
    n = max(1, round(mix["rate_per_s"] * length))
    sched = rng_for(mix["schedule_seed"], phase)
    prompts = sched.permutation(stratified(mix["prompt_len"], n))
    outputs = sched.permutation(stratified(mix["output_len"], n))
    gaps = sched.permutation([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    total = float(np.sum(gaps))
    due = start + length * np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) / total
    ids = rng_for(seed, phase).integers(0, vocab, size=int(np.sum(prompts)))
    out, at = [], 0
    for t, p, o in zip(due, prompts, outputs):
        out.append(Request(float(t), ids[at:at + p].tolist(), int(o), phase))
        at += p
    return out


def open_loop(mix: dict, seed: int, window_s: float, vocab: int) -> list[Request]:
    """A run's requests: ``warm_s`` of warm traffic before the window, the
    window, then ``tail_s`` more that keep the load on while the window's
    last requests finish (they are not measured)."""
    warm, tail = float(mix["warm_s"]), float(mix["tail_s"])
    return (phase_requests(mix, seed, "warm", -warm, warm, vocab)
            + phase_requests(mix, seed, "window", 0.0, window_s, vocab)
            + phase_requests(mix, seed, "tail", window_s, tail, vocab))
