"""Typed metric instruments: Counter / Gauge / Histogram + Prometheus text
(the port of ``photon_tpu/telemetry/metrics.py``; the exposition text is
the JAX package's, byte for byte, for the same observations).

- :class:`Counter` — cumulative, monotone; rendered with the ``_total``
  suffix. :meth:`Counter.inc_to` adopts an EXTERNAL cumulative source
  (the kernel-library load count) without breaking monotonicity.
- :class:`Gauge` — point-in-time set.
- :class:`Histogram` — fixed buckets, **cumulative** bucket counts at
  render time, the mandatory ``+Inf`` bucket, ``_sum``/``_count``, and
  OpenMetrics-style exemplars carrying the observing span's
  ``trace_id``/``span_id`` so a slow-bucket sample links to its timeline.
- :class:`MetricsHub` — the process-global registry (installed/uninstalled
  with the telemetry plane; hook sites are one ``None`` check when off).
  Every instrument also keeps a bounded ring buffer of recent
  ``(ts, value)`` samples — the time-series view health watchers compute
  percentiles over, and the reason the hub can't OOM the run it observes.

Instrument names are registry constants from ``utils/profiling.py``.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from collections import deque
from typing import Iterable

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: default duration buckets (seconds): sub-ms host hooks up to minute-long
#: collective stages — chosen so one vocabulary serves serve-plane TTFT and
#: train-plane round phases alike
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
#: default size buckets (bytes): TCP control frames (~100 B acks) up to
#: parameter-plane pointers and piggybacked telemetry (MBs)
DEFAULT_BYTES_BUCKETS: tuple[float, ...] = (
    256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0,
    1048576.0, 4194304.0, 16777216.0, 67108864.0,
)


def metric_name(key: str) -> str:
    """``server/round_time`` → ``photon_server_round_time`` (the exposition
    spelling shared with the History gauge renderer in ``prom.py``)."""
    return "photon_" + _NAME_RE.sub("_", key)


def _fmt(v: float) -> str:
    return f"{float(v):.10g}"


@dataclasses.dataclass
class Exemplar:
    """One traced observation attached to a histogram bucket."""

    value: float
    ts: float
    trace_id: str = ""
    span_id: str = ""

    def render(self) -> str:
        labels = f'trace_id="{self.trace_id}"'
        if self.span_id:
            labels += f',span_id="{self.span_id}"'
        return f"# {{{labels}}} {_fmt(self.value)} {self.ts:.3f}"


class _Instrument:
    """Shared base: a name, a lock, and the bounded sample ring."""

    kind = ""

    def __init__(self, name: str, retention: int, clock=time.time) -> None:
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        #: bounded (ts, value) retention — the time-series view for health
        #: watchers and debugging; overflow drops the oldest sample
        self._ring: deque[tuple[float, float]] = deque(maxlen=max(1, int(retention)))

    def series(self) -> list[tuple[float, float]]:
        with self._lock:
            return list(self._ring)

    def recent_values(self, n: int | None = None) -> list[float]:
        with self._lock:
            vals = [v for _, v in self._ring]
        return vals if n is None else vals[-n:]

    # -- windowed reducers: the controller-facing view ----------
    # Every consumer used to re-derive these from series() ad hoc; the SLO
    # autopilot needs one shared, tested vocabulary of reductions.
    def _window(self, window_s: float | None) -> list[tuple[float, float]]:
        """Retained samples, trimmed to the trailing ``window_s`` seconds
        (all of them when None)."""
        with self._lock:
            samples = list(self._ring)
        if window_s is None:
            return samples
        cut = self._clock() - float(window_s)
        return [(t, v) for t, v in samples if t >= cut]

    def latest(self) -> float | None:
        with self._lock:
            return self._ring[-1][1] if self._ring else None

    def percentile(self, q: float, window_s: float | None = None) -> float | None:
        """q-th percentile (nearest-rank) over the RETAINED samples — the
        ring, not any full-history state — optionally restricted to the
        trailing ``window_s`` seconds. None when the window is empty."""
        vals = sorted(v for _, v in self._window(window_s))
        if not vals:
            return None
        q = min(1.0, max(0.0, q))
        return vals[min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))]

    def rate(self, window_s: float | None = None) -> float | None:
        """Per-second change between the window's first and last samples
        (the Prometheus ``rate()`` shape for counters; a net drift for
        gauges). None with fewer than two samples or a zero timespan."""
        s = self._window(window_s)
        if len(s) < 2 or s[-1][0] <= s[0][0]:
            return None
        return (s[-1][1] - s[0][1]) / (s[-1][0] - s[0][0])

    def slope(self, window_s: float | None = None) -> float | None:
        """Least-squares trend (value units per second) over the window —
        noise-robust where :meth:`rate` keys on two endpoint samples.
        None with fewer than two samples or zero time variance."""
        s = self._window(window_s)
        if len(s) < 2:
            return None
        n = len(s)
        t0 = s[0][0]
        ts = [t - t0 for t, _ in s]
        vs = [v for _, v in s]
        mt = sum(ts) / n
        mv = sum(vs) / n
        var = sum((t - mt) ** 2 for t in ts)
        if var <= 0:
            return None
        return sum((t - mt) * (v - mv) for t, v in zip(ts, vs)) / var

    def ewma(self, alpha: float = 0.2, window_s: float | None = None) -> float | None:
        """Exponentially-weighted moving average over the window, seeded
        from the window's first sample. None when the window is empty."""
        s = self._window(window_s)
        if not s:
            return None
        acc = s[0][1]
        for _, v in s[1:]:
            acc += alpha * (v - acc)
        return acc

    def render(self, exemplars: bool = True) -> list[str]:  # pragma: no cover
        raise NotImplementedError


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, retention: int, clock=time.time) -> None:
        super().__init__(name, retention, clock)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self.value += float(n)
            self._ring.append((self._clock(), self.value))

    def inc_to(self, total: float) -> None:
        """Adopt an external cumulative total (e.g. the process-wide
        backend-compile count sampled at a round boundary). Monotone: a
        smaller total (listener re-install) is ignored, never a decrease."""
        with self._lock:
            if total > self.value:
                self.value = float(total)
                self._ring.append((self._clock(), self.value))

    def render(self, exemplars: bool = True) -> list[str]:
        # Prometheus counter convention: the _total suffix — but never
        # doubled when the registry name already carries it
        name = metric_name(self.name)
        if not name.endswith("_total"):
            name += "_total"
        with self._lock:
            v = self.value
        return [f"# TYPE {name} counter", f"{name} {_fmt(v)}"]


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name: str, retention: int, clock=time.time) -> None:
        super().__init__(name, retention, clock)
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)
            self._ring.append((self._clock(), self.value))

    def render(self, exemplars: bool = True) -> list[str]:
        name = metric_name(self.name)
        with self._lock:
            v = self.value
        return [f"# TYPE {name} gauge", f"{name} {_fmt(v)}"]


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, retention: int,
                 buckets: Iterable[float] | None = None, clock=time.time) -> None:
        super().__init__(name, retention, clock)
        if buckets is None:
            # bytes-shaped names get bytes-shaped buckets; everything else
            # in this repo's vocabulary is a duration in seconds
            buckets = (DEFAULT_BYTES_BUCKETS if name.endswith("_bytes")
                       else DEFAULT_LATENCY_BUCKETS)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {self.name}: empty bucket list")
        self.buckets = bs  # +Inf is implicit, always rendered
        self._counts = [0] * len(bs)  # per-bucket (NON-cumulative internally)
        self._inf = 0
        self.sum = 0.0
        self.count = 0
        # latest exemplar per bucket index (len(bs) == the +Inf slot index)
        self._exemplars: dict[int, Exemplar] = {}

    def _bucket_index(self, v: float) -> int:
        for i, b in enumerate(self.buckets):
            if v <= b:
                return i
        return len(self.buckets)  # +Inf

    def observe(self, v: float, exemplar: tuple | None = None) -> None:
        """Record one observation. ``exemplar`` is an optional
        ``(trace_id, span_id)`` — the active span's wire context — kept as
        the bucket's latest exemplar."""
        v = float(v)
        i = self._bucket_index(v)
        with self._lock:
            if i < len(self.buckets):
                self._counts[i] += 1
            else:
                self._inf += 1
            self.sum += v
            self.count += 1
            self._ring.append((self._clock(), v))
            if exemplar:
                self._exemplars[i] = Exemplar(
                    value=v, ts=self._clock(),
                    trace_id=str(exemplar[0]),
                    span_id=str(exemplar[1]) if len(exemplar) > 1 else "",
                )

    def render(self, exemplars: bool = True) -> list[str]:
        """``exemplars=False`` renders classic text format v0.0.4 (legacy
        parsers reject the ``#`` exemplar annotation after a value);
        ``True`` adds the OpenMetrics exemplar extension — only serve it
        under the ``application/openmetrics-text`` content type."""
        name = metric_name(self.name)
        with self._lock:
            counts = list(self._counts)
            inf, total, s = self._inf, self.count, self.sum
            exs = dict(self._exemplars) if exemplars else {}
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += counts[i]
            line = f'{name}_bucket{{le="{_fmt(b)}"}} {cum}'
            ex = exs.get(i)
            if ex is not None:
                line += f" {ex.render()}"
            lines.append(line)
        # the mandatory +Inf bucket equals _count — scrapers reject
        # expositions where it doesn't
        line = f'{name}_bucket{{le="+Inf"}} {cum + inf}'
        ex = exs.get(len(self.buckets))
        if ex is not None:
            line += f" {ex.render()}"
        lines.append(line)
        lines.append(f"{name}_sum {_fmt(s)}")
        lines.append(f"{name}_count {total}")
        return lines


class MetricsHub:
    """Process-global typed-instrument registry.

    Get-or-create accessors are the only way in — two call sites naming the
    same instrument share it, and a kind clash (``counter`` where a
    ``histogram`` exists) raises instead of silently forking the series.
    Rendering is stable-sorted by instrument name so scrapes diff cleanly.
    """

    def __init__(self, retention: int = 512, clock=time.time) -> None:
        self.retention = max(1, int(retention))
        self._clock = clock
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _get_or_create(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, self.retention, clock=self._clock, **kwargs)
                self._instruments[name] = inst
                return inst
        if not isinstance(inst, cls):
            raise ValueError(
                f"instrument {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets: Iterable[float] | None = None) -> Histogram:
        return self._get_or_create(name, Histogram, buckets=buckets)

    def get(self, name: str) -> _Instrument | None:
        with self._lock:
            return self._instruments.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def render(self, exemplars: bool = True) -> str:
        """Prometheus text exposition of every instrument, trailing
        newline included. ``exemplars=True`` is the OpenMetrics flavor
        (bucket exemplars carrying trace ids); ``False`` is strict classic
        text v0.0.4 for legacy scrapers — the HTTP endpoints negotiate via
        the Accept header."""
        with self._lock:
            insts = sorted(self._instruments.items())
        lines: list[str] = []
        for _, inst in insts:
            lines.extend(inst.render(exemplars=exemplars))
        return "\n".join(lines) + "\n" if lines else ""
