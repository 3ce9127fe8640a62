"""The traced run: host spans, recorded kernel calls and the profiler's
device records, reduced to a :class:`Record` that the metric readers read.

Spans are ``torch.profiler.record_function`` ranges opened from this
folder around the calls into each layer of the port, so the profiler's
clock times them beside the device work. A recorded call (a K1–K3 or K4
launch through its Python entry) is a range of its own named
``pb#<kind>#<n>``: the kernels its launch calls start are its kernels, so
each call's device time is matched to its shapes exactly, and a call whose
device records the profiler lost drops out of both sides of a ratio.

:func:`profiled` is ``chip_smoke.py::_profiled``: the window opens with
``PROFILER_PAD`` launches of ``torch.cuda._sleep``'s kernel (the profiler
drops a window's first device records) and a margin of idle card.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Callable

import torch

PROFILER_PAD = 256
PROFILER_PAD_KERNEL = "spin_kernel"
PROFILER_MARGIN_S = 0.1
SPAN_PREFIX = "pb."
WINDOW_SPAN = "pb.window"
CALL_PREFIX = "pb#"
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
             "cudaLaunchCooperativeKernel")


class Spans:
    """Host spans: profiler ranges while a trace is on, nothing otherwise."""

    def __init__(self) -> None:
        self.on = False

    def __call__(self, name: str):
        return (torch.profiler.record_function(SPAN_PREFIX + name) if self.on
                else contextlib.nullcontext())

    def wrap(self, obj, attr: str, name: str) -> None:
        """Replace ``obj.attr`` (an instance's method) by one inside span
        ``name``."""
        fn = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)

        setattr(obj, attr, wrapped)


class CallRecorder:
    """Wraps a module's function: while :attr:`on`, each call is a
    ``pb#<kind>#<n>`` range and ``describe(*args, **kwargs)`` is kept as
    call ``n``'s shapes. ``kernel`` is a part of the name of every kernel
    such a call launches."""

    def __init__(self, module, attr: str, kind: str, describe: Callable,
                 kernel: str = "") -> None:
        self.module, self.attr, self.kind, self.kernel = module, attr, kind, kernel
        self.calls: list[dict] = []
        self.on = False
        self._orig = getattr(module, attr)

        def wrapped(*args, **kwargs):
            if not self.on:
                return self._orig(*args, **kwargs)
            n = len(self.calls)
            self.calls.append(describe(*args, **kwargs))
            with torch.profiler.record_function(f"{CALL_PREFIX}{kind}#{n}"):
                return self._orig(*args, **kwargs)

        setattr(module, attr, wrapped)

    def restore(self) -> None:
        setattr(self.module, self.attr, self._orig)


@contextlib.contextmanager
def profiled():
    """``torch.profiler`` (CPU + CUDA, every thread) over the block, opened
    with the pad and a margin of idle card at both ends; yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from torch._C._profiler import _ExperimentalConfig

    torch.cuda.synchronize()
    # every thread's ranges: the serving plane launches from its scheduler thread
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        for _ in range(PROFILER_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)


@dataclasses.dataclass
class Record:
    """What a traced run gives the metric readers."""

    config: dict
    traffic: dict
    window_s: float = 0.0
    busy_s: float = 0.0
    #: kernel name -> [launches, device seconds] inside the window
    kernels: dict = dataclasses.field(default_factory=dict)
    #: the longest idle gaps: [the innermost host span at the gap, seconds]
    idle_gaps: list = dataclasses.field(default_factory=list)
    #: kind -> the recorded calls whose kernels were seen, each its shapes
    #: plus ``device_s``
    calls: dict = dataclasses.field(default_factory=dict)
    #: the runner's own counters (host clock, the port's request times)
    host: dict = dataclasses.field(default_factory=dict)
    pad_lost: int = 0

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        return {"device_ops": [[name, secs] for name, (_, secs) in ops],
                "idle_gaps": [list(g) for g in self.idle_gaps[:top]]}


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(prof, record: Record, recorders: list[CallRecorder], top_gaps: int = 10) -> Record:
    """Fill ``record`` from the profiler's events: the window (the
    ``pb.window`` range), the device's busy time in it, kernel time by
    name, the idle gaps named by host span, and each recorded call's
    device time."""
    device, spans, launches = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if _is_device(ev) and name.startswith("pb"):
            continue  # a host range drawn again on the device's timeline
        if _is_device(ev):
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), name,
                           ev.correlation_id()))
        elif name in _LAUNCHES:
            launches.append((ev.start_ns(), ev.start_thread_id(), ev.correlation_id()))
        elif name.startswith("pb"):
            spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), name,
                          ev.start_thread_id()))
    windows = [s for s in spans if s[2] == WINDOW_SPAN]
    if not windows:
        raise RuntimeError("the traced run has no window span")
    w0, w1 = windows[0][0], windows[0][1]
    record.pad_lost = PROFILER_PAD - sum(1 for d in device if PROFILER_PAD_KERNEL in d[2])
    inside = [d for d in device if w0 <= d[0] < w1 and PROFILER_PAD_KERNEL not in d[2]]
    busy = _union([(a, min(b, w1)) for a, b, _, _ in inside])
    record.window_s = (w1 - w0) / 1e9
    record.busy_s = sum(b - a for a, b in busy) / 1e9
    kernels: dict[str, list] = {}
    for a, b, name, _ in inside:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e9
    record.kernels = kernels
    # idle gaps, each named by the shortest host span covering its start
    host = sorted((s for s in spans if s[2].startswith(SPAN_PREFIX) and s[2] != WINDOW_SPAN),
                  key=lambda s: s[1] - s[0])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top_gaps]:
        span = next((s[2][len(SPAN_PREFIX):] for s in host if s[0] <= a < s[1]), "none")
        named.append((span, (b - a) / 1e9))
    record.idle_gaps = named
    # recorded calls: the kernels of the call's family that launches inside
    # its range started, those of its own thread where the profiler gives
    # both kinds of record the same thread ids
    by_corr = {d[3]: d for d in device}
    launches.sort()
    starts = [x[0] for x in launches]
    for rec in recorders:
        found, seen = [], 0
        prefix = f"{CALL_PREFIX}{rec.kind}#"
        for a, b, name, tid in spans:
            if not name.startswith(prefix):
                continue
            seen += 1
            n = int(name[len(prefix):])
            lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
            cands = [(t, by_corr[c]) for _, t, c in launches[lo:hi]
                     if c in by_corr and rec.kernel in by_corr[c][2]]
            ks = [k for t, k in cands if t == tid] or [k for _, k in cands]
            if ks and all(w0 <= k[0] < w1 for k in ks):
                found.append({**rec.calls[n], "device_s": sum(k[1] - k[0] for k in ks) / 1e9})
        record.calls[rec.kind] = found
        record.host.setdefault("matched", {})[rec.kind] = [len(rec.calls), seen, len(found)]
    return record


def idle_share(rec: Record) -> float | None:
    """The share of the traced window with no device record, in %."""
    if rec.window_s <= 0 or rec.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
