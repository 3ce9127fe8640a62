"""Device-plane introspection: device memory, kernel builds, profiling (the
port of ``photon_tpu/telemetry/introspect.py``, rewritten for the CUDA
card).

- :func:`device_memory` — the caching allocator's live and peak bytes
  (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
  ``.peak``), sampled at round and serve-tick boundaries into
  ``server/hbm_bytes_in_use`` / ``serve/hbm_*`` gauges. ``None`` for a CPU
  device, and in a process that has not initialised CUDA: a sampler never
  opens a context (the ``--tcp-listen`` server holds none).
- :func:`compile_count` — the kernel libraries this process has built or
  loaded through ``photon_tpu_torch.ops._build.load``, the only runtime
  compiles the port makes; the ``*/backend_compiles_total`` counter reads
  it, and it stays flat once serving is warm.
- :class:`ProfileController` — on-demand ``torch.profiler`` capture (CPU
  activity, plus CUDA where this process has initialised CUDA): arm it for
  N round/tick units (``photon.telemetry.profile_rounds``, or ``POST
  /debug/profile``), the next unit boundary starts the trace, the N-th
  after it stops it, and the Chrome trace lands in
  ``{out_dir}/profile-{tag}-{seq}/trace.json`` beside ``trace-{run}.json``.

All of it installs/uninstalls with the telemetry plane; disabled hook
sites are one ``None`` check (``telemetry.profile_tick`` /
``telemetry.metrics_active``).
"""

from __future__ import annotations

import pathlib
import threading
import time
from typing import Any

#: the Chrome trace a capture writes into its ``profile-{tag}-{seq}/`` dir
PROFILE_TRACE_FILE = "trace.json"


def device_memory(device: Any | None = None) -> dict[str, int] | None:
    """Live/peak allocator bytes of ``device`` (default: the current CUDA
    device). None for a CPU device and where CUDA is not initialised in
    this process — callers skip the KPIs rather than recording zeros that
    would read as "no memory in use"."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats(device)
    live = int(stats.get("allocated_bytes.all.current", 0))
    return {
        "bytes_in_use": live,
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", live)),
    }


_COUNTING = False


def install_compile_counter() -> None:
    global _COUNTING
    _COUNTING = True


def uninstall_compile_counter() -> None:
    global _COUNTING
    _COUNTING = False


def compile_count() -> int | None:
    """Kernel libraries this process has built or loaded (one per source),
    or None when the counter isn't installed (telemetry off)."""
    if not _COUNTING:
        return None
    from photon_tpu_torch.ops import _build

    return len(_build.loaded_sources())


def sample_device_plane(metrics: dict, hub, *, hbm_key: str, peak_key: str,
                        compiles_key: str) -> None:
    """Shared round/tick-boundary sampler: device live/peak bytes + the
    kernel-build count into both the caller's KPI dict (History) and the
    typed hub (gauges + a monotone counter). Key names are the caller's
    registry constants (``server/*`` at round boundaries, ``serve/*`` at
    scheduler ticks). Skips the memory keys where no CUDA device reports."""
    mem = device_memory()
    if mem is not None:
        metrics[hbm_key] = float(mem["bytes_in_use"])
        metrics[peak_key] = float(mem["peak_bytes_in_use"])
        hub.gauge(hbm_key).set(metrics[hbm_key])
        hub.gauge(peak_key).set(metrics[peak_key])
    n = compile_count()
    if n is not None:
        metrics[compiles_key] = float(n)
        hub.counter(compiles_key).inc_to(n)


class TorchProfiler:
    """``start_trace(dir)`` / ``stop_trace()`` over ``torch.profiler``:
    CPU activity always, CUDA activity when this process has initialised
    CUDA (a profiler never opens a context). ``stop_trace`` writes the
    Chrome trace to ``{dir}/trace.json``."""

    def __init__(self) -> None:
        self._prof = None
        self._out: pathlib.Path | None = None

    def start_trace(self, out: str) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_initialized():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._out = pathlib.Path(out)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.stop()
        prof.export_chrome_trace(str(self._out / PROFILE_TRACE_FILE))


class ProfileBusyError(RuntimeError):
    """A profile capture is already armed or active (HTTP 409)."""


class ProfileController:
    """On-demand ``torch.profiler`` capture over N round/tick units.

    :meth:`request` arms a capture; the product loops' unit boundaries
    (``telemetry.profile_tick`` in the server round loop and the serve
    scheduler) drive it: the first boundary after arming starts the trace,
    the N-th after that stops it. One capture at a time; artifacts land in
    ``{out_dir}/profile-{tag}-{seq}/``.

    ``profiler`` (an object with ``start_trace(dir)`` and ``stop_trace()``)
    is injectable for tests; the default is a :class:`TorchProfiler`.
    Profiler failures disarm and are recorded on :attr:`last_error` (and in
    :meth:`status`) — a broken profiler must never take the round loop or
    the scheduler thread with it, and its missing artifact shows the
    failure.
    """

    def __init__(self, out_dir: str, profiler: Any | None = None,
                 clock=time.time) -> None:
        self.out_dir = str(out_dir)
        self._profiler = profiler
        self._clock = clock
        self._lock = threading.Lock()
        self._pending = 0  # units requested, capture not yet started
        self._active_left = 0  # boundaries left until stop
        self._active_dir: str | None = None
        self._active_tag = ""
        self._seq = 0
        self.completed: list[dict] = []
        self.last_error: str | None = None

    # -- arming ------------------------------------------------------------
    def request(self, n_units: int, tag: str = "ondemand") -> dict:
        """Arm a capture for ``n_units`` upcoming units. Raises
        :class:`ProfileBusyError` when one is already armed/active, and
        ValueError on a non-positive unit count."""
        n = int(n_units)
        if n < 1:
            raise ValueError(f"profile units must be >= 1, got {n_units}")
        with self._lock:
            if self._pending or self._active_left:
                raise ProfileBusyError(
                    "a profile capture is already armed or active"
                )
            self._pending = n
            self._active_tag = "".join(
                ch for ch in str(tag) if ch.isalnum() or ch in "-_"
            ) or "ondemand"
        return {"armed_units": n, "tag": self._active_tag}

    # -- the product-loop boundary hook -----------------------------------
    def tick(self, label: str) -> None:
        """One unit boundary. Cheap when idle: two int reads, no lock."""
        if not (self._pending or self._active_left):
            return
        with self._lock:
            if self._pending:
                n, self._pending = self._pending, 0
                self._seq += 1
                out = (pathlib.Path(self.out_dir)
                       / f"profile-{self._active_tag}-{self._seq}")
                if self._start(str(out)):
                    self._active_left = n
                    self._active_dir = str(out)
                return
            if self._active_left:
                self._active_left -= 1
                if self._active_left == 0:
                    self._stop(label)

    def _start(self, out: str) -> bool:
        try:
            if self._profiler is None:
                self._profiler = TorchProfiler()
            pathlib.Path(out).mkdir(parents=True, exist_ok=True)
            self._profiler.start_trace(out)
            return True
        except Exception as e:  # noqa: BLE001 — never take the loop down
            self.last_error = f"{type(e).__name__}: {e}"
            return False

    def _stop(self, label: str) -> None:
        try:
            self._profiler.stop_trace()
            self.completed.append({
                "dir": self._active_dir,
                "tag": self._active_tag,
                "stopped_at": label,
                "ts": self._clock(),
            })
        except Exception as e:  # noqa: BLE001
            self.last_error = f"{type(e).__name__}: {e}"
        self._active_dir = None

    def close(self) -> None:
        """Force-stop an active capture (telemetry uninstall / end of run)
        so a trace armed for more rounds than the run had still flushes."""
        with self._lock:
            self._pending = 0
            if self._active_left:
                self._active_left = 0
                self._stop("close")

    def status(self) -> dict:
        with self._lock:
            return {
                "armed_units": self._pending,
                "active_units_left": self._active_left,
                "active_dir": self._active_dir,
                "completed": list(self.completed),
                "last_error": self.last_error,
            }
