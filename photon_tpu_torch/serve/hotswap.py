"""Live checkpoint hot-swap: serve the rounds of a federated run as it
trains.

The port of ``photon_tpu/serve/hotswap.py``. The watcher keeps its
counters as attributes (``/healthz`` reports them); with
``photon.telemetry`` on, a skipped round is a ``hotswap/skipped`` event
and a corrupt one also bumps ``serve/hotswap_rejected_corrupt_total`` and
raises a ``store`` health alert (the swap itself is the scheduler's
span, histogram observation and event). A watcher thread polls the
run's store and stages each new, checksum-valid round at the scheduler's
swap point, where admission pauses, running requests finish on the old
params, and the engine swaps and flushes its prefix cache. No request is
dropped, and each runs end to end on one round's params.

One poll, in order:

1. **discover** — ``ServerCheckpointManager.latest_complete_round()``, a
   manifest-presence scan (no object reads): a torn round is never a
   candidate;
2. **drain fence** — during a SIGTERM drain nothing is swapped;
3. **health gate** (``serve.hotswap_statusz_url``, optional) — the
   training run's ``/statusz``; a ``failing`` federation plane blocks the
   swap, and an unreachable or malformed answer lets it through;
4. **integrity** — ``verify_round`` checks every object's CRC against the
   manifest; a corrupt round is skipped with one warning and counted
   once, and the server keeps serving what it has;
5. **load** the params on the CPU (and, with the adapters on, the round's
   adapter bank: base and bank swap together), **stage** them with
   ``ContinuousBatcher.request_swap``, and **resolve**: wait (stop-aware)
   until the scheduler thread applied the swap. The watcher thread never
   touches engine state.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
import warnings

from photon_tpu_torch import telemetry
from photon_tpu_torch.serve.engine import load_serving_bank, load_serving_params
from photon_tpu_torch.serve.scheduler import ContinuousBatcher, DrainingError
from photon_tpu_torch.utils.profiling import (
    EVENT_HOTSWAP_SKIPPED,
    SERVE_HOTSWAP_REJECTED_CORRUPT,
)

#: how long one poll waits for the scheduler to apply the swap it staged;
#: a longer quiesce is resolved by a later poll
SWAP_TIMEOUT_S = 120.0


class CheckpointWatcher:
    """Polls a federated run's checkpoint store and hot-swaps new rounds
    into a running :class:`ContinuousBatcher`. :meth:`poll_once` is the
    whole state machine (tests drive it directly); the named thread calls
    it every ``poll_s`` seconds and :meth:`close` joins it."""

    def __init__(self, batcher: ContinuousBatcher, mgr, cfg, *, poll_s: float = 5.0,
                 statusz_url: str = "") -> None:
        self.batcher = batcher
        self.mgr = mgr
        self.cfg = cfg
        self.poll_s = poll_s
        self.statusz_url = statusz_url
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.swaps_applied = 0
        self.rejected_corrupt = 0
        self.polls = 0
        self.last_outcome = "idle"
        self._warned_rounds: set[int] = set()  # one warning per bad round
        self._rejected_rounds: set[int] = set()  # one count per bad round
        #: a staged swap not yet resolved: (round, done event)
        self._staged: tuple[int, threading.Event] | None = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "CheckpointWatcher":
        self._thread = threading.Thread(target=self._loop, name="photon-serve-hotswap",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — a poll must not kill the watcher
                warnings.warn(f"hotswap poll failed ({type(e).__name__}: {e}); "
                              "still serving the current round", stacklevel=2)
                self.last_outcome = "error"
            self._stop.wait(self.poll_s)

    # -- the state machine ------------------------------------------------
    def stats(self) -> dict:
        b, eng = self.batcher, self.batcher.engine
        return {"round": eng.loaded_round, "swaps_applied": self.swaps_applied,
                "rejected_corrupt": self.rejected_corrupt, "polls": self.polls,
                "last_outcome": self.last_outcome,
                # the last swap: staged → applied seconds, its wall time, and
                # the device bytes before it and at its peak (CUDA only)
                "last_swap_s": b.last_swap_s, "last_swap_at": b.last_swap_at,
                "swap_bytes_before": eng.swap_bytes_before,
                "swap_peak_bytes": eng.swap_peak_bytes}

    def poll_once(self) -> str:
        """One poll: discover → fence → gate → verify → load → swap.
        Returns the outcome (also kept on :attr:`last_outcome`)."""
        self.last_outcome = self._poll_once()
        return self.last_outcome

    def _poll_once(self) -> str:
        self.polls += 1
        if self._staged is not None:
            # a quiesce that outlasted SWAP_TIMEOUT_S: resolve it rather
            # than load the round again
            return self._resolve_staged(wait_s=0.0)
        current = self.batcher.engine.loaded_round
        candidate = self.mgr.latest_complete_round()
        if candidate is None or (current is not None and candidate <= current):
            return "idle"
        if self.batcher.draining:
            self._skip(candidate, "draining", warn=False)
            return "skipped-draining"
        if self.statusz_url and not self._federation_healthy():
            self._skip(candidate, "federation-failing")
            return "skipped-health"
        if not self.mgr.verify_round(candidate):
            # counted once per round: verify_round memoizes the verdict
            if candidate not in self._rejected_rounds:
                self._rejected_rounds.add(candidate)
                self.rejected_corrupt += 1
                telemetry.metric_inc(SERVE_HOTSWAP_REJECTED_CORRUPT)
                health = telemetry.health_active()
                if health is not None:
                    health.note_store_corruption(round=candidate, run_uuid=self.mgr.run_uuid,
                                                 stage="hotswap")
            self._skip(candidate, "corrupt")
            return "skipped-corrupt"
        params = load_serving_params(self.cfg, self.mgr, candidate)
        # CRC-checked above with the round's other objects
        bank = load_serving_bank(self.cfg, self.mgr, candidate)
        try:
            done = self.batcher.request_swap(params, loaded_round=candidate, adapter_bank=bank)
        except DrainingError:
            self._skip(candidate, "draining", warn=False)
            return "skipped-draining"
        del params, bank  # the batcher holds the only references until the swap
        self._staged = (candidate, done)
        return self._resolve_staged(wait_s=SWAP_TIMEOUT_S)

    def _resolve_staged(self, wait_s: float) -> str:
        """``swapped`` (counted once), ``pending`` (still quiescing) or
        ``swap-abandoned`` (a drain or a failed apply gave it up)."""
        rnd, done = self._staged
        deadline = time.monotonic() + wait_s
        # stop-aware: close() during a quiesce must not wait out the bound
        while not done.is_set() and not self._stop.is_set() and time.monotonic() < deadline:
            done.wait(0.2)
        if self.batcher.engine.loaded_round == rnd:
            self._staged = None
            self.swaps_applied += 1
            return "swapped"
        if not done.is_set():
            return "pending"
        self._staged = None
        return "swap-abandoned"

    def _skip(self, candidate: int, reason: str, warn: bool = True) -> None:
        telemetry.emit_event(EVENT_HOTSWAP_SKIPPED, round=candidate, reason=reason)
        if warn and candidate not in self._warned_rounds:
            self._warned_rounds.add(candidate)
            warnings.warn(f"hotswap: skipping candidate round {candidate} ({reason}); "
                          f"still serving round {self.batcher.engine.loaded_round}",
                          stacklevel=2)

    def _federation_healthy(self) -> bool:
        """False exactly when the training run's ``/statusz`` answers and
        reports the federation plane ``failing``; unreachable or malformed
        answers fail open (a dead endpoint must not freeze serving on a
        stale round)."""
        try:
            with urllib.request.urlopen(self.statusz_url, timeout=5.0) as r:
                payload = json.loads(r.read().decode())
            plane = payload.get("planes", {}).get("federation", {})
            return not (isinstance(plane, dict) and plane.get("status") == "failing")
        except (OSError, ValueError, TypeError, AttributeError):
            return True
